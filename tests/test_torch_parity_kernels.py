"""The plain PyTorch versions of the parity path's CUDA kernels against the
Pallas kernels they replace (interpret mode on the CPU) and the XLA
functions with the same contract: NMS + first-K selection, exact PAF
scoring and connected-component labels."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.ops import paf as JP
from islx.ops import peaks as JPK
from islx.ops.hand_peaks import _label_components
from islx.ops.pallas_cc import label_components_pallas
from islx.ops.pallas_paf import score_limbs_pallas
from islx.ops.pallas_peaks import nms_first_k as pallas_nms_first_k
from islx_torch.ops import cc_label as TCC
from islx_torch.ops import nms_first_k as TNF
from islx_torch.ops import paf as TP
from islx_torch.ops import paf_sample as TPS
from chip_smoke import tile_maps
from test_torch_gpu import cc_maps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores, and more threads a process
    oversubscribe them (six concurrent copies of a torch-only test ran
    ~10x slower with the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(rng, b, c, h, w, shift):
    """Seeded maps with a 3x3 plateau, a row at 0.7 along the top border,
    an empty channel (sentinels) and a negative shift, so thre1 <= 0 sees
    out-of-image neighbours."""
    maps = rng.rand(b, c, h, w).astype(np.float32) - shift
    maps[0, 0, 10:13, 5:8] = 0.9
    maps[-1, 2, 0, :] = 0.7
    maps[0, 1] = -1.0
    return maps


@pytest.mark.parametrize("thre", [0.55, 0.0, -0.2])
def test_nms_first_k_plain_matches_pallas(rng, thre):
    """The plain version == the Pallas kernel: indices, order, sentinels."""
    b, c, h, w, k = 3, 25, 46, 32, 16
    maps = _maps(rng, b, c, h, w, 0.3)
    want = np.asarray(pallas_nms_first_k(jnp.asarray(maps), jnp.float32(thre),
                                         k, interpret=True))
    got = TNF.nms_first_k(torch.from_numpy(maps), thre, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    assert (want < h * w).sum() > 100 and (want == h * w).any()


def test_nms_first_k_border_contracts(rng):
    """At thre1 <= 0 the two border contracts differ: border 0.0 is the
    Pallas kernel's, -inf is islx's ``_nms_mask`` + ``_first_k_masked``."""
    b, c, h, w, k = 2, 6, 20, 24, 12
    thre = -0.1
    maps = _maps(rng, b, c, h, w, 0.5)
    zero = TNF.nms_first_k(torch.from_numpy(maps), thre, k).numpy()
    ninf = TNF.nms_first_k(torch.from_numpy(maps), thre, k,
                           border=-float("inf")).numpy()
    np.testing.assert_array_equal(
        np.asarray(pallas_nms_first_k(jnp.asarray(maps), jnp.float32(thre), k,
                                      interpret=True)), zero)
    for i in range(b):
        mask = JPK._nms_mask(jnp.asarray(maps[i].transpose(1, 2, 0)), thre)
        want = JPK._first_k_masked(mask.transpose(2, 0, 1).reshape(c, h * w),
                                   k)
        np.testing.assert_array_equal(np.asarray(want), ninf[i])
    assert not np.array_equal(zero, ninf)


@pytest.mark.parametrize("h,w", [(7, 130), (37, 130), (1, 1), (720, 1280),
                                 (184, 144), (184, 328), (40, 1001)])
def test_nms_first_k_bands_cover_each_row_once(h, w):
    """The CUDA kernel's band plan: bands of ``rows`` rows cover rows
    0..H-1 exactly once, none is empty, and a block's staged band with its
    halo rows fits the shared memory it is given."""
    rows, bands, smem = TNF.band_plan(h, w)
    seen = np.zeros(h, np.int64)
    for b in range(bands):
        y0, y1 = b * rows, min((b + 1) * rows, h)
        assert y0 < y1
        seen[y0:y1] += 1
    np.testing.assert_array_equal(seen, np.ones(h, np.int64))
    assert smem <= TNF.MAX_SMEM
    assert rows * w <= max(TNF.BAND_PX, w) * 2
    # bands a block reads in turn: more than one only while the launch
    # keeps enough blocks
    for planes in (1, 25, 400, 4800):
        group = TNF.bands_per_block(planes, bands)
        blocks = planes * -(-bands // group)
        assert 1 <= group <= 4
        assert group == 1 or blocks >= TNF.MIN_BLOCKS


def _peak_tables(rng, c, k, h, w):
    count = rng.randint(0, k + 1, c)
    xy = np.zeros((c, k, 2), np.int32)
    valid = np.zeros((c, k), bool)
    for ch in range(c):
        xy[ch, :count[ch], 0] = rng.randint(0, w, count[ch])
        xy[ch, :count[ch], 1] = rng.randint(0, h, count[ch])
        valid[ch, :count[ch]] = True
    xy[3, 1] = xy[3, 0]                        # a repeated peak: norm 0.001
    return xy, valid


@pytest.mark.parametrize("mid_num,thre2,table", [
    pytest.param(10, 0.05, "body25", id="10-0.05"),
    pytest.param(7, -0.1, "body25", id="7--0.1"),
    pytest.param(1, 0.05, "body25", id="1-0.05"),
    pytest.param(2, 0.05, "body25", id="2-0.05"),
    pytest.param(11, 0.05, "body25", id="11-0.05"),
    pytest.param(10, 0.05, "coco", id="coco-10-0.05"),
    pytest.param(1, 0.05, "coco", id="coco-1-0.05")] + [
    pytest.param(m, 0.05, "body25", id=f"{m}-0.05")
    for m in (3, 4, 5, 6, 8, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20)])
def test_score_limbs_matches_pallas_and_xla(rng, mid_num, thre2, table):
    """ok and score bit for bit (the norm's square root is correctly
    rounded, as XLA's is: PyTorch's CPU f32 sqrt is not), with both limb
    tables, at every mid 1-20: 1 (the first sample alone), 2 (the two
    endpoints alone), the chained sums and the mids where XLA's program
    sums the samples in vector lanes (2, 4, 8, 16-20)."""
    h, w, k, c = 92, 64, 16, 25
    seq, idx = {"body25": (JP.LIMB_SEQ_BODY25, JP.MAP_IDX_BODY25),
                "coco": (JP.LIMB_SEQ_COCO, JP.MAP_IDX_COCO)}[table]
    paf = rng.rand(h, w, 52).astype(np.float32) - 0.4
    xy, valid = _peak_tables(rng, c, k, h, w)
    args = (jnp.asarray(paf), jnp.asarray(xy), jnp.asarray(valid),
            jnp.asarray(seq), jnp.asarray(idx))
    want = JP.score_limbs(*args, thre2, mid_num, orig_h=jnp.float32(h))
    pallas = score_limbs_pallas(*args, thre2, mid_num, jnp.float32(h), True)
    limbs = TPS.LimbTable(seq, idx)
    got = TP.score_limbs(torch.from_numpy(paf), torch.from_numpy(xy),
                         torch.from_numpy(valid), limbs, thre2, mid_num,
                         orig_h=float(h))
    np.testing.assert_array_equal(
        got.score.numpy(), TPS.paf_sample_plain(
            torch.from_numpy(paf), torch.from_numpy(xy),
            torch.from_numpy(valid), limbs, thre2, mid_num,
            float(h))[0].numpy())
    for ref in (want, pallas):
        np.testing.assert_array_equal(np.asarray(ref.ok), got.ok.numpy())
        np.testing.assert_array_equal(np.asarray(ref.score), got.score.numpy())
    assert got.ok.sum() > 0


def test_score_one_limb_bit_equal(rng):
    """One limb's ok bits and scores == islx's ``_score_one_limb`` compiled
    alone, bit for bit: the plain version keeps XLA's fused multiply-adds
    and its correctly rounded square root."""
    h, w, k = 92, 64, 16
    paf2 = rng.rand(h, w, 2).astype(np.float32) - 0.4
    a = np.stack([rng.randint(0, w, k), rng.randint(0, h, k)], -1)
    b = np.stack([rng.randint(0, w, k), rng.randint(0, h, k)], -1)
    va = rng.rand(k) > 0.2
    vb = rng.rand(k) > 0.2
    sw, ok = jax.jit(lambda *x: JP._score_one_limb(
        *x, jnp.float32(h), 0.05, 10))(
        jnp.asarray(paf2), jnp.asarray(a, jnp.int32),
        jnp.asarray(b, jnp.int32), jnp.asarray(va), jnp.asarray(vb))
    xy = np.stack([a, b]).astype(np.int32)
    got = TPS.paf_sample(torch.from_numpy(paf2), torch.from_numpy(xy),
                         torch.from_numpy(np.stack([va, vb])),
                         TPS.LimbTable([[0, 1]], [[0, 1]]), 0.05, 10,
                         float(h))
    np.testing.assert_array_equal(np.asarray(sw), got[0][0].numpy())
    np.testing.assert_array_equal(np.asarray(ok), got[1][0].numpy())


def test_sqrt_rn_matches_xla(rng):
    """``runtime.sqrt_rn`` == XLA's f32 sqrt, bit for bit, on every integer
    a squared limb length can take at 1280x720 and on seeded floats, where
    PyTorch's own CPU f32 sqrt is one ulp off for some inputs."""
    from islx_torch.core.runtime import sqrt_rn

    for x in (np.arange(1280 ** 2 + 720 ** 2 + 1, dtype=np.float32),
              (rng.rand(1_000_000) * 1e4).astype(np.float32)):
        np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))),
                                      sqrt_rn(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("mid_num", [10, 7, 3])
def test_sample_positions_are_linspace_words(mid_num):
    np.testing.assert_array_equal(
        np.asarray(jnp.linspace(0.0, 1.0, mid_num)),
        TPS._samples_t(mid_num, "cpu").numpy())


def _peaks8(rng, b, k, h, w):
    """Seeded peak tables [B,25,K,2] on an h x w image, about 1 in 5
    invalid."""
    xy = np.stack([rng.randint(0, w, (b, 25, k)),
                   rng.randint(0, h, (b, 25, k))], -1).astype(np.int32)
    return xy, rng.rand(b, 25, k) > 0.2


@pytest.mark.parametrize("mid_num", [7, 10, 11])
def test_pair_samples8_cells_match_islx(rng, mid_num):
    """The /8 cell of every line sample == islx's ``_pair_samples8``: the
    sample positions are ``jnp.linspace``'s words and the sample point is
    one fused multiply-add, as XLA computes it (``torch.linspace`` and a
    separate multiply and add put a few hundred samples a run in the next
    cell at 7 and 11)."""
    b, h8, w8, k = 4, 23, 18, 16
    xy, valid = _peaks8(rng, b, k, 8 * h8, 8 * w8)
    for limb in JP.LIMB_SEQ_BODY25:
        want = jax.jit(jax.vmap(lambda x, v: JP._pair_samples8(
            x, v, jnp.asarray(limb), 8, h8, w8, mid_num)))(
            jnp.asarray(xy), jnp.asarray(valid))
        got = TP._pair_samples8(torch.from_numpy(xy), torch.from_numpy(valid),
                                tuple(limb.tolist()), 8, h8, w8, mid_num)
        np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy())
        np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())


@pytest.mark.parametrize("count_dtype", ["int32", "int8"])
@pytest.mark.parametrize("mid_num,orig_h", [(10, 48.0), (7, 48.0),
                                            (10, 1000.0)])
def test_score_limbs_cell_score_words_on_one_cell(rng, count_dtype, mid_num,
                                                  orig_h):
    """On a paf8 that is zero but for one cell, each pair's sum over cells
    has at most one nonzero term, so summation order cannot matter and the
    score words must equal islx's exactly, at int32 and int8 counts (the
    port counts in int32: the same integers). The mean is a multiply by
    the f32 reciprocal, fused with the prior's add, as XLA computes it."""
    b, h8, w8, k = 3, 6, 8, 8
    paf8 = np.zeros((b, h8, w8, 52), np.float32)
    xy = np.zeros((b, 25, k, 2), np.int32)
    for i in range(b):
        cy, cx = rng.randint(1, h8 - 1), rng.randint(1, w8 - 1)
        paf8[i, cy, cx] = (rng.rand(52) * 4 - 1).astype(np.float32)
        # peaks around the cell, so that some pairs sample it nine times
        # in ten and pass
        xy[i, ..., 0] = rng.randint(8 * cx - 6, 8 * cx + 14, (25, k))
        xy[i, ..., 1] = rng.randint(8 * cy - 6, 8 * cy + 14, (25, k))
    valid = rng.rand(b, 25, k) > 0.2
    want = jax.vmap(lambda p, x, v: JP.score_limbs_cell(
        p, x, v, jnp.asarray(JP.LIMB_SEQ_BODY25),
        jnp.asarray(JP.MAP_IDX_BODY25), 8, 0.05, mid_num,
        orig_h=jnp.float32(orig_h), count_dtype=getattr(jnp, count_dtype)))(
        jnp.asarray(paf8), jnp.asarray(xy), jnp.asarray(valid))
    got = TP.score_limbs_cell(torch.from_numpy(paf8), torch.from_numpy(xy),
                              torch.from_numpy(valid), TP.LIMB_SEQ_BODY25,
                              TP.MAP_IDX_BODY25, 8, 0.05, mid_num,
                              orig_h=orig_h)
    np.testing.assert_array_equal(np.asarray(want.score), got.score.numpy())
    np.testing.assert_array_equal(np.asarray(want.ok), got.ok.numpy())
    assert got.ok.sum() > 0 and (got.score.numpy() != 0).sum() > 1000


@pytest.mark.parametrize("h,w", [(40, 36), (17, 1), (1, 23)])
def test_label_components_matches_pallas_and_xla(rng, h, w):
    maps = cc_maps(rng, h, w)
    want = np.stack([np.asarray(_label_components(jnp.asarray(maps[:, :, i])))
                     for i in range(maps.shape[2])], -1)
    pallas = np.asarray(label_components_pallas(jnp.asarray(maps),
                                                interpret=True))
    got = TCC.label_components(torch.from_numpy(maps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, pallas)
    np.testing.assert_array_equal(want, got.numpy())


def _min_index_labels(maps):
    """scipy's 8-connected labels renumbered to each component's smallest
    row-major index, background H*W: an independent reference."""
    from scipy import ndimage

    h, w, c = maps.shape
    out = np.full((h, w, c), h * w, np.int64)
    for i in range(c):
        lab, n = ndimage.label(maps[:, :, i], structure=np.ones((3, 3)))
        flat = lab.reshape(-1)
        first = np.full(n + 1, h * w, np.int64)
        np.minimum.at(first, flat, np.arange(h * w))
        first[0] = h * w
        out[:, :, i] = first[flat].reshape(h, w)
    return out


def test_label_components_plain_at_crop_size(rng):
    """The plain version at a 368 px crop (too slow for the XLA sweeps on
    a spiral) against scipy's labels."""
    maps = cc_maps(rng, 368, 368)
    got = TCC.label_components(torch.from_numpy(maps)).numpy()
    np.testing.assert_array_equal(_min_index_labels(maps), got)


@pytest.mark.parametrize("h,w,c,first", [(97, 61, 22, 0), (40, 36, 9, 0),
                                         (1, 40, 3, 0), (40, 1, 3, 4),
                                         (33, 17, 3, 6), (24, 24, 1, 0),
                                         (24, 24, 1, 1)])
def test_label_components_plain_on_tile_maps(rng, h, w, c, first):
    """The plain version on maps built to break a tiled labeller (corner
    joins, a spiral and a snake across every tile, ragged H and W, full
    and empty channels) == scipy's labels and the Pallas kernel's."""
    maps = tile_maps(rng, h, w, c, first)
    got = TCC.label_components(torch.from_numpy(maps)).numpy()
    np.testing.assert_array_equal(_min_index_labels(maps), got)
    pallas = np.asarray(label_components_pallas(jnp.asarray(maps),
                                                interpret=True))
    np.testing.assert_array_equal(pallas, got)


def test_corner_maps_join_only_through_the_corner():
    """corner_map's two lines at each tile corner form one component with
    the diagonal step and two without it."""
    from chip_smoke import corner_map

    for diagonal, cut in (("nw", (8, 8)), ("ne", (8, 7))):
        m = corner_map(24, 24, diagonal)
        lab = _min_index_labels(m[..., None])[..., 0]
        assert len(np.unique(lab[m])) == 4          # one a corner
        m[cut] = False
        lab = _min_index_labels(m[..., None])[..., 0]
        assert len(np.unique(lab[m])) == 5


@pytest.mark.parametrize("h,w,c", [(256, 256, 21), (368, 368, 21),
                                   (736, 736, 21), (97, 61, 22), (1, 40, 1),
                                   (40, 1, 3), (10, 10, 300), (3, 3, 1300)])
def test_cc_tile_plan_covers_each_pixel_once(h, w, c):
    """The kernel's tiles cover every pixel once, and a block's staged rows
    (16-byte multiples, room for a 15-byte head), forest and links fit its
    shared memory, with fewer rows a tile only where C needs it."""
    th, tiles_y, tiles_x, row_bytes, smem = TCC.tile_plan(h, w, c)
    tw = TCC.TILE_W
    seen = np.zeros((h, w), np.int64)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            assert ty * th < h and tx * tw < w
            seen[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
    np.testing.assert_array_equal(seen, 1)
    assert row_bytes % 16 == 0 and row_bytes >= tw * c + 15
    forest, links = th * tw * c, th * (tw + 1) * c
    assert smem == th * row_bytes + 4 * (forest + links) <= TNF.MAX_SMEM
    assert th == TCC.TILE_ROWS or 2 * smem > TNF.MAX_SMEM
    assert forest < 2 ** 16             # a link packs two slots in 32 bits


def test_cc_tile_plan_refuses_too_many_channels():
    with pytest.raises(ValueError):
        TCC.tile_plan(4, 4, 2000)


def _tiled_model(maps, th, tw):
    """The kernel's three passes in numpy, on tiles of th x tw: each tile
    component labelled by its smallest pixel; the border pass's unions,
    larger root under smaller (a tile's top row with N where N is
    foreground, else with NW and NE; its left column with W where W is
    foreground, else with NW and SW); then each pixel's root."""
    h, w, c = maps.shape
    out = np.full((h, w, c), h * w, np.int64)
    for ch in range(c):
        fg = maps[:, :, ch]
        parent = np.full(h * w, h * w, np.int64)
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                sub = fg[y0:y0 + th, x0:x0 + tw]
                loc = _min_index_labels(sub[..., None])[..., 0]
                ly, lx = np.divmod(loc, sub.shape[1])
                glob = (y0 + ly) * w + x0 + lx
                ys, xs = np.nonzero(sub)
                parent[(y0 + ys) * w + x0 + xs] = glob[ys, xs]

        def root(p):
            while parent[p] != p:
                p = parent[p]
            return p

        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                border = []
                if y0 > 0:     # near: N; else NW and NE
                    border += [(y0, x, (-1, 0), ((-1, -1), (-1, 1)))
                               for x in range(x0, min(x0 + tw, w))]
                if x0 > 0:     # near: W; else NW and SW
                    border += [(y, x0, (0, -1), ((-1, -1), (1, -1)))
                               for y in range(y0, min(y0 + th, h))]
                for y, x, near, others in border:
                    if not fg[y, x]:
                        continue
                    ny, nx = y + near[0], x + near[1]
                    for dy, dx in ([near] if fg[ny, nx] else others):
                        yy, xx = y + dy, x + dx
                        if 0 <= yy < h and 0 <= xx < w and fg[yy, xx]:
                            a, b = root(y * w + x), root(yy * w + xx)
                            parent[max(a, b)] = min(a, b)
        lab = np.full(h * w, h * w, np.int64)
        on = np.nonzero(fg.reshape(-1))[0]
        lab[on] = [root(p) for p in on]
        out[:, :, ch] = lab.reshape(h, w)
    return out


@pytest.mark.parametrize("th,tw", [(16, 16), (4, 4), (3, 8), (8, 2)])
def test_tiled_union_find_model_matches_scipy(rng, th, tw):
    """The kernel's algorithm, modelled in numpy, gives the min-index labels
    on the tile maps at ragged shapes: the border pass's links reach every
    8-neighbour pair that crosses a tile edge, corners included."""
    for h, w in [(97, 61), (1, 40), (40, 1)]:
        maps = tile_maps(rng, h, w, 9)
        np.testing.assert_array_equal(_tiled_model(maps, th, tw),
                                      _min_index_labels(maps))
