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
from test_torch_gpu import cc_maps


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


@pytest.mark.parametrize("mid_num,thre2", [(10, 0.05), (7, -0.1)])
def test_score_limbs_matches_pallas_and_xla(rng, mid_num, thre2):
    """ok and score bit for bit (the norm's square root is correctly
    rounded, as XLA's is: PyTorch's CPU f32 sqrt is not)."""
    h, w, k, c = 92, 64, 16, 25
    paf = rng.rand(h, w, 52).astype(np.float32) - 0.4
    xy, valid = _peak_tables(rng, c, k, h, w)
    args = (jnp.asarray(paf), jnp.asarray(xy), jnp.asarray(valid),
            jnp.asarray(JP.LIMB_SEQ_BODY25), jnp.asarray(JP.MAP_IDX_BODY25))
    want = JP.score_limbs(*args, thre2, mid_num, orig_h=jnp.float32(h))
    pallas = score_limbs_pallas(*args, thre2, mid_num, jnp.float32(h), True)
    got = TP.score_limbs(torch.from_numpy(paf), torch.from_numpy(xy),
                         torch.from_numpy(valid), JP.LIMB_SEQ_BODY25,
                         JP.MAP_IDX_BODY25, thre2, mid_num, orig_h=float(h))
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
                         np.array([[0, 1]]), np.array([[0, 1]]), 0.05, 10,
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
