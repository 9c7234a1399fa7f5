"""islx_torch's CUDA kernels on the card. These tests skip on a machine
without a GPU. They import neither JAX nor islx, so they also run where JAX
is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from chip_smoke import (band_field, band_cases_hold, conv_q_bit_equal,
                        conv_q_inputs, tile_maps)
from islx_torch.ops import cc_label as CC
from islx_torch.ops import conv_q as CQ
from islx_torch.ops import nms_first_k as NF
from islx_torch.ops import nms_mask as N
from islx_torch.ops import paf_sample as PS


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a CUDA kernel has no CPU mode)")


@pytest.mark.gpu
def test_nms_kernel_bit_equal_on_card():
    """The sm_90a kernel == its plain version, bit for bit, at the main
    path's shapes and a ragged one, with plateaus and thre1 ties; then on
    maps with peaks where its row bands meet (band_field), and on an input
    that starts off a 16-byte boundary (the 1-pixel path at a width of
    144)."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(4, 25, 184, 144), (2, 25, 184, 328), (3, 5, 7, 130),
                  (1, 2, 1, 1)]:
        x = torch.rand(shape, device="cuda", generator=g)
        x[..., ::3, ::5] = 0.5
        before = N.nms_mask_rows.launches
        m, c = N.nms_mask_rows(x, 0.5)
        torch.cuda.synchronize()
        assert N.nms_mask_rows.launches == before + 1
        mp, cp = N.nms_mask_rows_plain(x, 0.5)
        assert torch.equal(m, mp) and torch.equal(c, cp)
    for shape in [(192, 25, 184, 144), (16, 25, 184, 328), (3, 25, 37, 130),
                  (2, 3, 40, 1001)]:
        x = band_field(shape, g, 0.5, 32)
        m, c = N.nms_mask_rows(x, 0.5)
        mp, cp = N.nms_mask_rows_plain(x, 0.5)
        assert torch.equal(m, mp) and torch.equal(c, cp)
    x = band_field((3, 5, 184, 144), g, 0.5, 32)
    off = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 != 0
    m, c = N.nms_mask_rows(off, 0.5)
    mp, cp = N.nms_mask_rows_plain(x, 0.5)
    assert torch.equal(m, mp) and torch.equal(c, cp)


@pytest.mark.gpu
def test_nms_kernel_refuses_what_it_cannot_take():
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    _need_gpu()
    x = torch.rand(2, 3, 8, 9, device="cuda")
    before = N.nms_mask_rows.launches
    for bad in (x.double(), x[0], x.transpose(2, 3)):
        with pytest.raises((TypeError, ValueError)):
            N.nms_mask_rows(bad, 0.5)
    assert N.nms_mask_rows.launches == before


def cc_maps(rng, h, w):
    """[H,W,C] test maps: spiral, snake, full, empty, diagonal-only
    contacts and seeded random blobs (tile_maps without its corner
    maps)."""
    return tile_maps(rng, h, w, 7, first=2)


@pytest.mark.gpu
def test_nms_first_k_bit_equal_on_card():
    """The NMS+first-K kernel == its plain version, bit for bit, for both
    border contracts, at the main path's shapes and ragged ones (W = 130:
    odd rows start off a 16-byte boundary), K = 1 included."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape, k in [((4, 25, 184, 144), 32), ((2, 25, 184, 328), 32),
                     ((1, 3, 720, 1280), 32), ((3, 5, 7, 130), 16),
                     ((3, 25, 37, 130), 32), ((3, 25, 37, 130), 1),
                     ((1, 2, 1, 1), 4), ((1, 2, 1, 1), 1)]:
        x = torch.rand(shape, device="cuda", generator=g) - 0.2
        x[..., ::3, ::5] = 0.5
        for thre, border in [(0.5, 0.0), (0.0, 0.0), (-0.1, -float("inf"))]:
            before = NF.nms_first_k.launches
            got = NF.nms_first_k(x, thre, k, border)
            torch.cuda.synchronize()
            assert NF.nms_first_k.launches == before + 1
            assert torch.equal(got, NF.nms_first_k_plain(x, thre, k, border))


@pytest.mark.gpu
def test_nms_first_k_bit_equal_on_sparse_planes():
    """Whole planes read: a few planted peaks a plane, some in the last
    rows and one plane whose K-th peak falls late; then peaks where the
    kernel's row bands meet (band_field): on a band's first and last row,
    a band that alone holds K peaks before fuller ones, a K-th peak in the
    last band and fewer than K peaks, for K = 32 and K = 1."""
    _need_gpu()
    from chip_smoke import planted_field

    g = torch.Generator(device="cuda").manual_seed(4)
    for shape in [(1, 25, 720, 1280), (8, 25, 184, 144), (3, 5, 37, 130)]:
        x = planted_field(shape, g, 0.6, 32)
        for border in (0.0, -float("inf")):
            got = NF.nms_first_k(x, 0.6, 32, border)
            want = NF.nms_first_k_plain(x, 0.6, 32, border)
            n = shape[2] * shape[3]
            assert torch.equal(got, want)
            assert bool((want >= n - 1024).any() & (want < n).any())
    # [192,25,184,144] has each block read 4 bands in turn
    for shape in [(1, 25, 720, 1280), (192, 25, 184, 144), (2, 25, 184, 328),
                  (3, 5, 7, 130), (3, 25, 37, 130), (1, 2, 1, 1)]:
        h, w = shape[2:]
        for k in (32, 1):
            x = band_field(shape, g, 0.5, k)
            for border in (0.0, -float("inf")):
                want = NF.nms_first_k_plain(x, 0.5, k, border)
                assert torch.equal(NF.nms_first_k(x, 0.5, k, border), want)
            if NF.band_plan(h, w)[1] > 1:
                assert band_cases_hold(want, h, w, k)


@pytest.mark.gpu
@pytest.mark.parametrize("mid_num", [1, 2, 4, 7, 8, 10, 11, 16, 17, 20])
@pytest.mark.parametrize("table", ["body25", "coco"])
@pytest.mark.parametrize("layout", ["channel pairs", "odd channels",
                                    "off 8 bytes"])
def test_paf_sample_bit_equal_on_card(mid_num, table, layout):
    """The fused PAF sampling kernel == its plain version on the card: ok
    and score words bit for bit (both round every step the same way), one
    launch a call, for both limb tables, with the tables' channels
    (cx, cx + 1), cx even, with odd first channels, and on a map that
    starts off an 8-byte boundary; some invalid peaks lie outside the map,
    two past 2^24."""
    _need_gpu()
    from islx_torch.ops.paf import LIMB_TABLES

    rng = np.random.RandomState(2)
    h, w, c, k = 184, 240, 25, 12
    paf = torch.from_numpy(rng.rand(h, w, 52).astype(np.float32) - 0.4)
    xy = np.stack([rng.randint(0, w, (c, k)), rng.randint(0, h, (c, k))], -1)
    valid = rng.rand(c, k) > 0.3
    far = np.array([[-7, h + 3], [w + 40, -1], [2 ** 30, 5],
                    [-2 ** 31, 2 ** 31 - 1]])
    bad = np.argwhere(~valid)
    xy[tuple(bad[:4].T)] = far[:len(bad[:4])]
    seq, idx = LIMB_TABLES[table]
    card = paf.cuda()
    if layout == "odd channels":
        idx = (idx + 1) % 52
    elif layout == "off 8 bytes":
        card = torch.empty(paf.numel() + 1, device="cuda")[1:].view(h, w, 52)
        card.copy_(paf)
    limbs = PS.LimbTable(seq, idx)
    # from mid 16 a pair needs 0.8 * mid samples over thre2: a lower
    # threshold lets some pairs of the random map pass
    thre2 = 0.05 if mid_num < 16 else -0.1
    args = (card, torch.from_numpy(xy.astype(np.int32)).cuda(),
            torch.from_numpy(valid).cuda(), limbs, thre2, mid_num, float(h))
    before = PS.paf_sample.launches
    score, ok = PS.paf_sample(*args)
    torch.cuda.synchronize()
    assert PS.paf_sample.launches == before + 1
    pscore, pok = PS.paf_sample_plain(*args)
    assert torch.equal(ok, pok) and bool(ok.any())
    assert torch.equal(score.view(torch.int32), pscore.view(torch.int32))


@pytest.mark.gpu
def test_cc_label_bit_equal_on_card():
    """The tiled union-find kernel == its plain version, bit for bit, one
    launch a call: on the spiral, snake, full and blob maps; on maps built
    to break a tiled labeller (tile_maps: components joined only through a
    tile corner's NW or NE diagonal, a spiral and a snake across every
    tile, full and empty channels) at the Hand call's crop sizes and at
    ragged shapes with C = 1, 3 and 22, each kind of map at C = 1; and on
    an input that starts off a 16-byte boundary."""
    _need_gpu()
    rng = np.random.RandomState(3)
    maps = [cc_maps(rng, h, w) for h, w in [(368, 368), (97, 61), (1, 40)]]
    maps += [tile_maps(rng, h, w, c) for h, w, c in [
        (256, 256, 21), (368, 368, 21), (736, 736, 21), (97, 61, 22),
        (97, 61, 3), (1, 40, 3), (40, 1, 22), (33, 130, 22)]]
    maps += [tile_maps(rng, 97, 61, 1, first) for first in range(9)]
    for m in maps:
        m = torch.from_numpy(m).cuda()
        before = CC.label_components.launches
        got = CC.label_components(m)
        torch.cuda.synchronize()
        assert CC.label_components.launches == before + 1
        assert torch.equal(got, CC.label_components_plain(m)), m.shape
    m = torch.from_numpy(tile_maps(rng, 97, 61, 22)).cuda()
    off = torch.empty(m.numel() + 1, dtype=torch.bool,
                      device="cuda")[1:].view(m.shape)
    off.copy_(m)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(CC.label_components(off),
                       CC.label_components_plain(m))


@pytest.mark.gpu
def test_new_kernels_refuse_what_they_cannot_take():
    """Bad CUDA inputs raise before any launch; nothing falls back."""
    _need_gpu()
    x = torch.rand(2, 3, 8, 9, device="cuda")
    before = NF.nms_first_k.launches
    for bad in (x.double(), x[0], x.transpose(2, 3)):
        with pytest.raises((TypeError, ValueError)):
            NF.nms_first_k(bad, 0.5, 4)
    assert NF.nms_first_k.launches == before
    m = torch.rand(8, 9, 3, device="cuda") > 0.5
    before = CC.label_components.launches
    for bad in (m.to(torch.uint8), m[0], m.transpose(0, 1)):
        with pytest.raises((TypeError, ValueError)):
            CC.label_components(bad)
    assert CC.label_components.launches == before
    paf = torch.rand(8, 9, 4, device="cuda")
    xy = torch.zeros(2, 3, 2, dtype=torch.int32, device="cuda")
    valid = torch.ones(2, 3, dtype=torch.bool, device="cuda")
    seq, idx = np.array([[0, 1]]), np.array([[2, 3]])
    limbs = PS.LimbTable(seq, idx)
    before = PS.paf_sample.launches
    for args in ((paf.double(), xy, valid), (paf, xy.long(), valid),
                 (paf, xy, valid.int()), (paf, xy, valid.cpu()),
                 (paf.transpose(0, 1), xy, valid)):
        with pytest.raises((TypeError, ValueError)):
            PS.paf_sample(*args, limbs)
    with pytest.raises(ValueError):
        PS.paf_sample(paf, xy, valid, PS.LimbTable(seq, [[2, 4]]))
    with pytest.raises(ValueError):
        PS.paf_sample(paf, xy, valid, PS.LimbTable(
            np.zeros((PS.MAX_LIMBS + 1, 2)), np.zeros((PS.MAX_LIMBS + 1, 2))))
    with pytest.raises(TypeError):
        PS.paf_sample(paf, xy, valid, seq, idx)
    with pytest.raises(ValueError):
        PS.paf_sample(paf, xy, valid, limbs, mid_num=0)
    big = torch.zeros(2, 1025, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        PS.paf_sample(paf, big, torch.ones(2, 1025, dtype=torch.bool,
                                           device="cuda"), limbs)
    assert PS.paf_sample.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("k,cin,cout", [(1, 128, 22), (3, 3, 64),
                                        (3, 288, 96), (7, 150, 128),
                                        (7, 206, 52), (1, 27, 26),
                                        (3, 64, 128), (3, 180, 96),
                                        (7, 128, 128), (3, 512, 512),
                                        (1, 512, 26), (3, 100, 22)])
@pytest.mark.parametrize("act", ["relu", "prelu", "none"])
@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
def test_conv_q_bit_equal_on_card(k, cin, cout, act, out):
    """The int8 implicit-GEMM kernel == conv_q_plain, word for word, one
    launch a call: k 1, 3 and 7; cin 3, 27 (conv1_1's patches), 64, 128,
    150, 180, 512 and ragged ones (100, 206, 288: each tap's last K step 32,
    64 or 128 channels wide); cout 22, 26, 52, 96, 128 and 512 (each wgmma
    width, and the grid over N); each activation and output conversion, on
    a ragged map (odd H and W, pixels not a multiple of the tile's 128)
    whose 7x7 halo covers most of it."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(k * 7 + cin)
    conv_q_bit_equal(conv_q_inputs(gen, 3, 9, 13, cin, cout, k, act,
                                   getattr(torch, out)))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", [(2, 23, 18), (1, 1, 1), (5, 3, 37)])
def test_conv_q_patch_path_bit_equal_on_card(b, h, w):
    """conv1_1 in patch mode on the card: the quantize kernel's 3x3x3
    patches byte-equal to quantize_plain's, and conv_q over them (a 1x1
    conv over 27 channels) word-equal to conv_q_plain and to the plain 3x3
    conv over the plain quantized input; one launch each."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(b * h * w)
    x = torch.randn(b, h, w, 3, generator=gen, device="cuda") * 2
    inv = 127.0 / 5.0
    before = CQ.quantize.launches
    patches = CQ.quantize(x, inv, patch=3)
    torch.cuda.synchronize()
    assert CQ.quantize.launches == before + 1
    assert torch.equal(patches, CQ.quantize_plain(x, inv, patch=3))
    assert patches.shape == (b, h, w, 32) and not patches[..., 27:].any()
    w_q = torch.randint(-127, 128, (64, 3, 3, 3), generator=gen,
                        device="cuda", dtype=torch.int32).to(torch.int8)
    scale = torch.rand(64, generator=gen, device="cuda") * 1e-4
    bias = torch.randn(64, generator=gen, device="cuda")
    w1 = CQ.pack_weights(w_q.permute(0, 2, 3, 1).reshape(64, 27, 1, 1))
    args = (patches, w1, 27, scale, bias, None, "relu", torch.int8, 30.0)
    conv_q_bit_equal(args)
    direct = CQ.conv_q_plain(CQ.quantize_plain(x, inv), CQ.pack_weights(w_q),
                             3, scale, bias, None, "relu", torch.int8, 30.0)
    assert torch.equal(CQ.conv_q(*args), direct)


@pytest.mark.gpu
def test_conv_q_refuses_what_it_cannot_take():
    """A CUDA input the kernel does not take raises, and so does a patch
    mode the quantize kernel does not take; nothing falls back to the plain
    version, and no refused call counts a launch."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w_pack, cin, scale, bias, slope, act, dt, oi = conv_q_inputs(
        gen, 1, 5, 5, 150, 64, 3, "prelu", torch.float32)
    before = CQ.conv_q.launches
    bad = [
        (x[..., :150].contiguous(), w_pack, cin, 64),    # stride not 16 x n
        (x[:, :, :, 1:].contiguous(), w_pack, cin, 64),  # 159 channels
        (x.float(), w_pack, cin, 64),                    # not int8
        (x, w_pack[:, :, :128], cin, 64),                # packed for 128 in
        (x, w_pack[:, :4], cin, 64),                     # not k x k taps
        (x, w_pack, cin, 63),                            # odd cout
    ]
    for xx, pp, ci, co in bad:
        with pytest.raises((TypeError, ValueError)):
            CQ.conv_q(xx, pp, ci, scale[:co], bias[:co], slope[:co], act, dt)
    with pytest.raises(ValueError):
        CQ.conv_q(x, w_pack, cin, scale, bias, None, "prelu", dt)
    with pytest.raises(ValueError):
        CQ.conv_q(x, w_pack, cin, scale, bias, slope, act, torch.int8)
    with pytest.raises(ValueError):
        CQ.conv_q(x, w_pack, cin, scale.cpu(), bias, slope, act, dt)
    assert CQ.conv_q.launches == before
    before = CQ.quantize.launches
    f = torch.rand(2, 5, 5, 4, device="cuda")
    for xx, patch in ((f, 3), (f[..., :2], 3), (f[..., :3], 5),
                      (f[0, ..., :3], 3)):
        with pytest.raises(ValueError):          # patches of 4 or 2 channels,
            CQ.quantize(xx, 1.0, patch)          # a 5x5 patch, not 4-D
    assert CQ.quantize.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((3, 9, 13, 3), "float32"),
                                         ((2, 5, 7, 150), "float32"),
                                         ((2, 5, 7, 288), "bfloat16"),
                                         ((1, 1, 1, 206), "bfloat16")])
def test_quantize_bit_equal_on_card(shape, dtype):
    """The quantize kernel == quantize_plain, byte for byte (the padding
    channels zero), one launch a call, on an NHWC view of a channels_last
    tensor and on a contiguous one, with .5 ties and out-of-range values;
    3-channel inputs also in patch mode (3x3 patches)."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(shape[-1])
    x = (torch.randn(shape, generator=gen, device="cuda") * 200).to(
        getattr(torch, dtype))
    x.view(-1)[::5] = 2.5
    nchw = x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    patch = 3 if shape[-1] == 3 else 0
    for inp in (x, nchw.permute(0, 2, 3, 1)):
        for inv in (1.0, 0.37, 127.0 / 3e-8):
            for p in {0, patch}:
                before = CQ.quantize.launches
                got = CQ.quantize(inp, inv, p)
                torch.cuda.synchronize()
                assert CQ.quantize.launches == before + 1
                assert torch.equal(got, CQ.quantize_plain(inp, inv, p))


@pytest.mark.gpu
def test_resize_u8_kernel_bit_equal_on_card():
    """The sm_90a bicubic resize == its plain version on the card and on the
    CPU, word for word: camera frames to their buckets, the calibration's
    square, upscales and a ragged shape; it counts its launches and refuses
    a strided batch."""
    _need_gpu()
    from islx_torch.ops import resize_u8 as R

    g = torch.Generator(device="cuda").manual_seed(0)
    for (h, w), (oh, ow) in [((480, 640), (184, 248)),
                             ((720, 1280), (184, 328)),
                             ((184, 328), (184, 184)), ((97, 131), (61, 203)),
                             ((5, 7), (184, 184)), ((1, 1), (3, 3))]:
        x = torch.randint(0, 256, (3, h, w, 3), dtype=torch.uint8,
                          device="cuda", generator=g)
        before = R.resize_u8.launches
        got = R.resize_u8(x, oh, ow)
        torch.cuda.synchronize()
        assert R.resize_u8.launches == before + 1
        assert torch.equal(got, R.resize_u8_plain(x, oh, ow))
        assert torch.equal(got.cpu(), R.resize_u8_plain(x.cpu(), oh, ow))
    strided = torch.zeros(2, 8, 10, 3, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        R.resize_u8(strided[:, :, ::2], 4, 4)
