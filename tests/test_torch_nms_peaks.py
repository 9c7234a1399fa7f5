"""islx_torch ops against islx on the same inputs (CPU): I420 ingest, the
blur/resize matrices, the batched crop-resize, the NMS mask (the CUDA
kernel's plain version vs the Pallas kernel in interpret mode) and the
fused body peaks."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.ops import blur as JB
from islx.ops import peaks as JPK
from islx.ops import resize as JR
from islx.ops import yuv as JY
from islx.ops.pallas_peaks import nms_mask_rows as pallas_nms_mask_rows
from islx_torch.ops import _bands
from islx_torch.ops import blur as TB
from islx_torch.ops import nms_mask as TN
from islx_torch.ops import peaks as TPK
from islx_torch.ops import resize as TR
from islx_torch.ops import yuv as TY


def test_yuv420_to_bgr_exact(rng):
    """Integer-valued output: exactly equal, including clip at 0 and 255."""
    b, h, w = 3, 24, 34
    frames = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    frames[0, :4] = 0
    frames[1, :4] = 255
    flat = JY.bgr_to_yuv420_host(frames)
    np.testing.assert_array_equal(flat, TY.bgr_to_yuv420_host(frames))
    want = np.asarray(JY.yuv420_to_bgr(jnp.asarray(flat), b, h, w))
    got = TY.yuv420_to_bgr(torch.from_numpy(flat), b, h, w).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n_in,n_out,sigma", [(23, 184, 3.0), (18, 144, 3.0),
                                              (6, 48, 3.0), (1, 8, 3.0),
                                              (11, 11, 0.375)])
def test_matrices_exact(n_in, n_out, sigma):
    """The host-built blur, resize and blur∘upsample matrices: bit-equal."""
    np.testing.assert_array_equal(JB._blur_matrix(n_out, sigma),
                                  TB._blur_matrix(n_out, sigma))
    np.testing.assert_array_equal(JR._resize_matrix(n_in, n_out),
                                  TR._resize_matrix(n_in, n_out))
    np.testing.assert_array_equal(
        JPK._blurred_upsample_matrix(n_in, n_out, sigma),
        TPK._blurred_upsample_matrix(n_in, n_out, sigma))


def test_gaussian_blur_f32(rng):
    """Same matrices, f32 contraction: differs by summation order only."""
    img = rng.rand(2, 11, 9, 5).astype(np.float32)
    want = np.asarray(jax.vmap(lambda x: JB.gaussian_blur(x, 0.375))(
        jnp.asarray(img)))
    got = TB.gaussian_blur(torch.from_numpy(img), 0.375).numpy()
    np.testing.assert_allclose(want, got, rtol=1e-6, atol=1e-6)


def test_dynamic_crop_resize_batch_exact(rng):
    """Crops after rint/clip: exactly equal to islx's jitted crops (as its
    fused step computes them), boxes at the frame edge too."""
    b, h, w = 2, 40, 56
    frames = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    # (frame, x0, y0, w): interior, top-left corner, right/bottom edge,
    # a 1-px box, a box wider than the frame's remaining height
    boxes = np.array([[0, 5, 7, 20], [1, 0, 0, 13], [0, 40, 24, 16],
                      [1, 55, 39, 1], [1, 30, 20, 33]], np.int32)
    for size in (46, 92):
        want = np.asarray(jax.jit(JR.dynamic_crop_resize_batch,
                                  static_argnums=5)(
            jnp.asarray(frames), *[jnp.asarray(boxes[:, i]) for i in range(4)],
            size))
        got = TR.dynamic_crop_resize_batch(
            torch.from_numpy(frames),
            *[torch.from_numpy(boxes[:, i]) for i in range(4)], size).numpy()
        np.testing.assert_array_equal(want, got)


def _nms_cases():
    rng = np.random.RandomState(3)
    maps = rng.rand(2, 5, 17, 23).astype(np.float32)
    maps[0, 0, 4:7, 3:6] = 0.9                   # plateau: >= ties
    maps[0, 1, 2, :] = 0.55                      # value == thre1 (not > )
    maps[1, 2, 8, 8] = 0.55
    maps[1, 3, 0, :] = 0.95                      # plateau along the border
    maps[1, 4] = 0.7                             # flat channel
    return [
        ("random+plateaus", maps, 0.55),
        ("row", rng.rand(2, 3, 1, 31).astype(np.float32), 0.3),
        ("column", rng.rand(2, 3, 29, 1).astype(np.float32), 0.3),
        ("pixel", rng.rand(1, 4, 1, 1).astype(np.float32), 0.3),
        ("negative", rng.rand(1, 2, 9, 9).astype(np.float32) - 0.5, 0.1),
    ]


@pytest.mark.parametrize("case", _nms_cases(), ids=lambda c: c[0])
def test_nms_mask_rows_plain_vs_pallas(case):
    """The CUDA kernel's plain version == the Pallas kernel (interpret):
    mask and row counts bit-equal; the CPU wrapper takes the plain path."""
    _, maps, thre = case
    want_m, want_c = pallas_nms_mask_rows(jnp.asarray(maps),
                                          jnp.float32(thre), interpret=True)
    got_m, got_c = TN.nms_mask_rows(torch.from_numpy(maps), thre)
    assert got_m.dtype == torch.uint8 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_m), got_m.numpy())
    np.testing.assert_array_equal(np.asarray(want_c), got_c.numpy())


def _band_maps(seed, b, c, h, w, thre):
    """Seeded maps [B,C,H,W] with structure where the kernel's row bands
    (``_bands.band_plan``) meet: in every band a peak on its first and its
    last row, a first-row pixel that only the halo row above suppresses,
    and a 2x3 plateau across each band boundary (all six pixels peak)."""
    rng = np.random.RandomState(seed)
    maps = (rng.rand(b, c, h, w) * (thre + 0.1)).astype(np.float32)
    rows, bands, _ = _bands.band_plan(h, w)
    for band in range(bands):
        y0, y1 = band * rows, min((band + 1) * rows, h)
        col = (13 * band + 3) % (w - 13)
        maps[..., y0, col] = thre + 0.4
        if y0 > 0:
            maps[..., y0, col + 2] = thre + 0.35
            maps[..., y0 - 1, col + 2] = thre + 0.45
        maps[..., y1 - 1, col + 4] = thre + 0.4
        if y1 < h:
            maps[..., y1 - 1:y1 + 1, col + 6:col + 9] = thre + 0.3
    return maps


@pytest.mark.parametrize("shape", [(2, 3, 184, 144), (3, 5, 37, 130),
                                   (2, 3, 40, 1001)])
def test_nms_mask_rows_on_band_boundaries(shape):
    """Peaks, halo-suppressed pixels and plateaus where the CUDA kernel's
    row bands meet: the wrapper's CPU path == the Pallas kernel
    (interpret), mask and row counts bit-equal."""
    thre = 0.5
    maps = _band_maps(5, *shape, thre)
    want_m, want_c = pallas_nms_mask_rows(jnp.asarray(maps),
                                          jnp.float32(thre), interpret=True)
    got_m, got_c = TN.nms_mask_rows(torch.from_numpy(maps), thre)
    np.testing.assert_array_equal(np.asarray(want_m), got_m.numpy())
    np.testing.assert_array_equal(np.asarray(want_c), got_c.numpy())
    rows, bands, _ = _bands.band_plan(*shape[2:])
    assert bands > 1
    # every band's first and last row holds a peak; a pixel only the halo
    # row above suppresses is no peak
    first = got_m.numpy()[..., ::rows, :].any(-1)
    last = got_m.numpy()[..., rows - 1::rows, :].any(-1)
    assert first.all() and last.all()
    assert not got_m[..., rows, (13 + 3) % (shape[3] - 13) + 2].any()
    plateau = got_m[..., rows - 1:rows + 1, 3 + 6:3 + 9]
    assert bool(plateau.all())


def test_nms_mask_nan_is_no_peak():
    maps = np.full((1, 1, 3, 3), 0.5, np.float32)
    maps[0, 0, 1, 1] = np.nan
    m, c = TN.nms_mask_rows(torch.from_numpy(maps), 0.1)
    assert m[0, 0, 1, 1] == 0
    # a NaN neighbour fails its comparison too
    assert int(c.sum()) == 4 and m[0, 0, 0, 0] == 1


def test_nms_wrapper_counts_only_kernel_launches():
    before = TN.nms_mask_rows.launches
    TN.nms_mask_rows(torch.rand(1, 2, 4, 5), 0.5)
    assert TN.nms_mask_rows.launches == before      # CPU: plain version
    with pytest.raises(ValueError):
        TN.nms_mask_rows(torch.empty(1, 2, 4, 5, device="meta"), 0.5)


@pytest.mark.parametrize("k", [4, 8])
def test_first_k_masked_rows_matches(rng, k):
    """Row-blocked first-K selection on the same mask: exact."""
    mask = (rng.rand(3, 6, 13, 11) > 0.93).astype(np.uint8)
    mask[0, 0] = 1                                  # more than K in a row
    cnt = mask.sum(-1).astype(np.int32)
    want = np.stack([np.asarray(JPK._first_k_masked_rows(
        jnp.asarray(mask[i]), k, jnp.asarray(cnt[i]))) for i in range(3)])
    got = TPK._first_k_masked_rows(torch.from_numpy(mask), k,
                                   torch.from_numpy(cnt)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("shape", [(2, 12, 9, 7, 96, 72), (3, 6, 6, 25, 48, 48)])
def test_find_peaks_fused_batched_matches(rng, shape):
    """kernel='mask' epilogue on the same heat8: indices, valid and counts
    exact; scores f32-tight (summation order)."""
    b, h8, w8, c, h_out, w_out = shape
    heat8 = rng.rand(b, h8, w8, c).astype(np.float32)
    thre = 0.4
    want = JPK.find_peaks_fused_batched(jnp.asarray(heat8), h_out, w_out,
                                        jnp.float32(thre), 8, interpret=True,
                                        kernel="mask")
    got = TPK.find_peaks_fused_batched(torch.from_numpy(heat8), h_out, w_out,
                                       thre, 8)
    np.testing.assert_array_equal(np.asarray(want.xy), got.xy.numpy())
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_array_equal(np.asarray(want.count), got.count.numpy())
    assert int(got.count.sum()) > 0
    np.testing.assert_allclose(np.asarray(want.score), got.score.numpy(),
                               rtol=1e-5, atol=1e-6)

