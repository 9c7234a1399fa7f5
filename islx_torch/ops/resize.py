"""Bicubic resize with cv2 INTER_CUBIC semantics (A=-0.75), as matmuls
(port of islx/ops/resize.py).

Static resizes use host-built [n_out, n_in] matrices; the batched hand-crop
resize builds its matrices on the device from each crop's (start, width).
All contractions run in f32 (``resize_cubic`` inside ``true_f32``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from islx_torch.core.runtime import div, true_f32

_A = -0.75  # cv2's bicubic coefficient


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """cv2 interpolateCubic: 4 tap weights for fractional offset x in [0,1)."""
    A = _A
    w = np.empty(x.shape + (4,), np.float64)
    w[..., 0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    w[..., 1] = ((A + 2) * x - (A + 3)) * x * x + 1
    w[..., 2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    w[..., 3] = 1.0 - w[..., 0] - w[..., 1] - w[..., 2]
    return w


@functools.lru_cache(maxsize=256)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] cubic interpolation matrix (border replicate)."""
    scale = n_in / n_out
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    w = _cubic_coeffs(src - i0)
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    for t in range(4):
        cols = np.clip(i0 - 1 + t, 0, n_in - 1)
        np.add.at(mat, (rows, cols), w[:, t].astype(np.float32))
    return mat


def cv2_round(x: float) -> int:
    """cvRound: round half to even (cv2 uses it for fx/fy -> dsize)."""
    return int(np.rint(x))


def output_size(size: int, f: float) -> int:
    return cv2_round(size * f)


def resize_cubic(img: torch.Tensor, h_out: int, w_out: int,
                 saturate_uint8: bool = False) -> torch.Tensor:
    """Resize [..., H, W, C] (channels last) to (h_out, w_out), cv2
    INTER_CUBIC, in f32. ``saturate_uint8`` rounds half to even and clips
    to [0, 255], as cv2's uint8 resize does."""
    dev = img.device
    r = torch.from_numpy(_resize_matrix(img.shape[-3], h_out)).to(dev)
    c = torch.from_numpy(_resize_matrix(img.shape[-2], w_out)).to(dev)
    with true_f32():
        x = torch.einsum("oh,...hwc->...owc", r, img.float())
        x = torch.einsum("pw,...owc->...opc", c, x)
    if saturate_uint8:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x


def _cubic_weight(t: torch.Tensor) -> torch.Tensor:
    """cv2 bicubic kernel value at offset t (A=-0.75)."""
    a = torch.abs(t)
    w1 = ((_A + 2) * a - (_A + 3)) * a * a + 1
    w2 = ((_A * a - 5 * _A) * a + 8 * _A) * a - 4 * _A
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(a < 1, w1, torch.where(a < 2, w2, zero))


def _dynamic_axis_matrix(n_in: int, out_size: int, start: torch.Tensor,
                         width: torch.Tensor) -> torch.Tensor:
    """[N, out_size, n_in] cubic matrices for crops [start, start+width)
    resized to out_size, built on the device in f32.

    Same operation order as the JAX code: src = start + (j+0.5)*width/out
    - 0.5, then floor, 4 taps clamped into the crop (replicate border)."""
    dev = start.device
    start = start.float()[:, None, None]
    width = width.float()[:, None, None]
    j = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(n_in, dtype=torch.float32, device=dev)[None, None, :]
    src = start + div((j + 0.5) * width, out_size) - 0.5   # [N,out,1]
    base = torch.floor(src)
    lo = start
    hi = start + width - 1.0
    mat = torch.zeros((start.shape[0], out_size, n_in), dtype=torch.float32,
                      device=dev)
    for d in range(-1, 3):
        tap = base + d
        wgt = _cubic_weight(src - tap)
        clamped = torch.minimum(torch.maximum(tap, lo), hi)
        mat = mat + wgt * (i == clamped)
    return mat


def dynamic_crop_resize_batch(frames: torch.Tensor, fidx: torch.Tensor,
                              x0: torch.Tensor, y0: torch.Tensor,
                              w: torch.Tensor, out_size: int
                              ) -> torch.Tensor:
    """frames [B,H,W,C], per-crop (fidx, x0, y0, w) [N] -> crops
    [N,out,out,C] f32: crop [y0:y0+w, x0:x0+w] of frame fidx, cv2-cubic
    resized, rounded half to even and clipped to [0, 255]."""
    h, wd = frames.shape[1], frames.shape[2]
    ry = _dynamic_axis_matrix(h, out_size, y0, w)           # [N,out,H]
    rx = _dynamic_axis_matrix(wd, out_size, x0, w)          # [N,out,W]
    src = frames[fidx.long()].float()                       # [N,H,W,C]
    x = torch.einsum("noh,nhwc->nowc", ry, src)
    x = torch.einsum("npw,nowc->nopc", rx, x)
    return torch.clamp(torch.round(x), 0.0, 255.0)
