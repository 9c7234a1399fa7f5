"""u8 BGR frames resized as ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_CUBIC)`` computes them with its default Intel IPP
path (cv2 4.x/5.x pip wheels, x86-64), word for word.

islx resizes every served frame to its 184-row bucket with cv2
(``islx/serve/batcher.py``, ``islx/pipeline/batch_pose.py``); the port's
machine has no cv2. On a CUDA tensor :func:`resize_u8` launches the
hand-written kernel in ``islx_torch/csrc/resize_u8.cu``; on a CPU tensor it
runs :func:`resize_u8_plain`, the plain PyTorch version of the same
arithmetic. There is no fallback between the two.

The arithmetic, probed against cv2 on frames built to sit on rounding
ties (each op's rounding shows there):

* taps (:func:`taps`, once per (in, out) length, on the host): source
  coordinate ``x = (d + 0.5) * in / out - 0.5`` in f64, ``i = floor(x)``;
  the fraction is rounded to f32 and then once more to the f32 grid of
  ``1 + t``; the four Keys weights (A = -0.75) of that fraction are
  computed in f64 and rounded to f32; tap indices ``i-1..i+2`` clamped to
  the frame (border replicate);
* horizontal pass, per source row: ``p0*w0`` rounded to f32, then
  ``fma(p1, w1, acc)``, ``fma(p2, w2, acc)``, ``fma(p3, w3, acc)``, each
  rounded once (f32 FMA);
* vertical pass over the four f32 row sums ``r``: ``fma(r0, v0, r1*v1) +
  fma(r2, v2, r3*v3)`` in f32;
* round half to even, clamp to 0..255.

Frames under 4 pixels on a side take another path in cv2 (not IPP's),
which this does not follow (ROADMAP.md §3).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from islx_torch.ops import _build

_A = -0.75   # cv2's bicubic coefficient


@functools.lru_cache(maxsize=64)
def taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tap indices [n_out, 4] int32, weights [n_out, 4] f32) of a resize
    from ``n_in`` to ``n_out`` samples along one axis (cached; read-only)."""
    if n_in < 1 or n_out < 1:
        raise ValueError(f"taps: lengths {n_in} -> {n_out}")
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i = np.floor(x)
    t32 = (x - i).astype(np.float32)
    t = (np.float32(1) + t32).astype(np.float64) - 1.0

    def far(s):
        return ((_A * s - 5 * _A) * s + 8 * _A) * s - 4 * _A

    def near(s):
        return ((_A + 2) * s - (_A + 3)) * s * s + 1

    w = np.stack([far(t + 1), near(t), near(1 - t), far(2 - t)], -1
                 ).astype(np.float32)
    idx = np.clip(i.astype(np.int64)[:, None] + np.arange(-1, 3)[None], 0,
                  n_in - 1).astype(np.int32)
    idx.flags.writeable = False
    w.flags.writeable = False
    return idx, w


def _f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> the nearest f32 value, held in f64."""
    return x.to(torch.float32).to(torch.float64)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The f32 FMA ``a * b + c`` rounded once, for f32 values held in f64:
    the product is exact in f64; the sum is rounded to odd in f64 (exact
    two-sum, then the last bit set where it was inexact), whose rounding
    to f32 is the exact sum's."""
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where((err != 0) & even, (bits + step).view(torch.float64), s)
    return _f32(s)


def _frames4(frames: torch.Tensor, what: str) -> torch.Tensor:
    if frames.dtype != torch.uint8:
        raise TypeError(f"{what}: need uint8 frames, got {frames.dtype}")
    if frames.dim() == 3:
        frames = frames[None]
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"{what}: need [B,H,W,3] or [H,W,3], got "
                         f"{tuple(frames.shape)}")
    return frames


def resize_u8_plain(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """frames u8 [B,H,W,3] (or [H,W,3]) -> [B,h,w,3] u8, the kernel's
    arithmetic one f32 operation at a time in its order (f32 values held in
    f64, FMAs rounded once), on the frames' device."""
    src = _frames4(frames, "resize_u8_plain")
    dev = src.device
    (ix, wx), (iy, wy) = ((torch.from_numpy(idx.astype(np.int64)).to(dev),
                           torch.from_numpy(wt.astype(np.float64)).to(dev))
                          for idx, wt in (taps(src.shape[2], w),
                                          taps(src.shape[1], h)))
    s = src.to(torch.float64)

    def col(k):
        return s.index_select(2, ix[:, k]), wx[:, k].view(1, 1, w, 1)

    p, v = col(0)
    acc = _f32(p * v)
    for k in (1, 2, 3):
        p, v = col(k)
        acc = _fma(p, v, acc)

    def row(k):
        return acc.index_select(1, iy[:, k]), wy[:, k].view(1, h, 1, 1)

    (r0, v0), (r1, v1), (r2, v2), (r3, v3) = (row(k) for k in range(4))
    out = _f32(_fma(r0, v0, _f32(r1 * v1)) + _fma(r2, v2, _f32(r3 * v3)))
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _device_taps(n_in: int, n_out: int, dev: torch.device) -> torch.Tensor:
    """One axis's taps on ``dev``: int32 [2, n_out, 4], the indices then
    the f32 weights' bits (each half 16-byte aligned for int4/float4
    loads)."""
    idx, w = taps(n_in, n_out)
    return torch.from_numpy(np.stack([idx, w.view(np.int32)])).to(dev)


@functools.cache
def _kernel():
    fn = _build.load("resize_u8").islx_resize_u8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resize_u8(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """frames u8 [B,H,W,3] (or [H,W,3]) -> [B,h,w,3] u8, cv2's
    ``INTER_CUBIC`` as its IPP path computes it.

    CUDA tensors go through the sm_90a kernel on the current stream (no
    synchronisation; ``resize_u8.launches`` counts the launches), CPU
    tensors through :func:`resize_u8_plain`."""
    src = _frames4(frames, "resize_u8")
    if src.device.type == "cpu":
        return resize_u8_plain(src, h, w)
    if src.device.type != "cuda":
        raise ValueError(f"resize_u8: unsupported device {src.device}")
    if not src.is_contiguous():
        raise ValueError("resize_u8: frames must be contiguous")
    b, hi, wi = src.shape[:3]
    if h < 1 or w < 1 or hi < 1 or wi < 1:
        raise ValueError(f"resize_u8: {hi}x{wi} -> {h}x{w}")
    if max(src.numel(), b * h * w * 3) >= 2 ** 31:
        raise ValueError("resize_u8: frames of 2**31 bytes or more")
    dev = src.device
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=dev)
    if b == 0:
        return out
    tx, ty = _device_taps(wi, w, dev), _device_taps(hi, h, dev)
    _build.launch("resize_u8", _kernel(), dev, src.data_ptr(),
                  out.data_ptr(), tx.data_ptr(), ty.data_ptr(), b, hi, wi,
                  h, w)
    resize_u8.launches += 1
    return out


resize_u8.launches = 0


def _host_frames(frames) -> np.ndarray:
    arr = np.ascontiguousarray(np.stack(frames) if isinstance(frames, list)
                               else frames)
    return arr[None] if arr.ndim == 3 else arr


def upload_resized(frames, h: int, w: int, device) -> torch.Tensor:
    """Host u8 BGR frames (an [H,W,3] array, an [N,H,W,3] array or a list
    of one size) -> [N,h,w,3] on ``device``: uploaded once and resized
    there with :func:`resize_u8` (the kernel on a GPU, the plain version on
    the CPU). Frames already (h, w) are uploaded as they are (a same-size
    cv2 resize is a copy)."""
    arr = _host_frames(frames)
    x = torch.from_numpy(arr).to(device)
    return x if arr.shape[1:3] == (h, w) else resize_u8(x, h, w)


def resize_frames(frames, h: int, w: int, device) -> np.ndarray:
    """:func:`upload_resized`, back on the host as [N,h,w,3]; frames
    already (h, w) come back as they are, with no upload."""
    arr = _host_frames(frames)
    if arr.shape[1:3] == (h, w):
        return arr
    return upload_resized(arr, h, w, device).cpu().numpy()
