"""4-neighbour plateau NMS mask + per-row counts.

``nms_mask_rows`` is the port of the Pallas kernel
``islx/ops/pallas_peaks.py::nms_mask_rows``. On a CUDA tensor it launches
the hand-written kernel in ``islx_torch/csrc/nms_mask.cu``; on a CPU tensor
it runs :func:`nms_mask_rows_plain`, the plain PyTorch version of the same
function. There is no fallback between the two: a CUDA tensor the kernel
cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from islx_torch.ops import _build
from islx_torch.ops._bands import MAX_SMEM, band_plan


def _thre_f32(thre1) -> float:
    """thre1 rounded to f32 (the kernel and the JAX code compare in f32)."""
    if isinstance(thre1, torch.Tensor):
        thre1 = thre1.item()
    return float(np.float32(thre1))


def nms_mask(blurred: torch.Tensor, thre1, border: float = 0.0
             ) -> torch.Tensor:
    """blurred [..., H, W] f32 -> bool mask: >= each of the 4 neighbours
    (``border`` outside the image) and > thre1; comparisons with NaN are
    false."""
    b = blurred
    thre = _thre_f32(thre1)
    up = F.pad(b[..., :-1, :], (0, 0, 1, 0), value=border)
    down = F.pad(b[..., 1:, :], (0, 0, 0, 1), value=border)
    left = F.pad(b[..., :, :-1], (1, 0), value=border)
    right = F.pad(b[..., :, 1:], (0, 1), value=border)
    return (b >= up) & (b >= down) & (b >= left) & (b >= right) & (b > thre)


def nms_mask_rows_plain(blurred: torch.Tensor, thre1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """blurred [B,C,H,W] f32 -> (mask u8 [B,C,H,W], row_cnt s32 [B,C,H]).

    A pixel is 1 where it is >= its four neighbours (0.0 outside the image)
    and > thre1; comparisons with NaN are false."""
    mask = nms_mask(blurred, thre1)
    return mask.to(torch.uint8), mask.sum(-1, dtype=torch.int32)


@functools.cache
def _kernel():
    lib = _build.load("nms_mask")
    fn = lib.islx_nms_mask_rows
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def nms_mask_rows(blurred: torch.Tensor, thre1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """blurred [B,C,H,W] f32 -> (mask u8 [B,C,H,W], row_cnt s32 [B,C,H]).

    CUDA tensors go through the sm_90a kernel on the current stream (no
    synchronisation; ``nms_mask_rows.launches`` counts the launches), CPU
    tensors through :func:`nms_mask_rows_plain`. ``thre1`` is a float; a
    CUDA tensor threshold is read to the host first."""
    if blurred.device.type == "cpu":
        return nms_mask_rows_plain(blurred, thre1)
    if blurred.device.type != "cuda":
        raise ValueError(f"nms_mask_rows: unsupported device {blurred.device}")
    if blurred.dtype != torch.float32:
        raise TypeError(f"nms_mask_rows: need float32, got {blurred.dtype}")
    if blurred.dim() != 4:
        raise ValueError(f"nms_mask_rows: need [B,C,H,W], got "
                         f"{tuple(blurred.shape)}")
    if not blurred.is_contiguous():
        raise ValueError("nms_mask_rows: input must be contiguous")
    bsz, c, h, w = blurred.shape
    dev = blurred.device
    planes, px = bsz * c, blurred.numel()
    # one allocation, for host time: the mask, then the row counts at a
    # 16-byte-aligned offset
    cnt_at = -(-px // 16) * 16
    buf = torch.empty(cnt_at + 4 * planes * h, dtype=torch.uint8, device=dev)
    mask = buf[:px].view(bsz, c, h, w)
    row_cnt = buf[cnt_at:].view(torch.int32).view(bsz, c, h)
    if px == 0:
        return mask, row_cnt.zero_()
    rows, bands, smem = band_plan(h, w)
    smem += 4 * rows                       # a counter a row
    if smem > MAX_SMEM:
        raise ValueError(f"nms_mask_rows: rows of {w} pixels do not fit a "
                         f"block's shared memory")
    if planes * bands >= 2 ** 31:
        raise ValueError(f"nms_mask_rows: {planes} planes of {bands} bands "
                         f"are too many")
    _build.launch("nms_mask_rows", _kernel(), dev, blurred.data_ptr(),
                  buf.data_ptr(), buf.data_ptr() + cnt_at, _thre_f32(thre1),
                  planes, h, w, rows, bands, smem)
    nms_mask_rows.launches += 1
    return mask, row_cnt


nms_mask_rows.launches = 0
