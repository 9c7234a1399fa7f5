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
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from islx_torch.ops import _build


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


def _kernel():
    lib = _build.load("nms_mask")
    fn = lib.islx_nms_mask_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
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
    thre = _thre_f32(thre1)
    mask = torch.empty((bsz, c, h, w), dtype=torch.uint8,
                       device=blurred.device)
    row_cnt = torch.empty((bsz, c, h), dtype=torch.int32,
                          device=blurred.device)
    if mask.numel() == 0:
        return mask, row_cnt.zero_()
    with torch.cuda.device(blurred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(blurred.data_ptr(), mask.data_ptr(),
                        row_cnt.data_ptr(), thre, bsz * c, h, w, stream)
    if err != 0:
        raise RuntimeError(f"nms_mask_rows: kernel launch failed "
                           f"(cudaError {err})")
    nms_mask_rows.launches += 1
    return mask, row_cnt


nms_mask_rows.launches = 0
