"""4-neighbour plateau NMS + the first K peak indices of each plane.

``nms_first_k`` is the port of the Pallas kernel
``islx/ops/pallas_peaks.py::nms_first_k``. On a CUDA tensor it launches the
hand-written kernel in ``islx_torch/csrc/nms_first_k.cu``; on a CPU tensor
it runs :func:`nms_first_k_plain`, the plain PyTorch version of the same
function. There is no fallback between the two: a CUDA tensor the kernel
cannot take raises.

``border`` is the value out-of-image neighbours compare as: 0.0 in the
``nms_first_k`` contract, -inf in ``islx/ops/peaks.py::_nms_mask`` (the
parity path's ``find_peaks``). The two agree only for ``thre1 > 0``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from islx_torch.ops import _build
from islx_torch.ops._bands import (BAND_PX, MAX_SMEM, MIN_BLOCKS,  # noqa: F401
                                   band_plan, bands_per_block)
from islx_torch.ops.nms_mask import _thre_f32, nms_mask


def first_k_masked(flat_mask: torch.Tensor, k: int) -> torch.Tensor:
    """[R, N] bool -> [R, K] int32: the first k set positions of each row,
    ascending, then the sentinel N (islx/ops/peaks.py:63)."""
    r, n = flat_mask.shape
    rank = torch.cumsum(flat_mask, dim=1, dtype=torch.int32)   # inclusive
    take = flat_mask & (rank <= k)
    # slot k collects every position not taken and is dropped
    slot = torch.where(take, rank - 1, k).long()
    pos = torch.arange(n, dtype=torch.int32, device=flat_mask.device)
    out = torch.full((r, k + 1), n, dtype=torch.int32,
                     device=flat_mask.device)
    out.scatter_(1, slot, pos.expand(r, n))
    out[:, k] = n
    return out[:, :k]


def nms_first_k_plain(blurred: torch.Tensor, thre1, k: int,
                      border: float = 0.0) -> torch.Tensor:
    """blurred [B,C,H,W] f32 -> idx [B,C,K] int32 (see the module doc)."""
    bsz, c, h, w = blurred.shape
    mask = nms_mask(blurred, thre1, border).reshape(bsz * c, h * w)
    return first_k_masked(mask, k).reshape(bsz, c, k)


@functools.cache
def _kernel():
    lib = _build.load("nms_first_k")
    fn = lib.islx_nms_first_k
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def nms_first_k(blurred: torch.Tensor, thre1, k: int, border: float = 0.0
                ) -> torch.Tensor:
    """blurred [B,C,H,W] f32 -> idx [B,C,K] int32 ascending flat (y*W+x)
    indices of each channel's first k NMS peaks, sentinel H*W past them.

    CUDA tensors go through the sm_90a kernel's two passes on the current
    stream (no synchronisation; ``nms_first_k.launches`` counts the calls),
    CPU tensors through :func:`nms_first_k_plain`."""
    if blurred.device.type == "cpu":
        return nms_first_k_plain(blurred, thre1, k, border)
    if blurred.device.type != "cuda":
        raise ValueError(f"nms_first_k: unsupported device {blurred.device}")
    if blurred.dtype != torch.float32:
        raise TypeError(f"nms_first_k: need float32, got {blurred.dtype}")
    if blurred.dim() != 4:
        raise ValueError(f"nms_first_k: need [B,C,H,W], got "
                         f"{tuple(blurred.shape)}")
    if not blurred.is_contiguous():
        raise ValueError("nms_first_k: input must be contiguous")
    if k < 1:
        raise ValueError(f"nms_first_k: need k >= 1, got {k}")
    bsz, c, h, w = blurred.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"nms_first_k: plane {h}x{w} too large")
    dev = blurred.device
    if blurred.numel() == 0:
        return torch.full((bsz, c, k), h * w, dtype=torch.int32, device=dev)
    planes = bsz * c
    rows, bands, smem = band_plan(h, w)
    if smem > MAX_SMEM:
        raise ValueError(f"nms_first_k: rows of {w} pixels do not fit a "
                         f"block's shared memory")
    if planes * bands >= 2 ** 31:
        raise ValueError(f"nms_first_k: {planes} planes of {bands} bands "
                         f"are too many")
    # one allocation, for host time: the output [B,C,K], then the kernel's
    # scratch (each band's first k indices and its count, each plane's
    # cutoff), which lives as long as the output does
    buf = torch.empty(planes * (k + bands * (k + 1) + 1), dtype=torch.int32,
                      device=dev)
    idx = buf[:planes * k].view(bsz, c, k)
    _build.launch("nms_first_k", _kernel(), dev, blurred.data_ptr(),
                  idx.data_ptr(), buf.data_ptr() + 4 * planes * k,
                  _thre_f32(thre1), float(border), planes, h, w, rows, bands,
                  bands_per_block(planes, bands), k, smem)
    nms_first_k.launches += 1
    return idx


nms_first_k.launches = 0
