"""Body-joint peaks on the device (port of ``islx/ops/peaks.py``).

* :func:`find_peaks_fused_batched`, the fused step's peaks: the gaussian
  blur folds into the x8 cubic upsample (one host-built matrix per axis);
  ``kernel="mask"`` takes the NMS mask + row counts from the CUDA kernel of
  :mod:`islx_torch.ops.nms_mask` and the first K peaks per channel in
  row-major order from the row-blocked selection, ``kernel="select"`` takes
  both from the NMS+first-K kernel of :mod:`islx_torch.ops.nms_first_k`;
  each peak's score is the unblurred cubic value reconstructed at the peak.
* :func:`find_peaks`, the parity path's peaks of one full-resolution map:
  gaussian blur, then NMS+first-K (the same kernel, with the -inf border of
  islx's ``_nms_mask``), then the unblurred value at each peak.

All contractions are f32: CUDA matmuls run in full f32 unless TF32 is
allowed, which :func:`_assert_f32_matmul` checks.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from islx_torch.ops.blur import _blur_matrix, gaussian_blur
from islx_torch.ops.nms_first_k import nms_first_k
from islx_torch.ops.nms_mask import nms_mask_rows
from islx_torch.ops.resize import _resize_matrix


class Peaks(NamedTuple):
    """Fixed-K peaks per channel, batched over any leading dims.

    xy [...,C,K,2] int32 (x, y) row-major order; score [...,C,K] f32; valid
    [...,C,K] bool; count [...,C] int32."""

    xy: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


@functools.lru_cache(maxsize=256)
def _blurred_upsample_matrix(n_in: int, n_out: int, sigma: float,
                             truncate: float = 4.0) -> np.ndarray:
    """blur(resize(x)) along one axis as one [n_out, n_in] matrix (f64
    product, cast to f32)."""
    b = _blur_matrix(n_out, sigma, truncate).astype(np.float64)
    r = _resize_matrix(n_in, n_out).astype(np.float64)
    return (b @ r).astype(np.float32)


def _assert_f32_matmul(device: torch.device) -> None:
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("peak math needs full-f32 CUDA matmuls; TF32 is "
                           "allowed (torch.backends.cuda.matmul.allow_tf32)")


def _first_k_masked_rows(mask: torch.Tensor, k: int,
                         row_cnt: torch.Tensor) -> torch.Tensor:
    """mask [B,C,H,W] u8 + row counts [B,C,H] -> [B,C,K] int64 ascending
    flat (y*W+x) indices of the first k set pixels per channel, sentinel
    H*W beyond the count (islx/ops/peaks.py:92)."""
    bsz, c, h, w = mask.shape
    dev = mask.device
    row_pre = torch.cumsum(row_cnt, dim=-1, dtype=torch.int32)  # inclusive
    q = torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    row = torch.searchsorted(row_pre, q.expand(bsz, c, k).contiguous(),
                             right=False)                       # 0..H
    count = row_pre[..., -1]
    rowc = torch.clamp_max(row, h - 1)
    before = torch.gather(row_pre, 2, torch.clamp_min(rowc - 1, 0))
    excl = torch.where(rowc > 0, before, torch.zeros_like(before))
    target = q - excl                                           # 1-based
    rows_b = torch.gather(mask, 2, rowc[..., None].expand(bsz, c, k, w)) != 0
    local = torch.cumsum(rows_b, dim=-1, dtype=torch.int32)     # [B,C,K,W]
    hit = (local == target[..., None]) & rows_b
    # CUDA argmax takes no bool; over 0/1 it returns the first set column
    wpos = torch.argmax(hit.to(torch.int32), dim=-1)
    idx = rowc * w + wpos
    return torch.where(q <= count[..., None], idx,
                       torch.full_like(idx, h * w))


def find_peaks_fused_batched(heat8: torch.Tensor, h_out: int, w_out: int,
                             thre1: float, k: int = 32, sigma: float = 3.0,
                             kernel: str = "mask") -> Peaks:
    """heat8 [B,h8,w8,C] net-resolution heatmaps -> peaks at (h_out, w_out).

    ``kernel``: ``"mask"`` (NMS mask kernel + row-blocked selection) or
    ``"select"`` (the NMS+first-K kernel, islx's ``ISLX_PALLAS_NMS`` path);
    both give the same peaks. Positions agree with the JAX code except
    where f32 rounding flips a near-exact NMS tie."""
    bsz, h8, w8, c = heat8.shape
    dev = heat8.device
    _assert_f32_matmul(dev)
    fh = torch.from_numpy(_blurred_upsample_matrix(h8, h_out, sigma)).to(dev)
    fw = torch.from_numpy(_blurred_upsample_matrix(w8, w_out, sigma)).to(dev)
    x = heat8.float()
    t = torch.einsum("oh,bhwc->bowc", fh, x)
    blurred = torch.einsum("pw,bowc->bcop", fw, t).contiguous()  # [B,C,H,W]

    n = h_out * w_out
    if kernel == "mask":
        mask, row_cnt = nms_mask_rows(blurred, thre1)
        idx = _first_k_masked_rows(mask, k, row_cnt)            # [B,C,K]
    elif kernel == "select":
        idx = nms_first_k(blurred, thre1, k).long()             # [B,C,K]
    else:
        raise ValueError(f"unknown peak kernel {kernel!r}")
    valid = idx < n
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    y = idx // w_out
    x_ = idx % w_out

    # exact unblurred cubic values at the peaks: Ry[y] @ heat8[:,:,c] @ Cx[x]
    ry = torch.from_numpy(_resize_matrix(h8, h_out)).to(dev)
    cx = torch.from_numpy(_resize_matrix(w8, w_out)).to(dev)
    rows = ry[y]                                                # [B,C,K,h8]
    cols = cx[x_]                                               # [B,C,K,w8]
    # same contraction order as the JAX einsum: rows with heat8 first
    t = torch.einsum("bcki,bijc->bckj", rows, x)
    score = (t * cols).sum(-1)
    score = torch.where(valid, score, torch.zeros_like(score))
    xy = torch.stack([x_, y], dim=-1).to(torch.int32)
    count = valid.sum(dim=2, dtype=torch.int32)
    return Peaks(xy=xy, score=score, valid=valid, count=count)


def find_peaks(heatmap: torch.Tensor, thre1: float, k: int = 32,
               sigma: float = 3.0) -> Peaks:
    """heatmap [H,W,C] averaged (unblurred) joint heatmaps -> Peaks over
    the C channels (xy [C,K,2], ...), islx/ops/peaks.py:358."""
    h, w, c = heatmap.shape
    _assert_f32_matmul(heatmap.device)
    blurred = gaussian_blur(heatmap, sigma)                     # [H,W,C]
    idx = nms_first_k(blurred.permute(2, 0, 1)[None].contiguous(), thre1, k,
                      border=-float("inf"))[0].long()           # [C,K]
    valid = idx < h * w
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    flat = heatmap.float().permute(2, 0, 1).reshape(c, h * w)
    score = torch.gather(flat, 1, idx)
    score = torch.where(valid, score, torch.zeros_like(score))
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.int32)
    count = valid.sum(dim=1, dtype=torch.int32)
    return Peaks(xy=xy, score=score, valid=valid, count=count)
