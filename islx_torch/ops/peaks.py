"""Body-joint peaks on the device (port of ``islx/ops/peaks.py``).

* :func:`find_peaks_fused_batched`, the fused step's peaks: the gaussian
  blur folds into the x8 cubic upsample (one host-built matrix per axis);
  ``kernel="mask"`` takes the NMS mask + row counts from the CUDA kernel of
  :mod:`islx_torch.ops.nms_mask` and the first K peaks per channel in
  row-major order from the row-blocked selection, ``kernel="select"`` takes
  both from the NMS+first-K kernel of :mod:`islx_torch.ops.nms_first_k`;
  each peak's score is the unblurred cubic value reconstructed at the peak.
* :func:`find_peaks_fused`, the same for one frame [h8,w8,C] with islx's
  ``select`` choice of first-K selection (``"rows"``, the row-blocked
  search, or ``"flat"``, one rank over the plane; the same indices); its
  NMS mask is the CUDA kernel's.
* :func:`find_peaks_pyramid`, the scale pyramid's peaks: each scale's
  upsample -> de-pad -> back-to-bucket -> blur chain folds into one matrix
  per axis (:func:`_pyramid_axis_fold`), the weighted sum of the scales is
  the blurred average, the NMS mask is the kernel's, and the scores are the
  unblurred average reconstructed at the peaks.
* :func:`find_peaks`, the parity path's peaks of full-resolution maps
  (any leading batch dims): gaussian blur, then NMS+first-K (the same
  kernel, with the -inf border of islx's ``_nms_mask``) in one launch over
  the batch, then the unblurred value at each peak.

islx's ``_nms_mask`` (its XLA NMS) compares out-of-image neighbours as
-inf, the mask kernel (like islx's Pallas kernels) as 0.0: the two agree
for ``thre1 >= 0`` (a pixel above the threshold is then >= 0). Where islx
runs its XLA NMS and ``thre1 < 0``, the port takes the peaks from the
NMS+first-K kernel with the -inf border (:func:`_masked_peaks`).

All contractions are f32: CUDA matmuls run in full f32 unless TF32 is
allowed, which :func:`_assert_f32_matmul` checks.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from islx_torch.ops.blur import _blur_matrix, gaussian_blur
from islx_torch.ops.nms_first_k import first_k_masked, nms_first_k
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


def _masked_peaks(blurred: torch.Tensor, thre1, k: int, kernel: str,
                  select: str, border: float = 0.0) -> torch.Tensor:
    """blurred [B,C,H,W] f32 contiguous -> [B,C,K] int64 first-K NMS peak
    indices (sentinel H*W): the mask kernel + ``select`` (``"rows"`` or
    ``"flat"``), or the NMS+first-K kernel (``kernel="select"``).
    ``border``: what out-of-image neighbours compare as, 0.0 (islx's Pallas
    kernels) or -inf (its XLA NMS); the mask kernel's is 0.0, so a -inf
    border with ``thre1 < 0`` goes to the NMS+first-K kernel."""
    bsz, c, h, w = blurred.shape
    if kernel == "select" or (border != 0.0 and float(thre1) < 0):
        return nms_first_k(blurred, thre1, k, border=border).long()
    if kernel != "mask":
        raise ValueError(f"unknown peak kernel {kernel!r}")
    mask, row_cnt = nms_mask_rows(blurred, thre1)
    if select == "rows":
        return _first_k_masked_rows(mask, k, row_cnt)
    if select == "flat":
        return first_k_masked(mask.reshape(bsz * c, h * w) != 0, k).reshape(
            bsz, c, k).long()
    raise ValueError(f"unknown peak selection {select!r}")


def find_peaks_fused_batched(heat8: torch.Tensor, h_out: int, w_out: int,
                             thre1: float, k: int = 32, sigma: float = 3.0,
                             kernel: str = "mask", select: str = "rows",
                             border: float = 0.0) -> Peaks:
    """heat8 [B,h8,w8,C] net-resolution heatmaps -> peaks at (h_out, w_out).

    ``kernel``: ``"mask"`` (NMS mask kernel + ``select``: the row-blocked
    selection, or ``"flat"``) or ``"select"`` (the NMS+first-K kernel,
    islx's ``ISLX_PALLAS_NMS`` path); all give the same peaks. ``border``:
    0.0 as islx's Pallas kernels, -inf as its XLA NMS (``find_peaks_fused``).
    Positions agree with the JAX code except where f32 rounding flips a
    near-exact NMS tie."""
    bsz, h8, w8, c = heat8.shape
    dev = heat8.device
    _assert_f32_matmul(dev)
    fh = torch.from_numpy(_blurred_upsample_matrix(h8, h_out, sigma)).to(dev)
    fw = torch.from_numpy(_blurred_upsample_matrix(w8, w_out, sigma)).to(dev)
    x = heat8.float()
    t = torch.einsum("oh,bhwc->bowc", fh, x)
    blurred = torch.einsum("pw,bowc->bcop", fw, t).contiguous()  # [B,C,H,W]

    n = h_out * w_out
    idx = _masked_peaks(blurred, thre1, k, kernel, select,
                        border)                                 # [B,C,K]
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


def find_peaks_fused(heat8: torch.Tensor, h_out: int, w_out: int,
                     thre1: float, k: int = 32, sigma: float = 3.0,
                     two_stage: bool = True, select: str = None) -> Peaks:
    """heat8 [h8,w8,C] one frame's net-resolution heatmaps -> Peaks (xy
    [C,K,2], ...) at (h_out, w_out), islx/ops/peaks.py:243. ``select``:
    ``"rows"`` or ``"flat"`` (None reads ``ISLX_PEAKS_SELECT``, default
    rows); ``two_stage`` is kept for islx's signature (islx ignores it)."""
    del two_stage
    pk = find_peaks_fused_batched(heat8[None], h_out, w_out, thre1, k, sigma,
                                  kernel="mask", select=_select_mode(select),
                                  border=-float("inf"))
    return Peaks(*(t[0] for t in pk))


def _select_mode(select) -> str:
    """islx's ``_select_peaks`` default: ``ISLX_PEAKS_SELECT``, else
    rows."""
    return select or os.environ.get("ISLX_PEAKS_SELECT", "rows")


@functools.lru_cache(maxsize=1024)
def _pyramid_axis_fold(n_bucket: int, n_scaled: int, n8_padded: int,
                       stride: int = 8, sigma: float = 0.0,
                       truncate: float = 4.0) -> np.ndarray:
    """One axis of the per-scale map chain as one [n_bucket, n8_padded]
    matrix (islx/ops/peaks.py:169): x``stride`` cubic upsample, crop the
    stride padding (first ``n_scaled`` rows), cubic resize back to the
    bucket, then (sigma > 0) the gaussian blur; built in f64, cast to
    f32."""
    up = _resize_matrix(n8_padded, n8_padded * stride).astype(np.float64)
    m = up[:n_scaled]
    if n_scaled != n_bucket:
        m = _resize_matrix(n_scaled, n_bucket).astype(np.float64) @ m
    if sigma > 0:
        m = _blur_matrix(n_bucket, sigma, truncate).astype(np.float64) @ m
    return m.astype(np.float32)


def _f32(v: float, dev) -> torch.Tensor:
    """A host weight as a 0-dim f32 tensor (the product rounds as XLA's
    multiply by an f32 constant)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=dev)


def find_peaks_pyramid(heat8s, folds, weights, thre1, k: int,
                       two_stage: bool = True, select: str = None) -> Peaks:
    """Multi-scale peaks of a batch (islx/ops/peaks.py:196, vmapped over
    frames there).

    heat8s: per scale [B,h8p_s,w8p_s,C] net-resolution heatmaps; folds: per
    scale ((fh_blur, fw_blur), (fh, fw)) matrices from
    :func:`_pyramid_axis_fold` (numpy or tensors); weights: per-scale
    averaging weights. The blurred bucket-resolution average is the sum of
    one matmul pair a scale; the NMS runs once over the batch on the mask
    kernel; scores are the unblurred average reconstructed at the peaks.
    -> Peaks [B,C,K]."""
    del two_stage
    dev = heat8s[0].device
    _assert_f32_matmul(dev)

    def mats(pair):
        return [torch.as_tensor(m, device=dev) for m in pair]

    blurred = None
    for h8, (fb, _), w in zip(heat8s, folds, weights):
        fhb, fwb = mats(fb)
        x = torch.einsum("oh,bhwc->bowc", fhb, h8.float())
        x = torch.einsum("pw,bowc->bopc", fwb, x) * _f32(w, dev)
        blurred = x if blurred is None else blurred + x
    bsz, h_out, w_out, c = blurred.shape
    idx = _masked_peaks(blurred.permute(0, 3, 1, 2).contiguous(), thre1, k,
                        "mask", _select_mode(select),
                        -float("inf"))                          # [B,C,K]
    valid = idx < h_out * w_out
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    y, x_ = idx // w_out, idx % w_out

    score = None
    for h8, (_, fp), w in zip(heat8s, folds, weights):
        fh, fw = mats(fp)
        t = torch.einsum("bcki,bijc->bckj", fh[y], h8.float())
        s = (t * fw[x_]).sum(-1) * _f32(w, dev)
        score = s if score is None else score + s
    score = torch.where(valid, score, torch.zeros_like(score))
    xy = torch.stack([x_, y], dim=-1).to(torch.int32)
    count = valid.sum(dim=2, dtype=torch.int32)
    return Peaks(xy=xy, score=score, valid=valid, count=count)


def find_peaks(heatmap: torch.Tensor, thre1: float, k: int = 32,
               sigma: float = 3.0, two_stage: bool = False,
               select: str = None) -> Peaks:
    """heatmap [...,H,W,C] averaged (unblurred) joint heatmaps -> Peaks over
    the C channels (xy [...,C,K,2], ...), islx/ops/peaks.py:358: one
    NMS+first-K launch over every leading batch index. ``two_stage`` and
    ``select`` are kept for islx's signature: every selection gives the
    same indices."""
    del two_stage, select
    lead = heatmap.shape[:-3]
    h, w, c = heatmap.shape[-3:]
    _assert_f32_matmul(heatmap.device)
    hm = heatmap.reshape((-1, h, w, c))
    blurred = gaussian_blur(hm, sigma)                          # [N,H,W,C]
    idx = nms_first_k(blurred.permute(0, 3, 1, 2).contiguous(), thre1, k,
                      border=-float("inf")).long()              # [N,C,K]
    valid = idx < h * w
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    flat = hm.float().permute(0, 3, 1, 2).reshape(-1, c, h * w)
    score = torch.gather(flat, 2, idx)
    score = torch.where(valid, score, torch.zeros_like(score))
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.int32)
    count = valid.sum(dim=-1, dtype=torch.int32)
    return Peaks(xy=xy.reshape(lead + (c, k, 2)),
                 score=score.reshape(lead + (c, k)),
                 valid=valid.reshape(lead + (c, k)),
                 count=count.reshape(lead + (c,)))
