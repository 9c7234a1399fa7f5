"""PAF limb scoring (port of ``islx/ops/paf.py``).

:func:`score_limbs` is the parity path's exact scoring at full resolution:
the CUDA kernel of :mod:`islx_torch.ops.paf_sample` on the card, its plain
version on the CPU. The rest is the fused step's scoring on the /8 grid +
on-device compaction (``score_limbs_cell`` with int8-counted cells and
``compact_connections``), batched over frames, and islx's other /8
scorers (``score_limbs_mxu``, ``score_limbs_fused``), which read the same
/8 samples.

Every K x K candidate pair of a limb samples ``mid_num`` points on its line;
each sample lands on a cell of the net-resolution PAF grid. The line
integral regroups by cell: ``count[pair, cell]`` times the score surface
``S[pair, cell] = unit . paf[cell]``, and the hit count sums ``count`` where
``S > thre2``. Counts are integers (<= mid_num); they are built with
``scatter_add_``, which gives the same integers as the JAX one-hot sum.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from islx_torch.core.runtime import div, fma_rn, rdiv, sqrt_rn
from islx_torch.ops.paf_sample import (LimbTable, _inv_mid, _samples_t,
                                       paf_sample, sum_plan)

# Limb connection tables (reference: src/body.py:109-126).
LIMB_SEQ_BODY25 = np.array(
    [[1, 0], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6], [6, 7], [1, 8], [8, 9],
     [9, 10], [10, 11], [8, 12], [12, 13], [13, 14], [0, 15], [0, 16],
     [15, 17], [16, 18], [11, 24], [11, 22], [14, 21], [14, 19], [22, 23],
     [19, 20]], dtype=np.int32)
MAP_IDX_BODY25 = np.array(
    [[30, 31], [14, 15], [16, 17], [18, 19], [22, 23], [24, 25], [26, 27],
     [0, 1], [6, 7], [2, 3], [4, 5], [8, 9], [10, 11], [12, 13], [32, 33],
     [34, 35], [36, 37], [38, 39], [50, 51], [46, 47], [44, 45], [40, 41],
     [48, 49], [42, 43]], dtype=np.int32)

LIMB_SEQ_COCO = np.array(
    [[1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9], [9, 10],
     [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16], [0, 15],
     [15, 17], [2, 16], [5, 17]], dtype=np.int32)
MAP_IDX_COCO = np.array(
    [[12, 13], [20, 21], [14, 15], [16, 17], [22, 23], [24, 25], [0, 1],
     [2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [28, 29], [30, 31], [34, 35],
     [32, 33], [36, 37], [18, 19], [26, 27]], dtype=np.int32)

LIMB_TABLES = {
    "body25": (LIMB_SEQ_BODY25, MAP_IDX_BODY25),
    "coco": (LIMB_SEQ_COCO, MAP_IDX_COCO),
}


class LimbScores(NamedTuple):
    """score [...,L,K,K] f32 (score with distance prior); ok [...,L,K,K]
    bool."""

    score: torch.Tensor
    ok: torch.Tensor


class CompactConnections(NamedTuple):
    """Per-limb candidate pairs sorted score-descending, ties in (i, j)
    order. pair [B,L,M] int32 (i*K + j); score [B,L,M] f32 (-inf where not
    ok); ok [B,L,M] bool."""

    pair: torch.Tensor
    score: torch.Tensor
    ok: torch.Tensor


def score_limbs(paf: torch.Tensor, peaks_xy: torch.Tensor,
                peaks_valid: torch.Tensor, limbs: LimbTable,
                thre2: float = 0.05, mid_num: int = 10,
                orig_h: float = None) -> LimbScores:
    """paf [H,W,P] full-resolution PAF maps, peaks_xy [C,K,2] int32,
    peaks_valid [C,K], the limb table made once -> every limb's K x K pair
    scores [L,K,K] (islx/ops/paf.py:91); ``orig_h`` is the height in the
    distance prior."""
    score, ok = paf_sample(paf.contiguous(), peaks_xy.to(torch.int32)
                           .contiguous(), peaks_valid.contiguous(), limbs,
                           thre2, mid_num, orig_h)
    return LimbScores(score=score, ok=ok)


def _pair_samples8(peaks_xy: torch.Tensor, peaks_valid: torch.Tensor,
                   limb: tuple, stride: int, h8: int, w8: int, mid_num: int):
    """One limb's K x K pair geometry over a batch: -> (unit [B,K,K,2],
    norm [B,K,K], valid [B,K,K], cell [B,K,K,mid] int64) — the nearest /8
    cell of each line sample (src = (p+.5)/stride - .5)."""
    a_xy = peaks_xy[:, limb[0]].float()                    # [B,K,2]
    b_xy = peaks_xy[:, limb[1]].float()
    valid = peaks_valid[:, limb[0]][:, :, None] & peaks_valid[:, limb[1]][
        :, None, :]
    vec = b_xy[:, None, :, :] - a_xy[:, :, None, :]        # [B,K,K,2]
    norm = torch.clamp_min(sqrt_rn((vec * vec).sum(-1)), 0.001)
    unit = vec / norm[..., None]
    t = _samples_t(mid_num, peaks_xy.device)
    pts = fma_rn(vec[:, :, :, None, :], t[None, None, None, :, None],
                 a_xy[:, :, None, None, :])
    cx = torch.clamp(torch.round(div(pts[..., 0] + 0.5, stride) - 0.5),
                     0, w8 - 1).long()
    cy = torch.clamp(torch.round(div(pts[..., 1] + 0.5, stride) - 0.5),
                     0, h8 - 1).long()
    return unit, norm, valid, cy * w8 + cx


def score_limbs_cell(paf8: torch.Tensor, peaks_xy: torch.Tensor,
                     peaks_valid: torch.Tensor, limb_seq: np.ndarray,
                     map_idx: np.ndarray, stride: int = 8,
                     thre2: float = 0.05, mid_num: int = 10,
                     orig_h: float = None, count_dtype=torch.int32,
                     seq: bool = True) -> LimbScores:
    """paf8 [B,h8,w8,P], peaks_xy [B,C,K,2], peaks_valid [B,C,K] -> all
    K x K pair scores of every limb. One limb at a time, as the JAX code
    maps over limbs, to bound the [B, K*K, cells] count tensor.

    ``count_dtype`` and ``seq`` are islx's memory and scheduling choices
    (int8 counts, limbs vmapped): the counts are the same integers <=
    mid_num and the limbs independent, so neither changes a result; the
    counts are int32 here (``scatter_add_``)."""
    del count_dtype, seq
    bsz, h8, w8, _ = paf8.shape
    if orig_h is None:
        orig_h = h8 * stride
    cells = h8 * w8
    k = peaks_xy.shape[2]
    paf_flat = paf8.reshape(bsz, cells, -1).float()
    swdps, oks = [], []
    for limb, chans in zip(np.asarray(limb_seq).tolist(),
                           np.asarray(map_idx).tolist()):
        unit, norm, valid, cell = _pair_samples8(
            peaks_xy, peaks_valid, limb, stride, h8, w8, mid_num)
        unit = unit.reshape(bsz, k * k, 2)
        cell = cell.reshape(bsz, k * k, mid_num)
        count = torch.zeros((bsz, k * k, cells), dtype=torch.int32,
                            device=paf8.device)
        count.scatter_add_(2, cell, torch.ones_like(cell, dtype=torch.int32))
        ps = paf_flat[:, :, chans]                          # [B,cells,2]
        s_cell = torch.matmul(unit, ps.transpose(1, 2))     # [B,K*K,cells]
        score_sum = (count.float() * s_cell).sum(-1)
        hits = torch.where(s_cell > thre2, count,
                           torch.zeros_like(count)).sum(-1)
        prior = torch.clamp_max(rdiv(0.5 * orig_h, norm) - 1.0, 0.0)
        swdp = fma_rn(score_sum,
                      torch.full_like(score_sum, _inv_mid(mid_num)),
                      prior.reshape(bsz, k * k))
        ok = (hits > 0.8 * mid_num) & (swdp > 0) & valid.reshape(bsz, k * k)
        swdps.append(swdp.reshape(bsz, k, k))
        oks.append(ok.reshape(bsz, k, k))
    return LimbScores(score=torch.stack(swdps, 1), ok=torch.stack(oks, 1))


def _sampled8(paf_flat: torch.Tensor, cell: torch.Tensor, chans) -> tuple:
    """The (x, y) PAF values at each /8 sample: paf_flat [B,cells,P], cell
    [B,K,K,mid] -> (sx, sy) [B,K,K,mid]. islx's mxu scorer reads them
    with a one-hot matmul, its fused scorer with a compare-select reduce
    over the cells and its ``take`` variant with a gather: each selects
    the one value exactly, so here it is a gather."""
    bsz = cell.shape[0]
    idx = cell.reshape(bsz, -1)
    return tuple(torch.gather(paf_flat[:, :, ch], 1, idx).reshape(cell.shape)
                 for ch in chans)


def _limb_tail(sx, sy, unit, norm, valid, thre2, mid_num, orig_h) -> tuple:
    """One limb's score and ok from its sampled values: each sample's dot
    ``fma(sy, uy, sx*ux)`` (the hit count's), the mean's sum over the
    2*mid products as multiply-adds in (sample, x/y) order, lane-split as
    :data:`islx_torch.ops.paf_sample.SUM_LANES` says, then
    ``fma(total, 1/mid, prior)``. That gives the words of islx's ``take``
    scorer at mid 10; its mxu and reduce scorers sum in other orders inside
    their fused programs, so their scores agree within f32 rounding of the
    sum, and ok exactly (tests/test_torch_batch_modes.py)."""
    ux, uy = unit[..., 0], unit[..., 1]
    score_mid = fma_rn(sy, uy[..., None], sx * ux[..., None])
    vf, vec = sum_plan(mid_num)
    lanes = [torch.full_like(norm, -0.0 if j else 0.0) for j in range(vf)]
    for m in range(vec):
        lanes[m % vf] = fma_rn(sy[..., m], uy, fma_rn(sx[..., m], ux,
                                                    lanes[m % vf]))
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[j] + lanes[j + half] for j in range(half)]
    total = lanes[0]
    for m in range(vec, mid_num):
        total = fma_rn(sy[..., m], uy, fma_rn(sx[..., m], ux, total))
    prior = torch.clamp_max(rdiv(0.5 * float(np.float32(orig_h)), norm)
                            - 1.0, 0.0)
    swdp = fma_rn(total, torch.full_like(total, _inv_mid(mid_num)), prior)
    hits = (score_mid > float(np.float32(thre2))).sum(-1)
    ok = (hits > 0.8 * mid_num) & (swdp > 0) & valid
    return swdp, ok


def _score_limbs8(paf8, peaks_xy, peaks_valid, limb_seq, map_idx, stride,
                  thre2, mid_num, orig_h) -> LimbScores:
    """The /8 scorers' shared body: every limb's K x K pairs sampled at
    their nearest /8 cells."""
    bsz, h8, w8, _ = paf8.shape
    if orig_h is None:
        orig_h = h8 * stride
    paf_flat = paf8.reshape(bsz, h8 * w8, -1).float()
    swdps, oks = [], []
    for limb, chans in zip(np.asarray(limb_seq).tolist(),
                           np.asarray(map_idx).tolist()):
        unit, norm, valid, cell = _pair_samples8(
            peaks_xy, peaks_valid, limb, stride, h8, w8, mid_num)
        sx, sy = _sampled8(paf_flat, cell, chans)
        swdp, ok = _limb_tail(sx, sy, unit, norm, valid, thre2, mid_num,
                              orig_h)
        swdps.append(swdp)
        oks.append(ok)
    return LimbScores(score=torch.stack(swdps, 1), ok=torch.stack(oks, 1))


def score_limbs_mxu(paf8: torch.Tensor, peaks_xy: torch.Tensor,
                    peaks_valid: torch.Tensor, limb_seq: np.ndarray,
                    map_idx: np.ndarray, stride: int = 8,
                    thre2: float = 0.05, mid_num: int = 10,
                    orig_h: float = None) -> LimbScores:
    """islx/ops/paf.py:147 over a batch: paf8 [B,h8,w8,P], peaks_xy
    [B,C,K,2], peaks_valid [B,C,K] -> scores and ok [B,L,K,K]; each sample
    reads its nearest /8 cell, the line integral sums the samples' dots."""
    return _score_limbs8(paf8, peaks_xy, peaks_valid, limb_seq, map_idx,
                         stride, thre2, mid_num, orig_h)


def score_limbs_fused(paf8: torch.Tensor, peaks_xy: torch.Tensor,
                      peaks_valid: torch.Tensor, limb_seq: np.ndarray,
                      map_idx: np.ndarray, stride: int = 8,
                      thre2: float = 0.05, mid_num: int = 10,
                      orig_h: float = None, impl: str = "reduce"
                      ) -> LimbScores:
    """islx/ops/paf.py:293 over a batch (``impl`` ``"reduce"`` or
    ``"take"``: islx's two ways to read the samples, the same values): the
    same function as :func:`score_limbs_mxu`."""
    if impl not in ("reduce", "take"):
        raise ValueError(f"unknown impl {impl!r}")
    return _score_limbs8(paf8, peaks_xy, peaks_valid, limb_seq, map_idx,
                         stride, thre2, mid_num, orig_h)


def compact_connections(ls: LimbScores, m: int = 48) -> CompactConnections:
    """Each limb's K*K pair scores sorted descending, top ``m`` kept.

    ``lax.top_k`` in the JAX code puts the lower index first on ties (the
    reference's stable sort order); ``torch.topk`` promises no tie order on
    CUDA, so this is a stable descending sort sliced to ``m``."""
    bsz, l, k, _ = ls.score.shape
    neg_inf = torch.full_like(ls.score, -float("inf"))
    masked = torch.where(ls.ok, ls.score, neg_inf).reshape(bsz, l, k * k)
    vals, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals = vals[..., :m]
    return CompactConnections(pair=order[..., :m].to(torch.int32),
                              score=vals, ok=vals != -float("inf"))
