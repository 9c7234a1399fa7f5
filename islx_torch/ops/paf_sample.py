"""Exact PAF line-integral scoring of every limb's K x K candidate pairs.

``paf_sample`` is the port of the Pallas kernel
``islx/ops/pallas_paf.py::_sample_kernel`` together with the score math of
``islx/ops/paf.py::score_limbs`` around it. On a CUDA tensor it launches the
hand-written kernel in ``islx_torch/csrc/paf_sample.cu``; on a CPU tensor it
runs :func:`paf_sample_plain`, the plain PyTorch version of the same
function, in the same operation order. There is no fallback between the
two: a CUDA tensor the kernel cannot take raises.

Every function here takes its limb table as a :class:`LimbTable`,
checked and laid out once; a caller that scores many frames
(``pose.body.Body``) makes one at construction, so that a call does no
numpy work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from islx_torch.core.runtime import fma_rn, rdiv, sqrt_rn
from islx_torch.ops import _build


MAX_LIMBS = 64         # rows of the table the kernel takes by value
MAX_THREADS = 1024     # a block's threads: rows * K
# pairs a block, as rows of K: 384 blocks at L=24, K=32 on 132 SMs, the
# fastest in a parity Body call (PERF.md §6)
BLOCK_PAIRS = 64


class LimbTable:
    """A limb table checked and laid out once: ``rows`` [L,4] int32 (a part,
    b part, x channel, y channel), the same rows as a ctypes array that the
    kernel's launch copies into its parameters, and the largest part and
    channel for the per-call range check."""

    def __init__(self, limb_seq, map_idx):
        tab = np.concatenate([np.asarray(limb_seq).reshape(-1, 2),
                              np.asarray(map_idx).reshape(-1, 2)], 1)
        if tab.size and tab.min() < 0:
            raise ValueError("paf_sample: limb table out of range")
        tab = tab.astype(np.int32)
        self.rows = torch.from_numpy(tab)
        self.c_rows = (ctypes.c_int32 * tab.size)(*tab.ravel().tolist())
        self.max_part = int(tab[:, :2].max(initial=-1))
        self.max_chan = int(tab[:, 2:].max(initial=-1))

    def __len__(self) -> int:
        return len(self.rows)


def block_rows(k: int) -> int:
    """Rows of candidates a block takes: BLOCK_PAIRS pairs, at least one
    row, at most K."""
    return max(1, min(k, BLOCK_PAIRS // k))


@functools.lru_cache(maxsize=32)
def _samples_t(mid_num: int, device) -> torch.Tensor:
    """The f32 sample positions along a limb, the words of
    ``jnp.linspace(0, 1, mid_num)`` as XLA computes them: ``i * f32(1/div)``
    and an exact 1.0 at the end (``torch.linspace`` differs in the last bit
    for some counts, e.g. 7). Made once a device: a copy from host memory
    waits for the work queued before it, so one a call would stall the
    fused step once a limb. Callers must not write to it."""
    t = np.arange(mid_num, dtype=np.float32)
    if mid_num > 1:
        t = t * np.float32(1.0 / (mid_num - 1))
        t[-1] = 1.0
    return torch.from_numpy(t.astype(np.float32)).to(device)


def _inv_mid(mid_num: int) -> float:
    """The mean's factor: XLA rewrites the JAX code's ``sum / mid`` into a
    multiply by the f32 reciprocal."""
    return float(np.float32(1.0 / mid_num))


@functools.lru_cache(maxsize=64)
def _scalars(thre2: float, mid_num: int, orig_h: float) -> tuple:
    """The kernel's f32 scalars: thre2, half the height, the hit count to
    pass, 1/mid and the sample step ``_samples_t`` multiplies by."""
    step = np.float32(1.0 / (mid_num - 1)) if mid_num > 1 else 0.0
    return (float(np.float32(thre2)),
            float(np.float32(0.5 * float(np.float32(orig_h)))),
            float(np.float32(0.8 * mid_num)), _inv_mid(mid_num), float(step))


# How XLA's CPU program sums the mean's 2*mid products, by mid: LLVM
# vectorises the loop over the samples at some mids. ``(vf, vec)``: the
# first ``vec`` samples go into ``vf`` lanes, sample m into lane m % vf (a
# lane starts at +0 for lane 0 and -0 for the others, and takes its
# samples' x then y product as multiply-adds), the lanes are added by
# halves ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7)), and the samples
# from ``vec`` on are multiply-added onto that sum in order. Any mid not
# listed is the plain chain, (1, 0). Read from the optimised LLVM IR of
# ``islx.ops.paf.score_limbs`` and held bit-equal at every mid 1-20
# (tests/test_torch_parity_kernels.py); above 20 the chain is not XLA's
# order at every mid.
SUM_LANES = {2: (2, 2), 4: (4, 4), 8: (8, 8), 16: (8, 16), 17: (8, 16),
             18: (8, 16), 19: (8, 16), 20: (4, 20)}


def sum_plan(mid_num: int) -> Tuple[int, int]:
    """``(vf, vec)`` of :data:`SUM_LANES` for ``mid_num``."""
    return SUM_LANES.get(mid_num, (1, 0))


def paf_sample_plain(paf: torch.Tensor, peaks_xy: torch.Tensor,
                     peaks_valid: torch.Tensor, limbs: LimbTable,
                     thre2: float = 0.05, mid_num: int = 10,
                     orig_h: float = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """paf [H,W,P] f32, peaks_xy [C,K,2] int, peaks_valid [C,K] bool,
    limbs (L rows) -> (score [L,K,K] f32, ok [L,K,K] bool);
    islx/ops/paf.py:61-117.

    The arithmetic is the JAX code's as XLA compiles it for the CPU: the
    sample points, each sample's dot with the unit vector, the mean's sum
    of products and the mean plus prior are fused multiply-adds, and the
    mean's sum runs over the 2*mid products in (sample, x/y) order (at
    mid 2, XLA's program adds the two samples' dots instead)."""
    terms = paf_sample_terms(paf, peaks_xy, peaks_valid, limbs, thre2,
                             mid_num, orig_h)
    return terms["score"], terms["ok"]


def paf_sample_terms(paf: torch.Tensor, peaks_xy: torch.Tensor,
                     peaks_valid: torch.Tensor, limbs: LimbTable,
                     thre2: float = 0.05, mid_num: int = 10,
                     orig_h: float = None) -> dict:
    """:func:`paf_sample_plain`'s intermediate tensors by name, in the order
    they are computed, ending in ``score`` and ``ok``: run on two devices,
    they show the first step that rounds apart."""
    h, w = paf.shape[0], paf.shape[1]
    if orig_h is None:
        orig_h = h
    tab = limbs.rows.to(paf.device).long()
    a = peaks_xy[tab[:, 0]].float()                       # [L,K,2]
    b = peaks_xy[tab[:, 1]].float()
    vec = b[:, None, :, :] - a[:, :, None, :]             # [L,K,K,2]
    vx, vy = vec[..., 0], vec[..., 1]
    norm = torch.clamp_min(sqrt_rn(vx * vx + vy * vy), 0.001)
    ux, uy = vx / norm, vy / norm
    t = _samples_t(mid_num, paf.device)
    px = fma_rn(vx[..., None], t, a[:, :, None, None, 0])   # [L,K,K,mid]
    py = fma_rn(vy[..., None], t, a[:, :, None, None, 1])
    xi = torch.clamp(torch.round(px).long(), 0, w - 1)
    yi = torch.clamp(torch.round(py).long(), 0, h - 1)
    sx = paf[yi, xi, tab[:, 2, None, None, None]]
    sy = paf[yi, xi, tab[:, 3, None, None, None]]
    ux_, uy_ = ux[..., None], uy[..., None]
    score_mid = fma_rn(sy, uy_, sx * ux_)
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
    prior = torch.clamp_max(rdiv(0.5 * float(np.float32(orig_h)), norm) - 1.0,
                            0.0)
    score = fma_rn(total, torch.full_like(total, _inv_mid(mid_num)), prior)
    crit1 = (score_mid > float(np.float32(thre2))).sum(-1) > 0.8 * mid_num
    valid = peaks_valid.bool()
    ok = (crit1 & (score > 0) & valid[tab[:, 0]][:, :, None]
          & valid[tab[:, 1]][:, None, :])
    return {"norm": norm, "ux": ux, "uy": uy, "px": px, "py": py, "sx": sx,
            "sy": sy, "score_mid": score_mid, "total": total,
            "prior": prior, "score": score, "ok": ok}


@functools.cache
def _kernel():
    lib = _build.load("paf_sample")
    fn = lib.islx_paf_sample
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paf_sample(paf: torch.Tensor, peaks_xy: torch.Tensor,
               peaks_valid: torch.Tensor, limbs: LimbTable,
               thre2: float = 0.05, mid_num: int = 10, orig_h: float = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """paf [H,W,P] f32, peaks_xy [C,K,2] int32, peaks_valid [C,K] bool,
    limbs (L rows) -> (score [L,K,K] f32, ok [L,K,K] bool).

    CUDA tensors go through the sm_90a kernel on the current stream (no
    synchronisation; ``paf_sample.launches`` counts the launches), CPU
    tensors through :func:`paf_sample_plain`. The two outputs are views of
    one allocation."""
    if not isinstance(limbs, LimbTable):
        raise TypeError(f"paf_sample: need a LimbTable, got {type(limbs)}")
    if paf.device.type == "cpu":
        return paf_sample_plain(paf, peaks_xy, peaks_valid, limbs, thre2,
                                mid_num, orig_h)
    if paf.device.type != "cuda":
        raise ValueError(f"paf_sample: unsupported device {paf.device}")
    if paf.dtype != torch.float32 or paf.dim() != 3:
        raise TypeError(f"paf_sample: need paf [H,W,P] float32, got "
                        f"{paf.dtype} {tuple(paf.shape)}")
    if peaks_xy.dtype != torch.int32 or peaks_xy.dim() != 3 \
            or peaks_xy.shape[2] != 2:
        raise TypeError(f"paf_sample: need peaks_xy [C,K,2] int32, got "
                        f"{peaks_xy.dtype} {tuple(peaks_xy.shape)}")
    if peaks_valid.dtype != torch.bool \
            or peaks_valid.shape != peaks_xy.shape[:2]:
        raise TypeError("paf_sample: need peaks_valid [C,K] bool")
    dev = paf.device
    for name, x in (("paf", paf), ("peaks_xy", peaks_xy),
                    ("peaks_valid", peaks_valid)):
        if x.device != dev:
            raise ValueError(f"paf_sample: {name} on {x.device}, paf on "
                             f"{dev}")
        if not x.is_contiguous():
            raise ValueError(f"paf_sample: {name} must be contiguous")
    h, w, p = paf.shape
    c, k = peaks_xy.shape[:2]
    if limbs.max_part >= c or limbs.max_chan >= p:
        raise ValueError("paf_sample: limb table out of range")
    if len(limbs) > MAX_LIMBS:
        raise ValueError(f"paf_sample: {len(limbs)} limbs, at most "
                         f"{MAX_LIMBS}")
    if mid_num < 1 or h * w == 0:
        raise ValueError(f"paf_sample: need mid_num >= 1 and a non-empty "
                         f"map, got {mid_num}, {h}x{w}")
    if k > MAX_THREADS:
        raise ValueError(f"paf_sample: K = {k}, at most {MAX_THREADS}")
    l = len(limbs)
    n = l * k * k
    # one allocation, for host time: the score words, then the ok bytes
    # (two strided views: each view op costs host time of the order of an
    # allocation)
    buf = torch.empty(-(-5 * n // 4) * 4, dtype=torch.uint8, device=dev)
    score = buf.view(torch.float32).as_strided((l, k, k), (k * k, k, 1))
    ok = buf.view(torch.bool).as_strided((l, k, k), (k * k, k, 1), 4 * n)
    if n == 0:
        return score, ok
    _build.launch("paf_sample", _kernel(), dev, paf.data_ptr(),
                  peaks_xy.data_ptr(), peaks_valid.data_ptr(), limbs.c_rows,
                  buf.data_ptr(), buf.data_ptr() + 4 * n, h, w, p, l, k,
                  mid_num, block_rows(k), *sum_plan(mid_num),
                  *_scalars(thre2, mid_num, h if orig_h is None else orig_h))
    paf_sample.launches += 1
    return score, ok


paf_sample.launches = 0
