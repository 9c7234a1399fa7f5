"""The C++ person grouping, bound with ``ctypes`` (port of
``islx/ops/native.py``).

``csrc/grouping.cpp`` runs the greedy limb assignment and the person merge
of a whole batch in one call; it is built with ``g++`` at first use
(:mod:`islx_torch.ops._build`). Its results are those of the numpy copy,
:func:`islx_torch.ops.grouping.assemble_sorted`, frame by frame, which runs
instead only where the caller sets islx's switch ``ISLX_NO_NATIVE``. A
failed build raises: there is no quiet fallback to numpy.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Tuple

import numpy as np

from islx_torch.ops import _build


def enabled() -> bool:
    """Whether the fused step groups with the C++ code: unless
    ``ISLX_NO_NATIVE`` is set to a non-empty value (islx's switch)."""
    return not os.environ.get("ISLX_NO_NATIVE")


def get_lib() -> ctypes.CDLL:
    """The loaded grouping library, built at first use. Where islx returns
    None after a failed build, this raises: there is no quiet fallback."""
    return _build.load("grouping")


def available() -> bool:
    """Whether the grouping runs in C++ (islx's name): False under
    ``ISLX_NO_NATIVE``, else the library is loaded (built at first use),
    and a failed build raises."""
    if not enabled():
        return False
    get_lib()
    return True


@functools.cache
def _fn():
    fn = get_lib().islx_assemble_batch
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [i32p, f32p, i32p, i32p, f32p, u8p,
                                        i32p, ctypes.c_int, ctypes.c_int,
                                        f64p, i32p, f64p, i32p]
    return fn


def assemble_batch(xy: np.ndarray, score: np.ndarray, count: np.ndarray,
                   pair: np.ndarray, cscore: np.ndarray, cok: np.ndarray,
                   k: int, limb_seq: np.ndarray, njoint: int,
                   max_subset: int = 512
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A batch's peak and sorted connection tables -> per-frame
    (candidate [N,4], subset [P, njoint+1]) f64, as
    :func:`islx_torch.ops.grouping.assemble_sorted` gives them.

    xy [B,C,K,2] i32, score [B,C,K] f32, count [B,C] i32 (each in [0, K]),
    pair/cscore/cok [B,L,M], limb_seq [L,2] channel indices."""
    b, c, kk, _ = xy.shape
    l, m = pair.shape[1], pair.shape[2]
    limb_seq = np.ascontiguousarray(limb_seq, np.int32)
    count = np.ascontiguousarray(count, np.int32)
    if k != kk:
        raise ValueError(f"assemble_batch: k={k}, but xy holds {kk} peaks "
                         f"a channel")
    if (score.shape != (b, c, kk) or count.shape != (b, c)
            or cscore.shape != (b, l, m) or cok.shape != (b, l, m)
            or limb_seq.shape != (l, 2)):
        raise ValueError("assemble_batch: table shapes do not agree")
    if count.size and (count.min() < 0 or count.max() > kk):
        raise ValueError(f"assemble_batch: counts outside [0, {kk}]")
    if limb_seq.size and (limb_seq.min() < 0 or limb_seq.max() >= c):
        raise ValueError(f"assemble_batch: limb table outside {c} channels")
    cols = njoint + 1
    max_cand = c * kk
    cand = np.zeros((b, max_cand, 4), np.float64)
    n_cand = np.zeros((b,), np.int32)
    subset = np.zeros((b, max_subset, cols), np.float64)
    n_subset = np.zeros((b,), np.int32)
    ret = _fn()(b, c, kk, l, m, njoint,
                np.ascontiguousarray(xy, np.int32),
                np.ascontiguousarray(score, np.float32), count,
                np.ascontiguousarray(pair, np.int32),
                np.ascontiguousarray(cscore, np.float32),
                np.ascontiguousarray(cok, np.uint8), limb_seq, max_cand,
                max_subset, cand, n_cand, subset, n_subset)
    if ret != 0:
        raise RuntimeError(f"islx_assemble_batch returned {ret}")
    return [(cand[i, :n_cand[i]].copy(), subset[i, :n_subset[i]].copy())
            for i in range(b)]
