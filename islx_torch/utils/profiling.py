"""Tracing, profiling and observability (port of islx/utils/profiling.py).

* :class:`StageTimer`: named wall-clock spans with summary statistics, the
  light always-on layer (islx's, copied).
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler plugin
  and ``chrome://tracing`` read) into ``log_dir``. The pipelines' stages
  run in ``record_function`` ranges (``body_cpm``, ``body_peaks``,
  ``paf_limbs``, ``hand_crops``, ...), which the trace names; the port's
  ``ctypes`` kernels show as device activity in no range.
* :func:`log_compile_cache`: what stands for islx's jit-cache and live-array
  counts in an eager port: the kernel libraries loaded in this process
  (``ops/_build.py``; one a ``csrc`` source, never one a shape) and the
  device bytes allocated. Growth of the second across served shapes means
  a leak.

Time device work between CUDA events or under :func:`trace`: host spans
around asynchronous launches measure the launches.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class StageTimer:
    """Accumulate named wall-clock spans: ``with timer("decode"): ...``."""

    def __init__(self):
        self._spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._spans[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._spans.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_ms": 1000 * sum(xs) / len(xs),
                "p50_ms": 1000 * xs_sorted[len(xs) // 2],
                "max_ms": 1000 * xs_sorted[-1],
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>8}{'mean ms':>10}{'p50 ms':>10}"
                 f"{'max ms':>10}{'total s':>10}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24}{s['count']:>8}{s['mean_ms']:>10.2f}"
                         f"{s['p50_ms']:>10.2f}{s['max_ms']:>10.2f}"
                         f"{s['total_s']:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where
    it is available) and write its Chrome trace into ``log_dir``. Yields
    the profiler; after the block ``prof.trace_path`` is the file."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(
            log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(prof.trace_path)


def log_compile_cache() -> Dict[str, int]:
    """Loaded kernel libraries and device bytes allocated (0 where CUDA
    was never initialised in this process)."""
    import torch

    from islx_torch.ops import _build

    return {"kernel_libraries": len(_build._libs),
            "device_bytes_allocated": (torch.cuda.memory_allocated()
                                       if torch.cuda.is_initialized()
                                       else 0)}
