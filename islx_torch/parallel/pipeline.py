"""Pipeline parallelism (GPipe-style microbatches) for the CPM nets (port
of ``islx/parallel/pipeline.py``).

The default for the 26-52M-parameter CPMs is replication with data
parallelism; this covers a device too small for a net and its
activations:

* the net's stages are grouped into contiguous segments balanced by
  parameter count (an exact DP), one segment a device;
* each segment's parameters live only on its device;
* a batch is split into microbatches that flow device to device. Every
  microbatch is queued before any result is read, so segment s works on
  microbatch m while segment s+1 works on m-1;
* training gradients come from one backward pass a microbatch,
  accumulated and averaged (GPipe: the full-batch gradient of a
  mean-reduced loss).

The segments run :func:`islx_torch.models.cpm.cells`, the chain that
:class:`~islx_torch.models.cpm.CPM`'s own forward runs, so a pipelined
forward computes what the single net computes.
Forward and backward run inside ``true_f32()``: an f32 pipeline keeps
f32 on the card (no TF32).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from islx_torch.core.runtime import true_f32
from islx_torch.models import cpm

def _param_cost(model_type: str) -> Dict[str, int]:
    return {c.name: c.k * c.k * c.cin * c.cout
            for c in cpm.conv_layers(model_type)}


def _balance(cells: Sequence[cpm.Cell], costs: Dict[str, int],
             n_seg: int) -> List[List[cpm.Cell]]:
    """Contiguous partition of cells into n_seg groups minimizing the max
    group parameter cost (exact DP; cell counts are tiny)."""
    w = [sum(costs[n] for n in names) for _, names, _ in cells]
    n = len(cells)
    # best[k][i] = minimal max-cost partitioning cells[i:] into k groups
    INF = float("inf")
    best = [[INF] * (n + 1) for _ in range(n_seg + 1)]
    cut = [[0] * (n + 1) for _ in range(n_seg + 1)]
    best[0][n] = 0.0
    for k in range(1, n_seg + 1):
        for i in range(n - 1, -1, -1):
            acc = 0
            for j in range(i + 1, n + 1):
                acc += w[j - 1]
                v = max(acc, best[k - 1][j])
                if v < best[k][i]:
                    best[k][i], cut[k][i] = v, j
    groups, i = [], 0
    for k in range(n_seg, 0, -1):
        j = cut[k][i]
        groups.append(list(cells[i:j]))
        i = j
    if i != n:
        raise AssertionError((i, n))
    return groups


class PipelinedCPM:
    """A CPM split into per-device pipeline segments.

    ``params`` is a float port weight state. Each segment is a
    :class:`~islx_torch.models.cpm.CPM` holding only its own layers, on
    its device, with f32 weights that require gradients (the compute
    dtype rounds them at use, as in training). ``forward(x, n_micro)``
    computes ``CPM.forward``'s outputs; ``grads(x, targets, n_micro)``
    gives the GPipe-accumulated gradient of the summed MSE over the outputs
    with respect to every segment's parameters."""

    def __init__(self, params, model_type: str, devices: Sequence,
                 compute_dtype=torch.float32):
        cells = cpm.cells(model_type)
        n_seg = len(devices)
        if not 1 <= n_seg <= len(cells):
            raise ValueError(f"{model_type} has {len(cells)} pipeline "
                             f"cells; {n_seg} segments asked")
        self.model_type = model_type
        self.compute_dtype = compute_dtype
        self.devices = [torch.device(d) for d in devices]
        self.segments = []
        groups = _balance(cells, _param_cost(model_type), n_seg)
        for dev, group in zip(self.devices, groups):
            names = [n for _, cell_names, _ in group for n in cell_names]
            net = cpm.CPM(model_type)
            net.layers = nn.ModuleDict({n: net.layers[n] for n in names})
            net = net.load_params(params).to(dev).trainable()
            self.segments.append({"device": dev, "net": net, "names": names,
                                  "fns": [fn for _, _, fn in group],
                                  "cells": [c[0] for c in group]})

    def _micro(self, x: torch.Tensor, n_micro: int) -> List[torch.Tensor]:
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible into {n_micro} "
                             f"microbatches")
        return list(torch.split(x, b // n_micro))

    def _default_micro(self, b: int) -> int:
        """Largest divisor of b at most 2x the segment count (enough
        microbatches to fill the pipeline, no smaller than necessary)."""
        target = min(b, 2 * len(self.segments))
        return next(m for m in range(target, 0, -1) if b % m == 0)

    def _run(self, xm: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """One microbatch (NHWC) through every segment -> the outputs,
        NHWC, on the last segment's device."""
        state = {"x": xm.permute(0, 3, 1, 2)}
        for seg in self.segments:
            state = {k: v.to(seg["device"]) for k, v in state.items()}
            for fn in seg["fns"]:
                state = fn(seg["net"], state, self.compute_dtype)
        return tuple(state[k].permute(0, 2, 3, 1)
                     for k in cpm.OUT_KEYS[self.model_type])

    def forward(self, x: torch.Tensor, n_micro: int = None):
        """x [B,H,W,3] -> the outputs of ``CPM.forward``, on the last
        segment's device. Every microbatch is queued before any result is
        awaited."""
        n_micro = n_micro or self._default_micro(x.shape[0])
        with torch.no_grad(), true_f32():
            outs = [self._run(xm) for xm in self._micro(x, n_micro)]
        result = tuple(torch.cat(parts) for parts in zip(*outs))
        return result if len(result) > 1 else result[0]

    __call__ = forward

    def grads(self, x: torch.Tensor, targets, n_micro: int = None):
        """GPipe training: a backward pass a microbatch, gradients
        averaged over the microbatches -> (loss, [per-segment gradients
        as weight states, {name: {"w", "b"[, "p"]}}]). The averages are
        also left in the segments' ``.grad``, for their optimizers.

        targets: the structure of forward()'s output. The loss is the MSE
        of each output summed over outputs (islx's objective)."""
        n_micro = n_micro or self._default_micro(x.shape[0])
        tg = targets if isinstance(targets, tuple) else (targets,)
        last = self.segments[-1]["device"]
        tms = [self._micro(t.to(last), n_micro) for t in tg]
        for seg in self.segments:
            seg["net"].zero_grad(set_to_none=True)
        total = torch.zeros((), device=last)
        with true_f32():
            for m, xm in enumerate(self._micro(x, n_micro)):
                outs = self._run(xm)
                loss = sum(torch.mean((o.float() - t[m]) ** 2)
                           for o, t in zip(outs, tms))
                loss.backward()
                total = total + loss.detach()
        scale = 1.0 / n_micro
        grads = []
        for seg in self.segments:
            g = {}
            for name, layer in seg["net"].layers.items():
                entry = {"w": layer.weight, "b": layer.bias}
                if layer.prelu is not None:
                    entry["p"] = layer.prelu
                g[name] = {k: v.grad.mul_(scale) for k, v in entry.items()}
            grads.append(g)
        return total * scale, grads

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every segment's weights as one port weight state (f32, CPU)."""
        out = {}
        for seg in self.segments:
            out.update(seg["net"].state())
        return out
