"""Sharded CPM forwards (port of ``islx/parallel/sharding.py``).

* :func:`make_batched_forward`: frames over ``data``, the net replicated;
* :func:`make_spatial_forward`: each device computes a vertical stripe of
  every frame (width over ``model``, batch over ``data``) and exchanges
  the columns each conv needs with its neighbours: ``k // 2`` of them
  before a conv of kernel ``k`` (one for BODY_25's 3x3 convs, three for the
  7x7 convs of the hand and COCO stages, none for a 1x1). Stripe edges stay
  on multiples of 8 pixels, so the three 2x2 pools split with the frame;
  a width that ``8 * n_model`` does not divide leaves the ragged end in
  the last stripe, and the result is the single forward's.

Both return ``fn(params, x)`` for a port weight state (or the copies of
:func:`islx_torch.parallel.mesh.shard_cpm_params`) and NHWC input, and give
the net's outputs gathered on the mesh's first device. Nets are built
once a device and a weight state, and every shard is queued before any
result is read.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from islx_torch.core import weights as W
from islx_torch.core.runtime import true_f32
from islx_torch.models import cpm
from islx_torch.parallel import mesh as M


class _Nets:
    """Nets built from one weight state (the latest seen: a step uploads no
    weights), a copy a data row of the mesh (``grid``: a copy a device of
    the grid), by :func:`~islx_torch.parallel.mesh.replicate`. ``params``
    is a port weight state or :func:`~islx_torch.parallel.mesh.
    shard_cpm_params`' copies; a net is built from the copy on its own
    device where there is one."""

    def __init__(self, model_type: str, compute_dtype, grid: bool = False):
        self.model_type, self.compute_dtype = model_type, compute_dtype
        self.grid = grid
        self._key, self._nets = None, None

    def __call__(self, params, mesh: M.Mesh):
        key = (params, mesh.devices.shape, tuple(mesh.devices.ravel()))
        if self._key is None or self._key[0] is not params \
                or self._key[1:] != key[1:]:
            def make(dev):
                state = params
                if isinstance(params, list):
                    state = next((p for p, d in zip(params,
                                                    mesh.data_devices)
                                  if d == dev), params[0])
                return W.build(self.model_type, state, dev,
                               self.compute_dtype)

            self._key = key
            self._nets = M.replicate(mesh, make, grid=self.grid)
        return self._nets


def make_batched_forward(model_type: str, mesh: Optional[M.Mesh] = None,
                         compute_dtype=torch.bfloat16):
    """Batched CPM forward: x [B,H,W,3] normalized -> (paf, heat) (or
    heat). With a mesh, B is split over the data axis and the net
    replicates; without one the net runs on x's device."""
    nets = _Nets(model_type, compute_dtype)

    @torch.inference_mode()
    def fn(params, x: torch.Tensor):
        grid = mesh or M.single(x.device)
        sharding = M.batch_sharding(grid)
        return sharding.gather([net(xs, compute_dtype) for net, xs in
                                zip(nets(params, grid), sharding.put(x))])

    return fn


def _halo(xs: List[torch.Tensor], j: int, h: int):
    """The ``h`` columns left and right of stripe ``j`` (fewer at the
    frame's edges), read from the stripes that hold them, on stripe
    ``j``'s device: NCHW tensors, width last."""
    dev = xs[j].device
    left, need, i = [], h, j - 1
    while need > 0 and i >= 0:
        w = xs[i].shape[3]
        take = min(w, need)
        left.insert(0, xs[i][..., w - take:].to(dev))
        need, i = need - take, i - 1
    right, need, i = [], h, j + 1
    while need > 0 and i < len(xs):
        take = min(xs[i].shape[3], need)
        right.append(xs[i][..., :take].to(dev))
        need, i = need - take, i + 1
    return left, right


class StripedCPM(cpm.CPM):
    """A CPM whose activations are lists of width stripes (NCHW), stripe
    ``j`` on ``replicas[j]``'s device. It keeps :class:`~islx_torch.models.
    cpm.CPM`'s wiring and replaces its three primitives: a conv gathers
    its halo from the neighbouring stripes, runs the replica's layer on
    the widened stripe (the layer's own zero padding is used only at the
    frame's edges) and keeps the stripe's columns; pools and channel
    concatenations run stripe by stripe."""

    def __init__(self, replicas: List[cpm.CPM]):
        nn.Module.__init__(self)
        if any(r.quantized for r in replicas):
            raise ValueError("the spatial forward runs float nets; int8 "
                             "layers chain NHWC activations across convs")
        self.model_type = replicas[0].model_type
        self.spec, self.cells = replicas[0].spec, replicas[0].cells
        self.layers = replicas[0].layers     # _seq's layer-kind checks
        self.replicas = replicas

    def _conv(self, xs, name: str, cd):
        h = self.layers[name].spec.k // 2
        out = []
        for j, x in enumerate(xs):
            left, right = _halo(xs, j, h) if h else ([], [])
            hl = sum(t.shape[3] for t in left)
            y = self.replicas[j].layers[name](
                torch.cat(left + [x] + right, dim=3), cd)
            out.append(y[..., hl:hl + x.shape[3]])
        return out

    def _pool(self, xs, layer: cpm.Pool):
        return [F.max_pool2d(x, layer.k, layer.s) for x in xs]

    def _cat(self, xss):
        return [torch.cat(parts, dim=1) for parts in zip(*xss)]

    def forward(self, stripes_nhwc: List[torch.Tensor],
                compute_dtype: torch.dtype = torch.float32):
        """NHWC stripes -> the outputs as lists of NHWC stripes."""
        xs = [s.permute(0, 3, 1, 2) for s in stripes_nhwc]
        with true_f32():
            outs = self.outputs(xs, compute_dtype)
        return tuple([o.permute(0, 2, 3, 1) for o in out] for out in outs)


def make_spatial_forward(model_type: str, mesh: M.Mesh,
                         compute_dtype=torch.bfloat16):
    """Spatially-partitioned CPM forward: x [B,H,W,3] -> (paf, heat) (or
    heat), the frames' width over ``model`` and the batch over ``data``
    (:class:`StripedCPM`): the few-large-frames regime, where the batch
    alone cannot fill the mesh. Any width with at least ``n_model``
    8-pixel columns."""
    nets = _Nets(model_type, compute_dtype, grid=True)
    sharding = M.spatial_sharding(mesh)

    @torch.inference_mode()
    def fn(params, x: torch.Tensor):
        outs = [StripedCPM(row)(stripes, compute_dtype) for row, stripes
                in zip(nets(params, mesh), sharding.put(x))]
        res = tuple(sharding.gather([o[k] for o in outs])
                    for k in range(len(outs[0])))
        return res if len(res) > 1 else res[0]

    return fn
