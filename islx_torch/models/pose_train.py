"""Pose-net training: CPM heatmap and PAF regression (port of
``islx/models/pose_train.py``).

The reference freezes every pose parameter (src/model.py:167-168); islx
trains the CPMs with OpenPose-style supervision, the MSE between predicted
and target heatmaps and PAFs at the net's resolution, and so does the
port: Adam (1e-4) on a float :class:`~islx_torch.models.cpm.CPM` whose f32
master weights are rounded to the compute dtype at use. A step runs its
forward and backward inside ``true_f32()``, so an f32 net keeps islx's f32
meaning on the card (no TF32).

The targets are numpy, computed on the host from keypoint annotations
(the port's own copies of islx's functions).

With a mesh (``make_train_step(..., mesh=)``) the batch is split over its
data axis: each data row runs a replica of the net on its rows, the
outputs are gathered on the first device and the loss, its
``pos_weight`` and deep supervision are the global batch's, as in the
unsharded step; the replicas' gradients are summed into the master net,
Adam steps it, and the new weights are copied to the replicas.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from islx_torch.core import weights as W
from islx_torch.core.runtime import resolve_device, true_f32
from islx_torch.models import cpm
from islx_torch.ops.paf import LIMB_TABLES
from islx_torch.parallel import mesh as M


@dataclasses.dataclass
class PoseTrainState:
    net: cpm.CPM
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.Adam:
    """optax.adam(lr)'s defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _weighted_heat_mse(heat: torch.Tensor, heat_t: torch.Tensor,
                       pos_weight: float) -> torch.Tensor:
    """MSE with joint cells upweighted by ``1 + pos_weight * target``.

    Gaussian joint targets are sparse, so a uniform MSE lets the all-zeros
    prediction reach a small loss without localizing. The weight applies
    to the joint channels only: the background channel (last, ~1 in empty
    cells) keeps weight 1. pos_weight=0 is the plain MSE."""
    if pos_weight == 0.0:
        return torch.mean((heat - heat_t) ** 2)
    joints = heat_t.clone()
    joints[..., -1] = 0.0
    return torch.mean((1.0 + pos_weight * joints) * (heat - heat_t) ** 2)


def loss_fn(net: cpm.CPM, x: torch.Tensor, heat_t: torch.Tensor,
            paf_t: torch.Tensor, model_type: str,
            compute_dtype: torch.dtype = torch.bfloat16,
            pos_weight: float = 0.0, deep_supervision: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,H,W,3] normalized; targets at the net's resolution
    [B,H/8,W/8,C] -> (loss, metrics).

    deep_supervision (hand only): every CPM stage head is driven toward
    the target, averaged over the six. Body PAFs, with pos_weight > 0, are
    weighted by ``1 + pos_weight * |paf_t|`` (sparse along limbs)."""
    if model_type == "hand":
        if deep_supervision:
            outs = net.hand_forward_stages(x, compute_dtype)
            heat_loss = sum(_weighted_heat_mse(h, heat_t, pos_weight)
                            for h in outs) / len(outs)
        else:
            heat_loss = _weighted_heat_mse(net(x, compute_dtype), heat_t,
                                           pos_weight)
        return heat_loss, {"loss": heat_loss.detach(),
                           "heat_loss": heat_loss.detach()}
    paf, heat = net(x, compute_dtype)
    heat_loss = _weighted_heat_mse(heat, heat_t, pos_weight)
    if pos_weight == 0.0:
        paf_loss = torch.mean((paf - paf_t) ** 2)
    else:
        wp = 1.0 + pos_weight * torch.abs(paf_t)
        paf_loss = torch.mean(wp * (paf - paf_t) ** 2)
    loss = heat_loss + paf_loss
    return loss, {"loss": loss.detach(), "heat_loss": heat_loss.detach(),
                  "paf_loss": paf_loss.detach()}


class MeshNet:
    """A master net's forward with the batch over a mesh's data rows (the
    1x1 mesh of the net's device without one): row ``i`` runs its own copy
    (:func:`~islx_torch.parallel.mesh.replicate`; row 0's is the master),
    and the outputs are gathered on the mesh's first device, which must
    hold the master. :meth:`reduce` adds the other copies' gradients into
    the master's; :meth:`broadcast` copies the master's weights to them."""

    def __init__(self, net: cpm.CPM, mesh=None):
        dev = next(net.parameters()).device
        mesh = mesh or M.single(dev)
        if dev != mesh.first:
            raise ValueError(f"the master net is on {dev}, the mesh starts "
                             f"at {mesh.first}")
        self.net, self.mesh = net, mesh
        self._sharding = M.batch_sharding(mesh)
        self.replicas = M.replicate(
            mesh, lambda d: copy.deepcopy(net).to(d), first=net)

    def _rows(self, x, fn):
        return self._sharding.gather(
            [fn(r, xs) for r, xs in zip(self.replicas,
                                        self._sharding.put(x))])

    def __call__(self, x, compute_dtype):
        return self._rows(x, lambda net, xs: net(xs, compute_dtype))

    def hand_forward_stages(self, x, compute_dtype):
        return self._rows(
            x, lambda net, xs: net.hand_forward_stages(xs, compute_dtype))

    def zero_grad(self) -> None:
        for r in self.replicas[1:]:
            r.zero_grad(set_to_none=True)

    @torch.no_grad()
    def reduce(self) -> None:
        for r in self.replicas[1:]:
            for p, q in zip(self.net.parameters(), r.parameters()):
                if q.grad is not None:
                    g = q.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad + g

    @torch.no_grad()
    def broadcast(self) -> None:
        for r in self.replicas[1:]:
            for p, q in zip(self.net.parameters(), r.parameters()):
                q.copy_(p)


def make_train_step(state: PoseTrainState, model_type: str = "body25",
                    compute_dtype: torch.dtype = torch.bfloat16,
                    pos_weight: float = 0.0, deep_supervision: bool = False,
                    mesh=None):
    """-> step(x, heat_t, paf_t) -> metrics (tensors on the net's device),
    updating ``state``: the gradient, then the Adam update. With a
    ``mesh`` (the net on its first device) the batch is split over its
    data axis (:class:`MeshNet`)."""
    net = MeshNet(state.net, mesh)
    first = net.mesh.first

    def step(x, heat_t, paf_t):
        state.optimizer.zero_grad(set_to_none=True)
        net.zero_grad()
        with true_f32():
            loss, metrics = loss_fn(net, x, heat_t.to(first),
                                    paf_t.to(first), model_type,
                                    compute_dtype, pos_weight,
                                    deep_supervision)
            loss.backward()
        net.reduce()
        state.optimizer.step()
        net.broadcast()
        state.step += 1
        return metrics

    return step


def init_state(model_type: str = "body25", lr: float = 1e-4,
               params: Optional[W.State] = None, seed: int = 0,
               device=None) -> PoseTrainState:
    """A trainable float CPM on ``device`` (a port weight state, or the
    port's seeded init) with its Adam, at step 0."""
    if params is None:
        params = W.init_params(model_type, seed)
    net = cpm.CPM(model_type).load_params(params).to(
        resolve_device(device)).trainable()
    return PoseTrainState(net, make_optimizer(net.parameters(), lr))


def gaussian_heatmap_targets(keypoints: np.ndarray, visible: np.ndarray,
                             h8: int, w8: int, stride: int = 8,
                             sigma: float = 7.0) -> np.ndarray:
    """Ground-truth heatmaps from keypoint annotations.

    keypoints [B,C,2] (x, y) in input-pixel coords; visible [B,C] bool ->
    [B,h8,w8,C+1] with the standard background channel = 1 - max(joints).
    """
    b, c = keypoints.shape[:2]
    yy, xx = np.mgrid[0:h8, 0:w8].astype(np.float32)
    grid_x = xx * stride + stride / 2 - 0.5
    grid_y = yy * stride + stride / 2 - 0.5
    out = np.zeros((b, h8, w8, c + 1), np.float32)
    for i in range(b):
        for j in range(c):
            if not visible[i, j]:
                continue
            d2 = ((grid_x - keypoints[i, j, 0]) ** 2
                  + (grid_y - keypoints[i, j, 1]) ** 2)
            out[i, :, :, j] = np.maximum(out[i, :, :, j],
                                         np.exp(-d2 / (2 * sigma ** 2)))
        out[i, :, :, c] = 1.0 - out[i, :, :, :c].max(axis=-1)
    return out


def pose_targets(kp: np.ndarray, vis: np.ndarray, h8: int, w8: int,
                 model_type: str = "body25", sigma: float = 7.0):
    """Multi-person keypoint annotations -> supervision in the net's layout.

    kp [P,J,2] input-pixel (x,y) for P people, vis [P,J] bool ->
    (heat [h8,w8,J+1], paf [h8,w8,npaf] | None). Heatmaps are max-combined
    across people with the background channel last; body PAFs are
    unit-vector fields in the net's MAP_IDX channel layout, count-averaged
    where people overlap (the OpenPose rule). Hand returns heat only.
    """
    p, j = kp.shape[:2]
    heats = [gaussian_heatmap_targets(kp[i][None], vis[i][None], h8, w8,
                                      sigma=sigma) for i in range(p)]
    joint = np.max(np.stack([h[0, :, :, :j] for h in heats]), axis=0)
    bg = 1.0 - joint.max(-1)
    heat = np.concatenate([joint, bg[..., None]], -1)
    if model_type == "hand":
        return heat, None

    limb_seq, map_idx = LIMB_TABLES[model_type]
    npaf = {"body25": 52, "coco": 38}[model_type]
    paf = np.zeros((h8, w8, npaf), np.float32)
    cnt = np.zeros((h8, w8, npaf // 2), np.int32)
    for i in range(p):
        limbs = np.stack([np.stack([kp[i, a], kp[i, b]])
                          for a, b in limb_seq.tolist()])
        valid = np.array([vis[i, a] and vis[i, b]
                          for a, b in limb_seq.tolist()])
        t = paf_targets(limbs[None], valid[None], h8, w8)[0]
        for k in range(len(limb_seq)):
            c0, c1 = int(map_idx[k, 0]), int(map_idx[k, 1])
            m = (t[:, :, 2 * k] != 0) | (t[:, :, 2 * k + 1] != 0)
            paf[:, :, c0] += np.where(m, t[:, :, 2 * k], 0)
            paf[:, :, c1] += np.where(m, t[:, :, 2 * k + 1], 0)
            cnt[:, :, c0 // 2] += m
    denom = np.maximum(np.repeat(cnt, 2, axis=2), 1)
    return heat, paf / denom


def paf_targets(limbs_xy: np.ndarray, valid: np.ndarray, h8: int, w8: int,
                stride: int = 8, width: float = 1.0) -> np.ndarray:
    """Ground-truth PAFs from limb segments.

    limbs_xy [B,L,2,2] ((x1,y1),(x2,y2)) input-pixel coords; valid [B,L] ->
    [B,h8,w8,2L] unit vectors within ``width`` cells of each segment.
    """
    b, n_limbs = limbs_xy.shape[:2]
    yy, xx = np.mgrid[0:h8, 0:w8].astype(np.float32)
    gx = xx + 0.5
    gy = yy + 0.5
    out = np.zeros((b, h8, w8, 2 * n_limbs), np.float32)
    for i in range(b):
        for k in range(n_limbs):
            if not valid[i, k]:
                continue
            (x1, y1), (x2, y2) = limbs_xy[i, k] / stride
            dx, dy = x2 - x1, y2 - y1
            norm = max(np.hypot(dx, dy), 1e-6)
            ux, uy = dx / norm, dy / norm
            # distance from each cell to the segment
            t = np.clip(((gx - x1) * ux + (gy - y1) * uy) / norm, 0, 1)
            px, py = x1 + t * norm * ux, y1 + t * norm * uy
            d = np.hypot(gx - px, gy - py)
            m = d <= width
            out[i, :, :, 2 * k] = np.where(m, ux, out[i, :, :, 2 * k])
            out[i, :, :, 2 * k + 1] = np.where(m, uy, out[i, :, :, 2 * k + 1])
    return out
