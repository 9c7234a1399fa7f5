"""Coarse-to-fine hand keypoints from net-resolution heatmaps (port of
``islx/ops/hand_peaks.py::find_hand_peaks_refine``), batched over crops.

(1) blur (sigma 3/up) + threshold + argmax at net resolution; (2) cubic
upsample only a ``window``-cell neighbourhood of the coarse peak with the
global-phase resize matrix; (3) argmax of the refined patch. Windows are
cut with one-hot matmuls, which are exact in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from islx_torch.ops.blur import gaussian_blur
from islx_torch.ops.resize import _resize_matrix


class HandPeaks(NamedTuple):
    """xy [N,C,2] int32 (x, y), (0, 0) where a part has no pixel above the
    threshold; found [N,C] bool."""

    xy: torch.Tensor
    found: torch.Tensor


def find_hand_peaks_refine(heat_small: torch.Tensor, thre: float = 0.05,
                           up: int = 8, window: int = 8) -> HandPeaks:
    """heat_small [N,h8,w8,C] -> peaks in (h8*up, w8*up) coordinates."""
    n, h8, w8, c = heat_small.shape
    dev = heat_small.device
    hm = heat_small.float()
    blurred = gaussian_blur(hm, 3.0 / up)
    mask = blurred > thre
    found = mask.any(dim=2).any(dim=1)                         # [N,C]
    flat = torch.where(mask, hm, torch.full_like(hm, -float("inf")))
    coarse = torch.argmax(flat.permute(0, 3, 1, 2).reshape(n, c, -1), dim=-1)
    cy, cx = coarse // w8, coarse % w8
    y0 = torch.clamp(cy - window // 2, 0, max(h8 - window, 0))   # [N,C]
    x0 = torch.clamp(cx - window // 2, 0, max(w8 - window, 0))

    u_mat = torch.from_numpy(_resize_matrix(window, window * up)).to(dev)
    off = torch.arange(window, device=dev)
    iy = torch.arange(h8, device=dev)
    ix = torch.arange(w8, device=dev)
    sy = (iy == (y0[..., None, None] + off[:, None])).float()  # [N,C,win,h8]
    sx = (ix == (x0[..., None, None] + off[:, None])).float()  # [N,C,win,w8]
    hmc = hm.permute(0, 3, 1, 2)                                # [N,C,h8,w8]
    win = torch.matmul(torch.matmul(sy, hmc), sx.transpose(-1, -2))
    # same contraction order as the JAX einsum: rows first, then columns
    patch = torch.matmul(torch.matmul(u_mat, win), u_mat.t())  # [N,C,P,P]
    side = window * up
    p = torch.argmax(patch.reshape(n, c, -1), dim=-1)
    py = p // side + y0 * up
    px = p % side + x0 * up
    xy = torch.stack([px, py], dim=-1).to(torch.int32)
    xy = torch.where(found[..., None], xy, torch.zeros_like(xy))
    return HandPeaks(xy=xy, found=found)
