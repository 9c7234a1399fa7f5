"""Hand keypoints (port of ``islx/ops/hand_peaks.py``).

* :func:`find_hand_peaks_refine`, the fused step's coarse-to-fine peaks,
  batched over crops: (1) blur (sigma 3/up) + threshold + argmax at net
  resolution; (2) cubic upsample only a ``window``-cell neighbourhood of the
  coarse peak with the global-phase resize matrix; (3) argmax of the refined
  patch. Windows are cut with one-hot matmuls, which are exact in f32.
* :func:`find_hand_peaks`, the parity path's exact peaks of one crop
  (reference src/hand.py:59-73): blur, threshold, 8-connected components
  (the CUDA kernel of :mod:`islx_torch.ops.cc_label`), the component with
  the largest sum of the unblurred map, and that component's first
  row-major maximum.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from islx_torch.ops.blur import gaussian_blur
from islx_torch.ops.cc_label import label_components
from islx_torch.ops.resize import _resize_matrix


class HandPeaks(NamedTuple):
    """xy [..., C, 2] int32 (x, y), (0, 0) where a part has no pixel above
    the threshold; found [..., C] bool."""

    xy: torch.Tensor
    found: torch.Tensor


def _one_part(map_ori: torch.Tensor, binary: torch.Tensor,
              lab: torch.Tensor):
    """Per channel, all at once (islx/ops/hand_peaks.py:68): map_ori, binary,
    lab [C,N] (N = H*W, labels from ``label_components``) -> (peak flat
    index [C], found [C]).

    The per-component sums use ``scatter_add_``, which sums with atomics in no
    fixed order on CUDA. They feed only the argmax over components, which
    can differ from the JAX code only if two components' sums lie within
    f32 rounding of each other."""
    c, n = map_ori.shape
    found = binary.any(dim=1)
    lab = lab.long()
    inside = lab < n
    sums = torch.zeros((c, n + 1), dtype=torch.float32, device=lab.device)
    sums.scatter_add_(1, torch.clamp_max(lab, n),
                      torch.where(inside, map_ori, 0.0))
    pos = torch.arange(n, device=lab.device)
    is_root = (lab == pos) & binary
    root_sums = torch.where(is_root, sums[:, :n], -float("inf"))
    # torch.argmax returns the first maximum, as jnp.argmax does
    best = torch.argmax(root_sums, dim=1)   # first max == skimage label order
    masked = torch.where(lab == best[:, None], map_ori, 0.0)
    return torch.argmax(masked, dim=1), found   # first row-major max (npmax)


def find_hand_peaks(heatmap: torch.Tensor, thre: float = 0.05,
                    sigma: float = 3.0, use_pallas: bool = False
                    ) -> HandPeaks:
    """heatmap [H,W,C] averaged hand heatmaps (the part channels) ->
    HandPeaks xy [C,2], found [C].

    ``use_pallas`` is kept for islx's signature: labelling goes through
    ``label_components`` either way (the CUDA kernel on the card, its plain
    version on the CPU)."""
    del use_pallas
    h, w, c = heatmap.shape
    blurred = gaussian_blur(heatmap, sigma)
    binary = blurred > float(np.float32(thre))
    labels = label_components(binary.contiguous())           # [H,W,C]
    peak, found = _one_part(heatmap.float().permute(2, 0, 1).reshape(c, -1),
                            binary.permute(2, 0, 1).reshape(c, -1),
                            labels.permute(2, 0, 1).reshape(c, -1))
    xy = torch.stack([peak % w, peak // w], dim=-1).to(torch.int32)
    xy = torch.where(found[:, None], xy, torch.zeros_like(xy))
    return HandPeaks(xy=xy, found=found)


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
