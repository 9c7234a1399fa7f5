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
  row-major maximum. Given [N,H,W,C] (islx vmaps it over N crops) the N*C
  planes are labelled as the channels of one [H,W,N*C] map, in one
  kernel call: labels never cross channels.
* :func:`find_hand_peaks_fast`, the multi-scale pipeline's ``fast`` mode:
  the global first row-major maximum of the thresholded map.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from islx_torch.ops.blur import gaussian_blur
from islx_torch.ops.cc_label import label_components, tile_plan
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


def crops_per_call(h: int, w: int, c: int, n: int) -> int:
    """How many of n crops' [H,W,C] planes one labelling call takes: all of
    them while the kernel's tile plan fits a block's shared memory (its
    tiles lose rows as the channels grow), else halves."""
    k = n
    while k > 1:
        try:
            tile_plan(h, w, k * c)
            return k
        except ValueError:
            k = (k + 1) // 2
    return 1


def find_hand_peaks(heatmap: torch.Tensor, thre: float = 0.05,
                    sigma: float = 3.0, use_pallas: bool = False
                    ) -> HandPeaks:
    """heatmap [H,W,C] averaged hand heatmaps (the part channels), or
    [N,H,W,C] for N crops -> HandPeaks xy [(N,)C,2], found [(N,)C].

    ``use_pallas`` is kept for islx's signature: labelling goes through
    ``label_components`` either way (the CUDA kernel on the card, its plain
    version on the CPU), :func:`crops_per_call` crops' planes a call (one
    call at N=8, 368 px: 0.48-0.51 ms on an H100 against 0.96-0.99 ms for
    8 calls, PERF.md §6); the labels do not depend on it."""
    del use_pallas
    lead = heatmap.shape[:-3]
    h, w, c = heatmap.shape[-3:]
    hm = heatmap.reshape((-1, h, w, c))
    n = hm.shape[0]
    blurred = gaussian_blur(hm, sigma)
    binary = blurred > float(np.float32(thre))                # [N,H,W,C]
    per_call = crops_per_call(h, w, c, n)
    planes = binary.permute(1, 2, 0, 3).reshape(h, w, n * c)
    labels = torch.cat([label_components(
        planes[..., i * c:(i + per_call) * c].contiguous())
        for i in range(0, n, per_call)], -1)                  # [H,W,N*C]
    peak, found = _one_part(
        hm.float().permute(0, 3, 1, 2).reshape(n * c, -1),
        binary.permute(0, 3, 1, 2).reshape(n * c, -1),
        labels.permute(2, 0, 1).reshape(n * c, -1))
    xy = torch.stack([peak % w, peak // w], dim=-1).to(torch.int32)
    xy = torch.where(found[:, None], xy, torch.zeros_like(xy))
    return HandPeaks(xy=xy.reshape(lead + (c, 2)),
                     found=found.reshape(lead + (c,)))


def find_hand_peaks_fast(heatmap: torch.Tensor, thre: float = 0.05,
                         sigma: float = 3.0) -> HandPeaks:
    """heatmap [...,H,W,C] -> HandPeaks [...,C]: the first row-major
    maximum of the map where its blur is above ``thre``
    (islx/ops/hand_peaks.py:175)."""
    h, w, c = heatmap.shape[-3:]
    hm = heatmap.float()
    blurred = gaussian_blur(hm, sigma)
    mask = blurred > float(np.float32(thre))
    found = mask.any(dim=-2).any(dim=-2)                       # [...,C]
    flat = torch.where(mask, hm, torch.full_like(hm, -float("inf")))
    flat = flat.movedim(-1, -3).reshape(heatmap.shape[:-3] + (c, h * w))
    peak = torch.argmax(flat, dim=-1)          # first max, as jnp.argmax
    xy = torch.stack([peak % w, peak // w], dim=-1).to(torch.int32)
    xy = torch.where(found[..., None], xy, torch.zeros_like(xy))
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
