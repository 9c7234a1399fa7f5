"""Hand pose estimator with the reference's API (port of islx/pose/hand.py).

``Hand(weights)(crop)`` returns 21 ``(x, y)`` keypoints with ``(0, 0)`` for
missing parts, as the reference does (src/hand.py:24-74). On the device: the
scale pyramid, CPM forward, heatmap averaging and the per-part
connected-component peaks (the ``cc_label`` CUDA kernel).

Each stage of a call runs inside a ``torch.profiler.record_function`` range
(``hand_resize``, ``hand_cpm``, ``hand_maps``, ``hand_peaks``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig
from islx_torch.core.runtime import div, resolve_device, true_f32
from islx_torch.ops.hand_peaks import find_hand_peaks
from islx_torch.ops.preprocess import pad_normalize
from islx_torch.ops.resize import output_size, resize_cubic


def _hand_heatmap(forward, img: torch.Tensor, cfg: HandConfig,
                  compute_dtype) -> torch.Tensor:
    """img [H,W,3] on the device -> averaged heatmap [H,W,22] f32
    (src/hand.py:35-56); ``forward(x, compute_dtype)`` -> heat at /8."""
    h, w = img.shape[0], img.shape[1]
    heat_sum = torch.zeros((h, w, 22), device=img.device)
    n = len(cfg.scale_search)
    for s in cfg.scale_search:
        scale = s * cfg.boxsize / h
        hs, ws = output_size(h, scale), output_size(w, scale)
        with record_function("hand_resize"):
            scaled = resize_cubic(img, hs, ws, saturate_uint8=True)
            x, (pd, pr) = pad_normalize(scaled, cfg.stride, cfg.pad_value)
        with record_function("hand_cpm"):
            heat = forward(x, compute_dtype)
        hp, wp = x.shape[1], x.shape[2]
        with record_function("hand_maps"):
            m = resize_cubic(heat[0], hp, wp)
            m = m[:hp - pd, :wp - pr]
            m = resize_cubic(m, h, w)
            heat_sum = heat_sum + div(m, n)   # correct mean (src/hand.py:56)
    return heat_sum


class Hand:
    """Reference-compatible hand estimator (drop-in for src/hand.py:15).

    weights: a port weight state, a checkpoint path, or None for the seeded
    random init. ``forward_fn(weights, x, compute_dtype) -> heat`` replaces
    the CPM (a test hook). ``device`` defaults to CUDA and raises without a
    GPU unless ``"cpu"`` is asked for."""

    def __init__(self, weights: Union[str, W.State, None] = None,
                 config: Optional[HandConfig] = None,
                 compute_dtype=torch.float32, forward_fn=None, device=None):
        self.cfg = config or HandConfig()
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        if forward_fn is not None:
            self._forward = lambda x, cd: forward_fn(weights, x, cd)
            return
        if weights is None:
            weights = W.init_params("hand")
        elif isinstance(weights, str):
            weights = W.load(weights, "hand")
        net = W.build("hand", weights, self.device, compute_dtype)
        self._forward = lambda x, cd: net(x, cd, self.cfg.stages)

    def _heatmap(self, crop: np.ndarray) -> torch.Tensor:
        img = torch.from_numpy(np.ascontiguousarray(crop)).to(self.device)
        return _hand_heatmap(self._forward, img, self.cfg, self.compute_dtype)

    @torch.inference_mode()
    def heatmap(self, crop: np.ndarray) -> np.ndarray:
        """Averaged [H,W,22] heatmap as numpy."""
        return self._heatmap(crop).cpu().numpy()

    @torch.inference_mode()
    def __call__(self, crop: np.ndarray) -> np.ndarray:
        """BGR u8 [H,W,3] crop -> peaks [21,2] int32 (x, y); (0,0) =
        missing."""
        with true_f32():
            heat = self._heatmap(crop)
            with record_function("hand_peaks"):
                pk = find_hand_peaks(heat[:, :, :self.cfg.n_parts],
                                     self.cfg.thre)
        return pk.xy.cpu().numpy()
