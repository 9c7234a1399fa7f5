"""Body pose estimator with the reference's API (port of islx/pose/body.py).

``Body(weights, model_type)(oriImg)`` returns ``(candidate[N,4], subset[P,
njoint+2])`` as the reference does (src/body.py:39,233-235). On the device:
the multi-scale resize, stride-pad, normalize, CPM forward, x8 cubic
upsample, de-pad, back-to-original resize, scale averaging, gaussian NMS
with first-K selection (the ``nms_first_k`` CUDA kernel) and the exact PAF
line integrals (the ``paf_sample`` CUDA kernel). The greedy person grouping
runs on the host (:mod:`islx_torch.ops.grouping`).

Each stage of a call runs inside a ``torch.profiler.record_function`` range
named after it (``body_resize``, ``body_cpm``, ``body_maps``, ``body_peaks``,
``paf_limbs``, ``grouping``), so a profile splits the call's device time by
stage (``chip_smoke.py --profile``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from islx_torch.core import weights as W
from islx_torch.core.config import PoseConfig
from islx_torch.core.runtime import div, resolve_device, true_f32
from islx_torch.ops import grouping
from islx_torch.ops.paf import LIMB_TABLES, LimbScores, score_limbs
from islx_torch.ops.paf_sample import LimbTable
from islx_torch.ops.peaks import Peaks, find_peaks
from islx_torch.ops.preprocess import pad_normalize
from islx_torch.ops.resize import output_size, resize_cubic


def _compute_maps(forward, img: torch.Tensor, cfg: PoseConfig,
                  compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """img [H,W,3] on the device -> (heat_avg [H,W,njoint], paf_avg
    [H,W,npaf]) f32; ``forward(x, compute_dtype)`` -> (paf, heat) at /8."""
    h, w = img.shape[0], img.shape[1]
    heat_sum = torch.zeros((h, w, cfg.njoint), device=img.device)
    paf_sum = torch.zeros((h, w, cfg.npaf), device=img.device)
    n = len(cfg.scale_search)
    for s in cfg.scale_search:
        scale = s * cfg.boxsize / h
        hs, ws = output_size(h, scale), output_size(w, scale)
        with record_function("body_resize"):
            scaled = resize_cubic(img, hs, ws, saturate_uint8=True)
            x, (pd, pr) = pad_normalize(scaled, cfg.stride, cfg.pad_value)
        with record_function("body_cpm"):
            paf, heat = forward(x, compute_dtype)
        hp, wp = x.shape[1], x.shape[2]

        def to_orig(maps):  # [1,h8,w8,C] -> [H,W,C] (src/body.py:69-78)
            m = resize_cubic(maps[0], hp, wp)         # x8 cubic upsample
            m = m[:hp - pd, :wp - pr]                  # remove stride pad
            return resize_cubic(m, h, w)               # back to original

        with record_function("body_maps"):
            heat_o, paf_o = to_orig(heat), to_orig(paf)
            if cfg.ref_compat_averaging:
                # reference bug (src/body.py:80): avg += avg + heat/n
                heat_sum = heat_sum + heat_sum + div(heat_o, n)
            else:
                heat_sum = heat_sum + div(heat_o, n)
            paf_sum = paf_sum + div(paf_o, n)
    return heat_sum, paf_sum


class Body:
    """Reference-compatible body estimator (drop-in for src/body.py:15).

    weights: a port weight state (:mod:`islx_torch.core.weights`), a
    checkpoint path (``weights.load``), or None for the seeded random init.
    ``forward_fn(weights, x, compute_dtype) -> (paf, heat)`` replaces the
    CPM (a test hook). ``device`` defaults to CUDA and raises without a GPU
    unless ``"cpu"`` is asked for."""

    def __init__(self, weights: Union[str, W.State, None] = None,
                 model_type: str = "body25",
                 config: Optional[PoseConfig] = None,
                 compute_dtype=torch.float32, forward_fn=None, device=None):
        if model_type not in ("body25", "coco"):
            model_type = "coco"  # reference fallback (src/body.py:25-29)
        self.model_type = model_type
        self.cfg = config or PoseConfig(model_type=model_type)
        if self.cfg.model_type != model_type:
            self.cfg = dataclasses.replace(self.cfg, model_type=model_type)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.limb_seq, self.map_idx = LIMB_TABLES[model_type]
        self.limbs = LimbTable(self.limb_seq, self.map_idx)
        if forward_fn is not None:
            self._forward = lambda x, cd: forward_fn(weights, x, cd)
            return
        if weights is None:
            weights = W.init_params(model_type)
        elif isinstance(weights, str):
            weights = W.load(weights, model_type)
        self._forward = W.build(model_type, weights, self.device,
                                compute_dtype)

    def _maps(self, ori_img: np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(ori_img)).to(self.device)
        return _compute_maps(self._forward, img, self.cfg, self.compute_dtype)

    @torch.inference_mode()
    def maps(self, ori_img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(heatmap_avg [H,W,njoint], paf_avg [H,W,npaf]) as numpy."""
        heat, paf = self._maps(ori_img)
        return heat.cpu().numpy(), paf.cpu().numpy()

    @torch.inference_mode()
    def peaks_and_limbs(self, ori_img: np.ndarray
                        ) -> Tuple[Peaks, LimbScores]:
        """BGR u8 [H,W,3] -> the device tables the grouping reads."""
        cfg = self.cfg
        with true_f32():
            heat, paf = self._maps(ori_img)
            with record_function("body_peaks"):
                pk = find_peaks(heat[:, :, :cfg.njoint - 1], cfg.thre1,
                                cfg.max_peaks)
            with record_function("paf_limbs"):
                ls = score_limbs(paf, pk.xy, pk.valid, self.limbs, cfg.thre2,
                                 cfg.mid_num, orig_h=float(ori_img.shape[0]))
        return pk, ls

    def __call__(self, ori_img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """BGR u8 [H,W,3] -> (candidate[N,4], subset[P,njoint+2])."""
        pk, ls = self.peaks_and_limbs(ori_img)
        with record_function("grouping"):
            return grouping.assemble(
                pk.xy.cpu().numpy(), pk.score.cpu().numpy(),
                pk.count.cpu().numpy(), ls.score.cpu().numpy(),
                ls.ok.cpu().numpy(), self.limb_seq, self.cfg.njoint)
