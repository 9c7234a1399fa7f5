"""Per-frame ISL translation on the reference-parity pose path (port of
islx/isl/translator.py; reference ISLSignPos / ISLSignPosTranslator,
src/ISL_Model_parameter.py:41-60,308-353).

``ISLSignPos`` is the body + hand composite. ``ISLTranslator`` keeps each
frame's 156-d features in a rolling window, so a new frame costs one pose
pass and one head pass, where the reference re-runs pose on all 20 window
frames for every prediction; the outputs are the same.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from islx_torch.core.config import TranslatorConfig
from islx_torch.isl import features as F
from islx_torch.isl.expressions import EXPRESSIONS
from islx_torch.models import translator as T
from islx_torch.pose.body import Body
from islx_torch.pose.detector import hand_detect
from islx_torch.pose.hand import Hand


class ISLSignPos:
    """frame -> (candidate, subset, all_hand_peaks)."""

    def __init__(self, body: Body, hand: Hand):
        self.body = body
        self.hand = hand

    def __call__(self, frame: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        candidate, subset = self.body(frame)
        all_hand_peaks = []
        for x, y, w, _is_left in hand_detect(candidate, subset, frame.shape):
            peaks = self.hand(frame[y:y + w, x:x + w, :]).astype(np.int64)
            # re-offset crop coords into full-image space, keeping the (0,0)
            # missing sentinel (reference demo.py:36-37)
            peaks[:, 0] = np.where(peaks[:, 0] == 0, peaks[:, 0],
                                   peaks[:, 0] + x)
            peaks[:, 1] = np.where(peaks[:, 1] == 0, peaks[:, 1],
                                   peaks[:, 1] + y)
            all_hand_peaks.append(peaks)
        return candidate, subset, all_hand_peaks


class ISLTranslator:
    """Rolling-window sign translator with a per-frame feature cache; the
    head runs on the body estimator's device."""

    def __init__(self, body: Body, hand: Hand,
                 head_params: Optional[T.Params] = None,
                 cfg: TranslatorConfig = TranslatorConfig()):
        self.pose = ISLSignPos(body, hand)
        self.cfg = cfg
        self.model_type = body.model_type
        self.device = body.device
        self.head = T.build_head(head_params, self.device, cfg)
        self._window: List[np.ndarray] = []

    # ----- streaming API -----

    def frame_features(self, frame: np.ndarray) -> np.ndarray:
        candidate, subset, all_hand_peaks = self.pose(frame)
        return F.frame_features(candidate, subset, all_hand_peaks,
                                self.model_type)

    def push(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """Add one frame; [167] probabilities once the window is full (the
        reference predicts on full windows only,
        demo_isl_translate.py:183-193), else None."""
        self._window.append(self.frame_features(frame))
        if len(self._window) > self.cfg.window_size:
            self._window.pop(0)
        if len(self._window) < self.cfg.window_size:
            return None
        return self.predict_from_features(np.stack(self._window))

    def reset(self) -> None:
        self._window.clear()

    # ----- window API (the reference's ISLSignPosTranslator.call) -----

    @torch.inference_mode()
    def predict_from_features(self, feats: np.ndarray) -> np.ndarray:
        """feats [T<=20,156] -> probabilities [167]; a short window is
        zero-padded at the end (reference src/ISL_Model_parameter.py:344-346)."""
        t = feats.shape[0]
        if t < self.cfg.window_size:
            pad = np.zeros((self.cfg.window_size - t, self.cfg.feature_dim))
            feats = np.concatenate([feats, pad], axis=0)
        x = torch.from_numpy(np.asarray(feats[None], np.float32))
        return self.head(x.to(self.device)).cpu().numpy()[0]

    def __call__(self, window: np.ndarray) -> np.ndarray:
        """window [T,H,W,3] u8 -> probabilities [1,167] (reference
        contract, src/ISL_Model_parameter.py:322-353)."""
        feats = np.stack([self.frame_features(f) for f in window])
        return self.predict_from_features(feats)[None]

    # ----- convenience -----

    def top_expression(self, probs: np.ndarray) -> Tuple[int, str, float]:
        idx = int(np.argmax(probs))
        return idx, EXPRESSIONS[idx], float(probs[idx])

    def translate_video_frames(self, frames: Sequence[np.ndarray]
                               ) -> List[Tuple[int, int, str, float]]:
        """-> [(frame_idx, class_id, expression, prob)] for each full
        window (the demo loop, demo_isl_translate.py:171-197)."""
        self.reset()
        out = []
        for idx, frame in enumerate(frames):
            probs = self.push(frame)
            if probs is not None:
                cid, expr, p = self.top_expression(probs)
                out.append((idx, cid, expr, p))
        return out
