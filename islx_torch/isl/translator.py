"""Body + hand composite (port of islx/isl/translator.py ``ISLSignPos``;
reference src/ISL_Model_parameter.py:51-60)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

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
