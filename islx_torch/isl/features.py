"""Pose -> ISL feature vectors (numpy copy of the parts of
islx/isl/features.py that ``frame_features`` uses).

Re-implements the reference's feature serialization chain —
``util.get_bodypose`` (src/util.py:99-151), ``util.get_handpose``
(src/util.py:187-219) and ``ISLSignPosTranslator.populate_features``
(src/ISL_Model_parameter.py:376-443) — as small pure functions producing the
exact 156-dim per-frame vector the BiLSTM head consumes:

    [15 body x | 15 body y | hand0: 21 x, 21 y, 21 part-idx |
     hand1: 21 x, 21 y, 21 part-idx]

Body entries enumerate (joint-major, then person) the detected keypoints and
truncate/zero-pad to 15; hand part-idx columns are the stringified indices the
reference round-trips through str() (src/ISL_Model_parameter.py:410). The
reference's limb sticks and hand edges feed only its drawing, so they are
not computed here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

FEATURE_DIM = 156


def body_circles(candidate: np.ndarray, subset: np.ndarray,
                 model_type: str = "body25") -> List[Tuple[float, float]]:
    """Detected keypoints (x, y), joints-major then person (reference
    src/util.py:122-129)."""
    njoint = 25 if model_type == "body25" else 18
    circles = []
    for i in range(njoint):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            circles.append((float(x), float(y)))
    return circles


def hand_peaks(all_hand_peaks: Sequence[np.ndarray]) -> List[list]:
    """-> peaks[2], peaks[h] = [(x, y, str(i)) x21] for up to two hands
    (reference src/util.py:200-219). The reference indexes fixed two-hand
    lists and crashes on a third hand; we take the first two."""
    export_peaks: List[list] = [[], []]
    for idx, peaks in enumerate(all_hand_peaks[:2]):
        for i, (x, y) in enumerate(np.asarray(peaks)):
            export_peaks[idx].append((x, y, str(i)))
    return export_peaks


def populate_features(bodypose_circles: Sequence[Tuple[float, float]],
                      handpose_peaks: Sequence[list]) -> np.ndarray:
    """-> float64 [156] (reference src/ISL_Model_parameter.py:376-443)."""
    feature: List[float] = []
    for idx in range(15):
        feature.append(bodypose_circles[idx][0] if idx < len(bodypose_circles)
                       else 0.0)
    for idx in range(15):
        feature.append(bodypose_circles[idx][1] if idx < len(bodypose_circles)
                       else 0.0)
    for hand_idx in range(2):
        peaks = handpose_peaks[hand_idx]
        for col in range(3):
            for idx in range(21):
                feature.append(float(peaks[idx][col]) if idx < len(peaks)
                               else 0.0)
    return np.asarray(feature, dtype=np.float64)


def frame_features(candidate: np.ndarray, subset: np.ndarray,
                   all_hand_peaks: Sequence[np.ndarray],
                   model_type: str = "body25") -> np.ndarray:
    """Full per-frame featurizer: pose tables -> [156] vector."""
    return populate_features(body_circles(candidate, subset, model_type),
                             hand_peaks(all_hand_peaks))
