"""Pose -> ISL feature vectors (numpy copy of islx/isl/features.py).

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
limb sticks and hand edges of :func:`get_bodypose` / :func:`get_handpose`
feed only the stick-figure drawing (:mod:`islx_torch.utils.draw`).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from islx_torch.ops.paf import LIMB_SEQ_BODY25, LIMB_SEQ_COCO

FEATURE_DIM = 156

HAND_EDGES = [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
              [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
              [15, 16], [0, 17], [17, 18], [18, 19], [19, 20]]


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


def body_sticks(candidate: np.ndarray, subset: np.ndarray,
                model_type: str = "body25"
                ) -> List[Tuple[float, float, float, float]]:
    """Limbs (mean_x, mean_y, angle_deg, length), limbs-major then person
    (reference src/util.py:130-148)."""
    limb_seq = LIMB_SEQ_BODY25 if model_type == "body25" else LIMB_SEQ_COCO
    njoint = 25 if model_type == "body25" else 18
    sticks = []
    for i in range(njoint - 1):
        for n in range(len(subset)):
            index = subset[n][np.array(limb_seq[i])]
            if -1 in index:
                continue
            xs = candidate[index.astype(int), 0]
            ys = candidate[index.astype(int), 1]
            length = float(math.hypot(xs[0] - xs[1], ys[0] - ys[1]))
            angle = float(math.degrees(math.atan2(ys[0] - ys[1],
                                                  xs[0] - xs[1])))
            sticks.append((float(np.mean(xs)), float(np.mean(ys)), angle,
                           length))
    return sticks


def get_bodypose(candidate: np.ndarray, subset: np.ndarray,
                 model_type: str = "body25"):
    """-> (circles, sticks): :func:`body_circles` and :func:`body_sticks`
    (reference src/util.py:99-151)."""
    return (body_circles(candidate, subset, model_type),
            body_sticks(candidate, subset, model_type))


def hand_edges(all_hand_peaks: Sequence[np.ndarray]) -> List[list]:
    """-> edges[2], edges[h] = [(edge_idx, (x1, y1), (x2, y2))] for the
    edges of the first two hands whose endpoints are both detected
    (reference src/util.py:200-214)."""
    export_edges: List[list] = [[], []]
    for idx, peaks in enumerate(all_hand_peaks[:2]):
        peaks = np.asarray(peaks)
        for ie, e in enumerate(HAND_EDGES):
            if np.sum(np.all(peaks[e], axis=1) == 0) == 0:
                x1, y1 = peaks[e[0]]
                x2, y2 = peaks[e[1]]
                export_edges[idx].append((ie, (x1, y1), (x2, y2)))
    return export_edges


def get_handpose(all_hand_peaks: Sequence[np.ndarray]):
    """-> (edges, peaks): :func:`hand_edges` and :func:`hand_peaks`
    (reference src/util.py:187-219)."""
    return hand_edges(all_hand_peaks), hand_peaks(all_hand_peaks)


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
