"""Hand-box detector from body keypoints (port of islx/pose/detector.py).

Same geometry as the reference (src/util.py:242-306, itself modelled on CMU
OpenPose handDetector.cpp): hand centre extrapolated from wrist along the
elbow->wrist direction, square box sized from arm segment lengths, clamped to
the image and discarded under 20 px. Pure numpy on the tiny (candidate,
subset) tables.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from islx_torch.core.config import DetectorConfig

_CFG = DetectorConfig()


def hand_detect(candidate: np.ndarray, subset: np.ndarray,
                image_shape: Tuple[int, ...],
                cfg: DetectorConfig = _CFG) -> List[List]:
    """-> [[x, y, w, is_left], ...] square crops (top-left corner + side)."""
    image_height, image_width = image_shape[0], image_shape[1]
    result: List[List] = []
    for person in subset.astype(int):
        # joints: right arm (shoulder 2, elbow 3, wrist 4),
        #         left arm  (shoulder 5, elbow 6, wrist 7)
        arms = []
        if not np.any(person[[5, 6, 7]] == -1):
            s, e, wr = person[[5, 6, 7]]
            arms.append((candidate[s][:2], candidate[e][:2],
                         candidate[wr][:2], True))
        if not np.any(person[[2, 3, 4]] == -1):
            s, e, wr = person[[2, 3, 4]]
            arms.append((candidate[s][:2], candidate[e][:2],
                         candidate[wr][:2], False))
        for (x1, y1), (x2, y2), (x3, y3), is_left in arms:
            x = x3 + cfg.ratio_wrist_elbow * (x3 - x2)
            y = y3 + cfg.ratio_wrist_elbow * (y3 - y2)
            d_we = math.hypot(x3 - x2, y3 - y2)
            d_es = math.hypot(x2 - x1, y2 - y1)
            width = cfg.width_scale * max(d_we, cfg.shoulder_ratio * d_es)
            x -= width / 2
            y -= width / 2
            x = max(x, 0.0)
            y = max(y, 0.0)
            width = min(width,
                        image_width - x if x + width > image_width else width,
                        image_height - y if y + width > image_height else width)
            if width >= cfg.min_box:
                result.append([int(x), int(y), int(width), is_left])
    return result
