"""Stick-figure rendering for ``--sticks`` extraction (port of
``draw_stick_model`` in islx/utils/draw.py; reference drawStickmodel,
src/util.py:308-366).

It draws with cv2 primitives, so it runs where cv2 is installed (the CPU
hosts that decode clips); cv2 is imported at the first call.
"""
from __future__ import annotations

import colorsys
import copy
from typing import Sequence, Tuple

import numpy as np

from islx_torch.isl.features import HAND_EDGES

# joint colors (reference src/util.py:64-67)
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85], [255, 255, 0], [255, 255, 85],
          [255, 255, 170], [255, 255, 255], [170, 255, 255], [85, 255, 255],
          [0, 255, 255]]

STICK_WIDTH = 4


def _hsv_color(i: int, n: int) -> Tuple[int, int, int]:
    r, g, b = colorsys.hsv_to_rgb(i / float(n), 1.0, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def draw_stick_model(ori_img: np.ndarray,
                     circles: Sequence[Tuple[float, float]],
                     sticks: Sequence[Tuple[float, float, float, float]],
                     hand_edges: Sequence[list],
                     hand_peaks: Sequence[list]) -> np.ndarray:
    """The frame with the feature geometry of
    :func:`islx_torch.isl.features.get_bodypose` / ``get_handpose`` drawn
    on it: limbs as ellipses blended 0.6/0.4, joints, hand edges and hand
    keypoints."""
    import cv2

    canvas = copy.deepcopy(ori_img)
    for idx, (m_x, m_y, angle, length) in enumerate(sticks):
        cur = canvas.copy()
        poly = cv2.ellipse2Poly((int(m_x), int(m_y)),
                                (int(length / 2), STICK_WIDTH),
                                int(angle), 0, 360, 1)
        cv2.fillConvexPoly(cur, poly, COLORS[idx % len(COLORS)])
        canvas = cv2.addWeighted(canvas, 0.4, cur, 0.6, 0)
    for idx, (x, y) in enumerate(circles):
        cv2.circle(canvas, (int(x), int(y)), 4, COLORS[idx % len(COLORS)],
                   thickness=-1)
    for hand in hand_edges:
        for (ie, (x1, y1), (x2, y2)) in hand:
            cv2.line(canvas, (int(x1), int(y1)), (int(x2), int(y2)),
                     _hsv_color(ie, len(HAND_EDGES)), thickness=2)
    for hand in hand_peaks:
        for (x, y, _txt) in hand:
            if x == 0 and y == 0:
                continue
            cv2.circle(canvas, (int(x), int(y)), 3, (0, 0, 255), thickness=-1)
    return canvas
