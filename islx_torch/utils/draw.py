"""Skeleton rendering (port of islx/utils/draw.py): body keypoints and
limbs (``draw_bodypose``, reference src/util.py:47-96), hand skeletons
(``draw_handpose``, :154-185, drawn with cv2 into the frame as islx does
instead of the reference's matplotlib figure), the stick model of the
feature geometry (``draw_stick_model``, drawStickmodel :308-366) and the
tight crop around a drawing (``crop_to_drawing``).

It draws with cv2 primitives, so it runs where cv2 is installed (the CPU
hosts that decode clips); cv2 is imported at the first call.
"""
from __future__ import annotations

import colorsys
import copy
import math
from typing import Sequence, Tuple

import numpy as np

from islx_torch.isl.features import HAND_EDGES
from islx_torch.ops.paf import LIMB_SEQ_BODY25, LIMB_SEQ_COCO

# joint colors (reference src/util.py:64-67)
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85], [255, 255, 0], [255, 255, 85],
          [255, 255, 170], [255, 255, 255], [170, 255, 255], [85, 255, 255],
          [0, 255, 255]]

STICK_WIDTH = 4


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray,
                  subset: np.ndarray, model_type: str = "body25"
                  ) -> np.ndarray:
    """A copy of ``canvas`` with each person's joints as coloured circles
    and limbs as ellipses blended 0.6/0.4."""
    import cv2

    limb_seq = LIMB_SEQ_BODY25 if model_type == "body25" else LIMB_SEQ_COCO
    njoint = 25 if model_type == "body25" else 18
    canvas = canvas.copy()
    for i in range(njoint):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            cv2.circle(canvas, (int(x), int(y)), 4, COLORS[i], thickness=-1)
    for i in range(njoint - 1):
        for n in range(len(subset)):
            index = subset[n][np.array(limb_seq[i])]
            if -1 in index:
                continue
            cur = canvas.copy()
            ys = candidate[index.astype(int), 1]
            xs = candidate[index.astype(int), 0]
            m_x, m_y = float(np.mean(xs)), float(np.mean(ys))
            length = math.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            poly = cv2.ellipse2Poly((int(m_x), int(m_y)),
                                    (int(length / 2), STICK_WIDTH),
                                    int(angle), 0, 360, 1)
            cv2.fillConvexPoly(cur, poly, COLORS[i])
            canvas = cv2.addWeighted(canvas, 0.4, cur, 0.6, 0)
    return canvas


def _hsv_color(i: int, n: int) -> Tuple[int, int, int]:
    r, g, b = colorsys.hsv_to_rgb(i / float(n), 1.0, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def draw_handpose(canvas: np.ndarray, all_hand_peaks: Sequence[np.ndarray],
                  show_number: bool = False) -> np.ndarray:
    """A copy of ``canvas`` with each hand's edges (hsv colours) and
    keypoints ((0, 0) = missing, not drawn)."""
    import cv2

    canvas = canvas.copy()
    for peaks in all_hand_peaks:
        peaks = np.asarray(peaks)
        for ie, e in enumerate(HAND_EDGES):
            if np.sum(np.all(peaks[e], axis=1) == 0) == 0:
                x1, y1 = peaks[e[0]]
                x2, y2 = peaks[e[1]]
                cv2.line(canvas, (int(x1), int(y1)), (int(x2), int(y2)),
                         _hsv_color(ie, len(HAND_EDGES)), thickness=2)
        for i, (x, y) in enumerate(peaks):
            if x == 0 and y == 0:
                continue
            cv2.circle(canvas, (int(x), int(y)), 3, (0, 0, 255), thickness=-1)
            if show_number:
                cv2.putText(canvas, str(i), (int(x), int(y)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.3, (0, 0, 0),
                            lineType=cv2.LINE_AA)
    return canvas


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


def crop_to_drawing(image: np.ndarray) -> np.ndarray:
    """The tight bounding box of the non-zero pixels over all channels
    (the intent of the reference's crop_to_drawing, src/util.py:368-391,
    as islx implements it)."""
    import cv2

    mask = np.any(image != 0, axis=2).astype(np.uint8)
    x, y, w, h = cv2.boundingRect(mask)
    return image[y:y + h, x:x + w]
