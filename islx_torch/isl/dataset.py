"""Extraction records -> training tables and windows (port of
``islx/isl/dataset.py``).

Walks an extraction output tree (``<root>/<video_id>/<frame>.json``, as
:mod:`islx_torch.isl.extract` writes it), re-derives each frame's geometry
from its record, explodes it into flat named columns (``bodypeaks_x_i``,
``bodyedges_angle_i``, ``hand{0,1}peaks_*``, reference
json_to_pandas.py:129-150), tracks per-video completion in STATUS.csv
(json_to_pandas.py:50-92) and builds fixed-size training windows
([N, 20, 156] and label ids) for :mod:`islx_torch.isl.train`.

islx returns pandas DataFrames; the card's machine has no pandas, so
:func:`build_table` and :func:`build_status` return ``(columns, rows)`` and
write the bytes ``DataFrame(rows).to_csv(index=False)`` writes, through
:func:`islx_torch.isl.extract._write_csv` (columns in first-seen order: the
hand-edge columns exist only for edges that were found).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from islx_torch.core.config import TranslatorConfig
from islx_torch.isl import features as F
from islx_torch.isl.expressions import EXPRESSIONS
from islx_torch.isl.extract import _write_csv

Table = Tuple[List[str], List[Dict]]


def _pose_tables(record: Dict):
    candidate = np.asarray(record["candidate"], dtype=float).reshape(-1, 4) \
        if record["candidate"] else np.zeros((0, 4))
    subset = np.asarray(record["subset"], dtype=float)
    if subset.size == 0:
        subset = np.zeros((0, 27))
    hands = [np.asarray(p) for p in record.get("all_hand_peaks", [])]
    return candidate, subset, hands


def explode_record(record: Dict, model_type: str = "body25"
                   ) -> Dict[str, float]:
    """One frame JSON record -> flat named feature columns (schema of
    json_to_pandas.py:129-150)."""
    candidate, subset, hands = _pose_tables(record)
    circles, sticks = F.get_bodypose(candidate, subset, model_type)
    edges, peaks = F.get_handpose(hands)

    row: Dict[str, float] = {}
    for i in range(15):
        row[f"bodypeaks_x_{i}"] = circles[i][0] if i < len(circles) else 0.0
        row[f"bodypeaks_y_{i}"] = circles[i][1] if i < len(circles) else 0.0
    for i in range(15):
        mx, my, angle, length = sticks[i] if i < len(sticks) else (0.0,) * 4
        row[f"bodyedges_mx_{i}"] = mx
        row[f"bodyedges_my_{i}"] = my
        row[f"bodyedges_angle_{i}"] = angle
        row[f"bodyedges_length_{i}"] = length
    for h in range(2):
        for i in range(21):
            has = i < len(peaks[h])
            row[f"hand{h}peaks_x_{i}"] = float(peaks[h][i][0]) if has else 0.0
            row[f"hand{h}peaks_y_{i}"] = float(peaks[h][i][1]) if has else 0.0
        for (ie, (x1, y1), (x2, y2)) in edges[h]:
            row[f"hand{h}edge_x1_{ie}"] = float(x1)
            row[f"hand{h}edge_y1_{ie}"] = float(y1)
            row[f"hand{h}edge_x2_{ie}"] = float(x2)
            row[f"hand{h}edge_y2_{ie}"] = float(y2)
    return row


def runtime_features(record: Dict, model_type: str = "body25") -> np.ndarray:
    """One frame JSON record -> the 156-dim runtime feature vector."""
    return F.frame_features(*_pose_tables(record), model_type)


def _video_dirs(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def build_status(root: str, total_frames: Optional[Dict[str, int]] = None
                 ) -> Table:
    """STATUS.csv: per-video processed counts and %complete
    (json_to_pandas.py:50-92)."""
    rows = []
    for vid in _video_dirs(root):
        d = os.path.join(root, vid)
        n = len([f for f in os.listdir(d) if f.endswith(".json")])
        total = (total_frames or {}).get(vid, n)
        rows.append({"video": vid, "processed": n, "total": total,
                     "pct_complete": 100.0 * n / max(total, 1),
                     "status": "done" if n >= total else "partial"})
    return _write_csv(os.path.join(root, "STATUS.csv"), rows), rows


def build_table(root: str, model_type: str = "body25") -> Table:
    """Every per-frame JSON record -> data.csv (json_to_pandas.py:158-189).
    Unparseable records are skipped, not fatal (json_to_pandas.py:153-155).
    """
    rows = []
    for vid in _video_dirs(root):
        d = os.path.join(root, vid)
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, fname)) as f:
                    row = explode_record(json.load(f), model_type)
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
            row["video"] = vid
            row["frame"] = int(fname.split(".")[0])
            rows.append(row)
    return _write_csv(os.path.join(root, "data.csv"), rows), rows


_NAME_TO_ID = {v.lower(): k for k, v in EXPRESSIONS.items()}


def expression_id(name: str) -> Optional[int]:
    return _NAME_TO_ID.get(str(name).lower())


def build_windows(root: str, labels: Dict[str, str],
                  cfg: TranslatorConfig = TranslatorConfig(),
                  model_type: str = "body25"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-video frame records -> training windows.

    labels: {video_id: expression name}; a video with no known label is
    left out. Returns (x [N,20,156] f32, y [N] i32), the last window of a
    video zero-padded (the translator masks padding)."""
    xs, ys = [], []
    for vid in _video_dirs(root):
        label = expression_id(labels.get(vid, ""))
        if label is None:
            continue
        d = os.path.join(root, vid)
        feats = []
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, fname)) as f:
                    feats.append(runtime_features(json.load(f), model_type))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
        if not feats:
            continue
        arr = np.stack(feats)
        for start in range(0, len(arr), cfg.window_size):
            win = arr[start:start + cfg.window_size]
            if win.shape[0] < cfg.window_size:
                pad = np.zeros((cfg.window_size - win.shape[0],
                                cfg.feature_dim))
                win = np.concatenate([win, pad], 0)
            xs.append(win.astype(np.float32))
            ys.append(label)
    if not xs:
        return (np.zeros((0, cfg.window_size, cfg.feature_dim), np.float32),
                np.zeros((0,), np.int32))
    return np.stack(xs), np.asarray(ys, np.int32)
