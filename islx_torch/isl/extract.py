"""Dataset feature extraction: the offline training-data build (port of
islx/isl/extract.py; reference extract_features.py, extract_features_mp.py,
extract_featuressingle.py).

One sharded, idempotent, resumable pipeline:

* per frame: pose -> features -> a JSON record {candidate, subset,
  all_hand_peaks} and, optionally, a stick-figure JPG (reference
  extract_features.py:105-141);
* resume by output-file existence (reference extract_features.py:97-101);
* sharding: a deterministic row partition over (shard_index, num_shards),
  one process per card or host;
* per video: the rows of features, with the video's extraction seconds on
  its last row, written to ``features-shard{i}.csv``.

Two pose back ends: a per-frame callable (``ISLSignPos``, the exact path)
through :func:`extract_video`, or a ``FusedPosePipeline`` stepping
``batch`` frames at a time through :func:`extract_video_batched`. The JSON
records, the JPGs and the CSV are byte for byte what islx writes for the
same poses. The shard CSV is read and written with the ``csv`` module
(:func:`_read_csv`, :func:`_write_csv`), following the types pandas infers
and writes for islx.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from islx_torch.isl import features as F


@dataclass
class ExtractConfig:
    out_root: str
    write_json: bool = True
    write_sticks: bool = False
    window_size: int = 20
    # per-frame augmentation (reference extract_featuressingle.py:49-52:
    # RandomRotation + RandomSolarize); deterministic per (video, frame) so
    # reruns stay idempotent
    augment: bool = False
    augment_degrees: float = 10.0
    solarize_threshold: float = 192.0


def _frame_paths(cfg: ExtractConfig, video_id: str, idx: int):
    d = os.path.join(cfg.out_root, video_id)
    return (os.path.join(d, f"{idx:06d}.json"),
            os.path.join(d, f"{idx:06d}.jpg"))


def is_processed(cfg: ExtractConfig, video_id: str, idx: int) -> bool:
    """Per-frame idempotency marker (reference extract_features.py:97-101)."""
    jp, ip = _frame_paths(cfg, video_id, idx)
    ok = (not cfg.write_json) or os.path.exists(jp)
    return ok and ((not cfg.write_sticks) or os.path.exists(ip))


def save_frame(cfg: ExtractConfig, video_id: str, idx: int,
               candidate: np.ndarray, subset: np.ndarray,
               all_hand_peaks: Sequence[np.ndarray],
               frame: Optional[np.ndarray] = None) -> Dict:
    """Persist one frame's pose record; returns the flat feature row."""
    d = os.path.join(cfg.out_root, video_id)
    os.makedirs(d, exist_ok=True)
    jp, ip = _frame_paths(cfg, video_id, idx)
    record = {
        "candidate": np.asarray(candidate).tolist(),
        "subset": np.asarray(subset).tolist(),
        "all_hand_peaks": [np.asarray(p).tolist() for p in all_hand_peaks],
    }
    if cfg.write_json:
        tmp = jp + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, jp)   # write-once atomic, safe under sharded reruns
    if cfg.write_sticks and frame is not None:
        import cv2

        from islx_torch.utils import draw

        circles, sticks = F.get_bodypose(candidate, subset, "body25")
        edges, peaks = F.get_handpose(all_hand_peaks)
        cv2.imwrite(ip, draw.draw_stick_model(frame, circles, sticks,
                                              edges, peaks))
    feat = F.frame_features(candidate, subset, all_hand_peaks, "body25")
    return {"video": video_id, "frame": idx,
            **{f"f{i}": float(v) for i, v in enumerate(feat)}}


def _pending(cfg: ExtractConfig, video_id: str,
             frames: Iterable[Tuple[int, np.ndarray]]):
    """The (idx, frame) not yet extracted, augmented when asked."""
    for idx, frame in frames:
        if is_processed(cfg, video_id, idx):
            continue
        if cfg.augment:
            frame = _augment_frame(cfg, video_id, idx, frame)
        yield idx, frame


def _extract_frames(cfg: ExtractConfig, pose,
                    frames: Iterable[Tuple[int, np.ndarray]],
                    video_id: str) -> List[Dict]:
    """The per-frame loop of :func:`extract_video` over (idx, frame)
    pairs; decode and augmentation run in a prefetch thread."""
    from islx_torch.pipeline.video import Prefetcher

    rows: List[Dict] = []
    for idx, frame in Prefetcher(_pending(cfg, video_id, frames), depth=4):
        candidate, subset, hands = pose(frame)
        rows.append(save_frame(cfg, video_id, idx, candidate, subset,
                               hands, frame))
    return rows


def extract_video(cfg: ExtractConfig, pose, video_path: str,
                  video_id: Optional[str] = None) -> List[Dict]:
    """Run pose over every frame of one video (resumable)."""
    from islx_torch.pipeline.video import FrameSource

    video_id = video_id or os.path.basename(video_path)
    t0 = time.time()
    with FrameSource(video_path) as src:
        rows = _extract_frames(cfg, pose, enumerate(src), video_id)
    if rows:
        rows[-1]["exec_time_s"] = time.time() - t0
    return rows


def _extract_batched(cfg: ExtractConfig, pipe,
                     frames: Iterable[Tuple[int, np.ndarray]],
                     orig_hw: Tuple[int, int], video_id: str,
                     batch: int) -> List[Dict]:
    """The loop of :func:`extract_video_batched` over (idx, frame) pairs
    of one video whose frames are ``orig_hw`` in size.

    Skip, augmentation and the bucket resize (cv2 ``INTER_CUBIC``, whose
    copy is exact when a frame is at its bucket's size already) run in a
    prefetch thread; a short last batch repeats its first frame. Step i+1
    is dispatched before step i is fetched and written, so decode, the
    device step and the writes overlap."""
    from islx_torch.pipeline.batch_pose import bucket_for
    from islx_torch.pipeline.video import Prefetcher

    h0, w0 = orig_hw
    hb, wb = bucket_for(h0, w0)
    sy, sx = h0 / hb, w0 / wb
    rows: List[Dict] = []

    def packed(items):
        arr = np.empty((batch, hb, wb, 3), np.uint8)
        for i, (_, f) in enumerate(items):
            if f.shape[:2] == (hb, wb):
                arr[i] = f
            else:
                import cv2

                arr[i] = cv2.resize(f, (wb, hb),
                                    interpolation=cv2.INTER_CUBIC)
        arr[len(items):] = arr[0]
        return arr, items

    def batches():
        buf = []
        for item in _pending(cfg, video_id, frames):
            buf.append(item)
            if len(buf) == batch:
                yield packed(buf)
                buf = []
        if buf:
            yield packed(buf)

    def consume(handle, items):
        results, boxes, peaks = pipe.assemble(handle, batch)
        for i, (idx, frame) in enumerate(items):
            candidate, subset = results[i]
            if candidate.shape[0]:
                candidate = candidate.copy()
                candidate[:, 0] *= sx
                candidate[:, 1] *= sy
            hands = pipe.hands_for_frame(boxes, peaks, i, sy, sx)
            rows.append(save_frame(cfg, video_id, idx, candidate, subset,
                                   hands, frame))

    pending = None
    for arr, items in Prefetcher(batches(), depth=2):
        handle = pipe.device_step_flat(pipe.upload_frames(arr), batch, hb,
                                       wb, (h0, w0))
        if pending is not None:
            consume(*pending)
        pending = (handle, items)
    if pending is not None:
        consume(*pending)
    return rows


def extract_video_batched(cfg: ExtractConfig, pipe, video_path: str,
                          video_id: Optional[str] = None,
                          batch: int = 16) -> List[Dict]:
    """Batched extraction through a ``FusedPosePipeline``: one upload and
    one fetch a ``batch`` frames (:func:`_extract_batched`). The records
    are those of the per-frame path's ``save_frame`` contract."""
    from islx_torch.pipeline.video import FrameSource

    video_id = video_id or os.path.basename(video_path)
    t0 = time.time()
    with FrameSource(video_path) as src:
        rows = _extract_batched(cfg, pipe, enumerate(src),
                                (src.meta.height, src.meta.width), video_id,
                                batch)
    if rows:
        rows[-1]["exec_time_s"] = time.time() - t0
    return rows


def _augment_frame(cfg: ExtractConfig, video_id: str, idx: int,
                   frame: np.ndarray, device="cpu") -> np.ndarray:
    """Deterministic per-frame rotate and maybe solarize
    (:mod:`islx_torch.ops.augment`), drawn as islx draws them."""
    import zlib

    import torch

    from islx_torch.ops.augment import rotate_nearest, solarize

    # crc32, not hash(): python's hash is salted per process and would
    # break the idempotent-resume contract
    seed = zlib.crc32(f"{video_id}/{idx}".encode()) & 0x7FFFFFFF
    rs = np.random.RandomState(seed)
    deg = rs.uniform(-cfg.augment_degrees, cfg.augment_degrees)
    out = rotate_nearest(torch.from_numpy(np.asarray(frame)).to(device), deg)
    if rs.rand() < 0.5:
        out = solarize(out, cfg.solarize_threshold)
    return out.cpu().numpy().astype(frame.dtype)


def shard_rows(rows: Sequence, shard_index: int, num_shards: int) -> List:
    """Deterministic row partition (replaces extract_features_mp.py:198-201)."""
    return [r for i, r in enumerate(rows) if i % num_shards == shard_index]


# pandas.read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}


def _parse_column(values: List[str]) -> list:
    """A CSV column's strings as the values pandas reads: int where every
    value is an integer, float where every present value is a number
    (missing -> nan), bool where every value is a truth word, else
    strings (missing -> None)."""
    present = [v for v in values if v not in _NA]

    def all_parse(fn):
        try:
            for v in present:
                fn(v)
            return True
        except ValueError:
            return False

    if present and len(present) == len(values) and all_parse(int):
        return [int(v) for v in values]
    if all_parse(float):
        return [float(v) if v not in _NA else float("nan") for v in values]
    if present and len(present) == len(values) and all(
            v in _TRUE or v in _FALSE for v in values):
        return [v in _TRUE for v in values]
    return [v if v not in _NA else None for v in values]


def _read_csv(path: str) -> Tuple[List[str], List[Dict]]:
    """-> (column names, rows as {column: value}) with pandas' types."""
    with open(path, newline="") as f:
        table = list(csv.reader(f))
    header, body = table[0], table[1:]
    cols = [_parse_column([r[i] if i < len(r) else "" for r in body])
            for i in range(len(header))]
    return header, [dict(zip(header, vals)) for vals in zip(*cols)]


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _write_csv(path: str, rows: List[Dict]) -> None:
    """Rows -> CSV as ``pandas.DataFrame(rows).to_csv(index=False)``
    writes them: columns in first-seen order, a missing cell empty, a
    column of ints (with no missing cell) as ints, a column of numbers as
    floats, and anything else as ``str``."""
    names: Dict[str, None] = {}
    for r in rows:
        names.update(dict.fromkeys(r))
    cols = {}
    for c in names:
        vals = [r.get(c) for r in rows]
        present = [v for v in vals if not _is_missing(v)]
        numbers = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                      for v in present)
        if numbers and len(present) == len(vals) and all(
                isinstance(v, int) for v in present):
            cols[c] = [str(v) for v in vals]
        elif numbers and present:
            cols[c] = ["" if _is_missing(v) else repr(float(v))
                       for v in vals]
        else:
            cols[c] = ["" if _is_missing(v) else str(v) for v in vals]
    with open(path, "w", newline="") as f:
        if not names:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(names))
        w.writerows(zip(*cols.values()))


def extract_dataset(cfg: ExtractConfig, pose, csv_path: str,
                    shard_index: int = 0, num_shards: int = 1,
                    path_col: str = "Filepath",
                    batch: Optional[int] = None) -> str:
    """Extract features for every video in an INCLUDE-style CSV shard.

    ``pose``: a per-frame callable (``ISLSignPos``), or, with ``batch``
    set, a ``FusedPosePipeline`` driven through
    :func:`extract_video_batched`. Writes ``features-shard{i}.csv`` under
    ``out_root``: each row is a frame's features, the video's other CSV
    columns, and ``exec_time_s`` on a video's last row."""
    columns, table = _read_csv(csv_path)
    all_rows: List[Dict] = []
    for row in shard_rows(table, shard_index, num_shards):
        path = row[path_col]
        meta = {c: row[c] for c in columns if c != path_col}
        rows = (extract_video_batched(cfg, pose, path, batch=batch)
                if batch else extract_video(cfg, pose, path))
        for r in rows:
            r.update(meta)
            all_rows.append(r)
    out = os.path.join(cfg.out_root, f"features-shard{shard_index}.csv")
    _write_csv(out, all_rows)
    return out
