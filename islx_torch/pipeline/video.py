"""Video input feeding the batched device pipelines (copy of the parts of
islx/pipeline/video.py the translation path uses).

Frames are read with cv2.VideoCapture (or decoded straight to bucketed I420
by ffmpeg) and metadata probed with ffprobe, cv2 as the fallback. A
``FrameBatcher`` groups frames into fixed-size device batches (the
throughput unit of islx_torch.pipeline.batch_pose); a ``Prefetcher`` runs
decoding in a background thread.
"""
from __future__ import annotations

import json
import shutil
import subprocess
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def _have(binary: str) -> bool:
    return shutil.which(binary) is not None


@dataclass
class VideoMeta:
    width: int
    height: int


def probe(path: str) -> VideoMeta:
    """Frame size via ffprobe (reference demo_video.py:18-34), cv2
    fallback when ffprobe is unavailable."""
    if _have("ffprobe"):
        cmd = ["ffprobe", "-v", "error", "-select_streams", "v:0",
               "-show_streams", "-print_format", "json", path]
        s = json.loads(subprocess.check_output(cmd).decode())["streams"][0]
        return VideoMeta(width=int(s["width"]), height=int(s["height"]))
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return VideoMeta(width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                         height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    finally:
        cap.release()


class FrameSource:
    """Iterate BGR u8 frames from a video file (cv2.VideoCapture);
    ``meta`` holds the frame size (:func:`probe`)."""

    def __init__(self, path: str):
        import cv2

        self.path = path
        self.meta = probe(path)
        self._cap = cv2.VideoCapture(path)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self._cap.read()
            if not ok:
                break
            yield frame

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class YUVFrameSource:
    """Decode straight to BUCKETED I420 frames via ffmpeg: yields flat u8
    buffers of ``hb*wb*3/2`` bytes per frame.

    Decode, scale, and 4:2:0 all happen inside the decoder process (video is
    stored 4:2:0 — this is the decoder's native output, the BGR round trip
    the reference pays per frame never happens); the device converts
    I420 -> BGR inside the fused step (islx_torch.ops.yuv). Host->device frame
    traffic drops to 1.5 bytes/px. Requires ffmpeg; callers fall back to
    FrameSource + host bucketing when it is missing.
    """

    def __init__(self, path: str, bucket_hw: Tuple[int, int]):
        if not _have("ffmpeg"):
            raise RuntimeError("YUVFrameSource requires ffmpeg")
        hb, wb = bucket_hw
        if hb % 2 or wb % 2:
            raise ValueError(f"I420 needs an even bucket, got {bucket_hw}")
        self.frame_bytes = hb * wb * 3 // 2
        cmd = ["ffmpeg", "-v", "error", "-i", path,
               "-vf", f"scale={wb}:{hb}", "-pix_fmt", "yuv420p",
               "-f", "rawvideo", "-"]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            buf = self._proc.stdout.read(self.frame_bytes)
            if len(buf) < self.frame_bytes:
                break
            yield np.frombuffer(buf, np.uint8)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
        self._proc.wait()
        self._proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def flat_batches(frames: Iterator[np.ndarray], batch: int
                 ) -> Iterator[Tuple[np.ndarray, int]]:
    """Group flat per-frame u8 buffers into (concat [batch*bytes], n_valid)
    device batches; the tail pads by repeating the last frame."""
    buf: List[np.ndarray] = []
    for f in frames:
        buf.append(f)
        if len(buf) == batch:
            yield np.concatenate(buf), batch
            buf.clear()
    if buf:
        n = len(buf)
        while len(buf) < batch:
            buf.append(buf[-1])
        yield np.concatenate(buf), n


class Prefetcher:
    """Run an iterator in a background thread behind a bounded queue.

    Overlaps host video decode/resize with device compute (the async input
    stage of SURVEY §2.3's 'host-side async decode feeding a device prefetch
    queue'). Order-preserving; exceptions in the producer re-raise in the
    consumer; the thread is joined when the iterator is exhausted.
    """

    _DONE = object()

    def __init__(self, it, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._exc = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate to the consumer
                self._exc = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                self._thread.join()
                if self._exc is not None:
                    raise self._exc
                return
            yield item


class FrameBatcher:
    """Group frames into fixed [B,Hb,Wb,3] buckets for device batches.

    Resizes each frame into the stride-aligned bucket (cv2 INTER_CUBIC, the
    same resize the per-image path applies on device) and yields
    (batch u8 [B,Hb,Wb,3], n_valid) — the tail batch is padded by repeating
    the last frame so device shapes stay static.
    """

    def __init__(self, batch: int, bucket_hw: Tuple[int, int]):
        self.batch = batch
        self.bucket_hw = bucket_hw

    def __call__(self, frames: Sequence[np.ndarray] | Iterator[np.ndarray]
                 ) -> Iterator[Tuple[np.ndarray, int]]:
        import cv2

        hb, wb = self.bucket_hw
        buf: List[np.ndarray] = []
        for frame in frames:
            buf.append(cv2.resize(frame, (wb, hb),
                                  interpolation=cv2.INTER_CUBIC))
            if len(buf) == self.batch:
                yield np.stack(buf), self.batch
                buf.clear()
        if buf:
            n = len(buf)
            while len(buf) < self.batch:
                buf.append(buf[-1])
            yield np.stack(buf), n
