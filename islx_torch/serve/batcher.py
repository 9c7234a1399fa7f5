"""Dynamic micro-batching over the fused pose step (port of
``islx/serve/batcher.py``).

Callers submit single frames and get futures. One worker thread drains the
queue every ``max_wait_ms``, or as soon as ``max_batch`` requests wait,
batches the requests of one resolution (others wait in a FIFO spill, so a
minority resolution is not starved), resizes each frame to its 184-row
bucket, pads the batch to ``max_batch`` and runs one
:class:`islx_torch.pipeline.batch_pose.FusedPosePipeline` step for the
whole batch. All request device work runs on the worker, under
``torch.inference_mode()``.

``quantize_after`` turns on the live int8 swap: after that many served
frames a background thread calibrates both nets on a bounded sample of the
served frames, builds the int8 W8A8 pipeline, runs one step of every
shape the float pipeline served, and hands the pipeline to the worker, which
switches between batches. On the GPU that thread works on its own CUDA
stream, so calibration never queues in front of request steps.

A batch's frames are uploaded once, as they came, and resized to their
bucket on the device by :func:`islx_torch.ops.resize_u8.resize_u8` (cv2's
``INTER_CUBIC``, word for word, without cv2), then padded there; the
calibration frames are resized to the hand crop size the same way. A frame
already at its target size is used as it is.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from islx_torch.ops.resize_u8 import resize_frames, upload_resized
from islx_torch.pipeline.batch_pose import bucket_for

_log = logging.getLogger(__name__)


class PoseResult:
    __slots__ = ("candidate", "subset", "hands")

    def __init__(self, candidate, subset, hands):
        self.candidate = candidate
        self.subset = subset
        self.hands = hands


class _Cancelled(Exception):
    """close() was called while the int8 swap was under way."""


class MicroBatcher:
    """Submit frames, get back futures resolving to :class:`PoseResult`.

    ``max_resolutions`` bounds the buckets kept live: past it, the least
    recently served bucket's keys are dropped (``pipe.drop_programs``),
    and ``stats()`` counts each bucket dropped as ``programs_evicted``
    (islx's name). islx frees the bucket's compiled programs there; the
    port holds no per-bucket device state, so the drop only bounds the
    shapes the int8 swap warms.
    After an int8 swap, ``calibrated_on`` holds the frames it calibrated
    on (bucket-sized u8 BGR, in serving order).

    ``aot_dir`` (islx's warm start): the matching artifacts of
    ``python -m islx_torch.cli.export_programs`` are loaded before the
    constructor returns (:func:`islx_torch.core.aot.preload_dir`: their
    kernel libraries installed, one step at each key on zero frames), and
    their keys kept in ``aot_loaded``. The worker thread loads them before
    it takes a request, because PyTorch keeps its cuDNN and cuBLAS handles
    a thread: a step on the constructor's thread would leave their
    creation to the first request. Those steps are not traffic: no
    request, batch or calibration frame counts them."""

    _CALIB_KEEP = 32      # calibration sample cap (frames kept in memory)
    _CALIB_CHUNK = 8      # frames a calibration forward (device memory)

    def __init__(self, pipe, max_batch: int = 8, max_wait_ms: float = 15.0,
                 target_h: int = 184, quantize_after: Optional[int] = None,
                 max_resolutions: int = 8, aot_dir: Optional[str] = None):
        self.pipe = pipe
        self.aot_loaded: list = []
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self.target_h = target_h
        self.max_resolutions = int(max_resolutions)
        self._res_lru: "OrderedDict[Tuple[int, int], None]" = OrderedDict()
        self.quantize_after = quantize_after
        # a bounded sample of the served frames, of the first-seen bucket
        # only (they are stacked), and the count of frames served
        self._calib_frames: list = []
        self._calib_hw0: Optional[Tuple[int, int]] = None
        self._calib_seen = 0
        self.calibrated_on: Optional[list] = None
        self._quant_started = False
        self._quant_thread: Optional[threading.Thread] = None
        self._pending_pipe = None
        self._pending_lock = threading.Lock()
        self._q: "queue.Queue[Tuple[np.ndarray, Future]]" = queue.Queue()
        self._stats = {"requests": 0, "batches": 0, "frames_padded": 0,
                       "quantized": False}
        # per-request latency, submit to result set, over a rolling window
        self._latencies_ms: "deque[float]" = deque(maxlen=2048)
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._preload_error: Optional[Exception] = None
        preloaded = threading.Event()
        self._worker = threading.Thread(target=self._run,
                                        args=(aot_dir, preloaded),
                                        daemon=True)
        self._worker.start()
        preloaded.wait()
        if self._preload_error is not None:
            self.close()
            raise self._preload_error

    def submit(self, frame_bgr_u8: np.ndarray) -> "Future[PoseResult]":
        """Non-blocking: returns a future with the frame's PoseResult."""
        fut: Future = Future()
        fut._t0 = time.monotonic()
        if self._stop.is_set():
            # the worker is gone: nothing would ever resolve the future
            fut.set_exception(RuntimeError("MicroBatcher closed"))
            return fut
        self._q.put((np.asarray(frame_bgr_u8), fut))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def pose(self, frame_bgr_u8: np.ndarray,
             timeout: Optional[float] = None) -> PoseResult:
        """Blocking convenience wrapper."""
        return self.submit(frame_bgr_u8).result(timeout)

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
            lats = sorted(self._latencies_ms)
        if lats:
            out["latency_ms_p50_request"] = round(lats[len(lats) // 2], 1)
            out["latency_ms_p99_request"] = round(
                lats[min(int(len(lats) * 0.99), len(lats) - 1)], 1)
            out["latency_window_n"] = len(lats)
        return out

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5.0)
        # the swap thread checks _stop between calibration chunks and
        # between warm-up steps, so this join waits at most one of those
        t = self._quant_thread
        if t is not None:
            t.join(timeout=120.0)
        # fail any request the worker never picked up
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("MicroBatcher closed"))

    def _run(self, aot_dir, preloaded) -> None:
        # the artifacts' warm-up steps run here, on the thread that serves
        # (the constructor waits for them and re-raises what they raised)
        try:
            if aot_dir:
                from islx_torch.core import aot

                with torch.inference_mode():
                    self.aot_loaded = aot.preload_dir(self.pipe, aot_dir,
                                                      verbose=True)
        except Exception as exc:
            self._preload_error = exc
            return
        finally:
            preloaded.set()
        pending = []   # spilled other-resolution requests, served first
        while not self._stop.is_set():
            if pending:
                first = pending.pop(0)
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                # the batching window ends early once a full batch waits
                deadline = time.monotonic() + self.max_wait
                while (self._q.qsize() < self.max_batch - 1
                       and not self._stop.is_set()):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._stop.wait(min(left, 0.001))
            hw0 = first[0].shape[:2]
            batch = [first]
            i = 0
            while len(batch) < self.max_batch and i < len(pending):
                if pending[i][0].shape[:2] == hw0:
                    batch.append(pending.pop(i))
                else:
                    i += 1
            while len(batch) < self.max_batch:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item[0].shape[:2] == hw0:
                    batch.append(item)
                else:
                    pending.append(item)
            try:
                with torch.inference_mode():
                    self._process(batch, hw0)
            except Exception as exc:  # resolve the futures, keep serving
                _log.exception("pose batch failed")
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
        for _, fut in pending:
            if not fut.done():
                fut.set_exception(RuntimeError("MicroBatcher closed"))

    def _process(self, batch, hw0) -> None:
        # switch to a finished int8 pipeline between batches
        with self._pending_lock:
            if self._pending_pipe is not None:
                self.pipe = self._pending_pipe
                self._pending_pipe = None
                with self._stats_lock:
                    self._stats["quantized"] = True

        h0, w0 = hw0
        hb, wb = bucket_for(h0, w0, target_h=self.target_h)
        self._touch_resolution(hb, wb)
        # one upload of the batch as it came (one resolution), the bucket
        # resize and the padding to max_batch on the device
        n = len(batch)
        frames = upload_resized([f for f, _ in batch], hb, wb,
                                self.pipe.device)
        if n < self.max_batch:
            frames = torch.cat([frames, frames[:1].expand(
                self.max_batch - n, -1, -1, -1)])
        if self.quantize_after is not None and not self._quant_started:
            self._sample_for_calibration(frames, n, hw0)
        packed = self.pipe.device_step(frames, (h0, w0))
        results, boxes, peaks = self.pipe.assemble(packed, self.max_batch)
        sy, sx = h0 / hb, w0 / wb
        for i, (_, fut) in enumerate(batch):
            candidate, subset = results[i]
            if candidate.shape[0]:
                candidate = candidate.copy()
                candidate[:, 0] *= sx
                candidate[:, 1] *= sy
            hands = self.pipe.hands_for_frame(boxes, peaks, i, sy, sx)
            # a client may have cancelled its future while the batch ran:
            # set_result would raise and fail the rest of the batch
            if not fut.done():
                try:
                    fut.set_result(PoseResult(candidate, subset, hands))
                except InvalidStateError:   # lost the race to a cancel
                    pass
                else:
                    lat = (time.monotonic() - fut._t0) * 1e3
                    with self._stats_lock:
                        self._latencies_ms.append(lat)
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["frames_padded"] += self.max_batch - len(batch)

    def _sample_for_calibration(self, frames, n, hw0) -> None:
        """Keep up to _CALIB_KEEP served frames of the first-seen bucket
        (bucket-sized host copies of the device batch ``frames``; only
        those kept are copied back) and start the swap once quantize_after
        frames were served."""
        self._calib_seen += n
        shape = tuple(frames.shape[1:])
        if (not self._calib_frames
                or self._calib_frames[0].shape == shape):
            if not self._calib_frames:
                # the swap's warm-up steps the key real traffic at this
                # resolution records (its scales come from hw0)
                self._calib_hw0 = hw0
            room = max(self._CALIB_KEEP - len(self._calib_frames), 0)
            if min(n, room):
                self._calib_frames.extend(frames[:min(n, room)].cpu().numpy())
        if self._calib_seen >= self.quantize_after:
            self._quant_started = True
            calib, self._calib_frames = self._calib_frames, []
            self._quant_thread = threading.Thread(
                target=self._background_quantize,
                args=(calib, self._calib_hw0), daemon=True)
            self._quant_thread.start()

    def _touch_resolution(self, hb: int, wb: int) -> None:
        """LRU-track served buckets; past ``max_resolutions`` live ones,
        drop the stalest bucket's keys."""
        self._res_lru[(hb, wb)] = None
        self._res_lru.move_to_end((hb, wb))
        while len(self._res_lru) > self.max_resolutions:
            (ehb, ewb), _ = self._res_lru.popitem(last=False)
            self.pipe.drop_programs(ehb, ewb)
            with self._stats_lock:
                self._stats["programs_evicted"] = (
                    self._stats.get("programs_evicted", 0) + 1)

    def _chunks(self, arr):
        """Calibration chunks; stops between chunks once close() was
        called."""
        for i in range(0, len(arr), self._CALIB_CHUNK):
            if self._stop.is_set():
                raise _Cancelled()
            yield arr[i:i + self._CALIB_CHUNK]

    def _background_quantize(self, calib_frames, cal_hw0) -> None:
        """Calibrate on the stored frames, build the int8 pipeline and run
        one step of every shape the float pipeline served before handing it
        to the worker: the float pipeline serves until the new one is
        ready. The hand net calibrates on whole frames resized to the crop
        size (the crops' pixel statistics), as islx does."""
        old = self.pipe
        dev = old.device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()), torch.inference_mode():
                new_pipe = self._int8_pipeline(old, calib_frames, cal_hw0)
                if stream is not None:
                    stream.synchronize()
        except _Cancelled:
            return
        except Exception as exc:
            # a failed swap must not stop serving: stay float, and say why
            _log.exception("int8 swap failed; serving stays float")
            self.quantize_after = None
            with self._stats_lock:
                self._stats["quantize_error"] = repr(exc)
            return
        self.calibrated_on = list(calib_frames)
        with self._pending_lock:
            self._pending_pipe = new_pipe

    def _int8_pipeline(self, old, calib_frames, cal_hw0):
        """The int8 twin of ``old``, calibrated on ``calib_frames`` and
        warmed on every shape it served."""
        from islx_torch.models import quant
        from islx_torch.pipeline.batch_pose import FusedPosePipeline

        xcal = np.stack(calib_frames).astype(np.float32) / 256.0 - 0.5
        size = int(np.rint(old.hand.cfg.scale_search[0]
                           * old.hand.cfg.boxsize))
        hcal = resize_frames(calib_frames, size, size, old.device).astype(
            np.float32) / 256.0 - 0.5
        cd = old.body.compute_dtype
        bq = quant.quantize_model(old.body.params, old.model_type,
                                  self._chunks(xcal), compute_dtype=cd,
                                  device=old.device)
        hq = quant.quantize_model(old.hand.params, "hand", self._chunks(hcal),
                                  compute_dtype=cd, device=old.device)
        new_pipe = FusedPosePipeline(
            bq, hq, old.model_type, old.body.cfg, old.hand.cfg,
            det_cfg=old.det_cfg, compute_dtype=cd, top_m=old.body.top_m,
            mesh=old.mesh, device=old.device,
            pallas_nms=old.body.pallas_nms)
        # one step of every shape the float pipeline served, the
        # calibration bucket's first: it builds the int8 kernels and sizes
        # the memory pools before any request meets the new pipeline. Keys
        # that differ only in their frame-to-bucket scales launch the same
        # work, so one step serves them all.
        ch, cw = calib_frames[0].shape[:2]
        keys = [old.program_key(self.max_batch, ch, cw, cal_hw0)]
        warmed = set()
        for b, hb, wb, sy, sx, fmt in keys + old.program_keys():
            if (b, hb, wb, fmt) in warmed:
                continue
            warmed.add((b, hb, wb, fmt))
            if self._stop.is_set():
                raise _Cancelled()
            n = b * hb * wb * 3 // (2 if fmt == "yuv420" else 1)
            new_pipe.device_step_flat(
                torch.zeros(n, dtype=torch.uint8, device=old.device), b, hb,
                wb, (round(sy * hb), round(sx * wb)),
                input_format=fmt).cpu()
        return new_pipe
