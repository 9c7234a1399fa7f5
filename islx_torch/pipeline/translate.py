"""Batched end-to-end ISL translation (port of
``islx/pipeline/translate.py::BatchedTranslatePipeline``).

Video frames -> one fused device step per batch (FusedPosePipeline) ->
host grouping from the one packed fetch -> 156-d features -> rolling
20-frame windows -> BiLSTM head on the device.

``dispatch_batch`` enqueues a batch's device work and returns at once;
``finish_batch`` copies that batch's packed buffer to the host and runs
grouping and features. Streams dispatch batch i+1 before finishing batch
i, so host work overlaps the device.

Setting ``prof`` to a dict accumulates host seconds by stage (islx's
accounting): ``dispatch`` (upload and enqueue of the fused step),
``fetch_group`` (the packed buffer's copy to the host, which waits for the
device, and grouping), ``featurize`` (156-d features) and ``head`` (the
BiLSTM on the windows, with its result's copy).
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig, TranslatorConfig
from islx_torch.isl import features as F
from islx_torch.isl.expressions import EXPRESSIONS
from islx_torch.models import translator as T
from islx_torch.pipeline.batch_pose import FusedPosePipeline, bucket_for


class BatchedTranslatePipeline:
    """Streaming frames -> per-frame sign predictions, batch-at-a-time.

    Weights default to the port's seeded init; ``head_params`` is islx's
    keras-layout numpy dict. ``device`` defaults to ``"cuda"``. ``mesh``
    (:mod:`islx_torch.parallel.mesh`) shards each batch's fused step over
    its data axis, which must divide ``batch``; the head runs on the
    mesh's first device."""

    def __init__(self, body_params=None, hand_params=None,
                 head_params: Optional[T.Params] = None,
                 model_type: str = "body25",
                 pose_cfg: Optional[PoseConfig] = None,
                 hand_cfg: Optional[HandConfig] = None,
                 cfg: TranslatorConfig = TranslatorConfig(),
                 batch: int = 16, compute_dtype=torch.bfloat16,
                 device=None, mesh=None):
        self.cfg = cfg
        self.batch = batch
        self.model_type = model_type
        if mesh is not None and batch % mesh.shape["data"]:
            raise ValueError(
                f"batch {batch} not divisible by mesh data axis "
                f"{mesh.shape['data']}")
        self.pipe = FusedPosePipeline(
            body_params if body_params is not None
            else W.init_params(model_type),
            hand_params if hand_params is not None
            else W.init_params("hand"),
            model_type,
            pose_cfg or PoseConfig(model_type=model_type, max_peaks=16),
            hand_cfg or HandConfig.production(),
            compute_dtype=compute_dtype, device=device, mesh=mesh)
        self.device = self.pipe.device
        # runtime peak-threshold override; None = pose_cfg.thre1
        self.thre1: Optional[float] = None
        self.head = T.build_head(head_params, self.device, cfg)
        self._window: List[np.ndarray] = []
        # host seconds by stage, accumulated where a dict is set
        self.prof: Optional[dict] = None

    def _tick(self, key: str, t0: float) -> None:
        if self.prof is not None:
            self.prof[key] = (self.prof.get(key, 0.0)
                              + (time.perf_counter() - t0))

    def reset(self) -> None:
        self._window.clear()

    def dispatch_batch(self, frames_bucketed: np.ndarray,
                       orig_hw: Tuple[int, int]):
        """Upload + enqueue the fused step; -> handles for finish_batch."""
        t0 = time.perf_counter()
        b, hb, wb = frames_bucketed.shape[:3]
        flat = self.pipe.upload_frames(frames_bucketed)
        packed = self.pipe.device_step_flat(flat, b, hb, wb, orig_hw,
                                            self.thre1)
        self._tick("dispatch", t0)
        return packed, (b, hb, wb)

    def finish_batch(self, handles, orig_hw: Tuple[int, int]
                     ) -> List[np.ndarray]:
        """One device->host copy of the packed buffer -> grouping +
        features."""
        packed, (b, hb, wb) = handles
        t0 = time.perf_counter()
        results, boxes, peaks = self.pipe.assemble(packed.cpu().numpy(), b)
        self._tick("fetch_group", t0)
        return self._features(results, boxes, peaks,
                              orig_hw[0] / hb, orig_hw[1] / wb)

    def process_batch(self, frames_bucketed: np.ndarray,
                      orig_hw: Tuple[int, int]) -> List[np.ndarray]:
        """u8 [B,Hb,Wb,3] -> per-frame 156-d feature vectors."""
        return self.finish_batch(self.dispatch_batch(frames_bucketed,
                                                     orig_hw), orig_hw)

    def _features(self, results, boxes, peaks, sy, sx) -> List[np.ndarray]:
        t0 = time.perf_counter()
        feats = []
        for fidx, (cand, subset) in enumerate(results):
            if cand.shape[0]:
                cand = cand.copy()
                cand[:, 0] *= sx
                cand[:, 1] *= sy
            hands = self.pipe.hands_for_frame(boxes, peaks, fidx, sy, sx)
            feats.append(F.frame_features(cand, subset, hands,
                                          self.model_type))
        self._tick("featurize", t0)
        return feats

    def _make_emitter(self, out: List[Tuple[int, int, str, float]]):
        """Rolling-window consumer: feats -> head -> predictions in out."""
        state = {"idx0": 0}

        def emit(feats):
            windows, widx = [], []
            for i, f in enumerate(feats):
                self._window.append(f)
                if len(self._window) > self.cfg.window_size:
                    self._window.pop(0)
                if len(self._window) == self.cfg.window_size:
                    windows.append(np.stack(self._window))
                    widx.append(state["idx0"] + i)
            if windows:
                t0 = time.perf_counter()
                x = torch.from_numpy(np.stack(windows).astype(np.float32))
                with torch.inference_mode():
                    probs = self.head(x.to(self.device)).cpu().numpy()
                self._tick("head", t0)
                for w, pr in zip(widx, probs):
                    cid = int(np.argmax(pr))
                    out.append((w, cid, EXPRESSIONS[cid], float(pr[cid])))
            state["idx0"] += len(feats)

        return emit

    def translate_frames(self, frames: Iterable[np.ndarray],
                         orig_hw: Optional[Tuple[int, int]] = None
                         ) -> List[Tuple[int, int, str, float]]:
        """Stream BGR frames -> [(frame_idx, class_id, expression, prob)]."""
        from islx_torch.pipeline.video import FrameBatcher, Prefetcher

        self.reset()
        out: List[Tuple[int, int, str, float]] = []
        emit = self._make_emitter(out)
        it = iter(frames)
        first = next(it, None)
        if first is None:
            return out
        hw = orig_hw or first.shape[:2]
        batcher = FrameBatcher(self.batch, bucket_for(hw[0], hw[1],
                                                      target_h=184))

        def chain():
            yield first
            yield from it

        pending = None   # (handles, n_valid): dispatched, not yet consumed
        for batch, n_valid in Prefetcher(batcher(chain()), depth=2):
            handles = self.dispatch_batch(batch, hw)
            if pending is not None:
                emit(self.finish_batch(pending[0], hw)[:pending[1]])
            pending = (handles, n_valid)
        if pending is not None:
            emit(self.finish_batch(pending[0], hw)[:pending[1]])
        return out

    def translate_yuv_frames(self, flat_frames: Iterable[np.ndarray],
                             orig_hw: Tuple[int, int],
                             bucket_hw: Tuple[int, int]
                             ) -> List[Tuple[int, int, str, float]]:
        """Stream flat per-frame I420 buffers (already at ``bucket_hw``) ->
        predictions; the device converts I420 -> BGR in the fused step."""
        from islx_torch.pipeline.video import Prefetcher, flat_batches

        self.reset()
        out: List[Tuple[int, int, str, float]] = []
        emit = self._make_emitter(out)
        hb, wb = bucket_hw
        sy, sx = orig_hw[0] / hb, orig_hw[1] / wb

        def finish(packed, n_valid):
            t0 = time.perf_counter()
            results, boxes, peaks = self.pipe.assemble(
                packed.cpu().numpy(), self.batch)
            self._tick("fetch_group", t0)
            emit(self._features(results, boxes, peaks, sy, sx)[:n_valid])

        pending = None
        for flat, n_valid in Prefetcher(
                flat_batches(iter(flat_frames), self.batch), depth=2):
            t0 = time.perf_counter()
            packed = self.pipe.device_step_flat(
                self.pipe.upload_frames(flat.reshape(self.batch, -1)),
                self.batch, hb, wb, orig_hw,
                self.thre1, input_format="yuv420")
            self._tick("dispatch", t0)
            if pending is not None:
                finish(*pending)
            pending = (packed, n_valid)
        if pending is not None:
            finish(*pending)
        return out

    def translate_video(self, path: str, yuv: Optional[bool] = None
                        ) -> List[Tuple[int, int, str, float]]:
        """A video file -> predictions. ``yuv`` (default: when ffmpeg
        exists) decodes straight to bucketed I420 and converts on the
        device; else frames are read as BGR and bucketed on the host."""
        import shutil

        from islx_torch.pipeline.video import (FrameSource, YUVFrameSource,
                                               probe)

        if yuv is None:
            yuv = shutil.which("ffmpeg") is not None
        if not yuv:
            with FrameSource(path) as src:
                return self.translate_frames(src)
        meta = probe(path)
        hw = (meta.height, meta.width)
        hb, wb = bucket_for(hw[0], hw[1], target_h=184)
        with YUVFrameSource(path, (hb, wb)) as src:
            return self.translate_yuv_frames(src, hw, (hb, wb))
