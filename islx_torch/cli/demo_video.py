"""Video annotation demo: batched body + hand over a video file (port of
``islx/cli/demo_video.py``; reference demo_video.py).

Frames stream through one fused device pass a batch
(:class:`islx_torch.pipeline.batch_pose.FusedPosePipeline`: body CPM -> hand
boxes on the device -> hand CPM), or the body pipeline alone with
``--no-hands``; ``--per-frame`` runs the reference-exact per-frame path.

    python -m islx_torch.cli.demo_video VIDEO [--out OUT.mp4] [--batch 16]
           [--body-weights W] [--hand-weights W] [--per-frame] [--no-hands]
           [--model-type body25|coco] [--device cuda|cpu]

cv2 decodes the clip; each batch is uploaded once and resized to its
bucket on the device (:func:`islx_torch.ops.resize_u8.upload_resized`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _bucket_batch(raw, hb: int, wb: int, batch: int, device
                  ) -> torch.Tensor:
    """Raw frames -> a fixed [batch,hb,wb,3] bucket on ``device`` (the tail
    repeats the last frame): one upload and one resize a batch, as islx
    resizes them."""
    from islx_torch.core.runtime import resolve_device
    from islx_torch.ops.resize_u8 import upload_resized

    frames = upload_resized(raw, hb, wb, resolve_device(device))
    if len(raw) < batch:
        frames = torch.cat([frames, frames[-1:].expand(
            batch - len(raw), -1, -1, -1)])
    return frames


def _annotate_hands(canvas, frame, candidate, subset, hand):
    if hand is None or len(subset) == 0:
        return canvas
    from islx_torch.pose.detector import hand_detect
    from islx_torch.utils import draw

    peaks_all = []
    for x, y, w, _ in hand_detect(candidate, subset, frame.shape):
        peaks = hand(frame[y:y + w, x:x + w, :]).astype(np.int64)
        peaks[:, 0] = np.where(peaks[:, 0] == 0, 0, peaks[:, 0] + x)
        peaks[:, 1] = np.where(peaks[:, 1] == 0, 0, peaks[:, 1] + y)
        peaks_all.append(peaks)
    return draw.draw_handpose(canvas, peaks_all)


def main(argv=None):
    from islx_torch.core import weights as W
    from islx_torch.core.config import PoseConfig
    from islx_torch.pipeline.batch_pose import (BatchedBodyPipeline,
                                                FusedPosePipeline, bucket_for)
    from islx_torch.pipeline.video import (FrameSource, FrameWriter,
                                           Prefetcher)
    from islx_torch.pose.body import Body
    from islx_torch.pose.hand import Hand
    from islx_torch.utils import draw

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("video")
    p.add_argument("--out", default=None)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--per-frame", action="store_true",
                   help="the reference-exact per-frame path instead of the "
                        "batched pipeline")
    p.add_argument("--no-hands", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    out_path = args.out or (args.video + ".annotated.mp4")
    with FrameSource(args.video) as src:
        meta = src.meta
        writer = FrameWriter(out_path, meta.fps, (meta.height, meta.width))
        n_done = 0
        if args.per_frame:
            hand = (None if args.no_hands
                    else Hand(args.hand_weights, device=args.device))
            body = Body(args.body_weights, args.model_type,
                        device=args.device)
            for frame in src:
                candidate, subset = body(frame)
                canvas = draw.draw_bodypose(frame, candidate, subset,
                                            args.model_type)
                writer(_annotate_hands(canvas, frame, candidate, subset,
                                       hand))
                n_done += 1
        else:
            body_params = (W.init_params(args.model_type)
                           if args.body_weights is None
                           else W.load(args.body_weights, args.model_type))
            pose_cfg = PoseConfig(model_type=args.model_type, max_peaks=16)
            if args.no_hands:
                pipe = BatchedBodyPipeline(body_params, args.model_type,
                                           pose_cfg, device=args.device)
            else:
                from islx_torch.cli import gated_hand_cfg, gated_int8_params

                hand_params = (W.init_params("hand")
                               if args.hand_weights is None
                               else W.load(args.hand_weights, "hand"))
                hand_cfg = gated_hand_cfg(args.hand_weights, log=print)
                if args.body_weights and args.hand_weights:
                    # a recorded int8 GO (gates.json) -> W8A8 CPMs,
                    # calibrated on the head of this clip
                    body_params, hand_params, _ = gated_int8_params(
                        body_params, hand_params,
                        model_type=args.model_type,
                        hand_weights=args.hand_weights,
                        body_weights=args.body_weights, hand_cfg=hand_cfg,
                        calib_clip=args.video, log=print,
                        device=args.device)
                pipe = FusedPosePipeline(body_params, hand_params,
                                         args.model_type, pose_cfg,
                                         hand_cfg=hand_cfg,
                                         device=args.device)
            hb, wb = bucket_for(meta.height, meta.width)
            sy, sx = meta.height / hb, meta.width / wb

            def batches():
                """Decode + bucket resize in the prefetch thread: yields
                (bucketed [B,hb,wb,3], raw frames, n_valid)."""
                raw = []
                for f in src:
                    raw.append(f)
                    if len(raw) == args.batch:
                        yield (_bucket_batch(raw, hb, wb, args.batch,
                                             args.device), raw, len(raw))
                        raw = []
                if raw:
                    yield (_bucket_batch(raw, hb, wb, args.batch,
                                         args.device), raw, len(raw))

            def annotate(packed, raw, n_valid):
                nonlocal n_done
                if args.no_hands:
                    results = pipe.assemble(packed, args.batch)
                    boxes = peaks = None
                else:
                    results, boxes, peaks = pipe.assemble(packed, args.batch)
                for i in range(n_valid):
                    candidate, subset = results[i]
                    if candidate.shape[0]:
                        candidate[:, 0] *= sx
                        candidate[:, 1] *= sy
                    canvas = draw.draw_bodypose(raw[i], candidate, subset,
                                                args.model_type)
                    if peaks is not None:
                        canvas = draw.draw_handpose(
                            canvas, pipe.hands_for_frame(boxes, peaks, i,
                                                         sy, sx))
                    writer(canvas)
                    n_done += 1

            def dispatch(batch):
                flat = pipe.upload_frames(batch)
                if args.no_hands:
                    return pipe.device_step_flat(flat, args.batch, hb, wb)
                return pipe.device_step_flat(flat, args.batch, hb, wb,
                                             (meta.height, meta.width))

            # double-buffered: batch i+1 is dispatched before batch i's
            # results are fetched and drawn
            pending = None
            for batch, raw, n_valid in Prefetcher(batches(), depth=2):
                packed = dispatch(batch)
                if pending is not None:
                    annotate(*pending)
                pending = (packed, raw, n_valid)
            if pending is not None:
                annotate(*pending)
        writer.close()
    print(f"annotated {n_done} frames -> {out_path}")


if __name__ == "__main__":
    main()
