"""Annotated live camera demo (port of ``islx/cli/camera.py``; reference
demo_camera.py:1-49).

Reads frames from a camera or a video, runs body pose + hand detection +
hand pose through :class:`islx_torch.pipeline.image.ImagePose`, draws the
skeleton overlay and shows it in a window (``q`` quits). With ``--out``, or
with no display, annotated frames are written to a video instead;
``--source`` takes a camera index or a video path. cv2 reads the frames.

    python -m islx_torch.cli.camera [--source 0] [--width 640]
           [--height 480] [--out out.mp4] [--max-frames N]
           [--multi-person] [--no-window] [--model-type body25|coco]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _has_display() -> bool:
    if sys.platform.startswith("linux"):
        return bool(os.environ.get("DISPLAY")
                    or os.environ.get("WAYLAND_DISPLAY"))
    return True


def open_capture(source: str, width: int, height: int):
    """cv2.VideoCapture from a camera index or a video path (the reference
    uses index 0 at 640x480)."""
    import cv2

    if source.isdigit():
        cap = cv2.VideoCapture(int(source))
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
    else:
        cap = cv2.VideoCapture(source)
    return cap


def annotate(frame: np.ndarray, pose, model_type: str) -> np.ndarray:
    """One frame -> its annotated canvas (body skeleton, hand edges and
    keypoints)."""
    from islx_torch.utils import draw

    candidate, subset, all_hand_peaks = pose(frame)
    canvas = draw.draw_bodypose(frame.copy(), candidate, subset, model_type)
    return draw.draw_handpose(canvas, all_hand_peaks)


def main(argv=None):
    import cv2

    from islx_torch.cli import gated_hand_cfg
    from islx_torch.core import weights as W
    from islx_torch.pipeline.image import ImagePose

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", default="0",
                   help="camera index (default 0) or video path")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--out", default=None,
                   help="write annotated frames to this video instead of "
                        "(or besides) showing a window")
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = until q / stream end)")
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--no-window", action="store_true")
    p.add_argument("--multi-person", action="store_true",
                   help="host hand boxes from grouped skeletons (up to 4 "
                        "hands; default: the fused step, one crop per arm "
                        "side)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    body_params = (W.load(args.body_weights, args.model_type)
                   if args.body_weights else None)
    hand_params = (W.load(args.hand_weights, "hand")
                   if args.hand_weights else None)
    pose = ImagePose(body_params, hand_params, args.model_type,
                     fused=not args.multi_person,
                     hand_cfg=gated_hand_cfg(args.hand_weights, log=print),
                     device=args.device)

    cap = open_capture(args.source, args.width, args.height)
    if not cap.isOpened():
        raise SystemExit(f"cannot open capture source {args.source!r}")
    show = _has_display() and not args.no_window
    writer = None
    n_done = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            canvas = annotate(frame, pose, args.model_type)
            if args.out:
                if writer is None:
                    from islx_torch.pipeline.video import FrameWriter

                    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                    writer = FrameWriter(args.out, fps, canvas.shape[:2])
                writer(canvas)
            if show:
                cv2.imshow("islx camera", canvas)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            n_done += 1
            if args.max_frames and n_done >= args.max_frames:
                break
    finally:
        cap.release()
        if writer is not None:
            writer.close()
        if show:
            cv2.destroyAllWindows()
    print(f"annotated {n_done} frames -> {args.out or 'window'}")


if __name__ == "__main__":
    main()
