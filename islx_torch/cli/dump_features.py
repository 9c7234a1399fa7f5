"""Single-frame feature dump, the pose -> feature debugging tool (port of
``islx/cli/dump_features.py``; reference ISL_model_xy.py:29-226).

Runs the pose composite on ONE frame, writes the geometry (circles, sticks,
hand edges and peaks) as JSON, the 156-d feature vector with
``np.savetxt`` (the reference's format) and the stick-model render.

    python -m islx_torch.cli.dump_features INPUT --out-dir DIR [--frame N]
           [--body-weights W] [--hand-weights W] [--model-type body25|coco]
           [--exact] [--device cuda|cpu]

INPUT: an image, or a video (``--frame N`` picks the frame, default 0).
Writes DIR/features.txt, DIR/pose.json, DIR/sticks.jpg, DIR/annotated.jpg.
cv2 reads the input and writes the images.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _load_frame(path: str, frame_idx: int) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is not None:
        return img
    cap = cv2.VideoCapture(path)
    try:
        if frame_idx:
            cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
        ok, frame = cap.read()
        if not ok:
            raise SystemExit(f"cannot read frame {frame_idx} of {path}")
        return frame
    finally:
        cap.release()


def main(argv=None):
    import cv2

    from islx_torch.isl import features as F
    from islx_torch.utils import draw

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--exact", action="store_true",
                   help="reference-parity per-frame path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    frame = _load_frame(args.input, args.frame)
    if args.exact:
        from islx_torch.isl.translator import ISLSignPos
        from islx_torch.pose.body import Body
        from islx_torch.pose.hand import Hand

        pose = ISLSignPos(Body(args.body_weights, args.model_type,
                               device=args.device),
                          Hand(args.hand_weights, device=args.device))
    else:
        from islx_torch.core import weights as W
        from islx_torch.pipeline.image import ImagePose

        pose = ImagePose(
            W.load(args.body_weights, args.model_type)
            if args.body_weights else None,
            W.load(args.hand_weights, "hand") if args.hand_weights else None,
            model_type=args.model_type, device=args.device)

    candidate, subset, all_hand_peaks = pose(frame)
    circles, sticks = F.get_bodypose(candidate, subset, args.model_type)
    edges, peaks = F.get_handpose(all_hand_peaks)
    feats = F.populate_features(circles, peaks)

    os.makedirs(args.out_dir, exist_ok=True)
    np.savetxt(os.path.join(args.out_dir, "features.txt"), feats)
    # geometry JSON in the reference's extract_features.py:79-84 schema
    with open(os.path.join(args.out_dir, "pose.json"), "w") as f:
        json.dump({
            "candidate": np.asarray(candidate).tolist(),
            "subset": np.asarray(subset).tolist(),
            "all_hand_peaks": [np.asarray(h).tolist()
                               for h in all_hand_peaks],
            "bodypose": {"circles": circles, "sticks": sticks},
            "handpose": {"edges": [[(int(ie), (float(x1), float(y1)),
                                     (float(x2), float(y2)))
                                    for ie, (x1, y1), (x2, y2) in hand]
                                   for hand in edges],
                         "peaks": [[(float(x), float(y), s)
                                    for x, y, s in hp] for hp in peaks]},
        }, f, indent=1)
    sticks_canvas = draw.draw_stick_model(frame, circles, sticks, edges, peaks)
    cv2.imwrite(os.path.join(args.out_dir, "sticks.jpg"),
                draw.crop_to_drawing(sticks_canvas))
    canvas = draw.draw_bodypose(frame.copy(), candidate, subset,
                                args.model_type)
    canvas = draw.draw_handpose(canvas, all_hand_peaks)
    cv2.imwrite(os.path.join(args.out_dir, "annotated.jpg"), canvas)

    nz = int(np.count_nonzero(feats))
    print(f"{args.input} frame {args.frame}: feature[{feats.shape[0]}] "
          f"({nz} nonzero) -> {args.out_dir}")


if __name__ == "__main__":
    main()
