"""Single-image demo: body pose + hand pose + rendering (port of
``islx/cli/demo.py``; reference demo.py / demo_batch.py).

    python -m islx_torch.cli.demo IMAGE [IMAGE ...] [--body-weights W]
           [--hand-weights W] [--model-type body25|coco] [--out OUT.png]
           [--exact] [--device cuda|cpu]

Default: :class:`islx_torch.pipeline.image.ImagePose` (the batched
pipelines, <= 1 px from the parity path), int8 W8A8 CPMs calibrated on the
image itself where the checkpoint's gate says GO. ``--exact``: the
reference-parity per-image path (``ISLSignPos(Body, Hand)``). Without
weights the nets run seeded random init. cv2 reads and writes the images.
"""
from __future__ import annotations

import argparse
import glob
import os


def build_pose(args, calib_image=None):
    """The pose callable the flags ask for: ImagePose (int8 through the
    gate when both weights are given) or, with ``--exact``, ISLSignPos."""
    if not args.exact:
        from islx_torch.cli import gated_hand_cfg, gated_int8_params
        from islx_torch.core import weights as W
        from islx_torch.pipeline.image import ImagePose

        bp = (W.load(args.body_weights, args.model_type)
              if args.body_weights else None)
        hp = W.load(args.hand_weights, "hand") if args.hand_weights else None
        hand_cfg = gated_hand_cfg(args.hand_weights, log=print)
        if bp is not None and hp is not None and calib_image is not None:
            # a recorded int8 GO (gates.json) -> W8A8 CPMs, calibrated on
            # the demo image itself (cached a checkpoint)
            bp, hp, _ = gated_int8_params(
                bp, hp, model_type=args.model_type,
                hand_weights=args.hand_weights,
                body_weights=args.body_weights, hand_cfg=hand_cfg,
                calib_image=calib_image, log=print, device=args.device)
        return ImagePose(bp, hp, args.model_type, hand_cfg=hand_cfg,
                         device=args.device)
    from islx_torch.isl.translator import ISLSignPos
    from islx_torch.pose.body import Body
    from islx_torch.pose.hand import Hand

    return ISLSignPos(Body(args.body_weights, args.model_type,
                           device=args.device),
                      Hand(args.hand_weights, device=args.device))


def process_image(pose, img, model_type: str):
    """-> (annotated canvas, (candidate, subset, hands))."""
    from islx_torch.utils import draw

    candidate, subset, hands = pose(img)
    canvas = draw.draw_bodypose(img, candidate, subset, model_type)
    return draw.draw_handpose(canvas, hands), (candidate, subset, hands)


def main(argv=None):
    import cv2

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", nargs="+", help="image path(s) or glob")
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--out", default=None,
                   help="output path (single image) or directory")
    p.add_argument("--exact", action="store_true",
                   help="reference-parity per-image path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    paths = []
    for pat in args.images:
        paths.extend(sorted(glob.glob(pat)) or [pat])
    # read every input before building the nets
    readable = {path: cv2.imread(path) for path in paths}
    for path, img in readable.items():
        if img is None:
            print(f"cannot read {path}")
    if all(img is None for img in readable.values()):
        raise SystemExit(1)
    pose = build_pose(args, calib_image=next(
        (img for img in readable.values() if img is not None), None))
    for path in paths:
        img = readable[path]
        if img is None:
            continue
        canvas, (candidate, subset, hands) = process_image(
            pose, img, args.model_type)
        if args.out and len(paths) == 1 and not os.path.isdir(args.out):
            out = args.out
        else:
            stem = os.path.splitext(os.path.basename(path))[0]
            out_dir = args.out if args.out else os.path.dirname(path) or "."
            os.makedirs(out_dir, exist_ok=True)
            out = os.path.join(out_dir, f"result_{stem}_{args.model_type}.png")
        cv2.imwrite(out, canvas)
        print(f"{path}: {len(subset)} people, {len(hands)} hands -> {out}")


if __name__ == "__main__":
    main()
