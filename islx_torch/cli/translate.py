"""ISL translation on the GPU: video -> rolling-window sign predictions
(port of islx/cli/translate.py; reference demo_isl_translate.py).

    python -m islx_torch.cli.translate VIDEO [--head H.keras|.h5|.npz]
        [--body-weights W] [--hand-weights W] [--bundle DIR|X.keras]
        [--batched --batch 16 [--mesh-data N]] [--camera] [--min-prob P]
        [--device cuda]

The default is the reference-exact per-frame path (``ISLTranslator``:
``Body`` + ``Hand`` on each frame, its features cached in the 20-frame
window). ``--batched`` runs the fused pipeline
(islx_torch.pipeline.translate), whose hand config follows the
per-checkpoint gate beside ``--hand-weights``; with both weight files
given, a recorded int8 GO (or ``ISLX_INT8=1``) quantizes both nets,
calibrated on the head of the clip and cached under ``<weights
dir>/.int8_cache`` (:func:`islx_torch.cli.gated_int8_params`), as islx
does; ``ISLX_INT8=0`` keeps bf16. Weights are islx ``.npz`` or reference
``.pt`` files; without them the nets run the port's seeded random init.
``--bundle`` loads a port bundle directory
(:func:`islx_torch.core.checkpoint.save_bundle`, written by
``islx_torch.cli.train --bundle``) or a one-model ``.keras``/``.h5``
artifact (:mod:`islx_torch.models.one_model`; ``--keras-bundle``, or
islx's): its body, hand and head in place of the separate files. Clips
are decoded with cv2, as is ``--camera``; ``.keras``/``.h5`` heads and
one-models are read with h5py. ``--mesh-data N`` shards each fused step
over N devices (:func:`islx_torch.cli.mesh_for`); it needs ``--batched``
and a ``--batch`` that N divides.
"""
from __future__ import annotations

import argparse
import os


def load_head(path):
    """A head checkpoint (.keras, .h5 or islx .npz) -> params; None for
    the seeded init."""
    from islx_torch.models import translator as T

    if path is None:
        return None
    if path.endswith((".keras", ".h5")):
        return T.load_keras(path)
    if path.endswith(".npz"):
        return T.load_npz(path)
    raise ValueError(f"unsupported head checkpoint: {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("video", nargs="?", default=None)
    p.add_argument("--camera", action="store_true",
                   help="read the webcam instead of a file (cv2)")
    p.add_argument("--head", default=None,
                   help="translator head checkpoint (.keras/.h5/.npz)")
    p.add_argument("--bundle", default=None,
                   help="a port translator bundle directory (islx_torch."
                        "cli.train --bundle) or a one-model .keras/.h5")
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--min-prob", type=float, default=0.0)
    p.add_argument("--batched", action="store_true",
                   help="the fused batched pipeline instead of the "
                        "reference-exact per-frame path")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--mesh-data", type=int, default=0, metavar="N",
                   help="shard each fused device step over N devices "
                        "(data-parallel mesh); requires --batched and "
                        "--batch divisible by N; 0 = one device")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh_data and not args.batched:
        p.error("--mesh-data requires --batched (the fused device pipeline)")
    if args.mesh_data and args.batch % args.mesh_data:
        p.error(f"--batch {args.batch} not divisible by "
                f"--mesh-data {args.mesh_data}")
    if not args.camera:
        if args.video is None:
            p.error("VIDEO is required unless --camera is given")
        if not os.path.exists(args.video):
            p.error(f"no such video: {args.video}")

    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device

    device = resolve_device(args.device)
    head_params = load_head(args.head)
    body_params = hand_params = None
    model_type = "body25"
    if args.bundle and args.bundle.endswith((".keras", ".h5")):
        from islx_torch.models import one_model

        model_type = one_model.model_type_of(args.bundle)
        body_params, hand_params, head_params = \
            one_model.import_one_model(args.bundle, model_type)
    elif args.bundle:
        from islx_torch.core import checkpoint as ckpt

        body_params, hand_params, head_params, model_type = \
            ckpt.load_bundle(args.bundle)

    def show(idx, cid, expr, prob):
        if prob >= args.min_prob:
            print(f"{idx} {prob:0.4f} {cid}-{expr}")

    if args.batched and not args.camera:
        from islx_torch.cli import gated_hand_cfg, gated_int8_params, mesh_for
        from islx_torch.pipeline.translate import BatchedTranslatePipeline

        bp = (body_params if body_params is not None
              else W.load(args.body_weights, "body25") if args.body_weights
              else None)
        hp = (hand_params if hand_params is not None
              else W.load(args.hand_weights, "hand") if args.hand_weights
              else None)
        hand_cfg = gated_hand_cfg(args.hand_weights, log=print)
        if bp is not None and hp is not None:
            # a recorded int8 GO -> W8A8 CPMs, calibrated on the head of
            # this clip (cached a checkpoint)
            bp, hp, _ = gated_int8_params(
                bp, hp, hand_weights=args.hand_weights,
                body_weights=args.body_weights, hand_cfg=hand_cfg,
                calib_clip=args.video, log=print, device=device)
        mesh = mesh_for(args.mesh_data, 1, device)
        pipe = BatchedTranslatePipeline(
            body_params=bp, hand_params=hp, head_params=head_params,
            hand_cfg=hand_cfg, batch=args.batch,
            device=None if mesh else device, mesh=mesh)
        for pred in pipe.translate_video(args.video):
            show(*pred)
        return

    from islx_torch.isl.translator import ISLTranslator
    from islx_torch.pose.body import Body
    from islx_torch.pose.hand import Hand

    translator = ISLTranslator(
        Body(body_params if body_params is not None else args.body_weights,
             model_type, device=device),
        Hand(hand_params if hand_params is not None else args.hand_weights,
             device=device), head_params)
    if args.camera:
        import cv2

        cap = cv2.VideoCapture(0)
        idx = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                probs = translator.push(frame)
                if probs is not None:
                    show(idx, *translator.top_expression(probs))
                idx += 1
        finally:
            cap.release()
        return

    from islx_torch.pipeline.video import FrameSource

    with FrameSource(args.video) as src:
        for pred in translator.translate_video_frames(src):
            show(*pred)


if __name__ == "__main__":
    main()
