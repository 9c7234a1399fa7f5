"""ISL translation on the GPU: video -> rolling-window sign predictions.

    python -m islx_torch.cli.translate VIDEO [--batch 16]
        [--body-weights W] [--hand-weights W] [--head H.npz] [--device cuda]

The batched fused pipeline (islx_torch.pipeline.translate). Weights are
islx ``.npz`` or reference ``.pt`` files; without them the nets run the
port's seeded random init. The hand config follows the per-checkpoint gate
(``gates.json`` beside ``--hand-weights``); a recorded int8 GO, or
``ISLX_INT8=1``, quantizes both nets to int8 W8A8, calibrated on the head
of the clip and cached under ``<weights dir>/.int8_cache``
(:func:`islx_torch.cli.gated_int8_params`); ``ISLX_INT8=0`` keeps bf16.
"""
from __future__ import annotations

import argparse
import os


def gated_hand_cfg(hand_weights=None, log=None):
    """The hand config of the checkpoint's recorded gate verdicts; the
    ungated production default when no weights are given (a verdict
    travels with the checkpoint it was recorded on)."""
    from islx_torch.core.config import HandConfig

    if hand_weights is None:
        cfg, note = HandConfig.production(), "production default"
    else:
        cfg, note = HandConfig.gated(
            os.path.dirname(os.path.abspath(hand_weights)))
    if log is not None:
        log(f"hand config: {note}")
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("video")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--head", default=None,
                   help="translator head checkpoint (islx .npz)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--min-prob", type=float, default=0.0)
    args = p.parse_args(argv)
    if not os.path.exists(args.video):
        p.error(f"no such video: {args.video}")

    from islx_torch.cli import gated_int8_params
    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device
    from islx_torch.models import translator as T
    from islx_torch.pipeline.translate import BatchedTranslatePipeline

    device = resolve_device(args.device)
    hand_cfg = gated_hand_cfg(args.hand_weights, log=print)
    bp, hp, _ = gated_int8_params(
        (W.load(args.body_weights, "body25") if args.body_weights
         else W.init_params("body25")),
        (W.load(args.hand_weights, "hand") if args.hand_weights
         else W.init_params("hand")),
        hand_weights=args.hand_weights, body_weights=args.body_weights,
        hand_cfg=hand_cfg, calib_clip=args.video, log=print, device=device)
    pipe = BatchedTranslatePipeline(
        body_params=bp, hand_params=hp,
        head_params=T.load_npz(args.head) if args.head else None,
        hand_cfg=hand_cfg, batch=args.batch, device=device)
    for idx, cid, expr, prob in pipe.translate_video(args.video):
        if prob >= args.min_prob:
            print(f"{idx} {prob:0.4f} {cid}-{expr}")


if __name__ == "__main__":
    main()
