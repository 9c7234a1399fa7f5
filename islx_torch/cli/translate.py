"""ISL translation on the GPU: video -> rolling-window sign predictions.

    python -m islx_torch.cli.translate VIDEO [--batch 16]
        [--body-weights W] [--hand-weights W] [--head H.npz] [--device cuda]

The batched fused pipeline (islx_torch.pipeline.translate). Weights are
islx ``.npz`` or reference ``.pt`` files; without them the nets run the
port's seeded random init. The hand config follows the per-checkpoint gate
(``gates.json`` beside ``--hand-weights``); a recorded int8 GO, or
``ISLX_INT8=1``, is refused: the int8 trunks are a later slice.
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


def refuse_gated_int8(hand_weights=None) -> None:
    """Raise where the checkpoint's gate (or ISLX_INT8) asks for int8."""
    from islx_torch.core.config import int8_gated
    from islx_torch.core.runtime import INT8_SLICE, refuse_int8

    refuse_int8()
    if hand_weights is not None:
        go, note = int8_gated(os.path.dirname(os.path.abspath(hand_weights)))
        if go:
            raise NotImplementedError(f"{note}: {INT8_SLICE}")


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

    from islx_torch.core import weights as W
    from islx_torch.models import translator as T
    from islx_torch.pipeline.translate import BatchedTranslatePipeline

    refuse_gated_int8(args.hand_weights)
    pipe = BatchedTranslatePipeline(
        body_params=(W.load(args.body_weights, "body25")
                     if args.body_weights else None),
        hand_params=(W.load(args.hand_weights, "hand")
                     if args.hand_weights else None),
        head_params=T.load_npz(args.head) if args.head else None,
        hand_cfg=gated_hand_cfg(args.hand_weights, log=print),
        batch=args.batch, device=args.device)
    for idx, cid, expr, prob in pipe.translate_video(args.video):
        if prob >= args.min_prob:
            print(f"{idx} {prob:0.4f} {cid}-{expr}")


if __name__ == "__main__":
    main()
