"""Train the ISL translator head on extracted features (port of
islx/cli/train.py).

    extract   (islx_torch.cli.extract) -> FEATURES_ROOT/<video_id>/<frame>.json
    train     (this CLI)               -> head .npz (+ optional bundle)
    translate (islx_torch.cli.translate --head H.npz | --bundle DIR)

    python -m islx_torch.cli.train FEATURES_ROOT --labels LABELS.csv
           --out HEAD.npz [--epochs 20] [--batch 32] [--lr 1e-3] [--seed 0]
           [--checkpoint-dir DIR] [--bundle DIR --body-weights W
           --hand-weights W] [--device cuda]

LABELS.csv: columns ``video_id,expression`` (an expression name from
islx_torch.isl.expressions, any case). Training is checkpointed every
epoch and resumes from --checkpoint-dir on restart. The head ``.npz`` is
islx's format (islx's ``load_npz`` reads it). A bundle holds the body and
hand weights given (the port's seeded init without them) and the head.
"""
from __future__ import annotations

import argparse
import csv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("features_root")
    p.add_argument("--labels", required=True,
                   help="CSV with video_id,expression columns")
    p.add_argument("--out", required=True, help="head checkpoint (.npz)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-epoch training-state checkpoints (resume)")
    p.add_argument("--bundle", default=None,
                   help="also save a translator bundle to this directory")
    p.add_argument("--keras-bundle", default=None,
                   help="not ported: the .keras one-model export waits for "
                        "ROADMAP.md §1 item 7")
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--mesh-data", type=int, default=0,
                   help="not ported: multi-device waits for ROADMAP.md §1 "
                        "item 8")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="not ported: multi-device waits for ROADMAP.md §1 "
                        "item 8")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.keras_bundle:
        p.error("--keras-bundle is not ported yet (the one-model export, "
                "ROADMAP.md §1 item 7)")
    if args.mesh_data or args.mesh_model != 1:
        p.error("--mesh-data/--mesh-model are not ported yet (multi-device, "
                "ROADMAP.md §1 item 8)")

    from islx_torch.core.config import TranslatorConfig
    from islx_torch.core.runtime import resolve_device
    from islx_torch.isl import dataset as D
    from islx_torch.isl import train as TR
    from islx_torch.models import translator as T

    device = resolve_device(args.device)
    labels = {}
    with open(args.labels, newline="") as f:
        for row in csv.DictReader(f):
            labels[row["video_id"]] = row["expression"]

    cfg = TranslatorConfig()
    x, y = D.build_windows(args.features_root, labels, cfg, args.model_type)
    if x.shape[0] == 0:
        raise SystemExit("no training windows: check features_root/labels")
    print(f"{x.shape[0]} windows of [{cfg.window_size},{cfg.feature_dim}] "
          f"over {len(set(y.tolist()))} classes")

    params = TR.fit(x, y, epochs=args.epochs, batch_size=args.batch,
                    lr=args.lr, cfg=cfg, seed=args.seed,
                    checkpoint_dir=args.checkpoint_dir, device=device)
    T.save_npz(args.out, params)
    print(f"head -> {args.out}")

    if args.bundle:
        from islx_torch.core import checkpoint as ckpt
        from islx_torch.core import weights as W

        body = (W.load(args.body_weights, args.model_type)
                if args.body_weights else W.init_params(args.model_type))
        hand = (W.load(args.hand_weights, "hand") if args.hand_weights
                else W.init_params("hand"))
        ckpt.save_bundle(args.bundle, body, hand, params, args.model_type)
        print(f"bundle -> {args.bundle}")


if __name__ == "__main__":
    main()
