"""Train the ISL translator head on extracted features (port of
islx/cli/train.py).

    extract   (islx_torch.cli.extract) -> FEATURES_ROOT/<video_id>/<frame>.json
    train     (this CLI)               -> head .npz (+ optional bundles)
    translate (islx_torch.cli.translate --head H.npz | --bundle DIR|X.keras)

    python -m islx_torch.cli.train FEATURES_ROOT --labels LABELS.csv
           --out HEAD.npz [--epochs 20] [--batch 32] [--lr 1e-3] [--seed 0]
           [--checkpoint-dir DIR] [--bundle DIR] [--keras-bundle X.keras]
           [--body-weights W --hand-weights W]
           [--mesh-data N [--mesh-model M]] [--device cuda]

LABELS.csv: columns ``video_id,expression`` (an expression name from
islx_torch.isl.expressions, any case). Training is checkpointed every
epoch and resumes from --checkpoint-dir on restart. The head ``.npz`` is
islx's format (islx's ``load_npz`` reads it). A bundle holds the body and
hand weights given (the port's seeded init without them) and the head:
a port bundle directory, or a one-model ``.keras`` artifact
(:mod:`islx_torch.models.one_model`, which islx and stock keras load).
``--mesh-data N --mesh-model M`` trains data- and tensor-parallel on an
(N, M) mesh (:func:`islx_torch.cli.mesh_for`; islx_torch.isl.train); the
result equals the one-device run's within float rounding.
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
                   help="also export a portable one-model .keras artifact "
                        "(islx_torch.models.one_model)")
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh axis (0 = no mesh, one device)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis for the head kernels")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from islx_torch.cli import mesh_for
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

    mesh = mesh_for(args.mesh_data, args.mesh_model, device)
    params = TR.fit(x, y, epochs=args.epochs, batch_size=args.batch,
                    lr=args.lr, cfg=cfg, seed=args.seed,
                    checkpoint_dir=args.checkpoint_dir,
                    device=None if mesh else device, mesh=mesh)
    T.save_npz(args.out, params)
    print(f"head -> {args.out}")

    if args.bundle or args.keras_bundle:
        from islx_torch.core import weights as W

        body = (W.load(args.body_weights, args.model_type)
                if args.body_weights else W.init_params(args.model_type))
        hand = (W.load(args.hand_weights, "hand") if args.hand_weights
                else W.init_params("hand"))
        if args.bundle:
            from islx_torch.core import checkpoint as ckpt

            ckpt.save_bundle(args.bundle, body, hand, params,
                             args.model_type)
            print(f"bundle -> {args.bundle}")
        if args.keras_bundle:
            from islx_torch.models import one_model

            one_model.export_one_model(body, hand, params,
                                       args.keras_bundle,
                                       model_type=args.model_type, cfg=cfg)
            print(f"keras one-model -> {args.keras_bundle}")


if __name__ == "__main__":
    main()
