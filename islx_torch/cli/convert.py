"""Weight conversion CLI (port of islx/cli/convert.py; reference
caffemodel2pytorch + model_converter.py).

    python -m islx_torch.cli.convert SRC DST --model-type body25|coco|hand
           [--to-keras]

SRC: ``.caffemodel`` (parsed natively, no protoc:
     :mod:`islx_torch.core.caffe_reader`), ``.pt``/``.pth`` (the reference
     converter's output or a torch state_dict), ``.npz``, or a state file
     of :func:`islx_torch.core.weights.save_state`.
DST: ``.npz`` (islx's flat weight file, which islx's ``weights.load``
     reads too), or with ``--to-keras`` a ``.keras`` model built from the
     same spec tables as the port's forward
     (:mod:`islx_torch.models.keras_export`, written without keras).

A host-side tool: it runs no net and takes no device. The parameter count
is checked against the port's conv table (``cpm.param_count``).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from islx_torch.core import weights as W
    from islx_torch.models import cpm

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--model-type", required=True,
                   choices=["body25", "coco", "hand"])
    p.add_argument("--to-keras", action="store_true",
                   help="write a runnable .keras model instead of .npz")
    args = p.parse_args(argv)

    state = W.load(args.src, args.model_type)
    if any("w" not in e for e in state.values()):
        p.error(f"{args.src} holds int8 layers; convert float weights")
    n = sum(v.numel() for e in state.values() for v in e.values())
    expected = cpm.param_count(args.model_type)
    if n != expected:
        raise SystemExit(f"param count {n} != expected {expected}")
    if args.to_keras:
        from islx_torch.models.keras_export import export_keras

        export_keras(state, args.model_type, args.dst)
    else:
        W.save_npz(args.dst, state)
    print(f"{args.src} -> {args.dst} ({n:,} params, verified)")


if __name__ == "__main__":
    main()
