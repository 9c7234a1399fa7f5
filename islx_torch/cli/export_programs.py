"""Export serving warm-start artifacts (port of
``islx/cli/export_programs.py``).

    python -m islx_torch.cli.export_programs --out aot/ --batch 8 \
        --orig 480x640 --orig 720x1280 [--format bgr] [--target-h 184] \
        [--model-type body25] [--int8] [--hand-weights W] [--device cuda]

Each --orig HxW produces one artifact for (batch, bucket_for(H,W), H/W
scale factors): the pipeline's fingerprint and the kernel libraries one
step at that key loads, each under its content key
(:mod:`islx_torch.core.aot`). A serving host started with
``python -m islx_torch.cli.serve --aot-dir aot/ --max-batch 8`` installs
the libraries of matching artifacts and steps once at each key before it
serves, so its first request at those resolutions pays no compile, no
library load and no first cuDNN call.

The libraries depend only on the kernel sources and the pipeline's
config, never on weight values, so artifacts made here (random init)
serve real checkpoints of the same structure.
"""
from __future__ import annotations

import argparse
import os


def export(pipe, out: str, batch: int, origs, input_format: str = "bgr",
           target_h: int = 184) -> list:
    """One artifact in ``out`` for each original (H, W) in ``origs`` ->
    [(path, meta)]."""
    from islx_torch.core import aot
    from islx_torch.pipeline.batch_pose import bucket_for

    os.makedirs(out, exist_ok=True)
    written = []
    for h0, w0 in origs:
        hb, wb = bucket_for(h0, w0, target_h=target_h)
        key = pipe.program_key(batch, hb, wb, (h0, w0), input_format)
        path = os.path.join(out, aot.artifact_name(key))
        meta = aot.save_fused(pipe, path, batch, hb, wb, (h0, w0),
                              input_format)
        print(f"exported {path}  key={key}  platform={meta['platform']}")
        written.append((path, meta))
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--batch", type=int, default=8,
                   help="frames per device step (= serve --max-batch)")
    p.add_argument("--orig", action="append", required=True, metavar="HxW",
                   help="original frame resolution(s) to export, repeatable")
    p.add_argument("--format", default="bgr", choices=["bgr", "yuv420"])
    p.add_argument("--target-h", type=int, default=184)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--int8", action="store_true",
                   help="export for int8 (W8A8) CPMs: the random-init "
                        "states quantized on zero calibration frames (the "
                        "libraries do not depend on the scales)")
    p.add_argument("--hand-weights", default=None, metavar="W",
                   help="the checkpoint serving will run: its gates.json "
                        "verdict decides the exported hand resolution "
                        "(without it the ungated production default is "
                        "exported)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    origs = [tuple(int(v) for v in spec.lower().split("x"))
             for spec in args.orig]

    from islx_torch.cli import gated_hand_cfg
    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device
    from islx_torch.pipeline.batch_pose import FusedPosePipeline

    device = resolve_device(args.device)
    # the artifacts must match what serving will run: the same
    # gate-resolved hand config (gates.json beside the serving checkpoint,
    # or env) feeds both
    hcfg = gated_hand_cfg(args.hand_weights, log=print)
    bp, hp = W.init_params(args.model_type), W.init_params("hand")
    if args.int8:
        import numpy as np

        from islx_torch.models import quant

        hsize = int(np.rint(hcfg.scale_search[0] * hcfg.boxsize))
        cal = [np.zeros((1, args.target_h, args.target_h, 3), np.float32)]
        bp = quant.quantize_model(bp, args.model_type, cal, device=device)
        hp = quant.quantize_model(
            hp, "hand", [np.zeros((1, hsize, hsize, 3), np.float32)],
            device=device)
    pipe = FusedPosePipeline(bp, hp, args.model_type, hand_cfg=hcfg,
                             device=device)
    export(pipe, args.out, args.batch, origs, args.format, args.target_h)


if __name__ == "__main__":
    main()
