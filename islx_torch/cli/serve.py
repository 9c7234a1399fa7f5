"""Pose serving daemon on the GPU: an HTTP endpoint over the fused step.

    python -m islx_torch.cli.serve [--host 127.0.0.1] [--port 8008]
        [--body-weights W] [--hand-weights W] [--model-type body25|coco]
        [--max-batch 8] [--max-wait-ms 15] [--int8-after N]
        [--mesh-data N] [--device cuda]

    curl -s -X POST --data-binary @image.jpg localhost:8008/pose
    curl -s localhost:8008/healthz

Concurrent requests micro-batch into shared fused steps
(:mod:`islx_torch.serve`). The hand config follows the checkpoint's gate
(``gates.json`` beside ``--hand-weights``). ``--int8-after N`` calibrates
on the first N served frames and swaps in int8 W8A8 CPMs; without it, a
recorded int8 GO, or ``ISLX_INT8=1`` with or without ``--hand-weights``,
gives ``--int8-after 256`` (``ISLX_INT8=0`` keeps bf16). Decoding POST
bodies, and resizing frames that are not at their bucket's size, needs
cv2. Without weights the nets run the port's seeded random init.
``--mesh-data N`` shards each served batch over N devices (a data-parallel
mesh of the first N visible GPUs; ``--max-batch`` must divide by N); the
int8 swap builds its pipeline on the same mesh.
"""
from __future__ import annotations

import argparse
import os


def int8_after_for(int8_after, hand_weights, log=None):
    """The swap threshold the server runs with: an explicit
    ``--int8-after`` wins; else 256 where :func:`int8_gated` says GO.
    ``ISLX_INT8`` always decides when it is set, with or without
    ``--hand-weights``; with neither, no verdict is borrowed (bf16)."""
    from islx_torch.core.config import int8_gated

    def _log(msg):
        if log is not None:
            log(msg)

    if int8_after is not None:
        return int8_after
    if hand_weights is None and os.environ.get("ISLX_INT8") is None:
        _log("int8: bf16 (no --hand-weights: the int8 verdict travels "
             "with checkpoints)")
        return None
    go, note = int8_gated(os.path.dirname(os.path.abspath(hand_weights))
                          if hand_weights is not None else None)
    if go:
        _log(f"int8: {note} -> --int8-after 256 (live-traffic calibration "
             f"and warm swap)")
        return 256
    _log(f"int8: {note}")
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco"])
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=15.0)
    p.add_argument("--int8-after", type=int, default=None, metavar="N",
                   help="after N served frames, calibrate on the live "
                        "traffic and swap in int8 (W8A8) CPMs")
    p.add_argument("--mesh-data", type=int, default=0, metavar="N",
                   help="shard each served micro-batch over N devices "
                        "(data-parallel mesh; needs --max-batch divisible "
                        "by N; 0 = one device)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh_data and args.max_batch % args.mesh_data:
        p.error(f"--max-batch {args.max_batch} not divisible by "
                f"--mesh-data {args.mesh_data}")

    from islx_torch.cli import gated_hand_cfg, mesh_for
    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.serve import PoseServer

    device = resolve_device(args.device)
    mesh = mesh_for(args.mesh_data, 1, device)
    hand_cfg = gated_hand_cfg(args.hand_weights, log=print)
    int8_after = int8_after_for(args.int8_after, args.hand_weights,
                                log=print)
    pipe = FusedPosePipeline(
        (W.load(args.body_weights, args.model_type) if args.body_weights
         else W.init_params(args.model_type)),
        (W.load(args.hand_weights, "hand") if args.hand_weights
         else W.init_params("hand")),
        args.model_type, hand_cfg=hand_cfg,
        device=None if mesh else device, mesh=mesh)
    server = PoseServer(pipe, args.host, args.port,
                        max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        quantize_after=int8_after)
    print(f"serving on http://{args.host}:{server.port}  "
          f"(POST /pose, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()
