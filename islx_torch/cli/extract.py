"""Dataset feature extraction on the GPU (port of islx/cli/extract.py;
reference extract_features*.py).

    python -m islx_torch.cli.extract CSV OUT_DIR [--shard-index I
        --num-shards N] [--body-weights W] [--hand-weights W] [--sticks]
        [--exact] [--batch 16] [--mesh-data N] [--device cuda]

The default runs the fused pose pipeline, ``--batch`` frames a step; the
hand config follows the per-checkpoint gate beside ``--hand-weights``, and
with both weight files given a recorded int8 GO (or ``ISLX_INT8=1``)
quantizes both nets, calibrated on the CSV's first readable video.
``--exact`` runs the reference-parity per-frame ``Body`` + ``Hand``.
Without weights the nets run the port's seeded random init.

Shard across processes by launching one a (I, N) pair. Without
``--shard-index``/``--num-shards`` they are the process's
``torch.distributed`` rank and world size when a process group is
initialised, else 0 and 1 (islx asks ``jax.process_index()`` and
``jax.process_count()``), as after a launcher's
:func:`islx_torch.parallel.mesh.init_distributed`. ``--mesh-data N`` shards
each fused step over N devices of this process (it composes with the
process sharding); it needs the fused path and a ``--batch`` that N
divides. Clips are decoded with cv2.
"""
from __future__ import annotations

import argparse
import csv
import os


def _first_video(csv_path: str, path_col: str):
    """The CSV's first existing video: the int8 calibration sample."""
    try:
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
    except OSError:
        return None
    for row in rows:
        p = row.get(path_col)
        if p and os.path.exists(p):
            return p
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("csv")
    p.add_argument("out_dir")
    p.add_argument("--shard-index", type=int, default=None,
                   help="default: the torch.distributed rank, else 0")
    p.add_argument("--num-shards", type=int, default=None,
                   help="default: the torch.distributed world size, else 1")
    p.add_argument("--body-weights", default=None)
    p.add_argument("--hand-weights", default=None)
    p.add_argument("--path-col", default="Filepath")
    p.add_argument("--sticks", action="store_true",
                   help="also write stick-figure JPGs per frame (cv2)")
    p.add_argument("--exact", action="store_true",
                   help="reference-parity per-frame path")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per fused step (default path)")
    p.add_argument("--mesh-data", type=int, default=0, metavar="N",
                   help="shard each fused device step over N devices "
                        "(data-parallel mesh; needs --batch divisible by "
                        "N; 0 = one device); composes with --shard-index/"
                        "--num-shards process sharding")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh_data and args.exact:
        p.error("--mesh-data requires the batched production path "
                "(drop --exact)")
    if args.mesh_data and args.batch % args.mesh_data:
        p.error(f"--batch {args.batch} not divisible by "
                f"--mesh-data {args.mesh_data}")

    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device
    from islx_torch.isl.extract import ExtractConfig, extract_dataset

    device = resolve_device(args.device)
    batch = None
    if args.exact:
        from islx_torch.isl.translator import ISLSignPos
        from islx_torch.pose.body import Body
        from islx_torch.pose.hand import Hand

        pose = ISLSignPos(Body(args.body_weights, "body25", device=device),
                          Hand(args.hand_weights, device=device))
    else:
        from islx_torch.cli import gated_hand_cfg, gated_int8_params, mesh_for
        from islx_torch.pipeline.batch_pose import FusedPosePipeline

        bp = (W.load(args.body_weights, "body25") if args.body_weights
              else W.init_params("body25"))
        hp = (W.load(args.hand_weights, "hand") if args.hand_weights
              else W.init_params("hand"))
        hand_cfg = gated_hand_cfg(args.hand_weights, log=print)
        if args.body_weights and args.hand_weights:
            # a recorded int8 GO beside the checkpoint -> W8A8 CPMs,
            # calibrated on the dataset's first readable video
            bp, hp, _ = gated_int8_params(
                bp, hp, hand_weights=args.hand_weights,
                body_weights=args.body_weights, hand_cfg=hand_cfg,
                calib_clip=_first_video(args.csv, args.path_col),
                log=print, device=device)
        mesh = mesh_for(args.mesh_data, 1, device)
        pose = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                                 device=None if mesh else device, mesh=mesh)
        batch = args.batch
    from islx_torch.parallel.mesh import process_rank

    rank, world = process_rank()
    shard_index = rank if args.shard_index is None else args.shard_index
    num_shards = world if args.num_shards is None else args.num_shards

    cfg = ExtractConfig(out_root=args.out_dir, write_sticks=args.sticks)
    out = extract_dataset(cfg, pose, args.csv, shard_index, num_shards,
                          args.path_col, batch=batch)
    print(f"shard {shard_index}/{num_shards} -> {out}")


if __name__ == "__main__":
    main()
