"""Fine-tune CPM pose nets on keypoint-annotated samples (port of
islx/cli/pose_train.py).

    python -m islx_torch.cli.pose_train DATA_DIR --model-type body25|hand
           --out W.npz [--init W0.npz|.pt|.caffemodel] [--epochs 5]
           [--batch 8] [--lr 1e-4] [--size 184] [--seed 0]
           [--compute-dtype f32|bf16] [--mesh-data N | --pipeline N]
           [--device cuda]

Sample format, one .npz per image:
    image      u8  [H,W,3] BGR
    keypoints  f32 [P,J,2] (x,y) input-pixel coords (P people; [J,2] ok)
    visible    bool [P,J] (or [J])

Images are resized to ``--size`` with cv2's ``INTER_CUBIC`` as islx does
(an image already ``size x size`` is used as it is: a same-size
``cv2.resize`` is an exact copy). Targets come from
islx_torch.models.pose_train.pose_targets: gaussian joint heatmaps
(max-combined across people, background channel last) and, for BODY_25,
unit-vector PAFs in the net's MAP_IDX layout. The output is islx's flat
``.npz`` (islx's ``weights.load`` reads it). Without ``--init`` training
starts from the port's seeded init (not islx's: JAX's bits are not
reproduced).

Parallelism: ``--mesh-data N`` splits each batch over N devices
(:func:`islx_torch.cli.mesh_for`; the loss and gradients are the global
batch's); ``--pipeline N`` splits the net's stages over N devices
(:class:`islx_torch.parallel.pipeline.PipelinedCPM`, GPipe microbatches,
one Adam a segment). They are exclusive; ``--pipeline`` needs N GPUs
(on the CPU, N copies of the CPU device).
"""
from __future__ import annotations

import argparse
import glob
import os


def _resize(img, size: int):
    """``img`` at ``size x size`` by cv2's INTER_CUBIC, as islx resizes;
    raises without cv2 (another resize gives other pixels)."""
    if img.shape[:2] == (size, size):
        return img
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"a {img.shape[1]}x{img.shape[0]} sample needs a resize to "
            f"{size}x{size} with cv2's INTER_CUBIC, as islx's does, and cv2 "
            f"is not installed") from e
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)


def load_samples(data_dir: str, size: int, model_type: str):
    """(x [N,size,size,3] f32 normalized, heat_t, paf_t|zeros) from npz dir."""
    import numpy as np

    from islx_torch.models import pose_train as PT

    paths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not paths:
        raise SystemExit(f"no .npz samples under {data_dir}")
    h8 = w8 = size // 8
    xs, heats, pafs = [], [], []
    for p in paths:
        with np.load(p) as d:
            img, kp = d["image"], np.asarray(d["keypoints"], np.float32)
            vis = np.asarray(d["visible"], bool)
        if kp.ndim == 2:
            kp, vis = kp[None], vis[None]
        sy, sx = size / img.shape[0], size / img.shape[1]
        img = _resize(img, size)
        kp = kp * np.array([sx, sy], np.float32)
        heat, paf = PT.pose_targets(kp, vis, h8, w8, model_type)
        xs.append(img.astype(np.float32) / 256.0 - 0.5)
        heats.append(heat)
        pafs.append(paf if paf is not None
                    else np.zeros((h8, w8, 0), np.float32))
    return np.stack(xs), np.stack(heats), np.stack(pafs)


def _epoch_order(n: int, b: int, seed: int, log=None):
    """Per-epoch sample permutation. With n % b != 0 a fixed order would
    drop the SAME tail samples every epoch (e.g. 9 samples at --batch 8
    never train sample 9); shuffling rotates the dropped tail across
    epochs and the note makes it visible."""
    import numpy as np

    if log is not None and n % b:
        log(f"note: {n} samples % batch {b} leaves {n % b}/epoch out; "
            "per-epoch shuffling rotates which ones")
    return np.random.RandomState(seed).permutation(n)


def _pipeline_devices(n: int, device):
    """The devices of ``--pipeline N``: the first N GPUs, or N copies of
    the CPU device; fewer GPUs than N exit with a message."""
    import torch

    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--pipeline {n} but only "
                         f"{torch.cuda.device_count()} devices visible")
    return [torch.device("cuda", i) for i in range(n)]


def _train_pipeline(params, x, heat_t, paf_t, args, log):
    """GPipe path: each segment's weights on its own device, one Adam a
    segment; PipelinedCPM.grads is the full-batch gradient."""
    import torch

    from islx_torch.core.runtime import resolve_device
    from islx_torch.models import pose_train as PT
    from islx_torch.parallel.pipeline import PipelinedCPM

    devices = _pipeline_devices(args.pipeline,
                                resolve_device(getattr(args, "device", None)))
    dt = torch.bfloat16 if args.compute_dtype == "bf16" else torch.float32
    pipe = PipelinedCPM(params, args.model_type, devices, dt)
    opts = [PT.make_optimizer(seg["net"].parameters(), args.lr)
            for seg in pipe.segments]
    n = x.shape[0]
    b = min(args.batch, n)
    xt = torch.from_numpy(x).to(devices[0])
    targets = ((torch.from_numpy(heat_t),) if args.model_type == "hand"
               else (torch.from_numpy(paf_t), torch.from_numpy(heat_t)))
    loss = None
    for ep in range(args.epochs):
        order = _epoch_order(n, b, getattr(args, "seed", 0) + ep,
                             log if ep == 0 else None)
        for i0 in range(0, n - b + 1, b):
            sl = torch.from_numpy(order[i0:i0 + b])
            loss, _ = pipe.grads(xt[sl.to(devices[0])],
                                 tuple(t[sl] for t in targets))
            for opt in opts:        # grads() left the averaged gradients
                opt.step()
        log(f"epoch {ep} loss {float(loss):.5f} "
            f"({args.pipeline} pipeline segments)")
    return pipe.state()


def _train_flat(params, x, heat_t, paf_t, args, log, on_step=None):
    """One device or a data-parallel mesh (pose_train.make_train_step) ->
    the trained weight state. ``args`` carries model_type, epochs, batch,
    lr, compute_dtype, seed, device and mesh_data; ``on_step(metrics)``
    sees each step's metrics."""
    import torch

    from islx_torch.cli import mesh_for
    from islx_torch.core.runtime import resolve_device
    from islx_torch.models import pose_train as PT

    dev = resolve_device(getattr(args, "device", None))
    mesh = mesh_for(getattr(args, "mesh_data", 0), 1, dev)
    if mesh is not None:
        dev = mesh.first
    dt = torch.bfloat16 if args.compute_dtype == "bf16" else torch.float32
    state = PT.init_state(args.model_type, args.lr, params, device=dev)
    step = PT.make_train_step(state, args.model_type, dt, mesh=mesh)
    xt, ht, pt = (torch.from_numpy(a).to(dev) for a in (x, heat_t, paf_t))
    n = x.shape[0]
    b = min(args.batch, n)
    metrics = None
    for ep in range(args.epochs):
        order = _epoch_order(n, b, getattr(args, "seed", 0) + ep,
                             log if ep == 0 else None)
        for i0 in range(0, n - b + 1, b):
            sl = torch.from_numpy(order[i0:i0 + b]).to(dev)
            metrics = step(xt[sl], ht[sl], pt[sl])
            if on_step is not None:
                on_step(metrics)
        log(f"epoch {ep} loss {float(metrics['loss']):.5f}"
            + (f" (mesh data={args.mesh_data})" if mesh else ""))
    return state.net.state()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("data_dir")
    p.add_argument("--model-type", default="body25",
                   choices=["body25", "coco", "hand"])
    p.add_argument("--out", required=True, help="output checkpoint (.npz)")
    p.add_argument("--init", default=None,
                   help="starting weights (.npz/.pt/.caffemodel; default: "
                        "fresh init)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--size", type=int, default=184,
                   help="training resolution (multiple of 8)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh axis (0 = no mesh)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="GPipe pipeline-parallel over N devices "
                        "(0 = no pipeline; exclusive with --mesh-data)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.size % 8:
        p.error("--size must be a multiple of 8")
    if args.pipeline and args.mesh_data:
        p.error("--pipeline and --mesh-data are exclusive")

    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device

    resolve_device(args.device)
    x, heat_t, paf_t = load_samples(args.data_dir, args.size,
                                    args.model_type)
    print(f"{x.shape[0]} samples at {args.size}px")
    params = (W.load(args.init, args.model_type) if args.init
              else W.init_params(args.model_type, args.seed))
    train = _train_pipeline if args.pipeline else _train_flat
    state = train(params, x, heat_t, paf_t, args, print)
    W.save_npz(args.out, state)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
