"""Offline int8 (W8A8) quantization: calibrate on a clip, write a state
(port of islx/cli/quantize.py).

    python -m islx_torch.cli.quantize WEIGHTS OUT --model-type body25|coco|hand
           --calib CLIP.mp4 [--frames 8] [--device cuda]

Loads float weights (.npz/.pt/.caffemodel), samples ``--frames`` evenly
spaced frames from the clip (bounded-memory stride sampling, as islx),
prepares them as islx does (the 184-row bucket for the body nets, 368
square for the hand net, cv2's ``INTER_CUBIC`` computed without cv2 on
``--device``, /256 - 0.5), records each
conv's activation scale with the float net on ``--device`` and writes the
quantized state to OUT, whose name ends in ``.pt``
(:func:`islx_torch.core.weights.save_state`). Every CLI of the port takes
OUT wherever it takes weights:

    python -m islx_torch.cli.demo_video clip.mp4 --body-weights body-int8.pt \\
        --hand-weights hand-int8.pt

islx writes an orbax directory or a pickled treedef here, which needs JAX
to read; the port's state is a ``torch.save`` file (ROADMAP.md §3).
Decoding the clip needs cv2; the resize does not
(:func:`islx_torch.ops.resize_u8.resize_frames`, word-equal to cv2's).
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np


def sample_frames(clip: str, n_frames: int = 8) -> List[np.ndarray]:
    """``n_frames`` evenly spaced BGR u8 frames of the clip. At most
    ``2 * n_frames`` decoded frames are kept: when full, the kept set is
    halved and the stride doubled (a long clip never lives in memory)."""
    from islx_torch.pipeline.video import FrameSource

    picked: list = []
    stride = 1
    with FrameSource(clip) as src:
        for i, f in enumerate(src):
            if i % stride == 0:
                picked.append(f)
                if len(picked) > 2 * n_frames:
                    picked = picked[::2]
                    stride *= 2
    if not picked:
        raise SystemExit(f"no frames decoded from {clip}")
    step = max(len(picked) // n_frames, 1)
    return picked[::step][:n_frames]


def calibration_inputs(frames, model_type: str, device=None) -> np.ndarray:
    """BGR u8 frames of one size -> normalized net inputs [n,H,W,3] f32:
    368x368 for the hand net, the 184-row bucket for a body net, resized
    as cv2's ``INTER_CUBIC`` on ``device`` (the GPU unless the caller asks
    for the CPU). Frames already at that size are used as they are (a
    same-size ``cv2.resize`` is an exact copy)."""
    from islx_torch.core.runtime import resolve_device
    from islx_torch.ops.resize_u8 import resize_frames
    from islx_torch.pipeline.batch_pose import bucket_for

    h0, w0 = np.asarray(frames[0]).shape[:2]
    if model_type == "hand":
        hb = wb = 368
    else:
        hb, wb = bucket_for(h0, w0, target_h=184)
    out = resize_frames(list(frames), hb, wb, resolve_device(device))
    return out.astype(np.float32) / 256.0 - 0.5


def sample_calibration_inputs(clip: str, model_type: str,
                              n_frames: int = 8, device=None) -> np.ndarray:
    """-> normalized net inputs [n,H,W,3] f32 from evenly spaced frames
    (islx's function of this name), resized on ``device``."""
    return calibration_inputs(sample_frames(clip, n_frames), model_type,
                              device)


def quantize_to_file(state, model_type: str, xcal: np.ndarray, out: str,
                     device=None) -> str:
    """Calibrate ``state`` on ``xcal`` with the float net on ``device``
    (the GPU unless the caller asks for another), quantize every conv and
    write the state to ``out`` -> the file written."""
    from islx_torch.core import weights as W
    from islx_torch.models import quant

    q = quant.quantize_model(state, model_type, [xcal], device=device)
    return W.save_state(out, q, model_type)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("weights")
    p.add_argument("out", help="the state file to write (*.pt)")
    p.add_argument("--model-type", required=True,
                   choices=["body25", "coco", "hand"])
    p.add_argument("--calib", required=True,
                   help="video clip to calibrate activation scales on")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.out.endswith(".pt"):
        p.error(f"OUT must end in .pt: {args.out}")

    from islx_torch.core import weights as W
    from islx_torch.core.runtime import resolve_device
    from islx_torch.models import cpm

    device = resolve_device(args.device)
    state = W.load(args.weights, args.model_type)
    xcal = sample_calibration_inputs(args.calib, args.model_type,
                                     args.frames, device)
    path = quantize_to_file(state, args.model_type, xcal, args.out, device)
    q = W.load(path, args.model_type)
    n_q = sum(1 for e in q.values() if "w_q" in e)
    print(f"quantized {n_q}/{len(cpm.conv_layers(args.model_type))} conv "
          f"layers -> {path}")


if __name__ == "__main__":
    main()
