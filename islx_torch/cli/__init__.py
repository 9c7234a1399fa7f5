"""CLI entry points of the port, and the int8 gate they share."""
from __future__ import annotations

import json
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


def _calib_frames(calib_clip=None, calib_image=None, n: int = 2):
    """Up to ``n`` evenly spaced BGR u8 frames from the CLI's own input (the
    head of the clip, or the still image): the activation-calibration
    sample of gated int8 quantization."""
    import numpy as np

    if calib_image is not None:
        return [np.asarray(calib_image)]
    if calib_clip is None:
        return []
    from islx_torch.pipeline.video import FrameSource

    frames = []
    with FrameSource(calib_clip) as src:
        for i, f in enumerate(src):
            frames.append(f)
            if i + 1 >= 8 * n:
                break
    if not frames:
        return []
    step = max(len(frames) // n, 1)
    return frames[::step][:n]


def calib_inputs(frames, hand_cfg):
    """BGR u8 frames of one size -> (body batch [n,hb,wb,3], hand batch
    [n,s,s,3]) of normalized f32 net inputs (x/256 - 0.5): the frames
    resized to the body's 184-row bucket, and their centre squares to the
    hand crop size, with cv2's u8 ``INTER_CUBIC``, as islx's gate resizes
    them (``islx/cli/__init__.py::gated_int8_params``). cv2 is needed
    here; where it is missing this raises (a calibration on other pixels
    would give other activation scales)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "int8 calibration resizes its frames with cv2, as islx's gate "
            "does, and cv2 is not installed") from e
    import numpy as np

    from islx_torch.pipeline.batch_pose import bucket_for

    h0, w0 = np.asarray(frames[0]).shape[:2]
    hb, wb = bucket_for(h0, w0, target_h=184)
    hsize = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    s = min(h0, w0)
    xcal = np.stack([cv2.resize(f, (wb, hb), interpolation=cv2.INTER_CUBIC)
                     for f in frames]).astype(np.float32) / 256.0 - 0.5
    hcal = np.stack([cv2.resize(
        f[(h0 - s) // 2:(h0 + s) // 2, (w0 - s) // 2:(w0 + s) // 2],
        (hsize, hsize), interpolation=cv2.INTER_CUBIC)
        for f in frames]).astype(np.float32) / 256.0 - 0.5
    return xcal, hcal


def quantize_states(body_params, hand_params, frames, hand_cfg,
                    model_type: str = "body25", device=None):
    """Calibrate both nets on ``frames`` (:func:`calib_inputs`) with the
    float nets on ``device`` (the GPU unless the caller asks for another)
    and quantize every conv -> (body, hand) quantized port states."""
    from islx_torch.models import quant

    xcal, hcal = calib_inputs(frames, hand_cfg)
    return (quant.quantize_model(body_params, model_type, [xcal],
                                 device=device),
            quant.quantize_model(hand_params, "hand", [hcal], device=device))


def _ident(path):
    """A weight file's identity for the int8 cache key."""
    if path is None:
        return None
    try:
        st = os.stat(path)
        return [os.path.basename(path), st.st_size, int(st.st_mtime)]
    except OSError:
        return [os.path.basename(path)]


def gated_int8_params(body_params, hand_params, *, model_type="body25",
                      hand_weights=None, body_weights=None, hand_cfg=None,
                      calib_clip=None, calib_image=None, log=None,
                      device=None):
    """Apply the recorded per-checkpoint int8 verdict to float port states
    (port of ``islx/cli/__init__.py::gated_int8_params``).

    When ``gates.json`` beside ``hand_weights`` says ``int8_default: GO``
    (or ``ISLX_INT8=1``; ``ISLX_INT8=0`` forces bf16), both nets are
    quantized to W8A8 with activation scales calibrated on the CLI's own
    input, on ``device`` (the GPU unless the caller asks for another),
    and cached with ``torch.save`` under
    ``<weights_dir>/.int8_cache``. The cache key holds the identity of the
    hand AND the body weight files, so that a changed body checkpoint is
    calibrated anew. No verdict is borrowed when no ``hand_weights`` path
    is given. -> (body_params, hand_params, applied)."""
    import torch

    from islx_torch.core.config import HandConfig, int8_gated

    def _log(msg):
        if log is not None:
            log(msg)

    if hand_weights is None and os.environ.get("ISLX_INT8") != "1":
        _log("int8: bf16 (no --hand-weights: the int8 verdict travels "
             "with checkpoints)")
        return body_params, hand_params, False
    wdir = (os.path.dirname(os.path.abspath(hand_weights))
            if hand_weights is not None else None)
    go, note = int8_gated(wdir)
    _log(f"int8: {note}")
    if not go:
        return body_params, hand_params, False
    frames = _calib_frames(calib_clip, calib_image)
    if not frames:
        _log("int8: no calibration source available; staying bf16")
        return body_params, hand_params, False

    import numpy as np

    from islx_torch.pipeline.batch_pose import bucket_for

    hand_cfg = hand_cfg or HandConfig.production()
    h0, w0 = np.asarray(frames[0]).shape[:2]
    croot = os.path.join(wdir, ".int8_cache") if wdir else None
    key = {"hand": _ident(hand_weights), "body": _ident(body_weights),
           "body_bucket": list(bucket_for(h0, w0, target_h=184)),
           "hsize": int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize)),
           "model_type": model_type}
    if croot is not None:
        try:
            with open(os.path.join(croot, "meta.json")) as f:
                if json.load(f) == key:
                    q = torch.load(os.path.join(croot, "int8.pt"),
                                   map_location="cpu", weights_only=True)
                    _log(f"int8: quantized states loaded from {croot}")
                    return q["body"], q["hand"], True
        except (OSError, ValueError, KeyError, RuntimeError):
            pass
    _log("int8: calibrating activation scales on this input "
         "(once a checkpoint; cached)")
    qb, qh = quantize_states(body_params, hand_params, frames, hand_cfg,
                             model_type, device)
    if croot is not None:
        try:
            os.makedirs(croot, exist_ok=True)
            torch.save({"body": qb, "hand": qh},
                       os.path.join(croot, "int8.pt"))
            with open(os.path.join(croot, "meta.json"), "w") as f:
                json.dump(key, f)
        except OSError as e:
            _log(f"int8: cache write failed ({e}); continuing uncached")
    return qb, qh, True
