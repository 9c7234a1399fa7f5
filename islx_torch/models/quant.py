"""Int8 (W8A8) inference for the CPM nets (port of ``islx/models/quant.py``).

Every conv that has an activation scale is quantized:

* weights: per-output-channel symmetric int8, ``s_w[o] = max|w[o]|/127``;
* activations: a per-tensor symmetric scale ``a_scale`` per conv input,
  from calibration batches run through the float net
  (:func:`calibrate_scales`); the input is quantized at the conv;
* the int8 conv sums in int32 and its epilogue dequantizes, adds the bias
  and activates in f32 (:mod:`islx_torch.ops.conv_q`), then writes f32
  (head convs), the compute dtype, or int8 at the next conv's scale where
  :meth:`islx_torch.models.cpm.CPM._seq` chains two quantized convs.

A quantized state entry is ``{"w_q" int8 OIHW, "s_w" f32 [cout], "a_scale"
f32 scalar, "b"[, "p"]}``; :func:`islx_torch.core.weights.build` makes a
:class:`QConvLayer` of it.

The host computes each layer's two scalars once, in f32 as XLA's CPU
program does: ``inv = 127 / a_scale`` by true division, and the epilogue's
``scale = s_w * (a_scale * f32(1/127))``, since XLA rewrites the JAX code's
``a_scale / 127.0`` into a multiply by the reciprocal. Neither is ever a
CUDA ``tensor / float``, which is a multiply by a reciprocal too.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from islx_torch.core.runtime import resolve_device
from islx_torch.ops import conv_q as CQ

State = Dict[str, Dict[str, torch.Tensor]]


def act_inv(a_scale) -> float:
    """127 / a_scale in f32 (true division): the activation's quantize
    factor, and a chained conv's ``out_inv``."""
    return float(np.float32(127.0) / np.float32(a_scale))


def epilogue_scale(s_w: np.ndarray, a_scale) -> np.ndarray:
    """The epilogue's per-channel f32 factor ``s_w * (a_scale / 127)``,
    with the division as XLA compiles it: a multiply by f32(1/127)."""
    return (np.asarray(s_w, np.float32)
            * (np.float32(a_scale) * np.float32(1.0 / 127.0))
            ).astype(np.float32)


def quantize_params(state: State, a_scales: Dict[str, float],
                    skip: Iterable[str] = ()) -> State:
    """Float port state + per-layer activation scales -> quantized state.

    Every layer in ``a_scales`` (and not in ``skip``) gets ``w_q`` int8
    OIHW, ``s_w`` f32 [cout] and ``a_scale`` f32 (at least 1e-8); ``b`` and
    ``p`` stay f32. The arithmetic is islx's, in numpy f32, so ``w_q`` and
    ``s_w`` are the same words."""
    skip = set(skip)
    out: State = {}
    for name, entry in state.items():
        if name not in a_scales or name in skip:
            out[name] = dict(entry)
            continue
        w = entry["w"].numpy().astype(np.float32)
        s_w = np.max(np.abs(w), axis=(1, 2, 3)) / 127.0
        s_w = np.where(s_w > 0, s_w, 1.0).astype(np.float32)
        w_q = np.clip(np.rint(w / s_w[:, None, None, None]), -127, 127)
        q = {k: v for k, v in entry.items() if k != "w"}
        q["w_q"] = torch.from_numpy(w_q.astype(np.int8))
        q["s_w"] = torch.from_numpy(s_w)
        q["a_scale"] = torch.tensor(np.float32(max(a_scales[name], 1e-8)))
        out[name] = q
    return out


def quantize_act(x: torch.Tensor, inv: float) -> torch.Tensor:
    """Symmetric per-tensor quantization: int8 ``clip(rint(x * inv),
    +-127)``, the product in f32, rounded half to even (on the card, the
    convs' inputs come from :func:`islx_torch.ops.conv_q.quantize`, the
    same words with the channels padded)."""
    return CQ.quantize_plain(x, inv)[..., :x.shape[-1]]


class QConvLayer(nn.Module):
    """An int8 W8A8 conv layer of a CPM net.

    Buffers: ``w_pack``, the int8 weights packed once
    (:func:`islx_torch.ops.conv_q.pack_weights`), and per output channel
    the epilogue's f32
    ``scale``, ``bias`` and PReLU ``slope``. ``a_scale`` is the input's
    scale and ``inv`` its quantize factor.

    A conv whose k x k x cin neighbourhood fits one K step of the kernel
    (conv1_1 of both nets, 3x3x3) runs in patch mode
    (:func:`islx_torch.ops.conv_q.patch_k`): its input is quantized into
    [B,H,W,32] patches and its weights are packed as a 1x1 conv over the
    k*k*cin patch channels, in the same (ky, kx, c) order. The int32 sums
    are the same exact sums, so the words do not change. ``cin`` is the
    channel count the kernel sees (27 there), ``patch`` the k (else 0)."""

    def __init__(self, c, entry: Dict[str, torch.Tensor]):
        super().__init__()
        self.spec = c
        w_q = entry["w_q"].to(torch.int8)
        if tuple(w_q.shape) != (c.cout, c.cin, c.k, c.k):
            raise ValueError(f"{c.name}: w_q {tuple(w_q.shape)}, want OIHW "
                             f"{(c.cout, c.cin, c.k, c.k)}")
        a_scale = np.float32(entry["a_scale"])
        self.a_scale = float(a_scale)
        self.inv = act_inv(a_scale)
        self.patch = CQ.patch_k(c.cin, c.k)
        self.cin = c.k * c.k * c.cin if self.patch else c.cin
        if self.patch:                    # a 1x1 conv over (ky, kx, c)
            w_q = w_q.permute(0, 2, 3, 1).reshape(c.cout, self.cin, 1, 1)
        self.register_buffer("w_pack", CQ.pack_weights(w_q))
        self.register_buffer("scale", torch.from_numpy(epilogue_scale(
            entry["s_w"].numpy(), a_scale)))
        self.register_buffer("bias", entry["b"].to(torch.float32).clone())
        self.register_buffer("slope", (entry["p"].to(torch.float32).clone()
                                       if c.act == "prelu" else None))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """A float NCHW input (any memory format) -> int8 NHWC at this
        layer's scale (:func:`quantize_act`), its channel stride padded
        for the kernel, or its patches in patch mode
        (:func:`islx_torch.ops.conv_q.quantize`)."""
        return CQ.quantize(x.permute(0, 2, 3, 1), self.inv, self.patch)

    def core(self, x_q: torch.Tensor, compute_dtype: torch.dtype,
             out_inv: Optional[float] = None) -> torch.Tensor:
        """islx's ``conv_q_core``: int8 NHWC in -> NHWC out, int8 at
        ``out_inv`` (127 / the next conv's a_scale: chained), else f32 for
        a head conv and the compute dtype otherwise."""
        c = self.spec
        if self.patch and x_q.shape[-1] != CQ.channel_stride(self.cin):
            raise ValueError(f"{c.name}: a patch-mode conv takes its own "
                             f"quantize's patches, got {tuple(x_q.shape)}")
        if out_inv is not None:
            dt = torch.int8
        else:
            dt = torch.float32 if c.head else compute_dtype
        return CQ.conv_q(x_q, self.w_pack, self.cin, self.scale, self.bias,
                         self.slope, c.act, dt, out_inv)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype
                ) -> torch.Tensor:
        """Unchained (islx's ``conv_q``): quantize the float input, conv,
        float output; NCHW in and out (channels_last memory)."""
        return self.core(self.quantize(x), compute_dtype).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Calibration: each conv input's max|x|, seen by a hook in the float
# ConvLayer.forward. Thread-local, so that a calibration in one thread
# never sees another thread's forwards.
# ---------------------------------------------------------------------------

_TLS = threading.local()


def observer():
    """The active calibration observer of this thread, or None."""
    return getattr(_TLS, "observer", None)


def calibrate_scales(state: State, model_type: str,
                     batches: Iterable[np.ndarray],
                     compute_dtype=torch.float32,
                     percentile: Optional[float] = None,
                     device=None) -> Dict[str, float]:
    """Each conv input's max|x| (or the ``percentile`` of |x|) over the
    calibration batches: normalized net inputs [B,H,W,3] (x/256 - 0.5),
    run through the float net on ``device`` (the GPU unless the caller
    asks for another, :func:`islx_torch.core.runtime.resolve_device`). The
    maxima stay on the device and come to the host in one copy at the
    end."""
    from islx_torch.core import weights as W

    device = resolve_device(device)
    net = W.build(model_type, state, device, compute_dtype)
    maxima: Dict[str, torch.Tensor] = {}

    def observe(name: str, x: torch.Tensor) -> None:
        a = x.detach().abs().float()
        v = (a.max() if percentile is None
             else torch.quantile(a.reshape(-1), percentile / 100.0))
        prev = maxima.get(name)
        maxima[name] = v if prev is None else torch.maximum(prev, v)

    _TLS.observer = observe
    try:
        with torch.inference_mode():
            for x in batches:
                net(torch.as_tensor(np.asarray(x, np.float32)).to(device),
                    compute_dtype)
    finally:
        _TLS.observer = None
    names = list(maxima)
    vals = torch.stack([maxima[n] for n in names]).cpu().numpy()
    return {n: float(v) for n, v in zip(names, vals)}


def quantize_model(state: State, model_type: str,
                   calib_batches: Iterable[np.ndarray],
                   compute_dtype=torch.float32, device=None) -> State:
    """Calibrate on ``calib_batches`` on ``device`` (the GPU unless the
    caller asks for another), then quantize every conv."""
    return quantize_params(state, calibrate_scales(
        state, model_type, calib_batches, compute_dtype, device=device))
