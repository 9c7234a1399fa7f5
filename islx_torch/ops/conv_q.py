"""Int8 W8A8 convolution with the requantize epilogue fused, and the
activation quantization of its unchained inputs.

``conv_q`` is the port of islx's int8 conv, ``islx/models/quant.py::
conv_q_core``, which XLA ran on the TPU (``lax.conv_general_dilated`` with
int32 accumulation; no Pallas kernel backs it). Stock PyTorch has no CUDA
int8 convolution, so on a CUDA tensor it launches the hand-written
implicit-GEMM kernel in ``islx_torch/csrc/conv_q.cu`` (``wgmma`` on tiles
that TMA brings in, the activations through its im2col mode); on a CPU
tensor it runs :func:`conv_q_plain`, the plain PyTorch version of the same
function. There is no fallback between the two: a CUDA tensor the kernel
cannot take raises.

The function: NHWC int8 activations x int8 weights, k x k with pad (k-1)/2
and stride 1, summed exactly in int32, then per output channel c

    o = fma(f32(y), scale[c], bias[c])          (one rounding, as XLA's
                                                 CPU program fuses it)
    o = max(o, 0) | (o >= 0 ? o : slope[c] * o) | o     (relu, prelu, none)
    out = o (f32) | bf16(o) | clip(rint(o * out_inv), +-127) (int8)

Layouts: the input's channel stride ``cs`` is a multiple of 16 and at
least ``cin`` (:func:`channel_stride`); the channels past ``cin`` may hold
anything, since the packed weights are zero there. Both take the weights
packed once by :func:`pack_weights`; the plain version reads them back OIHW
(:func:`unpack_weights`).

``quantize`` makes such an input from a float NHWC activation: islx's
``quantize_act`` (``islx/models/quant.py:63``, an XLA elementwise fusion
on the TPU), ``clip(rint(x * inv), +-127)`` with the product rounded once
in f32, written at the padded channel stride (zeros past ``cin``) by one
kernel (``islx_quantize`` in the same source) on a CUDA tensor, or by
:func:`quantize_plain` on a CPU tensor. In patch mode (:func:`patch_k`:
conv1_1, 3x3 over 3 channels) it writes each pixel's quantized 3x3
neighbourhood instead, and the conv runs as a 1x1 conv over those 27
channels: one K step in place of nine.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from islx_torch.core.runtime import fma_rn
from islx_torch.ops import _build

ACTS = {"none": 0, "relu": 1, "prelu": 2}
OUT_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PACK_N = 128        # the packed weights' cout padding: the widest N tile
K_CHUNK = 32        # the packed weights' cin padding: wgmma's k32
CHANNEL_ALIGN = 16  # the input's channel stride: TMA's 16-byte strides
# |sum| <= 127 * 127 * k * k * cin must stay below 2^31 (int32 sums)
MAX_K = (2 ** 31 - 1) // (127 * 127)


def channel_stride(cin: int) -> int:
    """The channel stride of a conv input with ``cin`` channels."""
    return -(-cin // CHANNEL_ALIGN) * CHANNEL_ALIGN


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> [cout padded to PACK_N, k*k, cin padded to K_CHUNK]
    int8, zero in the padding: a block's weight rows for one (tap,
    32-channel chunk) are 32 contiguous bytes."""
    cout, cin, k, _ = w_q.shape
    out = torch.zeros(-(-cout // PACK_N) * PACK_N, k * k,
                      -(-cin // K_CHUNK) * K_CHUNK, dtype=torch.int8,
                      device=w_q.device)
    out[:cout, :, :cin] = w_q.permute(0, 2, 3, 1).reshape(cout, k * k, cin)
    return out


def unpack_weights(w_pack: torch.Tensor, cin: int, cout: int
                   ) -> torch.Tensor:
    """:func:`pack_weights`'s inverse: -> OIHW int8 [cout, cin, k, k]."""
    k = int(round(w_pack.shape[1] ** 0.5))
    return w_pack[:cout, :, :cin].reshape(cout, k, k, cin).permute(0, 3, 1, 2)


def epilogue(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             slope: Optional[torch.Tensor], act: str, out_dtype: torch.dtype,
             out_inv: Optional[float] = None) -> torch.Tensor:
    """The epilogue on exact integer sums ``y`` [..., cout] (any dtype that
    holds them): ``fma(f32(y), scale, bias)`` with one rounding, the
    activation, then the output conversion."""
    o = fma_rn(y.float(), scale, bias)
    if act == "relu":
        o = torch.relu(o)
    elif act == "prelu":
        o = torch.where(o >= 0, o, slope * o)
    elif act != "none":
        raise ValueError(f"conv_q: unknown activation {act!r}")
    if out_dtype == torch.int8:
        return torch.round(o * out_inv).clamp_(-127, 127).to(torch.int8)
    return o.to(out_dtype)


def conv_q_plain(x_q: torch.Tensor, w_pack: torch.Tensor, cin: int,
                 scale: torch.Tensor, bias: torch.Tensor,
                 slope: Optional[torch.Tensor], act: str,
                 out_dtype: torch.dtype, out_inv: Optional[float] = None
                 ) -> torch.Tensor:
    """x_q [B,H,W,cs] int8 (its first cin channels), w_pack the packed
    int8 weights of a conv with ``cin`` inputs and ``scale.numel()``
    outputs -> [B,H,W,cout] of ``out_dtype``.

    The sums are F.conv2d over the int8 values in f64, exact since
    |sum| < 2^53."""
    w_q = unpack_weights(w_pack, cin, scale.numel())
    k = w_q.shape[2]
    y = F.conv2d(x_q[..., :cin].permute(0, 3, 1, 2).double(), w_q.double(),
                 padding=(k - 1) // 2)
    return epilogue(y.permute(0, 2, 3, 1), scale, bias, slope, act,
                    out_dtype, out_inv).contiguous()


def patch_k(cin: int, k: int) -> int:
    """The patch mode of a k x k conv over ``cin`` channels: 3 for a 3x3
    conv over 3 channels (conv1_1 of both nets), whose 27-value
    neighbourhood fits one 32-channel K step, else 0. Such a conv runs as a
    1x1 conv over :func:`quantize`'s patches: one K step, not nine."""
    return 3 if k == 3 and cin == 3 else 0


def quantize_plain(x: torch.Tensor, inv: float, patch: int = 0
                   ) -> torch.Tensor:
    """x [..., C] float (f32 or bf16) -> int8 [..., channel_stride(C)]:
    ``clip(rint(x * inv), +-127)``, the product in f32 rounded half to
    even, zeros in the padding channels.

    With ``patch`` k (x [B,H,W,C]): each pixel's k x k neighbourhood of
    quantized values in (ky, kx, c) order, zero outside the frame, ->
    [B,H,W,channel_stride(k*k*C)], the input of the conv as a 1x1 conv
    over k*k*C channels (:func:`patch_k`)."""
    q = torch.round(x.float() * inv).clamp_(-127, 127)
    if patch:
        b, h, w, _ = q.shape
        p = (patch - 1) // 2
        qp = F.pad(q, (0, 0, p, p, p, p))
        q = torch.cat([qp[:, ky:ky + h, kx:kx + w]
                       for ky in range(patch) for kx in range(patch)], -1)
    c = q.shape[-1]
    out = torch.zeros(q.shape[:-1] + (channel_stride(c),), dtype=torch.int8,
                      device=x.device)
    out[..., :c] = q
    return out


@functools.cache
def _quantize_kernel():
    lib = _build.load("conv_q")
    fn = lib.islx_quantize
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64]
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def quantize(x: torch.Tensor, inv: float, patch: int = 0) -> torch.Tensor:
    """x [..., C] f32 or bf16 -> int8 [..., channel_stride(C)], or with
    ``patch`` k (x [B,H,W,C]) the k x k patches [B,H,W,channel_stride(k*k*C)],
    the input of :func:`conv_q` (see :func:`quantize_plain`).

    A CUDA tensor goes through the sm_90a kernel on the current stream
    (``quantize.launches`` counts the launches), in its NHWC order made
    contiguous; a CPU tensor through :func:`quantize_plain`."""
    if x.device.type == "cpu":
        return quantize_plain(x, inv, patch)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize: need float32 or bfloat16, got {x.dtype}")
    if patch and (x.dim() != 4 or patch != 3 or x.shape[-1] != 3):
        raise ValueError(f"quantize: the kernel's patch mode takes a 3x3 "
                         f"neighbourhood of [B,H,W,3], got patch "
                         f"{patch}, {tuple(x.shape)}")
    x = x.contiguous()
    c = x.shape[-1]
    h, w = (x.shape[1], x.shape[2]) if patch else (1, 1)
    out = torch.empty(x.shape[:-1] + (channel_stride(
        c * max(patch, 1) ** 2),), dtype=torch.int8, device=x.device)
    m = x.numel() // c if c else 0
    if m == 0:
        return out
    _build.launch("quantize", _quantize_kernel(), x.device, x.data_ptr(),
                  out.data_ptr(), m, c, out.shape[-1],
                  int(x.dtype == torch.bfloat16), h, w, max(patch, 1), inv)
    quantize.launches += 1
    return out


quantize.launches = 0


@functools.cache
def _kernel():
    lib = _build.load("conv_q")
    fn = lib.islx_conv_q
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def conv_q(x_q: torch.Tensor, w_pack: torch.Tensor, cin: int,
           scale: torch.Tensor, bias: torch.Tensor,
           slope: Optional[torch.Tensor], act: str, out_dtype: torch.dtype,
           out_inv: Optional[float] = None) -> torch.Tensor:
    """x_q [B,H,W,cs] int8 -> [B,H,W,cout] of ``out_dtype`` (float32,
    bfloat16, or int8 at ``out_inv``); w_pack the :func:`pack_weights`
    form of a k x k conv's int8 weights with ``cin`` inputs; scale, bias
    and slope (prelu) f32 [cout].

    CUDA tensors go through the sm_90a kernel on the current stream (no
    synchronisation; ``conv_q.launches`` counts the launches), CPU tensors
    through :func:`conv_q_plain`."""
    if act not in ACTS:
        raise ValueError(f"conv_q: unknown activation {act!r}")
    if out_dtype not in OUT_MODES:
        raise TypeError(f"conv_q: output dtype {out_dtype} not supported")
    if out_dtype == torch.int8 and out_inv is None:
        raise ValueError("conv_q: an int8 output needs out_inv")
    if act == "prelu" and slope is None:
        raise ValueError("conv_q: prelu needs a slope")
    if x_q.device.type == "cpu":
        return conv_q_plain(x_q, w_pack, cin, scale, bias, slope, act,
                            out_dtype, out_inv)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv_q: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or not x_q.is_contiguous():
        raise TypeError(f"conv_q: need x_q [B,H,W,cs] int8 contiguous, got "
                        f"{x_q.dtype} {tuple(x_q.shape)}")
    b, h, w, cs = x_q.shape
    cout = scale.numel()
    k = int(round(w_pack.shape[1] ** 0.5)) if w_pack.dim() == 3 else 0
    if w_pack.dim() != 3 or k * k != w_pack.shape[1] or k % 2 == 0:
        raise ValueError(f"conv_q: need packed weights of an odd square "
                         f"kernel, got {tuple(w_pack.shape)}")
    if cs % CHANNEL_ALIGN or cs < cin or x_q.data_ptr() % 16:
        raise ValueError(f"conv_q: the input's channel stride {cs} must be "
                         f"a multiple of {CHANNEL_ALIGN} holding {cin} "
                         f"channels, from a 16-byte boundary")
    if cout % 2:
        raise ValueError(f"conv_q: cout {cout} must be even (pair stores)")
    if k * k * cin > MAX_K:
        raise ValueError(f"conv_q: K = {k * k * cin} could overflow int32")
    cin32 = -(-cin // K_CHUNK) * K_CHUNK
    want = (-(-cout // PACK_N) * PACK_N, k * k, cin32)
    if tuple(w_pack.shape) != want or w_pack.dtype != torch.int8:
        raise ValueError(f"conv_q: packed weights {tuple(w_pack.shape)}, "
                         f"want {want} int8")
    vecs = [scale, bias] + ([slope] if act == "prelu" else [])
    tensors = [x_q, w_pack] + vecs
    for t in tensors:
        if t.device != x_q.device or not t.is_contiguous():
            raise ValueError("conv_q: every tensor on the input's device, "
                             "contiguous")
    for v in vecs:
        if v.dtype != torch.float32 or v.numel() != cout:
            raise TypeError("conv_q: scale, bias and slope must be f32 "
                            f"[{cout}]")
    out = torch.empty(b, h, w, cout, dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    if b * h * w >= 2 ** 31:
        raise ValueError(f"conv_q: {b * h * w} pixels are too many")
    _build.launch("conv_q", _kernel(), x_q.device, x_q.data_ptr(),
                  w_pack.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  slope.data_ptr() if act == "prelu" else None,
                  out.data_ptr(), b, h, w, cin, cs, cout, cin32, k,
                  ACTS[act], OUT_MODES[out_dtype],
                  0.0 if out_inv is None else out_inv)
    conv_q.launches += 1
    return out


conv_q.launches = 0
