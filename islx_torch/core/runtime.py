"""Device choice and the precision the port's comparisons rely on."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    asks for another. Raises when CUDA is asked for (or defaulted to) and
    no GPU is present: an entry point never carries on on the CPU unless
    the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "islx_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` for a host number ``d``, correctly rounded on every device.

    A CUDA kernel dividing by a CPU scalar multiplies by the scalar's
    rounded reciprocal, which can differ in the last bit from the true
    quotient that the JAX code computes; a 0-dim tensor on x's device takes
    the true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def rdiv(d: float, x: torch.Tensor) -> torch.Tensor:
    """``d / x`` for a host number ``d``, correctly rounded (``float /
    tensor`` is evaluated as ``reciprocal(x) * d``)."""
    return torch.full((), d, dtype=x.dtype, device=x.device) / x


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` correctly rounded to x's float type on every device.

    PyTorch's f32 ``sqrt`` on the CPU (its vectorised path) is one ulp off
    for some inputs, e.g. sqrt(267), where XLA and the CUDA kernels round
    correctly. The square root of the f64 widening, rounded to f32, is the
    correctly rounded f32 result as long as the f64 root is within one f64
    ulp: an f32 root is never nearer than 2**-50 (relative) to a halfway
    point between two f32 numbers, four f64 ulps."""
    return torch.sqrt(x.double()).to(x.dtype)


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a*b + c`` with one rounding, as XLA's CPU program contracts a
    multiply-add: the f32 product is exact in f64 and the sum rounds twice
    (f64, then f32) only where the f64 sum is inexact and lands on an f32
    halfway point. One f64 ``addcmul``, whether or not it fuses: the
    product it would round is exact."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


@contextlib.contextmanager
def true_f32():
    """Float32 convolutions and matmuls in full f32 inside the block.

    cuDNN runs f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps ~3 decimal digits;
    the JAX reference computes them in f32. CUDA matmuls are already full
    f32 by default (``torch.backends.cuda.matmul.allow_tf32`` is False);
    the block sets both and restores them after."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
