"""Frame augmentations for dataset extraction (port of islx/ops/augment.py).

The reference's single-process extractor applies torchvision transforms per
frame (extract_featuressingle.py:49-52: RandomRotation(+-deg),
RandomSolarize(threshold)). islx computes them as jitted XLA programs; these
are the same functions in PyTorch, word-equal to islx's on the CPU, and the
same words on a CUDA tensor:

* rotation: inverse-mapped nearest-neighbour sampling about the centre,
  out-of-frame pixels 0 (torchvision's NEAREST, expand=False);
* solarize: invert values >= threshold (torchvision ``F.solarize``).

XLA's CPU program computes islx's ``cos``/``sin`` of the f32 angle with
the C library's ``cosf``/``sinf`` (probed: the same word at 3,000 angles
in +-10 degrees, where the correctly rounded cos and sin differ at 0.03%
and 1.3% of them), and contracts the coordinate expressions into FMAs:
``sx = fma(cos, xx, -(sin * yy)) + cx`` and ``sy = fma(sin, xx, cos * yy)
+ cy`` (the only one of the three roundings tried that gives islx's
source pixel at every output pixel of 720x1280, 184x328 and 37x53 frames).
So both words come from the C library once a frame, on the host, and the
FMAs round once through f64, where the f32 products are exact.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional

import numpy as np
import torch

from islx_torch.core.runtime import fma_rn


@functools.cache
def _libm():
    path = ctypes.util.find_library("m")
    if path is None:
        raise RuntimeError("rotate_nearest needs the C math library (libm) "
                           "for XLA's f32 cos/sin words")
    lib = ctypes.CDLL(path)
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def cos_sin_f32(degrees: float):
    """The f32 cos and sin words of ``degrees`` as islx's jitted program
    computes them: deg2rad as one f32 multiply, then ``cosf``/``sinf``."""
    theta = np.float32(degrees) * np.float32(np.pi / 180.0)
    lib = _libm()
    return (np.float32(lib.cosf(float(theta))),
            np.float32(lib.sinf(float(theta))))


def solarize(img: torch.Tensor, threshold: float = 128.0) -> torch.Tensor:
    """[..., H, W, C] u8 or f32: values >= threshold become 255 - v,
    compared and inverted in f32 and cast back to the input's type."""
    v = img.float()
    return torch.where(v >= threshold, 255.0 - v, v).to(img.dtype)


def rotate_nearest(img: torch.Tensor, degrees: float) -> torch.Tensor:
    """[H, W, C] rotated by ``degrees`` about the centre (positive turns the
    image counter-clockwise), nearest neighbour, 0 outside the source."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    c, s = (torch.tensor(float(v), dtype=torch.float32, device=dev)
            for v in cos_sin_f32(degrees))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None] \
        .expand(h, w)
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, :] \
        .expand(h, w)
    sx = fma_rn(c, xx, -(s * yy)) + cx
    sy = fma_rn(s, xx, c * yy) + cy
    xi = torch.round(sx).to(torch.int64)
    yi = torch.round(sy).to(torch.int64)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return torch.where(inside[:, :, None], out, torch.zeros_like(out))


def random_augment(frames: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   max_degrees: float = 10.0,
                   solarize_threshold: float = 192.0,
                   solarize_prob: float = 0.5) -> torch.Tensor:
    """Batched random rotation (uniform in +-max_degrees) and, with
    probability ``solarize_prob``, solarize: [B, H, W, C] -> the same shape
    and type. Draws from ``generator`` (a CPU ``torch.Generator``; islx's
    jax key stream cannot be reproduced, so only the contract is islx's)."""
    b = frames.shape[0]
    degs = (torch.rand(b, generator=generator, dtype=torch.float64) * 2 - 1
            ) * max_degrees
    do_sol = torch.rand(b, generator=generator) < solarize_prob
    out = []
    for i in range(b):
        f = rotate_nearest(frames[i], float(degs[i]))
        out.append(solarize(f, solarize_threshold) if do_sol[i] else f)
    return torch.stack(out).to(frames.dtype)
