"""Gaussian blur with scipy.ndimage.gaussian_filter semantics, as matmuls
(port of islx/ops/blur.py).

A separable blur with reflected borders is two dense banded matrices
``B_h[H,H]`` and ``B_w[W,W]``; they are built on the host in f64 and cast
to f32 exactly as the JAX code does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d, normalized."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float64)


def _reflect_index(p: np.ndarray, n: int) -> np.ndarray:
    """scipy 'reflect' mode index folding: (d c b a | a b c d | d c b a)."""
    if n == 1:
        return np.zeros_like(p)
    period = 2 * n
    p = np.mod(p, period)
    p = np.where(p < 0, p + period, p)
    return np.where(p < n, p, period - 1 - p)


@functools.lru_cache(maxsize=256)
def _blur_matrix(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """[n,n] matrix equal to 1-D gaussian correlation with reflect border."""
    k = gaussian_kernel1d(sigma, truncate)
    radius = (len(k) - 1) // 2
    mat = np.zeros((n, n), np.float64)
    rows = np.arange(n)
    for t, w in enumerate(k):
        cols = _reflect_index(rows - radius + t, n)
        np.add.at(mat, (rows, cols), w)
    return mat.astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 3.0,
                  truncate: float = 4.0) -> torch.Tensor:
    """Blur [..., H, W, C] per channel in f32 (any leading batch dims)."""
    h, w = img.shape[-3], img.shape[-2]
    bh = torch.from_numpy(_blur_matrix(h, sigma, truncate)).to(img.device)
    bw = torch.from_numpy(_blur_matrix(w, sigma, truncate)).to(img.device)
    x = torch.einsum("oh,...hwc->...owc", bh, img.float())
    return torch.einsum("pw,...owc->...opc", bw, x)
