"""I420 (YUV 4:2:0) -> BGR on the device (port of islx/ops/yuv.py).

Uploading the I420 planes moves 1.5 bytes/px instead of 3. The math is
OpenCV's ``COLOR_YUV2BGR_I420``: ITU-R BT.601 video-range coefficients,
2x2 chroma replication, round half to even, clip to [0, 255].
"""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.601 video-range coefficients as OpenCV applies them (20-bit fixed
# point, modules/imgproc/src/color_yuv.simd.hpp)
_CY = 1220542 / (1 << 20)
_CVR = 1673527 / (1 << 20)
_CVG = -852492 / (1 << 20)
_CUG = -409993 / (1 << 20)
_CUB = 2116026 / (1 << 20)


def frame_bytes(h: int, w: int) -> int:
    """I420 bytes per frame (h, w even)."""
    return h * w * 3 // 2


def yuv420_to_bgr(flat: torch.Tensor, b: int, h: int, w: int
                  ) -> torch.Tensor:
    """Flat u8 I420 buffer [b*h*w*3/2] -> f32 BGR frames [b,h,w,3], rounded
    (half to even) and clipped to [0, 255]."""
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even sizes, got {(h, w)}")
    n = h * w
    q = n // 4
    planes = flat.reshape(b, n + 2 * q)
    y = planes[:, :n].reshape(b, h, w).float()
    u = planes[:, n:n + q].reshape(b, h // 2, w // 2).float()
    v = planes[:, n + q:].reshape(b, h // 2, w // 2).float()
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    yl = _CY * torch.clamp_min(y - 16.0, 0.0)
    r = yl + _CVR * v
    g = yl + _CVG * v + _CUG * u
    bch = yl + _CUB * u
    return torch.clamp(torch.round(torch.stack([bch, g, r], -1)), 0.0, 255.0)


def bgr_to_yuv420_host(frames: np.ndarray) -> np.ndarray:
    """Host helper: BGR u8 [B,H,W,3] -> flat I420 u8 buffer."""
    import cv2

    b, h, w = frames.shape[:3]
    step = frame_bytes(h, w)
    out = np.empty(b * step, np.uint8)
    for i in range(b):
        out[i * step:(i + 1) * step] = cv2.cvtColor(
            frames[i], cv2.COLOR_BGR2YUV_I420).reshape(-1)
    return out
