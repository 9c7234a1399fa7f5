"""Input preprocessing: stride-pad + normalize (port of
islx/ops/preprocess.py; reference src/util.py:12-32 ``padRightDownCorner``
and src/body.py:55 ``/256 - 0.5``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_amounts(h: int, w: int, stride: int) -> Tuple[int, int]:
    """(pad_down, pad_right) to reach the next stride multiple
    (reference: src/util.py:19-20)."""
    pd = 0 if h % stride == 0 else stride - (h % stride)
    pr = 0 if w % stride == 0 else stride - (w % stride)
    return pd, pr


def pad_normalize(img: torch.Tensor, stride: int = 8, pad_value: int = 128
                  ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[H,W,3] (any dtype) -> (f32 [1,H',W',3] in [-0.5, ~0.5), stride-padded
    down and right with ``pad_value``; (pad_down, pad_right))."""
    pd, pr = pad_amounts(img.shape[0], img.shape[1], stride)
    x = F.pad(img.float(), (0, 0, 0, pr, 0, pd), value=float(pad_value))
    return (x / 256.0 - 0.5)[None], (pd, pr)


def pad_normalize_batch(imgs: torch.Tensor, stride: int = 8,
                        pad_value: int = 128
                        ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B,H,W,3] -> (f32 [B,H',W',3], (pad_down, pad_right)): the same
    padding for the whole batch."""
    pd, pr = pad_amounts(imgs.shape[1], imgs.shape[2], stride)
    x = F.pad(imgs.float(), (0, 0, 0, pr, 0, pd), value=float(pad_value))
    return x / 256.0 - 0.5, (pd, pr)
