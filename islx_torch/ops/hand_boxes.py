"""Hand boxes placed on the device from PAF connections (port of
``islx/ops/hand_boxes.py``), batched over frames.

Per arm side: the best elbow->wrist connection, then the best
shoulder->elbow connection ending at that elbow, then the reference's box
geometry (src/util.py:270-296) in original-image coordinates, mapped back
to the bucket. Arithmetic is f32 step by step, as in the JAX code.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from islx_torch.core.config import DetectorConfig
from islx_torch.core.runtime import div, sqrt_rn


def arm_limb_rows(limb_seq: np.ndarray) -> Tuple[Tuple[int, int],
                                                 Tuple[int, int]]:
    """-> ((se_left, ew_left), (se_right, ew_right)) limb-table rows
    (right arm = joints 2/3/4, left arm = 5/6/7, src/util.py:254-261)."""
    rows = {tuple(p): i for i, p in enumerate(np.asarray(limb_seq).tolist())}
    return ((rows[(5, 6)], rows[(6, 7)]), (rows[(2, 3)], rows[(3, 4)]))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x [B,M], i [B] -> x[b, i[b]]."""
    return torch.gather(x, 1, i[:, None])[:, 0]


def _chain_side(pair, score, ok, se: int, ew: int, k: int):
    """pair/score/ok [B,L,M] -> (shoulder, elbow, wrist peak indices,
    found) [B]; argmax takes the first index on ties."""
    neg = torch.full_like(score[:, ew], -float("inf"))
    sc_ew = torch.where(ok[:, ew], score[:, ew], neg)
    m_ew = torch.argmax(sc_ew, dim=1)
    has_ew = _take(sc_ew, m_ew) > -float("inf")
    p_ew = _take(pair[:, ew], m_ew)
    ei, wj = p_ew // k, p_ew % k
    sc_se = torch.where(ok[:, se] & (pair[:, se] % k == ei[:, None]),
                        score[:, se], neg)
    m_se = torch.argmax(sc_se, dim=1)
    has_se = _take(sc_se, m_se) > -float("inf")
    si = _take(pair[:, se], m_se) // k
    return si, ei, wj, has_ew & has_se


def device_hand_boxes(pk_xy: torch.Tensor, cc_pair: torch.Tensor,
                      cc_score: torch.Tensor, cc_ok: torch.Tensor,
                      limb_seq: np.ndarray, sy: float, sx: float,
                      hb: int, wb: int,
                      cfg: DetectorConfig = DetectorConfig()) -> torch.Tensor:
    """pk_xy [B,C,K,2] + connections [B,L,M] -> [B,2,3] int32 (x0, y0, w)
    hand boxes in bucket coords; row 0 = left hand, row 1 = right; w == 0
    marks a side with no detectable arm."""
    bsz, _, k, _ = pk_xy.shape
    dev = pk_xy.device
    oh, ow = hb * sy, wb * sx
    bidx = torch.arange(bsz, device=dev)
    scale = torch.tensor([sx, sy], dtype=torch.float32, device=dev)

    def one_side(se: int, ew: int) -> torch.Tensor:
        s_chan, e_chan = int(limb_seq[se][0]), int(limb_seq[se][1])
        w_chan = int(limb_seq[ew][1])
        si, ei, wj, found = _chain_side(cc_pair, cc_score, cc_ok, se, ew, k)
        p_s = pk_xy[bidx, s_chan, si].float() * scale      # [B,2]
        p_e = pk_xy[bidx, e_chan, ei].float() * scale
        p_w = pk_xy[bidx, w_chan, wj].float() * scale
        c = p_w + cfg.ratio_wrist_elbow * (p_w - p_e)
        d = p_w - p_e
        d_we = sqrt_rn((d * d).sum(-1))
        d = p_e - p_s
        d_es = sqrt_rn((d * d).sum(-1))
        width = cfg.width_scale * torch.maximum(d_we,
                                                cfg.shoulder_ratio * d_es)
        x = torch.clamp_min(c[:, 0] - width / 2.0, 0.0)
        y = torch.clamp_min(c[:, 1] - width / 2.0, 0.0)
        width = torch.minimum(torch.minimum(width, ow - x), oh - y)
        ok_box = found & (width >= cfg.min_box)
        xi, yi, wi = torch.floor(x), torch.floor(y), torch.floor(width)
        bx = torch.clamp_max(torch.round(div(xi, sx)), wb - 1).to(torch.int32)
        by = torch.clamp_max(torch.round(div(yi, sy)), hb - 1).to(torch.int32)
        bw = torch.clamp_min(torch.minimum(torch.minimum(
            torch.round(div(wi, sx)).to(torch.int32), wb - bx), hb - by), 1)
        bw = torch.where(ok_box, bw, torch.zeros_like(bw))
        return torch.stack([bx, by, bw], dim=-1)

    arms = arm_limb_rows(limb_seq)
    return torch.stack([one_side(*arms[0]), one_side(*arms[1])], dim=1)
