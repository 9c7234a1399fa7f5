"""The fused pose step: body CPM + on-device hand boxes + hand CPM in one
device pass per batch (port of ``islx/pipeline/batch_pose.py``: the
single-scale body core, ``BatchedHandPipeline._crops_core_fn`` and
``FusedPosePipeline``, with the ``bits16`` result buffer).

One frame upload in (u8 BGR, or I420 at 1.5 bytes/px), one packed int32
buffer out. The buffer layout is the JAX package's, word for word, so the
host ``unpack``/``assemble`` code and the end-to-end comparison are shared:

    [xy (x | y<<16) B*C*K] [peak scores, two f16 per word B*C*K/2]
    [counts B*C] [pairs, four u8 per word B*L*M/4 (K*K <= 256)]
    [connection scores (-inf = not ok), two f16 per word B*L*M/2]
    [hand boxes B*2*4] [hand peaks (x | y<<16) B*2*21] [found bits B*2]

Each stage runs inside a ``torch.profiler.record_function`` range named
after it (``body_cpm``, ``body_peaks``, ``paf_limbs``, ``hand_boxes``,
``hand_crops``, ``hand_cpm``, ``hand_peaks``, ``pack``, and
``yuv420_to_bgr`` for I420 input), so a profile splits the step's device
time by stage (``chip_smoke.py --profile``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from islx_torch.core import weights as W
from islx_torch.core.config import DetectorConfig, HandConfig, PoseConfig
from islx_torch.core.runtime import div, resolve_device
from islx_torch.ops import grouping
from islx_torch.ops.hand_boxes import device_hand_boxes
from islx_torch.ops.hand_peaks import find_hand_peaks_refine
from islx_torch.ops.paf import (LIMB_TABLES, compact_connections,
                                score_limbs_cell)
from islx_torch.ops.peaks import find_peaks_fused_batched
from islx_torch.ops.resize import dynamic_crop_resize_batch
from islx_torch.ops.yuv import yuv420_to_bgr


def bucket_for(h: int, w: int, target_h: int = 184, stride: int = 8
               ) -> Tuple[int, int]:
    """Stride-aligned bucket: scale height to target, round width up."""
    scale = target_h / h
    wb = int(np.ceil(w * scale / stride) * stride)
    return target_h, wb


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits
    (a byte >= 128 shifted into bit 31 wraps, as in the JAX code)."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _pack2x16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int arrays in [0, 65536) -> one int32 word each (lo | hi<<16)."""
    lo = lo.to(torch.int64) & 0xFFFF
    hi = hi.to(torch.int64) & 0xFFFF
    return _wrap_i32(lo | (hi << 16))


def _pack4x8(p: torch.Tensor) -> torch.Tensor:
    """[..., 4] ints in [0, 256) -> int32 words (little-endian bytes)."""
    p = p.to(torch.int64)
    return _wrap_i32(p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)
                     | (p[..., 3] << 24))


def _packf16x2(x: torch.Tensor) -> torch.Tensor:
    """f32 [..., 2n] -> int32 words [..., n], two IEEE f16 per word (round
    to nearest even; lo half first). ``view(int16)`` sign-extends, so the
    halves are masked to 16 bits before they are combined."""
    if x.shape[-1] % 2:
        raise ValueError(f"_packf16x2 needs an even last dim: {x.shape}")
    h = x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    h = h.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
    return _wrap_i32(h[..., 0] | (h[..., 1] << 16))


def _unpackf16x2(w: np.ndarray) -> np.ndarray:
    """Host inverse of _packf16x2 on a flat word array -> flat f32."""
    u = np.ascontiguousarray(w).view(np.uint32)
    lo = (u & 0xFFFF).astype(np.uint16).view(np.float16)
    hi = (u >> 16).astype(np.uint16).view(np.float16)
    return np.stack([lo, hi], -1).reshape(-1).astype(np.float32)


def _pack_body(pk, cc) -> torch.Tensor:
    """Peak + connection tables -> one flat int32 buffer (``bits16``)."""
    k = pk.xy.shape[-2]
    m = cc.pair.shape[-1]
    if k % 2:
        raise ValueError(f"bits16 packing needs an even max_peaks, got {k}")
    if k * k <= 256:                       # a pair index fits a byte
        if m % 4:
            raise ValueError(f"top_m must be a multiple of 4, got {m}")
        pair = _pack4x8(cc.pair.reshape(cc.pair.shape[:-1] + (m // 4, 4)))
    else:                                  # pair < K*K <= 2^15: two s16
        if k * k > 1 << 15 or m % 2:
            raise ValueError(f"cannot pack pairs for K={k}, M={m}")
        p2 = cc.pair.reshape(cc.pair.shape[:-1] + (m // 2, 2))
        pair = _pack2x16(p2[..., 0], p2[..., 1])
    neg = torch.full_like(cc.score, -float("inf"))
    return torch.cat([
        _pack2x16(pk.xy[..., 0], pk.xy[..., 1]).reshape(-1),
        _packf16x2(pk.score).reshape(-1),
        pk.count.to(torch.int32).reshape(-1),
        pair.reshape(-1),
        _packf16x2(torch.where(cc.ok, cc.score, neg)).reshape(-1),
    ])


def _pair_words(k: int, m: int) -> int:
    """Words per limb row of the packed pair plane (u8x4 or s16x2)."""
    return m // 4 if k * k <= 256 else m // 2


def _body_pack_len(b: int, c: int, k: int, l: int, m: int) -> int:
    return b * (c * k + c * (k // 2) + c + l * _pair_words(k, m)
                + l * (m // 2))


def _pallas_nms_env() -> bool:
    """islx's ``ISLX_PALLAS_NMS`` switch (islx/pipeline/batch_pose.py:270)."""
    env = os.environ.get("ISLX_PALLAS_NMS")
    return env is not None and env not in ("0", "false")


class BatchedBodyPipeline:
    """Body half of the fused step: frames -> (peaks, compact connections)
    on the device, and the host unpack/assemble of its tables.

    ``pallas_nms`` (default: ``ISLX_PALLAS_NMS``, as islx reads it) selects
    the peaks with the NMS+first-K kernel instead of the NMS mask kernel +
    row-blocked selection; the peaks are the same."""

    def __init__(self, net, model_type: str = "body25",
                 cfg: Optional[PoseConfig] = None,
                 compute_dtype=torch.bfloat16, top_m: int = 48,
                 pallas_nms: Optional[bool] = None):
        if model_type != "body25":
            raise NotImplementedError(
                f"model {model_type!r}: only body25 is ported")
        self.net = net
        self.model_type = model_type
        self.cfg = cfg or PoseConfig(model_type=model_type)
        self.compute_dtype = compute_dtype
        self.top_m = top_m
        self.pallas_nms = (_pallas_nms_env() if pallas_nms is None
                           else bool(pallas_nms))
        self.limb_seq, self.map_idx = LIMB_TABLES[model_type]

    def core(self, frames: torch.Tensor, thre1: float, hb: int, wb: int):
        """frames [B,hb,wb,3] u8-valued -> (Peaks, CompactConnections)."""
        cfg = self.cfg
        with record_function("body_cpm"):
            paf8, heat8 = self.net(frames.float() / 256.0 - 0.5,
                                   self.compute_dtype)
        with record_function("body_peaks"):
            pk = find_peaks_fused_batched(
                heat8[..., :cfg.njoint - 1], hb, wb, thre1, cfg.max_peaks,
                kernel="select" if self.pallas_nms else "mask")
        with record_function("paf_limbs"):
            ls = score_limbs_cell(paf8, pk.xy, pk.valid, self.limb_seq,
                                  self.map_idx, cfg.stride, cfg.thre2,
                                  cfg.mid_num, orig_h=float(np.float32(hb)))
            return pk, compact_connections(ls, self.top_m)

    def unpack(self, packed: np.ndarray, b: int):
        """Packed buffer -> (xy, score, count, pair, cscore, cok) numpy."""
        c = self.cfg.njoint - 1
        k = self.cfg.max_peaks
        l = self.limb_seq.shape[0]
        m = self.top_m
        sizes = [b * c * k, b * c * (k // 2), b * c,
                 b * l * _pair_words(k, m), b * l * (m // 2)]
        parts = np.split(np.ascontiguousarray(np.asarray(packed)),
                         np.cumsum(sizes)[:-1])
        w = parts[0].reshape(b, c, k)
        xy = np.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], -1).astype(np.int32)
        score = _unpackf16x2(parts[1]).reshape(b, c, k)
        cscore = _unpackf16x2(parts[4]).reshape(b, l, m)
        cok = cscore > -6e4   # sentinel is f16 -inf
        count = parts[2].reshape(b, c).astype(np.int32)
        if k * k <= 256:
            pair = parts[3].view(np.uint8).astype(np.int32).reshape(b, l, m)
        else:
            pair = parts[3].view(np.uint16).astype(np.int32).reshape(b, l, m)
        return xy, score, count, pair, np.where(cok, cscore, 0.0), cok

    def assemble(self, packed, b: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Packed buffer -> per-frame (candidate, subset), numpy grouping."""
        xy, score, count, pair, cscore, cok = self.unpack(packed, b)
        return [grouping.assemble_sorted(
            xy[i], score[i], count[i], pair[i], cscore[i], cok[i],
            self.cfg.max_peaks, self.limb_seq, self.cfg.njoint)
            for i in range(b)]


class BatchedHandPipeline:
    """Hand half of the fused step: crops cut on the device from resident
    frames, hand CPM, coarse-to-fine peaks (single scale)."""

    def __init__(self, net, cfg: Optional[HandConfig] = None,
                 compute_dtype=torch.bfloat16):
        self.net = net
        self.cfg = cfg or HandConfig.production()
        if len(self.cfg.scale_search) != 1:
            raise ValueError("the fused hand path is single-scale")
        self.compute_dtype = compute_dtype

    def core(self, frames: torch.Tensor, boxes: torch.Tensor):
        """frames [b,hb,wb,3], boxes [N,4] int32 (frame, x0, y0, w; w <= 0
        invalid) -> (xy [N,21,2] f32 in frame coords, valid [N,21])."""
        cfg = self.cfg
        size = int(np.rint(cfg.scale_search[0] * cfg.boxsize))
        with record_function("hand_crops"):
            crops = dynamic_crop_resize_batch(
                frames, boxes[:, 0], boxes[:, 1], boxes[:, 2],
                torch.clamp_min(boxes[:, 3], 1), size)      # [N,s,s,3]
        with record_function("hand_cpm"):
            heat = self.net(crops / 256.0 - 0.5, self.compute_dtype,
                            cfg.stages)
        with record_function("hand_peaks"):
            pk = find_hand_peaks_refine(heat[..., :cfg.n_parts], cfg.thre)
        scale = div(boxes[:, 3:4].float(), size)
        xy = (pk.xy.float() * scale[:, :, None]
              + boxes[:, None, 1:3].float())
        valid = (boxes[:, 3] > 0)[:, None] & pk.found
        return xy, valid


class FusedPosePipeline:
    """Body CPM + on-device hand boxes + hand CPM in one device pass.

    ``body_params``/``hand_params`` are port weight states
    (:mod:`islx_torch.core.weights`), float or int8 W8A8
    (:mod:`islx_torch.models.quant`); ``device`` defaults to ``"cuda"`` and
    raises when no GPU is present unless ``"cpu"`` is asked for;
    ``pallas_nms`` is :class:`BatchedBodyPipeline`'s."""

    MAX_HANDS = 2

    def __init__(self, body_params, hand_params, model_type: str = "body25",
                 pose_cfg: Optional[PoseConfig] = None,
                 hand_cfg: Optional[HandConfig] = None,
                 det_cfg: Optional[DetectorConfig] = None,
                 compute_dtype=torch.bfloat16, top_m: int = 48,
                 device=None, pallas_nms: Optional[bool] = None):
        self.device = resolve_device(device)
        self.body = BatchedBodyPipeline(
            W.build(model_type, body_params, self.device, compute_dtype),
            model_type,
            pose_cfg or PoseConfig(model_type=model_type, max_peaks=16),
            compute_dtype=compute_dtype, top_m=top_m, pallas_nms=pallas_nms)
        self.hand = BatchedHandPipeline(
            W.build("hand", hand_params, self.device, compute_dtype),
            hand_cfg or HandConfig.production(), compute_dtype)
        self.det_cfg = det_cfg or DetectorConfig()
        self.model_type = model_type

    def upload_frames(self, frames: np.ndarray) -> torch.Tensor:
        """A frame batch (u8 BGR or I420 bytes) as one flat device buffer."""
        return torch.from_numpy(np.ascontiguousarray(frames).reshape(-1)).to(
            self.device)

    @torch.inference_mode()
    def device_step_flat(self, flat: torch.Tensor, b: int, hb: int, wb: int,
                         orig_hw: Tuple[int, int],
                         thre1: Optional[float] = None,
                         input_format: str = "bgr") -> torch.Tensor:
        """flat u8 frames on the device -> packed int32 result buffer.

        input_format: ``"bgr"`` ([b*hb*wb*3]) or ``"yuv420"`` (I420 planes,
        [b*hb*wb*3/2])."""
        t1 = float(np.float32(self.body.cfg.thre1 if thre1 is None
                              else thre1))
        sy, sx = orig_hw[0] / hb, orig_hw[1] / wb
        if input_format == "yuv420":
            with record_function("yuv420_to_bgr"):
                frames = yuv420_to_bgr(flat, b, hb, wb)
        elif input_format == "bgr":
            frames = flat.reshape(b, hb, wb, 3)
        else:
            raise ValueError(f"unknown input_format {input_format!r}")
        pk, cc = self.body.core(frames, t1, hb, wb)
        with record_function("hand_boxes"):
            boxes2 = device_hand_boxes(pk.xy, cc.pair, cc.score, cc.ok,
                                       self.body.limb_seq, sy, sx, hb, wb,
                                       self.det_cfg)             # [B,2,3]
            fidx = torch.arange(b, dtype=torch.int32, device=flat.device)
            fidx = fidx[:, None, None].expand(b, self.MAX_HANDS, 1)
            boxes = torch.cat([fidx, boxes2], -1).reshape(
                b * self.MAX_HANDS, 4)
        hxy, hvalid = self.hand.core(frames, boxes)
        with record_function("pack"):
            hw = _pack2x16(torch.round(hxy[..., 0]).to(torch.int32),
                           torch.round(hxy[..., 1]).to(torch.int32))
            bits = torch.arange(hvalid.shape[-1], dtype=torch.int32,
                                device=flat.device)
            hv = (hvalid.to(torch.int32) << bits).sum(-1, dtype=torch.int32)
            return torch.cat([_pack_body(pk, cc), boxes.reshape(-1),
                              hw.reshape(-1), hv.reshape(-1)])

    def device_step(self, frames: np.ndarray,
                    orig_hw: Optional[Tuple[int, int]] = None,
                    thre1: Optional[float] = None) -> torch.Tensor:
        """frames u8 [B,Hb,Wb,3] -> packed buffer (on the device)."""
        b, hb, wb = frames.shape[:3]
        return self.device_step_flat(self.upload_frames(frames), b, hb, wb,
                                     orig_hw or (hb, wb), thre1)

    def unpack(self, packed, b: int):
        """-> (body_packed view, boxes [B*2,4] i32, hand peaks [B*2,21,2]
        i32 in bucket coords, (0,0) = missing)."""
        cfg = self.body.cfg
        c, k = cfg.njoint - 1, cfg.max_peaks
        l, m = self.body.limb_seq.shape[0], self.body.top_m
        nb = b * self.MAX_HANDS
        nh = self.hand.cfg.n_parts
        body_len = _body_pack_len(b, c, k, l, m)
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()
        packed = np.asarray(packed)
        rest = packed[body_len:]
        boxes = rest[:nb * 4].reshape(nb, 4).astype(np.int32)
        w = rest[nb * 4:nb * 4 + nb * nh].reshape(nb, nh)
        hxy = np.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], -1).astype(np.int32)
        hv = rest[nb * 4 + nb * nh:]
        hfound = ((hv.reshape(nb, 1) >> np.arange(nh)) & 1) > 0
        peaks = np.where(hfound[:, :, None], hxy, 0)
        return packed[:body_len], boxes, peaks

    def assemble(self, packed, b: int):
        """-> (per-frame (candidate, subset) list, boxes, hand peaks)."""
        body_packed, boxes, peaks = self.unpack(packed, b)
        return self.body.assemble(body_packed, b), boxes, peaks

    def hands_for_frame(self, boxes: np.ndarray, peaks: np.ndarray,
                        fidx: int, sy: float = 1.0, sx: float = 1.0):
        """Frame ``fidx``'s valid hand peaks as [21,2] int64 arrays scaled
        from bucket to original coords."""
        out = []
        for slot in range(self.MAX_HANDS):
            j = fidx * self.MAX_HANDS + slot
            if boxes[j, 3] <= 0:
                continue
            pk = peaks[j].astype(np.float64)
            pk[:, 0] *= sx
            pk[:, 1] *= sy
            out.append(np.rint(pk).astype(np.int64))
        return out
