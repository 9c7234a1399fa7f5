"""Batched frame pipelines (port of ``islx/pipeline/batch_pose.py``).

* :class:`BatchedBodyPipeline`: u8 frames in a fixed bucket -> body peaks
  and compact connections on the device, one packed buffer out, host
  grouping; islx's PAF modes, peak options, pack modes, the exact-parity
  construction and the scale pyramid.
* :class:`BatchedHandPipeline`: hand crops -> 21 keypoints each, single-
  or multi-scale, or crops cut on the device from resident frames.
* :func:`detect_hand_boxes`: the host's hand boxes from grouped
  skeletons, for the split single-image path (``pipeline/image.py``).
* :class:`FusedPosePipeline`: body CPM + on-device hand boxes + hand CPM in
  one device pass per batch, one frame upload in (u8 BGR, or I420 at 1.5
  bytes/px), one packed buffer out.

The buffer layouts are the JAX package's, word for word, so the host
``unpack``/``assemble`` code and the end-to-end comparison are shared. The
fused step's default (``bits16``):

    [xy (x | y<<16) B*C*K] [peak scores, two f16 per word B*C*K/2]
    [counts B*C] [pairs, four u8 per word B*L*M/4 (K*K <= 256)]
    [connection scores (-inf = not ok), two f16 per word B*L*M/2]
    [hand boxes B*2*4] [hand peaks (x | y<<16) B*2*21] [found bits B*2]

Each stage runs inside a ``torch.profiler.record_function`` range named
after it (``body_cpm``, ``body_peaks``, ``paf_limbs``, ``hand_boxes``,
``hand_crops``, ``hand_cpm``, ``hand_peaks``, ``pack``, ``yuv420_to_bgr``
for I420 input, and the pyramid's ``body_resize``, ``paf_average``,
``hand_resize``, ``hand_maps``), so a profile splits a step's device time
by stage (``chip_smoke.py --profile``).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from islx_torch.core import weights as W
from islx_torch.core.config import DetectorConfig, HandConfig, PoseConfig
from islx_torch.core.runtime import div, resolve_device, true_f32
from islx_torch.ops import grouping, native
from islx_torch.ops.hand_boxes import device_hand_boxes
from islx_torch.ops.hand_peaks import (HandPeaks, find_hand_peaks,
                                       find_hand_peaks_fast,
                                       find_hand_peaks_refine)
from islx_torch.ops.paf import (LIMB_TABLES, LimbScores, compact_connections,
                                score_limbs, score_limbs_cell,
                                score_limbs_fused, score_limbs_mxu)
from islx_torch.ops.paf_sample import LimbTable
from islx_torch.ops.peaks import (_pyramid_axis_fold, find_peaks,
                                  find_peaks_fused_batched,
                                  find_peaks_pyramid)
from islx_torch.ops.preprocess import pad_amounts
from islx_torch.ops.resize import (dynamic_crop_resize_batch, output_size,
                                   resize_cubic)
from islx_torch.ops.yuv import yuv420_to_bgr
from islx_torch.parallel import mesh as M
from islx_torch.pose.detector import hand_detect


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


def _pack_body(pk, cc, mode: str = "bits16") -> torch.Tensor:
    """Peak + connection tables -> one flat buffer (islx's ``_pack_body``).

    ``bits16``: int32 words, integer planes bit-packed, score planes two
    f16 a word, not-ok connection scores -inf. ``bits``: the same integer
    planes, f32 score planes bitcast, not-ok -1e30; bit-exact. ``nook``:
    f32 planes, ok folded into the score as -1e30; ``flat``: all six f32
    planes."""
    if mode in ("bits", "bits16"):
        k = pk.xy.shape[-2]
        m = cc.pair.shape[-1]
        if k * k <= 256:                   # a pair index fits a byte
            if m % 4:
                raise ValueError(f"top_m must be a multiple of 4, got {m}")
            pair = _pack4x8(cc.pair.reshape(cc.pair.shape[:-1] + (m // 4, 4)))
        else:                              # pair < K*K <= 2^15: two s16
            if k * k > 1 << 15 or m % 2:
                raise ValueError(f"cannot pack pairs for K={k}, M={m}")
            p2 = cc.pair.reshape(cc.pair.shape[:-1] + (m // 2, 2))
            pair = _pack2x16(p2[..., 0], p2[..., 1])
        xy = _pack2x16(pk.xy[..., 0], pk.xy[..., 1]).reshape(-1)
        if mode == "bits16":
            if k % 2:
                raise ValueError(f"bits16 packing needs an even max_peaks, "
                                 f"got {k}")
            neg = torch.full_like(cc.score, -float("inf"))
            return torch.cat([
                xy, _packf16x2(pk.score).reshape(-1),
                pk.count.to(torch.int32).reshape(-1), pair.reshape(-1),
                _packf16x2(torch.where(cc.ok, cc.score, neg)).reshape(-1)])
        neg = torch.full_like(cc.score, -1e30)
        return torch.cat([
            xy, pk.score.float().contiguous().view(torch.int32).reshape(-1),
            pk.count.to(torch.int32).reshape(-1), pair.reshape(-1),
            torch.where(cc.ok, cc.score, neg).contiguous().view(
                torch.int32).reshape(-1)])
    if mode not in ("nook", "flat"):
        raise ValueError(f"unknown pack mode {mode!r}")
    parts = [pk.xy.float().reshape(-1), pk.score.float().reshape(-1),
             pk.count.float().reshape(-1), cc.pair.float().reshape(-1)]
    if mode == "nook":
        parts.append(torch.where(cc.ok, cc.score,
                                 torch.full_like(cc.score, -1e30)
                                 ).reshape(-1))
    else:
        parts += [cc.score.reshape(-1), cc.ok.float().reshape(-1)]
    return torch.cat(parts)


def _pair_words(k: int, m: int) -> int:
    """Words per limb row of the packed pair plane (u8x4 or s16x2)."""
    return m // 4 if k * k <= 256 else m // 2


def _body_pack_len(b: int, c: int, k: int, l: int, m: int,
                   mode: str = "bits16") -> int:
    if mode == "bits16":
        return b * (c * k + c * (k // 2) + c + l * _pair_words(k, m)
                    + l * (m // 2))
    if mode == "bits":
        return b * (c * k * 2 + c + l * _pair_words(k, m) + l * m)
    return b * (c * k * 3 + c + (2 if mode == "nook" else 3) * l * m)


def _env_on(name: str):
    """islx's reading of an on/off switch: None when unset."""
    env = os.environ.get(name)
    return None if env is None else env not in ("0", "false")


def _on_mesh(mesh, device) -> Tuple[M.Mesh, torch.device]:
    """(the mesh a pipeline runs on, the device results land on): the 1x1
    mesh of ``device`` (default ``"cuda"``) without a mesh; with one, its
    first device (``device``, if given, must be it)."""
    if mesh is None:
        dev = resolve_device(device)
        return M.single(dev), dev
    dev = resolve_device(mesh.first)
    want = None if device is None else torch.device(device)
    if want is not None and (want.type, want.index or 0) != (
            dev.type, dev.index or 0):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{dev}")
    return mesh, dev


def _upload(mesh: M.Mesh, frames):
    """Frames (a host array, or a tensor on any device) to the device as
    flat u8, one buffer a data shard on its own device; a flat buffer goes
    whole to the first device (the step splits it by frames)."""
    frames = (frames.contiguous() if isinstance(frames, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(frames)))
    if frames.dim() == 1:
        return frames.to(mesh.first)
    return M.batch_sharding(mesh).put_flat(frames.reshape(-1),
                                           frames.shape[0])


def _host(packed) -> np.ndarray:
    return (packed.cpu().numpy() if isinstance(packed, torch.Tensor)
            else np.asarray(packed))


PAF_MODES = ("cell8", "cell", "vcell8", "fused", "take", "mxu", "exact")
PACK_MODES = ("bits16", "bits", "nook", "flat")


def detect_hand_boxes(results, hb: int, wb: int, orig_hw: Tuple[int, int],
                      max_hands: int) -> np.ndarray:
    """Per-frame (candidate, subset) in bucket coords -> fixed-count hand
    boxes [len(results)*max_hands, 4] = (frame_idx, x0, y0, w) in bucket
    coords (w <= 0 pads), islx/pipeline/batch_pose.py:86. The detection
    geometry runs in original-image coords (the reference's 20 px minimum
    is an original-pixels rule); Python ``round`` maps it back, as islx."""
    h0, w0 = orig_hw
    sy, sx = h0 / hb, w0 / wb
    boxes = np.zeros((len(results) * max_hands, 4), np.int32)
    for fidx, (cand, subset) in enumerate(results):
        if cand.shape[0] == 0:
            continue
        cand_orig = cand.copy()
        cand_orig[:, 0] *= sx
        cand_orig[:, 1] *= sy
        dets = hand_detect(cand_orig, subset, (h0, w0))
        for slot, (x, y, w, _left) in enumerate(dets[:max_hands]):
            bx = min(int(round(x / sx)), wb - 1)
            by = min(int(round(y / sy)), hb - 1)
            bw = max(min(int(round(w / sx)), wb - bx, hb - by), 1)
            boxes[fidx * max_hands + slot] = (fidx, bx, by, bw)
    return boxes


class BatchedBodyPipeline:
    """Fixed-bucket batched body pose: u8 frames -> (candidate, subset) per
    frame (islx/pipeline/batch_pose.py:226). ``core`` is the body half of
    :class:`FusedPosePipeline`'s step.

    ``params`` is a port weight state, float or int8. Options (islx's):

    * ``paf_mode``: the /8 scorers ``cell8`` (default), ``cell``,
      ``vcell8``, ``fused``, ``take``, ``mxu``, or ``exact`` (the PAF
      upsampled to the bucket and scored by the ``paf_sample`` kernel, one
      launch a frame);
    * ``fused_peaks`` (default ``two_stage_peaks``): blur folded into the
      x8 upsample, NMS on the mask kernel; otherwise the maps are upsampled
      (``resize_cubic``) and ``find_peaks`` runs the NMS+first-K kernel
      over the batch with islx's -inf border. ``paf_mode="exact",
      two_stage_peaks=False`` is islx's exact-parity construction;
    * ``pallas_nms`` (default ``ISLX_PALLAS_NMS``): the NMS+first-K kernel
      picks the fused peaks; ``pallas_mask`` (default ``ISLX_PALLAS_MASK``,
      else on, islx's TPU default): the mask kernel + row-blocked
      selection; with neither, the mask kernel + ``ISLX_PEAKS_SELECT``'s
      selection (rows or flat). The card runs a kernel for the NMS in
      every case; the peaks are the same;
    * ``ISLX_PACK_MODE``: the result buffer, ``bits16`` (default),
      ``bits`` (the exact construction's default; bit-exact), ``nook``
      or ``flat`` (:func:`_pack_body`);
    * a ``cfg.scale_search`` of more than one scale runs the scale pyramid
      (islx's ``multi_scale``), its PAF averaged on the /8 grid or, in
      exact mode, at the bucket's resolution.

    ``mesh`` (:mod:`islx_torch.parallel.mesh`; default the 1x1 mesh of
    ``device``): frames over its data axis, a copy of the net a data row
    (``nets``; ``net`` is row 0's); each shard runs the same step on its
    frames, all queued before any is read, and the packed buffer is
    assembled on the mesh's first device as the unsharded one. Its kernels
    run on every shard (islx turns its Pallas kernels off under a mesh;
    the port launches a kernel a device). ``device`` defaults to
    ``"cuda"`` (with a mesh, its first device) and raises without a GPU
    unless ``"cpu"`` is asked for."""

    def __init__(self, params, model_type: str = "body25",
                 cfg: Optional[PoseConfig] = None,
                 compute_dtype=torch.bfloat16, mesh=None, top_m: int = 48,
                 paf_mode: str = "cell8", two_stage_peaks: bool = True,
                 fused_peaks: Optional[bool] = None,
                 pallas_nms: Optional[bool] = None,
                 pallas_mask: Optional[bool] = None, device=None):
        if paf_mode not in PAF_MODES:
            raise ValueError(f"unknown paf_mode {paf_mode!r}")
        self.mesh, self.device = _on_mesh(mesh, device)
        self.params = params
        self.nets = M.replicate(self.mesh, lambda d: W.build(
            model_type, params, d, compute_dtype))
        self.model_type = model_type
        self.cfg = cfg or PoseConfig(model_type=model_type)
        self.compute_dtype = compute_dtype
        self.top_m = top_m
        self.paf_mode = paf_mode
        self.two_stage_peaks = two_stage_peaks
        self.fused_peaks = (two_stage_peaks if fused_peaks is None
                            else bool(fused_peaks))
        if pallas_nms is None:
            pallas_nms = bool(_env_on("ISLX_PALLAS_NMS"))
        self.pallas_nms = bool(pallas_nms) and self.fused_peaks
        if pallas_mask is None:
            env = _env_on("ISLX_PALLAS_MASK")
            pallas_mask = True if env is None else env
        self.pallas_mask = (bool(pallas_mask) and self.fused_peaks
                            and not self.pallas_nms)
        self.peaks_select = os.environ.get("ISLX_PEAKS_SELECT", "rows")
        self.pack_mode = os.environ.get(
            "ISLX_PACK_MODE", "bits" if paf_mode == "exact" else "bits16")
        if self.pack_mode not in PACK_MODES:
            raise ValueError(f"unknown ISLX_PACK_MODE {self.pack_mode!r}")
        self.limb_seq, self.map_idx = LIMB_TABLES[model_type]
        self.limbs = LimbTable(self.limb_seq, self.map_idx)

    # -- device --------------------------------------------------------

    @property
    def net(self):
        """Data row 0's net."""
        return self.nets[0]

    @net.setter
    def net(self, value):
        self.nets[0] = value

    def _single_scale(self, frames, thre1, hb, wb, row):
        cfg = self.cfg
        with record_function("body_cpm"):
            paf8, heat8 = self.nets[row](frames.float() / 256.0 - 0.5,
                                         self.compute_dtype)
        with record_function("body_peaks"):
            joints = heat8[..., :cfg.njoint - 1]
            if not self.fused_peaks:       # every channel, as islx resizes
                heat = resize_cubic(heat8, hb, wb)
                pk = find_peaks(heat[..., :cfg.njoint - 1].contiguous(),
                                thre1, cfg.max_peaks)
            elif self.pallas_nms or self.pallas_mask:
                pk = find_peaks_fused_batched(
                    joints, hb, wb, thre1, cfg.max_peaks,
                    kernel="mask" if self.pallas_mask else "select")
            else:                      # islx's XLA NMS: a -inf border
                pk = find_peaks_fused_batched(joints, hb, wb, thre1,
                                              cfg.max_peaks, kernel="mask",
                                              select=self.peaks_select,
                                              border=-float("inf"))
        return pk, paf8

    def _multi_scale(self, frames, thre1, hb, wb, row):
        """The scale pyramid (islx/pipeline/batch_pose.py:349-409): each
        scale's upsample -> de-pad -> back-to-bucket chain is one folded
        matrix per axis."""
        cfg = self.cfg
        n_s = len(cfg.scale_search)
        # the reference's accumulator (src/body.py:80) weighs scale s by
        # 2^(n-1-s)/n; only the heatmaps, the PAFs average correctly
        if cfg.ref_compat_averaging:
            w_heat = [2.0 ** (n_s - 1 - i) / n_s for i in range(n_s)]
        else:
            w_heat = [1.0 / n_s] * n_s
        heat8s, paf8s, folds, gfolds = [], [], [], []
        for s in cfg.scale_search:
            f = s * cfg.boxsize / hb
            hs, ws = output_size(hb, f), output_size(wb, f)
            pd, pr = pad_amounts(hs, ws, cfg.stride)
            with record_function("body_resize"):
                x = (frames.float() if (hs, ws) == (hb, wb)
                     else resize_cubic(frames, hs, ws, saturate_uint8=True))
                x = F.pad(x, (0, 0, 0, pr, 0, pd),
                          value=float(cfg.pad_value)) / 256.0 - 0.5
            with record_function("body_cpm"):
                paf8_s, heat8_s = self.nets[row](x, self.compute_dtype)
            heat8s.append(heat8_s[..., :cfg.njoint - 1])
            paf8s.append(paf8_s)
            h8p, w8p = (hs + pd) // cfg.stride, (ws + pr) // cfg.stride
            fh = _pyramid_axis_fold(hb, hs, h8p, cfg.stride)
            fw = _pyramid_axis_fold(wb, ws, w8p, cfg.stride)
            folds.append(((_pyramid_axis_fold(hb, hs, h8p, cfg.stride, 3.0),
                           _pyramid_axis_fold(wb, ws, w8p, cfg.stride, 3.0)),
                          (fh, fw)))
            # the PAF sampled back onto the bucket's /8 grid: the plain
            # fold's rows at full-resolution positions 0, stride, ...
            gfolds.append((fh[::cfg.stride], fw[::cfg.stride]))
        with record_function("body_peaks"):
            pk = find_peaks_pyramid(heat8s, folds, w_heat, thre1,
                                    cfg.max_peaks, select=self.peaks_select)
        with record_function("paf_average"), true_f32():
            mats = (gfolds if self.paf_mode != "exact"
                    else [fp for _, fp in folds])
            paf_avg = None
            for p8, (gh, gw) in zip(paf8s, mats):
                dev = p8.device
                p = torch.einsum("oh,bhwc->bowc",
                                 torch.as_tensor(gh, device=dev), p8.float())
                p = div(torch.einsum("pw,bowc->bopc",
                                     torch.as_tensor(gw, device=dev), p), n_s)
                paf_avg = p if paf_avg is None else paf_avg + p
        return pk, paf_avg

    def _limb_scores(self, paf_in, pk, hb: int, wb: int, multi: bool):
        cfg = self.cfg
        orig_h = float(np.float32(hb))
        args = (self.limb_seq, self.map_idx, cfg.stride, cfg.thre2,
                cfg.mid_num)
        mode = self.paf_mode
        if mode in ("cell", "cell8", "vcell8"):
            return score_limbs_cell(paf_in, pk.xy, pk.valid, *args,
                                    orig_h=orig_h)
        if mode == "mxu":
            return score_limbs_mxu(paf_in, pk.xy, pk.valid, *args,
                                   orig_h=orig_h)
        if mode in ("fused", "take"):
            return score_limbs_fused(paf_in, pk.xy, pk.valid, *args,
                                     orig_h=orig_h,
                                     impl="take" if mode == "take"
                                     else "reduce")
        paf = paf_in if multi else resize_cubic(paf_in, hb, wb)
        per = [score_limbs(paf[i], pk.xy[i], pk.valid[i], self.limbs,
                           cfg.thre2, cfg.mid_num, orig_h=orig_h)
               for i in range(paf.shape[0])]
        return LimbScores(score=torch.stack([p.score for p in per]),
                          ok=torch.stack([p.ok for p in per]))

    def core(self, frames: torch.Tensor, thre1: float, hb: int, wb: int,
             row: int = 0):
        """frames [B,hb,wb,3] u8-valued (data row ``row``'s, on its
        device) -> (Peaks, CompactConnections)."""
        multi = len(self.cfg.scale_search) > 1
        if multi:
            pk, paf_in = self._multi_scale(frames, thre1, hb, wb, row)
        else:
            pk, paf_in = self._single_scale(frames, thre1, hb, wb, row)
        with record_function("paf_limbs"):
            ls = self._limb_scores(paf_in, pk, hb, wb, multi)
            return pk, compact_connections(ls, self.top_m)

    def upload_frames(self, frames):
        """A frame batch as flat u8 device buffers, one a data shard (the
        fused hand pipeline's ``from_frames`` reads the same upload)."""
        return _upload(self.mesh, frames)

    @torch.inference_mode()
    def device_step_flat(self, flat, b: int, hb: int, wb: int,
                         thre1: Optional[float] = None) -> torch.Tensor:
        """flat u8 frames on the device (one buffer, or ``upload_frames``'
        shards) -> the packed result buffer (on the device); ``thre1``
        overrides the config's peak threshold."""
        t1 = float(np.float32(self.cfg.thre1 if thre1 is None else thre1))
        sharding = M.batch_sharding(self.mesh)
        pk, cc = sharding.gather([
            self.core(s.reshape(-1, hb, wb, 3), t1, hb, wb, row)
            for row, s in enumerate(sharding.put_flat(flat, b))])
        with record_function("pack"):
            return _pack_body(pk, cc, self.pack_mode)

    def device_step(self, frames, thre1: Optional[float] = None
                    ) -> torch.Tensor:
        """frames u8 [B,Hb,Wb,3] (bucketed; a host array, or a tensor on
        any device) -> packed buffer."""
        b, hb, wb = frames.shape[:3]
        return self.device_step_flat(self.upload_frames(frames), b, hb, wb,
                                     thre1)

    # -- host ----------------------------------------------------------

    def unpack(self, packed, b: int):
        """Packed buffer -> (xy, score, count, pair, cscore, cok) numpy."""
        c = self.cfg.njoint - 1
        k = self.cfg.max_peaks
        l = self.limb_seq.shape[0]
        m = self.top_m
        packed = _host(packed)
        if self.pack_mode in ("bits", "bits16"):
            half = self.pack_mode == "bits16"
            sizes = [b * c * k, b * c * (k // 2 if half else k), b * c,
                     b * l * _pair_words(k, m),
                     b * l * (m // 2 if half else m)]
            parts = np.split(np.ascontiguousarray(packed),
                             np.cumsum(sizes)[:-1])
            w = parts[0].reshape(b, c, k)
            xy = np.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], -1
                          ).astype(np.int32)
            if half:
                score = _unpackf16x2(parts[1]).reshape(b, c, k)
                cscore = _unpackf16x2(parts[4]).reshape(b, l, m)
                cok = cscore > -6e4   # sentinel is f16 -inf
            else:
                score = parts[1].view(np.float32).reshape(b, c, k)
                cscore = parts[4].view(np.float32).reshape(b, l, m)
                cok = cscore > -1e29
            count = parts[2].reshape(b, c).astype(np.int32)
            if k * k <= 256:
                pair = parts[3].view(np.uint8).astype(np.int32).reshape(
                    b, l, m)
            else:
                pair = parts[3].view(np.uint16).astype(np.int32).reshape(
                    b, l, m)
            return xy, score, count, pair, np.where(cok, cscore, 0.0), cok
        sizes = [b * c * k * 2, b * c * k, b * c, b * l * m, b * l * m]
        if self.pack_mode != "nook":
            sizes.append(b * l * m)
        parts = np.split(packed, np.cumsum(sizes)[:-1])
        xy = parts[0].reshape(b, c, k, 2).astype(np.int32)
        score = parts[1].reshape(b, c, k)
        count = parts[2].reshape(b, c).astype(np.int32)
        pair = parts[3].reshape(b, l, m).astype(np.int32)
        cscore = parts[4].reshape(b, l, m)
        if self.pack_mode == "nook":
            cok = cscore > -1e29
            cscore = np.where(cok, cscore, 0.0)
        else:
            cok = parts[5].reshape(b, l, m) > 0.5
        return xy, score, count, pair, cscore, cok

    def assemble(self, packed, b: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Packed buffer -> per-frame (candidate, subset): the whole batch
        in one call of the C++ grouping (:mod:`islx_torch.ops.native`), or
        frame by frame in numpy where ``ISLX_NO_NATIVE`` is set, as islx
        chooses."""
        xy, score, count, pair, cscore, cok = self.unpack(packed, b)
        if native.enabled():
            return native.assemble_batch(xy, score, count, pair, cscore, cok,
                                         self.cfg.max_peaks, self.limb_seq,
                                         self.cfg.njoint)
        return [grouping.assemble_sorted(
            xy[i], score[i], count[i], pair[i], cscore[i], cok[i],
            self.cfg.max_peaks, self.limb_seq, self.cfg.njoint)
            for i in range(b)]

    def __call__(self, frames: np.ndarray,
                 orig_hw: Optional[Tuple[int, int]] = None,
                 thre1: Optional[float] = None
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """frames u8 [B,Hb,Wb,3] -> per-frame (candidate, subset), peak
        coordinates scaled back to ``orig_hw`` when it is given."""
        b, hb, wb = frames.shape[:3]
        out = self.assemble(self.device_step(frames, thre1), b)
        if orig_hw is not None:
            sy, sx = orig_hw[0] / hb, orig_hw[1] / wb
            for cand, _ in out:
                if cand.shape[0]:
                    cand[:, 0] *= sx
                    cand[:, 1] *= sy
        return out


class BatchedHandPipeline:
    """Fixed-bucket batched hand pose (islx/pipeline/batch_pose.py:573):
    u8 crops [N,S,S,3] -> peaks [N,21,2] (``__call__``), or crops cut on
    the device from resident frames (``core``, ``from_frames``: the hand
    half of :class:`FusedPosePipeline`'s step, single-scale).

    ``__call__`` at one scale resizes the crops to the scale, runs the CPM
    and the coarse-to-fine peaks; at several it averages each scale's
    heatmap (upsampled, de-padded, resized back to S) and takes the peaks
    of the average with ``peak_mode`` ``"cc"`` (connected components: the
    ``cc_label`` kernel over all N crops' planes) or ``"fast"`` (global
    maximum). ``crop_chunk`` is islx's compile-time knob; it changes no
    result and the port computes the crops in one batch. ``mesh`` (default
    the 1x1 mesh of ``device``): the crops (or boxes) over its data axis,
    a copy of the net a data row (``nets``; ``net`` is row 0's); a box may
    name a frame another shard holds, and ``from_frames`` copies each
    shard the frames its boxes name (islx all-gathers the frame
    buffer)."""

    def __init__(self, params, cfg: Optional[HandConfig] = None,
                 crop_size: int = 368, compute_dtype=torch.bfloat16,
                 mesh=None, peak_mode: str = "cc",
                 crop_chunk: Optional[int] = None, device=None):
        if peak_mode not in ("cc", "fast"):
            raise ValueError(f"unknown peak_mode {peak_mode!r}")
        self.mesh, self.device = _on_mesh(mesh, device)
        self.params = params
        self.nets = M.replicate(self.mesh, lambda d: W.build(
            "hand", params, d, compute_dtype))
        self.cfg = cfg or HandConfig()
        self.crop_size = crop_size
        self.compute_dtype = compute_dtype
        self.peak_mode = peak_mode
        self.crop_chunk = crop_chunk

    @property
    def net(self):
        """Data row 0's net."""
        return self.nets[0]

    @net.setter
    def net(self, value):
        self.nets[0] = value

    def _forward(self, x: torch.Tensor, row: int) -> torch.Tensor:
        with record_function("hand_cpm"):
            return self.nets[row](x, self.compute_dtype, self.cfg.stages)

    def run_scale(self, crops: torch.Tensor, s: float,
                  row: int = 0) -> torch.Tensor:
        """crops [N,S,S,3] u8-valued -> the scale's heatmap [N,size,size,
        22] (resized to size = rint(s * boxsize), stride-padded,
        normalized, CPM, x8 upsample, de-padded)."""
        cfg = self.cfg
        size = int(np.rint(s * cfg.boxsize))
        pd, pr = pad_amounts(size, size, cfg.stride)
        with record_function("hand_resize"):
            x = (crops.float() if size == self.crop_size
                 else resize_cubic(crops, size, size, saturate_uint8=True))
            x = F.pad(x, (0, 0, 0, pr, 0, pd),
                      value=float(cfg.pad_value)) / 256.0 - 0.5
        heat = self._forward(x, row)
        with record_function("hand_maps"):
            return resize_cubic(heat, size + pd, size + pr)[:, :size, :size]

    @torch.inference_mode()
    def peaks(self, crops: torch.Tensor, row: int = 0
              ) -> Tuple[HandPeaks, float]:
        """crops [N,S,S,3] on data row ``row``'s device -> (HandPeaks, the
        factor from the peaks' coords to crop coords)."""
        cfg = self.cfg
        s0 = self.crop_size
        if len(cfg.scale_search) == 1:
            # no full-resolution upsample: coarse peak at net resolution +
            # a local cubic refinement, in the scale's coords
            size = int(np.rint(cfg.scale_search[0] * cfg.boxsize))
            with record_function("hand_resize"):
                x = (crops.float() if size == s0 else resize_cubic(
                    crops, size, size, saturate_uint8=True))
            heat = self._forward(x / 256.0 - 0.5, row)
            with record_function("hand_peaks"):
                pk = find_hand_peaks_refine(heat[..., :cfg.n_parts], cfg.thre)
            return pk, float(np.float32(s0 / size))
        heat_sum = None
        for s in cfg.scale_search:
            m = self.run_scale(crops, s, row)
            with record_function("hand_maps"):
                m = div(resize_cubic(m, s0, s0), len(cfg.scale_search))
                heat_sum = m if heat_sum is None else heat_sum + m
        with record_function("hand_peaks"):
            fn = (find_hand_peaks if self.peak_mode == "cc"
                  else find_hand_peaks_fast)
            return fn(heat_sum[..., :cfg.n_parts], cfg.thre), 1.0

    def __call__(self, crops: np.ndarray) -> np.ndarray:
        """crops u8 [N,S,S,3] (S = crop_size) -> peaks [N,21,2] int32 in
        crop coords, (0, 0) where a part is missing."""
        sharding = M.batch_sharding(self.mesh)
        outs = [self.peaks(s, row) for row, s in enumerate(
            sharding.put(torch.from_numpy(np.ascontiguousarray(crops))))]
        pk, scale = sharding.gather([o[0] for o in outs]), outs[0][1]
        xy = pk.xy.cpu().numpy().astype(np.float64) * scale
        found = pk.found.cpu().numpy()
        return np.where(found[:, :, None], np.rint(xy).astype(np.int32), 0)

    def core(self, frames: torch.Tensor, boxes: torch.Tensor, row: int = 0):
        """frames [b,hb,wb,3], boxes [N,4] int32 (frame, x0, y0, w; w <= 0
        invalid), on data row ``row``'s device -> (xy [N,21,2] f32 in
        frame coords, valid [N,21])."""
        cfg = self.cfg
        if len(cfg.scale_search) != 1:
            raise ValueError("the crops-from-frames hand path is "
                             "single-scale")
        size = int(np.rint(cfg.scale_search[0] * cfg.boxsize))
        with record_function("hand_crops"):
            crops = dynamic_crop_resize_batch(
                frames, boxes[:, 0], boxes[:, 1], boxes[:, 2],
                torch.clamp_min(boxes[:, 3], 1), size)      # [N,s,s,3]
        with record_function("hand_cpm"):
            heat = self.nets[row](crops / 256.0 - 0.5, self.compute_dtype,
                                  cfg.stages)
        with record_function("hand_peaks"):
            pk = find_hand_peaks_refine(heat[..., :cfg.n_parts], cfg.thre)
        scale = div(boxes[:, 3:4].float(), size)
        xy = (pk.xy.float() * scale[:, :, None]
              + boxes[:, None, 1:3].float())
        valid = (boxes[:, 3] > 0)[:, None] & pk.found
        return xy, valid

    @torch.inference_mode()
    def from_frames(self, frames_flat, b: int, hb: int, wb: int,
                    boxes: np.ndarray) -> np.ndarray:
        """frames_flat: the flat u8 device buffer of [b,hb,wb,3] (or
        ``upload_frames``' shards); boxes [N,4] (frame_idx, x0, y0, w) in
        frame coords, w <= 0 pads -> peaks [N,21,2] int32 in frame coords
        ((0, 0) = missing). The boxes split over the data axis; each shard
        copies the frames its boxes name from the shards that hold them."""
        sharding = M.batch_sharding(self.mesh)
        frames = [f.reshape(-1, hb, wb, 3)
                  for f in sharding.put_flat(frames_flat, b)]
        boxes = np.ascontiguousarray(boxes, np.int32)
        cuts = np.cumsum(M.split_sizes(len(boxes),
                                       self.mesh.shape[M.DATA_AXIS]))
        outs = []
        for row, (part, dev) in enumerate(zip(np.split(boxes, cuts[:-1]),
                                              self.mesh.data_devices)):
            mine, idx = M.gather_rows(frames, part[:, 0], dev)
            local = part.copy()
            local[:, 0] = idx
            outs.append(self.core(mine, torch.from_numpy(local).to(dev),
                                  row))
        xy, valid = sharding.gather(outs)
        xy, valid = xy.cpu().numpy(), valid.cpu().numpy()
        return np.where(valid[:, :, None], np.rint(xy).astype(np.int32), 0)


class FusedPosePipeline:
    """Body CPM + on-device hand boxes + hand CPM in one device pass.

    ``body_params``/``hand_params`` are port weight states
    (:mod:`islx_torch.core.weights`), float or int8 W8A8
    (:mod:`islx_torch.models.quant`), kept as ``body.params`` and
    ``hand.params`` (the server's int8 swap calibrates them); ``device``
    defaults to ``"cuda"`` and raises when no GPU is present unless
    ``"cpu"`` is asked for; ``pallas_nms`` is :class:`BatchedBodyPipeline`'s,
    and so is the pack mode (``ISLX_PACK_MODE``). ``mesh`` (default the
    1x1 mesh of ``device``): frames over its data axis, a copy of both
    nets a data row; each shard runs the whole step on its frames (a frame's hand boxes name its own frame, so
    no frame crosses shards), every shard is queued before any is read,
    and the packed buffer is assembled on the mesh's first device, the
    same words as the unsharded step's.

    ``_programs`` records the :meth:`program_key` of every shape the
    pipeline has stepped, in first-step order. islx compiles one program a
    key; the port compiles none, but the server's per-bucket LRU
    (:meth:`drop_programs`) and its int8 swap's warm-up read these keys."""

    MAX_HANDS = 2

    def __init__(self, body_params, hand_params, model_type: str = "body25",
                 pose_cfg: Optional[PoseConfig] = None,
                 hand_cfg: Optional[HandConfig] = None,
                 det_cfg: Optional[DetectorConfig] = None,
                 compute_dtype=torch.bfloat16, top_m: int = 48,
                 crop_chunk: Optional[int] = None, mesh=None, device=None,
                 pallas_nms: Optional[bool] = None):
        self.mesh, self.device = _on_mesh(mesh, device)
        self.body = BatchedBodyPipeline(
            body_params, model_type,
            pose_cfg or PoseConfig(model_type=model_type, max_peaks=16),
            compute_dtype=compute_dtype, mesh=self.mesh, top_m=top_m,
            pallas_nms=pallas_nms, device=self.device)
        self.hand = BatchedHandPipeline(
            hand_params, hand_cfg or HandConfig.production(),
            compute_dtype=compute_dtype, mesh=self.mesh,
            crop_chunk=crop_chunk, device=self.device)
        self.det_cfg = det_cfg or DetectorConfig()
        self.model_type = model_type
        self._programs: Dict[tuple, None] = {}
        self._programs_lock = threading.Lock()

    def program_key(self, b: int, hb: int, wb: int,
                    orig_hw: Tuple[int, int],
                    input_format: str = "bgr") -> tuple:
        """The key a step with these shapes records (islx's program-cache
        key: batch, bucket, the bucket-to-frame scales and the input
        format)."""
        return (b, hb, wb, float(orig_hw[0] / hb), float(orig_hw[1] / wb),
                input_format)

    def program_keys(self) -> List[tuple]:
        """The keys stepped so far, oldest first."""
        with self._programs_lock:
            return list(self._programs)

    def drop_programs(self, hb: int, wb: int) -> None:
        """Forget every key of bucket (hb, wb): the server bounds the
        buckets it keeps live (:class:`islx_torch.serve.MicroBatcher`).

        islx frees the bucket's compiled XLA programs here. The port keeps
        no per-bucket device state to free: the steps' interpolation and
        blur matrices are small host arrays in bounded LRU caches keyed by
        axis lengths (``ops/peaks.py``, ``ops/resize.py``), shared by every
        bucket of the same height, and are copied to the device at each
        step. So only the keys go."""
        with self._programs_lock:
            for key in [k for k in self._programs if k[1:3] == (hb, wb)]:
                del self._programs[key]

    def upload_frames(self, frames):
        """A frame batch (u8 BGR or I420 bytes; a host array, or a tensor on
        any device) as flat device buffers, one a data shard."""
        return _upload(self.mesh, frames)

    def _step(self, flat: torch.Tensor, b: int, hb: int, wb: int,
              t1: float, sy: float, sx: float, input_format: str,
              first: int, row: int):
        """Data row ``row``'s step on its ``b`` frames, the batch's frames
        from ``first`` on -> (peaks, connections, hand boxes [b*2,4]
        naming batch frames, hand xy, hand valid) on the row's device."""
        if input_format == "yuv420":
            with record_function("yuv420_to_bgr"):
                frames = yuv420_to_bgr(flat, b, hb, wb)
        elif input_format == "bgr":
            frames = flat.reshape(b, hb, wb, 3)
        else:
            raise ValueError(f"unknown input_format {input_format!r}")
        pk, cc = self.body.core(frames, t1, hb, wb, row)
        with record_function("hand_boxes"):
            boxes2 = device_hand_boxes(pk.xy, cc.pair, cc.score, cc.ok,
                                       self.body.limb_seq, sy, sx, hb, wb,
                                       self.det_cfg)             # [B,2,3]
            fidx = torch.arange(b, dtype=torch.int32, device=frames.device)
            fidx = fidx[:, None, None].expand(b, self.MAX_HANDS, 1)
            boxes = torch.cat([fidx, boxes2], -1).reshape(
                b * self.MAX_HANDS, 4)
        hxy, hvalid = self.hand.core(frames, boxes, row)
        if first:
            boxes = boxes + torch.tensor([first, 0, 0, 0], dtype=torch.int32,
                                         device=boxes.device)
        return pk, cc, boxes, hxy, hvalid

    @torch.inference_mode()
    def device_step_flat(self, flat, b: int, hb: int, wb: int,
                         orig_hw: Tuple[int, int],
                         thre1: Optional[float] = None,
                         input_format: str = "bgr") -> torch.Tensor:
        """flat u8 frames on the device -> packed int32 result buffer.

        input_format: ``"bgr"`` ([b*hb*wb*3]) or ``"yuv420"`` (I420 planes,
        [b*hb*wb*3/2]); ``flat`` is one buffer or ``upload_frames``'
        shards."""
        t1 = float(np.float32(self.body.cfg.thre1 if thre1 is None
                              else thre1))
        key = self.program_key(b, hb, wb, orig_hw, input_format)
        with self._programs_lock:
            self._programs[key] = None
        sy, sx = key[3], key[4]
        sharding = M.batch_sharding(self.mesh)
        outs, first = [], 0
        for row, (shard, n) in enumerate(zip(
                sharding.put_flat(flat, b),
                M.split_sizes(b, self.mesh.shape[M.DATA_AXIS]))):
            outs.append(self._step(shard, n, hb, wb, t1, sy, sx,
                                   input_format, first, row))
            first += n
        pk, cc, boxes, hxy, hvalid = sharding.gather(outs)
        mode = self.body.pack_mode
        with record_function("pack"):
            body = _pack_body(pk, cc, mode)
            if mode not in ("bits", "bits16"):
                return torch.cat([body, boxes.float().reshape(-1),
                                  hxy.reshape(-1),
                                  hvalid.float().reshape(-1)])
            # hand coords rounded on the device, as islx's bits modes do
            hw = _pack2x16(torch.round(hxy[..., 0]).to(torch.int32),
                           torch.round(hxy[..., 1]).to(torch.int32))
            if mode == "bits16":           # 21 found bits in one word
                bits = torch.arange(hvalid.shape[-1], dtype=torch.int32,
                                    device=self.device)
                hv = (hvalid.to(torch.int32) << bits).sum(-1,
                                                          dtype=torch.int32)
            else:
                hv = hvalid.to(torch.int32)
            return torch.cat([body, boxes.reshape(-1), hw.reshape(-1),
                              hv.reshape(-1)])

    def device_step(self, frames,
                    orig_hw: Optional[Tuple[int, int]] = None,
                    thre1: Optional[float] = None) -> torch.Tensor:
        """frames u8 [B,Hb,Wb,3] (a host array, or a tensor on any device,
        as the batcher passes its resized batch) -> packed buffer (on the
        device)."""
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
        mode = self.body.pack_mode
        body_len = _body_pack_len(b, c, k, l, m, mode)
        packed = _host(packed)
        rest = packed[body_len:]
        boxes = rest[:nb * 4].reshape(nb, 4).astype(np.int32)
        if mode not in ("bits", "bits16"):
            hxy = rest[nb * 4:nb * 4 + nb * nh * 2].reshape(nb, nh, 2)
            hfound = rest[nb * 4 + nb * nh * 2:].reshape(nb, nh) > 0.5
            peaks = np.where(hfound[:, :, None],
                             np.rint(hxy).astype(np.int32), 0)
            return packed[:body_len], boxes, peaks
        w = rest[nb * 4:nb * 4 + nb * nh].reshape(nb, nh)
        hxy = np.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], -1).astype(np.int32)
        hv = rest[nb * 4 + nb * nh:]
        if mode == "bits16":               # 21-bit masks, a word a hand
            hfound = ((hv.reshape(nb, 1) >> np.arange(nh)) & 1) > 0
        else:
            hfound = hv.reshape(nb, nh) > 0
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
