"""Drive the PyTorch/CUDA port (islx_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and the last line is never printed):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile the five CUDA kernel sources from islx_torch/csrc (one
   nvcc a source, sm_90a) and the C++ grouping (g++), all started
   together;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (masks, indices, labels and ok bits bit-equal),
   with median times over 20 launches beside the bound; the NMS mask on
   smooth maps and on maps with peaks where its row bands meet, also timed
   as calls queued back to back (the device's time); NMS+first-K on sparse
   maps (whole planes read, peaks in the last rows), dense ones (early
   exit) and maps with peaks where its row bands meet, K = 32 and K = 1;
   the PAF scoring kernel at the parity Body's shape, timed single and back
   to back beside an empty kernel's back-to-back time, and bit-equal at
   mid 1, 2, 4, 7, 8, 11 and 16-20, with the COCO table, with channels
   other than (cx, cx + 1) pairs, off an 8-byte boundary, and with invalid
   peaks outside the map; the bound counts the distinct sectors read; the plain
   PAF scoring on the card bit-equal to the CPU's; the labelling kernel on
   blob maps and on maps built to break a tiled labeller, timed single and
   back to back; the int8 conv kernel bit-equal at every distinct conv
   shape of the int8 BODY_25 (184x144 bucket) and hand nets (160 and 184
   px crops) in each output mode they use (conv1_1 as the 1x1 conv over
   its 27 patch channels), and on ragged shapes, timed at four shapes
   (TIMED_CONVS: the dominant 7x7, a hand-trunk 3x3, a BODY_25 dense-block
   3x3 and conv1_1's patches) single and back to back beside its bound
   and torch._int_mm's GEMM; the activation quantize kernel bit-equal at
   the int8 step's input shapes, in patch mode too, timed;
4. fused pose step at full width (BODY_25 + hand CPM, bf16, seeded random
   weights): B=192 frames at the 184x144 bucket from I420, for the gated
   hand config (184 px, 6 stages) and for 160 px / 5 stages; the launch
   counters must show the main path went through every kernel; each
   step's 384 hand crops, cut on the card from its frames, word-equal to
   the CPU function's on the same inputs; the same step in f32 on a small
   input must match the plain CPU path, hand peaks included;
4c. the fused-160s5 step with int8 W8A8 CPMs, the seeded weights
   quantized by the port's calibration on the phase's frames: conv_q must
   launch once a conv (159 a step) and quantize once an unchained conv
   (109); one more step holds every one of those calls word for word
   against its plain version on the same inputs, at the batch, map size
   and calibrated scales the step gives it; and the same int8 step in f32
   on a small input must match the plain CPU path;
4b. the fused-184s6 step again with ``pallas_nms=True`` (the NMS+first-K
   kernel): its packed buffer's integer planes word-equal to phase 4's;
5. translation: BatchedTranslatePipeline at batch 16 over 48 seeded
   720x1280 frames (bucket 184x328, I420), frames - 19 predictions, with
   the host's ms by stage (dispatch, fetch_group, featurize, head);
5b. serving through islx_torch.serve at full width (BODY_25 + the gated
   hand CPM, bf16, thre2 -0.5 and thre1 lowered from phase 4's until the
   burst forms a person a frame and a hand box): a burst of
   8 frames served word-equal to a direct step, with at least one person
   and one hand; the grouping of a B=8 and a B=32 step timed in C++ and
   in numpy (same people); load for 10 s a pass from 4 and 16 clients
   over the 184x144 and 184x328 buckets at max_batch 8 and 32 (frames/s,
   request p50/p99, the NMS mask kernel once a batch); one served B=8
   batch under torch.profiler (device ms, busy share); the live int8 swap
   on 184x184 frames, landing within a deadline, whose first full int8
   batch launches conv_q and quantize once a conv, holds each of those
   calls word for word against its plain version, and is word-equal to a
   pipeline quantized directly on the stored calibration frames; the NMS
   mask calls of the served batches held bit for bit against the plain
   version at every served shape; GET /healthz over HTTP;
5c. dataset extraction (islx_torch.isl.extract) at full width from
   memory: 48 seeded 184x328 frames, augmentation on (the card's rotated
   frames word-equal to the CPU's), the serving phase's weights and
   threshold rule; the fused path at batch 16 in bf16 and with int8 CPMs,
   a resume after a third of the records are deleted (only those written
   again, same bytes), two shards over four videos, and the exact
   per-frame path over 8 frames; every record byte-equal to a direct
   step's, every kernel call held against its plain version, frames/s a
   leg (the fused legs once more unwatched, same bytes);
5d. training at full width: the translator head (default config, batch
   32) on windows built from 5c's records by isl/dataset.build_windows,
   fit for 4 epochs, interrupted after one and resumed (bit-equal to an
   uninterrupted run), saved as .npz and in a bundle and reloaded through
   cli/translate's loaders (the same probabilities); BODY_25 and the hand
   CPM through cli/pose_train._train_flat on 8 seeded 184x184 samples at
   batch 8, f32 and bf16, 6 steps each (the loss falls on the fixed
   batch), the hand once more deep-supervised with pos_weight 2; on one
   batch the card's loss and gradients against the CPU's (the CPMs' on
   64x64 corners); ms/step, samples/s and peak memory beside the card
   line; no kernel of the port launches (training runs none);
5e. serving warm starts (islx_torch.core.aot): serve-184s6 (5b's weights,
   thre1 and thre2, B=8, 184x144 frames) answered first in fresh processes,
   each on a copy of islx_torch without a build directory, the seconds to
   the first response split into import, build (library builds, installs
   and loads), construction and first step: cold (empty build directory:
   nms_mask.cu and grouping.cpp compiled), restart (the cold copy's
   libraries present, no artifact), warm (an artifact written by
   cli/export_programs.export in this process, on the libraries it
   loaded, then loaded by MicroBatcher(aot_dir=), with an nvcc and a g++
   that fail first on PATH and CUDA_HOME at an empty toolkit, so any
   compile raises) and int8 warm (an artifact of the export CLI's
   ``--int8``, run in this process, serving int8 states of the same
   weights quantized here); the warm legs must hold the key before
   traffic with no request counted, compile nothing and load nothing in
   their first step;
   the first responses' integer words equal the cold leg's (bf16) and this
   process's int8 step on the same frames and states (int8); each leg
   serves the frames once more with every NMS mask call (and conv_q and
   quantize call) held against its plain version, and launches the cold
   leg's kernels (int8: nms_mask_rows, conv_q and quantize);
6. the reference-parity path at full width in f32: ``ISLSignPos(Body,
   Hand)`` on a seeded 720x1280 frame and ``Hand`` on two 256x256 crops;
   the launch counters must show the NMS+first-K, PAF-sampling and
   labelling kernels on it; the same path on a small frame must match the
   plain CPU path;
6b. the single-image path and the split pipelines at full width (BODY_25,
   COCO and the hand CPM, seeded weights with the arm joints' heat
   raised, thre2 -0.5 and thre1 lowered until people and hands form), the
   launch counters set to 0 at its start: ImagePose fused and split, bf16,
   on 8 frames of the 184x328 bucket (each result == a direct fused step,
   or a body step -> detect_hand_boxes -> from_frames; every NMS mask
   launch bit-equal; the split crops == the CPU's words; ms per call);
   ImagePose with int8 CPMs (one call's conv_q and quantize calls held
   word for word; ms per call); BatchedBodyPipeline alone at B=192 in the
   184x144 bucket (integer planes == phase 4's fused step's body half;
   frames/s); the exact-parity construction over 4 frames (nms_first_k
   and paf_sample launches bit-equal; each frame == the parity Body's;
   ms per frame); the body pyramid (0.5, 1.0) over 4 frames; the hand
   pyramid (0.5-2.0) over 8 seeded 368 px crops, cc (cc_label launches
   bit-equal, each crop == the parity Hand's) and fast, and the labelling
   of the 8x21 planes in one call against 8 calls; a COCO ImagePose call;
   small f32 runs (split, exact, pyramid; BODY_25 and COCO) card == CPU;
   every kernel must have launched;
6c. the offline tools and the Caffe API at full width, the launch
   counters set to 0 at its start: seeded BODY_25 and hand states written
   as .caffemodel files by a wire-format writer in this script (about 104
   and 147 MB), read with weights.load (seconds a file; equal word for
   word) and converted to .npz by cli/convert; the fused step at B=192 in
   184x144 from I420 (bf16, the gated hand config) on the .caffemodel
   weights, its NMS mask launch bit-equal, its integer planes word-equal
   to the same step on the .npz weights; profiling.trace around one more
   step (the Chrome trace names body_cpm and nms_mask_kernel); the quantize
   CLI's core on frames already at their target sizes (no cv2 here: a
   same-size resize is a copy), its state files reloaded with
   weights.load and one int8 fused-160s5 step on them with every conv_q
   and quantize call word-equal to its plain version; core/caffe_net.Net
   on the hand CPM (a prototxt from the port's conv table, the
   .caffemodel's weights) at 368x368 in f32 with TF32 off, within 1e-4
   (relative) of the port's f32 hand CPM and of the same Net on the CPU,
   and SGDSolver with an EuclideanLoss at batch 4 for 5 steps on the card
   and on the CPU (the loss falls; each step's loss within 1e-4 of the
   CPU's; the params' update within 1e-3 of the CPU's by norm, each
   blob's within 5e-2), ms per forward and per step; a burst of 8 COCO
   frames served word-equal to a direct step; nms_mask_rows, conv_q and
   quantize must have launched and no other kernel. The .keras writers
   are not run here: this machine has no h5py or keras;
6d. multi-device (islx_torch.parallel), the launch counters set to 0 at
   its start: ``torch.cuda.device_count()`` and the devices of every mesh
   (with one card every shard shares cuda:0: no copies between cards, no
   NCCL across cards); over a data mesh of 2 (a copy of each net a data
   row): the fused-184s6 bf16 step and the int8 fused-160s5 step at
   B=192, full width, on phase 6b's weights and threshold rule so that
   hand boxes form on every shard, their integer planes equal to the
   unsharded step's on each shard's frames (the words apart from the
   unsharded whole-batch step recorded), one step with every shard's NMS
   mask call and, under int8, every conv_q and quantize call held against
   its plain version, ms/step and frames/s in turns with the unsharded
   step; a burst of 8 frames served on the data mesh equal to direct
   steps; the multi-scale hand pipeline (cc peaks, every shard's
   cc_label call held bit-equal) and ``from_frames`` with boxes naming
   the other shard's frames, equal to the unsharded pipeline on each
   shard's crops and boxes; a BODY_25 f32 train step (gradients and
   Adam's first moments within 1e-3 of the unsharded step's); the
   spatial BODY_25 forward at 368x656 over two width stripes (f32
   without TF32 within 1e-4 of the single forward's largest output; bf16
   timed beside the single forward); PipelinedCPM on BODY_25 over 3
   segments at batch 4, 184x184, forward and f32 gradients (forward and
   backward without TF32) against the unsharded net, the forwards timed;
   one tensor-parallel head step on a (2, 2) mesh against the unsharded
   step (loss, weights, first moments); init_distributed in a world of
   the card count (NCCL, a worker process a further card); nms_mask_rows,
   conv_q, quantize and label_components must have launched and no other
   kernel;
7. device ms per launch (torch.profiler), after the timed phases, so
   that no profiler runs before them: the labelling kernel's launches, and
   the PAF kernel at phase 3's shape (inputs warm in L2, and L2 flushed
   before each launch) and inside phase 6's Body call;
8. a JSON line of the kernels' numbers, then the card line again, then
   ``{"ok": true, "device": {...}}`` as the last line.

    python3 chip_smoke.py --profile

runs phases 1-2, then profiles the fused step of phase 4 for both hand
configs and the int8 step of phase 4c with torch.profiler: device ms per
pipeline stage, the kernels that take the most device time, the port's
own kernels' device time (the int8 convs are conv_q_kernel's: the stage
ranges do not count them), the device's busy share of the steps' wall
time and the CPM convolutions' achieved rate; then one parity Body call
(720x1280) and one Hand call (256 px, four scales), and one ImagePose
call of each mode (phase 6b's), by their stage ranges; as one JSON
line.

    python3 chip_smoke.py --kernels

runs phases 1-3 and 7 only and prints their numbers as one JSON line;
``--single`` runs phases 1-2 and 6b only, ``--tools`` phases 1-2 and 6c,
``--mesh`` phases 1-2 and 6d, ``--aot`` phases 1-2 and 5e.

The script imports nothing of JAX or of the JAX package ``islx``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stream_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn`` over ``reps`` calls queued back to back between
    two CUDA events: the device's time where the host queues faster than
    the device runs, else the host's."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def smooth_field(shape, gen, thre: float) -> torch.Tensor:
    """Seeded smooth maps [B,C,H,W] on the card with planted plateaus and
    pixels equal to the threshold (the >= and > edge cases)."""
    bsz, c, h, w = shape
    lo = torch.rand((bsz, c, max(h // 8, 1), max(w // 8, 1)),
                    device="cuda", generator=gen)
    x = torch.nn.functional.interpolate(lo, size=(h, w), mode="bilinear",
                                        align_corners=False).contiguous()
    x[:, :, 5:8, 9:12] = 0.9                   # 3x3 plateau above thre
    x[:, :, h // 2, :] = thre                  # a row exactly at thre
    x[:, :, :, -1] = 0.95                      # plateau along the border
    return x


def planted_field(shape, gen, thre: float, k: int, per_plane: int = 4
                  ) -> torch.Tensor:
    """smooth_field clipped to thre, so that only planted pixels peak: up to
    ``per_plane`` isolated maxima above thre at seeded places in each plane
    (the sparsity of a calibrated heatmap), plus late ones: the last pixel
    of plane 0, a pixel of plane 1's last row, and k + 8 evenly spaced
    maxima in plane 2, whose K-th falls late in the plane."""
    bsz, c, h, w = shape
    n = h * w
    x = torch.clamp_max(smooth_field(shape, gen, thre), thre)
    flat = x.view(bsz * c, n)
    pos = torch.randint(0, n, (bsz * c, per_plane), device="cuda",
                        generator=gen)
    vals = thre + 0.01 + 0.01 * torch.rand((bsz * c, per_plane),
                                           device="cuda", generator=gen)
    keep = (torch.arange(per_plane, device="cuda")
            < torch.randint(0, per_plane + 1, (bsz * c, 1), device="cuda",
                            generator=gen))
    flat.scatter_(1, pos, torch.where(keep, vals, flat.gather(1, pos)))
    flat[0, n - 1] = thre + 0.02
    flat[1 % (bsz * c), n - 1 - w // 2] = thre + 0.02
    if bsz * c > 2:
        spaced = torch.linspace(0, n - 1, k + 8, device="cuda").long()
        flat[2, spaced] = thre + 0.02
    return x


def band_field(shape, gen, thre: float, k: int) -> torch.Tensor:
    """Maps whose peaks sit where the NMS+first-K kernel's row bands meet
    (``nms_first_k.band_plan``). Planes by index mod 4: 0, peaks on the
    first and the last row of every band and a plateau across each band
    boundary; 1, k + 3 peaks in band 0 alone and 2k in every later band;
    2, k - 1 peaks in band 0 and 3 in the last band, so the k-th peak lies
    in the last band; 3, k // 2 peaks over the plane, fewer than k. Every
    other pixel is at most thre."""
    from islx_torch.ops.nms_first_k import band_plan

    bsz, c, h, w = shape
    n = h * w
    rows, bands, _ = band_plan(h, w)
    x = thre - 0.3 * smooth_field(shape, gen, thre)
    pos = [[], [], [], []]
    for b in range(bands):
        y0, y1 = b * rows, min((b + 1) * rows, h)
        col = (5 * b) % w
        pos[0] += [y0 * w + col, (y1 - 1) * w + col]
        if y1 < h:
            pos[0].append(y1 * w + col)        # the next band's first row
        pos[1] += range(y0 * w, y1 * w, 2)[:k + 3 if b == 0 else 2 * k]
    last = (bands - 1) * rows * w
    pos[2] = [*range(0, min(rows, h) * w, 2)[:k - 1], last,
              (last + n - 1) // 2, n - 1]
    pos[3] = np.linspace(0, n - 1, k // 2).astype(np.int64).tolist()
    flat = x.view(bsz * c, n)
    for q, p in enumerate(pos):
        if p and q < bsz * c:
            flat[q::4][:, torch.tensor(sorted(set(p)), device="cuda")] = (
                thre + 0.02)
    return x


def band_cases_hold(want: torch.Tensor, h: int, w: int, k: int) -> bool:
    """Whether the indices of a band_field with two bands or more show its
    cases: a peak on a band's first row after row 0 and on a band's last
    row, a plane whose k-th peak lies in band 0, one whose k-th peak lies
    in the last band, and one with fewer than k peaks."""
    from islx_torch.ops.nms_first_k import band_plan

    rows, bands, _ = band_plan(h, w)
    n = h * w
    y = torch.where(want < n, want // w, -1)
    kth = want[..., k - 1]
    return bool(((y > 0) & (y % rows == 0)).any()
                and (y % rows == rows - 1).any()
                and (kth < rows * w).any()
                and ((kth >= (bands - 1) * rows * w) & (kth < n)).any()
                and (kth == n).any())


def check_nms_kernel(cases, thre: float = 0.5) -> list:
    """nms_mask_rows == its plain version, bit for bit, on "smooth" maps
    (smooth_field: plateaus and thre1 ties) and "bands" maps (band_field:
    peaks on each row band's first and last row, a plateau across each band
    boundary). Timed as single calls (``ms``, a call's host time included)
    and as calls queued back to back (``stream_ms``)."""
    from islx_torch.ops import nms_first_k as NF
    from islx_torch.ops import nms_mask as N

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, field in cases:
        bsz, c, h, w = shape
        x = (smooth_field(shape, gen, thre) if field == "smooth"
             else band_field(shape, gen, thre, 32))
        m, cnt = N.nms_mask_rows(x, thre)
        torch.cuda.synchronize()
        mp, cp = N.nms_mask_rows_plain(x, thre)
        err = max(int((m.int() - mp.int()).abs().max()),
                  int((cnt - cp).abs().max()))
        if not (torch.equal(m, mp) and torch.equal(cnt, cp)):
            raise SystemExit(f"nms_mask_rows differs from its plain version "
                             f"at {shape} ({field}): max abs err {err}")
        px = x.numel()
        rows_n = bsz * c * h
        bytes_ = px * 4 + px * 1 + rows_n * 4   # read f32, write u8 + s32
        ops = px * 5                            # five f32 comparisons
        bound_ms, by = bound(bytes_, ops)
        row = {"shape": list(shape), "field": field, "bit_equal": True,
               "max_abs_err": err, "peaks": int(cp.sum()),
               "bands": NF.band_plan(h, w)[1],
               "ms": cuda_ms(lambda: N.nms_mask_rows(x, thre)),
               "stream_ms": stream_ms(lambda: N.nms_mask_rows(x, thre)),
               "plain_ms": cuda_ms(lambda: N.nms_mask_rows_plain(x, thre)),
               "bound_ms": bound_ms, "bound_by": by}
        log(f"  nms_mask_rows {shape} {field}: bit-equal, {row['peaks']} "
            f"peaks, {row['bands']} bands a plane, kernel {row['ms']:.4f} "
            f"ms, back to back {row['stream_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        rows.append(row)
    return rows


def bound(bytes_: float, ops: float) -> tuple:
    """(bound ms, what bounds it) at the H100's f32 and memory peaks."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_nms_first_k(cases, k: int = 32) -> list:
    """nms_first_k == its plain version (both border contracts), timed with
    the contract's 0.0 border, or -inf where the case says so. A "sparse"
    case plants a few peaks a plane (planted_field), so the kernel reads
    whole planes and finds peaks in their last rows; a "dense" case fills K
    early in every plane (smooth_field); a "bands" case puts peaks where
    the kernel's row bands meet (band_field)."""
    from islx_torch.ops import nms_first_k as NF

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for shape, thre, border, field in cases:
        bsz, c, h, w = shape
        n = h * w
        x = {"sparse": lambda: planted_field(shape, gen, thre, k),
             "dense": lambda: smooth_field(shape, gen, thre),
             "bands": lambda: band_field(shape, gen, thre, k)}[field]()
        want = NF.nms_first_k_plain(x, thre, k, border)
        found = want < n
        if not bool(found.any()):
            raise SystemExit(f"nms_first_k check at {shape}: no peaks")
        kth = want[..., k - 1]
        late = bool(((kth < n) & (kth >= n // 2)).any())
        if field == "sparse" and not (
                late and bool((want[found] >= n - 1024).any())):
            raise SystemExit(f"nms_first_k check at {shape}: no peak in the "
                             f"last 1024 pixels or no plane's K-th peak late")
        if (field == "bands" and NF.band_plan(h, w)[1] > 1
                and not band_cases_hold(want, h, w, k)):
            raise SystemExit(f"nms_first_k check at {shape} K={k}: the band "
                             f"cases are not all present")
        for bd in (0.0, -float("inf")):
            got = NF.nms_first_k(x, thre, k, bd)
            torch.cuda.synchronize()
            ref = NF.nms_first_k_plain(x, thre, k, bd)
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise SystemExit(f"nms_first_k differs from its plain version "
                                 f"at {shape}, border {bd}: {bad} indices")
        # the kernel stops at a plane's K-th peak, once the row below it is
        # read: count the pixels this data needs
        last = want[..., -1].long()
        px = int(torch.where(last < n, torch.clamp_max(last + w + 1, n),
                             n).sum())
        bound_ms, by = bound(px * 4 + want.numel() * 4, px * 5)
        row = {"shape": list(shape), "k": k, "border": border,
               "field": field, "bit_equal": True, "max_abs_err": 0,
               "peaks": int(found.sum()), "planes_read_whole": int(
                   (kth == n).sum()),
               "ms": cuda_ms(lambda: NF.nms_first_k(x, thre, k, border)),
               "plain_ms": cuda_ms(
                   lambda: NF.nms_first_k_plain(x, thre, k, border)),
               "bound_ms": bound_ms, "bound_by": by}
        log(f"  nms_first_k {shape} K={k} border {border} {field}: "
            f"bit-equal, {row['peaks']} peaks,"
            f" {row['planes_read_whole']}/{bsz * c} planes read whole, "
            f"kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        rows.append(row)
    return rows


PAF_SHAPE = (720, 1280, 52)


def paf_inputs(gen, h=720, w=1280, p=52, k=32):
    """A seeded PAF [h,w,p] on the card and peaks from find_peaks on a
    seeded heatmap (the parity Body's tables at its shape)."""
    from islx_torch.ops.peaks import find_peaks

    paf = (torch.rand((h, w, p), device="cuda", generator=gen) - 0.4)
    heat = smooth_field((1, 25, h, w), gen, 0.6)[0].permute(1, 2, 0)
    pk = find_peaks(heat.contiguous(), 0.6, k)
    return paf, pk


def l2_flush() -> torch.Tensor:
    """A buffer twice the card's 50 MB L2: zeroing it between two launches
    evicts what the first left there."""
    return torch.empty(25 * 2 ** 22, device="cuda")


def paf_cases(gen, paf, pk) -> list:
    """(name, args) of the PAF kernel's other cases, each at the phase-3
    shape: mid 2, 4, 8 and 16-20 (the sums in lanes), 1, 7 and 11; the
    COCO limb table; channel tables other than
    (cx, cx + 1) pairs with cx even (odd first channels, the y channel
    before the x channel, channels apart); a map whose start is off an
    8-byte boundary; and invalid peaks whose coordinates lie outside the
    map."""
    from islx_torch.ops import paf_sample as PS
    from islx_torch.ops.paf import (LIMB_SEQ_BODY25, LIMB_SEQ_COCO,
                                    MAP_IDX_BODY25, MAP_IDX_COCO)

    h, w, p = paf.shape
    body = PS.LimbTable(LIMB_SEQ_BODY25, MAP_IDX_BODY25)
    odd = PS.LimbTable(LIMB_SEQ_BODY25, (MAP_IDX_BODY25 + 1) % p)
    off = torch.empty(paf.numel() + 1, device="cuda")[1:].view(paf.shape)
    off.copy_(paf)
    xy, valid = pk.xy.clone(), pk.valid.clone()
    far = torch.tensor([[-7, 5000], [w + 3, -1], [2 ** 30, -2 ** 30],
                        [-2 ** 31, 2 ** 31 - 1], [w, h], [5, 2 ** 24 + 1]],
                       dtype=torch.int32, device="cuda")
    bad = ~valid
    bad[::2, 1] = True                     # and a valid slot's place
    valid &= ~bad
    n = int(bad.sum())
    xy[bad] = far[torch.arange(n, device="cuda") % len(far)]
    # mid 2, 4, 8 and 16-20: the mean's sum in vector lanes (SUM_LANES)
    lanes = [(f"mid {m}", (paf, pk.xy, pk.valid, body, 0.05, m, float(h)))
             for m in (2, 4, 8, 16, 17, 18, 19, 20)]
    return lanes + [
        ("mid 1", (paf, pk.xy, pk.valid, body, 0.05, 1, float(h))),
        ("mid 7", (paf, pk.xy, pk.valid, body, -0.1, 7, float(h))),
        ("mid 11", (paf, pk.xy, pk.valid, body, 0.05, 11, float(h))),
        ("coco", (paf, pk.xy, pk.valid,
                  PS.LimbTable(LIMB_SEQ_COCO, MAP_IDX_COCO), 0.05, 10,
                  float(h))),
        ("odd channels", (paf, pk.xy, pk.valid, odd, 0.05, 10, float(h))),
        ("y before x", (paf, pk.xy, pk.valid, PS.LimbTable(
            LIMB_SEQ_BODY25, MAP_IDX_BODY25[:, ::-1].copy()), 0.05, 10,
                        float(h))),
        ("channels apart", (paf, pk.xy, pk.valid, PS.LimbTable(
            LIMB_SEQ_BODY25, np.stack([MAP_IDX_BODY25[:, 0],
                                       (MAP_IDX_BODY25[:, 1] + 2) % p], 1)),
                            0.05, 10, float(h))),
        ("map off 8 bytes", (off, pk.xy, pk.valid, body, 0.05, 10,
                             float(h))),
        ("far invalid peaks", (paf, xy, valid, body, 0.05, 10, float(h))),
        ("far invalid peaks, mid 11", (paf, xy, valid, body, 0.05, 11,
                                       float(h)))]


def paf_sectors(terms, limbs, paf) -> int:
    """The distinct 32 B sectors of ``paf`` [H,W,P] f32 that the samples
    of paf_sample_terms' ``terms`` read: channels cx and cy of each
    sample's pixel, rounded and clipped as the kernel does."""
    h, w, p = paf.shape
    xi = torch.clamp(torch.round(terms["px"]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(terms["py"]).long(), 0, h - 1)
    word = (yi * w + xi) * p                              # [L,K,K,mid]
    rows = limbs.rows.to(paf.device).long()
    chans = [rows[:, c, None, None, None] for c in (2, 3)]
    sector = torch.cat([((word + ch) * 4 // 32).reshape(-1) for ch in chans])
    return int(torch.unique(sector).numel())


def paf_bit_equal(name, args) -> float:
    """paf_sample == paf_sample_plain on ``args``, score words and ok bits,
    with one launch; -> the max abs error (0.0)."""
    from islx_torch.ops import paf_sample as PS

    before = PS.paf_sample.launches
    score, ok = PS.paf_sample(*args)
    torch.cuda.synchronize()
    pscore, pok = PS.paf_sample_plain(*args)
    err = float((score - pscore).abs().max())
    same = torch.equal(score.view(torch.int32), pscore.view(torch.int32))
    if not (same and torch.equal(ok, pok)) or (
            PS.paf_sample.launches != before + 1):
        raise SystemExit(f"paf_sample differs from its plain version "
                         f"({name}): ok equal {torch.equal(ok, pok)}, "
                         f"{int((score != pscore).sum())} score words apart "
                         f"(max abs err {err}), "
                         f"{PS.paf_sample.launches - before} launches")
    return err


def check_paf_sample(k=32) -> list:
    """paf_sample at the parity Body's shape (paf_inputs), then at each of
    paf_cases: score words and ok bits equal to the plain version, which
    rounds at the same points, one launch a call. The main case is timed
    as single calls (``ms``, a call's host time included) and as calls
    queued back to back (``stream_ms``), 200 of each, since a call's host
    time spreads widely; ``floor_ms`` is an empty kernel's back-to-back
    time on the same card."""
    from islx_torch.ops import paf_sample as PS
    from islx_torch.ops.paf import LIMB_SEQ_BODY25, MAP_IDX_BODY25

    h, w, p = PAF_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    paf, pk = paf_inputs(gen, h, w, p, k)
    args = (paf, pk.xy, pk.valid,
            PS.LimbTable(LIMB_SEQ_BODY25, MAP_IDX_BODY25), 0.05, 10, float(h))
    err = paf_bit_equal("main", args)
    score, ok = PS.paf_sample(*args)
    ls = LIMB_SEQ_BODY25
    pairs = int((pk.count[torch.as_tensor(ls[:, 0])]
                 * pk.count[torch.as_tensor(ls[:, 1])]).sum())
    if pairs == 0 or not bool(ok.any()):
        raise SystemExit("paf_sample check: no valid pair or no ok pair")
    # the plain version on the card == the same code on the CPU, step by
    # step (each rounds correctly); else name the first step apart
    card = PS.paf_sample_terms(*args)
    host = PS.paf_sample_terms(paf.cpu(), pk.xy.cpu(), pk.valid.cpu(),
                               *args[3:])
    apart = {name: int((card[name].cpu() != v).sum())
             for name, v in host.items()}
    first = next((name for name, n in apart.items() if n), None)
    if first is not None:
        raise SystemExit(f"plain paf_sample: the card and the CPU differ "
                         f"first at {first}; words apart {apart}")
    log("  plain paf_sample on the card == on the CPU, every step bit-equal")
    cases = []
    for name, cargs in paf_cases(gen, paf, pk):
        err = max(err, paf_bit_equal(name, cargs))
        cases.append(name)
    log(f"  paf_sample bit-equal, one launch a call: {', '.join(cases)}")
    l, mid = ls.shape[0], 10
    # the bytes this run's data needs: each distinct 32 B sector of the map
    # that a sample reads, once (the pairs of a limb share their peaks, and
    # the samples of pairs may share pixels), the peak tables, and the
    # outputs' 5 B a pair; ~12 f32 operations a sample
    sectors = paf_sectors(card, args[3], paf)
    ops = l * k * k * mid * 12
    bound_ms, by = bound(sectors * 32 + pk.xy.numel() * 4 + pk.valid.numel()
                         + l * k * k * 5, ops)
    # PRs 2-7's figure, one sector a sample, so that times compare across
    # PRs
    sample_bound_ms = bound(l * k * k * (mid * 32 + 5), ops)[0]
    row = {"shape": [h, w, p], "limbs": l, "k": k, "mid": mid,
           "bit_equal": True, "max_abs_err": err, "cases": cases,
           "valid_pairs": pairs, "ok_pairs": int(ok.sum()),
           "ms": cuda_ms(lambda: PS.paf_sample(*args), reps=200),
           "stream_ms": stream_ms(lambda: PS.paf_sample(*args), reps=200),
           "floor_ms": stream_ms(lambda: torch.cuda._sleep(0), reps=200),
           "plain_ms": cuda_ms(lambda: PS.paf_sample_plain(*args)),
           "bound_ms": bound_ms, "bound_by": by, "sectors": sectors,
           "sample_bound_ms": sample_bound_ms}
    log(f"  paf_sample [{h},{w},{p}] L={l} K={k}: bit-equal, {pairs} valid "
        f"pairs, {row['ok_pairs']} ok, kernel {row['ms']:.4f} ms, back to "
        f"back {row['stream_ms']:.4f}, empty kernel back to back "
        f"{row['floor_ms']:.4f}, plain {row['plain_ms']:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by}, {sectors} distinct sectors; one sector "
        f"a sample {sample_bound_ms:.4f})")
    return [row]


def paf_launch_split(row, body=None, frame=None) -> None:
    """Adds the PAF kernel's device ms a launch (torch.profiler) to
    check_paf_sample's row: at the phase-3 shape, and, given the parity
    ``Body`` and its frame, inside a ``Body`` call at that call's own peak
    counts. It runs after the timed phases."""
    from islx_torch.ops import paf_sample as PS
    from islx_torch.ops.paf import LIMB_SEQ_BODY25, MAP_IDX_BODY25

    h, w, p = PAF_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    paf, pk = paf_inputs(gen, h, w, p, row["k"])
    args = (paf, pk.xy, pk.valid,
            PS.LimbTable(LIMB_SEQ_BODY25, MAP_IDX_BODY25), 0.05, 10, float(h))
    pat = ("paf_sample_kernel",)
    flush = l2_flush()
    legs = {"launch_ms": ("phase-3 shape", lambda: PS.paf_sample(*args)),
            "cold_launch_ms": ("L2 flushed before each", lambda: (
                flush.zero_(), PS.paf_sample(*args)))}
    if body is not None:
        legs["body_launch_ms"] = ("in a Body call", lambda: body(frame))
    parts = []
    for key, (label, fn) in legs.items():
        got = launch_ms(fn, pat, reps=5 if key == "body_launch_ms" else 20)
        row[key] = got["paf_sample_kernel"]
        if "paf_sample_kernel_events" in got:
            row[key.replace("_ms", "_events")] = got[
                "paf_sample_kernel_events"]
        parts.append(f"{label} " + ("not measured" if row[key] is None
                                    else f"{row[key]:.4f}"))
    msg = ", ".join(parts)
    log(f"  paf_sample device ms a launch: {msg}")


def spiral(h, w):
    """A one-pixel-wide square spiral: one component, a long thin path."""
    m = np.zeros((h, w), bool)
    y0, x0, y1, x1 = 0, 0, h - 1, w - 1
    while y0 <= y1 and x0 <= x1:
        m[y0, x0:x1 + 1] = True
        m[y0:y1 + 1, x1] = True
        m[y1, x0:x1 + 1] = True
        m[y0 + 2:y1 + 1, x0] = True
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return m


def snake(h, w):
    """One-pixel-wide rows joined alternately at the right and left ends."""
    m = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        m[y, :] = True
        if y + 1 < h:
            m[y + 1, w - 1 if (y // 2) % 2 == 0 else 0] = True
    return m


def corner_map(h, w, diagonal, period=8):
    """Pairs of short lines joined only through one diagonal step across
    each point (Y, X) where rows Y-1, Y and columns X-1, X meet, Y and X
    multiples of ``period`` (so the corner of every tile whose sides
    divide it). ``diagonal`` "nw": (Y-1, X-1) and (Y, X), the NW link of
    the lower-right pixel; "ne": (Y-1, X) and (Y, X-1), the NE link of the
    lower-left pixel, whose component's smallest index lies to the
    right."""
    m = np.zeros((h, w), bool)
    for y in range(period, h, period):
        for x in range(period, w, period):
            if diagonal == "nw":
                m[y - 1, max(x - 4, 0):x] = True        # ends at (Y-1, X-1)
                m[y:y + 4, x] = True                    # starts at (Y, X)
            else:
                m[max(y - 3, 0):y, x] = True            # ends at (Y-1, X)
                m[y, max(x - 4, 0):x] = True            # ends at (Y, X-1)
    return m


def blob_maps(size: int, c: int = 21) -> torch.Tensor:
    """[size,size,c] bool on the card: a spiral, a snake and seeded smooth
    blobs thresholded as a hand heatmap is."""
    gen = torch.Generator(device="cuda").manual_seed(size)
    lo = torch.rand((1, c - 2, size // 16, size // 16), device="cuda",
                    generator=gen)
    blobs = torch.nn.functional.interpolate(
        lo, size=(size, size), mode="bilinear", align_corners=False)[0] > 0.7
    thin = torch.from_numpy(np.stack([spiral(size, size), snake(size, size)])
                            ).cuda()
    return torch.cat([thin, blobs]).permute(1, 2, 0).contiguous()


def tile_maps(rng, h, w, c, first=0) -> np.ndarray:
    """[H,W,C] bool maps built to break a tiled labeller, channel i of kind
    (first + i) mod 9: components joined only through a tile corner's NW
    or NE diagonal (corner_map), a spiral and a snake that cross every
    tile, all foreground, all background, a diagonal lattice (every pixel
    of a colour joined through corners alone) and seeded random pixels at
    two densities."""
    lattice = np.zeros((h, w), bool)
    lattice[::2, ::2] = True
    lattice[1::2, 1::2] = True
    kinds = [lambda: corner_map(h, w, "nw"), lambda: corner_map(h, w, "ne"),
             lambda: spiral(h, w), lambda: snake(h, w),
             lambda: np.ones((h, w), bool), lambda: np.zeros((h, w), bool),
             lambda: lattice, lambda: rng.rand(h, w) > 0.55,
             lambda: rng.rand(h, w) > 0.4]
    return np.stack([kinds[(first + i) % len(kinds)]() for i in range(c)],
                    -1)


def launch_ms(fn, names, reps: int = 20, tries: int = 3) -> dict:
    """Device ms a launch of each kernel in ``names``, each launched once
    by a call of ``fn``, from torch.profiler over ``reps`` calls: a
    kernel's device time over the launches the trace recorded. Late in a
    full run of this script a trace records fewer launches than were made,
    and once recorded none: a trace with no launch of a kernel is taken
    again, up to ``tries`` times. A kernel short of ``reps`` gets
    ``"<name>_events"``, the launches recorded; one with none, None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        found = dict.fromkeys(names, (0, 0.0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            hit = re.search(rf"\b({'|'.join(names)})\b", e.key)
            if hit:
                count, us = found[hit.group(1)]
                found[hit.group(1)] = (count + e.count,
                                       us + e.self_device_time_total)
        if all(count for count, _ in found.values()):
            break
    out: dict = {}
    for name, (count, us) in found.items():
        out[name] = us / 1e3 / count if count else None
        if count != reps:
            out[f"{name}_events"] = count
    return out


CC_CASES = [(256, "blobs"), (368, "blobs"), (736, "blobs"), (256, "tiles"),
            (368, "tiles"), (736, "tiles")]


def cc_map(size: int, field: str) -> torch.Tensor:
    """[size,size,21] bool on the card: "blobs" (blob_maps: a spiral, a
    snake and blobs as a thresholded hand heatmap) or "tiles" (tile_maps:
    joins only at a tile corner, full and empty channels, ...)."""
    if field == "blobs":
        return blob_maps(size)
    return torch.from_numpy(tile_maps(np.random.RandomState(size), size,
                                      size, 21)).cuda()


def check_cc_label(cases) -> list:
    """label_components == its plain version, bit for bit, one launch a
    call, on cc_map's maps. Timed as single calls (``ms``, a call's host
    time included) and as calls queued back to back (``stream_ms``)."""
    from islx_torch.ops import cc_label as CC

    rows = []
    for size, field in cases:
        m = cc_map(size, field)
        before = CC.label_components.launches
        got = CC.label_components(m)
        torch.cuda.synchronize()
        want = CC.label_components_plain(m)
        if not torch.equal(got, want) or (
                CC.label_components.launches != before + 1):
            raise SystemExit(f"cc_label differs from its plain version at "
                             f"{size} ({field}): {int((got != want).sum())} "
                             f"labels, {CC.label_components.launches - before}"
                             f" launches")
        h, w, c = m.shape
        bound_ms, by = bound(m.numel() * 5, m.numel() * 4)
        row = {"shape": [h, w, c], "field": field, "bit_equal": True,
               "max_abs_err": 0, "foreground": int(m.sum()),
               "components": int((want == torch.arange(
                   h * w, device="cuda", dtype=torch.int32).reshape(
                       h, w, 1)).sum()),
               "ms": cuda_ms(lambda: CC.label_components(m)),
               "stream_ms": stream_ms(lambda: CC.label_components(m)),
               "plain_ms": cuda_ms(lambda: CC.label_components_plain(m),
                                   reps=5, warmup=1),
               "bound_ms": bound_ms, "bound_by": by}
        log(f"  cc_label {[h, w, c]} {field}: bit-equal, "
            f"{row['components']} components, kernel {row['ms']:.4f} ms, "
            f"back to back {row['stream_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        rows.append(row)
    return rows


def cc_launch_split(rows) -> None:
    """Adds each launch's device ms (torch.profiler) to check_cc_label's
    rows. It runs after the timed phases, so that no profiler has traced
    the card before them."""
    from islx_torch.ops import cc_label as CC

    for row in rows:
        m = cc_map(row["shape"][0], row["field"])
        row["launch_ms"] = launch_ms(lambda: CC.label_components(m),
                                     ("cc_tile", "cc_border", "cc_final"))
        split = ", ".join(f"{k} {v}" if v is None or k.endswith("_events")
                          else f"{k} {v:.4f}"
                          for k, v in row["launch_ms"].items())
        log(f"  cc_label {row['shape']} {row['field']}: {split} ms")


def conv_q_inputs(gen, b, h, w, cin, cout, k, act, out_dtype):
    """Seeded arguments of ``conv_q`` on the card: int8 activations and
    weights over the whole int8 range, f32 epilogue vectors that map the
    sums to O(1) outputs, and an ``out_inv`` that clips some int8 outputs
    (the activations' padded channels hold int8 noise too)."""
    from islx_torch.ops import conv_q as CQ

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    x = s8(b, h, w, CQ.channel_stride(cin))
    w_q = s8(cout, cin, k, k)
    scale = (torch.rand(cout, generator=gen, device="cuda") + 0.5) / (
        127.0 * 127.0 * (k * k * cin) ** 0.5)
    bias = torch.randn(cout, generator=gen, device="cuda")
    slope = torch.rand(cout, generator=gen, device="cuda")
    out_inv = 40.0 if out_dtype == torch.int8 else None
    return (x, CQ.pack_weights(w_q), cin, scale, bias,
            slope if act == "prelu" else None, act, out_dtype, out_inv)


def _same_words(got: torch.Tensor, want: torch.Tensor) -> bool:
    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        got.element_size()]
    return got.dtype == want.dtype and torch.equal(got.view(words),
                                                   want.view(words))


def conv_q_bit_equal(args) -> float:
    """conv_q == conv_q_plain on ``args`` word for word, with one launch;
    -> the max abs error (0.0)."""
    from islx_torch.ops import conv_q as CQ

    before = CQ.conv_q.launches
    got = CQ.conv_q(*args)
    torch.cuda.synchronize()
    want = CQ.conv_q_plain(*args)
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    if not _same_words(got, want) or CQ.conv_q.launches != before + 1:
        x, w_pack, cin = args[:3]
        raise SystemExit(
            f"conv_q differs from its plain version at x {tuple(x.shape)}, "
            f"w {tuple(w_pack.shape)} cin {cin}, {args[6]}, {args[7]}: "
            f"{int((got != want).sum())} words apart (max abs err {err}), "
            f"{CQ.conv_q.launches - before} launches")
    return err


def conv_shapes(hand_sizes=(160, 184), body_hw=(184, 144)) -> list:
    """Every distinct (cin, cout, k, act, H, W, output dtype) of the int8
    CPMs' convs as the kernel sees them (conv1_1 as the 1x1 conv over 27
    patch channels) on the main path: BODY_25 at the fused step's
    bucket and the hand net (6 stages) at each crop size, bf16, recorded
    from one-image forwards of seeded int8 nets on the card."""
    from islx_torch.core import weights as W
    from islx_torch.models import quant

    seen, core = {}, quant.QConvLayer.core

    def rec(self, x_q, cd, out_inv=None):
        out = core(self, x_q, cd, out_inv)
        c = self.spec
        key = (self.cin, c.cout, 1 if self.patch else c.k, c.act,
               x_q.shape[1], x_q.shape[2], str(out.dtype).split(".")[1])
        seen.setdefault(key, c.name)
        return out

    quant.QConvLayer.core = rec
    try:
        with torch.inference_mode():
            for mt, shapes in (("body25", [body_hw]),
                               ("hand", [(s, s) for s in hand_sizes])):
                state = W.init_params(mt, 3)
                net = W.build(mt, quant.quantize_params(
                    state, dict.fromkeys(state, 1.0)), torch.device("cuda"),
                    torch.bfloat16)
                for h, w in shapes:
                    net(torch.rand(1, h, w, 3, device="cuda") - 0.5,
                        torch.bfloat16)
    finally:
        quant.QConvLayer.core = core
    return [(key, name) for key, name in seen.items()]


def im2col_s8(x_q: torch.Tensor, cin: int, k: int) -> torch.Tensor:
    """int8 NHWC [B,H,W,cs] -> [B*H*W, k*k*cin] int8 patches, zero halo,
    (ky, kx, c) order: the operand of one GEMM that computes the conv."""
    b, h, w, _ = x_q.shape
    p = (k - 1) // 2
    xp = torch.nn.functional.pad(x_q[..., :cin], (0, 0, p, p, p, p))
    cols = xp.unfold(1, k, 1).unfold(2, k, 1)          # [B,H,W,cin,k,k]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(b * h * w, k * k * cin)


# The convs phase 3 times, (name, (B, H, W, cin, cout, k, act, output),
# the input channels a pixel that the conv's function reads): the dominant
# one first (the hand stages' 7x7 128->128 at 20x20 over the fused-160s5
# step's 384 crops, 20 of its 159 convs a step), a hand-trunk 3x3 (conv2_2
# at 80x80), a BODY_25 dense-block 3x3 (23x18 over B=192, unchained: bf16
# out) and conv1_1 at 160 px as the 1x1 conv over its 27 patch channels,
# whose function (islx's 3x3 conv) reads the 3 channels of each pixel.
TIMED_CONVS = [
    ("hand Mconv2-5, 7x7", (384, 20, 20, 128, 128, 7, "relu", torch.int8),
     128),
    ("hand conv2_2, 3x3", (384, 80, 80, 128, 128, 3, "relu", torch.int8),
     128),
    ("BODY_25 dense block, 3x3",
     (192, 23, 18, 128, 128, 3, "prelu", torch.bfloat16), 128),
    ("conv1_1 patches, 1x1 over 27",
     (384, 160, 160, 27, 64, 1, "relu", torch.int8), 3),
]


def time_conv_q(gen, name, case, fn_cin) -> dict:
    """conv_q at one of TIMED_CONVS: bit-equal, then timed single and back
    to back beside the plain version, the bound and ``torch._int_mm`` on
    the im2col'd operands (the GEMM alone, im2col not timed; K padded to
    the input's channel stride where the GEMM needs a multiple of 8).

    The bound counts the bytes of the conv's function: ``fn_cin`` int8
    channels a pixel read once, the weights, the output and the epilogue's
    constants. A patch-mode conv reads ``cin`` (27) patch channels a pixel,
    the port's layout: that figure is kept beside it as ``patch_bound_ms``."""
    from islx_torch.ops import conv_q as CQ

    b, h, w, cin, cout, k, act, dt = case
    args = conv_q_inputs(gen, *case)
    err = conv_q_bit_equal(args)
    m, kk = b * h * w, k * k * cin
    ops = 2.0 * m * cout * kk
    fixed = (m * cout * torch.empty((), dtype=dt).element_size()
             + args[1][:cout, :, :cin].numel() + 8 * cout)
    t_ops = ops / PEAK_INT8_OPS_PER_S
    t_bytes = (m * fn_cin + fixed) / PEAK_BYTES_PER_S
    row = {"name": name, "shape": [b, h, w, cin, cout, k], "act": act,
           "out": str(dt).split(".")[1], "bit_equal": True,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: CQ.conv_q(*args)),
           "stream_ms": stream_ms(lambda: CQ.conv_q(*args)),
           "plain_ms": cuda_ms(lambda: CQ.conv_q_plain(*args), reps=3,
                               warmup=1),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "ops": ops}
    if fn_cin != cin:
        row["patch_bound_ms"] = max(
            t_ops, (m * cin + fixed) / PEAK_BYTES_PER_S) * 1e3
    ck = cin if kk % 8 == 0 else args[0].shape[-1]
    a_mat = im2col_s8(args[0], ck, k)
    b_mat = args[1][:cout, :, :ck].reshape(cout, k * k * ck)  # K-major
    try:
        torch._int_mm(a_mat, b_mat.t())
        row["library_ms"] = cuda_ms(lambda: torch._int_mm(a_mat, b_mat.t()))
        row["library"] = "torch._int_mm [M,K] x [K,N] s8 (col-major B)"
    except RuntimeError as e:
        row["library_ms"] = None
        row["library"] = f"torch._int_mm refused: {str(e)[:200]}"
    del a_mat
    row["tops"] = ops / (row["stream_ms"] * 1e-3) / 1e12
    lib = row["library_ms"]
    patch = (f"; {row['patch_bound_ms']:.4f} over the patch channels"
             if "patch_bound_ms" in row else "")
    log(f"  conv_q {name} {b}x{h}x{w} {cin}->{cout} k{k}: kernel "
        f"{row['ms']:.4f} ms, back to back {row['stream_ms']:.4f} "
        f"({row['tops']:.0f} TOP/s), plain {row['plain_ms']:.2f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}{patch}), _int_mm "
        f"{'refused' if lib is None else f'{lib:.4f} ms'}")
    return row


def check_conv_q() -> list:
    """conv_q bit-equal to conv_q_plain at every distinct conv shape of
    both int8 CPMs (conv_shapes, B=2) and on ragged shapes (odd H and W,
    B=1, channel tails), one launch a call; then bit-equal and timed at
    each of TIMED_CONVS (the dominant one first)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}
    cases = [(2, h, w, cin, cout, k, act, dtypes[dt])
             for (cin, cout, k, act, h, w, dt), _ in conv_shapes()]
    cases += [(1, 23, 17, 150, 128, 7, "relu", torch.int8),
              (1, 11, 13, 3, 64, 3, "relu", torch.int8),
              (1, 5, 3, 206, 22, 1, "none", torch.float32),
              (1, 1, 1, 512, 52, 1, "none", torch.float32),
              (3, 7, 9, 180, 96, 3, "prelu", torch.bfloat16),
              (1, 9, 5, 288, 26, 7, "prelu", torch.float32)]
    err = 0.0
    for case in cases:
        err = max(err, conv_q_bit_equal(conv_q_inputs(gen, *case)))
    log(f"  conv_q bit-equal, one launch a call: {len(cases)} shapes "
        f"({len(cases) - 6} of the int8 CPMs at B=2, 6 ragged)")
    rows = [time_conv_q(gen, *timed) for timed in TIMED_CONVS]
    rows[0]["cases"] = len(cases) + len(rows)
    rows[0]["max_abs_err"] = max(err, rows[0]["max_abs_err"])
    return rows


QUANTIZE_CASES = [((192, 23, 18, 384), torch.bfloat16),   # dense blocks
                  ((192, 23, 18, 180), torch.float32),    # body stages
                  ((384, 160, 160, 3), torch.float32),    # hand input
                  ((384, 20, 20, 150), torch.float32),    # hand stages
                  ((192, 184, 144, 3), torch.float32),    # body input
                  ((1, 5, 3, 206), torch.bfloat16),
                  ((2, 7, 9, 22), torch.float32)]


def check_quantize() -> list:
    """The quantize kernel bit-equal to quantize_plain, one launch a call,
    at the int8 step's input shapes (QUANTIZE_CASES: C=384 bf16 is BODY_25's
    dense-block input, 90 of the step's 109 quantizations; the others its
    f32 stage and net inputs, and ragged ones), with .5 ties and values
    past the int8 range, the 3-channel inputs also in patch mode (conv1_1's
    3x3 patches); timed at each of the first four, and in patch mode at
    the hand input (the main path's form of it)."""
    from islx_torch.ops import conv_q as CQ

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for i, (shape, dt) in enumerate(QUANTIZE_CASES):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dt)
        x.view(-1)[::97] = 2.5                      # a tie at inv = 1
        patches = (0, 3) if shape[-1] == 3 else (0,)
        for inv in (1.0, 37.25, 127.0 / 3e-8):
            for patch in patches:
                before = CQ.quantize.launches
                got = CQ.quantize(x, inv, patch)
                torch.cuda.synchronize()
                want = CQ.quantize_plain(x, inv, patch)
                if not torch.equal(got, want) or (
                        CQ.quantize.launches != before + 1):
                    raise SystemExit(
                        f"quantize differs from its plain version at "
                        f"{tuple(shape)} {dt} patch {patch}, inv {inv}: "
                        f"{int((got != want).sum())} bytes apart, "
                        f"{CQ.quantize.launches - before} launches")
        timed = [0] if i < 4 else []
        if shape == (384, 160, 160, 3):
            timed.append(3)
        for patch in timed:
            # the function (quantize_act) reads C channels and writes C
            # int8 ones, in patch mode too; the patches' k*k*C channels and
            # the padded layout's zeros past them are the port's layout
            read = x.numel() * x.element_size()
            got = CQ.quantize(x, 37.25, patch)
            row = {"shape": list(shape), "dtype": str(dt).split(".")[1],
                   "patch": patch, "bit_equal": True, "max_abs_err": 0,
                   "padded_bound_ms": (read + got.numel())
                   / PEAK_BYTES_PER_S * 1e3,
                   "ms": cuda_ms(lambda: CQ.quantize(x, 37.25, patch)),
                   "stream_ms": stream_ms(
                       lambda: CQ.quantize(x, 37.25, patch)),
                   "plain_ms": cuda_ms(
                       lambda: CQ.quantize_plain(x, 37.25, patch)),
                   "bound_ms": (read + x.numel()) / PEAK_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "library_ms": None}
            if patch:
                row["patch_bound_ms"] = (read + x.numel() * patch ** 2
                                         ) / PEAK_BYTES_PER_S * 1e3
            rows.append(row)
            log(f"  quantize {tuple(shape)} {row['dtype']}"
                f"{' patch 3' if patch else ''}: bit-equal, kernel "
                f"{row['ms']:.4f} ms, back to back {row['stream_ms']:.4f}, "
                f"plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms (bytes; "
                + (f"{row['patch_bound_ms']:.4f} writing the patches, "
                   if patch else "")
                + f"{row['padded_bound_ms']:.4f} with the padded channels' "
                f"writes)")
    return rows


def seeded_i420(rng, b: int, hb: int, wb: int) -> np.ndarray:
    """Seeded I420 frames [b*hb*wb*3/2] u8: smooth luma + noise, chroma."""
    yy, xx = np.mgrid[0:hb, 0:wb]
    out = []
    for _ in range(b):
        fy, fx, ph = rng.uniform(0.02, 0.1, 2).tolist() + [rng.uniform(0, 6)]
        y = 128 + 80 * np.sin(fy * yy + ph) * np.cos(fx * xx)
        y = np.clip(y + rng.randn(hb, wb) * 20, 0, 255).astype(np.uint8)
        uv = rng.randint(64, 192, (2, hb // 2, wb // 2)).astype(np.uint8)
        out.append(np.concatenate([y.ravel(), uv.ravel()]))
    return np.concatenate(out)


def calibrate_thre1(pipe, flat, b, hb, wb, orig_hw) -> float:
    """Double thre1 from 0.1 until the mean peak count per joint is <= 4
    (random weights give noise heatmaps; real scenes have a few peaks)."""
    thre1 = 0.1
    for _ in range(24):
        packed = pipe.device_step_flat(flat, b, hb, wb, orig_hw, thre1,
                                       input_format="yuv420")
        body, _, _ = pipe.unpack(packed, b)
        count = pipe.body.unpack(body, b)[2]
        if float(count.mean()) <= 4.0:
            return thre1
        thre1 *= 2.0
    return thre1


def quantize_on(bp, hp, frames, hand_cfg, device):
    """Both nets quantized to int8 W8A8 with activation scales calibrated
    on ``device`` on BGR u8 ``frames``, built as the CLIs' gate builds its
    calibration batches (the frames at the 184-row bucket, their centre
    squares at the hand size) but resized with the port's ``resize_cubic``:
    the card's machine has no cv2, which the gate's ``calib_inputs``
    needs. The checks that use these states hold the card against the
    plain versions and the CPU on the same states, so which pixels
    calibrated them does not matter -> (body, hand) states."""
    from islx_torch.models import quant
    from islx_torch.ops.resize import resize_cubic
    from islx_torch.pipeline.batch_pose import bucket_for

    f = torch.from_numpy(np.stack(frames))
    h0, w0 = f.shape[1:3]
    hb, wb = bucket_for(h0, w0, target_h=184)
    hsize = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    s = min(h0, w0)
    sq = f[:, (h0 - s) // 2:(h0 + s) // 2, (w0 - s) // 2:(w0 + s) // 2]
    x, hx = (resize_cubic(t, n, n2, saturate_uint8=True).numpy()
             / np.float32(256.0) - np.float32(0.5)
             for t, n, n2 in ((f, hb, wb), (sq, hsize, hsize)))
    return (quant.quantize_model(bp, "body25", [x], device=device),
            quant.quantize_model(hp, "hand", [hx], device=device))


def int8_states(hand_cfg, host, b, hb, wb, n=8):
    """The seeded full-width weights quantized to int8 W8A8 by the port's
    calibration on the card (:func:`quantize_on`), on the first ``n``
    frames of the phase's own I420 batch (decoded on the card) -> (body,
    hand) states."""
    from islx_torch.core import weights as W
    from islx_torch.ops.yuv import frame_bytes, yuv420_to_bgr

    flat = torch.from_numpy(host[:n * frame_bytes(hb, wb)]).cuda()
    frames = yuv420_to_bgr(flat, n, hb, wb).to(torch.uint8).cpu().numpy()
    return quantize_on(W.init_params("body25", 0), W.init_params("hand", 1),
                       list(frames), hand_cfg, "cuda")


def fused_setup(hand_cfg, b, orig_hw, device, pallas_nms=False,
                int8=False):
    """The full-width fused pipeline, bf16 on seeded weights or (``int8``)
    with those weights quantized (int8_states), a seeded I420 batch at the
    bucket of ``orig_hw`` and its calibrated thre1, warmed up -> (pipe,
    host frames, hb, wb, thre1)."""
    from islx_torch.core import weights as W
    from islx_torch.pipeline.batch_pose import FusedPosePipeline, bucket_for

    hb, wb = bucket_for(*orig_hw)
    host = seeded_i420(np.random.RandomState(0), b, hb, wb)
    states = (int8_states(hand_cfg, host, b, hb, wb) if int8
              else (W.init_params("body25", 0), W.init_params("hand", 1)))
    pipe = FusedPosePipeline(*states, hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device=device,
                             pallas_nms=pallas_nms)
    flat = pipe.upload_frames(host)
    thre1 = calibrate_thre1(pipe, flat, b, hb, wb, orig_hw)
    for _ in range(2):                                   # warm-up
        pipe.device_step_flat(flat, b, hb, wb, orig_hw, thre1,
                              input_format="yuv420").cpu()
    return pipe, host, hb, wb, thre1


@contextlib.contextmanager
def watched_convs(chunk=32):
    """Inside the block every QConvLayer's conv and input quantization is
    watched: each call's kernel output is held word for word against
    conv_q_plain (quantize_plain) on the same int8 input (float input),
    weights, scales and output mode, ``chunk`` frames or crops at a time,
    and each call must launch its kernel once. So every conv that runs in
    the block is checked at the batch, map size and calibrated scales its
    path gives it. A mismatch raises RuntimeError (in a serving worker it
    reaches the batch's futures). Yields {"convs", "quantizes",
    "max_abs_err", "shapes"}."""
    from islx_torch.models import quant
    from islx_torch.ops import conv_q as CQ

    core, quantize = quant.QConvLayer.core, quant.QConvLayer.quantize
    seen = {"convs": 0, "quantizes": 0, "max_abs_err": 0.0, "shapes": set()}

    def fail(what, name, x):
        raise RuntimeError(f"main path: {what} differs from its plain "
                           f"version at {name}, input {tuple(x.shape)}")

    def watched_core(self, x_q, cd, out_inv=None):
        c, before = self.spec, CQ.conv_q.launches
        out = core(self, x_q, cd, out_inv)
        if CQ.conv_q.launches != before + 1:
            raise RuntimeError(f"main path: {c.name} launched conv_q "
                               f"{CQ.conv_q.launches - before} times")
        for i in range(0, x_q.shape[0], chunk):
            want = CQ.conv_q_plain(x_q[i:i + chunk], self.w_pack, self.cin,
                                   self.scale, self.bias, self.slope, c.act,
                                   out.dtype, out_inv)
            got = out[i:i + chunk]
            if not _same_words(got, want):
                fail("conv_q", c.name, x_q)
            seen["max_abs_err"] = max(seen["max_abs_err"], float(
                (got.float() - want.float()).abs().max()))
        seen["convs"] += 1
        seen["shapes"].add((x_q.shape[0], x_q.shape[1], x_q.shape[2],
                            self.cin, c.cout, 1 if self.patch else c.k,
                            str(out.dtype).split(".")[1]))
        return out

    def watched_quantize(self, x):
        before = CQ.quantize.launches
        out = quantize(self, x)
        if CQ.quantize.launches != before + 1:
            raise RuntimeError(f"main path: {self.spec.name} launched "
                               f"quantize {CQ.quantize.launches - before} "
                               f"times")
        for i in range(0, x.shape[0], chunk):
            want = CQ.quantize_plain(x[i:i + chunk].permute(0, 2, 3, 1),
                                     self.inv, self.patch)
            if not torch.equal(out[i:i + chunk], want):
                fail("quantize", self.spec.name, x)
        seen["quantizes"] += 1
        return out

    quant.QConvLayer.core = watched_core
    quant.QConvLayer.quantize = watched_quantize
    try:
        yield seen
    finally:
        quant.QConvLayer.core, quant.QConvLayer.quantize = core, quantize
        seen["shapes"] = sorted(seen["shapes"])


def main_path_convs(pipe, flat, b, hb, wb, orig_hw, thre1) -> dict:
    """One more int8 fused step under watched_convs."""
    with watched_convs() as seen:
        pipe.device_step_flat(flat, b, hb, wb, orig_hw, thre1,
                              input_format="yuv420").cpu()
    return seen


@contextlib.contextmanager
def watched_nms():
    """Inside the block every NMS mask call of the peak stage is held bit
    for bit against nms_mask_rows_plain on the same blurred maps, and must
    launch its kernel once; a mismatch raises RuntimeError. Yields
    {"calls", "shapes", "peaks"}."""
    from islx_torch.ops import nms_mask as N
    from islx_torch.ops import peaks as P

    real = P.nms_mask_rows
    seen = {"calls": 0, "shapes": set(), "peaks": 0}

    def watched(blurred, thre1):
        before = N.nms_mask_rows.launches
        mask, cnt = real(blurred, thre1)
        if N.nms_mask_rows.launches != before + 1:
            raise RuntimeError(f"main path: nms_mask_rows launched "
                               f"{N.nms_mask_rows.launches - before} times")
        want_mask, want_cnt = N.nms_mask_rows_plain(blurred, thre1)
        if not (torch.equal(mask, want_mask) and torch.equal(cnt, want_cnt)):
            raise RuntimeError(f"main path: nms_mask_rows differs from its "
                               f"plain version at {tuple(blurred.shape)}")
        seen["calls"] += 1
        seen["shapes"].add(tuple(blurred.shape))
        seen["peaks"] += int(want_cnt.sum())
        return mask, cnt

    P.nms_mask_rows = watched
    try:
        yield seen
    finally:
        P.nms_mask_rows = real
        seen["shapes"] = sorted(seen["shapes"])


def fused_step(hand_cfg, b=192, orig_hw=(512, 384), steps=5,
               device="cuda", pallas_nms=False, int8=False) -> dict:
    """Time the fused step; ``pallas_nms`` takes the NMS+first-K kernel in
    place of the NMS mask kernel, ``int8`` the int8 W8A8 CPMs. The step's
    NMS kernel must launch once a step and the other not at all; conv_q
    once a conv a step under int8 (114 body convs and the hand net's
    15 + 2 + 7 * (stages - 1)), else never."""
    from islx_torch.ops import conv_q as CQ
    from islx_torch.ops import nms_first_k as NF
    from islx_torch.ops import nms_mask as N

    pipe, host, hb, wb, thre1 = fused_setup(hand_cfg, b, orig_hw, device,
                                            pallas_nms, int8)
    convs = 114 + 17 + 7 * (hand_cfg.stages - 1) if int8 else 0
    # the unchained convs' inputs: BODY_25's first conv, 90 dense-block
    # convs and 12 Mconv6/7; the hand's first conv, conv6_1 and each
    # stage's Mconv1
    quants = 103 + 2 + (hand_cfg.stages - 1) if int8 else 0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    N.nms_mask_rows.launches = 0
    NF.nms_first_k.launches = 0
    CQ.conv_q.launches = 0
    CQ.quantize.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        packed = pipe.device_step_flat(pipe.upload_frames(host), b, hb, wb,
                                       orig_hw, thre1,
                                       input_format="yuv420").cpu().numpy()
    dt = (time.perf_counter() - t0) / steps
    counts = (N.nms_mask_rows.launches, NF.nms_first_k.launches)
    conv_launches = CQ.conv_q.launches
    quant_launches = CQ.quantize.launches
    launches = counts[1] if pallas_nms else counts[0]
    want = steps if device == "cuda" else 0
    if counts != ((0, want) if pallas_nms else (want, 0)):
        raise SystemExit(f"nms_mask_rows / nms_first_k launched {counts} "
                         f"times in {steps} fused steps (pallas_nms="
                         f"{pallas_nms}: want one of the step's kernel a "
                         f"step)")
    if conv_launches != (convs * steps if device == "cuda" else 0) or (
            quant_launches != (quants * steps if device == "cuda" else 0)):
        raise SystemExit(f"conv_q / quantize launched {conv_launches} / "
                         f"{quant_launches} times in {steps} fused steps, "
                         f"want {convs} / {quants} a step")
    body, boxes, peaks = pipe.unpack(packed, b)
    xy, score, count, pair, cscore, cok = pipe.body.unpack(body, b)
    k = pipe.body.cfg.max_peaks
    if not (np.isfinite(score).all() and np.isfinite(cscore).all()
            and count.min() >= 0 and count.max() <= k and count.sum() > 0
            and (boxes[:, 1] < wb).all() and (boxes[:, 2] < hb).all()
            and (boxes[:, 3] >= 0).all() and pair.max() < k * k):
        raise SystemExit("fused step output out of range")
    size = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    max_mem = (torch.cuda.max_memory_allocated() / 2 ** 30
               if device == "cuda" else None)
    checked = None
    if int8 and device == "cuda":
        t_check = time.perf_counter()
        checked = main_path_convs(pipe, pipe.upload_frames(host), b, hb, wb,
                                  orig_hw, thre1)
        if (checked["convs"], checked["quantizes"]) != (convs, quants):
            raise SystemExit(f"main path: {checked['convs']} convs and "
                             f"{checked['quantizes']} quantizations checked,"
                             f" want {convs} and {quants}")
        log(f"  int8 step: all {convs} conv_q calls ({len(checked['shapes'])}"
            f" distinct shapes) and {quants} quantize calls word-equal to "
            f"their plain versions at the main path's batch, maps and "
            f"scales ({time.perf_counter() - t_check:.1f} s)")
    res = {"hand": f"{size}px/s{hand_cfg.stages}", "batch": b,
           "bucket": [hb, wb], "thre1": thre1, "ms_per_step": dt * 1e3,
           "frames_per_s": b / dt, "peaks": int(count.sum()),
           "hand_boxes": int((boxes[:, 3] > 0).sum()),
           "pallas_nms": pallas_nms, "nms_launches": launches,
           "int8": int8, "conv_q_launches": conv_launches,
           "main_path_checked": checked,
           "quantize_launches": quant_launches, "steps": steps,
           "max_mem_gb": max_mem}
    kind = "nms_first_k" if pallas_nms else "nms_mask"
    log(f"  fused step {res['hand']}{' select' if pallas_nms else ''}"
        f"{' int8' if int8 else ''}: {res['ms_per_step']:.1f} ms/step, "
        f"{res['frames_per_s']:.1f} frames/s at B={b}, {res['peaks']} peaks,"
        f" {res['hand_boxes']} hand boxes, {kind} launches "
        f"{launches}/{steps}, conv_q launches {conv_launches}/{steps}, "
        f"quantize launches {quant_launches}/{steps}")
    return res, pipe, packed


def crops_match_cpu(pipe, host, b, hb, wb, boxes) -> dict:
    """The hand crops of a full-width step, cut on the card from the step's
    own decoded frames, word-equal to the same function on the CPU, before
    and after the rounding: at the step's hand boxes where there are any,
    else (random weights give none) at seeded boxes over the frames, some
    at their borders, at the step's crop count and size. Then timed."""
    from islx_torch.ops.resize import dynamic_crop_resize_batch
    from islx_torch.ops.yuv import yuv420_to_bgr

    size = int(np.rint(pipe.hand.cfg.scale_search[0] * pipe.hand.cfg.boxsize))
    frames = yuv420_to_bgr(pipe.upload_frames(host), b, hb, wb)
    rng = np.random.RandomState(7)
    n = len(boxes)
    side = rng.randint(1, hb + 1, n)
    seeded = np.stack([rng.randint(0, b, n), rng.randint(0, wb, n),
                       rng.randint(0, hb, n), side], 1)
    seeded[::7, 1:3] = 0                              # clamped at a corner
    use = np.where((boxes[:, 3] > 0)[:, None], boxes, seeded).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(use[:, i]))
            for i in range(4)]
    cpu_frames = frames.cpu()
    for saturate in (False, True):
        got = dynamic_crop_resize_batch(frames, *(a.cuda() for a in args),
                                        size, saturate).cpu()
        want = dynamic_crop_resize_batch(cpu_frames, *args, size, saturate)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"crops at {size} px: {int((got != want).sum())}"
                             f" of {got.numel()} words differ from the CPU "
                             f"function's (saturate_uint8={saturate})")
    dev_args = [a.cuda() for a in args]
    ms = cuda_ms(lambda: dynamic_crop_resize_batch(frames, *dev_args, size),
                 reps=5, warmup=1)
    log(f"  crops {n}x{size}px from the step's frames: card == CPU, word for "
        f"word ({int((boxes[:, 3] > 0).sum())} of the step's boxes, the rest"
        f" seeded); {ms:.3f} ms on the card")
    return {"crops": n, "size": size, "word_equal": True, "ms": ms}


def integer_planes(pipe, packed, b) -> dict:
    """The packed buffer's integer planes: peak coordinates and counts,
    pair indices and ok bits, hand boxes and hand peaks."""
    body, boxes, peaks = pipe.unpack(packed, b)
    xy, _, count, pair, _, cok = pipe.body.unpack(body, b)
    return {"xy": xy, "count": count, "pair": pair, "ok": cok,
            "boxes": boxes, "hand_peaks": peaks}


PORT_KERNELS = ("nms_mask_kernel", "band_kernel", "gather_kernel",
                "paf_sample_kernel", "cc_tile", "cc_border", "cc_final",
                "conv_q_kernel", "quantize_kernel")
STAGES = ("yuv420_to_bgr", "body_cpm", "body_peaks", "paf_limbs",
          "hand_boxes", "hand_crops", "hand_cpm", "hand_peaks", "pack")


def conv_flops(model_type: str, h: int, w: int, stages: int = 6) -> int:
    """Multiply-add operations x2 of one frame's CPM convolutions."""
    from islx_torch.models import cpm

    spec, tot, s = cpm.SPECS[model_type](), 0, 1
    for layer in spec["trunk"]:
        if isinstance(layer, cpm.Pool):
            s *= layer.s
        else:
            tot += (2 * layer.cin * layer.cout * layer.k ** 2
                    * (h // s) * (w // s))
    heads = list(spec["stages"].values())
    if model_type == "hand":
        heads = [spec["stage1"]] + heads[:stages - 1]
    return tot + sum(2 * c.cin * c.cout * c.k ** 2 * (h // s) * (w // s)
                     for convs in heads for c in convs)


def profile_step(hand_cfg, b=192, orig_hw=(512, 384), steps=3,
                 int8=False) -> dict:
    """torch.profiler over a few fused steps: device ms per stage (the
    ``record_function`` ranges of the pipeline), the kernels that take the
    most device time, the device's busy share of the window, and the CPM
    convolutions' achieved rate against the bf16 tensor-core peak."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe, host, hb, wb, thre1 = fused_setup(hand_cfg, b, orig_hw, "cuda",
                                            int8=int8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.device_step_flat(pipe.upload_frames(host), b, hb, wb,
                                  orig_hw, thre1,
                                  input_format="yuv420").cpu()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    stage_ms = dict.fromkeys(STAGES, 0.0)
    kernel_ms: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in stage_ms:
            stage_ms[e.name] += e.device_time_total / 1e3 / steps
        elif e.device_type == DeviceType.CUDA and e.name not in stage_ms:
            kernel_ms[e.name] = (kernel_ms.get(e.name, 0.0)
                                 + e.device_time_total / 1e3 / steps)
    device_ms = sum(kernel_ms.values())
    if device_ms <= 0:
        raise SystemExit("profile: the trace holds no device time")
    size = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    flops = {"body_cpm": b * conv_flops("body25", hb, wb),
             "hand_cpm": 2 * b * conv_flops("hand", size, size,
                                            hand_cfg.stages)}
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:12]
    # the port's own kernels (csrc/*.cu, launched through ctypes): the
    # profiler traces them but counts them in no stage's range
    port = {k: sum(ms for name, ms in kernel_ms.items()
                   if re.search(rf"(^|::){k}(<[^>]*>)?(\(|$)", name))
            for k in PORT_KERNELS}
    peak = PEAK_INT8_OPS_PER_S if int8 else PEAK_BF16_OPS_PER_S
    res = {"hand": f"{size}px/s{hand_cfg.stages}", "int8": int8,
           "batch": b, "bucket": [hb, wb], "steps": steps,
           "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / wall_ms, "stage_ms": stage_ms,
           # under int8 the convs run in no stage range: their rate is
           # conv_q_kernel's over both nets' operations
           "conv_tflop_per_s": (
               {"conv_q_kernel": sum(flops.values())
                / (port["conv_q_kernel"] * 1e-3) / 1e12} if int8 else
               {k: v / (stage_ms[k] * 1e-3) / 1e12
                for k, v in flops.items()}),
           "conv_bound_ms": {k: v / peak * 1e3 for k, v in flops.items()},
           "port_kernel_ms": port,
           "top_kernels": [{"name": n[:90], "ms": t} for n, t in top]}
    log(f"  profile {res['hand']}{' int8' if int8 else ''}: wall "
        f"{wall_ms:.1f} ms/step, device "
        f"{device_ms:.1f} ms ({100 * res['device_busy_share']:.1f}% busy)")
    for name, ms in stage_ms.items():
        log(f"    {name:14s} {ms:8.2f} ms")
    log(f"    port kernels (ms/step): "
        f"{ {k: round(v, 4) for k, v in port.items() if v} }")
    return res


def small_reference_check(int8: bool = False) -> None:
    """The card's f32 fused step == the plain CPU path on a small input:
    peak, pair, box and hand-peak tables equal (no allowance: the crop
    resize sums alike on both devices), scores within f16. With
    ``int8``, both run the same int8 W8A8 states, calibrated on the CPU on
    the input's frames (the int8 CPMs are exact on both devices)."""
    from islx_torch.core import weights as W
    from islx_torch.core.config import HandConfig, PoseConfig
    from islx_torch.pipeline.batch_pose import FusedPosePipeline

    bp, hp = W.init_params("body25", 0), W.init_params("hand", 1)
    bb = bp["Mconv7_stage1_L1"]["b"].clone()
    bb[2:8] += 1.0                      # arm joints present: hands fire
    bp["Mconv7_stage1_L1"]["b"] = bb
    kw = dict(pose_cfg=PoseConfig(max_peaks=8, thre2=-0.5),
              hand_cfg=HandConfig(scale_search=(0.25,)),
              compute_dtype=torch.float32)
    frames = (np.random.RandomState(0).rand(2, 48, 48, 3) * 255
              ).astype(np.uint8)
    if int8:
        bp, hp = quantize_on(bp, hp, list(frames), kw["hand_cfg"], "cpu")
    cpu = FusedPosePipeline(bp, hp, device="cpu", **kw)
    gpu = FusedPosePipeline(bp, hp, device="cuda", **kw)
    with torch.inference_mode():
        heat = cpu.body.net(torch.from_numpy(frames).float() / 256 - 0.5)[1]
    thre1 = float(np.quantile(heat[..., :25].numpy(), 0.9))
    want = cpu.device_step(frames, thre1=thre1).numpy()
    got = gpu.device_step(frames, thre1=thre1).cpu().numpy()
    if want.shape != got.shape:
        raise SystemExit(f"small check: shapes {want.shape} {got.shape}")
    (bw, xw, pw), (bg, xg, pg) = cpu.unpack(want, 2), gpu.unpack(got, 2)
    tw, tg = cpu.body.unpack(bw, 2), gpu.body.unpack(bg, 2)
    for name, i in (("xy", 0), ("count", 2), ("pair", 3), ("ok", 5)):
        if not np.array_equal(tw[i], tg[i]):
            raise SystemExit(f"small check: {name} differs from the CPU path")
    if not np.array_equal(xw, xg):
        raise SystemExit(f"small check: hand boxes differ:\n{xw}\n{xg}")
    # the crop resize sums in the same order on both devices, so the hand
    # peaks are equal too
    if not np.array_equal(pw, pg):
        bad = np.nonzero((pw != pg).any(-1))
        raise SystemExit(f"small check: hand peaks differ at {bad}: "
                         f"{pw[bad].tolist()} vs {pg[bad].tolist()}")
    err = max(float(np.abs(tw[1] - tg[1]).max()),
              float(np.abs(tw[4] - tg[4]).max()))
    if err > 1e-2:
        raise SystemExit(f"small check: scores differ by {err}")
    log(f"  small f32{' int8' if int8 else ''} step on the card vs CPU "
        f"plain path: body tables and "
        f"hand boxes equal ({int(tw[2].sum())} peaks, "
        f"{int((xw[:, 3] > 0).sum())} hand boxes), hand peaks equal, "
        f"score max abs diff {err:.2e}, words equal "
        f"{int((want == got).sum())}/{want.size}")


def parity_weights():
    """Seeded full-width BODY_25 and hand states; the arm joints' stage-1
    heat bias is raised by 1 so arms chain and hand boxes fire."""
    from islx_torch.core import weights as W

    bp, hp = W.init_params("body25", 0), W.init_params("hand", 1)
    bb = bp["Mconv7_stage1_L1"]["b"].clone()
    bb[2:8] += 1.0
    bp["Mconv7_stage1_L1"]["b"] = bb
    return bp, hp


def seeded_frame(rng, h, w) -> np.ndarray:
    """A seeded BGR u8 frame: smooth colour fields plus noise."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    chans = [128 + 90 * np.sin(rng.uniform(5, 20) * yy + rng.uniform(0, 6))
             * np.cos(rng.uniform(5, 20) * xx) for _ in range(3)]
    img = np.stack(chans, -1) + rng.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def calibrate_body(body, frame, k) -> float:
    """Raise thre1 from 0.1 in steps of x1.25 until the mean peak count per
    joint of the frame's averaged heatmaps is <= 4 (phase 4's rule; finer
    steps, since full-resolution maps of random nets hold many peaks)."""
    from islx_torch.ops.peaks import find_peaks

    with torch.inference_mode():
        heat, _ = body._maps(frame)
    thre1 = 0.1
    for _ in range(24):
        pk = find_peaks(heat[:, :, :body.cfg.njoint - 1].contiguous(), thre1,
                        k)
        if float(pk.count.float().mean()) <= 4.0:
            break
        thre1 *= 1.25
    body.cfg = dataclasses.replace(body.cfg, thre1=thre1)
    return thre1


def host_ms(fn, reps: int = 3) -> float:
    """Median wall ms of ``fn`` (each call ends in a copy to the host)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def parity_path() -> tuple:
    """The reference-parity path at full width in f32: ISLSignPos(Body,
    Hand()) on a seeded 720x1280 frame and Hand on two 256x256 crops; the
    three kernels of the path must each launch, kernel 3 must see a valid
    pair and kernel 4 foreground. -> (numbers, the Body, its frame)."""
    from islx_torch.core.config import HandConfig, PoseConfig
    from islx_torch.isl.translator import ISLSignPos
    from islx_torch.ops import cc_label as CC
    from islx_torch.ops import nms_first_k as NF
    from islx_torch.ops import paf_sample as PS
    from islx_torch.pose.body import Body
    from islx_torch.pose.hand import Hand

    bp, hp = parity_weights()
    body = Body(bp, config=PoseConfig(), compute_dtype=torch.float32)
    hand = Hand(hp, config=HandConfig(), compute_dtype=torch.float32)
    pos = ISLSignPos(body, hand)
    rng = np.random.RandomState(7)
    frame = seeded_frame(rng, 720, 1280)
    crops = [seeded_frame(rng, 256, 256) for _ in range(2)]
    thre1 = calibrate_body(body, frame, body.cfg.max_peaks)
    pos(frame)                                            # warm-up
    torch.cuda.synchronize()
    kernels = (NF.nms_first_k, PS.paf_sample, CC.label_components)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    cand, subset, hands = pos(frame)
    crop_peaks = [hand(c) for c in crops]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if min(launches.values()) < 1:
        raise SystemExit(f"parity path: a kernel was not launched: "
                         f"{launches}")
    pk, ls = body.peaks_and_limbs(frame)
    seq = body.limb_seq
    pairs = int((pk.count[torch.as_tensor(seq[:, 0])]
                 * pk.count[torch.as_tensor(seq[:, 1])]).sum())
    found = sum(int((p != 0).any(-1).sum()) for p in crop_peaks + hands)
    if pairs == 0:
        raise SystemExit("parity path: the PAF kernel saw no valid pair")
    if found == 0:
        raise SystemExit("parity path: the labelling kernel saw no "
                         "foreground")
    if not (np.isfinite(cand).all() and np.isfinite(subset).all()
            and all(((p >= 0).all() and p.shape == (21, 2))
                    for p in crop_peaks + hands)):
        raise SystemExit("parity path: output out of range")
    res = {"frame": [720, 1280], "thre1": thre1,
           "candidates": int(len(cand)), "people": int(len(subset)),
           "hand_boxes": len(hands), "valid_pairs": pairs,
           "ok_pairs": int(ls.ok.sum()), "hand_parts_found": found,
           "launches": launches, "wall_s": wall,
           "body_ms": host_ms(lambda: body(frame)),
           "hand_ms_256": host_ms(lambda: hand(crops[0]))}
    log(f"  parity path: {res['candidates']} candidates, {res['people']} "
        f"people, {len(hands)} hand boxes, {pairs} valid pairs, "
        f"{found} hand parts found; Body {res['body_ms']:.1f} ms/call, "
        f"Hand {res['hand_ms_256']:.1f} ms/call (256 px crop, 4 scales); "
        f"launches {launches}")
    return res, body, frame


def parity_small_check() -> None:
    """The parity path on the card == the plain CPU path, f32, on a 92x120
    frame and a 64 px crop: coordinates, part ids and subset indices
    equal, scores within 1e-4."""
    from islx_torch.core.config import HandConfig, PoseConfig
    from islx_torch.isl.translator import ISLSignPos
    from islx_torch.pose.body import Body
    from islx_torch.pose.hand import Hand

    bp, hp = parity_weights()
    pose = PoseConfig(scale_search=(0.25,), max_peaks=8, thre2=-0.5)
    hcfg = HandConfig(scale_search=(0.25,))
    rng = np.random.RandomState(8)
    frame = seeded_frame(rng, 92, 120)
    crop = seeded_frame(rng, 64, 64)
    out = {}
    for dev in ("cpu", "cuda"):
        body = Body(bp, config=pose, device=dev)
        hand = Hand(hp, config=hcfg, device=dev)
        if dev == "cpu":
            heat, _ = body.maps(frame)
            # the 60th percentile of the joint maps: people and hand
            # boxes form on this frame, so grouping and crops are checked
            thre1 = float(np.quantile(heat[..., :25], 0.6))
        body.cfg = dataclasses.replace(body.cfg, thre1=thre1)
        out[dev] = ISLSignPos(body, hand)(frame) + (hand(crop),)
    (cw, sw, hw, pw), (cg, sg, hg, pg) = out["cpu"], out["cuda"]
    same = (cw.shape == cg.shape and sw.shape == sg.shape
            and np.array_equal(cw[:, [0, 1, 3]], cg[:, [0, 1, 3]])
            and np.array_equal(sw[:, :-2], sg[:, :-2])
            and np.array_equal(sw[:, -1], sg[:, -1])
            and len(hw) == len(hg)
            and all(np.array_equal(a, b) for a, b in zip(hw, hg))
            and np.array_equal(pw, pg))
    if not same:
        raise SystemExit(f"parity small check: integer outputs differ "
                         f"between the card and the CPU path:\n{cw}\n{cg}\n"
                         f"{sw}\n{sg}\n{hw}\n{hg}\n{pw}\n{pg}")
    err = max([float(np.abs(cw[:, 2] - cg[:, 2]).max(initial=0.0)),
               float(np.abs(sw[:, -2] - sg[:, -2]).max(initial=0.0))])
    if err > 1e-4:
        raise SystemExit(f"parity small check: scores differ by {err}")
    if len(sw) == 0 or len(hw) == 0 or not (pw != 0).any():
        raise SystemExit("parity small check: no people, hand boxes or "
                         "hand parts")
    log(f"  small f32 parity path on the card vs CPU plain path: "
        f"{len(cw)} candidates, {len(sw)} people, {len(hw)} hand boxes, "
        f"{int((pw != 0).any(-1).sum())} crop parts equal; score max abs "
        f"diff {err:.2e}")


def translation(hand_cfg, n_frames=48, batch=16, orig_hw=(720, 1280),
                device="cuda"):
    from islx_torch.ops import nms_mask as N
    from islx_torch.pipeline.batch_pose import bucket_for
    from islx_torch.pipeline.translate import BatchedTranslatePipeline
    from islx_torch.ops.yuv import frame_bytes

    hb, wb = bucket_for(*orig_hw)
    pipe = BatchedTranslatePipeline(hand_cfg=hand_cfg, batch=batch,
                                    device=device)
    host = seeded_i420(np.random.RandomState(1), n_frames, hb, wb)
    per = frame_bytes(hb, wb)
    frames = [host[i * per:(i + 1) * per] for i in range(n_frames)]
    pipe.thre1 = calibrate_thre1(
        pipe.pipe, pipe.pipe.upload_frames(host[:batch * per]), batch, hb,
        wb, orig_hw)
    pipe.translate_yuv_frames(frames[:batch], orig_hw, (hb, wb))  # warm-up
    if device == "cuda":
        torch.cuda.synchronize()
    N.nms_mask_rows.launches = 0
    pipe.prof = {}
    t0 = time.perf_counter()
    out = pipe.translate_yuv_frames(frames, orig_hw, (hb, wb))
    dt = time.perf_counter() - t0
    launches = N.nms_mask_rows.launches
    want = n_frames - pipe.cfg.window_size + 1
    if [o[0] for o in out] != list(range(pipe.cfg.window_size - 1,
                                         n_frames)):
        raise SystemExit(f"translation: {len(out)} predictions, want {want}")
    if not all(0 <= o[1] < 167 and 0.0 <= o[3] <= 1.0 for o in out):
        raise SystemExit("translation: prediction out of range")
    if launches != (-(-n_frames // batch) if device == "cuda" else 0):
        raise SystemExit(f"translation: nms launches {launches}")
    stage_ms = {k: v * 1e3 for k, v in pipe.prof.items()}
    res = {"frames": n_frames, "batch": batch, "bucket": [hb, wb],
           "predictions": len(out), "frames_per_s": n_frames / dt,
           "nms_launches": launches, "thre1": pipe.thre1,
           "wall_ms": dt * 1e3, "host_stage_ms": stage_ms}
    log(f"  translation: {len(out)} predictions over {n_frames} frames, "
        f"{res['frames_per_s']:.1f} frames/s, nms launches {launches}; "
        f"host ms by stage over the run ({dt * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items()))
    return res


SERVE_BUCKETS = ((184, 144), (184, 328))   # portrait 4:3 and 16:9 frames


# every kernel wrapper with a launch counter, and its module
KERNELS = (("nms_mask_rows", "islx_torch.ops.nms_mask"),
           ("nms_first_k", "islx_torch.ops.nms_first_k"),
           ("paf_sample", "islx_torch.ops.paf_sample"),
           ("label_components", "islx_torch.ops.cc_label"),
           ("conv_q", "islx_torch.ops.conv_q"),
           ("quantize", "islx_torch.ops.conv_q"))


def kernel_counts(names=None) -> dict:
    """The launch counts of the kernel wrappers (all six by default)."""
    import importlib

    return {name: getattr(importlib.import_module(mod), name).launches
            for name, mod in KERNELS if names is None or name in names}


def set_counts(counts: dict) -> None:
    """Set the counters named in ``counts``."""
    import importlib

    for name, mod in KERNELS:
        if name in counts:
            getattr(importlib.import_module(mod), name).launches = \
                counts[name]


def serve_counts() -> dict:
    """The launch counts of the serving path's three kernels."""
    return kernel_counts(("nms_mask_rows", "conv_q", "quantize"))


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block (a reference to compare with) are
    taken out of the counts again."""
    before = kernel_counts()
    try:
        yield
    finally:
        set_counts(before)


def delta(before: dict) -> dict:
    """The launches since ``before``, of the kernels it counts."""
    now = kernel_counts()
    return {k: now[k] - v for k, v in before.items()}


def bgr_frames(rng, n, hb, wb) -> np.ndarray:
    """n seeded u8 BGR frames [n,hb,wb,3]: seeded I420 decoded on the card
    (the machine has no cv2)."""
    from islx_torch.ops.yuv import yuv420_to_bgr

    host = seeded_i420(rng, n, hb, wb)
    return yuv420_to_bgr(torch.from_numpy(host).cuda(), n, hb, wb).to(
        torch.uint8).cpu().numpy()


def serve_batch(batcher, frames, timeout=120.0) -> list:
    """Submit the frames at once and wait for every result."""
    futs = [batcher.submit(f) for f in frames]
    return [f.result(timeout=timeout) for f in futs]


def same_results(got, results, boxes, peaks, pipe) -> bool:
    """PoseResults equal, word for word, to a direct step's assembly."""
    for i, r in enumerate(got):
        cand, subset = results[i]
        hands = pipe.hands_for_frame(boxes, peaks, i)
        if not (np.array_equal(r.candidate, cand)
                and np.array_equal(r.subset, subset)
                and len(r.hands) == len(hands)
                and all(np.array_equal(a, b) for a, b in zip(r.hands,
                                                             hands))):
            return False
    return True


def load_pass(pipe, max_batch, clients, pools, seconds=10.0) -> dict:
    """``clients`` threads, each sending requests one at a time (the next
    after the last one's result) for ``seconds``, alternating the two
    buckets' frames, through a MicroBatcher at ``max_batch`` and the
    default 15 ms window, after one warm batch a bucket on a batcher of
    its own, whose NMS calls are held against their plain version. The
    NMS mask kernel must launch once a served batch."""
    from islx_torch.serve import MicroBatcher

    warm = MicroBatcher(pipe, max_batch=max_batch)
    try:
        with watched_nms() as nms:
            for pool in pools:
                serve_batch(warm, pool[:max_batch])
    finally:
        warm.close()
    b = MicroBatcher(pipe, max_batch=max_batch)
    errors, done = [], [0] * clients

    def client(c, stop_at):
        try:
            j = 0
            while time.perf_counter() < stop_at:
                pool = pools[(c + j) % len(pools)]
                b.submit(pool[(c * 7 + j) % len(pool)]).result(timeout=120)
                done[c] += 1
                j += 1
        except Exception as exc:     # reported below, and the phase fails
            errors.append(repr(exc))

    torch.cuda.synchronize()
    before = serve_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c, t0 + seconds))
               for c in range(clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 300)
        dt = time.perf_counter() - t0
    finally:
        b.close()
    launches = delta(before)
    st = b.stats()
    n = sum(done)
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"serving load: client errors {errors[:3]}")
    if (n < 256 or st["requests"] != n
            or st["latency_window_n"] != min(n, 2048)):
        raise SystemExit(f"serving load: {n} requests answered, {st}")
    if launches["nms_mask_rows"] != st["batches"]:
        raise SystemExit(f"serving load: nms_mask_rows launched "
                         f"{launches['nms_mask_rows']} times in "
                         f"{st['batches']} batches")
    res = {"max_batch": max_batch, "clients": clients, "requests": n,
           "frames_per_s": n / dt, "seconds": dt,
           "p50_ms": st["latency_ms_p50_request"],
           "p99_ms": st["latency_ms_p99_request"],
           "batches": st["batches"], "frames_padded": st["frames_padded"],
           "nms_launches": launches["nms_mask_rows"],
           "nms_checked": nms["shapes"]}
    log(f"  load max_batch {max_batch}, {clients} clients: "
        f"{res['frames_per_s']:.1f} frames/s over {dt:.1f} s ({n} "
        f"requests), request p50 {res['p50_ms']} ms, p99 {res['p99_ms']} "
        f"ms, {res['batches']} batches, {res['frames_padded']} frames "
        f"padded, nms launches {res['nms_launches']}")
    return res


@contextlib.contextmanager
def numpy_grouping():
    """Group in numpy (islx's ISLX_NO_NATIVE switch) inside the block."""
    old = os.environ.get("ISLX_NO_NATIVE")
    os.environ["ISLX_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ISLX_NO_NATIVE"]
        else:
            os.environ["ISLX_NO_NATIVE"] = old


def grouping_ms(pipe, packed, b) -> dict:
    """Host ms of ``assemble`` on a step's fetched buffer, with the C++
    grouping and with numpy's; both must give the same people."""
    def run():
        return pipe.assemble(packed, b)[0]

    cpp = run()
    with numpy_grouping():
        ref = run()
        numpy_ms = host_ms(run, reps=5)
    if not all(np.array_equal(c0, c1) and np.array_equal(s0, s1)
               for (c0, s0), (c1, s1) in zip(cpp, ref)):
        raise SystemExit("serving: the C++ grouping differs from numpy's")
    res = {"batch": b, "people": sum(len(s) for _, s in cpp),
           "candidates": sum(len(c) for c, _ in cpp),
           "cpp_ms": host_ms(run, reps=5), "numpy_ms": numpy_ms}
    log(f"  grouping a batch of {b} ({res['people']} people, "
        f"{res['candidates']} candidates): C++ {res['cpp_ms']:.3f} ms, "
        f"numpy {numpy_ms:.3f} ms (host, median of 5), same people")
    return res


def profile_served(pipe, frames, reps=5) -> dict:
    """``reps`` served batches of the same full batch of frames, timed from
    submit to the last result, then ``reps`` more under torch.profiler:
    device ms a batch (its kernels and copies), device operations a batch,
    and the device's busy share of the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from islx_torch.serve import MicroBatcher

    b = MicroBatcher(pipe, max_batch=len(frames), max_wait_ms=1000.0)
    try:
        serve_batch(b, frames)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve_batch(b, frames)
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                serve_batch(b, frames)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        b.close()
    ops = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.name not in STAGES]
    device_ms = sum(e.device_time_total for e in ops) / 1e3 / reps
    if device_ms <= 0:
        raise SystemExit("serving profile: the trace holds no device time")
    wall = statistics.median(walls)
    res = {"batch": len(frames), "bucket": list(frames.shape[1:3]),
           "wall_ms": wall, "wall_ms_profiled": prof_wall,
           "device_ms": device_ms, "device_ops": len(ops) / reps,
           "device_busy_share": device_ms / wall}
    log(f"  a served batch of {len(frames)} at {res['bucket']}: wall "
        f"{wall:.1f} ms (median of {reps}; {prof_wall:.1f} under the "
        f"profiler), device {device_ms:.2f} ms in {res['device_ops']:.0f} "
        f"kernels and copies, busy {100 * res['device_busy_share']:.1f}%")
    return res


def calibrate_people(pipe, frames, thre1, what="serving",
                     tries=16) -> float:
    """Set thre2 to -0.5 (the CPU serve tests' value) and lower thre1 from
    phase 4's calibrated value by x0.75 until a direct step of ``frames``
    forms a person a frame on average and at least one hand box (random
    weights form none at phase 4's thre1) -> that thre1, set in the
    pipeline's config."""
    for _ in range(tries):
        pipe.body.cfg = dataclasses.replace(pipe.body.cfg, thre1=thre1,
                                            thre2=-0.5)
        results, boxes, _ = pipe.assemble(
            pipe.device_step(frames, frames.shape[1:3]), len(frames))
        if (sum(len(s) for _, s in results) >= len(frames)
                and (boxes[:, 3] > 0).any()):
            return thre1
        thre1 *= 0.75
    raise SystemExit(f"{what}: no thre1 down to {thre1} forms people")


def serving(hand_cfg, swap_deadline_s: float = 120.0) -> dict:
    """The serving path at full width (BODY_25 + the hand CPM at
    ``hand_cfg``, bf16, the parity phase's seeded weights, thre1 and
    thre2 by calibrate_people, so that people and hands form) through
    islx_torch.serve: (a) a burst of
    8 frames served word-equal to a direct step, with at least one person
    and one hand, and the grouping timed in C++ and numpy; (b) load from 4
    and 16 clients at max_batch 8 and 32, and one served B=8 batch
    profiled; (c) the live int8 swap on 184x184 frames, landing within
    ``swap_deadline_s``, its first full batch word-equal to a pipeline
    quantized directly on the stored calibration frames, with each of its
    conv_q and quantize calls held against their plain versions; (d) GET
    /healthz over HTTP. Every served batch of (a), (b)'s warm batches and
    (c)'s int8 batch hold their NMS mask calls against the plain version.
    The counts start at 0; the references' launches are taken out."""
    import urllib.request

    from islx_torch.models import quant
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.serve import MicroBatcher, PoseServer

    rng = np.random.RandomState(3)
    pools = [bgr_frames(rng, 32, hb, wb) for hb, wb in SERVE_BUCKETS]
    pipe = FusedPosePipeline(*parity_weights(), hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device="cuda")
    hb, wb = SERVE_BUCKETS[0]
    burst = pools[0][:8]
    thre1 = calibrate_people(pipe, burst, calibrate_thre1(
        pipe, pipe.upload_frames(seeded_i420(np.random.RandomState(0), 32,
                                             hb, wb)), 32, hb, wb, (hb, wb)))
    from islx_torch.ops import conv_q as CQ
    from islx_torch.ops import nms_mask as N

    N.nms_mask_rows.launches = 0
    CQ.conv_q.launches = 0
    CQ.quantize.launches = 0
    t_phase = time.perf_counter()
    nms_shapes = set()

    # (a) a burst of one full batch, against a direct step
    b = MicroBatcher(pipe, max_batch=8, max_wait_ms=1000.0)
    try:
        with watched_nms() as nms:
            got = serve_batch(b, burst)
    finally:
        b.close()
    nms_shapes.update(nms["shapes"])
    if b.stats()["batches"] != 1:
        raise SystemExit(f"serving: the burst took {b.stats()['batches']} "
                         f"batches")
    with uncounted():
        packed = pipe.device_step(burst, (hb, wb)).cpu().numpy()
        wide = pipe.device_step(pools[1], SERVE_BUCKETS[1]).cpu().numpy()
    results, boxes, peaks = pipe.assemble(packed, 8)
    if not same_results(got, results, boxes, peaks, pipe):
        raise SystemExit("serving: the burst's results differ from a direct "
                         "step's")
    people = sum(len(r.subset) for r in got)
    hands = sum(len(r.hands) for r in got)
    if not (people and hands):
        raise SystemExit(f"serving: the burst formed {people} people and "
                         f"{hands} hands; the check needs both")
    exact = {"frames": 8, "candidates": sum(len(r.candidate) for r in got),
             "people": people, "hands": hands, "thre1": thre1, "thre2": -0.5,
             "word_equal": True}
    log(f"  burst of 8: served results word-equal to a direct step "
        f"({exact['candidates']} candidates, {people} people, {hands} "
        f"hands)")
    grouping = [grouping_ms(pipe, packed, 8), grouping_ms(pipe, wide, 32)]

    # (b) load, then one served B=8 batch profiled
    load = [load_pass(pipe, mb, clients, pools)
            for mb in (8, 32) for clients in (4, 16)]
    for row in load:
        nms_shapes.update(row["nms_checked"])
    profiled = profile_served(pipe, burst)

    # (c) the live int8 swap on 184x184 frames (no resize, hand crop 184)
    side = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    sq = bgr_frames(rng, 24, side, side)
    b = MicroBatcher(pipe, max_batch=8, max_wait_ms=1000.0,
                     quantize_after=16)
    real_step = FusedPosePipeline.device_step
    stepped = []

    def recorded(self, frames, orig_hw=None, thre1=None):
        out = real_step(self, frames, orig_hw, thre1)
        stepped.append(out.cpu().numpy())
        return out

    try:
        serve_batch(b, sq[:8])
        serve_batch(b, sq[8:16])
        t0 = time.perf_counter()
        float_batches = 0
        while not b.stats()["quantized"]:
            if time.perf_counter() - t0 > swap_deadline_s:
                raise SystemExit(f"serving: the int8 swap did not land in "
                                 f"{swap_deadline_s} s: {b.stats()}")
            serve_batch(b, sq[16:24])
            float_batches += not b.stats()["quantized"]
        landed = time.perf_counter() - t0
        if b.stats().get("quantize_error"):
            raise SystemExit(f"serving: {b.stats()['quantize_error']}")
        before = serve_counts()
        FusedPosePipeline.device_step = recorded
        try:
            with watched_convs() as convs, watched_nms() as nms:
                got = serve_batch(b, sq[16:24])
        finally:
            FusedPosePipeline.device_step = real_step
        one = delta(before)
    finally:
        b.close()
    nms_shapes.update(nms["shapes"])
    stages = hand_cfg.stages
    want = {"nms_mask_rows": 1, "conv_q": 114 + 17 + 7 * (stages - 1),
            "quantize": 103 + 2 + (stages - 1)}
    if one != want or (convs["convs"], convs["quantizes"]) != (
            want["conv_q"], want["quantize"]):
        raise SystemExit(f"serving: the int8 batch launched {one} and held "
                         f"{convs['convs']} convs and {convs['quantizes']} "
                         f"quantizations against their plain versions, "
                         f"want {want}")
    need = {(8, 25, 184, 144), (8, 25, 184, 328), (32, 25, 184, 144),
            (32, 25, 184, 328), (8, 25, side, side)}
    if not need <= nms_shapes:
        raise SystemExit(f"serving: nms_mask_rows was held against its "
                         f"plain version at {sorted(nms_shapes)}, not at "
                         f"{sorted(need - nms_shapes)}")
    log(f"  int8 batch: all {convs['convs']} conv_q calls "
        f"({len(convs['shapes'])} distinct shapes) and {convs['quantizes']} "
        f"quantize calls word-equal to their plain versions; nms_mask_rows "
        f"bit-equal to its plain version on the served batches' maps at "
        f"{sorted(nms_shapes)}")
    calib = np.stack(b.calibrated_on)
    if not np.array_equal(calib, sq[:16]):
        raise SystemExit("serving: the swap did not calibrate on the first "
                         "16 served frames")
    with uncounted():
        x = calib.astype(np.float32) / 256.0 - 0.5
        chunks = [x[i:i + 8] for i in range(0, len(x), 8)]
        states = (quant.quantize_model(pipe.body.params, "body25", chunks,
                                       torch.bfloat16, device="cuda"),
                  quant.quantize_model(pipe.hand.params, "hand", chunks,
                                       torch.bfloat16, device="cuda"))
        ref = FusedPosePipeline(*states, pose_cfg=pipe.body.cfg,
                                hand_cfg=hand_cfg,
                                compute_dtype=torch.bfloat16, device="cuda")
        ref_packed = ref.device_step(sq[16:24], (side, side)).cpu().numpy()
        del ref
    apart = [f"{net}.{layer}.{key}"
             for net, got, want in (("body", b.pipe.body.params, states[0]),
                                    ("hand", b.pipe.hand.params, states[1]))
             for layer, entry in want.items() for key, v in entry.items()
             if not (torch.equal(v.cpu(), got[layer][key].cpu())
                     if isinstance(v, torch.Tensor)
                     else v == got[layer][key])]
    if apart:
        raise SystemExit(f"serving: the swap's int8 states differ from a "
                         f"direct quantize_model's at {apart[:6]}")
    if len(stepped) != 1 or not np.array_equal(stepped[0], ref_packed):
        raise SystemExit(f"serving: the int8 batch's packed buffer differs "
                         f"from a directly quantized pipeline's "
                         f"({len(stepped)} steps recorded)")
    swap = {"quantize_after": 16, "landed_s": landed,
            "float_batches_while_swapping": float_batches,
            "keys_warmed": len(b.pipe.program_keys()),
            "launches_one_batch": one, "word_equal": True,
            "words": int(ref_packed.size),
            "convs_checked": convs["convs"],
            "quantizes_checked": convs["quantizes"],
            "conv_max_abs_err": convs["max_abs_err"],
            "candidates": sum(len(r.candidate) for r in got),
            "people": sum(len(r.subset) for r in got),
            "hands": sum(len(r.hands) for r in got)}
    log(f"  int8 swap: landed {landed:.2f} s after it started "
        f"({float_batches} float batches served meanwhile, "
        f"{swap['keys_warmed']} keys warmed); one int8 batch launched "
        f"{one}; its {swap['words']} words equal a directly quantized "
        f"pipeline's ({swap['people']} people, {swap['hands']} hands)")

    # (d) HTTP, on the int8 pipeline (GET only: no cv2 to decode a POST)
    server = PoseServer(b.pipe, port=0, max_batch=8)
    server.start()
    try:
        server.batcher.pose(sq[0], timeout=120)
        url = f"http://127.0.0.1:{server.port}/healthz"
        with urllib.request.urlopen(url, timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        server.close()
    if not (health.get("ok") and health["requests"] == 1
            and health["batches"] == 1 and health["quantized"] is False
            and health["latency_window_n"] == 1):
        raise SystemExit(f"serving: /healthz gave {health}")
    log(f"  GET /healthz over HTTP: {health}")
    launches = serve_counts()
    for k, v in launches.items():
        if v <= 0:
            raise SystemExit(f"serving: {k} never launched")
    res = {"hand": f"{side}px/s{stages}", "exact": exact, "load": load,
           "grouping": grouping, "profiled_batch": profiled, "swap": swap,
           "nms_checked": sorted(nms_shapes), "healthz": health,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    log(f"  serving launches {launches} in {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------- 5e

AOT_BUCKET = (184, 144)           # serve-184s6's portrait 4:3 bucket
NO_COMPILER = "#!/bin/sh\necho \"$0: no compiler on a warm leg\" >&2\nexit 1\n"


def _timed(fn, spent):
    """``fn``, adding the seconds of each call to ``spent["build"]``."""
    def inner(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spent["build"] += time.perf_counter() - t
    return inner


def aot_leg(cfg_path: str) -> int:
    """One leg of phase 5e in a fresh process (``--aot-leg CFG``): imports
    the package copy at ``cfg["root"]``, builds the serving pipeline on the
    state files and thresholds it is given, with a MicroBatcher on ``cfg["aot_dir"]``
    when set, and serves the 8 frames once (the first response, timed
    from the process's launch: import, build, construction, first step)
    and once more with every NMS mask call, and under int8 every conv_q
    and quantize call, held against its plain version, and a third time
    unwatched (a steady batch, timed). Writes its numbers
    to ``cfg["out"]`` and the first batch's packed words beside it."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    root = os.path.abspath(cfg["root"])
    sys.path.insert(0, root)
    import islx_torch

    if not os.path.abspath(islx_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"aot leg: islx_torch from {islx_torch.__file__}, "
                         f"not from {root}")
    from islx_torch.core import weights as W
    from islx_torch.core.config import HandConfig
    from islx_torch.ops import _build
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.serve import MicroBatcher

    t_import = time.time() - cfg["t_launch"]
    spent, compiled = {"build": 0.0}, []
    real_build = _build.build

    def build(name):
        fresh = not os.path.exists(_build.lib_path(name))
        out = real_build(name)
        if fresh:
            compiled.append(name)
        return out

    _build.build = build
    _build.load = _timed(_build.load, spent)
    _build.install = _timed(_build.install, spent)
    hb, wb = AOT_BUCKET
    hand_cfg = HandConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg["hand_cfg"].items()})
    res = {"import_s": t_import}
    t0 = time.perf_counter()
    pipe = FusedPosePipeline(W.load(cfg["body"], "body25"),
                             W.load(cfg["hand"], "hand"), hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device="cuda")
    pipe.body.cfg = dataclasses.replace(pipe.body.cfg, **cfg["pose"])
    batcher = MicroBatcher(pipe, max_batch=8, max_wait_ms=1000.0,
                           target_h=hb, aot_dir=cfg["aot_dir"])
    res["construction_s"] = time.perf_counter() - t0 - spent["build"]
    res["aot_loaded"] = [list(k) for k in batcher.aot_loaded]
    res["stats_before"] = batcher.stats()
    before = spent["build"]
    frames = np.load(cfg["frames"])
    captured = []
    step = pipe.device_step

    def capture(frames, orig_hw=None, thre1=None):
        out = step(frames, orig_hw, thre1)
        captured.append(out.clone())    # the worker reads it in place
        return out

    pipe.device_step = capture
    t1 = time.perf_counter()
    try:
        got = serve_batch(batcher, frames)
        res["first_step_s"] = (time.perf_counter() - t1
                               - (spent["build"] - before))
        res["first_response_s"] = time.time() - cfg["t_launch"]
        res["build_in_first_step_s"] = spent["build"] - before
        res["launches_first"] = kernel_counts()
        with watched_nms() as nms, (
                watched_convs() if cfg["int8"]
                else contextlib.nullcontext({})) as convs:
            again = serve_batch(batcher, frames)
        t1 = time.perf_counter()
        steady = serve_batch(batcher, frames)
        res["steady_step_s"] = time.perf_counter() - t1
    finally:
        batcher.close()
    results, boxes, peaks = pipe.assemble(captured[0], 8)
    if not all(same_results(r, results, boxes, peaks, pipe)
               for r in (got, again, steady)):
        raise SystemExit("aot leg: a served batch differs from its "
                         "step's words")
    np.save(cfg["out"] + ".npy", captured[0].cpu().numpy())
    res.update(launches=kernel_counts(), nms_checked=nms["calls"],
               convs_checked=convs.get("convs", 0),
               quantizes_checked=convs.get("quantizes", 0),
               people=sum(len(r.subset) for r in got),
               hands=sum(len(r.hands) for r in got),
               stats_after=batcher.stats())
    res.update(build_s=spent["build"], compiled=compiled,
               libraries=[{k: r[k] for k in ("name", "key", "compiler")}
                          for r in _build.loaded()])
    with open(cfg["out"], "w") as f:
        json.dump(res, f)
    return 0


def copy_package(root: str) -> str:
    """A copy of islx_torch under ``root`` with no build directory."""
    shutil.copytree(os.path.join(HERE, "islx_torch"),
                    os.path.join(root, "islx_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return root


def run_leg(name: str, work: str, cfg: dict, no_compiler: bool = False,
            timeout: float = 600.0) -> dict:
    """Run one leg of phase 5e in a fresh process; ``no_compiler`` puts an
    ``nvcc`` and a ``g++`` that fail first on PATH and CUDA_HOME at an
    empty toolkit, so that any compile raises -> the leg's numbers (and
    ``packed``, its first batch's words)."""
    env = dict(os.environ)
    if no_compiler:
        bin_dir = os.path.join(work, "nocc", "bin")
        os.makedirs(bin_dir, exist_ok=True)
        for cc in ("nvcc", "g++"):
            path = os.path.join(bin_dir, cc)
            with open(path, "w") as f:
                f.write(NO_COMPILER)
            os.chmod(path, 0o755)
        env["PATH"] = bin_dir + os.pathsep + env.get("PATH", "")
        env["CUDA_HOME"] = os.path.dirname(bin_dir)
    out = os.path.join(work, f"{name}.json")
    cfg_path = os.path.join(work, f"{name}.cfg.json")
    cfg = dict(cfg, out=out, t_launch=time.time())
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    proc = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                           "--aot-leg", cfg_path], env=env, cwd=cfg["root"],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-6000:])
        raise SystemExit(f"warm starts: the {name} leg failed "
                         f"(exit {proc.returncode})")
    with open(out) as f:
        res = json.load(f)
    if os.path.exists(out + ".npy"):
        res["packed"] = np.load(out + ".npy")
    return res


def warm_starts(hand_cfg, thre1=None) -> dict:
    """Phase 5e: serve-184s6's first response in fresh processes, each on
    a copy of the package without a build directory (module doc), at
    phase 5b's thre1 (calibrated here as 5b does when not given). The
    launches are the legs' own; this process only makes the references."""
    from islx_torch.cli import export_programs
    from islx_torch.core import aot
    from islx_torch.core import weights as W
    from islx_torch.core.config import HandConfig
    from islx_torch.pipeline.batch_pose import FusedPosePipeline

    hb, wb = AOT_BUCKET
    burst = bgr_frames(np.random.RandomState(3), 32, hb, wb)[:8]
    bp, hp = parity_weights()
    pipe = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device="cuda")
    if thre1 is None:
        thre1 = calibrate_people(pipe, burst, calibrate_thre1(
            pipe, pipe.upload_frames(seeded_i420(np.random.RandomState(0),
                                                 32, hb, wb)),
            32, hb, wb, (hb, wb)))
    pipe.body.cfg = dataclasses.replace(pipe.body.cfg, thre1=thre1,
                                        thre2=-0.5)
    # the int8 leg serves what the export CLI's --int8 artifact was made
    # for: the ungated hand config and the default thre2
    hand_q = HandConfig.production()
    bq, hq = quantize_on(bp, hp, list(burst), hand_q, "cuda")
    pipe_q = FusedPosePipeline(bq, hq, hand_cfg=hand_q,
                               compute_dtype=torch.bfloat16, device="cuda")
    pipe_q.body.cfg = dataclasses.replace(pipe_q.body.cfg, thre1=thre1)
    want = pipe.device_step(burst, (hb, wb)).cpu().numpy()
    want_q = pipe_q.device_step(burst, (hb, wb)).cpu().numpy()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="islx_aot_")
    try:
        paths = {k: os.path.join(work, f"{k}.pt")
                 for k in ("body", "hand", "body_q", "hand_q")}
        for k, state in zip(paths, (bp, hp, bq, hq)):
            W.save_state(paths[k], state, "hand" if "hand" in k
                         else "body25")
        frames = os.path.join(work, "frames.npy")
        np.save(frames, burst)
        cold = copy_package(os.path.join(work, "cold"))
        aot_dir, aot_q = (os.path.join(work, d) for d in ("aot", "aot_q"))
        base = {"frames": frames, "aot_dir": None, "int8": False,
                "body": paths["body"], "hand": paths["hand"],
                "hand_cfg": dataclasses.asdict(hand_cfg),
                "pose": {"thre1": thre1, "thre2": -0.5}}
        legs = {"cold": run_leg("cold", work, dict(base, root=cold)),
                "restart": run_leg("restart", work, dict(base, root=cold))}
        # the export runs here, on the libraries this process loaded
        # (phase 2's builds); its steps are not the path's launches
        with uncounted():
            t0 = time.perf_counter()
            export_programs.export(pipe, aot_dir, 8, [AOT_BUCKET],
                                   target_h=hb)
            t1 = time.perf_counter()
            export_programs.main(["--out", aot_q, "--batch", "8", "--orig",
                                  f"{hb}x{wb}", "--target-h", str(hb),
                                  "--int8", "--device", "cuda"])
            exported = {"export_s": t1 - t0,
                        "export_int8_s": time.perf_counter() - t1,
                        "libraries": [
                            lib["name"] for lib in aot.read_meta(
                                os.path.join(aot_dir, os.listdir(aot_dir)[0])
                            )["libraries"]]}
        legs["warm"] = run_leg("warm", work, dict(
            base, root=copy_package(os.path.join(work, "warm")),
            aot_dir=aot_dir), no_compiler=True)
        legs["warm_int8"] = run_leg("warm_int8", work, dict(
            base, root=copy_package(os.path.join(work, "warm_int8")),
            aot_dir=aot_q, int8=True, body=paths["body_q"],
            hand=paths["hand_q"], hand_cfg=dataclasses.asdict(hand_q),
            pose={"thre1": thre1}), no_compiler=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    key = [8, hb, wb, 1.0, 1.0, "bgr"]
    checks = [
        ("cold compiled nms_mask and grouping",
         {"nms_mask", "grouping"} <= set(legs["cold"]["compiled"])),
        ("restart compiled nothing", legs["restart"]["compiled"] == []),
        ("warm legs compiled nothing",
         legs["warm"]["compiled"] == legs["warm_int8"]["compiled"] == [])]
    for name in ("warm", "warm_int8"):
        leg = legs[name]
        checks += [
            (f"{name} loaded the key before traffic",
             leg["aot_loaded"] == [key]),
            (f"{name} counted no traffic before the first request",
             leg["stats_before"]["requests"] == 0
             and leg["stats_before"]["batches"] == 0),
            (f"{name} loaded nothing in its first step",
             leg["build_in_first_step_s"] == 0.0)]
    ref = integer_planes(pipe, legs["cold"]["packed"], 8)
    for name in ("restart", "warm"):
        got = integer_planes(pipe, legs[name]["packed"], 8)
        checks.append((f"{name}'s first response word-equal to cold's",
                       all(np.array_equal(ref[k], got[k]) for k in ref)))
    got = integer_planes(pipe_q, legs["warm_int8"]["packed"], 8)
    ref_q = integer_planes(pipe_q, want_q, 8)
    checks.append(("warm_int8's first response word-equal to this "
                   "process's int8 step",
                   all(np.array_equal(ref_q[k], got[k]) for k in ref_q)))
    used = {n: {k for k, v in legs[n]["launches"].items() if v > 0}
            for n in legs}
    checks += [
        ("every leg counted all six kernels",
         all(set(legs[n]["launches"]) == set(ALL_KERNELS) for n in legs)),
        ("no leg launched nms_first_k, paf_sample or label_components",
         all(legs[n]["launches"][k] == 0 for n in legs
             for k in ("nms_first_k", "paf_sample", "label_components"))),
        ("every leg launched the same kernels as the cold leg",
         used["restart"] == used["warm"] == used["cold"]
         == {"nms_mask_rows"}),
        ("warm_int8 launched nms_mask_rows, conv_q and quantize",
         used["warm_int8"] == {"nms_mask_rows", "conv_q", "quantize"}),
        ("every kernel call of the held batches equal to its plain version",
         all(legs[n]["nms_checked"] == 1 for n in legs)
         and legs["warm_int8"]["convs_checked"] > 0)]
    failed = [what for what, ok in checks if not ok]
    for name, leg in legs.items():
        log(f"  {name}: first response {leg['first_response_s']:.2f} s "
            f"after launch (import {leg['import_s']:.2f}, build "
            f"{leg['build_s']:.2f}, construction "
            f"{leg['construction_s']:.2f}, first step "
            f"{leg['first_step_s']:.3f}, a steady batch "
            f"{leg['steady_step_s']:.3f}); compiled {leg['compiled']}; "
            f"launches {leg['launches']}")
    log(f"  export (this process): bf16 {exported['export_s']:.2f} s, int8 "
        f"(CLI) {exported['export_int8_s']:.2f} s; libraries "
        f"{exported['libraries']}")
    if failed:
        raise SystemExit(f"warm starts: {failed}")
    launches = {k: legs["warm"]["launches"][k]
                + legs["warm_int8"]["launches"][k] for k in ALL_KERNELS}
    res = {"bucket": list(AOT_BUCKET), "batch": 8, "thre1": thre1,
           "legs": {n: {k: v for k, v in leg.items() if k != "packed"}
                    for n, leg in legs.items()},
           "export": exported, "launches": launches,
           "cold_words_equal_this_process": int(
               (legs["cold"]["packed"] == want).sum()),
           "words": int(want.size), "checks": [w for w, _ in checks],
           "seconds": time.perf_counter() - t_phase}
    log(f"  first responses word-equal (cold == restart == warm, warm "
        f"int8 == this process's int8 step); warm launches {launches} in "
        f"{res['seconds']:.1f} s")
    return res


@contextlib.contextmanager
def watched_parity(what="extraction"):
    """Inside the block every nms_first_k, paf_sample and label_components
    call of the parity path (from ops.peaks, ops.paf and ops.hand_peaks) is
    held bit for bit against its plain version on the same inputs, and
    must launch its kernel once; a mismatch raises RuntimeError naming
    ``what``. Yields the calls checked, by kernel."""
    from islx_torch.ops import cc_label as CC
    from islx_torch.ops import hand_peaks as HP
    from islx_torch.ops import nms_first_k as NF
    from islx_torch.ops import paf as PF
    from islx_torch.ops import paf_sample as PS
    from islx_torch.ops import peaks as P

    def words(a, b):
        return all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y)
                   for x, y in zip(a, b))

    seen = {"nms_first_k": 0, "paf_sample": 0, "label_components": 0}
    plan = [(P, "nms_first_k", NF.nms_first_k, NF.nms_first_k_plain),
            (PF, "paf_sample", PS.paf_sample, PS.paf_sample_plain),
            (HP, "label_components", CC.label_components,
             CC.label_components_plain)]

    def watch(name, kern, plain):
        def watched(*a, **k):
            before = kern.launches
            got = kern(*a, **k)
            if kern.launches != before + 1:
                raise RuntimeError(f"{what}: {name} launched "
                                   f"{kern.launches - before} times")
            want = plain(*a, **k)
            pair = (got, want) if isinstance(got, tuple) else \
                ((got,), (want,))
            if not words(*pair):
                raise RuntimeError(f"{what}: {name} differs from its "
                                   f"plain version at "
                                   f"{tuple(a[0].shape)}")
            seen[name] += 1
            return got
        return watched

    for mod, name, kern, plain in plan:
        setattr(mod, name, watch(name, kern, plain))
    try:
        yield seen
    finally:
        for mod, name, kern, _ in plan:
            setattr(mod, name, kern)


def direct_records(pipe, items, batch, orig_hw) -> dict:
    """idx -> (JSON text, feature vector) of a direct device_step_flat +
    hands_for_frame + frame_features over ``items`` (idx, augmented frame),
    batched and padded as extraction batches them (uncounted)."""
    from islx_torch.isl import features as F
    from islx_torch.pipeline.batch_pose import bucket_for

    hb, wb = bucket_for(*orig_hw)
    sy, sx = orig_hw[0] / hb, orig_hw[1] / wb
    out = {}
    with uncounted(), torch.inference_mode():
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            arr = np.stack([f for _, f in chunk]
                           + [chunk[0][1]] * (batch - len(chunk)))
            packed = pipe.device_step_flat(pipe.upload_frames(arr), batch,
                                           hb, wb, orig_hw)
            results, boxes, peaks = pipe.assemble(packed, batch)
            for j, (idx, _) in enumerate(chunk):
                cand, subset = results[j]
                if cand.shape[0]:
                    cand = cand.copy()
                    cand[:, 0] *= sx
                    cand[:, 1] *= sy
                hands = pipe.hands_for_frame(boxes, peaks, j, sy, sx)
                out[idx] = (json.dumps({
                    "candidate": cand.tolist(), "subset": subset.tolist(),
                    "all_hand_peaks": [h.tolist() for h in hands]}),
                    F.frame_features(cand, subset, hands))
    return out


def same_as_direct(root, video, rows, want) -> dict:
    """Each written record of ``video`` byte-equal to the direct one and
    each row's features equal -> {"records", "people", "hands"}."""
    n = people = hands = 0
    for row in rows:
        idx = row["frame"]
        with open(os.path.join(root, video, f"{idx:06d}.json")) as f:
            text = f.read()
        rec, feat = want[idx]
        if text != rec:
            raise SystemExit(f"extraction: {video} frame {idx}'s record "
                             f"differs from a direct step's")
        if not np.array_equal(np.array([row[f"f{i}"] for i in range(156)]),
                              feat):
            raise SystemExit(f"extraction: {video} frame {idx}'s features "
                             f"differ from a direct step's")
        r = json.loads(text)
        n, people, hands = (n + 1, people + len(r["subset"]),
                            hands + len(r["all_hand_peaks"]))
    return {"records": n, "people": people, "hands": hands}


def extraction_host_split(pipe, pipe_q, items, frames, cfg, hb, wb) -> dict:
    """Where a fused leg's time goes (uncounted): the host's ms a frame to
    augment (``_augment_frame`` on the CPU, the prefetch thread's work) and
    to write a record (``save_frame``), and frames/s of the steps alone
    (upload, device_step_flat, assemble, hands_for_frame) on the augmented
    frames, bf16 and int8."""
    from islx_torch.isl import extract as E

    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        E._augment_frame(cfg, "split", i, f)
    aug = (time.perf_counter() - t0) * 1e3 / len(frames)
    arrs = [np.stack([f for _, f in items[i:i + 16]])
            for i in range(0, len(items), 16)]
    out = {"augment_ms_per_frame": aug}
    with uncounted(), torch.inference_mode():
        for name, p in (("bf16", pipe), ("int8", pipe_q)):
            results = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for arr in arrs:
                packed = p.device_step_flat(p.upload_frames(arr), 16, hb,
                                            wb, (hb, wb))
                people, boxes, peaks = p.assemble(packed, 16)
                results += [(c, s, p.hands_for_frame(boxes, peaks, j))
                            for j, (c, s) in enumerate(people)]
            dt = time.perf_counter() - t0
            out[f"steps_only_{name}_frames_per_s"] = len(items) / dt
        t0 = time.perf_counter()
        for (idx, f), (c, s, h) in zip(items, results):
            E.save_frame(cfg, "split", idx, c, s, h, f)
        out["save_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(
            items)
    return out


def extraction(hand_cfg, records_to: str) -> dict:
    """Dataset extraction (islx_torch.isl.extract) at full width on the
    card, from memory (the machine has no cv2 to decode a clip): 48 seeded
    184x328 frames (a bucket size, so no resize), augmentation on, the
    serving phase's seeded weights and its thresholds' rule (thre2 -0.5,
    thre1 from phase 4's rule lowered until people and hands form). Legs:
    (a) the fused path at batch 16, bf16 and with int8 CPMs calibrated on
    the frames (as phase 4c calibrates);
    (b) a resume after a third of (a)'s records are deleted: only those
    are written, with the same bytes; (c) two shards over four videos;
    (d) the exact per-frame path (ISLSignPos) over 8 frames. Every record
    is byte-equal to a direct step's on the same augmented frames, which
    the card augments word-equal to the CPU; every kernel call of the legs
    is held against its plain version; (a) is timed once more unwatched
    and must write the same bytes. The records of (a) and (c) are copied to
    ``records_to`` (phase 5d trains on them). -> numbers, launches by
    kernel."""
    from islx_torch.core.config import HandConfig, PoseConfig
    from islx_torch.isl import extract as E
    from islx_torch.isl.translator import ISLSignPos
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.pose.body import Body
    from islx_torch.ops.yuv import frame_bytes, yuv420_to_bgr
    from islx_torch.pose.hand import Hand

    hb, wb = 184, 328
    host = seeded_i420(np.random.RandomState(11), 48, hb, wb)
    frames = yuv420_to_bgr(torch.from_numpy(host).cuda(), 48, hb, wb).to(
        torch.uint8).cpu().numpy()
    bp, hp = parity_weights()

    def cfg_for(root):
        return E.ExtractConfig(out_root=root, augment=True)

    pipe = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device="cuda")
    with uncounted():
        flat = pipe.upload_frames(host[:16 * frame_bytes(hb, wb)])
        thre1 = calibrate_people(pipe, frames[:16], calibrate_thre1(
            pipe, flat, 16, hb, wb, (hb, wb)))
    tmp = tempfile.mkdtemp(prefix="islx_extract_")
    side = int(round(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    res = {"frames": 48, "bucket": [hb, wb], "batch": 16, "thre1": thre1,
           "thre2": -0.5, "hand": f"{side}px/s{hand_cfg.stages}",
           "legs": {}}

    def augmented(video, src):
        """(idx, frame) augmented on the CPU, and word-equal on the card."""
        cfg = cfg_for(tmp)
        items = []
        for i, f in enumerate(src):
            cpu = E._augment_frame(cfg, video, i, f)
            card = E._augment_frame(cfg, video, i, f, device="cuda")
            if not np.array_equal(cpu, card):
                raise SystemExit(f"extraction: frame {i} of {video} augments "
                                 f"to other words on the card")
            items.append((i, cpu))
        return items

    def leg(name, run, n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res["legs"][name] = {"frames": n_frames, "seconds": dt,
                             "frames_per_s": n_frames / dt}
        return out

    try:
        items = augmented("clip0", frames)
        qb, qh = quantize_on(bp, hp, list(frames[:8]), hand_cfg, "cuda")
        pipe_q = FusedPosePipeline(qb, qh, hand_cfg=hand_cfg,
                                   compute_dtype=torch.bfloat16,
                                   device="cuda")
        for p in (pipe, pipe_q):
            p.body.cfg = dataclasses.replace(p.body.cfg, thre1=thre1,
                                             thre2=-0.5)
        want = direct_records(pipe, items, 16, (hb, wb))
        want_q = direct_records(pipe_q, items, 16, (hb, wb))
        body = Body(bp, config=PoseConfig(thre1=thre1, thre2=-0.5),
                    device="cuda")
        hand = Hand(hp, config=HandConfig(), device="cuda")
        pose = ISLSignPos(body, hand)
        with uncounted():
            want_x = {i: pose(f) for i, f in items[:8]}
        set_counts({k: 0 for k in kernel_counts()})
        checked = {"nms": 0, "convs": 0, "quantizes": 0}

        def fused(root, p, video="clip0", src=frames):
            return E._extract_batched(cfg_for(root), p, enumerate(src),
                                      (hb, wb), video, 16)

        a = os.path.join(tmp, "a")
        with watched_nms() as nms:
            rows = leg("fused_bf16", lambda: fused(a, pipe), 48)
        checked["nms"] += nms["calls"]
        res["legs"]["fused_bf16"].update(same_as_direct(a, "clip0", rows,
                                                        want))
        aq = os.path.join(tmp, "a_int8")
        with watched_nms() as nms, watched_convs() as convs:
            rows = leg("fused_int8", lambda: fused(aq, pipe_q), 48)
        checked["nms"] += nms["calls"]
        checked["convs"] += convs["convs"]
        checked["quantizes"] += convs["quantizes"]
        res["legs"]["fused_int8"].update(same_as_direct(aq, "clip0", rows,
                                                        want_q))
        unwatched = kernel_counts()
        for name, p, root in (("fused_bf16", pipe, a),
                              ("fused_int8", pipe_q, aq)):
            again = root + "_unwatched"
            leg(name + "_unwatched", lambda: fused(again, p), 48)
            for i in range(48):
                f = f"clip0/{i:06d}.json"
                with open(os.path.join(root, f)) as x, \
                        open(os.path.join(again, f)) as y:
                    if x.read() != y.read():
                        raise SystemExit(f"extraction: the unwatched "
                                         f"{name} run wrote another {f}")
        unwatched = delta(unwatched)
        res["host"] = extraction_host_split(pipe, pipe_q, items, frames,
                                            cfg_for(tmp), hb, wb)

        # (b) resume: delete a third of (a)'s records, extract again
        gone = list(range(0, 48, 3))
        before = {}
        for i in range(48):
            path = os.path.join(a, "clip0", f"{i:06d}.json")
            with open(path) as f:
                before[i] = f.read()
            if i in gone:
                os.remove(path)
            else:
                os.utime(path, ns=(1, 1))
        with watched_nms() as nms:
            rows = leg("resume", lambda: fused(a, pipe), len(gone))
        checked["nms"] += nms["calls"]
        if sorted(r["frame"] for r in rows) != gone:
            raise SystemExit(f"extraction: the resume extracted "
                             f"{sorted(r['frame'] for r in rows)}, want "
                             f"{gone}")
        for i in range(48):
            path = os.path.join(a, "clip0", f"{i:06d}.json")
            with open(path) as f:
                if f.read() != before[i]:
                    raise SystemExit(f"extraction: resumed record {i} "
                                     f"differs")
            if (os.stat(path).st_mtime_ns == 1) == (i in gone):
                raise SystemExit(f"extraction: the resume wrote record {i}"
                                 if i not in gone else
                                 f"extraction: the resume left record {i}")

        # (c) two shards over four videos of 12 frames
        videos = [(f"clip{v + 1}", frames[12 * v:12 * v + 12])
                  for v in range(4)]
        c = os.path.join(tmp, "c")
        shards = {}
        with watched_nms() as nms:
            def run_shards():
                for shard in (0, 1):
                    rows = []
                    for vid, src in E.shard_rows(videos, shard, 2):
                        out = fused(c, pipe, vid, src)
                        for r in out:
                            r.update({"expression": "Hello"})
                        rows += out
                        shards.setdefault(shard, []).append((vid, out))
                    E._write_csv(os.path.join(
                        c, f"features-shard{shard}.csv"), rows)
            leg("shards", run_shards, 48)
        checked["nms"] += nms["calls"]
        shard_tot = {"records": 0, "people": 0, "hands": 0}
        for shard, vids in shards.items():
            for vid, out in vids:
                ref = direct_records(pipe, augmented(vid, dict(videos)[vid]),
                                     16, (hb, wb))
                got = same_as_direct(c, vid, out, ref)
                for k in shard_tot:
                    shard_tot[k] += got[k]
        if [v for v, _ in videos[0::2]] != [v for v, _ in shards[0]]:
            raise SystemExit("extraction: shard 0 took other videos")
        res["legs"]["shards"].update(shard_tot)

        # (d) the exact per-frame path over 8 frames
        d = os.path.join(tmp, "d")
        with watched_parity() as par:
            rows = leg("exact", lambda: E._extract_frames(
                cfg_for(d), pose, enumerate(frames[:8]), "clip0"), 8)
        checked.update(par)
        people = hands = 0
        for row in rows:
            i = row["frame"]
            cand, subset, hs = want_x[i]
            rec = json.dumps({"candidate": cand.tolist(),
                              "subset": subset.tolist(),
                              "all_hand_peaks": [h.tolist() for h in hs]})
            with open(os.path.join(d, "clip0", f"{i:06d}.json")) as f:
                if f.read() != rec:
                    raise SystemExit(f"extraction: exact record {i} "
                                     f"differs from a direct ISLSignPos "
                                     f"call's")
            people += len(subset)
            hands += len(hs)
        res["legs"]["exact"].update({"records": len(rows), "people": people,
                                     "hands": hands})
        shutil.copytree(os.path.join(a, "clip0"),
                        os.path.join(records_to, "clip0"))
        for vid, _ in videos:
            shutil.copytree(os.path.join(c, vid),
                            os.path.join(records_to, vid))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = kernel_counts()
    res["launches"] = launches
    res["checked"] = checked
    zero = [k for k, v in launches.items() if v <= 0]
    if zero:
        raise SystemExit(f"extraction: {zero} never launched: {launches}")
    for name in ("fused_bf16", "fused_int8", "shards", "exact"):
        if not (res["legs"][name]["people"] and res["legs"][name]["hands"]):
            raise SystemExit(f"extraction: leg {name} formed no people or "
                             f"no hands: {res['legs'][name]}")
    res["unwatched_launches"] = unwatched
    for key, name in (("nms", "nms_mask_rows"), ("convs", "conv_q"),
                      ("quantizes", "quantize"),
                      ("nms_first_k", "nms_first_k"),
                      ("paf_sample", "paf_sample"),
                      ("label_components", "label_components")):
        if checked[key] != launches[name] - unwatched[name]:
            raise SystemExit(f"extraction: {checked[key]} {name} calls "
                             f"checked of {launches[name]} launched "
                             f"({unwatched[name]} in the unwatched runs)")
    log("  extraction legs (frames/s; checked legs hold every kernel call "
        "against its plain version inside the run): " + ", ".join(
            f"{k} {v['frames_per_s']:.1f}" for k, v in res["legs"].items()))
    log(f"  extraction: {card_line()}; launches {launches}; checked "
        f"{checked}; host split {res['host']}")
    return res


# Phase 5d: training. Sizes are the CLIs' defaults: the head at batch 32
# (islx_torch.cli.train), the CPMs at --size 184 and --batch 8
# (islx_torch.cli.pose_train).
HEAD_LABELS = ("Hello", "Bank", "Book", "Money", "House", "Friend", "Pen",
               "Night")


def head_windows(records: str, work: str, seed: int = 0):
    """Training windows from phase 5c's records: every run of up to 20
    consecutive records of each extracted video becomes a video of its own
    (96 of them), labelled with a seeded expression a video; then
    isl/dataset.build_windows. -> (x, y, labels)."""
    from islx_torch.isl import dataset as D

    rng = np.random.RandomState(seed)
    labels = {}
    for vid in sorted(os.listdir(records)):
        files = sorted(f for f in os.listdir(os.path.join(records, vid))
                       if f.endswith(".json"))
        for s in range(len(files)):
            name = f"{vid}_{s:02d}"
            os.makedirs(os.path.join(work, name))
            for j, f in enumerate(files[s:s + 20]):
                shutil.copy(os.path.join(records, vid, f),
                            os.path.join(work, name, f"{j:06d}.json"))
            labels[name] = HEAD_LABELS[rng.randint(len(HEAD_LABELS))]
    x, y = D.build_windows(work, labels)
    return x, y, labels


def grads_of(module) -> dict:
    return {n: p.grad.detach().float().cpu().numpy()
            for n, p in module.named_parameters()}


def grads_close(got: dict, want: dict, f32: bool) -> dict:
    """The card's CPM gradient against the CPU's, as one vector: f32
    within 1e-2 in norm and cosine >= 0.9999; bf16 within 0.2 and cosine
    >= 0.98. A gradient through ReLUs and max-pools is not continuous: an
    f32 rounding apart flips a unit near zero or a near-tie in a pool
    window, and one tensor's largest error can be 1.5e-2 of its largest
    magnitude (the CPU's own f32 gradient is up to 1e-2 from its f64 one
    in a tensor, 3-4e-4 in norm); bf16 rounding alone moves a gradient
    0.04-0.15 at the CPU tests' sizes (tests/test_torch_pose_train.py).
    -> the measured errors."""
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    nrel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    worst = max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(),
                                                      1e-30))
                for k, w in want.items())
    ok = (nrel <= 1e-2 and cos >= 0.9999) if f32 else \
        (nrel <= 0.2 and cos >= 0.98)
    if not ok:
        raise SystemExit(f"training: {'f32' if f32 else 'bf16'} card "
                         f"gradient {nrel:.3g} in norm from the CPU's "
                         f"(cos {cos:.6f})")
    return {"norm_rel_err": nrel, "cos": cos, "max_rel_err": worst}


def device_ms_per_step(step, reps: int = 2) -> dict:
    """``reps`` calls of ``step`` under torch.profiler: the device ms of a
    step (its kernels and copies) and its device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in ops) / 1e3 / reps
    if device_ms <= 0:
        raise SystemExit("training profile: the trace holds no device time")
    return {"device_ms": device_ms, "device_ops": len(ops) / reps}


def head_training(records: str, work: str) -> dict:
    """The translator head, default TranslatorConfig (dropout 0.2), on the
    card: fit for 4 epochs at batch 32 interrupted after one epoch and
    resumed (bit-equal to an uninterrupted run, which is timed); the head
    saved as .npz and in a bundle and loaded back through cli/translate's
    loaders (the same probabilities as the head in memory); one batch's
    loss and gradients at dropout 0 on the card against the CPU."""
    from islx_torch.cli import translate as translate_cli
    from islx_torch.core import checkpoint as ckpt
    from islx_torch.core import weights as W
    from islx_torch.core.config import TranslatorConfig
    from islx_torch.isl import train as TR
    from islx_torch.models import translator as T

    x, y, labels = head_windows(records, os.path.join(work, "windows"))
    if x.shape[0] < 64:
        raise SystemExit(f"training: {x.shape[0]} windows from the records")
    kw = dict(epochs=4, batch_size=32, lr=1e-3, cfg=TranslatorConfig(),
              seed=0, verbose=False, device="cuda")
    ck = os.path.join(work, "ck")
    TR.fit(x, y, **{**kw, "epochs": 1}, checkpoint_dir=ck)   # interrupted
    resumed = TR.fit(x, y, **kw, checkpoint_dir=ck)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TR.fit(x, y, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    diff = [f"{n}/{k}" for n in params for k in params[n]
            if not np.array_equal(params[n][k], resumed[n][k])]
    if diff:
        raise SystemExit(f"training: the resumed head differs from the "
                         f"uninterrupted one at {diff}")
    steps = kw["epochs"] * (x.shape[0] // 32)

    npz = os.path.join(work, "head.npz")
    T.save_npz(npz, params)
    bp, hp = W.init_params("body25", 0), W.init_params("hand", 1)
    ckpt.save_bundle(os.path.join(work, "bundle"), bp, hp, params)
    xs = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        want = T.build_head(params, "cuda")(xs)
        from_npz = T.build_head(translate_cli.load_head(npz), "cuda")(xs)
        b_body, b_hand, b_head, _ = ckpt.load_bundle(
            os.path.join(work, "bundle"))
        from_bundle = T.build_head(b_head, "cuda")(xs)
    if not (torch.equal(from_npz, want) and torch.equal(from_bundle, want)):
        raise SystemExit("training: a reloaded head predicts otherwise")
    if not all(torch.equal(b_body[n][k], bp[n][k]) for n in bp
               for k in bp[n]):
        raise SystemExit("training: the bundle's body weights differ")

    # one batch at dropout 0, card against CPU
    cfg0 = TranslatorConfig(dropout=0.0)
    out = {}
    for dev in ("cuda", "cpu"):
        head = T.from_islx_params(params, dev, cfg0)
        loss, _ = TR.loss_fn(head, torch.from_numpy(x[:32]).to(dev),
                             torch.from_numpy(y[:32]).to(dev))
        loss.backward()
        out[dev] = (loss.item(), grads_of(head))
    if abs(out["cuda"][0] - out["cpu"][0]) > 1e-5 * abs(out["cpu"][0]):
        raise SystemExit(f"training: head loss {out['cuda'][0]} on the "
                         f"card, {out['cpu'][0]} on the CPU")
    worst = max(float(np.abs(out["cuda"][1][k] - g).max()
                      / max(np.abs(g).max(), 1e-30))
                for k, g in out["cpu"][1].items())
    if not worst <= 1e-4:
        raise SystemExit(f"training: head gradients {worst:.3g} of their "
                         f"largest magnitude from the CPU's")
    ms = 1e3 * dt / steps
    state = TR.init_state(kw["cfg"], 1e-3, params, device="cuda")
    step = TR.make_train_step(state)
    gen = torch.Generator(device="cuda").manual_seed(1)
    xb, yb = xs[:32], torch.from_numpy(y[:32].astype(np.int64)).cuda()
    step(xb, yb, gen)
    prof = device_ms_per_step(lambda: step(xb, yb, gen))
    return {"windows": int(x.shape[0]), "videos": len(labels),
            "classes": len(set(y.tolist())), "epochs": kw["epochs"],
            "batch": 32, "steps": steps, "ms_per_step": ms,
            "samples_per_s": 32 * steps / dt, "peak_mib": peak / 2 ** 20,
            **prof, "device_busy_share": prof["device_ms"] / ms,
            "resume_bit_equal": True, "reload_equal": True,
            "card_vs_cpu": {"loss": out["cuda"][0], "cpu_loss": out["cpu"][0],
                            "max_rel_err": worst}}


def pose_samples(root: str, model_type: str, n: int = 8, size: int = 184,
                 seed: int = 0) -> str:
    """n seeded u8 BGR samples of size x size (no resize, so no cv2) with
    two people's keypoints each, in the pose CLI's .npz format."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, model_type)
    os.makedirs(d)
    j = 21 if model_type == "hand" else 25
    for i in range(n):
        np.savez(os.path.join(d, f"s{i}.npz"),
                 image=(rng.rand(size, size, 3) * 255).astype(np.uint8),
                 keypoints=rng.rand(2, j, 2).astype(np.float32) * (size - 8)
                 + 4, visible=rng.rand(2, j) > 0.2)
    return d


def pose_run(model_type, dtype, x, heat_t, paf_t, steps=6) -> dict:
    """cli/pose_train._train_flat for ``steps`` steps on one fixed batch
    of 8 (one step an epoch): ms/step (median of the steps after the
    first), samples/s, peak memory, the loss falling."""
    import argparse

    from islx_torch.cli import pose_train as pose_cli
    from islx_torch.core import weights as W
    from islx_torch.models import pose_train as PT

    args = argparse.Namespace(model_type=model_type, epochs=steps, batch=8,
                              lr=1e-4, compute_dtype=dtype, seed=0,
                              device="cuda")
    losses, times = [], []
    last = [time.perf_counter()]

    def on_step(metrics):
        losses.append(float(metrics["loss"]))     # waits for the step
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last[0] = time.perf_counter()
    state = pose_cli._train_flat(W.init_params(model_type, 2), x, heat_t,
                                 paf_t, args, lambda s: None, on_step)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training: {model_type} {dtype} losses {losses} "
                         f"do not fall")
    if not all(torch.isfinite(v).all() for e in state.values()
               for v in e.values()):
        raise SystemExit(f"training: {model_type} {dtype} weights not "
                         f"finite")
    ms = 1e3 * statistics.median(times[1:])
    state = PT.init_state(model_type, params=W.init_params(model_type, 2),
                          device="cuda")
    step = PT.make_train_step(state, model_type, {
        "f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    xs = [torch.from_numpy(a[:8]).cuda() for a in (x, heat_t, paf_t)]
    step(*xs)
    prof = device_ms_per_step(lambda: step(*xs))
    return {"model": model_type, "dtype": dtype, "steps": steps,
            "batch": 8, "size": x.shape[1], "losses": losses,
            "first_step_ms": 1e3 * times[0], "ms_per_step": ms,
            "samples_per_s": 8e3 / ms, "peak_mib": peak / 2 ** 20,
            **prof, "device_busy_share": prof["device_ms"] / ms}


def pose_card_vs_cpu(model_type, x, heat_t, paf_t) -> dict:
    """The loss and its gradients of 2 samples' 64x64 corners (8x8 target
    cells: the same cells the full map holds there) on the card and the
    CPU, full width, f32 and bf16, from the same weights."""
    from islx_torch.core import weights as W
    from islx_torch.core.runtime import true_f32
    from islx_torch.models import pose_train as PT

    params = W.init_params(model_type, 2)
    sl = (slice(0, 2), slice(0, 64), slice(0, 64))
    tl = (slice(0, 2), slice(0, 8), slice(0, 8))
    res = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        out = {}
        for dev in ("cuda", "cpu"):
            state = PT.init_state(model_type, params=params, device=dev)
            step_in = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (x[sl], heat_t[tl], paf_t[tl])]
            with true_f32():
                loss, _ = PT.loss_fn(state.net, *step_in, model_type, dtype)
                loss.backward()
            out[dev] = (loss.item(), grads_of(state.net))
        # bf16: the CPU's bf16 loss here is 1.6e-3 from its f64 loss
        rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        if rel > (1e-4 if name == "f32" else 1e-2):
            raise SystemExit(f"training: {model_type} {name} loss "
                             f"{out['cuda'][0]} on the card, "
                             f"{out['cpu'][0]} on the CPU")
        res[name] = {"loss": out["cuda"][0], "cpu_loss": out["cpu"][0],
                     "loss_rel_err": rel,
                     **grads_close(out["cuda"][1], out["cpu"][1],
                                   name == "f32")}
    return res


def training(records: str) -> dict:
    """Phase 5d: the translator head on windows of phase 5c's records, and
    BODY_25 and the hand CPM through the pose CLI's _train_flat, full
    width, on the card. Training runs none of the port's kernels (no
    Pallas function has a backward in islx): their counts must not move.
    -> numbers by run."""
    from islx_torch.cli import pose_train as pose_cli
    from islx_torch.models import pose_train as PT

    before = kernel_counts()
    work = tempfile.mkdtemp(prefix="islx_train_")
    res = {"card": card_line()}
    try:
        res["head"] = head_training(records, work)
        res["pose"] = []
        res["card_vs_cpu"] = {}
        for mt in ("body25", "hand"):
            x, heat_t, paf_t = pose_cli.load_samples(
                pose_samples(work, mt), 184, mt)
            for dtype in ("f32", "bf16"):
                res["pose"].append(pose_run(mt, dtype, x, heat_t, paf_t))
            res["card_vs_cpu"][mt] = pose_card_vs_cpu(mt, x, heat_t, paf_t)
            if mt == "hand":
                # deep supervision with the positive weight, bf16
                state = PT.init_state("hand", params=None, seed=2,
                                      device="cuda")
                step = PT.make_train_step(state, "hand", torch.bfloat16,
                                          pos_weight=2.0,
                                          deep_supervision=True)
                xs = [torch.from_numpy(a).cuda() for a in (x, heat_t, paf_t)]
                losses = [float(step(*xs)["loss"]) for _ in range(4)]
                if not all(np.isfinite(losses)) or \
                        not losses[-1] < losses[0]:
                    raise SystemExit(f"training: deep-supervised hand "
                                     f"losses {losses} do not fall")
                res["hand_deep_supervision"] = {"pos_weight": 2.0,
                                                "dtype": "bf16",
                                                "losses": losses}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    moved = {k: v for k, v in delta(before).items() if v}
    if moved:
        raise SystemExit(f"training: launched the port's kernels {moved}")
    h = res["head"]
    log(f"  head: {h['windows']} windows, {h['steps']} steps at batch 32: "
        f"{h['ms_per_step']:.2f} ms/step, {h['samples_per_s']:.0f} "
        f"samples/s, peak {h['peak_mib']:.0f} MiB, device "
        f"{h['device_ms']:.2f} ms/step in {h['device_ops']:.0f} "
        f"operations; resume bit-equal, "
        f"reloads equal; card == CPU (grad {h['card_vs_cpu']['max_rel_err']:.2g})"
        f"  [{res['card']}]")
    for r in res["pose"]:
        log(f"  {r['model']} {r['dtype']} {r['size']}x{r['size']} batch 8: "
            f"{r['ms_per_step']:.1f} ms/step, {r['samples_per_s']:.1f} "
            f"samples/s, peak {r['peak_mib']:.0f} MiB, device "
            f"{r['device_ms']:.1f} ms/step in {r['device_ops']:.0f} "
            f"operations, loss "
            f"{r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}  [{res['card']}]")
    log(f"  card vs CPU: {json.dumps(res['card_vs_cpu'])}; deep-supervised "
        f"hand losses {res['hand_deep_supervision']['losses']}")
    return res


# ---------------------------------------------------------------------------
# Phase 6b: the single-image path (ImagePose) and the split batched
# pipelines, at full width.
# ---------------------------------------------------------------------------

SI_BUCKET = (184, 328)          # the bucket of a 720x1280 frame
ALL_KERNELS = tuple(name for name, _ in KERNELS)


def si_weights():
    """Seeded full-width BODY_25, COCO and hand states, the arm joints'
    final heat bias raised by 1 (parity_weights' rule) so arms chain and
    hand boxes form."""
    from islx_torch.core import weights as W

    bp, hp = parity_weights()
    cp = W.init_params("coco", 2)
    cb = cp["Mconv7_stage6_L2"]["b"].clone()
    cb[2:8] += 1.0
    cp["Mconv7_stage6_L2"]["b"] = cb
    return bp, cp, hp


def heat_quantile(pipe, frames, njoint, q) -> float:
    """The q quantile of the joint heatmaps a body pipeline's net gives
    ``frames`` [n,H,W,3] u8."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(pipe.device)
    with torch.inference_mode():
        heat = pipe.net(x.float() / 256.0 - 0.5, pipe.compute_dtype)[1]
    return float(torch.quantile(heat[..., :njoint - 1].float().reshape(-1),
                                q))


def same_pose(got, want) -> bool:
    """(candidate, subset, hands) equal word for word."""
    (c, s, h), (jc, js, jh) = got, want
    return (np.array_equal(c, jc) and np.array_equal(s, js)
            and len(h) == len(jh)
            and all(np.array_equal(a, b) for a, b in zip(h, jh)))


def close_pose(got, want, tol=1e-4) -> bool:
    """(candidate, subset[, hands]) with equal integers and scores within
    ``tol`` (card against CPU: the f32 CPMs sum in another order)."""
    c, s, jc, js = got[0], got[1], want[0], want[1]
    if not (c.shape == jc.shape and s.shape == js.shape
            and np.array_equal(c[:, [0, 1, 3]], jc[:, [0, 1, 3]])
            and np.array_equal(s[:, :-2], js[:, :-2])
            and np.array_equal(s[:, -1], js[:, -1])
            and np.abs(c[:, 2] - jc[:, 2]).max(initial=0.0) <= tol
            and np.abs(s[:, -2] - js[:, -2]).max(initial=0.0) <= tol):
        return False
    if len(got) > 2:
        return (len(got[2]) == len(want[2])
                and all(np.array_equal(a, b) for a, b in zip(got[2],
                                                             want[2])))
    return True


def describe_apart(a, b) -> str:
    """Where two tables first differ (for a failure's message)."""
    if a.shape != b.shape:
        n = min(len(a), len(b))
        a, b = a[:n], b[:n]
    bad = np.nonzero(~np.isclose(a, b, rtol=0, atol=1e-4).all(-1))[0]
    if not len(bad):
        return "none in the common rows"
    i = int(bad[0])
    return f"row {i}: {a[i].tolist()} vs {b[i].tolist()}"


def body_of(pose):
    """An ImagePose's body pipeline (its fused pipeline's, fused)."""
    return pose.pipe.body if pose.fused else pose.body


def direct_pose(pose, frame):
    """The result ImagePose must give for a bucket-sized ``frame``: a
    direct FusedPosePipeline step, or a BatchedBodyPipeline step ->
    detect_hand_boxes -> BatchedHandPipeline.from_frames."""
    from islx_torch.pipeline.batch_pose import detect_hand_boxes

    hb, wb = frame.shape[:2]
    if pose.fused:
        pipe = pose.pipe
        results, boxes, peaks = pipe.assemble(
            pipe.device_step(frame[None], (hb, wb)), 1)
        return results[0] + (pipe.hands_for_frame(boxes, peaks, 0),), boxes
    flat = pose.body.upload_frames(frame[None])
    results = pose.body.assemble(
        pose.body.device_step_flat(flat, 1, hb, wb), 1)
    boxes = detect_hand_boxes(results, hb, wb, (hb, wb), pose.max_hands)
    hands = []
    if (boxes[:, 3] > 0).any():
        peaks = pose.hand.from_frames(flat, 1, hb, wb, boxes)
        hands = [peaks[j].astype(np.int64) for j in range(len(boxes))
                 if boxes[j, 3] > 0]
    return results[0] + (hands,), boxes


def image_leg(pose, frames, name) -> dict:
    """ImagePose over ``frames``: every NMS mask launch held bit for bit
    against its plain version, each result equal to a direct step's
    (direct_pose), then ms per call (the median over the frames, each
    call ending on the host)."""
    with watched_nms() as nms:
        outs = [pose(f) for f in frames]
    all_boxes = []
    with uncounted():
        for i, f in enumerate(frames):
            want, boxes = direct_pose(pose, f)
            if not same_pose(outs[i], want):
                raise SystemExit(f"single image ({name}): frame {i} differs "
                                 f"from a direct step's result")
            all_boxes.append(np.c_[np.full(len(boxes), i), boxes[:, 1:]]
                             if len(boxes) else boxes)
    both = [i for i, (_, s, h) in enumerate(outs) if len(s) and len(h)]
    if not both:
        raise SystemExit(f"single image ({name}): no frame has a person "
                         f"and a hand")
    times = []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose(f)
        times.append((time.perf_counter() - t0) * 1e3)
    res = {"frames": len(frames), "nms_checked": nms["calls"],
           "people": sum(len(s) for _, s, _ in outs),
           "hands": sum(len(h) for _, _, h in outs),
           "frames_with_person_and_hand": both,
           "ms_per_call": statistics.median(times),
           "ms_per_call_range": [min(times), max(times)]}
    log(f"  ImagePose {name}: {res['people']} people, {res['hands']} hands "
        f"over {len(frames)} frames (== direct steps; {nms['calls']} NMS "
        f"mask launches bit-equal); {res['ms_per_call']:.2f} ms/call "
        f"(median; {min(times):.2f}-{max(times):.2f})")
    return res, np.concatenate(all_boxes)


def split_crops_match_cpu(frames, boxes, size) -> int:
    """The split path's crops (the host's boxes over the frames) cut on
    the card, word-equal to the CPU function's -> crops compared."""
    from islx_torch.ops.resize import dynamic_crop_resize_batch

    use = boxes[boxes[:, 3] > 0].astype(np.int32)
    if not len(use):
        raise SystemExit("single image (split): no hand box to crop")
    args = [torch.from_numpy(np.ascontiguousarray(use[:, i]))
            for i in range(4)]
    f = torch.from_numpy(np.ascontiguousarray(frames))
    got = dynamic_crop_resize_batch(f.cuda(), *(a.cuda() for a in args),
                                    size).cpu()
    want = dynamic_crop_resize_batch(f, *args, size)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise SystemExit(f"single image (split): {int((got != want).sum())} "
                         f"crop words differ from the CPU's")
    return len(use)


def capture_net(net, store):
    """``net`` wrapped to keep each call's outputs by input (H, W)."""
    def call(x, cd, *a):
        out = net(x, cd, *a)
        store[tuple(x.shape[1:3])] = out
        return out
    return call


def exact_leg(bp, frames, thre1) -> dict:
    """The exact-parity construction (paf_mode="exact",
    two_stage_peaks=False, boxsize 2*hb: the net sees the frame) in f32 on
    the frames: nms_first_k over the batch and paf_sample a frame, each
    launch bit-equal to its plain version; each frame's (candidate,
    subset) equal to the parity Body's on the net outputs of that frame
    (integers equal, scores within 1e-4: the batch upsamples its maps in
    one matmul, Body a frame at a time); ms per frame beside a parity Body
    call's (its own net)."""
    from islx_torch.core.config import PoseConfig
    from islx_torch.pipeline.batch_pose import BatchedBodyPipeline
    from islx_torch.pose.body import Body

    n, hb, wb = frames.shape[:3]
    cfg = PoseConfig(scale_search=(0.5,), boxsize=2 * hb, max_peaks=16,
                     thre1=thre1, thre2=-0.5)
    # top_m = K*K: the compaction keeps every pair, as the parity Body's
    # grouping reads them all (islx's default 48 drops pairs past the 48th
    # best, which the greedy grouping can reach at thre2 -0.5)
    pipe = BatchedBodyPipeline(bp, cfg=cfg, compute_dtype=torch.float32,
                               top_m=cfg.max_peaks ** 2, paf_mode="exact",
                               two_stage_peaks=False)
    if pipe.pack_mode != "bits" or pipe.fused_peaks:
        raise SystemExit("exact construction: not islx's bits/unfused one")
    outs = {}
    net = pipe.net
    pipe.net = capture_net(net, outs)
    with watched_parity("exact construction") as par:
        packed = pipe.device_step(frames)
    pipe.net = net
    results = pipe.assemble(packed, n)
    paf8, heat8 = outs[(hb, wb)]
    with uncounted():
        for i in range(n):
            body = Body(bp, config=cfg, compute_dtype=torch.float32,
                        forward_fn=lambda w, x, cd, i=i: (paf8[i:i + 1],
                                                          heat8[i:i + 1]))
            want = body(frames[i])
            if not close_pose(results[i], want):
                (c, s), (jc, js) = results[i], want
                raise SystemExit(
                    f"exact construction: frame {i} differs from the parity "
                    f"Body's: candidates {c.shape} {jc.shape}, people "
                    f"{s.shape} {js.shape}, first rows apart "
                    f"{describe_apart(c, jc)} / {describe_apart(s, js)}")
    if par["nms_first_k"] != 1 or par["paf_sample"] != n:
        raise SystemExit(f"exact construction: kernel calls {par}")
    ms = host_ms(lambda: pipe.assemble(pipe.device_step(frames), n))
    body = Body(bp, config=cfg, compute_dtype=torch.float32)
    body_ms = host_ms(lambda: body(frames[0]))
    res = {"frames": n, "bucket": [hb, wb], "checked": dict(par),
           "people": sum(len(s) for _, s in results),
           "candidates": sum(len(c) for c, _ in results),
           "ms_per_frame": ms / n, "parity_body_ms": body_ms}
    log(f"  exact construction: {res['candidates']} candidates, "
        f"{res['people']} people over {n} frames == the parity Body's; "
        f"launches checked {dict(par)}; {ms / n:.2f} ms/frame against "
        f"{body_ms:.2f} ms for a parity Body call")
    return res


def multi_body_leg(bp, frames, thre1) -> dict:
    """The body scale pyramid (0.5, 1.0) over the frames, bf16, each NMS
    mask launch held bit-equal."""
    from islx_torch.core.config import PoseConfig
    from islx_torch.pipeline.batch_pose import BatchedBodyPipeline

    n = len(frames)
    pipe = BatchedBodyPipeline(bp, cfg=PoseConfig(
        scale_search=(0.5, 1.0), max_peaks=16, thre1=thre1, thre2=-0.5))
    with watched_nms() as nms:
        results = pipe.assemble(pipe.device_step(frames), n)
    if nms["calls"] != 1:
        raise SystemExit(f"multi-scale body: {nms['calls']} NMS calls")
    if not all(np.isfinite(c).all() for c, _ in results):
        raise SystemExit("multi-scale body: candidates not finite")
    ms = host_ms(lambda: pipe.assemble(pipe.device_step(frames), n))
    res = {"frames": n, "scales": [0.5, 1.0], "nms_checked": nms["calls"],
           "candidates": sum(len(c) for c, _ in results),
           "people": sum(len(s) for _, s in results), "ms_per_batch": ms}
    log(f"  multi-scale body (0.5, 1.0), B={n}: {res['candidates']} "
        f"candidates, {res['people']} people, NMS mask bit-equal; "
        f"{ms:.1f} ms/batch")
    return res


def multi_hand_leg(hp, crops) -> dict:
    """The multi-scale BatchedHandPipeline (scales 0.5-2.0) over ``crops``
    [N,368,368,3], bf16: peak mode cc (cc_label over the N crops' planes,
    each launch bit-equal; every crop's peaks equal to the parity Hand's
    on the same net outputs) and fast; ms per batch; the labelling of the
    N*21 planes in one call against N calls of 21."""
    from islx_torch.core.config import HandConfig
    from islx_torch.ops.blur import gaussian_blur
    from islx_torch.ops.cc_label import label_components
    from islx_torch.ops.resize import resize_cubic
    from islx_torch.pipeline.batch_pose import BatchedHandPipeline
    from islx_torch.pose.hand import Hand

    n, s0 = crops.shape[0], crops.shape[1]
    cfg = HandConfig()
    pipe = BatchedHandPipeline(hp, cfg, crop_size=s0, peak_mode="cc")
    outs = {}
    net = pipe.net
    pipe.net = capture_net(net, outs)
    with watched_parity("multi-scale hand") as par:
        peaks = pipe(crops)
    pipe.net = net
    if par["label_components"] < 1:
        raise SystemExit("multi-scale hand: cc_label did not run")
    with uncounted():
        for i in range(n):
            hand = Hand(hp, config=cfg, forward_fn=lambda w, x, cd, i=i:
                        outs[tuple(x.shape[1:3])][i:i + 1])
            want = hand(crops[i])
            if not np.array_equal(peaks[i], want):
                raise SystemExit(f"multi-scale hand: crop {i}'s peaks "
                                 f"differ from the parity Hand's")
    found = int((peaks != 0).any(-1).sum())
    res = {"crops": n, "size": s0, "scales": list(cfg.scale_search),
           "cc_checked": par["label_components"], "parts_found": found,
           "cc_ms_per_batch": host_ms(lambda: pipe(crops))}
    pipe.peak_mode = "fast"
    fast = pipe(crops)
    res["fast_ms_per_batch"] = host_ms(lambda: pipe(crops))
    res["fast_parts_equal_cc"] = int((fast == peaks).all(-1).sum())
    # the labelling alone: the N crops' planes in one call, or a call a crop
    with uncounted(), torch.inference_mode():
        x = torch.from_numpy(crops).cuda()
        heat = None
        for s in cfg.scale_search:
            m = resize_cubic(pipe.run_scale(x, s), s0, s0)
            heat = m if heat is None else heat + m
        binary = gaussian_blur(heat[..., :21] / len(cfg.scale_search),
                               3.0) > cfg.thre
        stacked = binary.permute(1, 2, 0, 3).reshape(s0, s0, -1).contiguous()
        per = [binary[i].contiguous() for i in range(n)]
        res["cc_stacked_ms"] = cuda_ms(lambda: label_components(stacked),
                                       reps=10, warmup=2)
        res["cc_per_crop_ms"] = cuda_ms(
            lambda: [label_components(b) for b in per], reps=10, warmup=2)
    log(f"  multi-scale hand, {n} crops of {s0} px, scales 0.5-2.0: cc "
        f"{res['cc_ms_per_batch']:.1f} ms/batch ({found} parts found, == "
        f"the parity Hand's crop by crop, {par['label_components']} "
        f"labelling calls bit-equal), fast {res['fast_ms_per_batch']:.1f} "
        f"ms/batch; labelling {n}x21 planes in one call "
        f"{res['cc_stacked_ms']:.3f} ms, {n} calls of 21 "
        f"{res['cc_per_crop_ms']:.3f} ms")
    return res


def body_standalone_leg(hand_cfg, b=192, orig_hw=(512, 384)) -> dict:
    """BatchedBodyPipeline alone, islx's default construction, at B=192 in
    the 184x144 bucket on phase 4's frames and weights (the I420 batch
    decoded on the card, so both read the same BGR frames): its integer
    planes word-equal to the body half of phase 4's fused step; frames/s."""
    from islx_torch.core import weights as W
    from islx_torch.core.config import PoseConfig
    from islx_torch.ops.yuv import yuv420_to_bgr
    from islx_torch.pipeline.batch_pose import (BatchedBodyPipeline,
                                                FusedPosePipeline, bucket_for)

    hb, wb = bucket_for(*orig_hw)
    host = seeded_i420(np.random.RandomState(0), b, hb, wb)
    with uncounted():
        ref = FusedPosePipeline(W.init_params("body25", 0),
                                W.init_params("hand", 1), hand_cfg=hand_cfg)
        yuv = ref.upload_frames(host)
        thre1 = calibrate_thre1(ref, yuv, b, hb, wb, orig_hw)
        bgr = yuv420_to_bgr(yuv, b, hb, wb).to(torch.uint8).reshape(-1)
        want = ref.device_step_flat(bgr, b, hb, wb, orig_hw, thre1).cpu()
        want = ref.body.unpack(ref.unpack(want.numpy(), b)[0], b)
        del ref
    pipe = BatchedBodyPipeline(W.init_params("body25", 0),
                               cfg=PoseConfig(max_peaks=16))
    got = pipe.unpack(pipe.device_step_flat(bgr, b, hb, wb, thre1), b)
    for name, i in (("xy", 0), ("count", 2), ("pair", 3), ("ok", 5)):
        if not np.array_equal(got[i], want[i]):
            raise SystemExit(f"standalone body: {name} differs from the "
                             f"fused step's body half")
    ms = cuda_ms(lambda: pipe.device_step_flat(bgr, b, hb, wb, thre1).cpu(),
                 reps=3, warmup=1)
    res = {"batch": b, "bucket": [hb, wb], "thre1": thre1,
           "peaks": int(got[2].sum()), "ms_per_step": ms,
           "frames_per_s": b / (ms * 1e-3)}
    log(f"  standalone body B={b} {hb}x{wb}: planes == the fused step's body "
        f"half ({res['peaks']} peaks); {ms:.1f} ms/step, "
        f"{res['frames_per_s']:.1f} frames/s")
    return res


def small_cpu_checks(bp, cp, hp) -> dict:
    """The split ImagePose, the exact construction and the body pyramid,
    BODY_25 and COCO, f32, on small frames: the card == the plain CPU path
    (integers equal; scores within 1e-4 in the exact construction's bits
    buffer, within 1e-2 where bits16 rounds them to f16, as phase 4's
    small check)."""
    from islx_torch.core.config import HandConfig, PoseConfig
    from islx_torch.pipeline.batch_pose import BatchedBodyPipeline
    from islx_torch.pipeline.image import ImagePose

    rng = np.random.RandomState(17)
    frame = seeded_frame(rng, 184, 96)
    small = np.stack([seeded_frame(rng, 48, 64) for _ in range(2)])
    hcfg = HandConfig(scale_search=(0.25,))
    out = {}
    for mt, p in (("body25", bp), ("coco", cp)):
        nj = PoseConfig(model_type=mt).njoint
        res = {}
        for leg in ("split", "exact", "multi"):
            got = {}
            for dev in ("cpu", "cuda"):
                if leg == "split":
                    pose = ImagePose(p, hp, mt, compute_dtype=torch.float32,
                                     hand_cfg=hcfg, device=dev)
                    body = pose.body
                    if dev == "cpu":
                        t1 = heat_quantile(body, frame[None], nj, 0.6)
                    body.cfg = dataclasses.replace(body.cfg, max_peaks=8,
                                                   thre1=t1, thre2=-0.5)
                    got[dev] = [pose(frame)]
                    continue
                cfg = (dict(scale_search=(0.5,), boxsize=96,
                            paf_mode="exact") if leg == "exact"
                       else dict(scale_search=(0.5, 1.0), boxsize=96,
                                 paf_mode="cell8"))
                mode = cfg.pop("paf_mode")
                pipe = BatchedBodyPipeline(
                    p, mt, PoseConfig(model_type=mt, max_peaks=8, thre2=-0.5,
                                      **cfg),
                    compute_dtype=torch.float32, paf_mode=mode,
                    two_stage_peaks=leg != "exact", device=dev)
                if dev == "cpu":
                    t2 = heat_quantile(pipe, small, nj, 0.8)
                got[dev] = pipe.assemble(pipe.device_step(small, t2), 2)
            # scores: within f16 roundings where the buffer packs f16 (the
            # split and pyramid legs' bits16), within 1e-4 in exact's bits
            tol = 1e-4 if leg == "exact" else 1e-2
            for a, w in zip(got["cuda"], got["cpu"]):
                if not close_pose(a, w, tol):
                    hands = ([np.abs(x - y).max() for x, y in zip(a[2], w[2])]
                             if len(a) > 2 and len(a[2]) == len(w[2])
                             else "count differs" if len(a) > 2 else "-")
                    raise SystemExit(
                        f"small check ({mt}, {leg}): the card differs from "
                        f"the CPU path: candidates {a[0].shape} "
                        f"{w[0].shape} {describe_apart(a[0], w[0])}; "
                        f"people {a[1].shape} {w[1].shape} "
                        f"{describe_apart(a[1], w[1])}; hands {hands}")
            res[leg] = sum(len(r[0]) for r in got["cpu"])
        out[mt] = res
    log(f"  small f32 card vs CPU (split ImagePose 184x96, exact and "
        f"pyramid 2x48x64): candidates {out}")
    return out


def single_image(hand_cfg) -> dict:
    """Phase 6b (module doc)."""
    from islx_torch.pipeline.image import ImagePose

    t_phase = time.perf_counter()
    hb, wb = SI_BUCKET
    bp, cp, hp = si_weights()
    frames = bgr_frames(np.random.RandomState(13), 8, hb, wb)
    fused = ImagePose(bp, hp, fused=True, hand_cfg=hand_cfg)
    start = heat_quantile(fused.pipe.body, frames, 26, 0.99)
    with uncounted():
        thre1 = calibrate_people(fused.pipe, frames, start, "single image",
                                 tries=24)
    pose_cfg = fused.pipe.body.cfg
    split = ImagePose(bp, hp, hand_cfg=hand_cfg)
    split.body.cfg = pose_cfg
    with uncounted():                                     # warm-up
        fused(frames[0])
        split(frames[0])
    set_counts(dict.fromkeys(ALL_KERNELS, 0))   # the path's run starts here
    res = {"bucket": [hb, wb], "thre1": thre1, "hand": hand_cfg.stages}
    res["fused"], _ = image_leg(fused, frames, "fused bf16")
    res["split"], boxes = image_leg(split, frames, "split bf16")
    size = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    res["split"]["crops_word_equal_cpu"] = split_crops_match_cpu(
        frames, boxes, size)

    with uncounted():
        qb, qh = quantize_on(bp, hp, list(frames), hand_cfg, "cuda")
    for name, fused_mode in (("fused_int8", True), ("split_int8", False)):
        pose = ImagePose(qb, qh, fused=fused_mode, hand_cfg=hand_cfg)
        body_of(pose).cfg = pose_cfg
        pose(frames[0])                                   # warm-up
        with watched_convs(chunk=8) as seen:      # a frame with hands
            pose(frames[res["split"]["frames_with_person_and_hand"][0]])
        times = []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose(f)
            times.append((time.perf_counter() - t0) * 1e3)
        res[name] = {"convs_checked": seen["convs"],
                     "quantizes_checked": seen["quantizes"],
                     "conv_shapes": len(seen["shapes"]),
                     "ms_per_call": statistics.median(times),
                     "ms_per_call_range": [min(times), max(times)]}
        log(f"  ImagePose {name}: one call's {seen['convs']} conv_q and "
            f"{seen['quantizes']} quantize calls word-equal to their plain "
            f"versions; {res[name]['ms_per_call']:.2f} ms/call")
        del pose

    res["body_standalone"] = body_standalone_leg(hand_cfg)
    res["multi_body"] = multi_body_leg(bp, frames[:4], thre1)
    res["multi_hand"] = multi_hand_leg(
        hp, bgr_frames(np.random.RandomState(14), 8, 368, 368))

    coco = ImagePose(cp, hp, "coco", hand_cfg=hand_cfg)
    coco.body.cfg = dataclasses.replace(
        coco.body.cfg, thre2=-0.5,
        thre1=heat_quantile(coco.body, frames[:2], 19, 0.5))
    with watched_nms() as nms:
        cand, subset, hands = coco(frames[0])
    if not (np.isfinite(cand).all() and subset.shape[1:] == (20,)
            and nms["calls"] == 1):
        raise SystemExit("single image (coco): output out of range")
    res["coco"] = {"candidates": len(cand), "people": len(subset),
                   "hands": len(hands), "nms_checked": nms["calls"]}
    log(f"  ImagePose coco split: {len(cand)} candidates, {len(subset)} "
        f"people, {len(hands)} hands; NMS mask bit-equal")
    res["small_cpu"] = small_cpu_checks(bp, cp, hp)
    res["exact"] = exact_leg(bp, frames[:4], thre1)

    launches = kernel_counts()
    res["launches"] = launches
    if min(launches.values()) < 1:
        raise SystemExit(f"single image: a kernel of the path was not "
                         f"launched: {launches}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  launches in phase 6b: {launches}; {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 6c: .caffemodel weights, the quantize CLI's core, the Caffe API,
# served COCO and profiling.trace
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b7, v = v & 0x7F, v >> 7
        out.append(b7 | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _len_field(field: int, data: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(data)) + data


def caffe_blob(arr: np.ndarray) -> bytes:
    """A BlobProto: BlobShape dims (field 7, packed dim 1), packed f32
    data (field 5)."""
    arr = np.ascontiguousarray(arr, "<f4")
    dims = _len_field(1, b"".join(_varint(d) for d in arr.shape))
    return _len_field(7, dims) + _len_field(5, arr.tobytes())


def write_caffemodel(path: str, state) -> None:
    """A weight state as a .caffemodel (protobuf wire format, written
    here): a new-style ``layer`` (field 100) a conv with its weight and
    bias blobs, and a single-blob PReLU layer a PReLU conv."""
    from islx_torch.core import weights as W

    flat = W.to_flat_dict(state)
    with open(path, "wb") as f:
        f.write(_len_field(1, b"islx_torch"))
        for name, entry in state.items():
            f.write(_len_field(100, _len_field(1, name.encode())
                               + _len_field(2, b"Convolution")
                               + _len_field(7, caffe_blob(
                                   flat[f"{name}.weight"]))
                               + _len_field(7, caffe_blob(
                                   flat[f"{name}.bias"]))))
            if "p" in entry:
                pk = W._prelu_key(name)
                f.write(_len_field(100, _len_field(1, pk.encode())
                                   + _len_field(2, b"PReLU")
                                   + _len_field(7, caffe_blob(
                                       flat[f"{pk}.weight"]))))


def hand_prototxt(loss: bool = False) -> tuple:
    """The hand CPM as a Caffe prototxt, from the port's conv table (the
    trunk's convs and pools, stage 1, five stages over the concat of the
    previous heat and the trunk) -> (text, the output blob)."""
    from islx_torch.models import cpm

    spec = cpm.hand_spec()
    lines = ['name: "islx_hand"', 'input: "data"']

    def seq(layers, bottom, tag):
        pools = 0
        for layer in layers:
            if isinstance(layer, cpm.Pool):
                pools += 1
                top = f"pool{pools}_{tag}"
                lines.append(
                    f'layer {{ name: "{top}" type: "Pooling" bottom: '
                    f'"{bottom}" top: "{top}" pooling_param {{ pool: MAX '
                    f'kernel_size: {layer.k} stride: {layer.s} }} }}')
                bottom = top
                continue
            c = layer
            lines.append(
                f'layer {{ name: "{c.name}" type: "Convolution" bottom: '
                f'"{bottom}" top: "{c.name}" convolution_param {{ '
                f'num_output: {c.cout} kernel_size: {c.k} pad: {c.pad} }} }}')
            if c.act == "relu":
                lines.append(f'layer {{ name: "relu_{c.name}" type: "ReLU" '
                             f'bottom: "{c.name}" top: "{c.name}" }}')
            bottom = c.name
        return bottom

    trunk = seq(spec["trunk"], "data", "trunk")
    out = seq(spec["stage1"], trunk, "stage1")
    for i in range(2, 7):
        lines.append(f'layer {{ name: "concat_stage{i}" type: "Concat" '
                     f'bottom: "{out}" bottom: "{trunk}" top: '
                     f'"concat_stage{i}" }}')
        out = seq(spec["stages"][f"stage{i}"], f"concat_stage{i}",
                  f"stage{i}")
    if loss:
        lines.append(f'layer {{ name: "loss" type: "EuclideanLoss" bottom: '
                     f'"{out}" bottom: "label" top: "loss" }}')
    return "\n".join(lines) + "\n", out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def caffe_weights_leg(work: str, hand_cfg) -> tuple:
    """6c step 1: seeded full-width BODY_25 and hand states (parity_weights:
    the arm joints' heat raised) written as .caffemodel files, read with
    W.load (seconds a file, the states equal word for word), converted
    to .npz by cli/convert; the fused step at B=192 in 184x144 from I420
    (bf16, ``hand_cfg``, thre1 lowered until a quarter of the hand boxes
    form) on the .caffemodel weights, its NMS mask launch held bit-equal,
    its integer planes (hand peaks too) word-equal to the same step on the
    .npz weights -> (result, the pipeline, its frames, bucket, thre1, the
    hand .caffemodel path)."""
    from islx_torch.cli import convert
    from islx_torch.core import weights as W
    from islx_torch.pipeline.batch_pose import FusedPosePipeline

    res = {}
    paths, states = {}, {}
    for mt, state in zip(("body25", "hand"), parity_weights()):
        path = os.path.join(work, f"{mt}.caffemodel")
        t0 = time.perf_counter()
        write_caffemodel(path, state)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = W.load(path, mt)
        read_s = time.perf_counter() - t0
        if not all(torch.equal(loaded[n][k], state[n][k])
                   for n in state for k in state[n]):
            raise SystemExit(f"tools: {mt}.caffemodel read back other "
                             f"weights")
        npz = os.path.join(work, f"{mt}.npz")
        with contextlib.redirect_stdout(sys.stderr):
            convert.main([path, npz, "--model-type", mt])
        paths[mt], states[mt] = (path, npz), loaded
        res[mt] = {"bytes": os.path.getsize(path), "write_s": write_s,
                   "read_s": read_s}
        log(f"  {mt}.caffemodel: {os.path.getsize(path) / 2 ** 20:.1f} MiB "
            f"written in {write_s:.2f} s, read by W.load in {read_s:.2f} s "
            f"(equal word for word); cli/convert -> .npz")
    b, orig_hw = 192, (512, 384)
    hb, wb = 184, 144
    host = seeded_i420(np.random.RandomState(0), b, hb, wb)
    pipe = FusedPosePipeline(states["body25"], states["hand"],
                             hand_cfg=hand_cfg, compute_dtype=torch.bfloat16,
                             device="cuda")
    flat = pipe.upload_frames(host)
    with uncounted():       # lowered until hand boxes form: the hand net's
        thre1 = calibrate_thre1(pipe, flat, b, hb, wb, orig_hw)  # weights
        for _ in range(16):                                 # then count
            boxes = pipe.unpack(pipe.device_step_flat(
                flat, b, hb, wb, orig_hw, thre1,
                input_format="yuv420").cpu().numpy(), b)[1]
            if (boxes[:, 3] > 0).sum() >= b // 4:
                break
            thre1 *= 0.75
    with watched_nms() as nms:
        packed = pipe.device_step_flat(flat, b, hb, wb, orig_hw, thre1,
                                       input_format="yuv420").cpu().numpy()
    with uncounted():
        pipe_npz = FusedPosePipeline(
            W.load(paths["body25"][1], "body25"),
            W.load(paths["hand"][1], "hand"), hand_cfg=hand_cfg,
            compute_dtype=torch.bfloat16, device="cuda")
        want = pipe_npz.device_step_flat(
            pipe_npz.upload_frames(host), b, hb, wb, orig_hw, thre1,
            input_format="yuv420").cpu().numpy()
        del pipe_npz
    got_p, want_p = integer_planes(pipe, packed, b), integer_planes(
        pipe, want, b)
    diff = [k for k in want_p if not np.array_equal(got_p[k], want_p[k])]
    if diff or nms["calls"] != 1 or not (got_p["boxes"][:, 3] > 0).any():
        raise SystemExit(f"tools: the step on .caffemodel weights differs "
                         f"from the .npz one in {diff} ({nms['calls']} NMS "
                         f"calls checked, "
                         f"{int((got_p['boxes'][:, 3] > 0).sum())} hand "
                         f"boxes)")
    res["step"] = {"batch": b, "bucket": [hb, wb], "thre1": thre1,
                   "peaks": int(got_p["count"].sum()),
                   "hand_boxes": int((got_p["boxes"][:, 3] > 0).sum()),
                   "integer_planes_equal_npz": True,
                   "words_equal": int((packed == want).sum()),
                   "words": int(packed.size), "nms_checked": nms["calls"]}
    log(f"  fused step B={b} on the .caffemodel weights: integer planes "
        f"word-equal to the .npz weights' ({res['step']['peaks']} peaks, "
        f"{res['step']['hand_boxes']} hand boxes); NMS mask bit-equal")
    return res, pipe, flat, (b, hb, wb, orig_hw, thre1), paths["hand"][0]


def trace_leg(work: str, pipe, flat, geom) -> dict:
    """6c step 5: utils/profiling.trace around one fused step writes a
    Chrome trace naming the step's ranges and the NMS mask kernel."""
    from islx_torch.utils import profiling

    b, hb, wb, orig_hw, thre1 = geom
    with profiling.trace(os.path.join(work, "trace")) as prof:
        pipe.device_step_flat(flat, b, hb, wb, orig_hw, thre1,
                              input_format="yuv420").cpu()
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    want = ("body_cpm", "paf_limbs", "hand_cpm", "nms_mask_kernel")
    missing = [w for w in want if not any(w in n for n in names)]
    if missing:
        raise SystemExit(f"tools: the trace names no {missing}")
    res = {"trace_bytes": os.path.getsize(prof.trace_path),
           "events": len(names), "named": list(want),
           "cache": profiling.log_compile_cache()}
    log(f"  profiling.trace: {res['trace_bytes'] / 2 ** 20:.1f} MiB Chrome "
        f"trace naming {', '.join(want)}; {res['cache']}")
    return res


def quantize_leg(work: str, hand_160) -> dict:
    """6c step 2: the quantize CLI's core (cli/quantize.calibration_inputs
    on frames already at their target sizes, then quantize_to_file on the
    card) for BODY_25 (184x144) and the hand (368x368), the states
    reloaded with W.load; one int8 fused-160s5 step on them at B=192 with
    every conv_q and quantize call held word-equal to its plain version."""
    from islx_torch.cli import quantize as QCLI
    from islx_torch.core import weights as W
    from islx_torch.pipeline.batch_pose import FusedPosePipeline

    rng = np.random.RandomState(21)
    out = {}
    for mt, seed, (h, w) in (("body25", 0, (184, 144)),
                             ("hand", 1, (368, 368))):
        x = QCLI.calibration_inputs(list(bgr_frames(rng, 8, h, w)), mt)
        t0 = time.perf_counter()
        with uncounted():
            path = QCLI.quantize_to_file(W.init_params(mt, seed), mt, x,
                                         os.path.join(work, f"{mt}-int8.pt"),
                                         device="cuda")
        state = W.load(path, mt)
        n_q = sum("w_q" in e for e in state.values())
        if n_q != len(state):
            raise SystemExit(f"tools: {n_q}/{len(state)} {mt} layers int8")
        out[mt] = state
        log(f"  quantize: {mt} calibrated on 8 {h}x{w} frames and written "
            f"to {os.path.basename(path)} in {time.perf_counter() - t0:.1f}"
            f" s; W.load reads {n_q} int8 layers")
    b, orig_hw, hb, wb = 192, (512, 384), 184, 144
    host = seeded_i420(np.random.RandomState(0), b, hb, wb)
    pipe = FusedPosePipeline(out["body25"], out["hand"], hand_cfg=hand_160,
                             compute_dtype=torch.bfloat16, device="cuda")
    flat = pipe.upload_frames(host)
    with uncounted():
        thre1 = calibrate_thre1(pipe, flat, b, hb, wb, orig_hw)
    seen = main_path_convs(pipe, flat, b, hb, wb, orig_hw, thre1)
    convs = 114 + 17 + 7 * (hand_160.stages - 1)
    quants = 103 + 2 + (hand_160.stages - 1)
    if (seen["convs"], seen["quantizes"]) != (convs, quants):
        raise SystemExit(f"tools: the int8 step checked {seen['convs']} "
                         f"convs and {seen['quantizes']} quantizations, want"
                         f" {convs} and {quants}")
    log(f"  int8 fused-160s5 step on the CLI's states: all {convs} conv_q "
        f"and {quants} quantize calls word-equal to their plain versions")
    return {"convs_checked": seen["convs"],
            "quantizes_checked": seen["quantizes"],
            "conv_shapes": len(seen["shapes"]),
            "max_abs_err": seen["max_abs_err"], "thre1": thre1}


def caffe_net_leg(work: str, hand_caffemodel: str) -> dict:
    """6c step 3: core/caffe_net.Net on the hand CPM (a prototxt from the
    port's conv table, weights from the .caffemodel) at 368x368, f32 with
    TF32 off: the output against the port's f32 hand CPM on the card and
    against the same Net on the CPU (within 1e-4 of the largest
    magnitude); SGDSolver with an EuclideanLoss at batch 4 for 5 steps on
    the card and on the CPU (the loss falls; each step's loss within 1e-4
    of the CPU's, relative; the 5 steps' update of all params within 1e-3
    of the CPU's by norm, each blob's within 5e-2); ms per forward and per
    step."""
    from islx_torch.core import caffe_net as CN
    from islx_torch.core import weights as W

    text, out = hand_prototxt()
    proto = os.path.join(work, "hand.prototxt")
    with open(proto, "w") as f:
        f.write(text)
    rng = np.random.RandomState(22)
    frames = bgr_frames(rng, 4, 368, 368)
    x = np.ascontiguousarray((frames.astype(np.float32) / 256.0 - 0.5)
                             .transpose(0, 3, 1, 2))
    net = CN.Net(proto, hand_caffemodel, CN.TEST, device="cuda")
    got = torch.from_numpy(net.forward(data=x[:1])[out])
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.forward(data=x[:1])
        times.append((time.perf_counter() - t0) * 1e3)
    cpm_net = W.build("hand", W.load(hand_caffemodel, "hand"), "cuda",
                      torch.float32)
    with torch.no_grad():
        want = cpm_net(torch.from_numpy(frames[:1]).cuda().float() / 256.0
                       - 0.5).permute(0, 3, 1, 2)
    cpu = CN.Net(proto, hand_caffemodel, CN.TEST, device="cpu")
    want_cpu = torch.from_numpy(cpu.forward(data=x[:1])[out])
    err_cpm, err_cpu = rel_err(got, want), rel_err(got, want_cpu)
    if not (got.shape == (1, 22, 46, 46) and err_cpm <= 1e-4
            and err_cpu <= 1e-4):
        raise SystemExit(f"tools: caffe_net hand {tuple(got.shape)} is "
                         f"{err_cpm:.2e} from the port's CPM, {err_cpu:.2e} "
                         f"from the CPU Net (relative)")
    res = {"forward_shape": list(got.shape), "rel_err_cpm": err_cpm,
           "rel_err_cpu": err_cpu, "ms_per_forward": statistics.median(times),
           "ms_per_forward_range": [min(times), max(times)]}
    log(f"  caffe_net.Net hand at 368x368 f32: {err_cpm:.2e} from the "
        f"port's CPM, {err_cpu:.2e} from the CPU Net (relative); "
        f"{res['ms_per_forward']:.2f} ms/forward")

    text, out = hand_prototxt(loss=True)
    with open(os.path.join(work, "hand_train.prototxt"), "w") as f:
        f.write(text)
    solver = os.path.join(work, "solver.prototxt")
    with open(solver, "w") as f:
        f.write(f'net: "{os.path.join(work, "hand_train.prototxt")}"\n'
                f'base_lr: 1e-9\nmomentum: 0.9\nweight_decay: 0.0005\n')
    label = np.zeros((4, 22, 46, 46), np.float32)
    card = CN.SGDSolver(solver, device="cuda")
    card.net.copy_from(hand_caffemodel)
    start = {(n, k): v.detach().cpu().clone()
             for n, e in card.net.params.items() for k, v in e.items()}
    losses, step_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(card.step(1, data=x, label=label))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    host = CN.SGDSolver(solver, device="cpu")
    host.net.copy_from(hand_caffemodel)
    losses_cpu = [host.step(1, data=x, label=label) for _ in range(5)]
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses, losses_cpu)]
    blob_err, diff2, upd2 = {}, 0.0, 0.0
    for (n, k), v0 in start.items():
        d_card = card.net.params[n][k].detach().cpu().double() - v0.double()
        d_cpu = host.net.params[n][k].detach().double() - v0.double()
        diff, upd = float((d_card - d_cpu).norm()), float(d_cpu.norm())
        blob_err[f"{n}.{k}"] = diff / max(upd, 1e-30)
        diff2, upd2 = diff2 + diff * diff, upd2 + upd * upd
    upd_err = (diff2 / upd2) ** 0.5
    worst = max(blob_err, key=blob_err.get)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and max(loss_err) <= 1e-4
            and upd_err <= 1e-3 and blob_err[worst] <= 5e-2):
        raise SystemExit(f"tools: SGDSolver losses {losses}, CPU "
                         f"{losses_cpu}; updates {upd_err:.2e} from the "
                         f"CPU's by norm, {worst} {blob_err[worst]:.2e}")
    res.update({"solver_losses": losses, "solver_losses_cpu": losses_cpu,
                "solver_loss_rel_err": loss_err,
                "solver_update_rel_err": upd_err,
                "solver_worst_blob": [worst, blob_err[worst]],
                "solver_batch": 4,
                "ms_per_step": statistics.median(step_ms[1:]),
                "ms_per_step_range": [min(step_ms[1:]), max(step_ms[1:])]})
    log(f"  SGDSolver hand, batch 4, 5 steps: loss {losses[0]:.1f} -> "
        f"{losses[-1]:.1f} (CPU's within {loss_err[0]:.1e} first, "
        f"{loss_err[-1]:.1e} fifth; updates {upd_err:.1e} by norm, "
        f"{worst} {blob_err[worst]:.1e}); "
        f"{res['ms_per_step']:.1f} ms/step")
    return res


def served_coco_leg(hand_cfg) -> dict:
    """6c step 4: a burst of 8 COCO frames (184x144) through MicroBatcher,
    word-equal to a direct COCO step, the NMS mask launch bit-equal."""
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.serve import MicroBatcher

    _, cp, hp = si_weights()
    hb, wb = SERVE_BUCKETS[0]
    burst = bgr_frames(np.random.RandomState(23), 8, hb, wb)
    pipe = FusedPosePipeline(cp, hp, "coco", hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device="cuda")
    with uncounted():
        thre1 = heat_quantile(pipe.body, burst, 19, 0.99)
        thre1 = calibrate_people(pipe, burst, thre1, "served coco", tries=24)
    b = MicroBatcher(pipe, max_batch=8, max_wait_ms=1000.0)
    try:
        with watched_nms() as nms:
            got = serve_batch(b, burst)
    finally:
        b.close()
    if b.stats()["batches"] != 1 or nms["calls"] != 1:
        raise SystemExit(f"served coco: {b.stats()['batches']} batches, "
                         f"{nms['calls']} NMS calls checked")
    with uncounted():
        packed = pipe.device_step(burst, (hb, wb)).cpu().numpy()
    results, boxes, peaks = pipe.assemble(packed, 8)
    if not same_results(got, results, boxes, peaks, pipe):
        raise SystemExit("served coco: the burst differs from a direct step")
    res = {"frames": 8, "thre1": thre1,
           "candidates": sum(len(r.candidate) for r in got),
           "people": sum(len(r.subset) for r in got),
           "hands": sum(len(r.hands) for r in got), "word_equal": True}
    log(f"  served COCO burst of 8: word-equal to a direct step "
        f"({res['candidates']} candidates, {res['people']} people, "
        f"{res['hands']} hands); NMS mask bit-equal")
    return res


def tools(hand_cfg, hand_160) -> dict:
    """Phase 6c (module doc)."""
    t_phase = time.perf_counter()
    set_counts(dict.fromkeys(ALL_KERNELS, 0))   # the path's run starts here
    work = tempfile.mkdtemp(prefix="islx_tools_")
    try:
        res = {}
        res["caffemodel"], pipe, flat, geom, hand_cm = caffe_weights_leg(
            work, hand_cfg)
        res["trace"] = trace_leg(work, pipe, flat, geom)
        del pipe, flat
        torch.cuda.empty_cache()
        res["quantize"] = quantize_leg(work, hand_160)
        torch.cuda.empty_cache()
        res["caffe_net"] = caffe_net_leg(work, hand_cm)
        torch.cuda.empty_cache()
        res["served_coco"] = served_coco_leg(hand_cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = kernel_counts()
    res["launches"] = launches
    path = ("nms_mask_rows", "conv_q", "quantize")
    if (min(launches[k] for k in path) < 1
            or any(n for k, n in launches.items() if k not in path)):
        raise SystemExit(f"tools: want {', '.join(path)} launched and no "
                         f"other kernel: {launches}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  launches in phase 6c: {launches}; {res['seconds']:.1f} s")
    return res


def mesh_devices(n: int) -> list:
    """``n`` devices for a mesh: distinct cards where there are as many,
    else ``cuda:0`` again (the shards then share one card)."""
    count = torch.cuda.device_count()
    if count >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def describe_mesh(mesh) -> str:
    return (f"{mesh.shape} on "
            f"{[[str(d) for d in row] for row in mesh.devices]}")


def host_step_ms(fn, reps: int = 3) -> list:
    """Host ms of each of ``reps`` calls of ``fn`` that end in a copy to
    the host (the step's wall)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def planes_apart(got: dict, want: dict) -> dict:
    """Integer plane -> how many of its words differ."""
    return {k: int((got[k] != want[k]).sum()) for k in want
            if not np.array_equal(got[k], want[k])}


def mesh_fused_leg(name, hand_cfg, mesh, int8=False, b=192,
                   orig_hw=(512, 384)) -> dict:
    """The fused step at full width on ``mesh`` (data over its shards), on
    phase 6b's weights (si_weights; under int8 quantized by quantize_on on
    the batch's first 8 frames) and its threshold rule (calibrate_people on
    those 8 frames), so that people and hand boxes form across the batch:
    a shard's hand half then crops and reads real boxes. Its integer
    planes must equal those of the unsharded step run on each shard's
    frames (the same work at the shard's batch) on the same weights and
    thresholds; how many words differ from the unsharded step at the whole
    batch is recorded: a conv library may pick another algorithm at
    another batch, whose bf16 words differ, and the unsharded step at the
    shard's batch differs from it in just those words. One step with every
    shard's NMS mask call (and, under int8, every conv_q and quantize
    call) held against its plain version; ms/step in turns with the
    unsharded step at the whole batch on the same card."""
    from islx_torch.ops.yuv import frame_bytes, yuv420_to_bgr
    from islx_torch.pipeline.batch_pose import FusedPosePipeline, bucket_for

    n = mesh.shape["data"]
    per = b // n
    hb, wb = bucket_for(*orig_hw)
    host = seeded_i420(np.random.RandomState(0), b, hb, wb)
    rows = host.reshape(b, -1)
    with uncounted():
        first8 = yuv420_to_bgr(torch.from_numpy(
            host[:8 * frame_bytes(hb, wb)]).cuda(), 8, hb, wb).to(
                torch.uint8).cpu().numpy()
        bp, _, hp = si_weights()
        if int8:
            bp, hp = quantize_on(bp, hp, list(first8), hand_cfg, "cuda")
        one = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                                compute_dtype=torch.bfloat16, device="cuda")
        thre1 = calibrate_people(
            one, first8, heat_quantile(one.body, first8, 26, 0.99),
            f"mesh {name}", tries=24)

        def run(p, frames, k):
            return p.device_step_flat(p.upload_frames(frames), k, hb, wb,
                                      orig_hw, thre1,
                                      input_format="yuv420").cpu().numpy()

        run(one, rows, b)                                   # warm-up
        whole = integer_planes(one, run(one, rows, b), b)
        parts = []
        for i in range(n):
            pl = integer_planes(one, run(one, rows[i * per:(i + 1) * per],
                                         per), per)
            pl["boxes"][:, 0] += i * per
            parts.append(pl)
        halves = {k: np.concatenate([p[k] for p in parts]) for k in whole}
    pipe = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, mesh=mesh)
    pipe.body.cfg = one.body.cfg

    def step(p):
        return run(p, rows, b)

    packed = step(pipe)                                     # warm-up
    got = integer_planes(pipe, packed, b)
    diff = planes_apart(got, halves)
    if diff:
        raise SystemExit(f"mesh {name}: integer words {diff} differ from "
                         f"the unsharded step's on each shard's frames")
    boxes = got["boxes"][:, 3] > 0
    shards_with_hands = sorted({int(f) // per
                                for f in got["boxes"][boxes, 0]})
    if len(shards_with_hands) < n:
        raise SystemExit(f"mesh {name}: hand boxes formed on shards "
                         f"{shards_with_hands} of {n}")
    apart = planes_apart(got, whole)
    with watched_nms() as nms, (watched_convs() if int8
                                else contextlib.nullcontext()) as convs:
        step(pipe)
    convs_a_step = 114 + 17 + 7 * (hand_cfg.stages - 1)
    quants_a_step = 103 + 2 + (hand_cfg.stages - 1)
    if nms["calls"] != n or (int8 and (convs["convs"], convs["quantizes"])
                             != (n * convs_a_step, n * quants_a_step)):
        raise SystemExit(f"mesh {name}: {nms['calls']} NMS calls checked"
                         + (f", {convs['convs']} conv_q and "
                            f"{convs['quantizes']} quantize" if int8 else "")
                         + f" for {n} shards")
    sharded_ms, single_ms = [], []
    for _ in range(2):                    # in turns: one, mesh, mesh, one
        with uncounted():
            single_ms += host_step_ms(lambda: step(one), 2)
        sharded_ms += host_step_ms(lambda: step(pipe), 2)
    res = {"leg": name, "batch": b, "bucket": [hb, wb], "thre1": thre1,
           "shards": n, "integer_planes_equal_per_shard_batch": True,
           "words_apart_from_whole_batch": apart,
           "nms_checked": nms["calls"], "nms_shapes": nms["shapes"],
           "conv_q_checked": convs["convs"] if int8 else 0,
           "quantize_checked": convs["quantizes"] if int8 else 0,
           "ms_per_step": sharded_ms, "unsharded_ms_per_step": single_ms,
           "frames_per_s": [b / (ms / 1e3) for ms in sharded_ms],
           "unsharded_frames_per_s": [b / (ms / 1e3) for ms in single_ms],
           "hand_boxes": int(boxes.sum()),
           "hand_parts": int((got["hand_peaks"] != 0).any(-1).sum())}
    log(f"  mesh {name} B={b} over {n} shards: integer planes == the "
        f"unsharded step's on each shard's {per} frames, "
        f"{res['hand_boxes']} hand boxes on every shard, "
        f"{res['hand_parts']} hand parts; words apart from the unsharded "
        f"B={b} step {apart}; NMS mask held on {nms['calls']} shards"
        + (f", {convs['convs']} conv_q + {convs['quantizes']} quantize "
           f"calls word-equal" if int8 else "")
        + f"; {min(sharded_ms):.1f}-{max(sharded_ms):.1f} ms/step against "
          f"{min(single_ms):.1f}-{max(single_ms):.1f} unsharded")
    return res


def mesh_hand_leg(hand_cfg, mesh) -> dict:
    """BatchedHandPipeline on the data mesh, phase 6b's hand weights: (a)
    4 crops of 368 px at scales 0.5-2.0 with peak mode cc, every shard's
    cc_label call held bit for bit against its plain version; (b)
    ``from_frames`` on 8 frames of the 184x144 bucket uploaded a shard
    each, its 16 boxes naming frames that the other shard holds. The
    peaks must equal the unsharded pipeline's run on each shard's crops
    (boxes, over all 8 frames): the same work at the shard's batch, as
    mesh_fused_leg holds; how many differ from the unsharded call on the
    whole batch is recorded (bf16 convs at another batch)."""
    from islx_torch.core.config import HandConfig
    from islx_torch.parallel import mesh as M
    from islx_torch.pipeline.batch_pose import BatchedHandPipeline

    n = mesh.shape["data"]
    _, _, hp = si_weights()
    rng = np.random.RandomState(43)
    crops = bgr_frames(rng, 4, 368, 368)
    kw = dict(crop_size=368, peak_mode="cc")
    sharded = BatchedHandPipeline(hp, HandConfig(), mesh=mesh, **kw)
    per_crops = len(crops) // n
    with uncounted():
        one_cc = BatchedHandPipeline(hp, HandConfig(), device="cuda", **kw)
        want = np.concatenate([one_cc(crops[i:i + per_crops]) for i in
                               range(0, len(crops), per_crops)])
        whole = one_cc(crops)
    with watched_parity("mesh hand") as par:
        got = sharded(crops)
    if par["label_components"] != n or not np.array_equal(got, want):
        raise SystemExit(f"mesh hand: {par['label_components']} labelling "
                         f"calls for {n} shards, or peaks unlike the "
                         f"unsharded pipeline's")
    hb, wb = SERVE_BUCKETS[0]
    frames = bgr_frames(rng, 8, hb, wb)
    nb = 16
    boxes = np.zeros((nb, 4), np.int32)
    boxes[:, 0] = (np.arange(nb) // 2 + 5) % 8
    boxes[:, 3] = rng.randint(48, 96, nb)
    boxes[:, 1] = [rng.randint(0, wb - w) for w in boxes[:, 3]]
    boxes[:, 2] = [rng.randint(0, hb - w) for w in boxes[:, 3]]
    per = nb // n
    foreign = int(sum(f // (8 // n) != i // per
                      for i, f in enumerate(boxes[:, 0])))
    ff = BatchedHandPipeline(hp, hand_cfg, mesh=mesh)
    flat = M.batch_sharding(mesh).put_flat(
        torch.from_numpy(frames.reshape(-1)), 8)
    if len(flat) != n:
        raise SystemExit(f"mesh hand: {len(flat)} frame shards for {n}")
    got_ff = ff.from_frames(flat, 8, hb, wb, boxes)
    with uncounted():
        one = BatchedHandPipeline(hp, hand_cfg, device="cuda")
        up = torch.from_numpy(frames.reshape(-1)).cuda()
        want_ff = np.concatenate([one.from_frames(up, 8, hb, wb,
                                                  boxes[i:i + per])
                                  for i in range(0, nb, per)])
        whole_ff = one.from_frames(up, 8, hb, wb, boxes)
    if not np.array_equal(got_ff, want_ff):
        raise SystemExit("mesh hand: from_frames across shards differs "
                         "from the unsharded pipeline's")
    res = {"crops": 4, "scales": list(HandConfig().scale_search),
           "cc_checked": par["label_components"],
           "parts_found": int((got != 0).any(-1).sum()),
           "from_frames_boxes": nb, "boxes_naming_other_shards": foreign,
           "from_frames_parts": int((got_ff != 0).any(-1).sum()),
           "crop_parts_apart_from_whole_batch": int(
               (got != whole).any(-1).sum()),
           "box_parts_apart_from_whole_batch": int(
               (got_ff != whole_ff).any(-1).sum())}
    log(f"  hand on the mesh: cc peaks of 4 crops == unsharded on each "
        f"shard's crops ({res['parts_found']} parts), cc_label held on "
        f"{par['label_components']} shards; from_frames with {foreign} of "
        f"{nb} boxes naming the other shard's frames == unsharded on each "
        f"shard's boxes ({res['from_frames_parts']} parts); parts apart "
        f"from the unsharded whole-batch call: crops "
        f"{res['crop_parts_apart_from_whole_batch']}, boxes "
        f"{res['box_parts_apart_from_whole_batch']}")
    return res


def mesh_serving_leg(hand_cfg, mesh) -> dict:
    """A burst of 8 bucket-sized frames served through MicroBatcher on a
    pipeline on ``mesh`` (``--mesh-data 2``'s; phase 6b's weights and
    threshold rule, so people and hands form), equal to direct unsharded
    steps on each shard's frames (mesh_fused_leg says why not the whole
    batch's), each shard's NMS mask call bit-equal."""
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.serve import MicroBatcher

    hb, wb = SERVE_BUCKETS[0]
    bp, _, hp = si_weights()
    pipe = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, mesh=mesh)
    one = FusedPosePipeline(bp, hp, hand_cfg=hand_cfg,
                            compute_dtype=torch.bfloat16, device="cuda")
    burst = bgr_frames(np.random.RandomState(29), 8, hb, wb)
    with uncounted():
        thre1 = calibrate_people(one, burst,
                                 heat_quantile(one.body, burst, 26, 0.99),
                                 "mesh serving", tries=24)
        pipe.body.cfg = one.body.cfg
        per = 8 // mesh.shape["data"]
        direct = [one.assemble(one.device_step(
            burst[i:i + per], (hb, wb)).cpu().numpy(), per)
            for i in range(0, 8, per)]
    b = MicroBatcher(pipe, max_batch=8, max_wait_ms=1000.0)
    try:
        with watched_nms() as nms:
            got = serve_batch(b, burst)
    finally:
        b.close()
    if (b.stats()["batches"] != 1 or nms["calls"] != mesh.shape["data"]
            or not all(same_results(got[i * per:(i + 1) * per], *d, one)
                       for i, d in enumerate(direct))):
        raise SystemExit(f"mesh serving: {b.stats()['batches']} batches, "
                         f"{nms['calls']} NMS calls, or results unlike a "
                         f"direct step's")
    res = {"frames": 8, "bucket": [hb, wb], "thre1": thre1,
           "candidates": sum(len(r.candidate) for r in got),
           "hands": sum(len(r.hands) for r in got), "equal": True,
           "nms_checked": nms["calls"]}
    log(f"  served burst of 8 on the mesh: equal to direct unsharded "
        f"steps on each shard's {per} frames ({res['candidates']} "
        f"candidates, {res['hands']} hands); "
        f"NMS mask bit-equal on {nms['calls']} shards")
    return res


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def mesh_spatial_leg(mesh) -> dict:
    """The spatial BODY_25 forward at 368x656 (two stripes over
    ``model``) against the single forward: f32 without TF32 within 1e-4
    of the largest output; bf16 timed in turns with the single forward."""
    from islx_torch.core import weights as W
    from islx_torch.parallel import sharding as S

    state = W.init_params("body25", 0)
    x = torch.from_numpy(np.random.RandomState(31).rand(
        1, 368, 656, 3).astype(np.float32) - 0.5).cuda()
    errs = {}
    for dt in (torch.float32,):
        want = S.make_batched_forward("body25", None, dt)(state, x)
        got = S.make_spatial_forward("body25", mesh, dt)(state, x)
        errs = {k: rel_max(g, w) for k, g, w in zip(("paf", "heat"), got,
                                                    want)}
    if max(errs.values()) > 1e-4:
        raise SystemExit(f"spatial forward: {errs} from the single forward")
    single = S.make_batched_forward("body25", None, torch.bfloat16)
    spatial = S.make_spatial_forward("body25", mesh, torch.bfloat16)
    t_single, t_spatial = [], []
    for _ in range(2):
        t_single.append(cuda_ms(lambda: single(state, x), reps=3))
        t_spatial.append(cuda_ms(lambda: spatial(state, x), reps=3))
    res = {"shape": [1, 368, 656, 3], "rel_err_f32": errs,
           "ms": t_spatial, "single_ms": t_single}
    log(f"  spatial BODY_25 368x656 over {mesh.shape['model']} stripes: "
        f"f32 within {max(errs.values()):.2e} of the single forward; bf16 "
        f"{min(t_spatial):.2f}-{max(t_spatial):.2f} ms against "
        f"{min(t_single):.2f}-{max(t_single):.2f}")
    return res


def mesh_pipeline_leg(devices) -> dict:
    """PipelinedCPM on BODY_25 over three segments at batch 4, 184x184:
    the forward and the f32 gradients (forward and backward without
    TF32) against the unsharded net's; the forwards timed in turns."""
    from islx_torch.core import weights as W
    from islx_torch.core.runtime import true_f32
    from islx_torch.models import cpm
    from islx_torch.parallel.pipeline import PipelinedCPM

    state = W.init_params("body25", 0)
    rng = np.random.RandomState(37)
    x = torch.from_numpy(rng.rand(4, 184, 184, 3).astype(np.float32)
                         - 0.5).cuda()
    t_paf = torch.from_numpy(rng.rand(4, 23, 23, 52).astype(np.float32)
                             ).cuda()
    t_heat = torch.from_numpy(rng.rand(4, 23, 23, 26).astype(np.float32)
                              ).cuda()
    pipe = PipelinedCPM(state, "body25", devices, torch.float32)
    net = cpm.CPM("body25").load_params(state).cuda().trainable()
    with torch.no_grad():
        want = net(x, torch.float32)
    got = pipe.forward(x, n_micro=2)
    fwd = {k: rel_max(g, w) for k, g, w in zip(("paf", "heat"), got, want)}
    loss, seg_grads = pipe.grads(x, (t_paf, t_heat), n_micro=2)
    with true_f32():
        paf, heat = net(x, torch.float32)
        want_loss = (torch.mean((paf - t_paf) ** 2)
                     + torch.mean((heat - t_heat) ** 2))
        want_loss.backward()
    grads = {n: g for seg in seg_grads for n, g in seg.items()}
    gerr = max(rel_max(grads[n]["w"], layer.weight.grad)
               for n, layer in net.layers.items())
    want_loss = float(want_loss.detach())
    lerr = abs(float(loss) - want_loss) / abs(want_loss)
    if max(fwd.values()) > 1e-4 or gerr > 1e-3 or lerr > 1e-5:
        raise SystemExit(f"PipelinedCPM: forward {fwd}, loss {lerr}, "
                         f"gradients {gerr} from the unsharded net's")
    t_pipe, t_single = [], []
    with torch.no_grad():
        for _ in range(2):
            t_single.append(cuda_ms(lambda: net(x, torch.float32), reps=3))
            t_pipe.append(cuda_ms(lambda: pipe.forward(x, n_micro=2),
                                  reps=3))
    res = {"segments": [s["cells"] for s in pipe.segments],
           "devices": [str(d) for d in devices], "batch": 4,
           "forward_rel_err": fwd, "loss_rel_err": lerr,
           "grad_rel_err": gerr, "ms": t_pipe, "single_ms": t_single}
    log(f"  PipelinedCPM BODY_25 over {len(devices)} segments "
        f"{res['segments']}: forward within {max(fwd.values()):.2e}, f32 "
        f"gradients within {gerr:.2e} of the unsharded net's; forward "
        f"{min(t_pipe):.2f}-{max(t_pipe):.2f} ms against "
        f"{min(t_single):.2f}-{max(t_single):.2f}")
    return res


def mesh_pose_train_leg(mesh) -> dict:
    """One f32 BODY_25 training step (batch 4, 184x184, no TF32) on the
    data mesh, a copy of the net a data row, against the unsharded step:
    the loss, every gradient and Adam's first moment (a gradient scaled
    by the shard count would move them, where Adam's first step of the
    weights, about lr * sign(g), would not)."""
    from islx_torch.core import weights as W
    from islx_torch.models import pose_train as PT

    state = W.init_params("body25", 0)
    rng = np.random.RandomState(47)
    x = torch.from_numpy(rng.rand(4, 184, 184, 3).astype(np.float32)
                         - 0.5).cuda()
    heat = torch.from_numpy(rng.rand(4, 23, 23, 26).astype(np.float32)
                            ).cuda()
    paf = torch.from_numpy(rng.rand(4, 23, 23, 52).astype(np.float32)
                           ).cuda()
    sts, steps, losses = {}, {}, {}
    for name, m in (("one", None), ("mesh", mesh)):
        sts[name] = PT.init_state("body25", 1e-4, state, device="cuda")
        steps[name] = PT.make_train_step(sts[name], "body25", torch.float32,
                                         mesh=m)
        losses[name] = float(steps[name](x, heat, paf)["loss"])
    copies = len({id(r) for r in PT.MeshNet(sts["one"].net,
                                            mesh).replicas})
    named = {k: dict(st.net.named_parameters()) for k, st in sts.items()}
    gerr = max(rel_max(named["mesh"][k].grad, p.grad)
               for k, p in named["one"].items())
    merr = max(rel_max(sts["mesh"].optimizer.state[named["mesh"][k]][
        "exp_avg"], sts["one"].optimizer.state[p]["exp_avg"])
        for k, p in named["one"].items())
    lerr = abs(losses["mesh"] - losses["one"]) / abs(losses["one"])
    if copies != mesh.shape["data"] or lerr > 1e-5 or gerr > 1e-3 \
            or merr > 1e-3:
        raise SystemExit(f"pose train on the mesh: {copies} net copies, "
                         f"loss {lerr}, gradients {gerr}, first moments "
                         f"{merr} from the unsharded step's")
    ms = {"one": [], "mesh": []}
    for k in ("one", "mesh", "mesh", "one"):
        ms[k] += host_step_ms(lambda: steps[k](x, heat, paf)["loss"].item(),
                              1)
    res = {"batch": 4, "size": 184, "copies": copies, "loss_rel_err": lerr,
           "grad_rel_err": gerr, "exp_avg_rel_err": merr,
           "ms": ms["mesh"], "single_ms": ms["one"]}
    log(f"  BODY_25 f32 train step over {copies} data rows: loss within "
        f"{lerr:.1e}, gradients within {gerr:.1e}, first moments within "
        f"{merr:.1e} of the unsharded step's; "
        f"{min(ms['mesh']):.1f}-{max(ms['mesh']):.1f} ms/step against "
        f"{min(ms['one']):.1f}-{max(ms['one']):.1f}")
    return res


def mesh_head_leg(mesh) -> dict:
    """One tensor-parallel head step (batch 32, dropout on) on ``mesh``
    against the unsharded step on the card with the same generator: the
    loss, the weights and Adam's first moments (the gradient's scale,
    which the weights of a first step do not show)."""
    from islx_torch.core.config import TranslatorConfig
    from islx_torch.isl import train as TR
    from islx_torch.models import translator as T

    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.randn(32, 20, 156).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 167, 32)).cuda()
    params = T.init_params(TranslatorConfig(), 0)
    out, ms, moments = {}, {}, {}
    for name, m in (("one", None), ("mesh", mesh)):
        st = TR.init_state(TranslatorConfig(), 1e-3, params, device="cuda")
        step = TR.make_train_step(st, m)
        gen = torch.Generator(device="cuda").manual_seed(7)
        loss = float(step(x, y, gen)["loss"])
        out[name] = (loss, st.head.to_params())
        whole = TR.shard_state(st)
        moments[name] = {n: whole.optimizer.state[p]["exp_avg"]
                         for n, p in whole.head.named_parameters()}
        ms[name] = host_step_ms(lambda: step(x, y, gen)["loss"].item(), 3)
    lerr = abs(out["mesh"][0] - out["one"][0]) / abs(out["one"][0])
    diffs = np.concatenate([
        np.abs(out["mesh"][1][n][k] - out["one"][1][n][k]).ravel()
        for n in params for k in params[n]])
    merr = max(rel_max(moments["mesh"][n], w)
               for n, w in moments["one"].items())
    # Adam's first step is about lr * sign(g): a gradient within rounding
    # of zero may step the other way (2 * lr), and only there
    off = float((diffs > 1e-5).mean())
    if lerr > 1e-5 or diffs.max() > 2 * 1e-3 + 1e-6 or off > 1e-3 \
            or merr > 1e-4:
        raise SystemExit(f"tensor-parallel head: loss {lerr}, weights "
                         f"{diffs.max()} ({off:.2%} over 1e-5), first "
                         f"moments {merr} from the unsharded step's")
    res = {"batch": 32, "loss_rel_err": lerr,
           "max_weight_diff": float(diffs.max()), "share_over_1e-5": off,
           "exp_avg_rel_err": merr, "ms": ms["mesh"], "single_ms": ms["one"]}
    log(f"  tensor-parallel head step on {mesh.shape}: loss within "
        f"{lerr:.1e} of the unsharded step's, first moments within "
        f"{merr:.1e}, weights within {diffs.max():.1e} ({off:.3%} over "
        f"1e-5); {min(ms['mesh']):.1f}-{max(ms['mesh']):.1f} ms/step "
        f"against {min(ms['one']):.1f}-{max(ms['one']):.1f}")
    return res


_NCCL_WORKER = r"""
import sys
sys.path.insert(0, {here!r})
import torch, torch.distributed as dist
from islx_torch.parallel import mesh as M
M.init_distributed({coord!r}, {world}, int(sys.argv[1]))
t = torch.ones(1, device="cuda")
dist.all_reduce(t)
assert float(t) == {world}, float(t)
dist.destroy_process_group()
"""


def mesh_nccl_leg() -> dict:
    """init_distributed in a world of the card count, NCCL: this process
    is rank 0, one worker process a further card; an all_reduce of ones
    sums to the world size."""
    import socket

    import torch.distributed as dist
    from islx_torch.parallel import mesh as M

    world = torch.cuda.device_count()
    s = socket.socket()
    s.bind(("localhost", 0))
    coord = f"localhost:{s.getsockname()[1]}"
    s.close()
    script = _NCCL_WORKER.format(here=HERE, coord=coord, world=world)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              env=dict(os.environ,
                                       CUDA_VISIBLE_DEVICES=str(r)))
             for r in range(1, world)]
    try:
        t0 = time.perf_counter()
        multi = M.init_distributed(coord, world, 0)
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        backend = dist.get_backend()
        again = M.init_distributed(coord, world, 0)
        dist.destroy_process_group()
        for p in procs:
            if p.wait(timeout=120) != 0:
                raise SystemExit("init_distributed: a worker failed")
        seconds = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if float(t) != world or backend != "nccl" or multi != (world > 1) \
            or again != multi:
        raise SystemExit(f"init_distributed: sum {float(t)}, backend "
                         f"{backend}, world {world}")
    log(f"  init_distributed: world {world} ({backend}), all_reduce of "
        f"ones == {world}, {seconds:.1f} s")
    return {"world": world, "backend": backend, "seconds": seconds}


def multi_device(hand_cfg, hand_160) -> dict:
    """Phase 6d (module doc)."""
    from islx_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    data = M.make_mesh(2, devices=mesh_devices(2))
    spatial = M.make_mesh(1, 2, devices=mesh_devices(2))
    tp = M.make_mesh(2, 2, devices=mesh_devices(4))
    log(f"  torch.cuda.device_count() = {count}; data mesh "
        f"{describe_mesh(data)}; spatial {describe_mesh(spatial)}; head "
        f"{describe_mesh(tp)}; pipeline {[str(d) for d in mesh_devices(3)]}")
    if len(data.distinct()) == 1:
        log("  one card: every shard runs on cuda:0, one after another on "
            "its stream. This shows the split, the placement, the gather "
            "and each shard's kernels; it does not show copies between "
            "cards, NCCL across cards or shards overlapping on several "
            "cards.")
    set_counts(dict.fromkeys(ALL_KERNELS, 0))   # the path's run starts here
    res = {"device_count": count, "meshes": {
        "data": describe_mesh(data), "spatial": describe_mesh(spatial),
        "head": describe_mesh(tp),
        "pipeline": [str(d) for d in mesh_devices(3)]}}
    res["fused_184s6"] = mesh_fused_leg("fused-184s6 bf16", hand_cfg, data)
    torch.cuda.empty_cache()
    res["fused_160s5_int8"] = mesh_fused_leg("fused-160s5 int8", hand_160,
                                             data, int8=True)
    torch.cuda.empty_cache()
    res["serving"] = mesh_serving_leg(hand_cfg, data)
    res["hand"] = mesh_hand_leg(hand_cfg, data)
    res["pose_train"] = mesh_pose_train_leg(data)
    res["spatial"] = mesh_spatial_leg(spatial)
    res["pipeline"] = mesh_pipeline_leg(mesh_devices(3))
    res["head"] = mesh_head_leg(tp)
    torch.cuda.empty_cache()
    launches = kernel_counts()
    res["launches"] = launches
    path = ("nms_mask_rows", "conv_q", "quantize", "label_components")
    if (min(launches[k] for k in path) < 1
            or any(n for k, n in launches.items() if k not in path)):
        raise SystemExit(f"multi-device: want {', '.join(path)} launched "
                         f"and no other kernel: {launches}")
    res["nccl"] = mesh_nccl_leg()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  launches in phase 6d: {launches}; {res['seconds']:.1f} s")
    return res


PARITY_STAGES = ("body_resize", "body_cpm", "body_maps", "body_peaks",
                 "paf_limbs", "grouping", "hand_resize", "hand_cpm",
                 "hand_maps", "hand_peaks")


def profile_calls(calls, stages) -> dict:
    """torch.profiler over one call of each ``calls`` entry (name ->
    callable, each warmed up first): device ms per stage range, the port's
    kernels (in no range), the device's busy share of the call's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        fn()                                              # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        stage_ms = dict.fromkeys(stages, 0.0)
        kernel_ms: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name in stage_ms:
                stage_ms[e.name] += e.device_time_total / 1e3
            elif (e.device_type == DeviceType.CUDA
                  and e.name not in stage_ms):   # not the ranges' own spans
                kernel_ms[e.name] = (kernel_ms.get(e.name, 0.0)
                                     + e.device_time_total / 1e3)
        device_ms = sum(kernel_ms.values())
        if device_ms <= 0:
            raise SystemExit(f"profile: the {name} trace holds no device "
                             f"time")
        port = {k: sum(ms for n, ms in kernel_ms.items()
                       if re.search(rf"(^|::){k}(<[^>]*>)?(\(|$)", n))
                for k in PORT_KERNELS}
        out[name] = {"wall_ms": wall, "device_ms": device_ms,
                     "device_busy_share": device_ms / wall,
                     "operations": sum(1 for e in prof.events()
                                       if e.device_type == DeviceType.CUDA
                                       and e.name not in stage_ms),
                     "stage_ms": {k: v for k, v in stage_ms.items() if v},
                     "port_kernel_ms": {k: v for k, v in port.items() if v}}
        log(f"  profile {name}: wall {wall:.1f} ms, device "
            f"{device_ms:.2f} ms ({100 * device_ms / wall:.1f}% busy, "
            f"{out[name]['operations']} operations); "
            + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items() if v))
    return out


def profile_parity() -> dict:
    """One parity Body call (720x1280, f32) and one Hand call (256 px
    crop, four scales) under torch.profiler (profile_calls)."""
    from islx_torch.core.config import HandConfig, PoseConfig
    from islx_torch.pose.body import Body
    from islx_torch.pose.hand import Hand

    bp, hp = parity_weights()
    body = Body(bp, config=PoseConfig(), compute_dtype=torch.float32)
    hand = Hand(hp, config=HandConfig(), compute_dtype=torch.float32)
    rng = np.random.RandomState(7)
    frame = seeded_frame(rng, 720, 1280)
    crop = seeded_frame(rng, 256, 256)
    calibrate_body(body, frame, body.cfg.max_peaks)
    return profile_calls({"body": lambda: body(frame),
                          "hand": lambda: hand(crop)}, PARITY_STAGES)


def profile_image(hand_cfg) -> dict:
    """One ImagePose call of each mode (bf16, phase 6b's frames, weights
    and thresholds) under torch.profiler (profile_calls)."""
    from islx_torch.pipeline.image import ImagePose

    hb, wb = SI_BUCKET
    bp, _, hp = si_weights()
    frames = bgr_frames(np.random.RandomState(13), 8, hb, wb)
    fused = ImagePose(bp, hp, fused=True, hand_cfg=hand_cfg)
    calibrate_people(fused.pipe, frames,
                     heat_quantile(fused.pipe.body, frames, 26, 0.99),
                     "profile", tries=24)
    split = ImagePose(bp, hp, hand_cfg=hand_cfg)
    split.body.cfg = fused.pipe.body.cfg
    return profile_calls({"image_fused": lambda: fused(frames[0]),
                          "image_split": lambda: split(frames[0])}, STAGES)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive islx_torch on one GPU.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="instead of phases 3-6, profile the fused step "
                           "(device ms per stage, top kernels, busy share)")
    mode.add_argument("--kernels", action="store_true",
                      help="run phases 1-3 and 7 only: build the kernels "
                           "and hold each against its plain version, with "
                           "times")
    mode.add_argument("--single", action="store_true",
                      help="run phases 1-2 and 6b only: for iterating on "
                           "the single-image and split pipelines")
    mode.add_argument("--tools", action="store_true",
                      help="run phases 1-2 and 6c only: .caffemodel "
                           "weights, the quantize CLI, the Caffe API, "
                           "served COCO, profiling.trace")
    mode.add_argument("--mesh", action="store_true",
                      help="run phases 1-2 and 6d only: the multi-device "
                           "paths (data, spatial and pipeline parallel, the "
                           "tensor-parallel head, init_distributed)")
    mode.add_argument("--aot", action="store_true",
                      help="run phases 1-2 and 5e only: serving warm "
                           "starts (cold, restart, warm and int8 warm legs "
                           "in fresh processes)")
    mode.add_argument("--aot-leg", metavar="CFG", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    if args.aot_leg:
        return aot_leg(args.aot_leg)
    sys.path.insert(0, HERE)
    from islx_torch.core.config import HandConfig
    from islx_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = ("nms_mask", "nms_first_k", "paf_sample", "cc_label", "conv_q",
             "grouping")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))   # a compiler a source
    log(f"[2] build: {', '.join(os.path.basename(r['path']) for r in built)} from "
        f"islx_torch/csrc in {time.perf_counter() - t0:.1f} s")

    def finish(result: dict) -> int:
        log(json.dumps(result))
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    hand_cfg, note = HandConfig.gated()
    hand_160 = dataclasses.replace(HandConfig.production(160.0 / 368.0),
                                   stages=5)
    if args.profile:
        log("[P] fused step under torch.profiler, full width, bf16")
        prof = [profile_step(hand_cfg), profile_step(hand_160),
                profile_step(hand_160, int8=True)]
        log("[P] the parity Body and Hand (f32), and ImagePose fused and "
            "split (bf16), under torch.profiler")
        return finish({"profile": prof, "parity_profile": profile_parity(),
                       "image_profile": profile_image(hand_cfg),
                       "card": card})

    if args.single:
        log("[6b] single image and the split pipelines, full width")
        return finish({"single_image": single_image(hand_cfg), "card": card,
                       "seconds": time.perf_counter() - t_start})
    if args.tools:
        log("[6c] .caffemodel weights, the quantize CLI, the Caffe API, "
            "served COCO and profiling.trace, full width")
        return finish({"tools": tools(hand_cfg, hand_160), "card": card,
                       "seconds": time.perf_counter() - t_start})
    if args.mesh:
        log("[6d] multi-device: data, spatial and pipeline parallel, the "
            "tensor-parallel head, init_distributed")
        return finish({"multi_device": multi_device(hand_cfg, hand_160),
                       "card": card,
                       "seconds": time.perf_counter() - t_start})
    if args.aot:
        log("[5e] serving warm starts: cold, restart, warm and int8 warm "
            "legs in fresh processes")
        return finish({"warm_starts": warm_starts(hand_cfg), "card": card,
                       "seconds": time.perf_counter() - t_start})

    log("[3] kernels against their plain versions")
    # smooth: the fused step's shape, translation's and a ragged one; bands:
    # peaks where the kernel's row bands meet, [2,3,40,1001] on the 1-pixel
    # path with rows off 16-byte boundaries; [1,2,1,1]: a call's host floor
    nms_rows = check_nms_kernel(
        [((192, 25, 184, 144), "smooth"), ((16, 25, 184, 328), "smooth"),
         ((3, 25, 37, 130), "smooth"), ((192, 25, 184, 144), "bands"),
         ((16, 25, 184, 328), "bands"), ((3, 25, 37, 130), "bands"),
         ((2, 3, 40, 1001), "bands"), ((1, 2, 1, 1), "smooth")])
    # sparse: the parity Body's shape and the select step's, with a few
    # peaks a plane as the calibrated paths give (whole planes read);
    # dense: K peaks early in every plane (the early exit); bands: peaks
    # where the kernel's row bands meet, at the main shapes and ragged ones
    inf = -float("inf")
    nfk_rows = check_nms_first_k([((1, 25, 720, 1280), 0.6, inf, "sparse"),
                                  ((192, 25, 184, 144), 0.5, 0.0, "sparse"),
                                  ((192, 25, 184, 144), 0.5, 0.0, "dense"),
                                  ((16, 25, 184, 328), 0.5, 0.0, "dense"),
                                  ((3, 25, 37, 130), 0.5, 0.0, "sparse"),
                                  ((3, 25, 37, 130), 0.5, 0.0, "dense"),
                                  ((1, 25, 720, 1280), 0.5, inf, "bands"),
                                  ((192, 25, 184, 144), 0.5, 0.0, "bands"),
                                  ((3, 25, 37, 130), 0.5, 0.0, "bands")])
    nfk_rows += check_nms_first_k([((16, 25, 184, 328), 0.5, 0.0, "bands"),
                                   ((3, 5, 7, 130), 0.5, 0.0, "bands"),
                                   ((1, 2, 1, 1), 0.5, 0.0, "bands")], k=1)
    paf_rows = check_paf_sample()
    # the Hand call's crop first (the row the kernels line reports), then
    # the parity Hand's other net sizes; tiles: maps built to break a
    # tiled labeller
    cc_rows = check_cc_label(CC_CASES)
    conv_rows = check_conv_q()
    quant_rows = check_quantize()
    torch.cuda.empty_cache()     # the plain versions' buffers: GBs at B=192
    if args.kernels:
        log("[7] labelling and PAF kernels, device ms per launch")
        cc_launch_split(cc_rows)
        paf_launch_split(paf_rows[0])
        return finish({"phase3": {"nms_mask_rows": nms_rows,
                                  "nms_first_k": nfk_rows,
                                  "paf_sample": paf_rows, "cc_label": cc_rows,
                                  "conv_q": conv_rows,
                                  "quantize": quant_rows},
                       "card": card, "seconds": time.perf_counter() - t_start})

    log("[4] fused pose step, full width, bf16")
    log(f"    hand config: {note}")
    step184, pipe184, packed_mask = fused_step(hand_cfg)
    step160, pipe160, packed160 = fused_step(hand_160)
    for step, p, packed in ((step184, pipe184, packed_mask),
                            (step160, pipe160, packed160)):
        hb, wb = step["bucket"]
        step["crops"] = crops_match_cpu(
            p, seeded_i420(np.random.RandomState(0), 192, hb, wb), 192, hb,
            wb, p.unpack(packed, 192)[1])
    del pipe184, pipe160
    small_reference_check()

    log("[4c] fused pose step, full width, int8 W8A8 CPMs (160 px, 5 "
        "stages), calibrated on the phase's frames")
    step_q, _, packed_q = fused_step(hand_160, int8=True)
    log(f"  int8 fused-160s5 {step_q['ms_per_step']:.1f} ms/step "
        f"({step_q['frames_per_s']:.1f} frames/s) against bf16 fused-160s5 "
        f"{step160['ms_per_step']:.1f} ms/step "
        f"({step160['frames_per_s']:.1f} frames/s)")
    small_reference_check(int8=True)
    checked = step_q["main_path_checked"]
    conv_rows.append({"shape": "fused-160s5 step, every conv",
                      "calls": checked["convs"], "bit_equal": True,
                      "max_abs_err": checked["max_abs_err"]})
    quant_rows.append({"shape": "fused-160s5 step, every unchained conv",
                       "calls": checked["quantizes"], "bit_equal": True,
                       "max_abs_err": 0})

    log("[4b] fused select path (pallas_nms=True), fused-184s6")
    step_sel, pipe, packed_sel = fused_step(hand_cfg, pallas_nms=True)
    if step_sel["thre1"] != step184["thre1"]:
        raise SystemExit(f"select path calibrated thre1 "
                         f"{step_sel['thre1']}, the mask path "
                         f"{step184['thre1']}")
    want = integer_planes(pipe, packed_mask, 192)
    got = integer_planes(pipe, packed_sel, 192)
    diff = [k for k in want if not np.array_equal(want[k], got[k])]
    if diff:
        raise SystemExit(f"select path: integer planes {diff} differ from "
                         f"the mask path's")
    step_sel["words_equal"] = int((packed_mask == packed_sel).sum())
    step_sel["words"] = int(packed_mask.size)
    log(f"  select path: integer planes word-equal to the mask path's; "
        f"{step_sel['words_equal']}/{step_sel['words']} words equal")

    log("[5] translation")
    trans = translation(hand_cfg)

    log("[5b] serving: micro-batcher, int8 swap and HTTP, full width")
    serve = serving(hand_cfg)

    log("[5c] dataset extraction from memory, full width, augmented: fused "
        "bf16 and int8, resume, two shards, exact")
    records = tempfile.mkdtemp(prefix="islx_records_")
    try:
        extract = extraction(hand_cfg, records)
        log("[5d] training, full width: the head on windows of 5c's "
            "records (fit, resume, reload), BODY_25 and the hand CPM "
            "(184x184, batch 8, f32 and bf16)")
        train = training(records)
    finally:
        shutil.rmtree(records, ignore_errors=True)

    log("[5e] serving warm starts: cold, restart, warm and int8 warm legs "
        "in fresh processes")
    aot = warm_starts(hand_cfg, serve["exact"]["thre1"])

    log("[6] reference-parity path, full width, f32")
    parity, body, frame = parity_path()
    parity_small_check()

    log("[6b] single image and the split pipelines, full width: ImagePose "
        "fused and split (bf16, int8, coco), the standalone body step, the "
        "exact construction, the body and hand pyramids")
    single = single_image(hand_cfg)

    log("[6c] .caffemodel weights, the quantize CLI, the Caffe API, served "
        "COCO and profiling.trace, full width")
    tool = tools(hand_cfg, hand_160)

    log("[6d] multi-device: data, spatial and pipeline parallel, the "
        "tensor-parallel head, init_distributed")
    mesh = multi_device(hand_cfg, hand_160)

    log("[7] labelling and PAF kernels, device ms per launch")
    cc_launch_split(cc_rows)
    paf_launch_split(paf_rows[0], body, frame)

    def entry(name, source, replaces, launches, rows, main=0):
        bench = rows[main]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "serving_launches": serve["launches"].get(name, 0),
                "extraction_launches": extract["launches"][
                    "label_components" if name == "cc_label" else name],
                "single_image_launches": single["launches"][
                    "label_components" if name == "cc_label" else name],
                "tools_launches": tool["launches"][
                    "label_components" if name == "cc_label" else name],
                "mesh_launches": mesh["launches"][
                    "label_components" if name == "cc_label" else name],
                "aot_launches": aot["launches"][
                    "label_components" if name == "cc_label" else name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "bit_equal": all(r["bit_equal"] for r in rows),
                "ms": bench["ms"], "plain_ms": bench["plain_ms"],
                "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
                "library_ms": bench.get("library_ms"), "shapes": rows}

    pl = parity["launches"]
    kernels = {"kernels": [
        entry("nms_mask_rows", "islx_torch/csrc/nms_mask.cu",
              "islx/ops/pallas_peaks.py:64", step184["nms_launches"],
              nms_rows),
        entry("nms_first_k", "islx_torch/csrc/nms_first_k.cu",
              "islx/ops/pallas_peaks.py:29", pl["nms_first_k"], nfk_rows),
        entry("paf_sample", "islx_torch/csrc/paf_sample.cu",
              "islx/ops/pallas_paf.py:30", pl["paf_sample"], paf_rows),
        entry("cc_label", "islx_torch/csrc/cc_label.cu",
              "islx/ops/pallas_cc.py:29", pl["label_components"], cc_rows),
        entry("conv_q", "islx_torch/csrc/conv_q.cu",
              "islx/models/quant.py:70", step_q["conv_q_launches"],
              conv_rows),
        entry("quantize", "islx_torch/csrc/conv_q.cu",
              "islx/models/quant.py:63", step_q["quantize_launches"],
              quant_rows)],
        "fused_step": [step184, step160, step_q], "select_step": step_sel,
        "translation": trans, "serving": serve, "extraction": extract,
        "training": train, "warm_starts": aot, "parity": parity,
        "single_image": single,
        "tools": tool, "multi_device": mesh, "card": card,
        "seconds": time.perf_counter() - t_start}
    return finish(kernels)


if __name__ == "__main__":
    sys.exit(main())
