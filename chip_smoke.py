"""Drive the PyTorch/CUDA port (islx_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and the last line is never printed):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile the CUDA kernels from islx_torch/csrc (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (bit-equal), with median times over 20 launches;
4. fused pose step at full width (BODY_25 + hand CPM, bf16, seeded random
   weights): B=192 frames at the 184x144 bucket from I420, for the gated
   hand config (184 px, 6 stages) and for 160 px / 5 stages; the launch
   counters must show the main path went through every kernel; the same
   step in f32 on a small input must match the plain CPU path;
5. translation: BatchedTranslatePipeline at batch 16 over 48 seeded
   720x1280 frames (bucket 184x328, I420), frames - 19 predictions;
6. a JSON line of the kernels' numbers, then the card line again, then
   ``{"ok": true, "device": {...}}`` as the last line.

    python3 chip_smoke.py --profile

runs phases 1-2, then profiles the fused step of phase 4 for both hand
configs with torch.profiler: device ms per pipeline stage, the kernels
that take the most device time, the device's busy share of the steps'
wall time and the CPM convolutions' achieved rate, as one JSON line.

The script imports nothing of JAX or of the JAX package ``islx``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense


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


def check_nms_kernel(shapes, thre: float = 0.5) -> list:
    from islx_torch.ops import nms_mask as N

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in shapes:
        x = smooth_field(shape, gen, thre)
        m, c = N.nms_mask_rows(x, thre)
        torch.cuda.synchronize()
        mp, cp = N.nms_mask_rows_plain(x, thre)
        err = max(int((m.int() - mp.int()).abs().max()),
                  int((c - cp).abs().max()))
        if not (torch.equal(m, mp) and torch.equal(c, cp)):
            raise SystemExit(f"nms_mask_rows differs from its plain version "
                             f"at {shape}: max abs err {err}")
        px = x.numel()
        rows_n = shape[0] * shape[1] * shape[2]
        bytes_ = px * 4 + px * 1 + rows_n * 4   # read f32, write u8 + s32
        ops = px * 5                            # five f32 comparisons
        bound_s = max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)
        row = {"shape": list(shape), "bit_equal": True, "max_abs_err": err,
               "peaks": int(c.sum()),
               "ms": cuda_ms(lambda: N.nms_mask_rows(x, thre)),
               "plain_ms": cuda_ms(lambda: N.nms_mask_rows_plain(x, thre)),
               "bound_ms": bound_s * 1e3,
               "bound_by": ("bytes" if bytes_ / PEAK_BYTES_PER_S
                            >= ops / PEAK_F32_OPS_PER_S else "operations")}
        log(f"  nms_mask_rows {shape}: bit-equal, {row['peaks']} peaks, "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
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


def fused_setup(hand_cfg, b, orig_hw, device):
    """The full-width bf16 fused pipeline on seeded weights, a seeded I420
    batch at the bucket of ``orig_hw`` and its calibrated thre1, warmed
    up -> (pipe, host frames, hb, wb, thre1)."""
    from islx_torch.core import weights as W
    from islx_torch.pipeline.batch_pose import FusedPosePipeline, bucket_for

    hb, wb = bucket_for(*orig_hw)
    pipe = FusedPosePipeline(W.init_params("body25", 0),
                             W.init_params("hand", 1), hand_cfg=hand_cfg,
                             compute_dtype=torch.bfloat16, device=device)
    host = seeded_i420(np.random.RandomState(0), b, hb, wb)
    flat = pipe.upload_frames(host)
    thre1 = calibrate_thre1(pipe, flat, b, hb, wb, orig_hw)
    for _ in range(2):                                   # warm-up
        pipe.device_step_flat(flat, b, hb, wb, orig_hw, thre1,
                              input_format="yuv420").cpu()
    return pipe, host, hb, wb, thre1


def fused_step(hand_cfg, b=192, orig_hw=(512, 384), steps=5,
               device="cuda") -> dict:
    from islx_torch.ops import nms_mask as N

    pipe, host, hb, wb, thre1 = fused_setup(hand_cfg, b, orig_hw, device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    N.nms_mask_rows.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        packed = pipe.device_step_flat(pipe.upload_frames(host), b, hb, wb,
                                       orig_hw, thre1,
                                       input_format="yuv420").cpu().numpy()
    dt = (time.perf_counter() - t0) / steps
    launches = N.nms_mask_rows.launches
    if launches != (steps if device == "cuda" else 0):
        raise SystemExit(f"nms_mask_rows launched {launches} times in "
                         f"{steps} fused steps (want one per step)")
    body, boxes, peaks = pipe.unpack(packed, b)
    xy, score, count, pair, cscore, cok = pipe.body.unpack(body, b)
    k = pipe.body.cfg.max_peaks
    if not (np.isfinite(score).all() and np.isfinite(cscore).all()
            and count.min() >= 0 and count.max() <= k and count.sum() > 0
            and (boxes[:, 1] < wb).all() and (boxes[:, 2] < hb).all()
            and (boxes[:, 3] >= 0).all() and pair.max() < k * k):
        raise SystemExit("fused step output out of range")
    size = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    res = {"hand": f"{size}px/s{hand_cfg.stages}", "batch": b,
           "bucket": [hb, wb], "thre1": thre1, "ms_per_step": dt * 1e3,
           "frames_per_s": b / dt, "peaks": int(count.sum()),
           "hand_boxes": int((boxes[:, 3] > 0).sum()),
           "nms_launches": launches, "steps": steps,
           "max_mem_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                          if device == "cuda" else None)}
    log(f"  fused step {res['hand']}: {res['ms_per_step']:.1f} ms/step, "
        f"{res['frames_per_s']:.1f} frames/s at B={b}, {res['peaks']} peaks,"
        f" {res['hand_boxes']} hand boxes, nms launches {launches}/{steps}")
    return res


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


def profile_step(hand_cfg, b=192, orig_hw=(512, 384), steps=3) -> dict:
    """torch.profiler over a few fused steps: device ms per stage (the
    ``record_function`` ranges of the pipeline), the kernels that take the
    most device time, the device's busy share of the window, and the CPM
    convolutions' achieved rate against the bf16 tensor-core peak."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe, host, hb, wb, thre1 = fused_setup(hand_cfg, b, orig_hw, "cuda")
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
    res = {"hand": f"{size}px/s{hand_cfg.stages}", "batch": b,
           "bucket": [hb, wb], "steps": steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / wall_ms, "stage_ms": stage_ms,
           "conv_tflop_per_s": {k: v / (stage_ms[k] * 1e-3) / 1e12
                                for k, v in flops.items()},
           "conv_bound_ms": {k: v / PEAK_BF16_OPS_PER_S * 1e3
                             for k, v in flops.items()},
           "top_kernels": [{"name": n[:90], "ms": t} for n, t in top]}
    log(f"  profile {res['hand']}: wall {wall_ms:.1f} ms/step, device "
        f"{device_ms:.1f} ms ({100 * res['device_busy_share']:.1f}% busy)")
    for name, ms in stage_ms.items():
        log(f"    {name:14s} {ms:8.2f} ms")
    return res


def small_reference_check() -> None:
    """The card's f32 fused step == the plain CPU path on a small input:
    peak, pair, box and hand-peak tables equal, scores within f16."""
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
    cpu = FusedPosePipeline(bp, hp, device="cpu", **kw)
    gpu = FusedPosePipeline(bp, hp, device="cuda", **kw)
    frames = (np.random.RandomState(0).rand(2, 48, 48, 3) * 255
              ).astype(np.uint8)
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
    # Hand crops are rounded to integers after a cubic-resize contraction
    # that cuBLAS and the CPU BLAS sum in different orders, so a crop pixel
    # sitting at .5 can round apart and nudge a near-threshold hand part;
    # at most 1 in 20 (crop, part) entries may differ.
    same = float((pw == pg).all(-1).mean())
    if same < 0.95:
        bad = np.nonzero((pw != pg).any(-1))
        raise SystemExit(f"small check: hand peaks differ at {bad}: "
                         f"{pw[bad].tolist()} vs {pg[bad].tolist()}")
    err = max(float(np.abs(tw[1] - tg[1]).max()),
              float(np.abs(tw[4] - tg[4]).max()))
    if err > 1e-2:
        raise SystemExit(f"small check: scores differ by {err}")
    log(f"  small f32 step on the card vs CPU plain path: body tables and "
        f"hand boxes equal ({int(tw[2].sum())} peaks, "
        f"{int((xw[:, 3] > 0).sum())} hand boxes), hand peaks equal "
        f"{same:.3f}, score max abs diff {err:.2e}, words equal "
        f"{int((want == got).sum())}/{want.size}")


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
    res = {"frames": n_frames, "batch": batch, "bucket": [hb, wb],
           "predictions": len(out), "frames_per_s": n_frames / dt,
           "nms_launches": launches, "thre1": pipe.thre1}
    log(f"  translation: {len(out)} predictions over {n_frames} frames, "
        f"{res['frames_per_s']:.1f} frames/s, nms launches {launches}")
    return res


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive islx_torch on one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="instead of phases 3-5, profile the fused step "
                         "(device ms per stage, top kernels, busy share)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from islx_torch.core.config import HandConfig
    from islx_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build("nms_mask")
    log(f"[2] build: nms_mask.cu in {time.perf_counter() - t0:.1f} s")

    hand_cfg, note = HandConfig.gated()
    hand_160 = dataclasses.replace(HandConfig.production(160.0 / 368.0),
                                   stages=5)
    if args.profile:
        log("[P] fused step under torch.profiler, full width, bf16")
        prof = [profile_step(hand_cfg), profile_step(hand_160)]
        log(json.dumps({"profile": prof, "card": card}))
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    log("[3] kernels against their plain versions")
    nms_rows = check_nms_kernel([(192, 25, 184, 144), (16, 25, 184, 328),
                                 (3, 25, 37, 130)])

    log("[4] fused pose step, full width, bf16")
    log(f"    hand config: {note}")
    steps = [fused_step(hand_cfg), fused_step(hand_160)]
    small_reference_check()

    log("[5] translation")
    trans = translation(hand_cfg)

    bench = nms_rows[0]
    kernels = {"kernels": [{
        "name": "nms_mask_rows", "route": "cuda",
        "source": "islx_torch/csrc/nms_mask.cu",
        "replaces": "islx/ops/pallas_peaks.py:64",
        "launches": steps[0]["nms_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in nms_rows),
        "bit_equal": all(r["bit_equal"] for r in nms_rows),
        "ms": bench["ms"], "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        "library_ms": None, "shapes": nms_rows}],
        "fused_step": steps, "translation": trans,
        "card": card, "seconds": time.perf_counter() - t_start}
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
