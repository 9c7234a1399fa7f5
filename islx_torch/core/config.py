"""Frozen configuration dataclasses.

The reference hardcodes these constants at every copy site
(reference: src/body.py:41-46, src/hand.py:25-30, src/ISL_Model_parameter.py:64-69);
here they live in one place.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Body pose estimation config (reference: src/body.py:39-46)."""

    model_type: str = "body25"          # 'body25' | 'coco'
    scale_search: Tuple[float, ...] = (0.5,)
    boxsize: int = 368
    stride: int = 8
    pad_value: int = 128
    thre1: float = 0.1                  # peak threshold
    thre2: float = 0.05                 # PAF sample threshold
    max_peaks: int = 32                 # static K peaks per joint (device arrays)
    mid_num: int = 10                   # PAF line-integral samples (src/body.py:130)
    # reference multi-scale body averaging is buggy (src/body.py:80 doubles the
    # accumulator); default is the correct mean, flip for bit-parity experiments.
    ref_compat_averaging: bool = False

    @property
    def njoint(self) -> int:
        return 26 if self.model_type == "body25" else 19

    @property
    def npaf(self) -> int:
        return 52 if self.model_type == "body25" else 38


def resolve_gates(weights_dir: str | None = None) -> tuple:
    """-> (gates dict | None, bundle name): the per-checkpoint accuracy
    verdicts recorded by tools/validate_checkpoints.py (gates.json next to
    the evaluated weights). Shared lookup order for every gated production
    decision: explicit ``weights_dir`` > ``ISLX_WEIGHTS_DIR`` >
    ``<repo>/.synthetic_weights``."""
    import json
    import os

    wdir = (weights_dir or os.environ.get("ISLX_WEIGHTS_DIR")
            or os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                ".synthetic_weights"))
    name = os.path.basename(wdir) or wdir
    try:
        with open(os.path.join(wdir, "gates.json")) as f:
            return json.load(f), name
    except (OSError, ValueError):
        return None, name


def int8_gated(weights_dir: str | None = None) -> tuple:
    """(go, note): should production run int8 (W8A8) trunks for the
    checkpoint in ``weights_dir``? True iff the recorded per-checkpoint
    verdict is ``int8_default: GO`` (tools/validate_checkpoints.py — the
    int8-vs-float golden test passed on those weights; the reference has no
    quantization at all, src/body.py:58-65 runs f32). ``ISLX_INT8`` env
    always wins: 1 forces int8, 0 forces bf16."""
    import os

    env = os.environ.get("ISLX_INT8")
    if env is not None:
        on = env not in ("0", "")
        return on, f"env override (ISLX_INT8={env})"
    gates, name = resolve_gates(weights_dir)
    if gates is None:
        return False, ("bf16 (no gates.json — run "
                       "tools/validate_checkpoints.py)")
    v = gates.get("int8_default")
    if v == "GO":
        return True, f"int8 W8A8 trunks (gate GO on {name})"
    return False, f"bf16 (int8 gate {v} on {name})"


@dataclasses.dataclass(frozen=True)
class HandConfig:
    """Hand pose estimation config (reference: src/hand.py:24-33)."""

    scale_search: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0)
    boxsize: int = 368
    stride: int = 8
    pad_value: int = 128
    thre: float = 0.05
    n_parts: int = 21
    # CPM refinement depth: the reference consumes only the FINAL stage's
    # heatmap (src/model.py:394-407), so trailing stages are a pure
    # accuracy/FLOP knob — each trimmed stage cuts ~2.3 GFLOP per 184px
    # crop. 6 = reference-exact; tools/hand_scale_eval.py measures the
    # keypoint drift of 5/4 per checkpoint before flipping it in production
    # (ISLX_HAND_STAGES env on HandConfig.production()).
    stages: int = 6

    # Production fused-pipeline default: single pyramid scale 0.5 -> the hand
    # CPM runs on 184px crops instead of 368px (4x fewer FLOPs). The scale is
    # one the reference's own pyramid contains (src/hand.py:25 scale_search
    # starts at 0.5), and in the bucketed production pipeline the crop source
    # carries at most ~bucket-height (184px) of real content, so 368 was pure
    # upsample FLOPs. Whether trained-at-368 weights degrade at 184 is a
    # checkpoint-gated question (tools/hand_scale_eval.py answers it the
    # moment weights exist — PARITY.md #7); until then 184 is the default and
    # ISLX_HAND_SCALE=1.0 restores the 368 path.
    PRODUCTION_SCALE = 0.5

    @classmethod
    def production(cls, scale: float | None = None) -> "HandConfig":
        """Single-scale config for the fused production pipelines.

        Priority: explicit ``scale`` arg > ``ISLX_HAND_SCALE`` env >
        ``PRODUCTION_SCALE`` (0.5 -> 184px crops). ``ISLX_HAND_STAGES``
        (default 6) trims CPM refinement stages — accuracy-gated like the
        scale (tools/hand_scale_eval.py)."""
        import os

        if scale is None:
            scale = float(os.environ.get("ISLX_HAND_SCALE",
                                         cls.PRODUCTION_SCALE))
        return cls(scale_search=(scale,),
                   stages=int(os.environ.get("ISLX_HAND_STAGES", "6")))

    @classmethod
    def gated(cls, weights_dir: str | None = None) -> tuple:
        """(config, note): the production hand config resolved from EVERY
        recorded per-checkpoint gate verdict (gates.json written by
        tools/validate_checkpoints.py next to the evaluated weights —
        PARITY.md #7):

          hand_160_default GO         -> 160px crops (+hand_160_stages trim)
          hand_184_default GO         -> 184px default (+hand_stages trim)
          hand_184_default NO-GO      -> 368px fallback: the recorded verdict
                                         says the default ITSELF fails the
                                         accuracy bar, so staying on it would
                                         ignore the gate (VERDICT r4 weak #1)
          UNEVALUABLE                 -> 184px default, the note says the
                                         instrument had no signal
          no gates.json               -> 184px default, noted

        Every production surface (bench.py flagship, the batched CLIs,
        serving, AOT export) resolves its hand config through here so the
        flip is one recorded decision, never a hardcode. Lookup order:
        explicit ``weights_dir`` (CLIs pass the directory holding
        --hand-weights) > ``ISLX_WEIGHTS_DIR`` > ``<repo>/.synthetic_weights``.
        Explicit ``ISLX_HAND_SCALE`` / ``ISLX_HAND_STAGES`` env always wins."""
        import os

        cfg = cls.production()
        if "ISLX_HAND_SCALE" in os.environ or "ISLX_HAND_STAGES" in os.environ:
            return cfg, "env override"
        gates, name = resolve_gates(weights_dir)
        if gates is None:
            return cfg, ("184px default (no gates.json — run "
                         "tools/validate_checkpoints.py)")
        if gates.get("hand_160_default") == "GO":
            cfg = cls.production(scale=160.0 / 368.0)
            stages = int(gates.get("hand_160_stages", 6))
            if stages < 6:
                cfg = dataclasses.replace(cfg, stages=stages)
            return cfg, f"160px s{cfg.stages} (gate GO on {name})"
        g184 = gates.get("hand_184_default")
        if g184 == "NO-GO":
            return (cls.production(scale=1.0),
                    f"368px fallback (184px gate NO-GO on {name})")
        if g184 == "UNEVALUABLE" or gates.get(
                "hand_160_default") == "UNEVALUABLE":
            return cfg, (f"184px (hand gate UNEVALUABLE on {name} — "
                         "instrument had no signal)")
        stages = int(gates.get("hand_stages", 6))
        if g184 == "GO" and stages < 6:
            cfg = dataclasses.replace(cfg, stages=stages)
            return cfg, (f"184px s{stages} (184px gate GO on {name}, "
                         f"160px gate {gates.get('hand_160_default')})")
        return cfg, (f"184px (160px gate {gates.get('hand_160_default')} on "
                     f"{name})")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Wrist/elbow hand-box detector (reference: src/util.py:242-306)."""

    ratio_wrist_elbow: float = 0.33
    width_scale: float = 1.5
    shoulder_ratio: float = 0.9
    min_box: int = 20
    max_hands_per_person: int = 2


@dataclasses.dataclass(frozen=True)
class TranslatorConfig:
    """ISL translation head (reference: demo_isl_translate.py:72-100)."""

    window_size: int = 20
    feature_dim: int = 156
    lstm_units: int = 32
    dense_units: int = 32
    n_classes: int = 167
    dropout: float = 0.2
    n_body_points: int = 15
    n_hand_points: int = 21


