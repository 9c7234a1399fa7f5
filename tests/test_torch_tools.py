"""The port's offline tools against islx's on the CPU: the ``quantize`` CLI
(islx_torch.cli.quantize), ``summary`` (islx_torch.utils.summary and its
CLI) and ``profiling`` (islx_torch.utils.profiling).

Tolerances: the calibration inputs are word-equal to islx's; ``w_q`` and
``s_w`` equal; ``a_scale`` within rtol 1e-4 (the float convs sum in
another order, ROADMAP.md §3); a fused int8 step on the state the CLI
wrote, given islx's scales, has islx's integer words (the f16 score words
within one f16 rounding, as tests/test_torch_serve_int8.py); the summary
strings equal.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from islx.cli import quantize as JQCLI
from islx.models import cpm as JC
from islx.models import quant as JQ
from islx.pipeline import batch_pose as JBP
from islx.utils import profiling as JP
from islx.utils import summary as JS
from islx_torch.cli import quantize as TQCLI
from islx_torch.core import weights as W
from islx_torch.models import quant as TQ
from islx_torch.pipeline import batch_pose as TBP
from islx_torch.utils import profiling as TP
from islx_torch.utils import summary as TS
from test_torch_serve import (_frames, _islx_pipe, _port_pipe,
                              _same_steps, params)  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error:dynamic_crop_resize_batch:UserWarning")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# summary


@pytest.mark.parametrize("model_type", ["body25", "coco", "hand"])
def test_summary_string_equal(model_type, capsys):
    assert TS.summarize(model_type) == JS.summarize(model_type)
    from islx_torch.cli import summary as cli

    cli.main([model_type])
    assert capsys.readouterr().out == JS.summarize(model_type) + "\n"


@pytest.mark.parametrize("model_type", ["body25", "coco", "hand"])
def test_param_count_equal(model_type):
    """cpm.param_count (convert's check) and the summary's total share
    cpm.conv_params; both equal islx's count."""
    from islx_torch.models import cpm as TC

    n = TC.param_count(model_type)
    assert n == JC.param_count(model_type)
    assert TS.summarize(model_type).endswith(f"{n:>12,}")


def test_output_size_table_equal():
    assert TS.hand_output_size_table() == JS.hand_output_size_table()
    assert TS.hand_output_size_table(10, 999)["368"] == 46
    assert all(TS.output_size(n, k) == JS.output_size(n, k)
               for n in range(1, 200) for k in range(5))


# ---------------------------------------------------------------------------
# profiling


def test_stage_timer_matches_islx():
    """The same spans give islx's summary keys and values and its report,
    character for character."""
    spans = [("decode", 0.012), ("step", 0.5), ("decode", 0.004),
             ("group", 0.0021), ("step", 0.25), ("decode", 0.03)]
    j, t = JP.StageTimer(), TP.StageTimer()
    for name, s in spans:
        j.add(name, s)
        t.add(name, s)
    assert t.summary() == j.summary()
    assert t.report() == j.report()
    with t("ctx"):
        pass
    s = t.summary()["ctx"]
    assert s["count"] == 1 and s["total_s"] >= 0.0
    assert list(s) == ["count", "total_s", "mean_ms", "p50_ms", "max_ms"]


def test_trace_names_the_step_ranges(tmp_path, params):
    """A trace around a small CPU fused step writes a Chrome trace that
    names the step's stage ranges."""
    pipe = _port_pipe(params)
    frames = np.stack(_frames(0, [(48, 48)] * 2))
    pipe.device_step(frames)                 # warm
    with TP.trace(str(tmp_path / "tb")) as prof:
        pipe.device_step(frames)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tb")
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for stage in ("body_cpm", "body_peaks", "paf_limbs", "hand_boxes",
                  "hand_crops", "hand_cpm", "hand_peaks", "pack"):
        assert stage in names, stage
    cache = TP.log_compile_cache()
    assert set(cache) == {"kernel_libraries", "device_bytes_allocated"}
    assert cache["device_bytes_allocated"] == 0       # no CUDA here


# ---------------------------------------------------------------------------
# quantize

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 37-frame 120x160 clip (stride sampling halves its kept set)."""
    path = str(tmp_path_factory.mktemp("clip") / "c.avi")
    rng = np.random.RandomState(5)
    base = (rng.rand(30, 40, 3) * 255).astype(np.uint8)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 15,
                          (160, 120))
    for i in range(37):
        out.write(cv2.resize(np.roll(base, i, axis=1), (160, 120),
                             interpolation=cv2.INTER_CUBIC))
    out.release()
    return path


@pytest.mark.parametrize("model_type,n", [("hand", 8), ("body25", 3),
                                          ("coco", 16)])
def test_calibration_inputs_word_equal(clip, model_type, n):
    got = TQCLI.sample_calibration_inputs(clip, model_type, n, device="cpu")
    want = JQCLI.sample_calibration_inputs(clip, model_type, n)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_calibration_inputs_at_size_need_no_cv2(monkeypatch):
    """Without cv2, frames at the target size pass as they are (a
    same-size resize is a copy), and frames of another size are resized
    word-equal to cv2's INTER_CUBIC (the port's resize_u8)."""
    import sys

    import cv2

    from islx_torch.pipeline.batch_pose import bucket_for

    frames = _frames(1, [(368, 368)] * 2)
    other = _frames(2, [(240, 320)] * 2)
    hb, wb = bucket_for(240, 320, target_h=184)
    with_cv2 = TQCLI.calibration_inputs(frames, "hand", device="cpu")
    want = np.stack([cv2.resize(f, (wb, hb), interpolation=cv2.INTER_CUBIC)
                     for f in other]).astype(np.float32) / 256.0 - 0.5
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert TQCLI.calibration_inputs(frames, "hand", device="cpu"
                                    ).tobytes() == with_cv2.tobytes()
    assert TQCLI.calibration_inputs(other, "body25", device="cpu"
                                    ).tobytes() == want.tobytes()


def test_quantize_cli_matches_islx_and_steps_its_words(
        monkeypatch, clip, tmp_path, params, capsys):
    """The CLI on BODY_25 (2 frames of the clip) and its core on the hand
    net: ``w_q`` and ``s_w`` equal islx's ``quantize_model``, the port's
    own ``a_scale`` within rtol 1e-4 of islx's; with islx's scales the
    written states equal islx's quantized params word for word, and a
    fused int8 step on them is islx's int8 step."""
    body, hand, _ = params
    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    islx_scales, port_scales = {}, {}
    real_t = TQ.calibrate_scales

    def port_calibrate(state, model_type, batches, *a, **k):
        batches = list(batches)
        port_scales[model_type] = real_t(state, model_type, batches, *a, **k)
        islx_scales[model_type] = JQ.calibrate_scales(
            jax.tree.map(np.asarray, W.to_islx_params(state)), model_type,
            batches)
        return islx_scales[model_type]

    monkeypatch.setattr(TQ, "calibrate_scales", port_calibrate)
    W.save_npz(str(tmp_path / "body.npz"), W.from_islx_params(body))
    TQCLI.main([str(tmp_path / "body.npz"), str(tmp_path / "body-int8.pt"),
                "--model-type", "body25", "--calib", clip, "--frames", "2",
                "--device", "cpu"])
    n = len(JC.conv_layers("body25"))
    assert f"quantized {n}/{n} conv layers" in capsys.readouterr().out
    xh = np.random.RandomState(4).rand(2, 92, 92, 3).astype(np.float32) - .5
    TQCLI.quantize_to_file(W.from_islx_params(hand), "hand", xh,
                           str(tmp_path / "hand-int8.pt"), device="cpu")

    qb = W.load(str(tmp_path / "body-int8.pt"), "body25")
    qh = W.load(str(tmp_path / "hand-int8.pt"), "hand")
    xb = TQCLI.sample_calibration_inputs(clip, "body25", 2, device="cpu")
    jqb = JQ.quantize_params(body, islx_scales["body25"])
    jqh = JQ.quantize_params(hand, islx_scales["hand"])
    for mt, got, want in (("body25", qb, jqb), ("hand", qh, jqh)):
        for name, v in islx_scales[mt].items():
            np.testing.assert_allclose(port_scales[mt][name], v, rtol=1e-4,
                                       err_msg=name)
        want = W.from_islx_params(jax.tree.map(np.asarray, want))
        assert set(got) == set(want)
        for name in want:
            assert got[name].keys() == want[name].keys(), name
            for k in want[name]:
                assert torch.equal(got[name][k], want[name][k]), (name, k)
    assert xb.shape == (2, 184, 248, 3)

    ref = _port_pipe(params)                 # the small setup's configs
    tp = TBP.FusedPosePipeline(qb, qh, pose_cfg=ref.body.cfg,
                               hand_cfg=ref.hand.cfg,
                               compute_dtype=torch.float32, device="cpu")
    ref = _islx_pipe(params)
    jp = JBP.FusedPosePipeline(jqb, jqh, pose_cfg=ref.body.cfg,
                               hand_cfg=ref.hand.cfg,
                               compute_dtype=jax.numpy.float32)
    frames = np.stack(_frames(9, [(48, 48)] * 2))
    got = tp.device_step(frames).numpy()
    want = np.asarray(jp.device_step(frames))
    _same_steps([(frames, got)], [(frames, want)], 2)


def test_quantize_cli_needs_a_gpu_unless_asked(monkeypatch, clip, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        TQCLI.main(["w.npz", str(tmp_path / "o.pt"), "--model-type",
                    "hand", "--calib", clip])


def test_quantize_cli_wants_a_pt_out(clip, tmp_path, capsys):
    """OUT names the state file itself, so it ends in .pt; another name
    is refused before any weights are read."""
    with pytest.raises(SystemExit):
        TQCLI.main(["missing.npz", str(tmp_path / "o"), "--model-type",
                    "hand", "--calib", clip, "--device", "cpu"])
    assert "OUT must end in .pt" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
