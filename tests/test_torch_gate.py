"""The CLIs' int8 gate against islx's on the CPU (islx/cli/__init__.py,
islx/cli/translate.py, islx/cli/extract.py):

* the calibration inputs are cv2's ``INTER_CUBIC`` resizes of the clip's
  frames, word for word the arrays islx's ``gated_int8_params`` builds, and
  the activation scales of the port's gate equal islx's within the rtol
  1e-4 of tests/test_torch_quant.py::test_calibrate_scales_matches_islx
  (the float convs sum in another order);
* the translate CLIs consult the gate only when both nets' weights are
  given: with ``ISLX_INT8=1`` and no weights, both run bf16; with both
  weight files, both gate.
"""
import numpy as np
import pytest
import torch

import islx.cli as JGate
from islx.cli import translate as JCLI
from islx.core import weights as JW
from islx.core.config import HandConfig as JHand
from islx.models import quant as JQ
from islx.pipeline import translate as JPipe
from islx.pipeline.batch_pose import bucket_for
import islx_torch.cli as TGate
from islx_torch.cli import translate as TCLI
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig
from islx_torch.models import quant as TQ
from islx_torch.pipeline import translate as TPipe


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores, and more threads a process
    oversubscribe them (six concurrent copies of a torch-only test ran
    ~10x slower with the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

cv2 = pytest.importorskip("cv2")


def write_clip(path, h, w, n=6):
    rng = np.random.RandomState(h * w)
    base = (rng.rand(h // 4, w // 4, 3) * 255).astype(np.uint8)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 15, (w, h))
    for i in range(n):
        out.write(cv2.resize(np.roll(base, i, axis=1), (w, h),
                             interpolation=cv2.INTER_CUBIC))
    out.release()
    return path


def islx_calib_inputs(frames, hand_cfg):
    """The arrays islx's gated_int8_params calibrates on
    (islx/cli/__init__.py:649-659)."""
    h0, w0 = frames[0].shape[:2]
    hb, wb = bucket_for(h0, w0, target_h=184)
    hsize = int(np.rint(hand_cfg.scale_search[0] * hand_cfg.boxsize))
    xcal = np.stack([cv2.resize(f, (wb, hb), interpolation=cv2.INTER_CUBIC)
                     for f in frames]).astype(np.float32) / 256.0 - 0.5
    s = min(h0, w0)
    hcal = np.stack([cv2.resize(
        f[(h0 - s) // 2:(h0 + s) // 2, (w0 - s) // 2:(w0 + s) // 2],
        (hsize, hsize), interpolation=cv2.INTER_CUBIC)
        for f in frames]).astype(np.float32) / 256.0 - 0.5
    return xcal, hcal


@pytest.mark.parametrize("h,w,scale", [(720, 1280, 0.5), (480, 640, 0.5),
                                       (720, 720, 160 / 368),
                                       (96, 72, 0.25)])
def test_calib_inputs_word_equal(tmp_path, h, w, scale):
    """Frames of islx's gate (``_calib_frames``) and the port's, and the
    arrays built from them, word-equal, at the sizes where the port's
    former f32 resize rounded values apart."""
    clip = write_clip(str(tmp_path / "c.avi"), h, w)
    frames = TGate._calib_frames(clip)
    jframes = JGate._calib_frames(clip)
    assert len(frames) == len(jframes) == 2
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    got = TGate.calib_inputs(frames, HandConfig(scale_search=(scale,)),
                             device="cpu")
    want = islx_calib_inputs(jframes, JHand(scale_search=(scale,)))
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype == np.float32
        assert g.shape == wnt.shape
        np.testing.assert_array_equal(g, wnt)


def test_calib_inputs_refuse_without_cv2(monkeypatch):
    """Without cv2 the calibration inputs are built all the same, word-equal
    to cv2's INTER_CUBIC resizes of the frames and of their centre squares
    (the port's resize_u8 resizes them)."""
    import builtins

    import cv2

    frame = (np.random.RandomState(3).rand(60, 80, 3) * 255).astype(np.uint8)
    cfg = HandConfig(scale_search=(0.25,))
    hb, wb = bucket_for(60, 80, target_h=184)
    size = int(np.rint(cfg.scale_search[0] * cfg.boxsize))
    want = [cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)[None]
            .astype(np.float32) / 256.0 - 0.5
            for x, h, w in ((frame, hb, wb), (frame[:, 10:70], size, size))]
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    got = TGate.calib_inputs([frame], cfg, device="cpu")
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


def test_gate_scales_match_islx(tmp_path, monkeypatch):
    """``ISLX_INT8=1`` on a clip: the port's gate quantizes both nets with
    activation scales within rtol 1e-4 of islx's gate on the same clip and
    weights."""
    monkeypatch.setenv("ISLX_INT8", "1")
    body, hand = W.init_params("body25", 0), W.init_params("hand", 1)
    clip = write_clip(str(tmp_path / "c.avi"), 96, 48)
    jb, jh, japplied = JGate.gated_int8_params(
        W.to_islx_params(body), W.to_islx_params(hand),
        hand_cfg=JHand(scale_search=(0.25,)), calib_clip=clip)
    tb, th, tapplied = TGate.gated_int8_params(
        body, hand, hand_cfg=HandConfig(scale_search=(0.25,)),
        calib_clip=clip, device="cpu")
    assert japplied and tapplied
    for want, got in ((jb, tb), (jh, th)):
        assert sorted(want) == sorted(got)
        for name, entry in want.items():
            np.testing.assert_allclose(float(got[name]["a_scale"]),
                                       float(entry["a_scale"]), rtol=1e-4,
                                       err_msg=name)


class Recorder:
    """A BatchedTranslatePipeline stand-in: records its weights, predicts
    nothing."""

    made = []

    def __init__(self, body_params=None, hand_params=None, **kw):
        Recorder.made.append((body_params, hand_params))

    def translate_video(self, path):
        return []


@pytest.mark.parametrize("weights", ["none", "hand", "both"])
def test_translate_cli_gates_only_with_both_weights(tmp_path, monkeypatch,
                                                    weights):
    """``ISLX_INT8=1``: islx's and the port's translate CLI (``--batched``)
    call the int8 gate only when both weight files are given; without them
    nothing is quantized and the pipelines get no quantized weights."""
    monkeypatch.setenv("ISLX_INT8", "1")
    clip = write_clip(str(tmp_path / "c.avi"), 48, 48, n=2)
    args = [clip, "--batched"]
    if weights != "none":
        hw = str(tmp_path / "weights.npz")
        (tmp_path / "weights.npz").write_bytes(b"")   # read by the stubs
        args += ["--hand-weights", hw]
        monkeypatch.setattr(JW, "load", lambda p, mt: {"net": mt})
        monkeypatch.setattr(W, "load", lambda p, mt: {"net": mt})
    if weights == "both":
        args += ["--body-weights", hw]
    gated = []

    def gate(name):
        def record(bp, hp, **kw):
            gated.append((name, kw["calib_clip"]))
            return bp, hp, False
        return record

    def refuse(*a, **k):
        raise AssertionError("quantized")

    monkeypatch.setattr(JGate, "gated_int8_params", gate("islx"))
    monkeypatch.setattr(TGate, "gated_int8_params", gate("port"))
    monkeypatch.setattr(JQ, "quantize_model", refuse)
    monkeypatch.setattr(TQ, "quantize_model", refuse)
    monkeypatch.setattr(JPipe, "BatchedTranslatePipeline", Recorder)
    monkeypatch.setattr(TPipe, "BatchedTranslatePipeline", Recorder)
    Recorder.made.clear()
    JCLI.main(args)
    TCLI.main(args + ["--device", "cpu"])
    if weights == "both":
        assert gated == [("islx", clip), ("port", clip)]
    else:
        assert gated == []
    (jb, jh), (tb, th) = Recorder.made
    assert (jb is None, jh is None) == (tb is None, th is None)
    assert (tb is None) == (weights != "both")
