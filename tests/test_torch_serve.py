"""The port's serving path on the CPU (islx_torch.serve, islx_torch.cli.serve)
against islx's (islx/serve) and islx's own serve tests (tests/test_serve.py).

The small setup of tests/test_torch_slice.py: full-width seeded
``init_params`` with the arm joints' heat bias raised (so both hands fire),
``max_peaks=8``, ``thre2=-0.5``, thre1 at the 90th percentile of the
frames' joint heatmaps, 92 px crops, f32, ``target_h=48``. Each of islx's
ten serve tests has a case here, from the same seeds. The parity cases
send the same requests through islx's MicroBatcher (``ISLX_PALLAS_MASK=1``)
and the port's: the integer planes of every step's packed buffer are
word-equal, and so are the served results but for the f16 score words,
which agree within one f16 rounding (as in the slice test). A crop resize
at a shape with no probed summation order fails these tests (its warning
is an error here).
"""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.pipeline import batch_pose as JBP
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.pipeline import batch_pose as TBP
from islx_torch.serve import MicroBatcher, PoseServer

pytestmark = pytest.mark.filterwarnings(
    "error:dynamic_crop_resize_batch:UserWarning")


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

HAND = dict(scale_search=(0.25,))        # 92 px crops


def _frames(seed, shapes):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes]


@pytest.fixture(scope="module")
def params():
    """islx's full-width params of both nets and the calibrated thre1."""
    body = jax.tree.map(np.asarray,
                        JC.init_params("body25", jax.random.PRNGKey(1)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(2)))
    b = np.array(body["Mconv7_stage1_L1"]["b"])
    b[2:8] += 1.0                        # shoulders, elbows, wrists present
    body["Mconv7_stage1_L1"]["b"] = b
    net = W.build("body25", W.from_islx_params(body), "cpu", torch.float32)
    x = np.stack(_frames(0, [(48, 48)] * 4))
    with torch.no_grad():
        heat = net(torch.from_numpy(x).float() / 256.0 - 0.5)[1]
    pose = dict(max_peaks=8, thre2=-0.5,
                thre1=float(np.quantile(heat[..., :25].numpy(), 0.9)))
    return body, hand, pose


def _port_pipe(params):
    body, hand, pose = params
    return TBP.FusedPosePipeline(W.from_islx_params(body),
                                 W.from_islx_params(hand),
                                 pose_cfg=PoseConfig(**pose),
                                 hand_cfg=HandConfig(**HAND),
                                 compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def pipe(params):
    return _port_pipe(params)


def _islx_pipe(params):
    body, hand, pose = params
    return JBP.FusedPosePipeline(body, hand, pose_cfg=JPose(**pose),
                                 hand_cfg=JHand(**HAND),
                                 compute_dtype=jnp.float32)


def _record_steps(cls, monkeypatch):
    """-> the list of (bucketed frames, packed buffer) of every step that a
    ``cls`` pipeline's ``device_step`` runs from now on (a served batch;
    the int8 swap's warm-up steps go by other calls)."""
    steps = []
    real = cls.device_step

    def recording(self, frames, orig_hw=None, thre1=None):
        out = real(self, frames, orig_hw, thre1)
        packed = out.numpy() if isinstance(out, torch.Tensor) else \
            np.asarray(out)
        steps.append((frames.copy(), packed))
        return out

    monkeypatch.setattr(cls, "device_step", recording)
    return steps


def _planes(buf, b, c=25, l=24):
    """The bits16 buffer's planes by name (islx_torch.pipeline.batch_pose):
    ``c`` joints and ``l`` limbs (BODY_25's by default; COCO's 18, 19)."""
    k, m = 8, 48
    sizes = [b * c * k, b * c * k // 2, b * c, b * l * m // 4,
             b * l * m // 2, b * 2 * 4, b * 2 * 21, b * 2]
    names = ["xy", "score", "count", "pair", "cscore", "boxes", "hand_xy",
             "hand_found"]
    return dict(zip(names, np.split(buf, np.cumsum(sizes)[:-1])))


def _same_steps(got, want, b, c=25, l=24):
    """Step by step: the same frames, integer planes word-equal, the f16
    score words within one f16 rounding."""
    assert len(got) == len(want) > 0
    for (gf, gbuf), (wf, wbuf) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        assert gbuf.dtype == wbuf.dtype == np.int32
        assert gbuf.shape == wbuf.shape
        gp, wp = _planes(gbuf, b, c, l), _planes(wbuf, b, c, l)
        for name, wpl in wp.items():
            if name in ("score", "cscore"):
                ws = TBP._unpackf16x2(wpl)
                gs = TBP._unpackf16x2(gp[name])
                np.testing.assert_array_equal(np.isinf(ws), np.isinf(gs))
                fin = np.isfinite(ws)
                np.testing.assert_allclose(gs[fin], ws[fin], rtol=2 ** -10,
                                           atol=1e-7, err_msg=name)
            else:
                np.testing.assert_array_equal(gp[name], wpl, err_msg=name)


def _same_results(got, want):
    """PoseResults: coordinates, ids, subsets' part columns and hands
    equal; scores within one f16 rounding."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.candidate[:, [0, 1, 3]],
                                      w.candidate[:, [0, 1, 3]])
        np.testing.assert_allclose(g.candidate[:, 2], w.candidate[:, 2],
                                   rtol=2 ** -10, atol=1e-7)
        np.testing.assert_array_equal(g.subset[:, :-2], w.subset[:, :-2])
        np.testing.assert_allclose(g.subset[:, -2:], w.subset[:, -2:],
                                   rtol=1e-3)
        assert len(g.hands) == len(w.hands)
        for gh, wh in zip(g.hands, w.hands):
            np.testing.assert_array_equal(gh, wh)


# ---------------------------------------------------------------------------
# islx's ten serve tests, on the port


def test_batcher_batches_concurrent_requests(pipe):
    b = MicroBatcher(pipe, max_batch=4, max_wait_ms=300.0, target_h=48)
    try:
        frames = _frames(0, [(96, 96)] * 4)
        futs = [b.submit(f) for f in frames]     # before the worker wakes
        results = [f.result(timeout=300) for f in futs]
        for r in results:
            assert r.candidate.shape[1] == 4
            assert isinstance(r.hands, list)
        stats = b.stats()
        assert stats["requests"] == 4
        assert stats["batches"] <= 2              # shared device steps
        assert stats["latency_window_n"] == 4
        assert 0.0 < stats["latency_ms_p50_request"] <= \
            stats["latency_ms_p99_request"]
    finally:
        b.close()


def test_batcher_mixed_resolutions(pipe):
    b = MicroBatcher(pipe, max_batch=2, max_wait_ms=50.0, target_h=48)
    try:
        f1, f2 = _frames(1, [(96, 96), (64, 96)])
        r1, r2 = b.submit(f1), b.submit(f2)
        assert r1.result(timeout=300).subset is not None
        assert r2.result(timeout=300).subset is not None
        assert b.stats()["batches"] >= 2          # one step a bucket
    finally:
        b.close()


def test_http_pose_endpoint(pipe):
    """A JPEG POST round trip from two clients at once, /healthz, and the
    400 and 404 replies; the server keeps serving after each."""
    import cv2

    server = PoseServer(pipe, port=0, max_batch=2, max_wait_ms=20.0)
    server.batcher.target_h = 48
    server.start()
    try:
        img = _frames(2, [(96, 96)])[0]
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        url = f"http://127.0.0.1:{server.port}"
        results = {}

        def post(name):
            req = urllib.request.Request(f"{url}/pose", data=buf.tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                results[name] = json.loads(resp.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert len(results) == 2
        want = server.batcher.pose(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                                   timeout=300)
        for r in results.values():
            assert set(r) == {"candidate", "subset", "hands"}
            np.testing.assert_allclose(np.array(r["candidate"]).reshape(
                -1, 4), want.candidate)
            assert [np.array(h).tolist() for h in r["hands"]] == \
                [h.tolist() for h in want.hands]

        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests"] >= 3

        for path, data, code in (("/pose", b"not an image", 400),
                                 ("/other", b"x", 404)):
            req = urllib.request.Request(f"{url}{path}", data=data,
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == code
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/nothing", timeout=30)
        assert ei.value.code == 404
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["ok"]
    finally:
        server.close()


def test_live_traffic_int8_calibration(params):
    """quantize_after: the batcher calibrates on served frames, builds the
    int8 pipeline in the background (the float pipeline keeps serving) and
    switches between batches; requests resolve throughout."""
    b = MicroBatcher(_port_pipe(params), max_batch=2, max_wait_ms=50.0,
                     target_h=48, quantize_after=2)
    try:
        frames = _frames(3, [(96, 96)] * 4)
        for f in [b.submit(f) for f in frames[:2]]:
            assert f.result(timeout=600).candidate.shape[1] == 4
        deadline = time.time() + 600
        while not b.stats()["quantized"]:
            assert time.time() < deadline, "quantized swap never landed"
            assert "quantize_error" not in b.stats()
            assert b.submit(frames[2]).result(
                timeout=600).candidate.shape[1] == 4
            time.sleep(0.2)
        fut = b.submit(frames[3])                 # served by int8
        assert fut.result(timeout=600).candidate.shape[1] == 4
        assert b.pipe.body.net.quantized and b.pipe.hand.net.quantized
        assert any("w_q" in e for e in b.pipe.body.params.values())
        assert len(b.calibrated_on) == 2
    finally:
        b.close()


def test_program_cache_eviction(params):
    """max_resolutions bounds the live buckets under mixed traffic; an
    evicted bucket still serves."""
    b = MicroBatcher(_port_pipe(params), max_batch=2, max_wait_ms=10.0,
                     target_h=48, max_resolutions=2)
    try:
        shapes = [(96, 96), (64, 96), (80, 96), (96, 96)]
        for f in _frames(5, shapes):
            assert b.submit(f).result(timeout=600).subset is not None
        assert len(b._res_lru) <= 2
        assert b.stats().get("programs_evicted", 0) >= 1
        keys = b.pipe.program_keys()
        assert len(keys) <= 2
        assert {k[1:3] for k in keys} == set(b._res_lru)
    finally:
        b.close()


def test_int8_calibration_survives_mixed_resolutions(params):
    """Mixed-resolution traffic does not break the swap: the calibration
    sample keeps the first-seen bucket; serving goes on either way."""
    b = MicroBatcher(_port_pipe(params), max_batch=2, max_wait_ms=50.0,
                     target_h=48, quantize_after=3)
    try:
        futs = [b.submit(f) for f in _frames(
            4, [(96, 96), (64, 96), (96, 96), (96, 96)])]
        for f in futs:
            assert f.result(timeout=600).candidate.shape[1] == 4
        b._quant_thread.join(timeout=600)
        assert "quantize_error" not in b.stats()
        assert {f.shape for f in b.calibrated_on} == {(48, 48, 3)}
    finally:
        b.close()


def test_int8_swap_warms_each_served_shape_once(monkeypatch, params):
    """The swap's warm-up runs one step a served (batch, bucket, format):
    96x96 and 48x48 frames share the 48x48 bucket at other scales, so
    three served keys take two warm steps."""
    pipe = _port_pipe(params)
    warm = []
    real = TBP.FusedPosePipeline.device_step_flat

    def counting(self, flat, b, hb, wb, orig_hw, thre1=None,
                 input_format="bgr"):
        if self is not pipe:
            warm.append((b, hb, wb, input_format))
        return real(self, flat, b, hb, wb, orig_hw, thre1, input_format)

    monkeypatch.setattr(TBP.FusedPosePipeline, "device_step_flat", counting)
    b = MicroBatcher(pipe, max_batch=1, max_wait_ms=10.0, target_h=48,
                     quantize_after=4)
    try:
        for f in _frames(6, [(96, 96), (48, 48), (64, 96), (96, 96)]):
            assert b.submit(f).result(timeout=600).subset is not None
        b._quant_thread.join(timeout=600)
        assert "quantize_error" not in b.stats()
        assert len(pipe.program_keys()) == 3
        assert warm == [(1, 48, 48, "bgr"), (1, 48, 72, "bgr")]
    finally:
        b.close()


def test_submit_after_close_fails_fast(pipe):
    b = MicroBatcher(pipe, max_batch=2, max_wait_ms=10.0, target_h=48)
    b.close()
    fut = b.submit(np.zeros((96, 96, 3), np.uint8))
    assert fut.done()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=0)


def test_cancelled_future_does_not_poison_batch(pipe):
    """A client cancelling its future mid-flight must not break the other
    requests of the same batch."""
    # two submits of max_batch 3: the worker sits out the 3 s window, so
    # cancel() lands before the batch resolves
    b = MicroBatcher(pipe, max_batch=3, max_wait_ms=3000.0, target_h=48)
    try:
        f1, f2 = (b.submit(f) for f in _frames(6, [(96, 96)] * 2))
        won = f1.cancel()
        assert f2.result(timeout=600).candidate.shape[1] == 4
        if won:
            assert f1.cancelled()
        else:
            assert f1.done()
    finally:
        b.close()


def test_batching_window_ends_on_full_batch(pipe):
    """A burst that fills max_batch dispatches at once instead of sleeping
    out the 30 s window."""
    b = MicroBatcher(pipe, max_batch=2, max_wait_ms=30000.0, target_h=48)
    try:
        frames = _frames(7, [(96, 96)] * 4)
        for f in [b.submit(x) for x in frames[:2]]:
            assert f.result(timeout=600).candidate.shape[1] == 4
        t0 = time.monotonic()
        for f in [b.submit(x) for x in frames[2:]]:
            assert f.result(timeout=600).candidate.shape[1] == 4
        assert time.monotonic() - t0 < 15.0     # << the 30 s window
    finally:
        b.close()


def test_http_body_size_cap(pipe):
    server = PoseServer(pipe, port=0, max_batch=2, max_wait_ms=10.0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/pose",
            data=b"\0" * (33 * 1024 * 1024), method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 413
    finally:
        server.close()


# ---------------------------------------------------------------------------
# the port against islx


def _serve(batcher, frames, timeout=600):
    try:
        futs = [batcher.submit(f) for f in frames]
        return [f.result(timeout=timeout) for f in futs]
    finally:
        batcher.close()


def test_served_results_equal_islx(monkeypatch, params):
    """Three requests, one of them 64x96 (a real cv2 resize to the 48x72
    bucket): islx's batcher and the port's run the same two steps, with
    the same frames, word-equal integer planes and the same results."""
    from islx.serve import MicroBatcher as JMicroBatcher

    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    frames = _frames(8, [(96, 96), (64, 96), (96, 96)])
    jp, tp = _islx_pipe(params), _port_pipe(params)
    jsteps = _record_steps(JBP.FusedPosePipeline, monkeypatch)
    tsteps = _record_steps(TBP.FusedPosePipeline, monkeypatch)
    # max_batch 4 and a 2 s window: the three requests are queued before
    # it ends, so both batchers serve [0, 2] then [1]
    kw = dict(max_batch=4, max_wait_ms=2000.0, target_h=48)
    want = _serve(JMicroBatcher(jp, **kw), frames)
    got = _serve(MicroBatcher(tp, **kw), frames)
    assert [s[0].shape[1:3] for s in tsteps] == [(48, 48), (48, 72)]
    _same_steps(tsteps, jsteps, 4)
    _same_results(got, want)
    assert sum(len(r.candidate) for r in got) > 20
    assert sum(len(r.hands) for r in got) >= 2


@pytest.fixture(scope="module")
def coco_params():
    """islx's full-width COCO params (the arm joints' final heat raised by
    1, as tests/test_torch_coco.py), islx's hand params and a thre1 at the
    90th percentile of the frames' COCO joint heatmaps."""
    body = jax.tree.map(np.asarray,
                        JC.init_params("coco", jax.random.PRNGKey(11)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(2)))
    b = np.array(body["Mconv7_stage6_L2"]["b"])
    b[2:8] += 1.0
    body["Mconv7_stage6_L2"]["b"] = b
    net = W.build("coco", W.from_islx_params(body), "cpu", torch.float32)
    x = np.stack(_frames(0, [(48, 48)] * 4))
    with torch.no_grad():
        heat = net(torch.from_numpy(x).float() / 256.0 - 0.5)[1]
    pose = dict(model_type="coco", max_peaks=8, thre2=-0.5,
                thre1=float(np.quantile(heat[..., :18].numpy(), 0.9)))
    return body, hand, pose


def test_served_coco_burst_equals_direct_steps(monkeypatch, coco_params):
    """A burst of four COCO frames served in one B=4 step equals a direct
    ``FusedPosePipeline(..., "coco")`` step on the same frames word for
    word, and islx's COCO step on its integer planes (scores within one
    f16 rounding)."""
    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    body, hand, pose = coco_params
    tp = TBP.FusedPosePipeline(W.from_islx_params(body),
                               W.from_islx_params(hand), "coco",
                               pose_cfg=PoseConfig(**pose),
                               hand_cfg=HandConfig(**HAND),
                               compute_dtype=torch.float32, device="cpu")
    jp = JBP.FusedPosePipeline(body, hand, "coco", pose_cfg=JPose(**pose),
                               hand_cfg=JHand(**HAND),
                               compute_dtype=jnp.float32)
    frames = _frames(12, [(96, 96)] * 4)
    calls = []
    real = TBP.FusedPosePipeline.device_step

    def recording(self, frames, orig_hw=None, thre1=None):
        out = real(self, frames, orig_hw, thre1)
        calls.append((frames.copy(), orig_hw, thre1, out.numpy()))
        return out

    monkeypatch.setattr(TBP.FusedPosePipeline, "device_step", recording)
    got = _serve(MicroBatcher(tp, max_batch=4, max_wait_ms=2000.0,
                              target_h=48), frames)
    monkeypatch.setattr(TBP.FusedPosePipeline, "device_step", real)
    assert len(calls) == 1 and calls[0][0].shape == (4, 48, 48, 3)
    bucketed, orig_hw, thre1, served = calls[0]
    direct = tp.device_step(bucketed, orig_hw, thre1).numpy()
    np.testing.assert_array_equal(served, direct)
    tsteps = [(bucketed, served)]
    want = [(bucketed, np.asarray(jp.device_step(bucketed, orig_hw, thre1)))]
    _same_steps(tsteps, want, 4, c=18, l=19)
    assert sum(len(r.candidate) for r in got) > 10
    assert all(r.candidate.shape[1] == 4 for r in got)


def test_cli_serves_coco(monkeypatch):
    """``--model-type coco`` parses and builds a COCO fused pipeline."""
    from islx_torch.cli import serve as cli

    monkeypatch.delenv("ISLX_INT8", raising=False)
    seen = {}

    def interrupt(self):
        seen["pipe"] = self.batcher.pipe
        raise KeyboardInterrupt

    monkeypatch.setattr(PoseServer, "serve_forever", interrupt)
    monkeypatch.setattr(PoseServer, "close", lambda self: None)
    cli.main(["--port", "0", "--device", "cpu", "--model-type", "coco"])
    pipe = seen["pipe"]
    assert pipe.model_type == "coco"
    assert pipe.body.cfg.njoint == 19
    assert pipe.body.limb_seq.shape[0] == 19


def test_cli_gate(monkeypatch, tmp_path):
    """The serve CLI's int8 gate: an explicit --int8-after wins; a recorded
    GO gives 256; ISLX_INT8 decides whenever it is set, also without
    --hand-weights (islx's serve CLI ignores it there); without either no
    verdict is borrowed from ISLX_WEIGHTS_DIR."""
    from islx_torch.cli.serve import int8_after_for

    for var in ("ISLX_INT8", "ISLX_WEIGHTS_DIR"):
        monkeypatch.delenv(var, raising=False)
    go, nogo = tmp_path / "go", tmp_path / "nogo"
    for d, v in ((go, "GO"), (nogo, "NO-GO")):
        d.mkdir()
        (d / "gates.json").write_text(json.dumps({"int8_default": v}))
    hw_go, hw_nogo = str(go / "hand.npz"), str(nogo / "hand.npz")
    monkeypatch.setenv("ISLX_WEIGHTS_DIR", str(go))
    assert int8_after_for(None, None) is None
    assert int8_after_for(None, hw_go) == 256
    assert int8_after_for(None, hw_nogo) is None
    assert int8_after_for(64, hw_nogo) == 64
    monkeypatch.setenv("ISLX_INT8", "1")
    assert int8_after_for(None, None) == 256
    assert int8_after_for(None, hw_nogo) == 256
    monkeypatch.setenv("ISLX_INT8", "0")
    assert int8_after_for(None, hw_go) is None
    assert int8_after_for(None, None) is None
    assert int8_after_for(32, hw_go) == 32


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, capsys):
    """Without a GPU the CLI raises before it builds anything; with
    --device cpu it builds the pipeline and serves until interrupted."""
    from islx_torch.cli import serve as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ISLX_INT8", raising=False)
    with pytest.raises(RuntimeError, match="no.*GPU|none is available"):
        cli.main(["--port", "0"])
    seen = {}

    def interrupt(self):
        seen["pipe"] = self.batcher.pipe
        self.start()       # the real loop, on a thread close() can stop
        raise KeyboardInterrupt

    monkeypatch.setattr(PoseServer, "serve_forever", interrupt)
    cli.main(["--port", "0", "--device", "cpu", "--max-batch", "2"])
    assert seen["pipe"].device.type == "cpu"
    assert dataclasses.asdict(seen["pipe"].hand.cfg) == dataclasses.asdict(
        HandConfig.production())
    assert "serving on http://127.0.0.1:" in capsys.readouterr().out
