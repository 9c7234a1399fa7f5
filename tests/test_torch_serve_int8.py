"""The live int8 swap of the port's MicroBatcher against islx's, on the CPU,
in the small setup of tests/test_torch_serve.py (max_batch 2, 48x48
requests at target_h 48, 92 px crops, f32).

Both batchers serve the same first batch in float, calibrate on it, build
their int8 W8A8 pipelines in the background, warm them and switch; then
both serve the same next batch in int8. Each calibration computes the
same activation maxima, but the float convs behind them sum in other
orders, so the port's scales agree with islx's within rtol 1e-4
(tests/test_torch_quant.py). The port's swap runs its own calibration,
which is held to that tolerance, and then quantizes with islx's scales:
from there on, every int8 step's integer planes and the served results
must be islx's words (the f16 score words within one f16 rounding).
"""
import time

import numpy as np
import pytest
import torch

from islx.models import quant as JQ
from islx.pipeline import batch_pose as JBP
from islx.serve import MicroBatcher as JMicroBatcher
from islx_torch.models import quant as TQ
from islx_torch.pipeline import batch_pose as TBP
from islx_torch.serve import MicroBatcher
from test_torch_serve import (_frames, _islx_pipe, _port_pipe, _record_steps,
                              _same_results, _same_steps, params)  # noqa: F401

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


def _swap_then_serve(batcher, first, then):
    """Serve ``first`` (float), wait for the int8 swap, serve ``then``."""
    try:
        for f in [batcher.submit(x) for x in first]:
            f.result(timeout=600)
        batcher._quant_thread.join(timeout=600)
        assert not batcher._quant_thread.is_alive()
        deadline = time.time() + 600
        while not batcher.stats()["quantized"]:
            assert time.time() < deadline, "quantized swap never landed"
            batcher.submit(first[0]).result(timeout=600)
        futs = [batcher.submit(x) for x in then]
        return [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()


def test_int8_swap_serves_islx_words(monkeypatch, params):
    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    first, then = _frames(3, [(48, 48)] * 2), _frames(9, [(48, 48)] * 2)
    kw = dict(max_batch=2, max_wait_ms=200.0, target_h=48,
              quantize_after=2)

    islx_scales = {}
    real_j = JQ.calibrate_scales

    def islx_calibrate(p, model_type, batches, *a, **k):
        islx_scales[model_type] = real_j(p, model_type, batches, *a, **k)
        return islx_scales[model_type]

    monkeypatch.setattr(JQ, "calibrate_scales", islx_calibrate)
    jsteps = _record_steps(JBP.FusedPosePipeline, monkeypatch)
    want = _swap_then_serve(JMicroBatcher(_islx_pipe(params), **kw), first,
                            then)
    assert sorted(islx_scales) == ["body25", "hand"]

    port_scales = {}
    real_t = TQ.calibrate_scales

    def port_calibrate(state, model_type, batches, *a, **k):
        port_scales[model_type] = real_t(state, model_type, batches, *a, **k)
        return islx_scales[model_type]

    monkeypatch.setattr(TQ, "calibrate_scales", port_calibrate)
    tp = _port_pipe(params)
    tbatcher = MicroBatcher(tp, **kw)
    tsteps = _record_steps(TBP.FusedPosePipeline, monkeypatch)
    got = _swap_then_serve(tbatcher, first, then)

    assert len(tbatcher.calibrated_on) == 2
    np.testing.assert_array_equal(np.stack(tbatcher.calibrated_on),
                                  np.stack(first))
    for mt, want_scales in islx_scales.items():
        assert sorted(port_scales[mt]) == sorted(want_scales)
        for name, v in want_scales.items():
            np.testing.assert_allclose(port_scales[mt][name], v, rtol=1e-4,
                                       err_msg=f"{mt} {name}")
    assert tbatcher.pipe is not tp and tbatcher.pipe.body.net.quantized
    # the float steps, then at least the int8 step of ``then`` on each side
    assert tsteps[-1][0].shape == jsteps[-1][0].shape == (2, 48, 48, 3)
    _same_steps(tsteps[-1:], jsteps[-1:], 2)
    _same_steps(tsteps[:1], jsteps[:1], 2)
    _same_results(got, want)
    assert sum(len(r.candidate) for r in got) > 10
    assert sum(len(r.hands) for r in got) >= 1
