"""The int8 fused pose step on the CPU: islx_torch's FusedPosePipeline with
int8 W8A8 CPMs against islx's, for both hand configs the gates choose
between (160 px / 5 stages, the recorded GO; 184 px / 6 stages).

The slice test's size and pattern (tests/test_torch_slice.py): B=2 48x48
frames, full-width seeded ``init_params`` with the arm joints' heat bias
raised, f32 compute. islx's ``quantize_model`` calibrates both nets on the
frames and the quantized params are carried across, so both packages run
the very same int8 weights and scales.

Every integer plane of the packed buffer must be word-equal to islx's
unchanged step; the f16 score words agree within one f16 rounding (as in
the slice test). The hand crops' cubic resize sums in XLA's order
(``islx_torch.ops.resize.SUM_ORDER``), so the crops the int8 hand CPM sees
are islx's words (``test_crop_rounding_is_the_only_hand_difference``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.models import quant as JQ
from islx.pipeline import batch_pose as JBP
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.ops import conv_q as CQ
from islx_torch.pipeline import batch_pose as TBP

POSE = dict(max_peaks=8, thre2=-0.5)
B, HB, WB = 2, 48, 48


@pytest.fixture(scope="module")
def frames():
    return (np.random.RandomState(0).rand(B, HB, WB, 3) * 255
            ).astype(np.uint8)


@pytest.fixture(scope="module")
def quantized(frames):
    """islx's int8 params of both nets, calibrated on the frames."""
    body = jax.tree.map(np.asarray,
                        JC.init_params("body25", jax.random.PRNGKey(1)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(2)))
    b = np.array(body["Mconv7_stage1_L1"]["b"])
    b[2:8] += 1.0                        # shoulders, elbows, wrists present
    body["Mconv7_stage1_L1"]["b"] = b
    x = frames.astype(np.float32) / 256.0 - 0.5
    return (jax.tree.map(np.asarray, JQ.quantize_model(body, "body25", [x])),
            jax.tree.map(np.asarray, JQ.quantize_model(hand, "hand", [x])))


def _steps(quantized, frames, size, stages):
    """-> (islx's packed buffer, the port's, the port's pipeline)."""
    qbody, qhand = quantized
    scale = (size / 368.0,)
    jp = JBP.FusedPosePipeline(qbody, qhand, pose_cfg=JPose(**POSE),
                               hand_cfg=JHand(scale_search=scale,
                                              stages=stages),
                               compute_dtype=jnp.float32)
    tp = TBP.FusedPosePipeline(W.from_islx_params(qbody),
                               W.from_islx_params(qhand),
                               pose_cfg=PoseConfig(**POSE),
                               hand_cfg=HandConfig(scale_search=scale,
                                                   stages=stages),
                               compute_dtype=torch.float32, device="cpu")
    assert tp.body.net.quantized and tp.hand.net.quantized
    with torch.no_grad():
        heat = tp.body.net(torch.from_numpy(frames).float() / 256.0 - 0.5,
                           torch.float32)[1]
    thre1 = float(np.quantile(heat[..., :25].numpy(), 0.9))
    flat = frames.reshape(-1)
    want = np.asarray(jp.device_step_flat(jnp.asarray(flat), B, HB, WB,
                                          (HB, WB), thre1))
    before = CQ.conv_q.launches
    got = tp.device_step_flat(tp.upload_frames(flat), B, HB, WB, (HB, WB),
                              thre1).numpy()
    assert CQ.conv_q.launches == before       # the plain version on the CPU
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    return want, got


@pytest.mark.parametrize("size,stages", [(160, 5), (184, 6)])
def test_int8_fused_step_word_equal(monkeypatch, quantized, frames, size,
                                    stages):
    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    want, got = _steps(quantized, frames, size, stages)
    planes, gplanes = _planes(want), _planes(got)
    for name, wpl in planes.items():
        if name in ("score", "cscore"):
            ws, gs = TBP._unpackf16x2(wpl), TBP._unpackf16x2(gplanes[name])
            np.testing.assert_array_equal(np.isinf(ws), np.isinf(gs))
            fin = np.isfinite(ws)
            np.testing.assert_allclose(ws[fin], gs[fin], rtol=2 ** -10,
                                       atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(gplanes[name], wpl, err_msg=name)
    # the inputs exercise every stage: peaks, connections, both hands
    assert planes["count"].sum() > 20 and planes["ok"].any()
    assert (planes["boxes"][:, 3] > 0).sum() >= 2
    assert (planes["hand_xy"] != 0).sum() >= 10


def test_crop_rounding_is_the_only_hand_difference(monkeypatch, quantized,
                                                   frames):
    """The crops that islx's unchanged step (160 px / 5 stages) cuts from
    its hand boxes, and that its int8 hand CPM amplifies a rounding apart
    in, are word-equal to the port's before and after the rounding to
    integers, at every crop of the step; the body planes, boxes and hand
    planes are word-equal too."""
    from islx.ops.resize import dynamic_crop_resize_batch as islx_crops

    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    want, got = _steps(quantized, frames, 160, 5)
    planes, gplanes = _planes(want), _planes(got)
    for name in ("xy", "count", "pair", "ok", "boxes", "hand_xy",
                 "hand_found"):
        np.testing.assert_array_equal(gplanes[name], planes[name],
                                      err_msg=name)
    b = planes["boxes"]
    assert (b[:, 3] > 0).sum() >= 2
    args = (b[:, 0], b[:, 1], b[:, 2], np.maximum(b[:, 3], 1))
    f = jax.jit(islx_crops, static_argnums=(5, 6))
    for saturate in (False, True):
        jcrop = np.asarray(f(jnp.asarray(frames), *map(jnp.asarray, args),
                             160, saturate))
        tcrop = TBP.dynamic_crop_resize_batch(
            torch.from_numpy(frames), *(torch.from_numpy(np.array(v))
                                        for v in args), 160,
            saturate).numpy()
        np.testing.assert_array_equal(tcrop.view(np.uint32),
                                      jcrop.view(np.uint32))


def _planes(buf: np.ndarray) -> dict:
    """The bits16 buffer's planes by name (islx_torch.pipeline.batch_pose),
    boxes and hand planes one row a crop; ``ok`` from the connection
    scores' -inf sentinel."""
    c, k, l, m = 25, 8, 24, 48
    sizes = [B * c * k, B * c * k // 2, B * c, B * l * m // 4,
             B * l * m // 2, B * 2 * 4, B * 2 * 21, B * 2]
    names = ["xy", "score", "count", "pair", "cscore", "boxes", "hand_xy",
             "hand_found"]
    out = dict(zip(names, np.split(buf, np.cumsum(sizes)[:-1])))
    out["ok"] = TBP._unpackf16x2(out["cscore"]) > -6e4
    out["boxes"] = out["boxes"].reshape(-1, 4)
    out["hand_xy"] = out["hand_xy"].reshape(-1, 21)
    return out
