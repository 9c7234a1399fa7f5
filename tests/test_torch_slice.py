"""The whole slice on the CPU: islx_torch's FusedPosePipeline.device_step_flat
against islx's on the same frames and the same full-width weights, in f32.

islx runs its TPU main path (``ISLX_PALLAS_MASK=1``: the Pallas NMS-mask
kernel, in interpret mode on the CPU) or, under ``ISLX_PALLAS_NMS=1``, its
opt-in NMS+first-K kernel; the port reads the same switch. The integer planes of the packed
buffer (peak coordinates, counts, pair indices, hand boxes, hand peaks and
found bits) must be word-equal; the f16 score words agree within one f16
rounding. The inputs are deterministic: the arm-joint heat channels get a
+1 bias so arms chain and both hand crops fire.

For the word-equal comparison the port's step runs islx's jitted f32 CPM
forwards in place of its own nets: the f32 CPMs sum in another order,
which depends on torch's intra-op thread count, and a peak at an NMS
near-tie can flip (ROADMAP.md §3). The port's own CPMs are held to islx's
on the same net inputs within rtol/atol 1e-4, the tolerance of
tests/test_torch_pose.py::test_real_nets_match.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.ops.yuv import bgr_to_yuv420_host
from islx.pipeline import batch_pose as JBP
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.pipeline import batch_pose as TBP


@pytest.fixture(scope="module")
def slice_params():
    """Full-width islx params for both nets, made once for the module."""
    body = jax.tree.map(np.asarray,
                        JC.init_params("body25", jax.random.PRNGKey(1)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(2)))
    b = np.array(body["Mconv7_stage1_L1"]["b"])
    b[2:8] += 1.0                        # shoulders, elbows, wrists present
    body["Mconv7_stage1_L1"]["b"] = b
    return body, hand


POSE = dict(max_peaks=8, thre2=-0.5)
HAND = dict(scale_search=(0.25,))        # 92 px crops


def islx_nets(body, hand):
    """islx's jitted f32 forwards as the port's net callables."""
    fb = jax.jit(lambda p, x: JC.body25_forward(p, x, jnp.float32))
    fh = jax.jit(lambda p, x, s: JC.hand_forward(p, x, jnp.float32, s),
                 static_argnums=2)

    def body_net(x, cd=torch.float32):
        return tuple(torch.from_numpy(np.array(m))
                     for m in fb(body, jnp.asarray(x.numpy())))

    def hand_net(x, cd, stages=6):
        return torch.from_numpy(np.array(fh(hand, jnp.asarray(x.numpy()),
                                            stages)))

    return body_net, hand_net


def thre1_for(net, frames) -> float:
    """The 90th percentile of the joint heatmaps: peaks exist."""
    with torch.no_grad():
        heat = net(torch.from_numpy(frames).float() / 256.0 - 0.5)[1]
    return float(np.quantile(heat[..., :25].numpy(), 0.9))


@pytest.mark.parametrize("input_format", ["bgr", "yuv420"])
def test_fused_step_word_equal(monkeypatch, slice_params, input_format):
    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    _check_word_equal(slice_params, input_format, select=False)


def test_fused_step_select_word_equal(monkeypatch, slice_params):
    """``ISLX_PALLAS_NMS=1``: islx's NMS+first-K Pallas kernel against the
    port's select path (the nms_first_k kernel's plain version here)."""
    monkeypatch.setenv("ISLX_PALLAS_NMS", "1")
    _check_word_equal(slice_params, "yuv420", select=True)


def _check_word_equal(slice_params, input_format, select):
    body, hand = slice_params
    jp = JBP.FusedPosePipeline(body, hand, pose_cfg=JPose(**POSE),
                               hand_cfg=JHand(**HAND),
                               compute_dtype=jnp.float32)
    assert jp.body.pack_mode == "bits16"
    assert (jp.body.pallas_nms, jp.body.pallas_mask) == (select, not select)
    tp = TBP.FusedPosePipeline(W.from_islx_params(body),
                               W.from_islx_params(hand),
                               pose_cfg=PoseConfig(**POSE),
                               hand_cfg=HandConfig(**HAND),
                               compute_dtype=torch.float32, device="cpu")
    assert tp.body.pallas_nms == select
    b, hb, wb = 2, 48, 48
    frames = (np.random.RandomState(0).rand(b, hb, wb, 3) * 255
              ).astype(np.uint8)
    # the port's CPMs against islx's on the step's net inputs, and on
    # 92 px hand crops
    body_net, hand_net = islx_nets(body, hand)
    x = torch.from_numpy(frames).float() / 256.0 - 0.5
    crops = torch.from_numpy(np.random.RandomState(1).rand(
        4, 92, 92, 3).astype(np.float32) - 0.5)
    with torch.no_grad():
        for g, w in zip(tp.body.net(x, torch.float32),
                        body_net(x, torch.float32)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(
            tp.hand.net(crops, torch.float32).numpy(),
            hand_net(crops, torch.float32).numpy(), rtol=1e-4, atol=1e-4)
    tp.body.net, tp.hand.net = body_net, hand_net
    thre1 = thre1_for(tp.body.net, frames)
    flat = frames.reshape(-1)
    if input_format == "yuv420":
        flat = bgr_to_yuv420_host(frames)
    want = np.asarray(jp.device_step_flat(jnp.asarray(flat), b, hb, wb,
                                          (hb, wb), thre1,
                                          input_format=input_format))
    got = tp.device_step_flat(tp.upload_frames(flat), b, hb, wb, (hb, wb),
                              thre1, input_format=input_format).numpy()
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape

    # word planes of the bits16 buffer (see islx_torch.pipeline.batch_pose)
    c, k, l, m = 25, 8, 24, 48
    sizes = [b * c * k, b * c * k // 2, b * c, b * l * m // 4,
             b * l * m // 2, b * 2 * 4, b * 2 * 21, b * 2]
    names = ["xy", "score", "count", "pair", "cscore", "boxes", "hand_xy",
             "hand_found"]
    cut = np.cumsum(sizes)[:-1]
    for name, wpl, gpl in zip(names, np.split(want, cut), np.split(got, cut)):
        if name in ("score", "cscore"):
            ws, gs = TBP._unpackf16x2(wpl), TBP._unpackf16x2(gpl)
            np.testing.assert_array_equal(np.isinf(ws), np.isinf(gs))
            fin = np.isfinite(ws)
            np.testing.assert_allclose(ws[fin], gs[fin], rtol=2 ** -10,
                                       atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(wpl, gpl, err_msg=name)

    # the inputs exercise every stage: peaks, connections, both hands
    (body_w, boxes, peaks) = tp.unpack(got, b)
    count, cok = tp.body.unpack(body_w, b)[2], tp.body.unpack(body_w, b)[5]
    assert count.sum() > 20 and cok.any()
    assert (boxes[:, 3] > 0).sum() >= 2
    assert (peaks != 0).any(-1).sum() >= 20
    results, _, _ = tp.assemble(got, b)
    jresults, _, _ = jp.assemble(want, b)
    for (cand, subset), (jcand, jsubset) in zip(results, jresults):
        np.testing.assert_array_equal(cand[:, [0, 1, 3]], jcand[:, [0, 1, 3]])
        np.testing.assert_array_equal(subset[:, :-2], jsubset[:, :-2])
