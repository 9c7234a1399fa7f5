"""The port's ImagePose against islx's on the same frames (CPU): the split
mode (body step, host hand boxes from the grouped people, hand step on
crops of the same upload) and the fused mode, for BODY_25 and COCO.

The port's pipelines run with islx's jitted f32 CPM forwards in place of
their own nets, so the comparison holds everything but the CPMs (held by
tests/test_torch_coco.py and tests/test_torch_pose.py): the f32 CPMs sum
in another order, and a peak at an NMS near-tie could flip (ROADMAP.md §3).
Candidate coordinates and ids, the subsets' joint indices and every hand
keypoint must be equal; peak and person scores agree within 1e-4 (the
fused peak scores are reconstructed with f32 sums in another order).
Frames are at their 184-row bucket's size, which the port resizes without
cv2 (a same-size ``cv2.resize`` is an exact copy); another size needs cv2.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.models import cpm as JC
from islx.pipeline.image import ImagePose as JImagePose
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.pipeline.image import ImagePose


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the heat channel biased so that arms chain and hands fire, by net
ARM_HEAD = {"body25": "Mconv7_stage1_L1", "coco": "Mconv7_stage6_L2"}


@pytest.fixture(scope="module")
def params():
    """islx's seeded full-width params: both body nets (arm joints' heat
    raised by 1) and the hand CPM."""
    out = {}
    for i, mt in enumerate(("body25", "coco", "hand")):
        p = jax.tree.map(np.asarray, JC.init_params(
            mt, jax.random.PRNGKey(7 + i)))
        if mt in ARM_HEAD:
            b = np.array(p[ARM_HEAD[mt]]["b"])
            b[2:8] += 1.0
            p[ARM_HEAD[mt]]["b"] = b
        out[mt] = p
    return out


def islx_nets(params, mt):
    """islx's jitted f32 forwards as the port's net callables."""
    fb = jax.jit(lambda p, x: JC.FORWARDS[mt](p, x, jnp.float32))
    fh = jax.jit(lambda p, x, s: JC.hand_forward(p, x, jnp.float32, s),
                 static_argnums=2)

    def body_net(x, cd):
        return tuple(torch.from_numpy(np.array(m))
                     for m in fb(params[mt], jnp.asarray(x.numpy())))

    def hand_net(x, cd, stages=6):
        return torch.from_numpy(np.array(fh(params["hand"],
                                            jnp.asarray(x.numpy()), stages)))

    return body_net, hand_net


HAND = dict(scale_search=(0.25,))                    # 92 px crops


def _frame(seed):
    return (np.random.RandomState(seed).rand(184, 96, 3) * 255).astype(
        np.uint8)


def _thre1(body_net, frame, njoint):
    """The median of the frame's joint maps: people and hands form."""
    heat = body_net(torch.from_numpy(frame[None]).float() / 256.0 - 0.5,
                    torch.float32)[1]
    return float(np.quantile(heat[..., :njoint - 1].numpy(), 0.5))


def _assert_same(got, want):
    (cand, subset, hands), (jcand, jsubset, jhands) = got, want
    np.testing.assert_array_equal(cand[:, [0, 1, 3]], jcand[:, [0, 1, 3]])
    np.testing.assert_allclose(cand[:, 2], jcand[:, 2], atol=1e-4)
    np.testing.assert_array_equal(subset[:, :-2], jsubset[:, :-2])
    np.testing.assert_allclose(subset[:, -2], jsubset[:, -2], atol=1e-4)
    np.testing.assert_array_equal(subset[:, -1], jsubset[:, -1])
    assert len(hands) == len(jhands)
    for a, b in zip(hands, jhands):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("mt", ["body25", "coco"])
def test_image_pose_matches_islx(params, mt, fused):
    body_net, hand_net = islx_nets(params, mt)
    frame = _frame({"body25": 0, "coco": 1}[mt])
    njoint = PoseConfig(model_type=mt).njoint
    pose = dict(max_peaks=16, thre2=-0.5,
                thre1=_thre1(body_net, frame, njoint))
    jpose = JImagePose(params[mt], params["hand"], mt, fused=fused,
                       compute_dtype=jnp.float32, hand_cfg=JHand(**HAND))
    tpose = ImagePose(W.from_islx_params(params[mt]),
                      W.from_islx_params(params["hand"]), mt, fused=fused,
                      compute_dtype=torch.float32, hand_cfg=HandConfig(**HAND),
                      device="cpu")
    jbody, tbody = ((jpose.pipe.body, tpose.pipe.body) if fused
                    else (jpose.body, tpose.body))
    jbody.cfg = dataclasses.replace(jbody.cfg, **pose)
    tbody.cfg = dataclasses.replace(tbody.cfg, **pose)
    thand = tpose.pipe.hand if fused else tpose.hand
    tbody.net, thand.net = body_net, hand_net
    got, want = tpose(frame), jpose(frame)
    _assert_same(got, want)
    cand, subset, hands = got
    assert len(subset) > 0 and len(hands) > 0       # people and hands form
    assert tpose.max_hands == (2 if fused else 4)


def test_same_size_frames_need_no_cv2(params, monkeypatch):
    """Without cv2 a frame at its bucket's size runs (the same result as
    with cv2), and so does a 200x150 frame: its bucket resize is word-equal
    to cv2's INTER_CUBIC (the port's resize_u8)."""
    import cv2

    from islx_torch.ops.resize_u8 import upload_resized

    body_net, hand_net = islx_nets(params, "body25")
    tpose = ImagePose(W.init_params("body25"), W.init_params("hand"),
                      compute_dtype=torch.float32, hand_cfg=HandConfig(**HAND),
                      device="cpu")
    tpose.body.cfg = PoseConfig(max_peaks=16, thre2=-0.5, thre1=0.05)
    tpose.body.net, tpose.hand.net = body_net, hand_net
    frame = _frame(2)
    other = (np.random.RandomState(3).rand(200, 150, 3) * 255).astype(
        np.uint8)
    with_cv2 = tpose(frame)
    other_with_cv2 = tpose(other)
    want = cv2.resize(other, (144, 184), interpolation=cv2.INTER_CUBIC)
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    without = tpose(frame)
    for a, b in zip(with_cv2[:2], without[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        upload_resized(other, 184, 144, "cpu")[0].numpy(), want)
    for a, b in zip(other_with_cv2[:2], tpose(other)[:2]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ImagePose()


def test_other_size_resizes_as_islx(params):
    """A frame off its bucket's size goes through cv2's INTER_CUBIC (both
    sides), then the same pipeline: 200x150 -> the 184x144 bucket."""
    pytest.importorskip("cv2")
    body_net, hand_net = islx_nets(params, "body25")
    frame = (np.random.RandomState(3).rand(200, 150, 3) * 255).astype(
        np.uint8)
    pose = dict(max_peaks=16, thre2=-0.5, thre1=0.05)
    jpose = JImagePose(params["body25"], params["hand"],
                       compute_dtype=jnp.float32, hand_cfg=JHand(**HAND))
    jpose.body.cfg = dataclasses.replace(jpose.body.cfg, **pose)
    tpose = ImagePose(W.from_islx_params(params["body25"]),
                      W.from_islx_params(params["hand"]),
                      compute_dtype=torch.float32,
                      hand_cfg=HandConfig(**HAND), device="cpu")
    tpose.body.cfg = PoseConfig(**pose)
    tpose.body.net, tpose.hand.net = body_net, hand_net
    _assert_same(tpose(frame), jpose(frame))


def test_exports():
    import islx_torch
    from islx_torch.pipeline import batch_pose

    assert islx_torch.ImagePose is ImagePose
    assert islx_torch.BatchedBodyPipeline is batch_pose.BatchedBodyPipeline
    assert islx_torch.BatchedHandPipeline is batch_pose.BatchedHandPipeline
    with pytest.raises(AttributeError):
        islx_torch.NoSuchThing
