"""Translation end to end on the CPU: islx_torch's BatchedTranslatePipeline
against islx's on the same frames and the same full-width body, hand and
head weights, in f32: the same 156-d features for every frame, and the same
(frame_idx, class_id) predictions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.models import translator as JT
from islx.pipeline.translate import BatchedTranslatePipeline as JTranslate
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.pipeline.translate import BatchedTranslatePipeline
from islx_torch.pipeline.video import FrameBatcher


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


def record_features(pipe):
    """-> the list that collects every batch's features as the pipeline's
    own ``_features`` step returns them."""
    feats = []
    step = pipe._features

    def recording(*args):
        out = step(*args)
        feats.extend(out)
        return out

    pipe._features = recording
    return feats


def test_translate_frames_same_predictions(monkeypatch):
    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    body = jax.tree.map(np.asarray,
                        JC.init_params("body25", jax.random.PRNGKey(1)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(2)))
    b = np.array(body["Mconv7_stage1_L1"]["b"])
    b[2:8] += 1.0                        # arm joints present: hands fire
    body["Mconv7_stage1_L1"]["b"] = b
    head = jax.tree.map(np.asarray, JT.init_params(key=jax.random.PRNGKey(3)))
    pose, hcfg = dict(max_peaks=8, thre2=-0.5), dict(scale_search=(0.25,))
    jp = JTranslate(body, hand, head, pose_cfg=JPose(**pose),
                    hand_cfg=JHand(**hcfg), batch=8,
                    compute_dtype=jnp.float32)
    tp = BatchedTranslatePipeline(
        W.from_islx_params(body), W.from_islx_params(hand), head,
        pose_cfg=PoseConfig(**pose), hand_cfg=HandConfig(**hcfg), batch=8,
        compute_dtype=torch.float32, device="cpu")

    rng = np.random.RandomState(0)
    base = (rng.rand(64, 32, 3) * 255).astype(np.uint8)
    frames = [np.roll(base, 2 * i, axis=1) for i in range(24)]  # 184x96
    bucketed, _ = next(FrameBatcher(8, (184, 96))(frames[:8]))
    with torch.no_grad():
        heat = tp.pipe.body.net(torch.from_numpy(bucketed).float()
                                / 256.0 - 0.5)[1]
    thre1 = float(np.quantile(heat[..., :25].numpy(), 0.8))
    jp.thre1 = tp.thre1 = thre1

    fw, fg = record_features(jp), record_features(tp)
    want = jp.translate_frames(iter(frames))
    got = tp.translate_frames(iter(frames))
    assert [o[0] for o in got] == list(range(19, 24))
    assert [o[:3] for o in got] == [o[:3] for o in want]
    np.testing.assert_allclose([o[3] for o in got], [o[3] for o in want],
                               atol=1e-5)

    # the features behind them are the same 156-d vectors
    assert len(fg) == len(fw) == 24
    fw, fg = np.stack(fw), np.stack(fg)
    np.testing.assert_array_equal(fw, fg)
    assert np.count_nonzero(fg[:, :30]) > 0       # body keypoints
    assert np.count_nonzero(fg[:, 30:]) > 0       # hand keypoints


def test_stage_timers():
    """``prof`` accumulates host seconds for islx's four stages, on the
    BGR and the I420 stream, and changes no prediction."""
    from islx_torch.ops.yuv import bgr_to_yuv420_host

    tp = BatchedTranslatePipeline(
        pose_cfg=PoseConfig(max_peaks=8), hand_cfg=HandConfig(
            scale_search=(0.25,)), batch=10, compute_dtype=torch.float32,
        device="cpu")
    rng = np.random.RandomState(1)
    frames = [(rng.rand(184, 96, 3) * 255).astype(np.uint8)
              for _ in range(20)]
    want = tp.translate_frames(iter(frames))
    assert tp.prof is None
    tp.prof = {}
    got = tp.translate_frames(iter(frames))
    assert [o[:3] for o in got] == [o[:3] for o in want]
    assert [o[0] for o in got] == [19]
    assert set(tp.prof) == {"dispatch", "fetch_group", "featurize", "head"}
    assert all(v > 0 for v in tp.prof.values())
    bgr = dict(tp.prof)
    yuv = [bgr_to_yuv420_host(f[None]) for f in frames]
    tp.prof = {}
    got = tp.translate_yuv_frames(iter(yuv), (184, 96), (184, 96))
    assert [o[0] for o in got] == [19]
    assert set(tp.prof) == set(bgr)
    assert all(v > 0 for v in tp.prof.values())
