"""The reference-parity pose path of islx_torch against islx's on the CPU:
its ops (resize, pad/normalize, peaks, hand peaks, grouping, hand boxes),
``Body``, ``Hand`` and ``ISLSignPos`` on stub network outputs, and the same
three with the real full-width nets on a small frame.

Integer outputs (coordinates, part ids, subset indices) must be equal;
scores within atol 1e-4. Maps from stub network outputs agree within rtol
1e-4, atol 1e-5 (the resize contractions sum in another order in PyTorch's
CPU BLAS than in XLA); maps from the real CPMs within rtol 1e-4 and atol
1e-4 (the ~100 f32 convolution layers sum in another order too, and the
absolute error follows the size of the layer sums, ~1, not of each
output)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import DetectorConfig as JDet
from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.isl.translator import ISLSignPos as JSignPos
from islx.models import cpm as JC
from islx.ops import grouping as JG
from islx.ops import hand_peaks as JHP
from islx.ops import paf as JP
from islx.ops import peaks as JPK
from islx.ops import preprocess as JPre
from islx.ops import resize as JR
from islx.pose.body import Body as JBody
from islx.pose.detector import hand_detect as j_hand_detect
from islx.pose.hand import Hand as JHandEst
from islx_torch.core import weights as W
from islx_torch.core.config import DetectorConfig, HandConfig, PoseConfig
from islx_torch.isl.translator import ISLSignPos
from islx_torch.ops import grouping as TG
from islx_torch.ops import hand_peaks as THP
from islx_torch.ops import peaks as TPK
from islx_torch.ops import preprocess as TPre
from islx_torch.ops import resize as TR
from islx_torch.pose.body import Body
from islx_torch.pose.detector import hand_detect
from islx_torch.pose.hand import Hand


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


def _blobby(rng, h, w, c, n_lo=1, n_hi=4, amp=0.9):
    """Gaussian blobs at fractional centres plus a small tie breaker (as
    tests/test_pose_parity.py builds them)."""
    hm = np.zeros((h, w, c), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for ch in range(c):
        for _ in range(rng.randint(n_lo, n_hi)):
            cy = rng.randint(2, h - 2) + rng.uniform(-0.3, 0.3)
            cx = rng.randint(2, w - 2) + rng.uniform(-0.3, 0.3)
            hm[:, :, ch] += amp * rng.uniform(0.5, 1.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0 ** 2))
    hm += (rng.rand(h, w, 1) * 1e-3).astype(np.float32)
    return hm


def _smooth_noise(rng, h, w, c, scale=0.5):
    from scipy.ndimage import gaussian_filter

    x = rng.randn(h, w, c).astype(np.float32)
    for ch in range(c):
        x[:, :, ch] = gaussian_filter(x[:, :, ch], sigma=2)
    return (x * scale / (np.abs(x).max() + 1e-9) * 3).astype(np.float32)


def _assert_pose_equal(got, want):
    cand, subset = got
    jcand, jsubset = want
    assert cand.shape == jcand.shape and subset.shape == jsubset.shape
    np.testing.assert_array_equal(cand[:, [0, 1, 3]], jcand[:, [0, 1, 3]])
    np.testing.assert_allclose(cand[:, 2], jcand[:, 2], atol=1e-4)
    np.testing.assert_array_equal(subset[:, :-2], jsubset[:, :-2])
    np.testing.assert_allclose(subset[:, -2], jsubset[:, -2], atol=1e-4)
    np.testing.assert_array_equal(subset[:, -1], jsubset[:, -1])


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("h_out,w_out,saturate", [(37, 50, True),
                                                  (184, 240, True),
                                                  (23, 30, False)])
def test_resize_cubic_matches(rng, h_out, w_out, saturate):
    img = (rng.rand(92, 120, 3) * 255).astype(np.uint8)
    if not saturate:
        img = rng.randn(46, 60, 5).astype(np.float32)
    want = np.asarray(JR.resize_cubic(jnp.asarray(img), h_out, w_out,
                                      saturate_uint8=saturate))
    got = TR.resize_cubic(torch.from_numpy(img), h_out, w_out,
                          saturate_uint8=saturate).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if saturate:
        np.testing.assert_array_equal(want, got)
    else:
        np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,f", [(92, 2.0), (90, 2.0444444), (46, 4.0),
                                    (77, 0.3333)])
def test_output_size_matches(size, f):
    assert TR.output_size(size, f) == JR.output_size(size, f)
    assert TR.cv2_round(2.5) == JR.cv2_round(2.5) == 2


@pytest.mark.parametrize("h,w", [(184, 235), (96, 120), (13, 7)])
def test_pad_normalize_matches(rng, h, w):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    want, wpad = JPre.pad_normalize(jnp.asarray(img), 8, 128)
    got, gpad = TPre.pad_normalize(torch.from_numpy(img), 8, 128)
    assert gpad == wpad
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("thre1", [0.1, 0.02, -0.05])
def test_find_peaks_matches(rng, thre1):
    """Peak coordinates, order, counts and validity exact; scores exact (a
    gather); at thre1 <= 0 the -inf border of islx's ``_nms_mask`` holds."""
    heat = _blobby(rng, 60, 72, 25)
    heat[:, :, 3] -= 0.2                       # negative values for thre1 < 0
    want = JPK.find_peaks(jnp.asarray(heat), thre1, 16)
    got = TPK.find_peaks(torch.from_numpy(heat), thre1, 16)
    for name in ("xy", "valid", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(), name)
    np.testing.assert_allclose(np.asarray(want.score), got.score.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert int(got.count.sum()) > 20


@pytest.mark.parametrize("amp", [0.7, 0.2])
def test_find_hand_peaks_matches(rng, amp):
    heat = _blobby(rng, 64, 56, 21, 0, 4, amp=amp)
    heat[:, :, 0] = 0.0                        # a part that is not found
    want = JHP.find_hand_peaks(jnp.asarray(heat), 0.05)
    got = THP.find_hand_peaks(torch.from_numpy(heat), 0.05)
    np.testing.assert_array_equal(np.asarray(want.xy), got.xy.numpy())
    np.testing.assert_array_equal(np.asarray(want.found), got.found.numpy())
    assert not got.found[0] and got.found.sum() > 5


def test_one_part_picks_the_first_of_equal_components():
    """Two blobs with equal sums: the component that comes first in
    row-major order wins (skimage label order), as in islx."""
    heat = np.zeros((40, 40, 1), np.float32)
    heat[8:11, 28:31, 0] = 0.5
    heat[25:28, 5:8, 0] = 0.5
    want = JHP.find_hand_peaks(jnp.asarray(heat), 0.05)
    got = THP.find_hand_peaks(torch.from_numpy(heat), 0.05)
    np.testing.assert_array_equal(np.asarray(want.xy), got.xy.numpy())
    assert got.xy[0].tolist() == [28, 8]


@pytest.mark.parametrize("k", [8, 4])
def test_select_connections_and_assemble_match(rng, k):
    c, l = 25, 24
    counts = rng.randint(0, k + 1, c).astype(np.int32)
    counts[1:8] = k                            # neck and arms: people form
    xy = rng.randint(0, 100, (c, k, 2)).astype(np.int32)
    score = rng.rand(c, k).astype(np.float32)
    lscore = (rng.rand(l, k, k).astype(np.float32) - 0.3)
    lscore[0, 0, :] = 0.5                      # equal scores: order ties
    lok = rng.rand(l, k, k) > 0.4
    seq = JP.LIMB_SEQ_BODY25
    _, ids = JG.build_candidates(xy, score, counts)
    want = JG.select_connections(lscore, lok, counts, ids, seq)
    got = TG.select_connections(lscore, lok, counts, ids, seq)
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jc, js = JG.assemble(xy, score, counts, lscore, lok, seq, 26)
    tc, ts = TG.assemble(xy, score, counts, lscore, lok, seq, 26)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    assert len(ts) > 0 and len(tc) > 25


def test_hand_detect_matches(rng):
    assert dataclasses.asdict(DetectorConfig()) == dataclasses.asdict(JDet())
    for _ in range(30):
        n = rng.randint(6, 30)
        candidate = np.column_stack([
            rng.uniform(0, 200, n), rng.uniform(0, 150, n),
            rng.uniform(0, 1, n), np.arange(n, dtype=float)])
        subset = -np.ones((rng.randint(1, 4), 27))
        for p in range(len(subset)):
            joints = rng.choice(n, size=min(n, 10), replace=False)
            subset[p, rng.choice(25, size=len(joints), replace=False)] = joints
        assert (hand_detect(candidate, subset, (150, 200, 3))
                == j_hand_detect(candidate, subset, (150, 200, 3)))


# ------------------------------------------------ estimators on stub maps

def _stub_body_maps(rng):
    # a 92x120 frame at scale 0.5 -> net input 184x240 -> output 23x30
    return _blobby(rng, 23, 30, 26), _smooth_noise(rng, 23, 30, 52)


def test_body_stub_matches(rng):
    ori = (rng.rand(92, 120, 3) * 255).astype(np.uint8)
    heat, paf = _stub_body_maps(rng)

    def jstub(params, x, cd=None):
        assert x.shape[1:3] == (184, 240)
        return jnp.asarray(paf)[None], jnp.asarray(heat)[None]

    def tstub(params, x, cd=None):
        assert tuple(x.shape[1:3]) == (184, 240)
        return torch.from_numpy(paf)[None], torch.from_numpy(heat)[None]

    want = JBody(weights={}, config=JPose(thre2=-1.0), forward_fn=jstub)(ori)
    body = Body(weights={}, config=PoseConfig(thre2=-1.0), forward_fn=tstub,
                device="cpu")
    got = body(ori)
    _assert_pose_equal(got, want)
    assert len(got[0]) > 20 and len(got[1]) > 0


def _stub_hand(rng):
    """Blobby hand maps for a 46-px crop at the 4 default scales."""
    outs = {}
    for size, osize in [(184, 23), (368, 46), (552, 69), (736, 92)]:
        outs[(size, size)] = _blobby(rng, osize, osize, 22, 0, 3, amp=0.7)
    return outs


def test_hand_stub_matches(rng):
    crop = (rng.rand(46, 46, 3) * 255).astype(np.uint8)
    outs = _stub_hand(rng)
    jh = JHandEst(weights={}, forward_fn=lambda p, x, cd=None: jnp.asarray(
        outs[tuple(x.shape[1:3])])[None])
    th = Hand(weights={}, forward_fn=lambda p, x, cd=None: torch.from_numpy(
        outs[tuple(x.shape[1:3])])[None], device="cpu")
    np.testing.assert_allclose(jh.heatmap(crop), th.heatmap(crop), rtol=1e-4,
                               atol=1e-5)
    got = th(crop)
    np.testing.assert_array_equal(jh(crop), got)
    assert got.dtype == np.int32 and (got != 0).any(-1).sum() > 5


def test_sign_pos_stub_matches(rng):
    """``ISLSignPos`` on stub maps whose arm joints chain, so hand crops
    fire: candidates, subsets and re-offset hand peaks equal islx's."""
    ori = (rng.rand(92, 120, 3) * 255).astype(np.uint8)
    heat, paf = _stub_body_maps(rng)
    hand_maps = {}

    def jbody(p, x, cd=None):
        return jnp.asarray(paf)[None], jnp.asarray(heat)[None]

    def tbody(p, x, cd=None):
        return torch.from_numpy(paf)[None], torch.from_numpy(heat)[None]

    def hand_map(shape):
        if shape not in hand_maps:
            r = np.random.RandomState(shape[0] * 1000 + shape[1])
            hand_maps[shape] = _blobby(r, shape[0] // 8, shape[1] // 8, 22,
                                       1, 3, amp=0.7)
        return hand_maps[shape]

    cfg = dict(scale_search=(0.5, 1.0))
    jpos = JSignPos(JBody(weights={}, config=JPose(thre2=-1.0),
                          forward_fn=jbody),
                    JHandEst(weights={}, config=JHand(**cfg),
                             forward_fn=lambda p, x, cd=None: jnp.asarray(
                                 hand_map(tuple(x.shape[1:3])))[None]))
    tpos = ISLSignPos(Body(weights={}, config=PoseConfig(thre2=-1.0),
                           forward_fn=tbody, device="cpu"),
                      Hand(weights={}, config=HandConfig(**cfg),
                           forward_fn=lambda p, x, cd=None: torch.from_numpy(
                               hand_map(tuple(x.shape[1:3])))[None],
                           device="cpu"))
    cand, subset, hands = tpos(ori)
    jcand, jsubset, jhands = jpos(ori)
    _assert_pose_equal((cand, subset), (jcand, jsubset))
    assert len(hands) == len(jhands)
    for a, b in zip(hands, jhands):
        np.testing.assert_array_equal(a, b)


def test_estimators_refuse_without_gpu_and_coco():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Body(weights={}, forward_fn=lambda *a: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Hand(weights={}, forward_fn=lambda *a: None)
    # coco is ported: the estimator builds the COCO-18 net (the refusal
    # this test held until then is lifted)
    body = Body(model_type="coco", device="cpu")
    assert body.model_type == "coco" and body.limb_seq.shape == (19, 2)


# -------------------------------------------- real full-width nets, f32

@pytest.fixture(scope="module")
def nets():
    """Full-width BODY_25 and hand params from islx's seeded init; the arm
    joints' heat channels get a +1 bias so arms chain and hands fire."""
    body = jax.tree.map(np.asarray,
                        JC.init_params("body25", jax.random.PRNGKey(3)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(4)))
    b = np.array(body["Mconv7_stage1_L1"]["b"])
    b[2:8] += 1.0
    body["Mconv7_stage1_L1"]["b"] = b
    return body, hand


def test_real_nets_match(nets):
    """``Body.maps``/``Hand.heatmap`` within rtol 1e-4, atol 1e-4, and
    ``ISLSignPos`` on a 92x120 frame with the outputs as above, with the
    real CPMs at full width (the body at scale 0.25: a 96x120 net input;
    the hand at scale 0.25: 92 px)."""
    body_p, hand_p = nets
    frame = (np.random.RandomState(5).rand(92, 120, 3) * 255
             ).astype(np.uint8)
    pose = dict(scale_search=(0.25,), max_peaks=8, thre2=-0.5)
    jb = JBody(body_p, config=JPose(**pose))
    tb = Body(W.from_islx_params(body_p), config=PoseConfig(**pose),
              device="cpu")
    jheat, jpaf = jb.maps(frame)
    theat, tpaf = tb.maps(frame)
    print(f"largest map differences: heat {np.abs(theat - jheat).max():.3g},"
          f" paf {np.abs(tpaf - jpaf).max():.3g}")
    np.testing.assert_allclose(theat, jheat, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpaf, jpaf, rtol=1e-4, atol=1e-4)
    # people and hands exist: the threshold sits at the 80th percentile of
    # the joint maps
    thre1 = float(np.quantile(jheat[..., :25], 0.8))
    jb.cfg = dataclasses.replace(jb.cfg, thre1=thre1)
    tb.cfg = dataclasses.replace(tb.cfg, thre1=thre1)

    hand = dict(scale_search=(0.25,))
    jh = JHandEst(hand_p, config=JHand(**hand))
    th = Hand(W.from_islx_params(hand_p), config=HandConfig(**hand),
              device="cpu")
    crop = frame[10:74, 20:84]
    thm, jhm = th.heatmap(crop), jh.heatmap(crop)
    print(f"largest hand heatmap difference: {np.abs(thm - jhm).max():.3g}")
    np.testing.assert_allclose(thm, jhm, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(th(crop), jh(crop))

    cand, subset, hands = ISLSignPos(tb, th)(frame)
    jcand, jsubset, jhands = JSignPos(jb, jh)(frame)
    _assert_pose_equal((cand, subset), (jcand, jsubset))
    assert len(cand) > 25 and len(subset) > 0 and len(hands) > 0
    assert len(hands) == len(jhands)
    for a, b in zip(hands, jhands):
        np.testing.assert_array_equal(a, b)
