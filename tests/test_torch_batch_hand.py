"""The port's BatchedHandPipeline and detect_hand_boxes against islx's on the
same crops, frames and CPM outputs (CPU).

Both pipelines read the same stub hand CPM outputs (seeded gaussian blobs
a part channel, a function of the net input's shape and the crop), so the
comparison covers everything around the CPM: the crops' resize to each
scale, padding, the heatmaps' upsample and average, the peaks (coarse to
fine at one scale; connected components or the global maximum over
several) and the coordinate scaling. Peaks, boxes and labels are integers
and must be equal.
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.models import cpm as JC
from islx.ops import hand_peaks as JHP
from islx.pipeline import batch_pose as JBP
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig
from islx_torch.ops import hand_peaks as THP
from islx_torch.parallel import mesh as M
from islx_torch.pipeline import batch_pose as TBP


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    return W.init_params("hand", 1)


def stub_heat(shape, amp=0.8):
    """[N,H/8,W/8,22] heatmaps for a net input [N,H,W,3]: one or two
    gaussian blobs a part channel, seeded by the shape and the crop."""
    n, h, w = shape[0], shape[1] // 8, shape[2] // 8
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((n, h, w, 22), np.float32)
    for i in range(n):
        rng = np.random.RandomState(zlib.crc32(f"{shape} {i}".encode())
                                    & 0x7FFFFFFF)
        for ch in range(22):
            for _ in range(rng.randint(1, 3)):
                cy = rng.uniform(1, h - 1)
                cx = rng.uniform(1, w - 1)
                out[i, :, :, ch] += amp * rng.uniform(0.3, 1.0) * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0)
        out[i] += (rng.rand(h, w, 1) * 1e-3).astype(np.float32)
    return out


def _stubs(monkeypatch):
    def jforward(params, x, cd, stages=6):
        # + 0 * mean(x): the maps stay run-time values, which XLA does not
        # fold (its evaluator sums in its own order)
        return jnp.asarray(stub_heat(tuple(x.shape))) + 0.0 * jnp.mean(x)

    monkeypatch.setattr(JC, "hand_forward", jforward)

    def tnet(x, cd, stages=6):
        return torch.from_numpy(stub_heat(tuple(x.shape)))

    return tnet


def _pipes(monkeypatch, state, cfg, **kw):
    tnet = _stubs(monkeypatch)
    jp = JBP.BatchedHandPipeline({}, JHand(**cfg), compute_dtype=jnp.float32,
                                 **kw)
    tp = TBP.BatchedHandPipeline(state, HandConfig(**cfg),
                                 compute_dtype=torch.float32, device="cpu",
                                 **kw)
    tp.net = tnet
    return jp, tp


def _crops(n=3, size=96, seed=0):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 255
            ).astype(np.uint8)


def test_call_single_scale(monkeypatch, state):
    """One scale (184 px from 96 px crops): coarse-to-fine peaks in the
    scale's coords, mapped back to the crop's."""
    jp, tp = _pipes(monkeypatch, state, dict(scale_search=(0.5,)),
                    crop_size=96)
    crops = _crops()
    want, got = jp(crops), tp(crops)
    assert got.dtype == np.int32 and got.shape == want.shape == (3, 21, 2)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any(-1).sum() > 30


@pytest.mark.parametrize("peak_mode", ["cc", "fast"])
def test_call_multi_scale(monkeypatch, state, peak_mode):
    """Two scales (92 and 184 px, the first stride-padded) averaged at the
    crop size; peaks by connected components or the global maximum."""
    jp, tp = _pipes(monkeypatch, state, dict(scale_search=(0.25, 0.5)),
                    crop_size=96, peak_mode=peak_mode)
    crops = _crops(seed=1)
    want, got = jp(crops), tp(crops)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any(-1).sum() > 30


def test_cc_and_fast_differ_where_blobs_compete(monkeypatch, state):
    """The two multi-scale peak modes are different functions: on crops
    whose parts have two blobs, cc picks the blob of largest sum and fast
    the global maximum, and both equal islx's."""
    outs = {}
    for mode in ("cc", "fast"):
        jp, tp = _pipes(monkeypatch, state, dict(scale_search=(0.25, 0.5)),
                        crop_size=96, peak_mode=mode)
        crops = _crops(n=4, seed=2)
        outs[mode] = tp(crops)
        np.testing.assert_array_equal(outs[mode], jp(crops))
    assert (outs["cc"] != outs["fast"]).any()


@pytest.mark.parametrize("chunk", [None, 2])
def test_from_frames_and_crop_chunk(monkeypatch, state, chunk):
    """Crops cut on the device from resident frames (92 px), peaks in frame
    coords; islx's ``crop_chunk`` changes no bit."""
    jp, tp = _pipes(monkeypatch, state, dict(scale_search=(0.25,)),
                    crop_chunk=chunk)
    frames = (np.random.RandomState(3).rand(2, 48, 64, 3) * 255).astype(
        np.uint8)
    boxes = np.array([[0, 3, 2, 30], [0, 40, 10, 20], [1, 0, 0, 48],
                      [1, 50, 30, 0]], np.int32)
    want = jp.from_frames(jnp.asarray(frames.reshape(-1)), 2, 48, 64, boxes)
    got = tp.from_frames(torch.from_numpy(frames.reshape(-1)), 2, 48, 64,
                         boxes)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[3] == 0).all() and (got[:3] != 0).any(-1).sum() > 20


def test_call_refusals(state):
    mesh = M.make_mesh(2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="first device"):
        TBP.BatchedHandPipeline(state, mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="not divisible"):
        TBP.BatchedHandPipeline(state, HandConfig(scale_search=(0.25,)),
                                mesh=mesh).from_frames(
            torch.zeros(2 * 48 * 48 * 3, dtype=torch.uint8), 2, 48, 48,
            np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="peak_mode"):
        TBP.BatchedHandPipeline(state, peak_mode="nope", device="cpu")
    tp = TBP.BatchedHandPipeline(state, HandConfig(scale_search=(0.5, 1.0)),
                                 device="cpu")
    with pytest.raises(ValueError, match="single-scale"):
        tp.core(torch.zeros(1, 48, 48, 3), torch.zeros(1, 4,
                                                       dtype=torch.int32))


def _people(rng, n_people, h0, w0):
    """A (candidate, subset) pair in bucket coords: people with all arm
    joints present (some with one arm missing)."""
    cand, subset = [], []
    for p in range(n_people):
        row = -np.ones(27)
        cx, cy = rng.uniform(20, w0 - 20), rng.uniform(20, h0 - 20)
        for j in (2, 3, 4, 5, 6, 7):
            if p % 3 == 2 and j in (5, 6, 7):
                continue
            cand.append([cx + rng.uniform(-15, 15), cy + rng.uniform(-15, 15),
                         rng.uniform(0.2, 1.0), len(cand)])
            row[j] = len(cand) - 1
        row[-2], row[-1] = rng.uniform(1, 5), 6
        subset.append(row)
    return np.array(cand, np.float64).reshape(-1, 4), np.array(subset)


@pytest.mark.parametrize("seed", range(4))
def test_detect_hand_boxes(seed):
    """Host boxes from grouped skeletons (bucket coords, the 20 px minimum
    in frame coords, Python rounding back), up to max_hands a frame."""
    rng = np.random.RandomState(seed)
    hb, wb, orig = 184, 144, (720, 560)
    results = [_people(rng, n, hb, wb) for n in (0, 1, 3)]
    for max_hands in (2, 4):
        want = JBP.detect_hand_boxes(results, hb, wb, orig, max_hands)
        got = TBP.detect_hand_boxes(results, hb, wb, orig, max_hands)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert (got[:, 3] > 0).sum() >= 2


@pytest.mark.parametrize("thre", [0.05, 0.3])
def test_find_hand_peaks_fast_and_batched_cc(thre, monkeypatch):
    """The multi-scale peak functions directly on [N,H,W,21] maps: the
    global maximum, and the connected components of all N crops labelled
    in one call, or in calls of fewer crops where the kernel's tiles do not
    fit (islx vmaps the per-crop function)."""
    heat = stub_heat((4, 368, 368, 3))[..., :21]
    big = np.repeat(np.repeat(heat, 2, 1), 2, 2)          # 92x92 maps
    want = jax.vmap(lambda h: JHP.find_hand_peaks_fast(h, thre))(
        jnp.asarray(big))
    got = THP.find_hand_peaks_fast(torch.from_numpy(big), thre)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    want = jax.vmap(lambda h: JHP.find_hand_peaks(h, thre))(jnp.asarray(big))
    assert THP.crops_per_call(92, 92, 21, 4) == 4
    for per_call in (4, 1, 3):
        monkeypatch.setattr(THP, "crops_per_call",
                            lambda h, w, c, n, k=per_call: k)
        got = THP.find_hand_peaks(torch.from_numpy(big), thre)
        np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
        np.testing.assert_array_equal(got.found.numpy(),
                                      np.asarray(want.found))
    assert got.found.sum() > 10
