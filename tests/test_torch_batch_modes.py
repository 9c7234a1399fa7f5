"""The port's BatchedBodyPipeline in every construction islx offers, against
islx's on the same frames and the same CPM outputs (CPU).

Both pipelines read the same stub CPM outputs (seeded gaussian blobs on
the joint channels and smooth PAFs, a function of the net input's shape),
so what is compared is everything after the CPM: peaks (fused, pyramid or
exact), the PAF scorers, compaction and the packing. Integer planes (peak
coordinates and counts, pair indices, the ok bits) must be word-equal; f32
scores agree within the tolerance each test states (the fused peaks'
reconstructed scores and the /8 scorers' sums add in another order than
islx's programs), and the exact construction's ``bits`` buffer is islx's
word for word. The ops behind the pipelines are also held directly: ``find_peaks_fused``,
``find_peaks_pyramid``, ``score_limbs_mxu`` and ``score_limbs_fused``.
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.ops import paf as JPaf
from islx.ops import peaks as JPk
from islx.pipeline import batch_pose as JBP
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.ops import paf as TPaf
from islx_torch.ops import peaks as TPk
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
    return W.init_params("body25", 0)


def stub_maps(shape, channels=(26, 52), amp=0.9):
    """Net outputs (paf, heat) at /8 for a net input of ``shape`` [B,H,W,3]:
    1-3 gaussian blobs at fractional centres a joint channel and a small
    tie breaker, smooth noise PAFs; seeded by the shape and the frame."""
    from scipy.ndimage import gaussian_filter

    b, h, w = shape[0], shape[1] // 8, shape[2] // 8
    yy, xx = np.mgrid[0:h, 0:w]
    heats, pafs = [], []
    for f in range(b):
        rng = np.random.RandomState(zlib.crc32(f"{shape} {f}".encode())
                                    & 0x7FFFFFFF)
        heat = np.zeros((h, w, channels[0]), np.float32)
        for ch in range(channels[0]):
            for _ in range(rng.randint(1, 4)):
                cy = rng.randint(1, h - 1) + rng.uniform(-0.3, 0.3)
                cx = rng.randint(1, w - 1) + rng.uniform(-0.3, 0.3)
                heat[:, :, ch] += amp * rng.uniform(0.5, 1.0) * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
        heat += (rng.rand(h, w, 1) * 1e-3).astype(np.float32)
        paf = rng.randn(h, w, channels[1]).astype(np.float32)
        for ch in range(channels[1]):
            paf[:, :, ch] = gaussian_filter(paf[:, :, ch], sigma=1.5)
        paf = paf * 1.5 / (np.abs(paf).max() + 1e-9)
        heats.append(heat)
        pafs.append(paf.astype(np.float32))
    return np.stack(pafs), np.stack(heats)


def stub_forwards(monkeypatch):
    """islx's body forward replaced by the stub; the port's net callable."""
    def jforward(params, x, cd):
        paf, heat = stub_maps(tuple(x.shape))
        # + 0 * mean(x): the maps stay run-time values (constants would be
        # folded by XLA's evaluator, which sums in its own order)
        zero = 0.0 * jnp.mean(x)
        return jnp.asarray(paf) + zero, jnp.asarray(heat) + zero

    monkeypatch.setitem(JC.FORWARDS, "body25", jforward)

    def tnet(x, cd):
        return tuple(torch.from_numpy(a) for a in stub_maps(tuple(x.shape)))

    return tnet


POSE = dict(max_peaks=8, thre1=0.1, thre2=-0.5)


def _pipes(monkeypatch, state, pack=None, pose=None, **kw):
    """islx's and the port's pipelines of one construction (f32)."""
    tnet = stub_forwards(monkeypatch)
    if pack is None:
        monkeypatch.delenv("ISLX_PACK_MODE", raising=False)
    else:
        monkeypatch.setenv("ISLX_PACK_MODE", pack)
    pose = {**POSE, **(pose or {})}
    jp = JBP.BatchedBodyPipeline({}, "body25", JPose(**pose),
                                 compute_dtype=jnp.float32, **kw)
    tp = TBP.BatchedBodyPipeline(state, "body25", PoseConfig(**pose),
                                 compute_dtype=torch.float32, device="cpu",
                                 **kw)
    tp.net = tnet
    assert tp.pack_mode == jp.pack_mode
    return jp, tp


def _frames(b=2, hb=48, wb=64, seed=0):
    return (np.random.RandomState(seed).rand(b, hb, wb, 3) * 255).astype(
        np.uint8)


def _compare(jp, tp, frames, score_tol):
    b = frames.shape[0]
    want = np.asarray(jp.device_step(frames))
    got = tp.device_step(frames).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    jt, tt = jp.unpack(want, b), tp.unpack(got, b)
    names = ("xy", "score", "count", "pair", "cscore", "cok")
    for name, w, g in zip(names, jt, tt):
        if name in ("score", "cscore"):
            np.testing.assert_allclose(g, w, rtol=score_tol, atol=score_tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    count, cok = tt[2], tt[5]
    assert count.sum() >= 2 * 25 and cok.any()     # peaks and connections
    return got, want


# the /8 scorers' scores agree within 2 f32 ulps of their magnitude (another
# summation order inside islx's fused programs); the bits16 planes round
# to f16 (one f16 rounding apart at most)
SCORE_TOL = {"bits16": 2 ** -10, "bits": 1e-6, "nook": 1e-6, "flat": 1e-6}


@pytest.mark.parametrize("pack", ["bits16", "bits", "nook", "flat"])
@pytest.mark.parametrize("paf_mode", ["cell8", "cell", "vcell8", "fused",
                                      "take", "mxu", "exact"])
def test_paf_mode_and_pack_mode(monkeypatch, state, paf_mode, pack):
    """Every PAF mode under every pack mode, fused peaks (islx's mask path
    on the CPU: ``pallas_mask=False``, the XLA NMS; the port's mask
    kernel's plain version)."""
    jp, tp = _pipes(monkeypatch, state, pack, paf_mode=paf_mode,
                    pallas_mask=False)
    _compare(jp, tp, _frames(), SCORE_TOL[pack])


@pytest.mark.parametrize("pack", ["bits", "bits16"])
def test_exact_parity_construction(monkeypatch, state, pack):
    """``paf_mode="exact", two_stage_peaks=False``: upsampled maps, the
    NMS+first-K with islx's -inf border over the batch, the exact PAF
    integrals a frame; ``bits`` is its default pack (bitcast f32 scores)
    and equals islx's buffer word for word."""
    jp, tp = _pipes(monkeypatch, state, None if pack == "bits" else pack,
                    paf_mode="exact", two_stage_peaks=False)
    assert tp.pack_mode == pack and not tp.fused_peaks
    got, want = _compare(jp, tp, _frames(), SCORE_TOL[pack])
    if pack == "bits":
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("select", ["rows", "flat"])
@pytest.mark.parametrize("two_stage", [True, False])
def test_peaks_select(monkeypatch, state, select, two_stage):
    """``ISLX_PEAKS_SELECT`` flat/rows, fused and unfused peaks."""
    monkeypatch.setenv("ISLX_PEAKS_SELECT", select)
    jp, tp = _pipes(monkeypatch, state, "bits", pallas_mask=False,
                    two_stage_peaks=two_stage)
    assert tp.peaks_select == jp.peaks_select == select
    _compare(jp, tp, _frames(seed=1), 1e-6)


@pytest.mark.parametrize("paf_mode", ["cell8", "exact"])
@pytest.mark.parametrize("ref_compat", [False, True])
def test_multi_scale(monkeypatch, state, paf_mode, ref_compat):
    """The body scale pyramid (two scales: a resized and padded input and
    the bucket itself), with the reference's 2^(n-1-s)/n heat weights or
    the mean; the averaged PAF on the /8 grid or at full resolution."""
    pose = dict(scale_search=(0.75, 1.0), boxsize=48,
                ref_compat_averaging=ref_compat)
    jp, tp = _pipes(monkeypatch, state, "bits", pose=pose,
                    paf_mode=paf_mode)
    _compare(jp, tp, _frames(b=2, hb=48, wb=72, seed=2), 2e-6)


def test_pallas_nms_and_mask_flags(monkeypatch, state):
    """``pallas_nms`` and ``pallas_mask`` resolve as islx's (env switches,
    and the mask off when the NMS kernel picks the peaks); every choice
    gives the same buffer."""
    monkeypatch.setenv("ISLX_PALLAS_NMS", "1")
    jp, tp = _pipes(monkeypatch, state, "bits")
    assert tp.pallas_nms and not tp.pallas_mask
    select = tp.device_step(_frames(seed=3)).numpy()
    monkeypatch.delenv("ISLX_PALLAS_NMS")
    monkeypatch.setenv("ISLX_PALLAS_MASK", "0")
    _, tp2 = _pipes(monkeypatch, state, "bits")
    assert not tp2.pallas_nms and not tp2.pallas_mask
    np.testing.assert_array_equal(tp2.device_step(_frames(seed=3)).numpy(),
                                  select)
    _, tp3 = _pipes(monkeypatch, state, "bits", two_stage_peaks=False)
    assert not tp3.fused_peaks and not tp3.pallas_mask


def test_call_and_refusals(monkeypatch, state):
    """``__call__`` scales candidates to ``orig_hw`` as islx's does; on a
    data mesh of 2 the same results; a device other than the mesh's
    first and unknown modes are refused."""
    jp, tp = _pipes(monkeypatch, state)
    frames = _frames(seed=4)
    got = tp(frames, orig_hw=(96, 128), thre1=0.2)
    want = jp(frames, orig_hw=(96, 128), thre1=0.2)
    assert len(got) == len(want) == 2
    for (c, s), (jc, js) in zip(got, want):
        np.testing.assert_array_equal(c[:, [0, 1, 3]], jc[:, [0, 1, 3]])
        np.testing.assert_array_equal(s[:, :-2], js[:, :-2])
    # the port's own net: the stub's maps depend on the batch's shape
    mesh = M.make_mesh(2, devices=[torch.device("cpu")] * 2)
    one = TBP.BatchedBodyPipeline(state, "body25", tp.cfg,
                                  compute_dtype=torch.float32, device="cpu")
    tm = TBP.BatchedBodyPipeline(state, "body25", tp.cfg,
                                 compute_dtype=torch.float32, mesh=mesh)
    for (c, s), (mc, ms) in zip(one(frames, (96, 128), 0.2),
                                tm(frames, (96, 128), 0.2)):
        np.testing.assert_array_equal(mc, c)
        np.testing.assert_array_equal(ms, s)
    with pytest.raises(ValueError, match="first device"):
        TBP.BatchedBodyPipeline(state, mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="paf_mode"):
        TBP.BatchedBodyPipeline(state, paf_mode="nope", device="cpu")


def _hand_stub(shape):
    """[N,H/8,W/8,22] blob heatmaps for a hand net input of ``shape``."""
    return stub_maps(shape, channels=(22, 2))[1]


@pytest.mark.parametrize("pack", ["bits16", "bits", "nook", "flat"])
def test_fused_step_pack_modes(monkeypatch, state, pack):
    """FusedPosePipeline packs the body tables and the hand words as its
    body pipeline's pack mode says (islx's ``ISLX_PACK_MODE``): every
    integer plane, box and hand peak equal to islx's."""
    stub_forwards(monkeypatch)
    monkeypatch.setattr(JC, "hand_forward", lambda p, x, cd, s=6:
                        jnp.asarray(_hand_stub(tuple(x.shape)))
                        + 0.0 * jnp.mean(x))
    monkeypatch.setenv("ISLX_PACK_MODE", pack)
    hand = dict(scale_search=(0.25,))
    jp = JBP.FusedPosePipeline({}, {}, pose_cfg=JPose(**POSE),
                               hand_cfg=JHand(**hand),
                               compute_dtype=jnp.float32)
    tp = TBP.FusedPosePipeline(state, W.init_params("hand", 1),
                               pose_cfg=PoseConfig(**POSE),
                               hand_cfg=HandConfig(**hand),
                               compute_dtype=torch.float32, device="cpu")
    tp.body.net = stub_forwards(monkeypatch)
    tp.hand.net = lambda x, cd, s=6: torch.from_numpy(
        _hand_stub(tuple(x.shape)))
    assert tp.body.pack_mode == jp.body.pack_mode == pack
    frames = _frames(seed=5)
    want = np.asarray(jp.device_step(frames))
    got = tp.device_step(frames).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    (jb, jbox, jpk), (tb, tbox, tpk) = jp.unpack(want, 2), tp.unpack(got, 2)
    np.testing.assert_array_equal(tbox, jbox)
    np.testing.assert_array_equal(tpk, jpk)
    for i in (0, 2, 3, 5):                 # xy, count, pair, ok
        np.testing.assert_array_equal(tp.body.unpack(tb, 2)[i],
                                      jp.body.unpack(jb, 2)[i])
    assert (tbox[:, 3] > 0).any() and (tpk != 0).any()


# ------------------------------------------------------------ ops directly


@pytest.mark.parametrize("select", ["rows", "flat"])
def test_find_peaks_fused(select):
    paf, heat = stub_maps((1, 48, 64, 3))
    h8 = heat[0, :, :, :25]
    want = JPk.find_peaks_fused(jnp.asarray(h8), 48, 64, 0.1, 8,
                                select=select)
    got = TPk.find_peaks_fused(torch.from_numpy(h8), 48, 64, 0.1, 8,
                               select=select)
    for name in ("xy", "valid", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-6, atol=1e-7)
    assert got.count.sum() > 25
    # below 0 the -inf border differs from the mask kernel's 0.0: the
    # NMS+first-K kernel with islx's border takes the peaks
    want = JPk.find_peaks_fused(jnp.asarray(h8 - 0.05), 48, 64, -0.01, 8,
                                select=select)
    got = TPk.find_peaks_fused(torch.from_numpy(h8 - 0.05), 48, 64, -0.01, 8,
                               select=select)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))


@pytest.mark.parametrize("weights", [(0.5, 0.5), (1.0, 0.5)])
def test_find_peaks_pyramid(weights):
    """Two scales' folds (_pyramid_axis_fold, the port's and islx's
    matrices word-equal) and their weighted average's peaks."""
    hb, wb = 48, 64
    heats, folds, jfolds = [], [], []
    for hs, ws, h8p, w8p in ((36, 48, 5, 6), (48, 64, 6, 8)):
        heats.append(stub_maps((2, h8p * 8, w8p * 8, 3))[1][..., :25])
        mats = []
        for sigma in (3.0, 0.0):
            pair = (TPk._pyramid_axis_fold(hb, hs, h8p, 8, sigma),
                    TPk._pyramid_axis_fold(wb, ws, w8p, 8, sigma))
            for t, j in zip(pair, (JPk._pyramid_axis_fold(hb, hs, h8p, 8,
                                                          sigma),
                                   JPk._pyramid_axis_fold(wb, ws, w8p, 8,
                                                          sigma))):
                np.testing.assert_array_equal(t, j)
            mats.append(pair)
        folds.append(tuple(mats))
        jfolds.append(tuple(tuple(jnp.asarray(m) for m in p) for p in mats))
    want = jax.vmap(lambda *hs_: JPk.find_peaks_pyramid(
        list(hs_), jfolds, list(weights), 0.1, 8))(
        *[jnp.asarray(h) for h in heats])
    got = TPk.find_peaks_pyramid([torch.from_numpy(h) for h in heats], folds,
                                 list(weights), 0.1, 8)
    for name in ("xy", "valid", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-6, atol=1e-7)
    assert got.count.sum() > 25


def _pair_inputs(seed=0, b=2, h8=6, w8=8, k=8):
    rng = np.random.RandomState(seed)
    paf8 = stub_maps((b, h8 * 8, w8 * 8, 3))[0]
    xy = np.stack([rng.randint(0, w8 * 8, (b, 25, k)),
                   rng.randint(0, h8 * 8, (b, 25, k))], -1).astype(np.int32)
    valid = rng.rand(b, 25, k) > 0.3
    return paf8, xy, valid


@pytest.mark.parametrize("name,words", [("mxu", False), ("reduce", False),
                                        ("take", True)])
@pytest.mark.parametrize("mid", [10, 4])
def test_score_limbs_8(name, words, mid):
    """The /8 scorers over a batch: ok exactly; scores word-equal for
    ``take`` at mid 10 (the pipelines' default), within 4e-7 (f32 sums in
    another order) for mxu and reduce, and for take at mid 4 (where XLA
    splits the sum into vector lanes)."""
    paf8, xy, valid = _pair_inputs()
    ls, mi = JPaf.LIMB_TABLES["body25"]
    jfn = {"mxu": JPaf.score_limbs_mxu, "reduce": JPaf.score_limbs_fused,
           "take": lambda *a, **k: JPaf.score_limbs_fused(*a, impl="take",
                                                          **k)}[name]
    tfn = {"mxu": TPaf.score_limbs_mxu, "reduce": TPaf.score_limbs_fused,
           "take": lambda *a, **k: TPaf.score_limbs_fused(*a, impl="take",
                                                          **k)}[name]
    want = jax.jit(jax.vmap(lambda p, x, v: jfn(
        p, x, v, jnp.asarray(ls), jnp.asarray(mi), 8, -0.2, mid,
        orig_h=jnp.float32(48.0))))(jnp.asarray(paf8), jnp.asarray(xy),
                                    jnp.asarray(valid))
    got = tfn(torch.from_numpy(paf8), torch.from_numpy(xy),
              torch.from_numpy(valid), ls, mi, 8, -0.2, mid, orig_h=48.0)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    ws, gs = np.asarray(want.score), got.score.numpy()
    if words and mid == 10:
        np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
    else:
        np.testing.assert_allclose(gs, ws, rtol=0, atol=4e-7)
    assert got.ok.sum() > 10
