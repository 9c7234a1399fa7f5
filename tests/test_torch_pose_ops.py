"""islx_torch pose ops against islx on the same inputs (CPU): PAF scoring +
compaction, device hand boxes, hand peak refinement, the bits16 packing
helpers, host grouping and the 156-d features."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import DetectorConfig as JDet
from islx.isl import features as JF
from islx.ops import grouping as JG
from islx.ops import hand_boxes as JHB
from islx.ops import hand_peaks as JHP
from islx.ops import paf as JP
from islx.ops.peaks import Peaks as JPeaks
from islx.pipeline import batch_pose as JBP
from islx_torch.core.config import DetectorConfig
from islx_torch.isl import features as TF
from islx_torch.ops import grouping as TG
from islx_torch.ops import hand_boxes as THB
from islx_torch.ops import hand_peaks as THP
from islx_torch.ops import paf as TP
from islx_torch.ops.peaks import Peaks as TPeaks
from islx_torch.pipeline import batch_pose as TBP


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _peak_tables(rng, b, c, k, h, w, dup=True):
    """Random per-channel peak tables [B,C,K,2] (+ valid/count), row-major
    sorted; with ``dup`` some channels repeat a peak so pair scores tie."""
    xy = np.zeros((b, c, k, 2), np.int32)
    valid = np.zeros((b, c, k), bool)
    for i in range(b):
        for ch in range(c):
            n = rng.randint(0, k + 1)
            flat = np.sort(rng.choice(h * w, n, replace=False))
            xy[i, ch, :n, 0] = flat % w
            xy[i, ch, :n, 1] = flat // w
            valid[i, ch, :n] = True
            if dup and n >= 2 and ch % 3 == 0:
                xy[i, ch, 1] = xy[i, ch, 0]           # identical candidates
    return xy, valid


def test_limb_tables_equal():
    for name in ("body25", "coco"):
        for a, b in zip(JP.LIMB_TABLES[name], TP.LIMB_TABLES[name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("thre2", [0.05, -0.2])
def test_score_limbs_cell_and_compact(rng, thre2):
    """int8-count cell scoring: ok exact, scores f32-tight; compaction of
    the same scores: pair order exact, ties lower index first."""
    b, h8, w8, k = 2, 6, 8, 8
    paf8 = (rng.rand(b, h8, w8, 52).astype(np.float32) - 0.4)
    xy, valid = _peak_tables(rng, b, 25, k, h8 * 8, w8 * 8)
    want = jax.vmap(lambda p, x, v: JP.score_limbs_cell(
        p, x, v, jnp.asarray(JP.LIMB_SEQ_BODY25),
        jnp.asarray(JP.MAP_IDX_BODY25), 8, thre2, 10,
        orig_h=jnp.float32(h8 * 8), count_dtype=jnp.int8))(
        jnp.asarray(paf8), jnp.asarray(xy), jnp.asarray(valid))
    got = TP.score_limbs_cell(_t(paf8), _t(xy), _t(valid),
                              TP.LIMB_SEQ_BODY25, TP.MAP_IDX_BODY25, 8,
                              thre2, 10, orig_h=float(h8 * 8))
    np.testing.assert_array_equal(np.asarray(want.ok), got.ok.numpy())
    assert got.ok.any()
    ok = np.asarray(want.ok)
    np.testing.assert_allclose(np.asarray(want.score)[ok],
                               got.score.numpy()[ok], rtol=1e-6, atol=1e-6)

    # compaction on the SAME LimbScores (ties from duplicated peaks)
    same = TP.LimbScores(score=_t(np.asarray(want.score)), ok=_t(ok))
    cw = jax.vmap(lambda s, o: JP.compact_connections(
        JP.LimbScores(s, o), 48))(want.score, want.ok)
    cg = TP.compact_connections(same, 48)
    np.testing.assert_array_equal(np.asarray(cw.pair), cg.pair.numpy())
    np.testing.assert_array_equal(np.asarray(cw.ok), cg.ok.numpy())
    np.testing.assert_array_equal(np.asarray(cw.score), cg.score.numpy())


def test_compact_connections_ties_lower_index_first():
    score = np.zeros((1, 2, 8, 8), np.float32)
    score[0, 0] = 0.5                                  # all tied
    score[0, 1, ::2] = 0.25
    ok = np.ones_like(score, bool)
    ok[0, 1, 3] = False
    cw = JP.compact_connections(JP.LimbScores(jnp.asarray(score[0]),
                                              jnp.asarray(ok[0])), 48)
    cg = TP.compact_connections(TP.LimbScores(_t(score), _t(ok)), 48)
    np.testing.assert_array_equal(np.asarray(cw.pair), cg.pair.numpy()[0])
    np.testing.assert_array_equal(cg.pair.numpy()[0, 0], np.arange(48))


def _cc_tables(rng, b, l, k, m):
    pair = np.stack([np.stack([rng.permutation(k * k)[:m]
                               for _ in range(l)]) for _ in range(b)])
    score = rng.choice([0.1, 0.3, 0.5, 0.7], size=(b, l, m)).astype(
        np.float32)                                    # many exact ties
    ok = rng.rand(b, l, m) > 0.3
    return pair.astype(np.int32), score, ok


@pytest.mark.parametrize("hw", [(184, 328, 720, 1280), (48, 48, 48, 48),
                                (96, 64, 100, 70)])
def test_device_hand_boxes_exact(rng, hw):
    hb, wb, h0, w0 = hw
    b, k, m = 6, 8, 48
    xy, _ = _peak_tables(rng, b, 25, k, hb, wb, dup=False)
    pair, score, ok = _cc_tables(rng, b, 24, k, m)
    sy, sx = h0 / hb, w0 / wb
    want = jax.vmap(lambda x, p, s, o: JHB.device_hand_boxes(
        x, p, s, o, JP.LIMB_SEQ_BODY25, sy, sx, hb, wb, JDet()))(
        jnp.asarray(xy), jnp.asarray(pair), jnp.asarray(score),
        jnp.asarray(ok))
    got = THB.device_hand_boxes(_t(xy), _t(pair), _t(score), _t(ok),
                                TP.LIMB_SEQ_BODY25, sy, sx, hb, wb,
                                DetectorConfig())
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy()[..., 2] > 0).any()


@pytest.mark.parametrize("hw", [(11, 11), (23, 23), (5, 7)])
def test_find_hand_peaks_refine_exact(rng, hw):
    """Blobs near the centre and at the borders (clamped windows)."""
    h8, w8 = hw
    n, c = 3, 22
    yy, xx = np.mgrid[0:h8, 0:w8]
    heat = np.zeros((n, h8, w8, c), np.float32)
    for i in range(n):
        for ch in range(c):
            cy, cx = rng.uniform(-1, h8), rng.uniform(-1, w8)
            amp = rng.choice([0.0, 0.03, 0.4, 1.0])
            heat[i, :, :, ch] = amp * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(0.5, 4))
    heat += rng.rand(*heat.shape).astype(np.float32) * 0.02
    want = jax.vmap(lambda h: JHP.find_hand_peaks_refine(h[..., :21], 0.05))(
        jnp.asarray(heat))
    got = THP.find_hand_peaks_refine(_t(heat)[..., :21], 0.05)
    np.testing.assert_array_equal(np.asarray(want.found), got.found.numpy())
    np.testing.assert_array_equal(np.asarray(want.xy), got.xy.numpy())


def test_pack_helpers_word_equal(rng):
    lo = rng.randint(0, 1 << 16, (5, 7))
    hi = rng.randint(0, 1 << 16, (5, 7))
    np.testing.assert_array_equal(
        np.asarray(JBP._pack2x16(jnp.asarray(lo), jnp.asarray(hi))),
        TBP._pack2x16(_t(lo), _t(hi)).numpy())
    p = rng.randint(128, 256, (3, 12, 4))              # bit 31 set
    p[0, 0] = [0, 0, 0, 255]
    want = np.asarray(JBP._pack4x8(jnp.asarray(p)))
    assert (want < 0).all()
    np.testing.assert_array_equal(want, TBP._pack4x8(_t(p)).numpy())
    x = (rng.randn(4, 6) * 3).astype(np.float32)
    x[0, :2] = [-np.inf, 1e-8]
    x[1, :2] = [65504.0, -0.0]
    want = np.asarray(JBP._packf16x2(jnp.asarray(x)))
    got = TBP._packf16x2(_t(x)).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(JBP._unpackf16x2(want),
                                  TBP._unpackf16x2(got))


@pytest.mark.parametrize("k", [8, 16, 20])
def test_pack_body_bits16_word_equal(rng, k):
    """Same peak/connection tables -> the same bits16 words, with pair
    bytes >= 128 (bit 31) when K*K <= 256 and s16 pairs above."""
    b, c, l, m = 2, 25, 24, 48
    xy, valid = _peak_tables(rng, b, c, k, 184, 328, dup=False)
    score = rng.rand(b, c, k).astype(np.float32)
    count = valid.sum(-1).astype(np.int32)
    pair = rng.randint(max(0, k * k - 128), k * k, (b, l, m)).astype(np.int32)
    cscore = rng.rand(b, l, m).astype(np.float32)
    cok = rng.rand(b, l, m) > 0.4
    jpk = JPeaks(jnp.asarray(xy), jnp.asarray(score), jnp.asarray(valid),
                 jnp.asarray(count))
    jcc = JP.CompactConnections(jnp.asarray(pair), jnp.asarray(cscore),
                                jnp.asarray(cok))
    want = np.asarray(JBP._pack_body(jpk, jcc, "bits16"))
    tpk = TPeaks(_t(xy), _t(score), _t(valid), _t(count))
    tcc = TP.CompactConnections(_t(pair), _t(cscore), _t(cok))
    got = TBP._pack_body(tpk, tcc).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, got)
    assert want.size == TBP._body_pack_len(b, c, k, l, m) == \
        JBP._body_pack_len(b, c, k, l, m, "bits16")


def test_grouping_and_features_exact(rng):
    """Host grouping (numpy copy) and 156-d features on the same tables."""
    k, c, l, m = 8, 25, 24, 48
    people = 0
    for trial in range(6):
        xy, valid = _peak_tables(rng, 1, c, k, 184, 144, dup=False)
        count = valid.sum(-1).astype(np.int32)[0]
        score = rng.rand(c, k).astype(np.float32)
        pair, cscore, cok = _cc_tables(rng, 1, l, k, m)
        cscore = np.sort(cscore[0], axis=-1)[:, ::-1].copy()
        cok = np.sort(cok[0], axis=-1)[:, ::-1].copy()   # ok entries first
        pair = pair[0]
        want = JG.assemble_sorted(xy[0], score, count, pair, cscore, cok, k,
                                  JP.LIMB_SEQ_BODY25, 26)
        got = TG.assemble_sorted(xy[0], score, count, pair, cscore, cok, k,
                                 TP.LIMB_SEQ_BODY25, 26)
        np.testing.assert_array_equal(want[0], got[0])
        np.testing.assert_array_equal(want[1], got[1])
        people += len(got[1])
        hands = [rng.randint(0, 300, (21, 2)) for _ in range(trial % 3)]
        if hands:
            hands[0][3] = 0                            # missing part
        np.testing.assert_array_equal(
            JF.frame_features(want[0], want[1], hands),
            TF.frame_features(got[0], got[1], hands))
    assert people > 0
    assert TF.FEATURE_DIM == JF.FEATURE_DIM == 156
