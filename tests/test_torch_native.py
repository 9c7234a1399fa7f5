"""The port's C++ grouping (islx_torch/csrc/grouping.cpp, bound by
islx_torch/ops/native.py) against the port's numpy grouping and islx's own
C++ grouping, on the random tables that tests/test_native.py builds; the
fused pipeline's ``assemble`` with and without ``ISLX_NO_NATIVE``; and a
build without a compiler, which must raise."""
import os
import types

import numpy as np
import pytest
import torch

from islx.ops import native as JN
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.ops import _build, grouping, native
from islx_torch.ops.paf import LIMB_SEQ_BODY25, LIMB_SEQ_COCO
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


def _random_batch(rng, b=6, k=16, c=25, l_tab=LIMB_SEQ_BODY25, m=48):
    """tests/test_native.py's tables: counts 0-5 a channel, sorted
    connection lists with about half the pairs present."""
    l = l_tab.shape[0]
    count = rng.randint(0, 6, size=(b, c)).astype(np.int32)
    xy = rng.randint(0, 200, size=(b, c, k, 2)).astype(np.int32)
    score = rng.rand(b, c, k).astype(np.float32)
    pair = np.zeros((b, l, m), np.int32)
    cscore = np.zeros((b, l, m), np.float32)
    cok = np.zeros((b, l, m), bool)
    for f in range(b):
        for li in range(l):
            a, bb = l_tab[li]
            cands = [(i * k + j, rng.rand()) for i in range(count[f, a])
                     for j in range(count[f, bb]) if rng.rand() < 0.5]
            cands.sort(key=lambda t: -t[1])
            for t, (p, s) in enumerate(cands[:m]):
                pair[f, li, t] = p
                cscore[f, li, t] = s
                cok[f, li, t] = True
    return xy, score, count, pair, cscore, cok


@pytest.mark.parametrize("l_tab,njoint", [(LIMB_SEQ_BODY25, 26),
                                          (LIMB_SEQ_COCO, 19)])
def test_matches_numpy_and_islx(l_tab, njoint):
    rng = np.random.RandomState(0)
    people = 0
    for _ in range(5):
        tables = _random_batch(rng, b=4, c=njoint - 1, l_tab=l_tab)
        got = native.assemble_batch(*tables, 16, l_tab, njoint)
        theirs = JN.assemble_batch(*tables, 16, l_tab, njoint)
        for f in range(4):
            want = grouping.assemble_sorted(*(t[f] for t in tables), 16,
                                            l_tab, njoint)
            for g, w, j in zip(got[f], want, theirs[f]):
                assert g.dtype == w.dtype == j.dtype == np.float64
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, j)
            people += len(got[f][1])
    assert people > 0                     # the merge and prune ran


def test_empty():
    tables = (np.zeros((2, 25, 16, 2), np.int32),
              np.zeros((2, 25, 16), np.float32), np.zeros((2, 25), np.int32),
              np.zeros((2, 24, 48), np.int32),
              np.zeros((2, 24, 48), np.float32), np.zeros((2, 24, 48), bool))
    out = native.assemble_batch(*tables, 16, LIMB_SEQ_BODY25, 26)
    theirs = JN.assemble_batch(*tables, 16, LIMB_SEQ_BODY25, 26)
    for (cand, subset), (jc, js) in zip(out, theirs):
        assert cand.shape == jc.shape == (0, 4)
        assert subset.shape == js.shape == (0, 27)


def test_rejects_tables_it_cannot_take():
    xy, score, count, pair, cscore, cok = _random_batch(
        np.random.RandomState(1), b=2)
    with pytest.raises(ValueError, match="k=8"):
        native.assemble_batch(xy, score, count, pair, cscore, cok, 8,
                              LIMB_SEQ_BODY25, 26)
    count[0, 3] = 17
    with pytest.raises(ValueError, match="counts"):
        native.assemble_batch(xy, score, count, pair, cscore, cok, 16,
                              LIMB_SEQ_BODY25, 26)


@pytest.fixture(scope="module")
def small_pipe():
    return TBP.FusedPosePipeline(W.init_params("body25"),
                                 W.init_params("hand"),
                                 pose_cfg=PoseConfig(max_peaks=16),
                                 hand_cfg=HandConfig(scale_search=(0.25,)),
                                 compute_dtype=torch.float32, device="cpu")


def _packed(tables, b):
    """The random tables as the fused step's bits16 buffer (no hands)."""
    xy, score, count, pair, cscore, cok = (torch.from_numpy(t)
                                           for t in tables)
    pk = types.SimpleNamespace(xy=xy, score=score, count=count)
    cc = types.SimpleNamespace(pair=pair, score=cscore, ok=cok)
    hands = torch.zeros(b * 2 * (4 + 21 + 1), dtype=torch.int32)
    return torch.cat([TBP._pack_body(pk, cc), hands]).numpy()


def test_fused_assemble_same_with_and_without_native(monkeypatch,
                                                     small_pipe):
    b = 6
    packed = _packed(_random_batch(np.random.RandomState(2), b=b), b)
    monkeypatch.delenv("ISLX_NO_NATIVE", raising=False)
    calls = []
    real = native.assemble_batch
    monkeypatch.setattr(native, "assemble_batch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got, boxes, peaks = small_pipe.assemble(packed, b)
    assert calls == [1]                   # one call for the whole batch
    monkeypatch.setenv("ISLX_NO_NATIVE", "1")
    want, wboxes, wpeaks = small_pipe.assemble(packed, b)
    assert calls == [1]
    assert sum(len(s) for _, s in got) > 0
    for (gc, gs), (wc, ws) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(boxes, wboxes)
    np.testing.assert_array_equal(peaks, wpeaks)


def test_missing_compiler_raises(monkeypatch, tmp_path, small_pipe):
    """With no library built and no g++ on PATH the grouping raises,
    through the fused pipeline too; it does not fall back to numpy."""
    monkeypatch.setattr(_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("ISLX_NO_NATIVE", raising=False)
    native._fn.cache_clear()
    try:
        tables = _random_batch(np.random.RandomState(3), b=2)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.assemble_batch(*tables, 16, LIMB_SEQ_BODY25, 26)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            small_pipe.assemble(_packed(tables, 2), 2)
        assert not os.listdir(tmp_path)
    finally:
        native._fn.cache_clear()
