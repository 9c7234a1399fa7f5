"""Extraction records -> tables and windows on the CPU:
islx_torch.isl.dataset against islx.isl.dataset on the same seeded record
trees. Rows, features, windows and labels are word-equal; data.csv and
STATUS.csv are byte-equal to islx's pandas output (hand-edge columns
exist only where both ends of an edge were found, so rows have other key
sets; a missing cell is empty and an int column with one becomes floats).
"""
import json
import os
import shutil

import numpy as np
import pytest

from islx.core.config import TranslatorConfig as JCfg
from islx.isl import dataset as JD
from islx_torch.core.config import TranslatorConfig
from islx_torch.isl import dataset as D


def seeded_record(rng):
    """A frame record as extraction writes it: 0-3 people over a candidate
    table, 0-3 hands whose missing peaks are (0, 0)."""
    n = rng.randint(0, 30)
    cand = np.zeros((n, 4))
    cand[:, :2] = rng.rand(n, 2) * 300
    cand[:, 2] = rng.rand(n)
    cand[:, 3] = np.arange(n)
    people = rng.randint(0, 4) if n else 0
    subset = -np.ones((people, 27))
    for p in range(people):
        joints = rng.rand(25) < 0.6
        subset[p, :25][joints] = rng.randint(0, n, joints.sum())
        subset[p, 25] = rng.rand() * 20
        subset[p, 26] = joints.sum()
    hands = []
    for _ in range(rng.randint(0, 4)):
        peaks = np.rint(rng.rand(21, 2) * 200)
        peaks[rng.rand(21) < 0.3] = 0
        hands.append(peaks)
    return {"candidate": cand.tolist(), "subset": subset.tolist(),
            "all_hand_peaks": [h.tolist() for h in hands]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """v0-v4 with 3-45 frames; v2 holds an unparseable record and one
    without a candidate table; v4 is empty; v3 has no label."""
    root = tmp_path_factory.mktemp("features")
    rng = np.random.RandomState(0)
    for v, n in enumerate((45, 3, 23, 7, 0)):
        d = root / f"v{v}"
        d.mkdir()
        for i in range(n):
            (d / f"{i:06d}.json").write_text(json.dumps(seeded_record(rng)))
    (root / "v2" / "000023.json").write_text("{not json")
    (root / "v2" / "000024.json").write_text(json.dumps({"subset": []}))
    (root / "v1" / "notes.txt").write_text("not a record")
    return str(root)


LABELS = {"v0": "Hello", "v1": "how are you", "v2": "Bank",
          "v3": "no such sign", "v4": "Hello", "v9": "Hello"}


def test_explode_record_and_runtime_features_word_equal():
    rng = np.random.RandomState(1)
    keysets = set()
    for _ in range(60):
        rec = seeded_record(rng)
        got, want = D.explode_record(rec), JD.explode_record(rec)
        assert list(got) == list(want)
        assert all(type(got[k]) is type(want[k]) and got[k] == want[k]
                   for k in want)
        keysets.add(len(want))
        np.testing.assert_array_equal(D.runtime_features(rec),
                                      JD.runtime_features(rec))
    assert len(keysets) > 5            # rows with other hand-edge columns


def test_build_windows_word_equal(tree):
    x, y = D.build_windows(tree, LABELS)
    jx, jy = JD.build_windows(tree, LABELS)
    assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    # v0: 45 frames -> 3 windows; v1: 1; v2: 23 parseable -> 2; v3/v4 none
    assert x.shape == (6, 20, 156)
    assert (x[2, 5:] == 0).all() and (x[3, 3:] == 0).all()
    small = TranslatorConfig(window_size=8)
    np.testing.assert_array_equal(
        D.build_windows(tree, LABELS, small)[0],
        JD.build_windows(tree, LABELS, JCfg(window_size=8))[0])
    e, ey = D.build_windows(tree, {"v3": "Hello"})
    assert e.shape == (1, 20, 156) and list(ey) == [36]
    none_x, none_y = D.build_windows(tree, {})
    assert none_x.shape == (0, 20, 156) and none_y.shape == (0,)


def _copy(tree, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(tree, dst)
    return str(dst)


def test_build_table_csv_bytes_equal(tree, tmp_path):
    ours, theirs = _copy(tree, tmp_path, "t"), _copy(tree, tmp_path, "j")
    cols, rows = D.build_table(ours)
    df = JD.build_table(theirs)
    assert cols == list(df.columns) and len(rows) == len(df) == 78
    with open(os.path.join(ours, "data.csv"), "rb") as a, \
            open(os.path.join(theirs, "data.csv"), "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    assert b",," in want                    # missing hand-edge cells


def test_build_status_csv_bytes_equal(tree, tmp_path):
    for totals in (None, {"v0": 50, "v1": 3, "v4": 2}):
        ours = _copy(tree, tmp_path, f"t{totals is None}")
        theirs = _copy(tree, tmp_path, f"j{totals is None}")
        cols, rows = D.build_status(ours, totals)
        df = JD.build_status(theirs, totals)
        assert cols == list(df.columns) and len(rows) == 5
        with open(os.path.join(ours, "STATUS.csv"), "rb") as a, \
                open(os.path.join(theirs, "STATUS.csv"), "rb") as b:
            assert a.read() == b.read()


def test_empty_tree_csvs_equal(tmp_path):
    for name, fn, jfn, csv_name in (("a", D.build_table, JD.build_table,
                                     "data.csv"),
                                    ("b", D.build_status, JD.build_status,
                                     "STATUS.csv")):
        ours, theirs = tmp_path / f"t{name}", tmp_path / f"j{name}"
        ours.mkdir()
        theirs.mkdir()
        assert fn(str(ours)) == ([], [])
        jfn(str(theirs))
        assert (ours / csv_name).read_bytes() == \
            (theirs / csv_name).read_bytes()


def test_expression_id():
    assert D.expression_id("hello") == JD.expression_id("hello") == 36
    assert D.expression_id("HOW ARE YOU") == JD.expression_id("How are you")
    assert D.expression_id("nope") is None and D.expression_id(None) is None


def test_write_csv_follows_pandas(tmp_path):
    """The three ways the tables' rows differ from one another, against
    pandas itself: columns in first-seen order across rows with other key
    sets, a missing cell written empty, and an int column with a missing
    cell written as floats (``3.0``)."""
    import pandas as pd

    from islx_torch.isl.extract import _write_csv

    rows = [{"video": "a", "frame": 3, "x": 0.1},
            {"video": "b", "x": 1e-5, "edge_7": 2.0},
            {"video": "c", "frame": 12, "x": np.float64(250.0),
             "edge_2": 7.5}]
    path = tmp_path / "ours.csv"
    _write_csv(str(path), rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    got = path.read_bytes()
    assert got == (tmp_path / "pandas.csv").read_bytes()
    assert got.splitlines()[0] == b"video,frame,x,edge_7,edge_2"
    assert got.splitlines()[1] == b"a,3.0,0.1,,"
