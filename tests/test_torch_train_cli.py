"""The training CLIs on the CPU: islx_torch.cli.train on records the
port's extraction writes, islx_torch.cli.pose_train on seeded ``.npz``
samples (the format of tests/test_pose_train_cli.py), the translator
bundle and ``islx_torch.cli.translate --bundle``, and the flags that are
not ported.

What must hold: islx's loaders read what the CLIs write (the head ``.npz``
with the same probabilities, rtol 1e-5 and atol 1e-6: the same f32 math
summed in another order; the CPM ``.npz`` word for word); the port's
``load_samples`` gives islx's inputs and targets word for word, with
cv2's resize where islx resizes and without it for a ``size x size``
image (a same-size ``cv2.resize`` is an exact copy); from the same
``--init`` file the two pose CLIs train to weights within
``2 * steps * lr`` of each other (Adam moves each weight about ``lr`` a
step, and a gradient within rounding of zero may take the other sign).
The records come from the port's extraction with a seeded stand-in pose
(the nets' own numbers are tests/test_torch_extract.py's).
"""
import csv
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.cli import pose_train as JPCLI
from islx.core import weights as JW
from islx.models import cpm as JC
from islx.models import translator as JT
from islx_torch.cli import pose_train as PCLI
from islx_torch.cli import train as TCLI
from islx_torch.cli import translate as TRCLI
from islx_torch.core import checkpoint as ckpt
from islx_torch.core import weights as W
from islx_torch.isl import dataset as D
from islx_torch.isl import extract as E
from islx_torch.models import translator as T


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stand_in_pose(frame):
    """Seeded pose tables from the frame's first pixel: a person with most
    joints, and two hands with some peaks missing."""
    rng = np.random.RandomState(int(frame[0, 0, 0]) * 7 + 1)
    cand = np.zeros((25, 4))
    cand[:, :2] = rng.rand(25, 2) * 200
    cand[:, 2] = rng.rand(25)
    cand[:, 3] = np.arange(25)
    subset = -np.ones((1, 27))
    joints = rng.rand(25) < 0.8
    subset[0, :25][joints] = np.arange(25)[joints]
    subset[0, 25:] = (10.0, joints.sum())
    hands = [np.rint(rng.rand(21, 2) * 150) * (rng.rand(21, 1) > 0.2)
             for _ in range(2)]
    return cand, subset, hands


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Six videos of 9-31 records from the port's extraction, and labels
    (one video's unknown)."""
    root = tmp_path_factory.mktemp("features")
    cfg = E.ExtractConfig(out_root=str(root))
    rng = np.random.RandomState(0)
    names = {}
    for v, n in enumerate((31, 9, 22, 17, 25, 12)):
        frames = [np.full((8, 8, 3), rng.randint(0, 256), np.uint8)
                  for _ in range(n)]
        E._extract_frames(cfg, stand_in_pose, enumerate(frames), f"vid{v}")
        names[f"vid{v}"] = ("Hello", "Bank", "Book", "Hello", "Money",
                            "not a sign")[v]
    labels = root / "labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_id", "expression"])
        w.writerows(names.items())
    return str(root), str(labels), names


def test_train_cli_head_reads_in_islx(features, tmp_path):
    root, labels, names = features
    out, bundle = str(tmp_path / "head.npz"), str(tmp_path / "bundle")
    TCLI.main([root, "--labels", labels, "--out", out, "--epochs", "2",
               "--batch", "4", "--seed", "3", "--bundle", bundle,
               "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"])
    x, y = D.build_windows(root, names)
    assert x.shape == (8, 20, 156) and len(set(y.tolist())) == 4
    ours = T.load_npz(out)
    theirs = JT.load_npz(out)
    assert set(theirs) == set(ours)
    want = np.asarray(JT.forward(theirs, jnp.asarray(x)))
    with torch.no_grad():
        got = T.build_head(ours, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the head trained: it moved away from the seeded init
    init = T.init_params()
    assert not np.allclose(ours["dense3"]["kernel"], init["dense3"]["kernel"])
    # the bundle holds that head and the seeded nets
    body, hand, head, model_type = ckpt.load_bundle(bundle)
    assert model_type == "body25"
    for name in ours:
        for k in ours[name]:
            np.testing.assert_array_equal(head[name][k], ours[name][k])
    ref = W.init_params("body25")
    assert all(torch.equal(body[n][k], ref[n][k]) for n in ref
               for k in ref[n])
    assert os.path.exists(tmp_path / "ck" / "latest.pt")


def test_bundle_round_trip_and_islx_reads_its_weights(tmp_path):
    body, hand = W.init_params("body25", 4), W.init_params("hand", 5)
    head = T.init_params(seed=6)
    ckpt.save_bundle(str(tmp_path), body, hand, head)
    b, h, hd, mt = ckpt.load_bundle(str(tmp_path))
    assert mt == "body25"
    for got, want in ((b, body), (h, hand)):
        assert set(got) == set(want)
        assert all(torch.equal(got[n][k], want[n][k]) for n in want
                   for k in want[n])
    assert all(np.array_equal(hd[n][k], head[n][k]) for n in head
               for k in head[n])
    jb = JW.load(str(tmp_path / "body.npz"), "body25")
    np.testing.assert_array_equal(
        np.asarray(jb["conv1_1"]["w"]),
        body["conv1_1"]["w"].numpy().transpose(2, 3, 1, 0))
    # islx's bundles are not the port's format, and say why
    (tmp_path / "bundle.json").write_text('{"model_type": "body25", '
                                          '"format": 1}')
    with pytest.raises(ValueError, match="JAX"):
        ckpt.load_bundle(str(tmp_path))


def test_translate_cli_bundle(tmp_path, monkeypatch):
    """--bundle hands its body, hand and head to the per-frame path and
    to the batched pipeline."""
    from islx_torch.isl import translator as TI
    from islx_torch.pipeline import translate as TP
    from islx_torch.pipeline import video as V

    body, hand = W.init_params("body25", 4), W.init_params("hand", 5)
    head = T.init_params(seed=6)
    ckpt.save_bundle(str(tmp_path / "b"), body, hand, head)
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"")
    monkeypatch.delenv("ISLX_INT8", raising=False)
    seen = {}

    class Recorder:
        def __init__(self, *args, **kwargs):
            seen.setdefault(type(self).__name__, []).append((args, kwargs))

        def translate_video_frames(self, src):
            return iter(())

        def translate_video(self, path):
            return iter(())

    class Source(Recorder):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    for mod, name in ((TI, "ISLTranslator"), (TP, "BatchedTranslatePipeline"),
                      (V, "FrameSource")):
        monkeypatch.setattr(mod, name, type(name, (Source,), {}))
    import islx_torch.pose.body as PB
    import islx_torch.pose.hand as PH
    monkeypatch.setattr(PB, "Body", type("Body", (Recorder,), {}))
    monkeypatch.setattr(PH, "Hand", type("Hand", (Recorder,), {}))

    def same(state, want):
        return all(torch.equal(state[n][k], want[n][k]) for n in want
                   for k in want[n])

    TRCLI.main([str(clip), "--bundle", str(tmp_path / "b"), "--device",
                "cpu"])
    (b_args, _), = seen["Body"]
    (h_args, _), = seen["Hand"]
    (t_args, _), = seen["ISLTranslator"]
    assert same(b_args[0], body) and b_args[1] == "body25"
    assert same(h_args[0], hand)
    assert np.array_equal(t_args[2]["dense3"]["kernel"],
                          head["dense3"]["kernel"])
    TRCLI.main([str(clip), "--bundle", str(tmp_path / "b"), "--batched",
                "--device", "cpu"])
    (_, kw), = seen["BatchedTranslatePipeline"]
    assert same(kw["body_params"], body) and same(kw["hand_params"], hand)
    assert np.array_equal(kw["head_params"]["bn0"]["gamma"],
                          head["bn0"]["gamma"])


def test_train_cli_keras_bundle_is_translated(features, tmp_path,
                                              monkeypatch):
    """--keras-bundle writes a one-model .keras of the given body and hand
    weights and the trained head, which islx's importer reads equal; the
    translate CLI's --bundle X.keras hands the same body, hand and head to
    the per-frame path."""
    keras = pytest.importorskip("keras")  # noqa: F841
    from islx.models import one_model as JOM
    from islx_torch.isl import translator as TI
    from islx_torch.pipeline import video as V

    root, labels, _ = features
    body, hand = W.init_params("body25", 4), W.init_params("hand", 5)
    W.save_npz(str(tmp_path / "b.npz"), body)
    W.save_npz(str(tmp_path / "h.npz"), hand)
    out, one = str(tmp_path / "head.npz"), str(tmp_path / "one.keras")
    TCLI.main([root, "--labels", labels, "--out", out, "--epochs", "1",
               "--batch", "4", "--keras-bundle", one, "--body-weights",
               str(tmp_path / "b.npz"), "--hand-weights",
               str(tmp_path / "h.npz"), "--device", "cpu"])
    head = T.load_npz(out)
    jb, jh, jhd = JOM.import_one_model(one)
    for got, want in ((jb, body), (jh, hand)):
        assert set(got) == set(want)
        for n in want:
            for k in want[n]:
                np.testing.assert_array_equal(np.asarray(got[n][k]),
                                              W.to_islx_params(want)[n][k])
    for n in head:
        for k in head[n]:
            np.testing.assert_array_equal(np.asarray(jhd[n][k]), head[n][k])

    seen = {}

    class Recorder:
        def __init__(self, *args, **kwargs):
            seen.setdefault(type(self).__name__, []).append((args, kwargs))

        def translate_video_frames(self, src):
            return iter(())

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    for mod, name in ((TI, "ISLTranslator"), (V, "FrameSource")):
        monkeypatch.setattr(mod, name, type(name, (Recorder,), {}))
    import islx_torch.pose.body as PB
    import islx_torch.pose.hand as PH
    monkeypatch.setattr(PB, "Body", type("Body", (Recorder,), {}))
    monkeypatch.setattr(PH, "Hand", type("Hand", (Recorder,), {}))
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"")
    TRCLI.main([str(clip), "--bundle", one, "--device", "cpu"])
    (b_args, _), = seen["Body"]
    (h_args, _), = seen["Hand"]
    (t_args, _), = seen["ISLTranslator"]
    assert b_args[1] == "body25"
    for got, want in ((b_args[0], body), (h_args[0], hand)):
        assert all(torch.equal(got[n][k], want[n][k]) for n in want
                   for k in want[n])
    assert all(np.array_equal(t_args[2][n][k], head[n][k]) for n in head
               for k in head[n])


@pytest.fixture(scope="module")
def hand_samples(tmp_path_factory):
    """Four 24x24 hand samples (no resize at --size 24) and one 30x40
    sample (resized), in islx's sample format."""
    d = tmp_path_factory.mktemp("hand_ds")
    rng = np.random.RandomState(0)
    for i in range(4):
        img = (rng.rand(24, 24, 3) * 255).astype(np.uint8)
        kp = rng.rand(21, 2).astype(np.float32) * 20 + 2
        np.savez(d / f"s{i}.npz", image=img, keypoints=kp,
                 visible=rng.rand(21) > 0.2)
    other = tmp_path_factory.mktemp("mixed_ds")
    img = (rng.rand(30, 40, 3) * 255).astype(np.uint8)
    np.savez(other / "s.npz", image=img,
             keypoints=rng.rand(2, 25, 2).astype(np.float32) * 28,
             visible=rng.rand(2, 25) > 0.2)
    return str(d), str(other)


@pytest.mark.parametrize("which,model_type", [(0, "hand"), (1, "body25")])
def test_load_samples_word_equal(hand_samples, which, model_type):
    got = PCLI.load_samples(hand_samples[which], 24, model_type)
    want = JPCLI.load_samples(hand_samples[which], 24, model_type)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_load_samples_without_cv2(hand_samples, monkeypatch):
    """A size x size image needs no resize; any other raises without
    cv2 (another resize would give other pixels)."""
    with_cv2 = PCLI.load_samples(hand_samples[0], 24, "hand")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for a, b in zip(PCLI.load_samples(hand_samples[0], 24, "hand"),
                    with_cv2):
        assert np.array_equal(a, b)
    with pytest.raises(RuntimeError, match="cv2"):
        PCLI.load_samples(hand_samples[1], 24, "body25")


def test_pose_train_cli_matches_islx_from_one_init(hand_samples, tmp_path):
    init = str(tmp_path / "init.npz")
    JW.save_npz(init, jax.tree.map(np.asarray, JC.init_params(
        "hand", jax.random.PRNGKey(2))))
    args = [hand_samples[0], "--model-type", "hand", "--epochs", "1",
            "--batch", "2", "--size", "24", "--seed", "3", "--init", init,
            "--lr", "1e-4"]
    JPCLI.main(args + ["--out", str(tmp_path / "j.npz")])
    PCLI.main(args + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    want = JW.load(str(tmp_path / "j.npz"), "hand")
    got = JW.load(str(tmp_path / "t.npz"), "hand")     # islx reads the port's
    start = JW.load(init, "hand")
    assert set(got) == set(want)
    for name in want:
        for k in want[name]:
            g, w = np.asarray(got[name][k]), np.asarray(want[name][k])
            assert np.abs(g - w).max() <= 2 * 2 * 1e-4 + 1e-7, (name, k)
        # every layer trained (a 7x7 tap that only ever sees the 3x3
        # map's zero padding has no gradient)
        assert (np.asarray(got[name]["w"])
                != np.asarray(start[name]["w"])).any(), name
    # and the port's own loader reads the same words
    ours = W.load(str(tmp_path / "t.npz"), "hand")
    np.testing.assert_array_equal(
        ours["conv1_1"]["w"].numpy().transpose(2, 3, 1, 0),
        np.asarray(got["conv1_1"]["w"]))


@pytest.mark.parametrize("main,argv,item", [
    (TCLI.main, ["--mesh-data", "2"], "item 8"),
    (TCLI.main, ["--mesh-model", "2"], "item 8"),
    (PCLI.main, ["--pipeline", "2"], "item 8"),
    (PCLI.main, ["--mesh-data", "2"], "item 8"),
])
def test_unported_flags_name_their_roadmap_item(main, argv, item, capsys):
    base = (["root", "--labels", "l.csv", "--out", "h.npz"]
            if main is TCLI.main else ["data", "--out", "w.npz"])
    with pytest.raises(SystemExit):
        main(base + argv + ["--device", "cpu"])
    assert item in capsys.readouterr().err
