"""The per-frame translation path and the translate CLI on the CPU, against
islx's on the same clip (written with cv2) and the same full-width seeded
weights and head: keras head files read into equal arrays,
``ISLTranslator``'s window API, and the lines both CLIs print on their
default per-frame path and with ``--batched``.

The setup of tests/test_torch_translate.py: seeded full-width weights
with the arm joints' heat bias raised, thre1 at the 80th percentile of the
clip's joint heatmaps, ``thre2=-0.5``, ``max_peaks=8``, 92 px hand crops
(both pipelines' configs patched alike), f32, 184x96 frames, and a
3-frame window in place of 20 (the window logic is the same; the head's
weights do not depend on its length). The printed probability (4 decimals)
may differ in its last digit: the head's f32 BiLSTM sums in another order
than XLA's, so probabilities agree within atol 1e-5 (as in
tests/test_torch_translate.py); frame indices and classes are equal.
"""
import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.cli import translate as JCLI
from islx.core import weights as JW
from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.core.config import TranslatorConfig as JTrCfg
from islx.isl import translator as JTr
from islx.models import translator as JT
from islx.pipeline import translate as JPipe
from islx.pose import body as JBody
from islx.pose import hand as JHandMod
from islx_torch.cli import translate as TCLI
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.core.config import TranslatorConfig as TTrCfg
from islx_torch.isl import translator as TTr
from islx_torch.models import translator as TT
from islx_torch.pipeline import translate as TPipe
from islx_torch.pose import body as TBody
from islx_torch.pose import hand as THandMod


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

cv2 = pytest.importorskip("cv2")

H, WD = 184, 96


def write_clip(path, seed, n):
    """An MJPG clip of ``n`` 184x96 frames: a smooth random image that
    moves 2 px a frame."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(64, 32, 3) * 255).astype(np.uint8)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 15,
                          (WD, H))
    for i in range(n):
        out.write(cv2.resize(np.roll(base, 2 * i, axis=1), (WD, H),
                             interpolation=cv2.INTER_CUBIC))
    out.release()
    return path


WINDOW = 3           # the translator's window, cut from 20 to keep it small


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The head files (.npz, .keras, .h5), a clip of WINDOW + 1 frames,
    and both packages patched alike: the seeded weights read from memory
    for the weight files, the small configs and the WINDOW-frame window."""
    d = tmp_path_factory.mktemp("translate")
    state = {"body25": W.init_params("body25", 0),
             "hand": W.init_params("hand", 1)}
    bias = state["body25"]["Mconv7_stage1_L1"]["b"].clone()
    bias[2:8] += 1.0                     # arm joints present: hands fire
    state["body25"]["Mconv7_stage1_L1"]["b"] = bias
    jstate = {k: W.to_islx_params(v) for k, v in state.items()}
    head = jax.tree.map(np.asarray, JT.init_params(key=jax.random.PRNGKey(3)))
    paths = {k: str(d / f"{k}") for k in
             ("body.npz", "hand.npz", "head.npz", "head.keras", "head.h5")}
    JT.save_npz(paths["head.npz"], head)
    model = JT.build_keras_head()
    model.set_weights([w for ws in JT.to_keras_weights(head) for w in ws])
    model.save(paths["head.keras"])
    model.save(paths["head.h5"])
    clip = write_clip(str(d / "clip.avi"), 0, WINDOW + 1)

    from islx_torch.pipeline.video import FrameSource

    with FrameSource(clip) as src:
        frames = list(src)
    net = W.build("body25", state["body25"], "cpu", torch.float32)
    with torch.no_grad():
        heat = net(torch.from_numpy(np.stack(frames)).float() / 256.0
                   - 0.5)[1]
    pose = dict(max_peaks=8, thre2=-0.5,
                thre1=float(np.quantile(heat[..., :25].numpy(), 0.8)))
    small = dict(scale_search=(0.25,))
    mp = pytest.MonkeyPatch()
    for var in ("ISLX_INT8", "ISLX_HAND_STAGES", "ISLX_PALLAS_NMS",
                "ISLX_WEIGHTS_DIR"):
        mp.delenv(var, raising=False)
    mp.setenv("ISLX_PALLAS_MASK", "1")
    mp.setenv("ISLX_HAND_SCALE", "0.25")
    mp.setattr(JW, "load", lambda path, mt, *a: jstate[mt])
    mp.setattr(W, "load", lambda path, mt: state[mt])
    mp.setattr(JBody, "Body", functools.partial(JBody.Body,
                                                config=JPose(**pose)))
    mp.setattr(TBody, "Body", functools.partial(TBody.Body,
                                                config=PoseConfig(**pose)))
    mp.setattr(JHandMod, "Hand", functools.partial(JHandMod.Hand,
                                                   config=JHand(**small)))
    mp.setattr(THandMod, "Hand", functools.partial(
        THandMod.Hand, config=HandConfig(**small)))
    win = dict(cfg=JTrCfg(window_size=WINDOW))
    mp.setattr(JTr, "ISLTranslator", functools.partial(JTr.ISLTranslator,
                                                       **win))
    mp.setattr(TTr, "ISLTranslator", functools.partial(
        TTr.ISLTranslator, cfg=TTrCfg(window_size=WINDOW)))
    mp.setattr(JPipe, "BatchedTranslatePipeline", functools.partial(
        JPipe.BatchedTranslatePipeline, pose_cfg=JPose(**pose),
        compute_dtype=jnp.float32, **win))
    mp.setattr(TPipe, "BatchedTranslatePipeline", functools.partial(
        TPipe.BatchedTranslatePipeline, pose_cfg=PoseConfig(**pose),
        compute_dtype=torch.float32, cfg=TTrCfg(window_size=WINDOW)))
    yield dict(paths=paths, clip=clip, head=head, state=state)
    mp.undo()


@pytest.mark.parametrize("ext", ["keras", "h5"])
def test_load_keras_equal(env, ext):
    """A head saved by keras (islx's build_keras_head and
    to_keras_weights) loads into the arrays islx's load_keras gives, with
    h5py and no keras; the port's to/from_keras_weights and save_npz
    round trips equal islx's."""
    path = env["paths"][f"head.{ext}"]
    want = JT.load_keras(path)
    got = TT.load_keras(path)
    assert sorted(got) == sorted(want)
    for name, entry in want.items():
        assert sorted(got[name]) == sorted(entry)
        for k, v in entry.items():
            np.testing.assert_array_equal(got[name][k], np.asarray(v))
            assert got[name][k].dtype == np.float32
    jw, tw = JT.to_keras_weights(env["head"]), TT.to_keras_weights(got)
    assert [len(x) for x in tw] == [len(x) for x in jw]
    for a, b in zip(jw, tw):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    again = TT.from_keras_weights(tw)
    assert all(np.array_equal(again[n][k], got[n][k])
               for n in got for k in got[n])


def test_save_npz_loads_in_islx(env, tmp_path):
    path = str(tmp_path / "h.npz")
    TT.save_npz(path, TT.load_npz(env["paths"]["head.npz"]))
    want, got = JT.load_npz(env["paths"]["head.npz"]), JT.load_npz(path)
    for name, entry in want.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(np.asarray(got[name][k]),
                                          np.asarray(v))


def test_translator_window_api(env):
    """push/reset, the zero-padded short window, ``__call__`` over a
    window and ``top_expression`` equal islx's, on stub poses (the window
    logic; the real nets run in the CLI test below)."""
    rng = np.random.RandomState(5)
    feats = [rng.rand(156) * 100 for _ in range(23)]

    class Stub:
        model_type = "body25"
        device = torch.device("cpu")

    jt = JTr.ISLTranslator.func(Stub(), Stub(), env["head"])
    tt = TTr.ISLTranslator.func(Stub(), Stub(), env["head"])
    it_j, it_t = iter(feats), iter(feats)
    jt.frame_features = lambda f: next(it_j)
    tt.frame_features = lambda f: next(it_t)
    for i in range(len(feats)):
        pj, pt = jt.push(None), tt.push(None)
        assert (pj is None) == (pt is None) == (i < 19)
        if pj is not None:
            np.testing.assert_allclose(pt, pj, atol=1e-5)
            assert tt.top_expression(pt)[:2] == jt.top_expression(pj)[:2]
    short = np.stack(feats[:7])
    np.testing.assert_allclose(tt.predict_from_features(short),
                               jt.predict_from_features(short), atol=1e-5)
    tt.reset()
    jt.reset()
    assert tt._window == jt._window == []
    it_j, it_t = iter(feats), iter(feats)
    window = np.zeros((5, 4, 4, 3), np.uint8)
    got, want = tt(window), jt(window)
    assert got.shape == want.shape == (1, 167)
    np.testing.assert_allclose(got, want, atol=1e-5)


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [line for line in out.getvalue().splitlines()
            if line[:1].isdigit()]


def same_lines(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gi, gp, gc = g.split(" ")
        wi, wp, wc = w.split(" ")
        assert (gi, gc) == (wi, wc)
        assert abs(float(gp) - float(wp)) <= 1.5e-4


def people_and_hands(feats):
    """The frames' features hold body and hand keypoints."""
    feats = np.stack(feats)
    assert np.count_nonzero(feats[:, :30]) > 0
    assert np.count_nonzero(feats[:, 30:]) > 0


def test_cli_per_frame_lines_equal(env, monkeypatch):
    """The default (reference-exact, per-frame) path with a .keras head:
    one prediction a frame once the window is full, the same as islx's."""
    p = env["paths"]
    args = [env["clip"], "--body-weights", p["body.npz"], "--hand-weights",
            p["hand.npz"], "--head", p["head.keras"]]
    want = run(JCLI.main, args)
    feats, real = [], TTr.ISLTranslator.func.frame_features
    monkeypatch.setattr(TTr.ISLTranslator.func, "frame_features",
                        lambda self, f: feats.append(real(self, f))
                        or feats[-1])
    got = run(TCLI.main, args + ["--device", "cpu"])
    assert [g.split()[0] for g in got] == [str(WINDOW - 1), str(WINDOW)]
    same_lines(got, want)
    people_and_hands(feats)


def test_cli_batched_lines_equal(env, monkeypatch):
    p = env["paths"]
    args = [env["clip"], "--batched", "--batch", "2", "--body-weights",
            p["body.npz"], "--hand-weights", p["hand.npz"], "--head",
            p["head.h5"]]
    want = run(JCLI.main, args)
    feats, real = [], TPipe.BatchedTranslatePipeline.func._features
    monkeypatch.setattr(TPipe.BatchedTranslatePipeline.func, "_features",
                        lambda self, *a: feats.extend(real(self, *a))
                        or feats[-len(a[0]):])
    got = run(TCLI.main, args + ["--device", "cpu"])
    assert [g.split()[0] for g in got] == [str(WINDOW - 1), str(WINDOW)]
    same_lines(got, want)
    people_and_hands(feats)


def test_cli_keras_bundle_lines_equal_npz(env, tmp_path):
    """--bundle X.keras (a one-model artifact of the same nets and head)
    prints the lines that the same weights and the head as .npz print."""
    from islx_torch.models import one_model as OM

    p = env["paths"]
    one = str(tmp_path / "one.keras")
    OM.export_one_model(env["state"]["body25"], env["state"]["hand"],
                        TT.load_npz(p["head.npz"]), one)
    want = run(TCLI.main, [env["clip"], "--body-weights", p["body.npz"],
                           "--hand-weights", p["hand.npz"], "--head",
                           p["head.npz"], "--device", "cpu"])
    got = run(TCLI.main, [env["clip"], "--bundle", one, "--device", "cpu"])
    assert [g.split()[0] for g in got] == [str(WINDOW - 1), str(WINDOW)]
    assert got == want


def test_cli_rejects_unported_flags(env, capsys):
    for flag, value, item in (("--mesh-data", "2", "item 8"),):
        with pytest.raises(SystemExit):
            TCLI.main([env["clip"], flag, value, "--device", "cpu"])
        assert item in capsys.readouterr().err
