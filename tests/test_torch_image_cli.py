"""The port's demo-surface CLIs against islx's (CPU): camera on a clip the
test writes, demo (default and ``--exact``), dump_features and demo_video
(batched, ``--per-frame``, ``--no-hands``), and the draw functions.

Both packages run the same seeded weights: islx's CLIs take them from a
patched ``cpm.init_params``, and the port's nets are islx's jitted forwards
in the compute dtype the CLI asks for (``weights.build`` patched), so what
is compared is the CLIs and everything around the CPMs (the CPMs
themselves are held by tests/test_torch_coco.py, test_torch_pose.py and
test_torch_quant.py). The hand config is pinned by ``ISLX_HAND_SCALE``
(92 px crops) and ``ISLX_HAND_STAGES``, which both read; the parity
``Hand`` of the ``--exact`` paths runs one scale. The PAF head's bias
points every field the same way, so that limbs connect at the default
thresholds and people and hands form. Outputs must be equal: the images
and videos pixel for pixel, ``features.txt`` word for word, ``pose.json``
with its scores within 1e-4 (f32 sums in another order).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from islx.core import config as JCfg  # noqa: E402
from islx.models import cpm as JC  # noqa: E402
from islx.pose import hand as JHandMod  # noqa: E402
from islx.utils import draw as JDraw  # noqa: E402
from islx_torch.core import config as TCfg  # noqa: E402
from islx_torch.core import weights as W  # noqa: E402
from islx_torch.pose import hand as THandMod  # noqa: E402
from islx_torch.utils import draw as TDraw  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """islx's seeded BODY_25 and hand params: each joint's heat shifted so
    that a tenth of a test frame's map lies above the default thre1 (0.1),
    and every PAF channel's bias raised by 3 (limbs that point down and
    right connect)."""
    body = jax.tree.map(np.asarray, JC.init_params(
        "body25", jax.random.PRNGKey(21)))
    body["Mconv7_stage3_L2"]["b"] = np.array(
        body["Mconv7_stage3_L2"]["b"]) + 3.0
    x = _frames(1, seed=1)[0][None].astype(np.float32) / 256.0 - 0.5
    heat = np.asarray(JC.body25_forward(body, jnp.asarray(x))[1])[0]
    q = np.quantile(heat.reshape(-1, heat.shape[-1]), 0.9, axis=0)
    body["Mconv7_stage1_L1"]["b"] = (np.array(body["Mconv7_stage1_L1"]["b"])
                                     - q + 0.1).astype(np.float32)
    hand = jax.tree.map(np.asarray, JC.init_params(
        "hand", jax.random.PRNGKey(22)))
    return {"body25": body, "hand": hand}


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def forwards():
    """islx's jitted forwards, made once for the module (one compile a
    shape and dtype)."""
    fb = jax.jit(lambda p, x, cd: JC.body25_forward(p, x, cd),
                 static_argnums=2)
    fh = jax.jit(lambda p, x, cd, s: JC.hand_forward(p, x, cd, s),
                 static_argnums=(2, 3))
    return fb, fh


class _IslxNet:
    """A port ``net``: islx's forward on islx's params."""

    def __init__(self, fwd, p, model_type):
        self.fwd, self.p, self.model_type = fwd, p, model_type
        self.quantized = False

    def __call__(self, x, cd, stages=6):
        args = (self.p, jnp.asarray(x.float().numpy()), _JDT[cd])
        if self.model_type == "hand":
            return torch.from_numpy(np.array(self.fwd(*args, stages)))
        return tuple(torch.from_numpy(np.array(m)) for m in self.fwd(*args))


@pytest.fixture
def env(monkeypatch, params, forwards):
    """Both packages on the same weights and the pinned hand config."""
    for var in ("ISLX_INT8", "ISLX_WEIGHTS_DIR", "ISLX_PACK_MODE",
                "ISLX_PALLAS_NMS", "ISLX_PALLAS_MASK", "ISLX_PEAKS_SELECT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("ISLX_HAND_SCALE", "0.25")
    monkeypatch.setenv("ISLX_HAND_STAGES", "2")
    monkeypatch.setattr(JC, "init_params",
                        lambda mt, *a, **k: params[mt])
    fb, fh = forwards

    def build(model_type, state, device, compute_dtype):
        return _IslxNet(fh if model_type == "hand" else fb,
                        params[model_type], model_type)

    monkeypatch.setattr(W, "build", build)
    one = dict(scale_search=(0.25,), stages=2)      # the parity Hand's
    monkeypatch.setattr(JHandMod, "HandConfig",
                        lambda: JCfg.HandConfig(**one))
    monkeypatch.setattr(THandMod, "HandConfig",
                        lambda: TCfg.HandConfig(**one))
    return params


def _frames(n=5, h=184, w=96, seed=0):
    rng = np.random.RandomState(seed)
    base = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(n)]


def _write_clip(path, frames):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 15,
                         (w, h))
    for f in frames:
        vw.write(f)
    vw.release()


def _read_clip(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


def test_camera_on_a_clip(env, tmp_path, capsys):
    """``--source`` a clip, ``--max-frames 3 --out``: the fused step (and
    ``--multi-person``, the split one) annotates the same frames."""
    from islx.cli import camera as jcam
    from islx_torch.cli import camera as tcam

    clip = tmp_path / "clip.avi"
    _write_clip(clip, _frames())
    for extra in ([], ["--multi-person"]):
        outs = []
        for main, name in ((jcam.main, "j.avi"), (tcam.main, "t.avi")):
            argv = ["--source", str(clip), "--max-frames", "3", "--out",
                    str(tmp_path / name), "--no-window", *extra]
            main(argv + (["--device", "cpu"] if main is tcam.main else []))
            outs.append(_read_clip(tmp_path / name))
        assert outs[0].shape[0] == 3
        np.testing.assert_array_equal(outs[1], outs[0])
    assert "annotated 3 frames" in capsys.readouterr().out


def _pose_of_image(env, img, exact):
    """(islx, port) ``build_pose`` outputs on one image."""
    import argparse

    from islx.cli import demo as jdemo
    from islx_torch.cli import demo as tdemo

    args = argparse.Namespace(body_weights=None, hand_weights=None,
                              model_type="body25", exact=exact,
                              device="cpu")
    return (jdemo.build_pose(args, calib_image=img)(img),
            tdemo.build_pose(args, calib_image=img)(img))


@pytest.mark.parametrize("exact", [False, True], ids=["default", "exact"])
def test_demo(env, tmp_path, exact):
    """The demo on one image: the same people and hands (ImagePose, or
    ``--exact`` through ISLSignPos), and the same annotated PNG."""
    from islx.cli import demo as jdemo
    from islx_torch.cli import demo as tdemo

    img = _frames(1, seed=1)[0]
    path = tmp_path / "img.png"
    cv2.imwrite(str(path), img)
    (jc, js, jh), (tc, ts, th) = _pose_of_image(env, img, exact)
    np.testing.assert_array_equal(tc[:, [0, 1, 3]], jc[:, [0, 1, 3]])
    np.testing.assert_allclose(tc[:, 2], jc[:, 2], atol=1e-4)
    np.testing.assert_array_equal(ts[:, :-2], js[:, :-2])
    assert len(th) == len(jh) and len(js) > 0 and len(jh) > 0
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(a, b)
    flag = ["--exact"] if exact else []
    jdemo.main([str(path), "--out", str(tmp_path / "j.png"), *flag])
    tdemo.main([str(path), "--out", str(tmp_path / "t.png"), *flag,
                "--device", "cpu"])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")),
                                  cv2.imread(str(tmp_path / "j.png")))


def _same_json(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same_json(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_json(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-4
    else:
        assert got == want


def test_dump_features(env, tmp_path):
    """features.txt word for word, pose.json (scores within 1e-4), and the
    sticks and annotated renders pixel for pixel, from a clip's frame 2."""
    from islx.cli import dump_features as jdump
    from islx_torch.cli import dump_features as tdump

    clip = tmp_path / "clip.avi"
    _write_clip(clip, _frames(seed=2))
    jdump.main([str(clip), "--frame", "2", "--out-dir", str(tmp_path / "j")])
    tdump.main([str(clip), "--frame", "2", "--out-dir", str(tmp_path / "t"),
                "--device", "cpu"])
    j, t = tmp_path / "j", tmp_path / "t"
    assert (t / "features.txt").read_text() == \
        (j / "features.txt").read_text()
    feats = np.loadtxt(t / "features.txt")
    assert feats.shape == (156,) and np.count_nonzero(feats) > 10
    want = json.loads((j / "pose.json").read_text())
    _same_json(json.loads((t / "pose.json").read_text()), want)
    assert want["subset"] and want["all_hand_peaks"]
    for name in ("sticks.jpg", "annotated.jpg"):
        np.testing.assert_array_equal(cv2.imread(str(t / name)),
                                      cv2.imread(str(j / name)))


@pytest.mark.parametrize("flags", [["--batch", "4"],
                                   ["--batch", "4", "--no-hands"],
                                   ["--per-frame"]],
                         ids=["fused", "no-hands", "per-frame"])
def test_demo_video(env, tmp_path, flags):
    """Five frames in batches of 4 (the tail padded), the body pipeline
    alone, or the per-frame parity path: the same annotated video."""
    from islx.cli import demo_video as jvid
    from islx_torch.cli import demo_video as tvid

    clip = tmp_path / "clip.avi"
    _write_clip(clip, _frames(seed=3))
    jvid.main([str(clip), "--out", str(tmp_path / "j.avi"), *flags])
    tvid.main([str(clip), "--out", str(tmp_path / "t.avi"), *flags,
               "--device", "cpu"])
    got, want = _read_clip(tmp_path / "t.avi"), _read_clip(tmp_path / "j.avi")
    assert want.shape[0] == 5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model_type", ["body25", "coco"])
def test_draw_functions_pixel_equal(model_type):
    """draw_bodypose, draw_handpose (with numbers) and crop_to_drawing
    give islx's pixels on the same tables."""
    rng = np.random.RandomState(4)
    njoint = 25 if model_type == "body25" else 18
    canvas = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    cand = np.c_[rng.uniform(0, 160, 40), rng.uniform(0, 120, 40),
                 rng.rand(40), np.arange(40)]
    subset = -np.ones((3, njoint + 2))
    for p in range(3):
        idx = rng.choice(40, njoint, replace=False)
        keep = rng.rand(njoint) > 0.2
        subset[p, :njoint] = np.where(keep, idx, -1)
    hands = [np.c_[rng.randint(0, 160, 21), rng.randint(0, 120, 21)]
             for _ in range(2)]
    hands[0][3] = 0
    got = TDraw.draw_bodypose(canvas, cand, subset, model_type)
    np.testing.assert_array_equal(
        got, JDraw.draw_bodypose(canvas, cand, subset, model_type))
    np.testing.assert_array_equal(
        TDraw.draw_handpose(got, hands, show_number=True),
        JDraw.draw_handpose(got, hands, show_number=True))
    pad = np.zeros((200, 220, 3), np.uint8)
    pad[30:150, 40:200] = got
    np.testing.assert_array_equal(TDraw.crop_to_drawing(pad),
                                  JDraw.crop_to_drawing(pad))
    assert TDraw.crop_to_drawing(pad).shape[:2] == (120, 160)


def test_frame_writer_and_entry_points_without_gpu(tmp_path, monkeypatch):
    """FrameWriter writes what cv2 reads back (cv2's writer here, where
    ffmpeg is missing, as islx's does); the CLIs raise without a GPU
    unless --device cpu is given."""
    from islx_torch.cli import camera, demo, demo_video, dump_features
    from islx_torch.pipeline.video import FrameWriter, probe

    frames = _frames(3)
    with FrameWriter(str(tmp_path / "w.avi"), 10.0, frames[0].shape[:2],
                     vcodec="libx264") as w:
        for f in frames:
            w(f)
    meta = probe(str(tmp_path / "w.avi"))
    assert (meta.height, meta.width) == (184, 96) and meta.fps > 0
    assert _read_clip(tmp_path / "w.avi").shape[0] == 3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = tmp_path / "i.png"
    cv2.imwrite(str(img), frames[0])
    clip = tmp_path / "c.avi"
    _write_clip(clip, frames)
    for main, argv in ((demo.main, [str(img)]),
                       (dump_features.main, [str(img), "--out-dir",
                                             str(tmp_path / "d")]),
                       (camera.main, ["--source", str(clip), "--no-window"]),
                       (demo_video.main, [str(clip)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not os.path.exists(tmp_path / "d")
