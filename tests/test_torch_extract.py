"""Dataset extraction on the CPU: islx_torch.cli.extract against
islx.cli.extract, both back ends, on clips the test writes with cv2 and the
same full-width seeded weights, with augmentation on and stick figures
written.

The setup of tests/test_torch_translate.py: seeded full-width weights
with the arm joints' heat bias raised (so people and hand boxes form),
thre1 at the 80th percentile of the clip's joint heatmaps, ``thre2=-0.5``,
``max_peaks=8``, 92 px hand crops (``ISLX_HAND_SCALE=0.25``), f32, and
184x96 clips (a bucket size with probed crop orders). The default back end
is islx's TPU main path (``ISLX_PALLAS_MASK=1``). Both CLIs run with the
same patches: the pipelines' configs, augmentation switched on in
``ExtractConfig``, and a stepping clock in place of ``time`` so that
``exec_time_s`` is the same number.

The port's fused pipeline runs with islx's jitted CPM forwards in place
of its own nets (the same weights): the f32 CPMs sum in another order than
XLA's (held within rtol 1e-4 by
tests/test_torch_pose.py::test_real_nets_match), and on rotated frames
that moves a peak at an NMS near-tie (vid1.avi frame 0 here: the port's
own nets find a peak at (23, 81) that islx's do not). With the nets'
outputs shared, every layer above them is held exactly. The exact path's
maps pass through resizes and a blur that sum in another order too (a
shared CPM still left a blurred near-tie one pixel apart), so there both
sides run the same stub CPMs, gaussian blobs seeded by the net input, as
tests/test_torch_pose.py's stub tests do.

What must be equal: the file tree; the feature CSVs, byte for byte; the
stick-figure JPGs, byte for byte; the fused path's JSON records, byte for
byte; the exact path's records but for the score values, within the atol
1e-4 the pose tests state (its map resizes sum in another order). A
resumed run rewrites exactly the frames whose records were deleted, with
the same bytes, and its CSV equals islx's resumed CSV.
"""
import dataclasses
import functools
import json
import os
import shutil
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.cli import extract as JCLI
from islx.core import weights as JW
from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.isl import extract as JE
from islx.isl import features as JF
from islx.models import cpm as JC
from islx.pipeline import batch_pose as JBP
from islx.pose import body as JBody
from islx.pose import hand as JHandMod
from islx.utils import draw as JDraw
from islx_torch.cli import extract as TCLI
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.isl import extract as TE
from islx_torch.isl import features as TF
from islx_torch.pipeline import batch_pose as TBP
from islx_torch.pose import body as TBody
from islx_torch.pose import hand as THandMod
from islx_torch.utils import draw as TDraw


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

pytestmark = pytest.mark.filterwarnings(
    "error:dynamic_crop_resize_batch:UserWarning")

H, WD = 184, 96
# the dataclasses as defined (the module fixture patches the names)
JConfig, TConfig = JE.ExtractConfig, TE.ExtractConfig


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


def write_table(path, videos):
    """The shard CSV: a path, a string, an int and a float column, and a
    string with a comma."""
    lines = ["Filepath,expression,signer,take,note"]
    for i, v in enumerate(videos):
        lines.append(f'{v},Hello,{i + 1},{0.5 + i},"left, {i}"')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class Clock:
    """``time`` with a ``time()`` that steps a quarter second a call."""

    def __init__(self):
        self.t = 100.0

    def time(self):
        self.t += 0.25
        return self.t


def seeded_states():
    """Full-width seeded BODY_25 and hand states (the port's init, fast;
    islx gets them through ``weights.to_islx_params``), the arm joints'
    heat bias raised by 1 so arms chain and hand boxes form."""
    state = {"body25": W.init_params("body25", 0),
             "hand": W.init_params("hand", 1)}
    bias = state["body25"]["Mconv7_stage1_L1"]["b"].clone()
    bias[2:8] += 1.0
    state["body25"]["Mconv7_stage1_L1"]["b"] = bias
    return state


def islx_nets(body, hand):
    """islx's jitted f32 CPM forwards as the port's ``net`` callables:
    (x NHWC, compute dtype) -> (paf, heat), and (x, dtype, stages) ->
    heat."""
    fb = jax.jit(lambda p, x: JC.FORWARDS["body25"](p, x, jnp.float32))
    fh = jax.jit(lambda p, x, s: JC.hand_forward(p, x, jnp.float32, s),
                 static_argnums=2)

    def body_net(x, cd):
        return tuple(torch.from_numpy(np.array(m))
                     for m in fb(body, jnp.asarray(x.numpy())))

    def hand_net(x, cd, stages):
        return torch.from_numpy(np.array(fh(hand, jnp.asarray(x.numpy()),
                                            stages)))

    return body_net, hand_net


def blob_maps(x, channels, amp):
    """Net outputs at /8 for a net input x [1,H,W,3], seeded by its shape
    and its mean to 1e-3 (a crop resized by the two sides may round a
    value apart):
    1-3 gaussian blobs at fractional centres in each heat channel plus a
    small tie breaker (as tests/test_torch_pose.py builds them) and, for
    ``channels`` = (heat, paf), smooth noise PAFs."""
    from scipy.ndimage import gaussian_filter

    x = np.asarray(x, np.float32)
    key = f"{x.shape} {round(float(x.mean()) * 1000)}"
    rng = np.random.RandomState(zlib.crc32(key.encode()) & 0x7FFFFFFF)
    h, w = x.shape[1] // 8, x.shape[2] // 8
    yy, xx = np.mgrid[0:h, 0:w]
    heat = np.zeros((h, w, channels[0]), np.float32)
    for ch in range(channels[0]):
        for _ in range(rng.randint(1, 4)):
            cy = rng.randint(2, h - 2) + rng.uniform(-0.3, 0.3)
            cx = rng.randint(2, w - 2) + rng.uniform(-0.3, 0.3)
            heat[:, :, ch] += amp * rng.uniform(0.5, 1.0) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    heat += (rng.rand(h, w, 1) * 1e-3).astype(np.float32)
    if len(channels) == 1:
        return heat[None]
    paf = rng.randn(h, w, channels[1]).astype(np.float32)
    for ch in range(channels[1]):
        paf[:, :, ch] = gaussian_filter(paf[:, :, ch], sigma=2)
    paf = paf * 1.5 / (np.abs(paf).max() + 1e-9)
    return paf.astype(np.float32)[None], heat[None]


def stub_forwards():
    """The same stub CPMs (:func:`blob_maps`) as islx ``forward_fn``s (a
    host callback inside islx's jitted programs) and the port's."""
    def jbody(p, x, cd):
        h, w = x.shape[1] // 8, x.shape[2] // 8
        out = (jax.ShapeDtypeStruct((1, h, w, 52), jnp.float32),
               jax.ShapeDtypeStruct((1, h, w, 26), jnp.float32))
        return jax.pure_callback(lambda a: blob_maps(a, (26, 52), 0.9),
                                 out, x)

    def jhand(p, x, cd):
        h, w = x.shape[1] // 8, x.shape[2] // 8
        out = jax.ShapeDtypeStruct((1, h, w, 22), jnp.float32)
        return jax.pure_callback(lambda a: blob_maps(a, (22,), 0.7), out, x)

    def tbody(p, x, cd):
        return tuple(torch.from_numpy(m)
                     for m in blob_maps(x.numpy(), (26, 52), 0.9))

    def thand(p, x, cd):
        return torch.from_numpy(blob_maps(x.numpy(), (22,), 0.7))

    return jbody, jhand, tbody, thand


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Clips, tables, weight files and the module-wide patches."""
    d = tmp_path_factory.mktemp("extract")
    state = seeded_states()
    body, hand = (W.to_islx_params(state[k]) for k in ("body25", "hand"))
    bw, hw = str(d / "body.npz"), str(d / "hand.npz")
    videos = [write_clip(str(d / f"vid{i}.avi"), i, 3) for i in range(3)]
    table = write_table(str(d / "ds.csv"), videos)
    exact_table = write_table(str(d / "exact.csv"),
                              [write_clip(str(d / "ex.avi"), 7, 2)])

    net = W.build("body25", state["body25"], "cpu", torch.float32)
    from islx_torch.pipeline.video import FrameSource

    with FrameSource(videos[0]) as src:
        frames = np.stack(list(src))
    with torch.no_grad():
        heat = net(torch.from_numpy(frames).float() / 256.0 - 0.5)[1]
    pose = dict(max_peaks=8, thre2=-0.5,
                thre1=float(np.quantile(heat[..., :25].numpy(), 0.8)))

    mp = pytest.MonkeyPatch()
    for var in ("ISLX_INT8", "ISLX_HAND_STAGES", "ISLX_PALLAS_NMS",
                "ISLX_WEIGHTS_DIR"):
        mp.delenv(var, raising=False)
    mp.setenv("ISLX_PALLAS_MASK", "1")
    mp.setenv("ISLX_HAND_SCALE", "0.25")
    # the weight files of both CLIs, read from memory
    mp.setattr(JW, "load", lambda path, mt, *a: {"body25": body,
                                                 "hand": hand}[mt])
    mp.setattr(W, "load", lambda path, mt: state[mt])
    body_net, hand_net = islx_nets(body, hand)
    built = {}
    j_fused, t_fused = JBP.FusedPosePipeline, TBP.FusedPosePipeline

    def islx_fused(*a, **k):
        # one pipeline for every CLI run: its compiled programs are kept
        if "islx" not in built:
            built["islx"] = j_fused(*a, pose_cfg=JPose(**pose),
                                    compute_dtype=jnp.float32, **k)
        return built["islx"]

    def port_fused(*a, **k):
        if "port" not in built:
            pipe = t_fused(*a, pose_cfg=PoseConfig(**pose),
                           compute_dtype=torch.float32, **k)
            pipe.body.net, pipe.hand.net = body_net, hand_net
            built["port"] = pipe
        return built["port"]

    mp.setattr(JBP, "FusedPosePipeline", islx_fused)
    mp.setattr(TBP, "FusedPosePipeline", port_fused)
    jbody, jhand, tbody, thand = stub_forwards()
    exact = dict(max_peaks=8, thre2=-1.0)
    small = dict(scale_search=(0.25,))
    mp.setattr(JBody, "Body", functools.partial(
        JBody.Body, config=JPose(**exact), forward_fn=jbody))
    mp.setattr(TBody, "Body", functools.partial(
        TBody.Body, config=PoseConfig(**exact), forward_fn=tbody))
    mp.setattr(JHandMod, "Hand", functools.partial(
        JHandMod.Hand, config=JHand(**small), forward_fn=jhand))
    mp.setattr(THandMod, "Hand", functools.partial(
        THandMod.Hand, config=HandConfig(**small), forward_fn=thand))
    for mod in (JE, TE):
        mp.setattr(mod, "ExtractConfig", functools.partial(
            mod.ExtractConfig, augment=True))
    yield dict(dir=d, bw=bw, hw=hw, table=table, exact_table=exact_table,
               mp=mp)
    mp.undo()


def run_both(env, table, out, args, clocks=None):
    """Both CLIs over ``table`` into out/islx and out/port, each with its
    own stepping clock (continued from ``clocks`` when given)."""
    clocks = clocks or (Clock(), Clock())
    for mod, clock in zip((JE, TE), clocks):
        env["mp"].setattr(mod, "time", clock)
    common = ["--body-weights", env["bw"], "--hand-weights", env["hw"],
              "--sticks"] + args
    JCLI.main([table, str(out / "islx")] + common)
    TCLI.main([table, str(out / "port")] + common + ["--device", "cpu"])
    return clocks


def tree(root):
    return sorted(os.path.relpath(os.path.join(r, n), root)
                  for r, _, names in os.walk(root) for n in names)


@pytest.fixture(scope="module")
def fused(env):
    """Default (fused) extraction in two shards over three videos of three
    frames, two frames a step (a short last step)."""
    out = env["dir"] / "fused"
    for shard in ("0", "1"):
        run_both(env, env["table"], out,
                 ["--batch", "2", "--shard-index", shard, "--num-shards",
                  "2"])
    return out


@pytest.fixture(scope="module")
def exact(env):
    out = env["dir"] / "exact"
    run_both(env, env["exact_table"], out, ["--exact"])
    return out


def same_record(got: str, want: str, score_atol) -> bool:
    """True where the texts are equal; else (with ``score_atol``) asserts
    they differ only in the score values, within it, and returns False."""
    if got == want:
        return True
    assert score_atol is not None, "records not byte-equal"
    g, w = json.loads(got), json.loads(want)
    assert g["all_hand_peaks"] == w["all_hand_peaks"]
    gc, wc = np.array(g["candidate"]), np.array(w["candidate"])
    gs, ws = np.array(g["subset"]), np.array(w["subset"])
    assert gc.shape == wc.shape and gs.shape == ws.shape
    if gc.size:
        np.testing.assert_array_equal(gc[:, [0, 1, 3]], wc[:, [0, 1, 3]])
        np.testing.assert_allclose(gc[:, 2], wc[:, 2], rtol=0,
                                   atol=score_atol)
    if gs.size:
        np.testing.assert_array_equal(gs[:, :-2], ws[:, :-2])
        np.testing.assert_array_equal(gs[:, -1], ws[:, -1])
        np.testing.assert_allclose(gs[:, -2], ws[:, -2], rtol=0,
                                   atol=score_atol)
    return False


def check_outputs(out, score_atol=None):
    """The trees are equal; CSVs and JPGs byte-equal; the records
    byte-equal or (``score_atol``) within it; people and hands were found
    -> the count of byte-equal records."""
    names = tree(out / "islx")
    assert names == tree(out / "port")
    n_equal = n_json = n_people = n_hands = 0
    for name in names:
        want = (out / "islx" / name).read_bytes()
        got = (out / "port" / name).read_bytes()
        if name.endswith(".json"):
            n_json += 1
            n_equal += same_record(got.decode(), want.decode(), score_atol)
            rec = json.loads(got)
            n_people += len(rec["subset"])
            n_hands += len(rec["all_hand_peaks"])
        else:
            assert got == want, name
    assert n_people > 0 and n_hands > 0
    print(f"{n_equal} of {n_json} records byte-equal, {n_people} people, "
          f"{n_hands} hands")
    return n_equal, n_json



def test_fused_extraction_equal(fused):
    names = tree(fused / "port")
    assert "features-shard0.csv" in names and "features-shard1.csv" in names
    assert sum(n.endswith(".json") for n in names) == 9
    assert sum(n.endswith(".jpg") for n in names) == 9
    assert check_outputs(fused) == (9, 9)
    head = (fused / "port" / "features-shard0.csv").read_text().splitlines()
    cols = head[0].split(",")
    assert cols[:3] == ["video", "frame", "f0"]
    assert cols[-5:] == ["expression", "signer", "take", "note",
                         "exec_time_s"]
    assert len(head) == 7                    # two videos of three frames
    # exec_time_s only on each video's last row
    assert [r.endswith(",0.25") for r in head[1:]] == \
        [False, False, True] * 2


def test_exact_extraction_equal(exact):
    names = tree(exact / "port")
    assert sum(n.endswith(".json") for n in names) == 2
    check_outputs(exact, score_atol=1e-4)    # tests/test_torch_pose.py


def test_resume_rewrites_only_deleted_frames(env, fused):
    """Delete every third record of shard 0's videos, rerun both CLIs on
    shard 0: only those frames are extracted again, with the same bytes as
    before, nothing else is written, and the resumed CSV (only the new
    rows) is byte-equal to islx's."""
    out = env["dir"] / "resume"
    shutil.copytree(fused, out)
    gone = [n for n in tree(out / "port")
            if n.endswith(".json") and not n.startswith("vid1")][::3]
    assert len(gone) == 2
    before = {}
    for side in ("islx", "port"):
        for n in tree(out / side):
            p = out / side / n
            before[side, n] = (p.read_bytes(), p.stat().st_mtime_ns)
        for n in gone:
            os.remove(out / side / n)
    calls = []
    real = TE.save_frame

    def recording(cfg, video_id, idx, *a, **kw):
        calls.append(os.path.join(video_id, f"{idx:06d}.json"))
        return real(cfg, video_id, idx, *a, **kw)

    env["mp"].setattr(TE, "save_frame", recording)
    try:
        run_both(env, env["table"], out, ["--batch", "2", "--shard-index",
                                          "0", "--num-shards", "2"])
    finally:
        env["mp"].setattr(TE, "save_frame", real)
    assert sorted(calls) == sorted(gone)
    redone = set(gone) | {n.replace(".json", ".jpg") for n in gone}
    for n in tree(out / "port"):
        if n.endswith(".csv"):
            continue
        data, mtime = before["port", n]
        p = out / "port" / n
        assert p.read_bytes() == data, n
        assert (p.stat().st_mtime_ns == mtime) == (n not in redone), n
    got = (out / "port" / "features-shard0.csv").read_bytes()
    assert got == (out / "islx" / "features-shard0.csv").read_bytes()
    assert len(got.decode().splitlines()) == 1 + len(gone)


def test_augmented_frames_equal(env):
    """``_augment_frame`` gives islx's frame for the same video id and
    index: the same crc32-seeded draws, the rotation and the solarize."""
    from islx_torch.pipeline.video import FrameSource

    cfg_j, cfg_t = JConfig(out_root="unused"), TConfig(out_root="unused")
    with FrameSource(os.path.join(env["dir"], "vid1.avi")) as src:
        frames = list(src)
    n_sol = 0
    for idx, f in enumerate(frames + frames):
        vid = "vid1.avi" if idx < len(frames) else "other"
        want = JE._augment_frame(cfg_j, vid, idx, f)
        got = TE._augment_frame(cfg_t, vid, idx, f)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        seed = zlib.crc32(f"{vid}/{idx}".encode()) & 0x7FFFFFFF
        n_sol += np.random.RandomState(seed).rand(2)[1] < 0.5
    assert 0 < n_sol < 2 * len(frames)       # both branches ran


def test_stick_model_equal():
    """get_bodypose/get_handpose and draw_stick_model equal islx's on
    random poses, with a missing joint, a missing hand keypoint and a
    third hand."""
    rng = np.random.RandomState(4)
    n = 40
    cand = np.concatenate([rng.rand(n, 2) * [96, 184], rng.rand(n, 1),
                           np.arange(n)[:, None]], 1)
    subset = np.concatenate([rng.randint(-1, n, (3, 25)),
                             rng.rand(3, 2) * 10], 1).astype(np.float64)
    hands = [rng.randint(0, 90, (21, 2)) for _ in range(3)]
    hands[0][5] = 0
    for mt in ("body25", "coco"):
        sub = subset if mt == "body25" else subset[:, 7:]
        assert TF.get_bodypose(cand, sub, mt) == JF.get_bodypose(cand, sub,
                                                                 mt)
    je, jp = JF.get_handpose(hands)
    te, tp = TF.get_handpose(hands)
    assert te == je and tp == jp
    frame = (rng.rand(184, 96, 3) * 255).astype(np.uint8)
    circles, sticks = TF.get_bodypose(cand, subset)
    want = JDraw.draw_stick_model(frame, circles, sticks, je, jp)
    got = TDraw.draw_stick_model(frame, circles, sticks, te, tp)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frame)


@pytest.mark.parametrize("case", ["numbers", "blanks", "strings", "empty"])
def test_csv_read_and_write_follow_pandas(tmp_path, case):
    """``_read_csv`` types and ``_write_csv`` formats a table as pandas'
    ``read_csv`` / ``DataFrame(rows).to_csv(index=False)`` do."""
    pd = pytest.importorskip("pandas")
    tables = {
        "numbers": "Filepath,a,b,c,d\nx.mp4,1,0.5,1e16,-0\ny.mp4,2,2,3,7\n",
        "blanks": "Filepath,a,b,c\nx.mp4,1,,NA\ny.mp4,,2.25,z\n",
        "strings": 'Filepath,a,b\nx.mp4,"p, q",True\ny.mp4,r"s,False\n',
        "empty": "Filepath,a\n",
    }
    src = tmp_path / "t.csv"
    src.write_text(tables[case])
    df = pd.read_csv(src)
    cols, rows = TE._read_csv(str(src))
    assert cols == list(df.columns)
    want_rows = [dict(zip(df.columns, r)) for r in
                 df.itertuples(index=False)]
    # feature-like rows: ints, floats, a blank-but-last float column
    feats = [{"video": f"v{i}", "frame": i, "f0": 0.1 * i, "f1": 123.0,
              **({"exec_time_s": 0.25} if i == 1 else {})}
             for i in range(2)]
    for i, (g, w) in enumerate(zip(rows, want_rows)):
        feats[i % 2].update(g)
        for k in g:
            assert (g[k] is None and pd.isna(w[k])) or g[k] == w[k] or (
                g[k] != g[k] and w[k] != w[k]), (k, g[k], w[k])
    out = tmp_path / "o.csv"
    TE._write_csv(str(out), feats)
    assert out.read_text() == pd.DataFrame(feats).to_csv(index=False)
    TE._write_csv(str(out), [])
    assert out.read_text() == pd.DataFrame([]).to_csv(index=False)
    TE._write_csv(str(out), rows)
    assert out.read_text() == pd.DataFrame(want_rows).to_csv(index=False)


def test_cli_routing(env, tmp_path, monkeypatch):
    """The int8 gate is consulted only with both weight files (under
    ISLX_INT8=1 too, as islx's CLI); --exact builds ISLSignPos; the shard
    defaults are 0 and 1 with no process group; --mesh-data is refused."""
    from islx_torch import cli as gate

    seen = {}

    def gated(bp, hp, **kw):
        seen["gate"] = kw["calib_clip"]
        return bp, hp, False

    monkeypatch.setenv("ISLX_INT8", "1")
    monkeypatch.setattr(gate, "gated_int8_params", gated)
    monkeypatch.setattr(TE, "extract_dataset", lambda cfg, pose, csv, si,
                        ns, col, batch=None: seen.update(
                            pose=type(pose).__name__, shard=(si, ns),
                            batch=batch) or "out.csv")
    monkeypatch.setattr(TBP, "FusedPosePipeline",
                        type("FusedPosePipeline", (), {
                            "__init__": lambda self, *a, **k: None}))
    TCLI.main([env["table"], str(tmp_path), "--hand-weights", env["hw"],
               "--device", "cpu"])
    assert "gate" not in seen
    assert seen["pose"] == "FusedPosePipeline" and seen["shard"] == (0, 1)
    assert seen["batch"] == 16
    TCLI.main([env["table"], str(tmp_path), "--hand-weights", env["hw"],
               "--body-weights", env["bw"], "--device", "cpu"])
    assert seen["gate"] == JCLI._first_video(env["table"], "Filepath") \
        == os.path.join(env["dir"], "vid0.avi")
    TCLI.main([env["table"], str(tmp_path), "--exact", "--device", "cpu",
               "--shard-index", "1", "--num-shards", "3"])
    assert seen["pose"] == "ISLSignPos" and seen["shard"] == (1, 3)
    assert seen["batch"] is None
    with pytest.raises(SystemExit):
        TCLI.main([env["table"], str(tmp_path), "--mesh-data", "2"])
    assert TCLI._first_video(str(tmp_path / "none.csv"), "Filepath") is None


def test_dataclass_and_paths_equal(tmp_path):
    assert [(f.name, f.default) for f in dataclasses.fields(TConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    cj = JConfig(out_root=str(tmp_path), write_sticks=True)
    ct = TConfig(out_root=str(tmp_path), write_sticks=True)
    assert TE._frame_paths(ct, "v", 7) == JE._frame_paths(cj, "v", 7)
    assert TE.shard_rows(list(range(10)), 1, 3) == \
        JE.shard_rows(list(range(10)), 1, 3)
