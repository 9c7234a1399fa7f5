"""islx_torch package contract (CPU): the copied configs equal islx's, the
weight carry-across and loaders, the entry points' device and int8 rules,
and that nothing in the port imports JAX or islx."""
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import jax

from islx.core import config as JCfg
from islx.core import weights as JW
from islx.models import cpm as JC
from islx_torch.core import config as TCfg
from islx_torch.core import weights as W


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", ["PoseConfig", "HandConfig",
                                  "DetectorConfig", "TranslatorConfig"])
def test_config_dataclasses_equal(name):
    j, t = getattr(JCfg, name), getattr(TCfg, name)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert _fields(j()) == _fields(t())
    if name == "PoseConfig":
        for mt in ("body25", "coco"):
            assert (j(model_type=mt).njoint, j(model_type=mt).npaf) == \
                (t(model_type=mt).njoint, t(model_type=mt).npaf)


@pytest.mark.parametrize("gates", [
    None,
    {"hand_160_default": "GO", "hand_160_stages": 5, "int8_default": "GO"},
    {"hand_184_default": "NO-GO"},
    {"hand_184_default": "GO", "hand_stages": 4, "int8_default": "NO-GO"},
    {"hand_184_default": "UNEVALUABLE"},
])
def test_gated_configs_equal(tmp_path, monkeypatch, gates):
    """HandConfig.gated / int8_gated resolve the same verdicts."""
    for var in ("ISLX_HAND_SCALE", "ISLX_HAND_STAGES", "ISLX_INT8",
                "ISLX_WEIGHTS_DIR"):
        monkeypatch.delenv(var, raising=False)
    if gates is not None:
        (tmp_path / "gates.json").write_text(json.dumps(gates))
    wdir = str(tmp_path)
    (jc, jnote), (tc, tnote) = (JCfg.HandConfig.gated(wdir),
                                TCfg.HandConfig.gated(wdir))
    assert _fields(jc) == _fields(tc) and jnote == tnote
    assert JCfg.int8_gated(wdir) == TCfg.int8_gated(wdir)
    assert _fields(JCfg.HandConfig.production(0.25)) == \
        _fields(TCfg.HandConfig.production(0.25))


def _islx_params(model_type, seed=0):
    return jax.tree.map(np.asarray,
                        JC.init_params(model_type, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("model_type", ["body25", "hand"])
def test_weights_roundtrip(model_type, tmp_path):
    """islx params -> port state (OIHW) -> back, the flat caffe dict both
    ways, and islx .npz / reference .pt files load to the same state."""
    p = _islx_params(model_type)
    state = W.from_islx_params(p)
    c = state["conv1_1"]["w"]
    assert c.dtype == torch.float32 and c.shape == (64, 3, 3, 3)
    back = W.to_islx_params(state)
    for name in p:
        for k in p[name]:
            np.testing.assert_array_equal(p[name][k], back[name][k])
    flat = JW.to_flat_dict(p)
    assert flat.keys() == W.to_flat_dict(state).keys()
    for k, v in W.to_flat_dict(state).items():
        np.testing.assert_array_equal(flat[k], v)
    from_flat = W.from_flat_dict(flat, model_type)

    JW.save_npz(str(tmp_path / "w.npz"), p)
    from_npz = W.load(str(tmp_path / "w.npz"), model_type)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
               str(tmp_path / "w.pt"))
    from_pt = W.load(str(tmp_path / "w.pt"), model_type)
    for other in (from_flat, from_npz, from_pt):
        assert other.keys() == state.keys()
        for name in state:
            for k in state[name]:
                assert torch.equal(state[name][k], other[name][k])
    with pytest.raises(ValueError, match="unsupported"):
        W.load(str(tmp_path / "w.prototxt"), model_type)


def test_init_params_seeded():
    a, b = W.init_params("hand", 1), W.init_params("hand", 1)
    c = W.init_params("hand", 2)
    ref = _islx_params("hand")
    assert a.keys() == ref.keys()
    for name in a:
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert tuple(a[name]["w"].shape) == \
            ref[name]["w"].transpose(3, 2, 0, 1).shape
    assert not torch.equal(a["conv1_1"]["w"], c["conv1_1"]["w"])
    std = float(a["conv4_1"]["w"].std())
    assert abs(std - np.sqrt(2.0 / (9 * 256))) < 0.1 * std


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|islx|keras)\b(?!_torch)"
                        r"|from\s+(jax|islx|keras)(\.|\s)(?!.*islx_torch))",
                        re.MULTILINE)


def test_port_imports_no_jax_or_islx():
    """No file of islx_torch, nor chip_smoke.py, imports jax, keras or
    islx."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "islx_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            src = f.read()
        bad += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                for m in _FORBIDDEN.finditer(src)]
    assert not bad, bad
    # the pattern itself catches what it must
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from islx.ops import paf", "import islx", "import keras",
                 "from keras.layers import Dense"):
        assert _FORBIDDEN.search(line), line
    for line in ("import islx_torch", "from islx_torch.ops import paf"):
        assert not _FORBIDDEN.search(line), line


def test_port_modules_import_no_jax_or_islx():
    """Every module of islx_torch, imported in a fresh process, brings in
    no jax and nothing of islx (sys.modules after the imports)."""
    import subprocess
    import sys

    names = []
    for root, _, files in os.walk(os.path.join(REPO, "islx_torch")):
        for n in files:
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, n), REPO)[:-3]
                names.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    assert {"islx_torch.isl.extract", "islx_torch.ops.augment",
            "islx_torch.utils.draw", "islx_torch.cli.extract",
            "islx_torch.cli.translate", "islx_torch.isl.dataset",
            "islx_torch.isl.train", "islx_torch.core.checkpoint",
            "islx_torch.models.pose_train", "islx_torch.cli.train",
            "islx_torch.cli.pose_train", "islx_torch.pipeline.image",
            "islx_torch.cli.camera", "islx_torch.cli.demo",
            "islx_torch.cli.dump_features",
            "islx_torch.cli.demo_video", "islx_torch.core.caffe_reader",
            "islx_torch.core.caffe_net", "islx_torch.cli.convert",
            "islx_torch.cli.quantize", "islx_torch.cli.summary",
            "islx_torch.utils.summary", "islx_torch.utils.profiling",
            "islx_torch.models.keras_export",
            "islx_torch.models.one_model", "islx_torch.parallel.mesh",
            "islx_torch.parallel.sharding",
            "islx_torch.parallel.pipeline"} <= set(names)
    code = ("import importlib, json, sys\n"
            f"for n in {sorted(names)!r}: importlib.import_module(n)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'islx' "
            "or m.startswith('islx.') or m == 'keras' "
            "or m.startswith('keras.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """Asked for no device (default cuda) on a machine with no GPU, the
    entry points raise instead of carrying on on the CPU."""
    from islx_torch.cli import translate as cli
    from islx_torch.core.runtime import resolve_device
    from islx_torch.pipeline.batch_pose import FusedPosePipeline
    from islx_torch.pipeline.translate import BatchedTranslatePipeline

    _no_gpu(monkeypatch)
    monkeypatch.delenv("ISLX_INT8", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedPosePipeline(W.init_params("body25"), W.init_params("hand"))
    # the split pipelines and the single-image path
    from islx_torch.pipeline.batch_pose import (BatchedBodyPipeline,
                                                BatchedHandPipeline)
    from islx_torch.pipeline.image import ImagePose

    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedBodyPipeline(W.init_params("body25"))
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedHandPipeline(W.init_params("hand"))
    for fused in (False, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            ImagePose(fused=fused)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedTranslatePipeline(batch=2)
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(video)])
    # training: the CLIs, the head's fit and the CPMs' state
    from islx_torch.cli import pose_train as pose_cli
    from islx_torch.cli import train as train_cli
    from islx_torch.isl import train as TR
    from islx_torch.models import pose_train as PT

    (tmp_path / "labels.csv").write_text("video_id,expression\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([str(tmp_path), "--labels",
                        str(tmp_path / "labels.csv"), "--out",
                        str(tmp_path / "h.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        pose_cli.main([str(tmp_path), "--out", str(tmp_path / "w.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.fit(np.zeros((2, 20, 156), np.float32), np.zeros(2, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.init_state("hand")
    # int8 calibration runs the float nets on the GPU unless asked not to
    from islx_torch import cli as gate
    from islx_torch.core.config import HandConfig
    from islx_torch.models import quant

    frame = np.zeros((40, 56, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        quant.calibrate_scales(W.init_params("hand"), "hand",
                               [np.zeros((1, 16, 16, 3), np.float32)])
    with pytest.raises(RuntimeError, match="CUDA"):
        gate.quantize_states(W.init_params("body25"), W.init_params("hand"),
                             [frame], HandConfig(scale_search=(0.25,)))
    monkeypatch.setenv("ISLX_INT8", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        gate.gated_int8_params(W.init_params("body25"), W.init_params("hand"),
                               calib_image=frame)


def test_int8_gate_builds_quantized_pipelines(monkeypatch, tmp_path):
    """ISLX_INT8=1, or a recorded int8 GO beside the hand weights, quantizes
    both nets (calibrated on the CLI's input) and the fused pipeline builds
    int8 CPMs; ISLX_INT8=0, a NO-GO, or no hand weights keep bf16. The
    quantized states are cached under <weights dir>/.int8_cache, keyed on
    the hand AND the body weight files."""
    from islx_torch import cli
    from islx_torch.core.config import HandConfig
    from islx_torch.models import quant
    from islx_torch.pipeline.batch_pose import FusedPosePipeline

    bp, hp = W.init_params("body25"), W.init_params("hand", 1)
    frame = (np.random.RandomState(0).rand(40, 56, 3) * 255).astype(np.uint8)
    cfg = HandConfig(scale_search=(0.25,))
    logs = []
    kw = dict(hand_cfg=cfg, calib_image=frame, log=logs.append,
              device="cpu")

    def quantized(state):
        return all("w_q" in e and "w" not in e for e in state.values())

    monkeypatch.setenv("ISLX_INT8", "1")
    qb, qh, applied = cli.gated_int8_params(bp, hp, **kw)
    assert applied and quantized(qb) and quantized(qh)
    pipe = FusedPosePipeline(qb, qh, hand_cfg=cfg, device="cpu")
    assert pipe.body.net.quantized and pipe.hand.net.quantized
    assert isinstance(pipe.hand.net.layers["conv1_1"], quant.QConvLayer)

    monkeypatch.delenv("ISLX_INT8")
    assert cli.gated_int8_params(bp, hp, **kw)[2] is False  # no checkpoint
    hand = tmp_path / "hand.npz"
    body = tmp_path / "body.npz"
    hand.write_bytes(b"h")
    body.write_bytes(b"b")
    (tmp_path / "gates.json").write_text(json.dumps({"int8_default": "GO"}))
    paths = dict(hand_weights=str(hand), body_weights=str(body))
    qb, qh, applied = cli.gated_int8_params(bp, hp, **paths, **kw)
    assert applied and quantized(qb) and quantized(qh)
    assert (tmp_path / ".int8_cache" / "int8.pt").exists()
    meta = json.loads((tmp_path / ".int8_cache" / "meta.json").read_text())
    assert meta["body"][0] == "body.npz" and meta["hand"][0] == "hand.npz"
    del logs[:]
    qb2, _, _ = cli.gated_int8_params(bp, hp, **paths, **kw)
    assert any("loaded from" in m for m in logs)
    assert torch.equal(qb2["conv1_1"]["w_q"], qb["conv1_1"]["w_q"])
    body.write_bytes(b"another body")            # a changed body: calibrate
    del logs[:]
    cli.gated_int8_params(bp, hp, **paths, **kw)
    assert any("calibrating" in m for m in logs)
    assert not FusedPosePipeline(bp, hp, hand_cfg=cfg,
                                 device="cpu").hand.net.quantized

    monkeypatch.setenv("ISLX_INT8", "0")         # env 0 forces bf16
    assert cli.gated_int8_params(bp, hp, **paths, **kw)[2] is False
    monkeypatch.delenv("ISLX_INT8")
    (tmp_path / "gates.json").write_text(json.dumps(
        {"int8_default": "NO-GO"}))
    assert cli.gated_int8_params(bp, hp, **paths, **kw)[2] is False


def test_build_rebuilds_on_a_changed_header(monkeypatch, tmp_path):
    """A kernel library is keyed by the bytes of its source and of every
    csrc header: it is reused while both are unchanged, whatever their
    times, rebuilt once either changes, and an earlier build is reused
    when the sources come back to what it was built from."""
    from islx_torch.ops import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "s.cuh"\n')
    (csrc / "s.cuh").write_text("\n")
    log = tmp_path / "log"
    log.write_text("")
    fake = tmp_path / "nvcc"       # writes its -o file, logs each build
    fake.write_text('#!/bin/sh\n[ "$1" = --version ] && exit 0\n'
                    'echo built >> "%s"\nwhile [ $# -gt 0 ]; do '
                    '[ "$1" = -o ] && echo so > "$2"; shift; done\n' % log)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))

    def builds(edit=None, text="\n"):
        if edit is not None:
            (csrc / edit).write_text(text)
        _build.build("k")
        return len(log.read_text().splitlines())

    assert builds() == 1
    assert builds() == 1           # same bytes: reused
    for f in ("k.cu", "s.cuh"):    # newer times, same bytes: reused
        os.utime(csrc / f, (2e9, 2e9))
    assert builds() == 1
    assert builds("s.cuh", "// v2\n") == 2    # a header changed: rebuilt
    assert builds("s.cuh", "\n") == 2         # back: the first build
    assert builds("k.cu", '#include "s.cuh"\n// v2\n') == 3
    libs = sorted(f for f in os.listdir(build) if f.endswith(".so"))
    assert len(libs) == 3 and all(f.startswith("libk-") for f in libs)


def test_true_f32_holds_while_any_thread_is_inside():
    """Two threads' true_f32 blocks overlap, as a server's request forward
    and its int8 calibration do: the first block leaves while the second
    is still inside. The flags stay cleared until the last block leaves
    and are restored then."""
    import threading

    from islx_torch.core.runtime import true_f32

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    before = flags()
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def first():
        with true_f32():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def second():
        a_in.wait(10)
        with true_f32():
            b_in.set()
            a_out.wait(10)
            seen["inside"] = flags()

    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen["inside"] == (False, False)
        assert flags() == (True, False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
