"""Serving warm starts on the CPU: the port's artifacts
(islx_torch.core.aot, islx_torch.cli.export_programs, serve --aot-dir)
against islx's names and keys (islx/core/aot.py), and the content-keyed
kernel libraries they ship (islx_torch.ops._build).

The small setup of tests/test_torch_serve.py: islx's full-width seeded
params carried across, ``max_peaks=8``, ``thre2=-0.5``, 92 px crops, f32,
48x48 frames. A port artifact is a zip of a JSON fingerprint and the
libraries one step loads; loading it installs the libraries and steps once
at its key on zero frames. islx's artifacts are pickles and are refused
without being unpickled.
"""
import argparse
import glob
import json
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core import aot as JA
from islx.core.config import HandConfig as JHand
from islx.core.config import PoseConfig as JPose
from islx.models import cpm as JC
from islx.pipeline import batch_pose as JBP
from islx_torch.core import aot
from islx_torch.core import weights as W
from islx_torch.core.config import HandConfig, PoseConfig
from islx_torch.models import quant
from islx_torch.ops import _build
from islx_torch.pipeline import batch_pose as TBP
from islx_torch.serve import MicroBatcher, PoseServer
from test_torch_serve import _same_steps

pytestmark = pytest.mark.filterwarnings(
    "error:dynamic_crop_resize_batch:UserWarning")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores, and more threads a process
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HAND = dict(scale_search=(0.25,))        # 92 px crops
POSE = dict(max_peaks=8, thre2=-0.5, thre1=0.05)
B, HB, WB = 2, 48, 48


@pytest.fixture(scope="module")
def params():
    """islx's full-width params of both nets."""
    body = jax.tree.map(np.asarray,
                        JC.init_params("body25", jax.random.PRNGKey(1)))
    hand = jax.tree.map(np.asarray,
                        JC.init_params("hand", jax.random.PRNGKey(2)))
    return body, hand


def _pipe(params, body_state=None, hand=None, **kw):
    body, hand_p = params
    return TBP.FusedPosePipeline(
        body_state if body_state is not None else W.from_islx_params(body),
        W.from_islx_params(hand_p), pose_cfg=PoseConfig(**POSE),
        hand_cfg=HandConfig(**(hand or HAND)),
        compute_dtype=kw.pop("compute_dtype", torch.float32), device="cpu",
        **kw)


def _frames(seed, n=B):
    return (np.random.RandomState(seed).rand(n, HB, WB, 3) * 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def art(params, tmp_path_factory):
    """An artifact of the small pipeline at (2, 48, 48), and that
    pipeline's packed words on seeded frames."""
    out = tmp_path_factory.mktemp("aot")
    src = _pipe(params)
    key = src.program_key(B, HB, WB, (HB, WB))
    path = str(out / aot.artifact_name(key))
    meta = aot.save_fused(src, path, B, HB, WB)
    return {"dir": str(out), "path": path, "key": key, "meta": meta,
            "packed": src.device_step(_frames(5)).numpy()}


def _only(tmp_path, src, name="a.islxprog"):
    """A directory that holds only ``src``'s bytes, as ``name``."""
    d = tmp_path / "only"
    d.mkdir()
    (d / name).write_bytes(open(src, "rb").read())
    return str(d), str(d / name)


def _rewrite(src, dst, edit):
    """Copy artifact ``src`` to ``dst`` with ``edit(meta, files)`` applied
    to its manifest and its library entries."""
    with zipfile.ZipFile(src) as z:
        meta = json.loads(z.read("meta.json"))
        files = {n: z.read(n) for n in z.namelist() if n != "meta.json"}
    edit(meta, files)
    with zipfile.ZipFile(dst, "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        for n, data in files.items():
            z.writestr(n, data)


@pytest.fixture(scope="module")
def islx_packed(params):
    """islx's packed words on the same params and frames as ``art``: its
    FusedPosePipeline at f32 on the CPU, NMS through its Pallas mask
    kernel in interpret mode (the port's nms_mask counterpart)."""
    body, hand = params
    mp = pytest.MonkeyPatch()
    mp.setenv("ISLX_PALLAS_MASK", "1")
    mp.delenv("ISLX_PALLAS_NMS", raising=False)
    try:
        jp = JBP.FusedPosePipeline(body, hand, pose_cfg=JPose(**POSE),
                                   hand_cfg=JHand(**HAND),
                                   compute_dtype=jnp.float32)
        return np.asarray(jp.device_step(_frames(5)))
    finally:
        mp.undo()


def _equal_to_islx(got, want):
    """The packed buffer against islx's, as tests/test_torch_serve.py holds
    a served step: integer planes word-equal, f16 score words within one
    f16 rounding."""
    _same_steps([(None, got)], [(None, want)], B)


# ------------------------------------------------------------- round trip

def test_round_trip_words_equal(params, art, islx_packed):
    """A fresh pipeline holds the artifact's key before any traffic, and
    its first step's packed words equal the exporting pipeline's and
    islx's on the same params and frames; the traffic at that key records
    no new key."""
    pipe = _pipe(params)
    assert pipe.program_keys() == []
    key = aot.load_fused(pipe, art["path"])
    assert key == art["key"] and isinstance(key[3], float)
    assert pipe.program_keys() == [key]
    got = pipe.device_step(_frames(5)).numpy()
    np.testing.assert_array_equal(got, art["packed"])
    _equal_to_islx(got, islx_packed)
    assert pipe.program_keys() == [key]


def test_sharded_round_trip(params, art, islx_packed, tmp_path):
    """An artifact of a pipeline on a data mesh of 2 records 2 devices and
    loads into another such pipeline, whose step gives the exporting
    pipeline's words, and islx's unsharded step's within one f16 rounding
    of a score word (a shard's f32 CPU convs run at batch 1)."""
    from islx_torch.parallel import mesh as M

    def meshed():
        return _pipe(params, mesh=M.make_mesh(
            2, devices=[torch.device("cpu")] * 2))

    path = str(tmp_path / "sharded.islxprog")
    src = meshed()
    meta = aot.save_fused(src, path, B, HB, WB)
    assert meta["sharded"] is True and meta["num_devices"] == 2
    pipe = meshed()
    assert aot.load_fused(pipe, path) == art["key"]
    got = pipe.device_step(_frames(5)).numpy()
    np.testing.assert_array_equal(got, src.device_step(_frames(5)).numpy())
    _equal_to_islx(got, islx_packed)


def test_artifact_is_a_zip_of_json_and_keyed_libraries(art):
    """No pickle: a zip of meta.json and each loaded library under its
    content key, with islx's fingerprint fields and the port's own."""
    with zipfile.ZipFile(art["path"]) as z:
        names = set(z.namelist())
        meta = json.loads(z.read("meta.json"))
    assert meta == json.loads(json.dumps(art["meta"]))
    assert meta["magic"] == "islx_torch-aot-v1" and meta["kind"] == "lib"
    assert meta["key"] == list(art["key"]) and meta["num_devices"] == 1
    libs = {lib["name"]: lib for lib in meta["libraries"]}
    assert "grouping" in libs                 # the step's C++ grouping
    for name, lib in libs.items():
        assert lib["key"] == _build.key(name)
        assert f"lib/{name}-{lib['key']}.so" in names
    islx_fields = {"platform", "device_kind", "model_type", "pack_mode",
                   "paf_mode", "max_peaks", "top_m", "hand_scales",
                   "hand_stages", "params_sig", "sharded", "det_cfg",
                   "hand_boxsize", "crop_chunk", "two_stage_peaks",
                   "fused_peaks", "thre2"}
    assert islx_fields <= set(meta)
    assert {"torch", "cuda", "capability", "pallas_nms",
            "compute_dtype"} <= set(meta)


def test_lenient_defaults_are_islx_s_and_the_ports_two():
    """islx's lenient defaults word for word, and the port's two fields
    at their constructors' defaults."""
    extra = {k: v for k, v in aot._LENIENT_DEFAULTS.items()
             if k not in JA._LENIENT_DEFAULTS}
    assert {k: aot._LENIENT_DEFAULTS[k]
            for k in JA._LENIENT_DEFAULTS} == JA._LENIENT_DEFAULTS
    assert extra == {"pallas_nms": False, "compute_dtype": "bfloat16"}


def test_params_sig_tells_states_apart(params):
    """Float and int8 states, and BODY_25 and COCO, have other
    signatures; the same structure with other values has the same."""
    body, _ = params
    sig = aot._params_sig
    state = W.from_islx_params(body)
    assert sig(state) == sig(W.init_params("body25", seed=3))
    assert sig(state) != sig(_int8_state(params))
    assert sig(state) != sig(W.init_params("coco"))


@pytest.mark.parametrize("b,hb,wb,orig,fmt", [
    (8, 184, 248, (480, 640), "bgr"),
    (1, 184, 328, (720, 1280), "yuv420"),
    (4, 48, 48, (100, 97), "bgr"),           # non-integer scales
    (2, 184, 144, (184, 144), "yuv420"),
    (16, 184, 104, (1280, 720), "bgr")])
def test_keys_and_names_equal_islx(b, hb, wb, orig, fmt):
    got = TBP.FusedPosePipeline.program_key(None, b, hb, wb, orig, fmt)
    want = JBP.FusedPosePipeline.program_key(None, b, hb, wb, orig, fmt)
    assert got == want
    assert aot.artifact_name(got) == JA.artifact_name(want)


# --------------------------------------------------------------- refusals

def _int8_state(params):
    body, _ = params
    state = W.from_islx_params(body)
    return quant.quantize_params(state, {n: 1.0 for n in state})


REFUSALS = ["pack_mode_nook", "bf16", "int8_state", "pallas_nms",
            "no_hand_stages_into_5", "garbage", "foreign_library",
            "library_that_does_not_load", "sharded"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refused_and_skipped(case, params, art, tmp_path, monkeypatch):
    """Each mismatch raises AotMismatch from load_fused, and preload_dir
    skips the file: no key, no step."""
    path = art["path"]
    if case == "pack_mode_nook":
        monkeypatch.setenv("ISLX_PACK_MODE", "nook")
        pipe = _pipe(params)
    elif case == "bf16":
        pipe = _pipe(params, compute_dtype=torch.bfloat16)
    elif case == "int8_state":              # params_sig
        pipe = _pipe(params, body_state=_int8_state(params))
    elif case == "pallas_nms":
        pipe = _pipe(params, pallas_nms=True)
    elif case == "sharded":                 # a data mesh of 2
        from islx_torch.parallel import mesh as M

        pipe = _pipe(params, mesh=M.make_mesh(
            2, devices=[torch.device("cpu")] * 2))
    elif case == "no_hand_stages_into_5":
        # a manifest without hand_stages was built at its default, 6
        path = str(tmp_path / "old.islxprog")
        _rewrite(art["path"], path,
                 lambda meta, files: meta.pop("hand_stages"))
        pipe = _pipe(params, hand=dict(HAND, stages=5))
    elif case == "garbage":
        path = str(tmp_path / "junk.islxprog")
        with open(path, "wb") as f:
            f.write(np.random.RandomState(0).bytes(4096))
        pipe = _pipe(params)
    elif case == "library_that_does_not_load":
        # this tree's key, but a blob the host cannot dlopen, installed
        # into an empty build directory: refused, and the key's path stays
        # free
        path = str(tmp_path / "bad.islxprog")

        def edit(meta, files):
            lib = meta["libraries"][0]
            files[f"lib/{lib['name']}-{lib['key']}.so"] = b"\x7fELF junk"

        _rewrite(art["path"], path, edit)
        build = tmp_path / "build"
        monkeypatch.setattr(_build, "BUILD", str(build))
        pipe = _pipe(params)
    else:                                   # a library of other sources
        path = str(tmp_path / "foreign.islxprog")

        def edit(meta, files):
            lib = meta["libraries"][0]
            blob = files.pop(f"lib/{lib['name']}-{lib['key']}.so")
            lib["key"] = "0" * 64
            files[f"lib/{lib['name']}-{lib['key']}.so"] = blob

        _rewrite(art["path"], path, edit)
        pipe = _pipe(params)
    with pytest.raises(aot.AotMismatch):
        aot.load_fused(pipe, path)
    d, _ = _only(tmp_path, path)
    assert aot.preload_dir(pipe, d) == []
    assert pipe.program_keys() == []
    if case == "library_that_does_not_load":
        assert not glob.glob(str(tmp_path / "build" / "*.so"))


def test_missing_field_loads_at_its_default(params, art, tmp_path):
    """The manifest without hand_stages loads into a 6-stage pipeline."""
    path = str(tmp_path / "old.islxprog")
    _rewrite(art["path"], path, lambda meta, files: meta.pop("hand_stages"))
    pipe = _pipe(params)
    assert aot.load_fused(pipe, path) == art["key"]


def test_islx_artifact_refused_without_unpickling(params, tmp_path,
                                                  monkeypatch):
    """An artifact written by islx's save_fused (kind hlo on the CPU) is
    refused by its leading bytes: pickle is never called."""
    body, hand = params
    jp = JBP.FusedPosePipeline(body, hand, pose_cfg=JPose(**POSE),
                               hand_cfg=JHand(**HAND),
                               compute_dtype=jnp.float32)
    path = str(tmp_path / JA.artifact_name(jp.program_key(1, HB, WB,
                                                          (HB, WB))))
    JA.save_fused(jp, path, 1, HB, WB, kind="hlo")

    def no_unpickling(*a, **k):
        raise AssertionError("the port unpickled an artifact")

    monkeypatch.setattr(pickle, "load", no_unpickling)
    monkeypatch.setattr(pickle, "loads", no_unpickling)
    monkeypatch.setattr(pickle, "Unpickler", no_unpickling)
    pipe = _pipe(params)
    with pytest.raises(aot.AotMismatch, match="islx JAX artifact"):
        aot.load_fused(pipe, path)
    with pytest.raises(aot.AotMismatch, match="islx JAX artifact"):
        aot.read_meta(path)
    assert aot.preload_dir(pipe, str(tmp_path)) == []
    assert pipe.program_keys() == []


# ---------------------------------------------------- content-keyed builds

@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of csrc and an empty BUILD; a fake nvcc and g++ that log
    each compile and write their -o file."""
    import shutil

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    shutil.copytree(_build.CSRC, csrc)
    log = tmp_path / "log"
    log.write_text("")
    fake = tmp_path / "cc"
    fake.write_text('#!/bin/sh\n[ "$1" = --version ] && echo "fake, release '
                    '1.0" && exit 0\necho built >> "%s"\nwhile [ $# -gt 0 ]'
                    '; do [ "$1" = -o ] && echo so > "$2"; shift; done\n'
                    % log)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "cxx", lambda: str(fake))
    return csrc, build, log


def _sources(csrc):
    return sorted(os.path.splitext(f)[0] for f in os.listdir(csrc)
                  if f.endswith((".cu", ".cpp")))


def test_key_follows_bytes_not_mtimes(tree):
    csrc, _, _ = tree
    names = _sources(csrc)
    before = {n: _build.key(n) for n in names}
    for f in os.listdir(csrc):
        os.utime(csrc / f, (1e9, 1e9))
    assert {n: _build.key(n) for n in names} == before
    assert len(set(before.values())) == len(names)


def test_edited_header_changes_every_cu_key(tree):
    csrc, _, _ = tree
    names = _sources(csrc)
    before = {n: _build.key(n) for n in names}
    header = next(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    with open(csrc / header, "a") as f:
        f.write("\n")
    after = {n: _build.key(n) for n in names}
    for n in names:
        cu = os.path.exists(csrc / f"{n}.cu")
        assert (after[n] != before[n]) == cu, n


def test_build_reuses_only_its_own_key(tree):
    """A library is compiled once a key; one of another key (an older
    build of other sources) is never taken for this tree's."""
    csrc, build, log = tree
    rec = _build.build("nms_mask")
    out = rec["path"]
    assert os.path.basename(out) == \
        f"libnms_mask-{_build.key('nms_mask')[:16]}.so"
    assert rec == {"name": "nms_mask", "key": _build.key("nms_mask"),
                   "path": out, "compiler": "fake, release 1.0"}
    assert _build.build("nms_mask") == rec
    assert log.read_text().count("built") == 1
    os.utime(out, (1e9, 1e9))                    # older than its sources
    assert _build.build("nms_mask") == rec
    with open(csrc / "nms_mask.cu", "a") as f:
        f.write("\n")
    assert _build.build("nms_mask")["path"] != out   # new key: compiled
    assert log.read_text().count("built") == 2
    with open(out[:-3] + ".json") as f:
        assert json.load(f)["compiler"] == "fake, release 1.0"


def test_install_refuses_a_wrong_key(tree):
    csrc, build, _ = tree
    with pytest.raises(ValueError, match="not this tree's"):
        _build.install("conv_q", "f" * 64, b"so")
    assert not os.path.exists(build)


@pytest.fixture
def shared_object(tmp_path):
    """The bytes of a real shared library, built with this host's g++."""
    import shutil
    import subprocess

    src, out = tmp_path / "f.cpp", tmp_path / "libf.so"
    src.write_text('extern "C" int f() { return 7; }\n')
    subprocess.run([shutil.which("g++"), "-shared", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    return out.read_bytes()


def test_installed_library_is_built_without_a_compiler(tree, monkeypatch,
                                                       shared_object):
    import ctypes
    import subprocess

    csrc, build, _ = tree
    k = _build.key("grouping")
    path = _build.install("grouping", k, shared_object, "g++ 1")

    def no_compiler(*a, **kw):
        raise AssertionError("a compiler ran")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    assert _build.build("grouping") == {"name": "grouping", "key": k,
                                        "path": path, "compiler": "g++ 1"}
    assert open(path, "rb").read() == shared_object
    assert ctypes.CDLL(path).f() == 7


def test_install_refuses_a_library_that_does_not_load(tree, shared_object):
    """A shipped blob that this host cannot dlopen never takes its key's
    path (so build() compiles there), and a library already under its key
    is not overwritten."""
    csrc, build, log = tree
    k = _build.key("grouping")
    with pytest.raises(ValueError, match="does not load on this host"):
        _build.install("grouping", k, b"not a shared object")
    assert not os.path.exists(_build.lib_path("grouping"))
    assert os.listdir(build) == []
    _build.build("grouping")
    assert log.read_text().count("built") == 1
    path = _build.install("grouping", k, shared_object)
    assert path == _build.lib_path("grouping")
    assert open(path, "rb").read() == b"so\n"   # the fake compiler's


# ------------------------------------------------------- entry points

def _flags(main, argv):
    """The option strings of the parser ``main`` builds."""
    seen = {}

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["p"] = self
        raise Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Parsed):
            main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return {o for a in seen["p"]._actions for o in a.option_strings
            if o not in ("-h", "--help")}


def test_cli_flags_equal_islx_plus_device():
    from islx.cli import export_programs as jexp
    from islx.cli import serve as jserve
    from islx_torch.cli import export_programs as texp
    from islx_torch.cli import serve as tserve

    assert _flags(texp.main, []) == _flags(jexp.main, []) | {"--device"}
    assert _flags(tserve.main, []) == _flags(jserve.main, []) | {"--device"}


def test_export_cli_then_serve_aot_dir(tmp_path, monkeypatch):
    """The export CLI writes one loadable artifact for each --orig; the
    serve CLI's --aot-dir loads both into the pipeline it builds, before
    any request."""
    from islx_torch.cli import export_programs, serve

    for var in ("ISLX_INT8", "ISLX_HAND_SCALE", "ISLX_HAND_STAGES",
                "ISLX_PACK_MODE", "ISLX_PALLAS_NMS"):
        monkeypatch.delenv(var, raising=False)
    out = tmp_path / "aot"
    export_programs.main(["--out", str(out), "--batch", "1", "--orig",
                          "48x48", "--orig", "96x96", "--target-h", "48",
                          "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == sorted([aot.artifact_name((1, 48, 48, 1.0, 1.0, "bgr")),
                            aot.artifact_name((1, 48, 48, 2.0, 2.0, "bgr"))])
    seen = {}

    def interrupt(self):
        seen["loaded"] = self.batcher.aot_loaded
        seen["stats"] = self.batcher.stats()
        raise KeyboardInterrupt

    monkeypatch.setattr(PoseServer, "serve_forever", interrupt)
    monkeypatch.setattr(PoseServer, "close", lambda self: None)
    serve.main(["--port", "0", "--device", "cpu", "--max-batch", "1",
                "--aot-dir", str(out)])
    assert sorted(seen["loaded"]) == [(1, 48, 48, 1.0, 1.0, "bgr"),
                                      (1, 48, 48, 2.0, 2.0, "bgr")]
    assert seen["stats"]["requests"] == seen["stats"]["batches"] == 0


def test_batcher_preload_is_not_traffic(params, art, monkeypatch):
    """MicroBatcher(aot_dir=) holds the key before traffic with 0
    requests, batches and calibration frames, its warm-up step ran on the
    worker thread (cuDNN and cuBLAS handles are a thread's); the served
    frames are the only ones the int8 counter sees, and they equal a
    direct step."""
    import threading

    threads = []
    warm = aot._warm

    def recording(pipe, key):
        threads.append(threading.current_thread())
        return warm(pipe, key)

    monkeypatch.setattr(aot, "_warm", recording)
    pipe = _pipe(params)
    b = MicroBatcher(pipe, max_batch=B, max_wait_ms=200.0, target_h=HB,
                     quantize_after=10 ** 6, aot_dir=art["dir"])
    try:
        assert threads == [b._worker]
        assert b.aot_loaded == [art["key"]]
        assert pipe.program_keys() == [art["key"]]
        s = b.stats()
        assert (s["requests"], s["batches"], s["frames_padded"]) == (0, 0, 0)
        assert b._calib_seen == 0 and b._calib_frames == []
        frames = _frames(5)
        got = [f.result(timeout=600) for f in [b.submit(f) for f in frames]]
    finally:
        b.close()
    assert b.stats()["batches"] == 1 and b._calib_seen == B
    results, boxes, peaks = pipe.assemble(art["packed"], B)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.candidate, results[i][0])
        np.testing.assert_array_equal(r.subset, results[i][1])
    assert pipe.program_keys() == [art["key"]]


def test_batcher_raises_what_its_preload_raised(params, art, monkeypatch):
    """A preload that fails outright (not a skipped file) fails the
    constructor, and the worker is gone."""
    def broken(pipe, dirpath, verbose=False):
        raise OSError("disk gone")

    monkeypatch.setattr(aot, "preload_dir", broken)
    with pytest.raises(OSError, match="disk gone"):
        MicroBatcher(_pipe(params), max_batch=B, aot_dir=art["dir"])
