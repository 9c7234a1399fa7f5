"""Serving warm starts: artifacts that let a new process answer its first
request at a shape without paying its first-call costs (port of
``islx/core/aot.py``, with its names).

islx serializes each compiled XLA program. The port compiles no program:
the first request a new process serves at a shape pays instead for the
``nvcc``/``g++`` builds of the libraries its step launches
(:mod:`islx_torch.ops._build`), their ``dlopen``, cuDNN's first call at
each conv shape and the caching allocator's first blocks. An artifact
here is one zip file (stdlib ``zipfile``; no pickle anywhere) that holds

* ``meta.json``: the fingerprint of the pipeline it was made for (islx's
  fields, with ``torch``, ``cuda`` and the device's capability in place of
  ``jax``), ``kind="lib"``, ``num_devices`` and the program key;
* the kernel libraries the exporting process loaded, each under its
  content key (:func:`islx_torch.ops._build.key`) with its compiler line.

``load_fused`` checks the fingerprint, installs the libraries through
:func:`islx_torch.ops._build.install` (which refuses a library whose key
is not this tree's) and runs one step at the key on zero frames, so that
the first request finds every library loaded and cuDNN and the allocator
warm. A library that fails to install or load raises: a kernel never falls
back to its plain version. The libraries depend on the sources and the
flags, never on weight values, so an artifact made with random weights
serves real checkpoints of the same structure.

An artifact is trusted code, exactly like a pickle: its libraries are
native code that ``load_fused`` dlopens, and ``meta.json`` only claims
their keys. Load artifacts only from a source you would run code from.
A shipped library that does not load on this host is refused and never
takes its key's path (:func:`islx_torch.ops._build.install`).

islx's own artifacts (pickled PJRT executables or StableHLO) are refused
by their leading bytes, without unpickling them: the port cannot run XLA
programs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from islx_torch.ops import _build

_MAGIC = "islx_torch-aot-v1"
_ISLX_MAGIC = b"islx-aot-v1"      # islx's pickled artifacts carry it
_ZIP = b"PK\x03\x04"


class AotMismatch(RuntimeError):
    """Artifact does not match this process (platform/version/config)."""


def _leaves(tree, prefix=""):
    """(path, tensor or array) of a nested dict/tuple state, sorted by
    path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _params_sig(state) -> str:
    """Short hash of a port state's sorted keys and its leaves' shapes and
    dtypes: an int8 state (``w_q``, scales) differs from a float one, and
    BODY_25 from COCO."""
    s = ";".join(f"{path}{tuple(np.shape(x))}{getattr(x, 'dtype', type(x))}"
                 for path, x in _leaves(state))
    return hashlib.sha1(s.encode()).hexdigest()[:16]


# Fingerprint fields added after the first artifacts shipped: an artifact
# that predates a field is treated as built at that field's DOCUMENTED
# default and the default is compared against the current pipeline's value
# (never skipped — e.g. an old artifact exported under ISLX_HAND_STAGES=5
# lacks "hand_stages" but was NOT built at 6 stages; skipping the check
# would silently serve the wrong CPM depth). So old artifacts
# only load when the pipeline actually sits at the default configuration.
_LENIENT_DEFAULTS = {
    "det_cfg": (0.33, 1.5, 0.9, 20, 2),   # dataclasses.astuple(DetectorConfig())
    "hand_boxsize": 368,                  # HandConfig.boxsize
    "crop_chunk": None,                   # BatchedHandPipeline default
    "two_stage_peaks": True,              # BatchedBodyPipeline default
    "fused_peaks": True,                  # follows two_stage_peaks
    "thre2": 0.05,                        # PoseConfig.thre2
    "hand_stages": 6,                     # HandConfig.stages
    # the port's own fields: which NMS library the step launches, and the
    # nets' compute dtype (islx's params_sig sees its cast; the port's
    # state does not carry it)
    "pallas_nms": False,                  # BatchedBodyPipeline default
    "compute_dtype": "bfloat16",          # FusedPosePipeline default
}


def _num_devices(pipe) -> int:
    return int(pipe.mesh.devices.size)


def _fingerprint(pipe) -> dict:
    dev = pipe.device
    gpu = dev.type == "cuda"
    return {
        "magic": _MAGIC,
        "platform": "gpu" if gpu else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if gpu else dev.type,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "capability": (list(torch.cuda.get_device_capability(dev)) if gpu
                       else None),
        "model_type": pipe.model_type,
        "pack_mode": pipe.body.pack_mode,
        "paf_mode": getattr(pipe.body, "paf_mode", None),
        "max_peaks": pipe.body.cfg.max_peaks,
        "top_m": pipe.body.top_m,
        "hand_scales": tuple(pipe.hand.cfg.scale_search),
        "hand_stages": pipe.hand.cfg.stages,
        "params_sig": _params_sig((pipe.body.params, pipe.hand.params)),
        "sharded": _num_devices(pipe) > 1,
        "det_cfg": dataclasses.astuple(pipe.det_cfg),
        "hand_boxsize": pipe.hand.cfg.boxsize,
        "crop_chunk": getattr(pipe.hand, "crop_chunk", None),
        "two_stage_peaks": getattr(pipe.body, "two_stage_peaks", None),
        "fused_peaks": getattr(pipe.body, "fused_peaks", None),
        "thre2": pipe.body.cfg.thre2,
        "pallas_nms": pipe.body.pallas_nms,
        "compute_dtype": str(pipe.body.compute_dtype).replace("torch.", ""),
    }


def _warm(pipe, key) -> None:
    """One step at ``key`` on zero frames, and its grouping: builds or
    loads every library the step launches, and pays cuDNN's first calls
    and the allocator's first blocks."""
    b, hb, wb, sy, sx, fmt = key
    n = b * hb * wb * 3 // (2 if fmt == "yuv420" else 1)
    packed = pipe.device_step_flat(
        torch.zeros(n, dtype=torch.uint8, device=pipe.device), b, hb, wb,
        (round(sy * hb), round(sx * wb)), input_format=fmt)
    pipe.assemble(packed, b)


def save_fused(pipe, path: str, b: int, hb: int, wb: int,
               orig_hw: Optional[Tuple[int, int]] = None,
               input_format: str = "bgr",
               kind: Optional[str] = None) -> dict:
    """Run one step at the key on zero frames, then write the fingerprint
    and the libraries this process loaded to ``path``. Returns its meta."""
    if kind not in (None, "lib"):
        raise ValueError(f"unknown artifact kind {kind!r}: the port writes "
                         f"'lib' artifacts (islx's 'exe' and 'hlo' hold XLA "
                         f"programs)")
    key = pipe.program_key(b, hb, wb, orig_hw or (hb, wb), input_format)
    _warm(pipe, key)
    libs = _build.loaded()
    meta = dict(_fingerprint(pipe), kind="lib",
                num_devices=_num_devices(pipe), key=list(key),
                libraries=[{k: r[k] for k in ("name", "key", "compiler")}
                           for r in libs])
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta))
        for r in libs:
            z.write(r["path"], f"lib/{r['name']}-{r['key']}.so")
    os.replace(tmp, path)          # atomic: partial writes never load
    return meta


def _open(path: str) -> zipfile.ZipFile:
    """The artifact's zip, told apart from islx's pickles by its leading
    bytes (nothing is unpickled)."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    if head.startswith(_ZIP):
        return zipfile.ZipFile(path)
    if _ISLX_MAGIC in head:
        raise AotMismatch(f"{path}: an islx JAX artifact; the port cannot "
                          f"load XLA programs")
    raise AotMismatch(f"{path}: not an islx_torch AOT artifact")


def _meta(z: zipfile.ZipFile, path: str) -> dict:
    try:
        return json.loads(z.read("meta.json"))
    except (KeyError, ValueError) as e:
        raise AotMismatch(f"{path}: no readable meta.json ({e})") from e


def read_meta(path: str) -> dict:
    with _open(path) as z:
        return _meta(z, path)


def load_fused(pipe, path: str):
    """Install an artifact's libraries and warm ``pipe`` at its key;
    returns the key. The libraries are native code: load only trusted
    artifacts.

    Raises AotMismatch when the artifact was built for a different
    platform / torch version / pipeline configuration, or from other
    kernel sources.
    """
    with _open(path) as z:
        meta, want = _meta(z, path), _fingerprint(pipe)
        if meta.get("magic") != _MAGIC:
            raise AotMismatch(f"{path}: not an islx_torch AOT artifact")

        def _norm(v):
            # JSON round-trips tuples as lists: compare shape-blind
            return [_norm(x) for x in v] if isinstance(v, (tuple, list)) \
                else v

        def _got(k):
            if k in meta:
                return meta[k]
            return _LENIENT_DEFAULTS.get(k)   # pre-field artifact: its default

        mismatched = {k: (_got(k), v) for k, v in want.items()
                      if _norm(_got(k)) != _norm(v)}
        if mismatched:
            raise AotMismatch(f"{path}: artifact/env mismatch {mismatched}")
        n_dev = int(meta.get("num_devices", 1))
        if _num_devices(pipe) < n_dev:
            raise AotMismatch(f"{path}: needs {n_dev} devices, the "
                              f"pipeline's mesh has {_num_devices(pipe)}")
        for lib in meta.get("libraries", []):
            try:
                _build.install(lib["name"], lib["key"],
                               z.read(f"lib/{lib['name']}-{lib['key']}.so"),
                               lib.get("compiler", "unknown"))
            except ValueError as e:
                raise AotMismatch(f"{path}: {e}") from e
    key = tuple(meta["key"])
    key = (int(key[0]), int(key[1]), int(key[2]),
           float(key[3]), float(key[4]), str(key[5]))
    _warm(pipe, key)             # records the key in pipe._programs
    return key


def preload_dir(pipe, dirpath: str, verbose: bool = False) -> List[tuple]:
    """Load every matching ``*.islxprog`` artifact in ``dirpath``.

    Foreign artifacts (other platform / torch version / config, islx's)
    are skipped, not fatal — a serving host warms what it can and pays
    the first calls of the rest.
    """
    keys = []
    if not os.path.isdir(dirpath):
        return keys
    for name in sorted(os.listdir(dirpath)):
        if not name.endswith(".islxprog"):
            continue
        path = os.path.join(dirpath, name)
        try:
            keys.append(load_fused(pipe, path))
            if verbose:
                print(f"[aot] loaded {name} -> key {keys[-1]}")
        except AotMismatch as e:
            if verbose:
                print(f"[aot] skipped {name}: {e}")
        except Exception as e:            # truncated/foreign file
            if verbose:
                print(f"[aot] unreadable {name}: {e}")
    return keys


def artifact_name(key) -> str:
    b, hb, wb, sy, sx, fmt = key
    return f"fused_b{b}_{hb}x{wb}_sy{sy:g}_sx{sx:g}_{fmt}.islxprog"
