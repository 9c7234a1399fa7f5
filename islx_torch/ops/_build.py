"""Build and load the port's CUDA kernels and its C++ host code.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``islx_torch/_build/lib<name>-<key16>.so`` the
first time a kernel of it is launched in a process, and loaded with
``ctypes``. A ``csrc/<name>.cpp`` (host code: the person grouping) is
compiled the same way with ``g++``. Nothing is built on import, so the
package imports on machines without ``nvcc`` or a GPU.

A library is keyed by its content (:func:`key`): the sha256 of its source,
of every ``csrc/*.cuh`` for a ``.cu``, and of the compiler flags (the arch
among them). ``<key16>`` is the key's first 16 hex digits. A library is
reused only under its key, never by its age, so a ``_build/`` copied from
another tree, or one older than sources whose files carry older times,
cannot be loaded for sources it was not built from. The key needs no
compiler, so a host without ``nvcc`` can check a library shipped to it
(:func:`install`, :mod:`islx_torch.core.aot`); a shipped library that does
not load here is refused, so it never holds a key's path. Beside each
library a ``.json`` file keeps its name, key and the compiler's version
line, and :func:`loaded` lists what this process loaded.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: Dict[str, ctypes.CDLL] = {}
_records: Dict[str, dict] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the GPU")
    return path


def cxx() -> str:
    """Path of ``g++`` on PATH."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the port's C++ grouping "
                           "(csrc/grouping.cpp) is built with g++ at first "
                           "use")
    return found


def _source(name: str):
    """(source path, the files its key covers, compiler flags)."""
    src = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(src):
        return (src, [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))],
                NVCC_FLAGS)
    src = os.path.join(CSRC, f"{name}.cpp")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")
    return src, [src], CXX_FLAGS


def key(name: str) -> str:
    """The library's key: sha256 over the source's bytes, every
    ``csrc/*.cuh`` in name order for a ``.cu``, and the compiler flags.
    Computed without a compiler."""
    src, deps, flags = _source(name)
    h = hashlib.sha256()
    for path in deps:
        with open(path, "rb") as f:
            data = f.read()
        h.update(f"{os.path.basename(path)}\0{len(data)}\0".encode())
        h.update(data)
    h.update("\0".join(flags).encode())
    return h.hexdigest()


def lib_path(name: str, k: Optional[str] = None) -> str:
    """Where the library of ``name`` under key ``k`` (this tree's by
    default) lives."""
    return os.path.join(BUILD, f"lib{name}-{(k or key(name))[:16]}.so")


def _compiler_line(cmd: str) -> str:
    """The compiler's ``--version`` line: nvcc's ``release`` line, g++'s
    first."""
    out = subprocess.run([cmd, "--version"], capture_output=True,
                         text=True).stdout.splitlines()
    lines = [ln.strip() for ln in out if ln.strip()]
    return next((ln for ln in lines if "release" in ln),
                lines[0] if lines else "unknown")


def _write(out: str, write, note: dict) -> None:
    """Write a library through ``write(tmp_path)`` into ``out``, and its
    note beside it, each atomically (a reader never sees half a file)."""
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        write(tmp)
        with open(tmp + ".json", "w") as f:
            json.dump(note, f)
        os.replace(tmp + ".json", out[:-3] + ".json")
        os.replace(tmp, out)
    finally:
        for path in (tmp, tmp + ".json"):
            if os.path.exists(path):
                os.unlink(path)


def _note(path: str) -> dict:
    """The note beside a library (name, key, compiler line); {} if it
    cannot be read."""
    try:
        with open(path[:-3] + ".json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def build(name: str) -> dict:
    """The library of ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp``
    (g++) under this tree's key, compiled unless it exists -> its record:
    name, key, path and compiler line. Raises with the compiler's output if
    it fails, and if the compiler is missing."""
    src, _, flags = _source(name)
    k = key(name)
    out = lib_path(name, k)
    if os.path.exists(out):
        return {"name": name, "key": k, "path": out,
                "compiler": _note(out).get("compiler", "unknown")}
    cc = nvcc() if src.endswith(".cu") else cxx()

    def compile_to(tmp):
        proc = subprocess.run([cc, *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cc)} failed on "
                               f"{src}:\n{proc.stderr}")

    note = {"name": name, "key": k, "compiler": _compiler_line(cc)}
    _write(out, compile_to, note)
    return dict(note, path=out)


def install(name: str, k: str, blob: bytes,
            compiler: str = "unknown") -> str:
    """Write a shipped library of ``name`` into ``BUILD`` under key ``k``
    unless one is there already; -> its path. Raises ``ValueError`` when
    ``k`` is not this tree's key for ``name`` (the library was built from
    other sources or flags), and when the blob does not load on this host
    (another libc or toolchain): it never takes the key's path, so
    :func:`build` compiles there instead."""
    want = key(name)
    if k != want:
        raise ValueError(f"library {name}: key {k[:16]} is not this tree's "
                         f"{want[:16]}")
    out = lib_path(name, k)
    if os.path.exists(out):
        return out

    def write_to(tmp):
        with open(tmp, "wb") as f:
            f.write(blob)
        try:
            ctypes.CDLL(tmp)
        except OSError as e:
            raise ValueError(f"library {name}: the shipped library does not "
                             f"load on this host ({e})") from e

    _write(out, write_to, {"name": name, "key": k, "compiler": compiler})
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            record = build(name)
            lib = ctypes.CDLL(record["path"])
            _libs[name] = lib
            _records[name] = record
        return lib


def loaded() -> List[dict]:
    """What this process loaded: each library's name, key, path and
    compiler line, in load order."""
    with _lock:
        return [dict(r) for r in _records.values()]


def launch(what: str, fn, dev: torch.device, *args) -> None:
    """Calls a kernel's C entry ``fn(*args, stream)`` on the raw handle of
    ``dev``'s current stream (a ``torch.cuda.Stream`` object costs host
    time of the order of a kernel), with a device guard only where ``dev``
    is not the current device. Raises if it returns a CUDA error."""
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {err})")
