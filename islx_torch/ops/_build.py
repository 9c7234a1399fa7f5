"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``islx_torch/_build/lib<name>.so`` the first
time a kernel of it is launched in a process, and loaded with ``ctypes``.
Nothing is built on import, so the package imports on machines without
``nvcc`` or a GPU. A library newer than its source and every header in
``csrc/`` is reused.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
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


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library newer than it and than
    every ``csrc/*.cuh`` exists; -> the library's path. Raises with nvcc's
    output if it fails."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD, f"lib{name}.so")
    newest = max(map(os.path.getmtime,
                     [src, *glob.glob(os.path.join(CSRC, "*.cuh"))]))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


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
