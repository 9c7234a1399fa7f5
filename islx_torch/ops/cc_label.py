"""8-connected component labels of binary maps.

``label_components`` is the port of the Pallas kernel
``islx/ops/pallas_cc.py::label_components_pallas`` (and of
``islx/ops/hand_peaks.py::_label_components``, which computes the same
labels). On a CUDA tensor it launches the hand-written tiled union-find
kernel in ``islx_torch/csrc/cc_label.cu`` (tiles from :func:`tile_plan`); on
a CPU tensor it runs :func:`label_components_plain`, a plain PyTorch
version of the same function. There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Contract: a component's label is the smallest row-major index y*W+x of its
pixels; background gets H*W.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from islx_torch.ops import _build
from islx_torch.ops._bands import MAX_SMEM

# W, NW, N and NE: with their mirror images, the 8 neighbours
_HALF_NEIGHBOURS = ((0, -1), (-1, -1), (-1, 0), (-1, 1))
# The kernel's tile: up to TILE_ROWS x TILE_W pixels of all C channels;
# 256 blocks of 352 threads at the Hand call's [256,256,21], ~49 KB of
# shared memory each. Smaller tiles were faster on blob maps up to 368 px
# and slower on larger or more fragmented maps (PERF.md, the cc_label
# findings). TILE_W is the kernel's kTw.
TILE_ROWS = 16
TILE_W = 16


def tile_plan(h: int, w: int, c: int):
    """-> (rows a tile, tiles down, tiles across, bytes a staged row, shared
    bytes a block) for the kernel's tiles of [H,W,C] maps: TILE_ROWS rows,
    halved until a block's shared memory holds its staged fg rows (each
    padded to a 16-byte multiple with room for a 15-byte misalignment), its
    forest of th*TILE_W*C int32 slots and its list of links between runs,
    fewer than th*(TILE_W+1)*C."""
    row_bytes = -(-(TILE_W * c + 15) // 16) * 16
    th = TILE_ROWS
    while True:
        smem = (th * row_bytes + 4 * th * TILE_W * c
                + 4 * th * (TILE_W + 1) * c)
        if smem <= MAX_SMEM:
            return th, -(-h // th), -(-w // TILE_W), row_bytes, smem
        if th == 1:
            raise ValueError(f"label_components: {c} channels do not fit a "
                             f"block's shared memory")
        th //= 2


def label_components_plain(binary: torch.Tensor) -> torch.Tensor:
    """binary [H,W,C] bool -> labels [H,W,C] int32.

    Min-label hooking with pointer jumping over the 8-neighbour edges (the
    FastSV scheme): each round every node's parent's parent takes the
    smallest grandparent across its edges, every node takes the smallest
    neighbouring grandparent, and parents jump to grandparents. Parents only
    decrease and stay inside the component, so the fixpoint is each
    component's smallest index. The rounds grow with the log of a
    component's path length, not with the length itself."""
    h, w, c = binary.shape
    n = h * w
    dev = binary.device
    fg = binary.permute(2, 0, 1)                               # [C,H,W]
    # node ids: channel ci owns [ci*(n+1), (ci+1)*(n+1)); the last is the
    # channel's background sink, so every parent is a valid index
    base = torch.arange(c, device=dev)[:, None, None] * (n + 1)
    ids = base + torch.arange(n, device=dev).reshape(1, h, w)
    us, vs = [], []
    for dy, dx in _HALF_NEIGHBOURS:
        ys, yt = slice(max(-dy, 0), h - max(dy, 0)), slice(max(dy, 0),
                                                           h + min(dy, 0))
        xs, xt = slice(max(-dx, 0), w - max(dx, 0)), slice(max(dx, 0),
                                                           w + min(dx, 0))
        both = fg[:, ys, xs] & fg[:, yt, xt]
        us.append(ids[:, ys, xs][both])
        vs.append(ids[:, yt, xt][both])
    u = torch.cat(us + vs)
    v = torch.cat(vs + us)
    f = torch.where(fg, ids, base + n).reshape(c, n)
    f = torch.cat([f, (base + n).reshape(c, 1)], 1).reshape(-1)
    while True:
        prev = f
        gf = f[f]
        f = f.clone()
        f.scatter_reduce_(0, prev[u], gf[v], "amin")         # hook trees
        f.scatter_reduce_(0, u, gf[v], "amin")               # hook nodes
        f = torch.minimum(f, f[f])                           # jump
        if torch.equal(f, prev):
            break
    lab = (f.reshape(c, n + 1)[:, :n] - base.reshape(c, 1)).to(torch.int32)
    return lab.reshape(c, h, w).permute(1, 2, 0).contiguous()


@functools.cache
def _kernel():
    lib = _build.load("cc_label")
    fn = lib.islx_cc_label
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def label_components(binary: torch.Tensor) -> torch.Tensor:
    """binary [H,W,C] bool -> labels [H,W,C] int32 (see the module doc).

    CUDA tensors go through the sm_90a kernel on the current stream (no
    synchronisation; ``label_components.launches`` counts the calls, each
    one ctypes call of up to three launches), CPU tensors through
    :func:`label_components_plain`."""
    if binary.device.type == "cpu":
        return label_components_plain(binary)
    if binary.device.type != "cuda":
        raise ValueError(f"label_components: unsupported device "
                         f"{binary.device}")
    if binary.dtype != torch.bool:
        raise TypeError(f"label_components: need bool, got {binary.dtype}")
    if binary.dim() != 3:
        raise ValueError(f"label_components: need [H,W,C], got "
                         f"{tuple(binary.shape)}")
    if not binary.is_contiguous():
        raise ValueError("label_components: input must be contiguous")
    h, w, c = binary.shape
    if h * w >= 2 ** 31 - 1 or h * w * c >= 2 ** 62:
        raise ValueError(f"label_components: map {h}x{w} too large")
    dev = binary.device
    labels = torch.empty((h, w, c), dtype=torch.int32, device=dev)
    if labels.numel() == 0:
        return labels
    _build.launch("label_components", _kernel(), dev, binary.data_ptr(),
                  labels.data_ptr(), h, w, c, *tile_plan(h, w, c))
    label_components.launches += 1
    return labels


label_components.launches = 0
