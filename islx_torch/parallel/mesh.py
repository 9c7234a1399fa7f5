"""Device meshes and placements (port of ``islx/parallel/mesh.py``).

One process drives a mesh of its local devices, as islx's single JAX
controller does, and processes join through ``torch.distributed``
(:func:`init_distributed`). A :class:`Mesh` is a ``(data, model)`` grid of
``torch.device`` s:

* ``data``: batch parallelism (frames, windows, crops);
* ``model``: tensor parallelism for the translator head's gate and dense
  kernels (:func:`translator_param_spec`) and width stripes for the
  spatial CPM forward (:mod:`islx_torch.parallel.sharding`).

islx annotates arrays with ``NamedSharding`` s and XLA inserts the
collectives. Here a placement moves tensors explicitly:
:func:`batch_sharding` splits the leading dimension into ``n_data``
contiguous shards, :func:`spatial_sharding` splits the width over
``model`` at multiples of 8 pixels, and :func:`replicated` keeps one copy
a device. Each has a ``gather`` that puts shards back in batch order on
the mesh's first device. Work that runs a shard a data row uses the row's
first (``model`` 0) device, where XLA would run the same program on every
device of the row, and :func:`replicate` gives each row its own copy of a
net. Code without a mesh runs on :func:`single`, a 1x1 mesh: one shard,
one copy, nothing split or gathered.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(n_data, n_model)`` grid of devices.

    ``devices`` is an object array of ``torch.device`` s. A device may
    appear more than once (tests build ``[torch.device("cpu")] * 8``):
    that exercises the split, placement and gather logic, but no transfer
    between devices. A mesh is all CPU or all CUDA: a CUDA mesh never runs
    a shard on the CPU."""

    def __init__(self, devices: np.ndarray):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D device grid, got "
                             f"shape {devices.shape}")
        types = {torch.device(d).type for d in devices.ravel()}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(types)}")
        self.devices = np.empty(devices.shape, dtype=object)
        for idx, d in np.ndenumerate(devices):
            self.devices[idx] = torch.device(d)
        self.axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        """``{"data": n_data, "model": n_model}``, as islx reads it."""
        return {DATA_AXIS: self.devices.shape[0],
                MODEL_AXIS: self.devices.shape[1]}

    @property
    def first(self) -> torch.device:
        """Where gathered results land."""
        return self.devices[0, 0]

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each data row."""
        return list(self.devices[:, 0])

    def distinct(self) -> List[torch.device]:
        """Every device once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices.ravel():
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[[str(d) for d in row] for row in self.devices]})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device); all devices on the data axis unless ``n_data`` says
    otherwise."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[torch.device('cpu')] * n to run "
                               "a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} devices, {len(devices)} given")
    arr = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[:n_data * n_model]):
        arr[i // n_model, i % n_model] = d
    return Mesh(arr)


def single(device) -> Mesh:
    """The 1x1 mesh of one device: what a pipeline runs on without a
    mesh."""
    return Mesh(np.array([[torch.device(device)]], dtype=object))


def _to(x, dev: torch.device):
    """``x`` (a tensor, or nested dicts, lists and tuples of them) on
    ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def split_sizes(n: int, parts: int) -> List[int]:
    """``n`` rows into ``parts`` contiguous shards; refuses an uneven
    split (islx's programs take batches the data axis divides)."""
    if n % parts:
        raise ValueError(f"batch {n} not divisible by mesh data axis "
                         f"{parts}")
    return [n // parts] * parts


class BatchSharding:
    """The leading dimension over ``data``: ``n_data`` contiguous shards,
    shard ``i`` on data row ``i``'s first device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def put(self, x: torch.Tensor) -> List[torch.Tensor]:
        sizes = split_sizes(x.shape[0], self.mesh.shape[DATA_AXIS])
        return [s.to(d) for s, d in zip(torch.split(x, sizes),
                                        self.mesh.data_devices)]

    def put_flat(self, flat, b: int) -> List[torch.Tensor]:
        """A flat buffer of ``b`` equal records (frames) as one flat buffer
        a shard; a list is taken as shards already placed."""
        if isinstance(flat, (list, tuple)):
            return list(flat)
        return [s.reshape(-1) for s in self.put(flat.reshape(b, -1))]

    def gather(self, shards):
        """Shards (tensors, or tuples and NamedTuples of them) back in
        batch order on the mesh's first device; one shard is moved, not
        copied."""
        first, dev = shards[0], self.mesh.first
        if isinstance(first, torch.Tensor):
            if len(shards) == 1:
                return first.to(dev)
            return torch.cat([s.to(dev) for s in shards])
        fields = [self.gather(list(f)) for f in zip(*shards)]
        return (type(first)(*fields) if hasattr(first, "_fields")
                else type(first)(fields))


def stripe_bounds(w: int, n: int, align: int = 8) -> List[Tuple[int, int]]:
    """Column ranges of ``n`` width stripes of a ``w``-wide frame: the
    ``ceil(w / align)`` cells of ``align`` columns as evenly as possible,
    the ragged end in the last stripe, so that every stripe edge but the
    frame's own stays on a multiple of ``align`` (the CPMs' three 2x2
    pools keep their windows)."""
    cells = -(-w // align)
    if cells < n:
        raise ValueError(f"a {w}-wide frame has {cells} columns of {align} "
                         f"pixels, fewer than {n} stripes")
    edges = [min(w, align * (cells * j // n)) for j in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


class SpatialSharding:
    """NHWC frames: the batch over ``data``, the width over ``model``
    (:func:`stripe_bounds`); ``put`` gives ``[row][stripe]`` tensors,
    stripe ``j`` of row ``i`` on device ``(i, j)``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def put(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        rows = torch.split(x, split_sizes(x.shape[0],
                                          self.mesh.shape[DATA_AXIS]))
        bounds = stripe_bounds(x.shape[2], self.mesh.shape[MODEL_AXIS])
        return [[r[:, :, a:b].to(self.mesh.devices[i, j])
                 for j, (a, b) in enumerate(bounds)]
                for i, r in enumerate(rows)]

    def gather(self, stripes: Sequence[Sequence[torch.Tensor]]
               ) -> torch.Tensor:
        dev = self.mesh.first
        return torch.cat([torch.cat([s.to(dev) for s in row], dim=2)
                          for row in stripes])


def gather_rows(shards: Sequence[torch.Tensor], rows, dev: torch.device
                ) -> Tuple[torch.Tensor, np.ndarray]:
    """The batch rows named by ``rows`` (host ints indexing the batch that
    ``shards`` split in order), each distinct row once, copied from the
    shard that holds it to ``dev`` -> (those rows, each name's index among
    them). A shard reading frames that other shards hold copies only
    those frames."""
    uniq, inv = np.unique(np.asarray(rows, np.int64), return_inverse=True)
    ends = np.cumsum([s.shape[0] for s in shards])
    if len(uniq) and (uniq[0] < 0 or uniq[-1] >= ends[-1]):
        raise IndexError(f"rows {uniq[0]}..{uniq[-1]} outside a batch of "
                         f"{ends[-1]}")
    owner = np.searchsorted(ends, uniq, side="right")
    parts = [shards[0][:0].to(dev)]
    for i, s in enumerate(shards):
        mine = uniq[owner == i] - (ends[i] - s.shape[0])
        if len(mine):
            idx = torch.from_numpy(mine).to(s.device)
            parts.append(s.index_select(0, idx).to(dev))
    return torch.cat(parts), inv.reshape(-1).astype(np.int32)


def replicate(mesh: Mesh, make: Callable[[torch.device], Any],
              first: Any = None, grid: bool = False) -> List:
    """One copy of a value (a net, a weight state) a data row, copy ``i``
    built by ``make(device)`` on row ``i``'s first device; ``first``, when
    given, is row 0's copy. ``grid=True``: a copy for every device of the
    grid, ``[row][column]`` (the spatial forward's stripes). Rows never
    share a copy, also where they share a device, so a mesh of repeated
    devices runs, reduces and broadcasts real copies."""
    if grid:
        return [[make(d) if (i, j) != (0, 0) or first is None else first
                 for j, d in enumerate(row)]
                for i, row in enumerate(mesh.devices)]
    return [make(d) if i or first is None else first
            for i, d in enumerate(mesh.data_devices)]


class Replicated:
    """One copy a data row (:func:`replicate`); ``gather`` gives row 0's."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def put(self, value) -> List:
        return replicate(self.mesh, lambda d: _to(value, d))

    def gather(self, copies):
        return copies[0]


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Leading (batch) dim over the data axis."""
    return BatchSharding(mesh)


def spatial_sharding(mesh: Mesh) -> SpatialSharding:
    """NHWC: batch over ``data``, width over ``model`` (dp x sp): each
    device owns a vertical stripe of its frames; the spatial forward
    exchanges the columns each conv needs at stripe edges."""
    return SpatialSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    """One copy a data row."""
    return Replicated(mesh)


def _divides(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def translator_param_spec(name: str, key: str, shape: Tuple[int, ...],
                          n_model: int) -> Tuple:
    """Tensor-parallel rules for the BiLSTM head, islx's word for word: a
    partition spec as a tuple, ``()`` replicated.

    LSTM kernels [F,4U] and recurrent [U,4U] shard the gate dim over
    ``model``; hidden dense kernels shard the output dim. Biases/BN stats and
    the (prime-sized, 167-way) output projection replicate.
    """
    if n_model <= 1:
        return ()
    if name.startswith("lstm") and key in ("kernel", "recurrent") \
            and _divides(shape[1], n_model):
        return (None, MODEL_AXIS)
    if name.startswith("lstm") and key == "bias" \
            and _divides(shape[0], n_model):
        return (MODEL_AXIS,)
    if name in ("dense1", "dense2") and key == "kernel" \
            and _divides(shape[1], n_model):
        return (None, MODEL_AXIS)
    return ()


def translator_param_shardings(params, mesh: Mesh):
    """The spec of every head parameter under the TP rules."""
    n_model = mesh.shape[MODEL_AXIS]
    return {name: {key: translator_param_spec(name, key, np.shape(v), n_model)
                   for key, v in entry.items()}
            for name, entry in params.items()}


def shard_translator_params(params, mesh: Mesh, cfg=None):
    """The head (islx-layout numpy params) on the mesh under the TP rules:
    a :class:`islx_torch.models.translator.TranslatorHead` on ``mesh``."""
    from islx_torch.core.config import TranslatorConfig
    from islx_torch.models import translator as T

    return T.TranslatorHead(params, cfg or TranslatorConfig(), mesh)


def shard_cpm_params(params, mesh: Mesh) -> List:
    """CPM weight states replicate (26-52M params fit on every device): a
    copy a data row. The forwards of :mod:`islx_torch.parallel.sharding`
    build their nets once from it."""
    return replicated(mesh).put(params)


# ---------------------------------------------------------------------------
# Multi-process glue
# ---------------------------------------------------------------------------


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join a multi-process run (one process a host) through
    ``torch.distributed``: gloo on the CPU, NCCL where CUDA is available.

    The arguments default to the environment variables islx reads
    (``JAX_COORDINATOR_ADDRESS`` as ``host:port``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), so one launch script drives both packages. Safe to
    call twice, and a no-op when nothing is configured. Afterwards
    ``torch.distributed.get_rank()``/``get_world_size()`` drive the
    per-process input sharding (the extract CLI's defaults). Returns True
    when more than one process has joined."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, "
                         "the number of processes and this process's id")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)     # this process's mesh starts at cuda:0
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def process_rank() -> Tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class GlobalBatch:
    """A process's rows of a batch sharded over the processes' meshes:
    ``shards`` (its rows split over its own data devices), ``offset`` (its
    first row's global index) and ``count`` (the global batch)."""

    def __init__(self, shards: List[torch.Tensor], offset: int, count: int):
        self.shards = shards
        self.offset = offset
        self.count = count

    @property
    def local_count(self) -> int:
        return sum(s.shape[0] for s in self.shards)


def global_batch_from_local(mesh: Mesh, local) -> GlobalBatch:
    """Per-process local batch -> its place in the global batch.

    Each process loads only its own rows (its video shard, say); they go
    to its own data devices and nothing crosses processes. Every process
    holds the same number of rows, as islx's
    ``make_array_from_process_local_data`` assumes, so the offset is the
    rank times that number."""
    local = torch.as_tensor(np.asarray(local))
    rank, world = process_rank()
    n = local.shape[0]
    return GlobalBatch(batch_sharding(mesh).put(local), rank * n, world * n)
