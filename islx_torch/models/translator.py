"""ISL translation head: masked BiLSTM classifier over 167 expressions
(port of ``islx/models/translator.py``, inference and training).

    Input[20,156] -> Masking(0.) -> BatchNorm -> BiLSTM(32, seq) -> Dropout
    -> BiLSTM(32) -> ELU -> Dense32(no bias) -> BN -> Dropout -> ELU
    -> Dense32(no bias) -> BN -> ELU -> Dropout -> Dense(167, softmax)

The LSTMs are hand loops over the T=20 steps with keras masking: a masked
step passes h, c and the output through unchanged, which ``nn.LSTM`` cannot
express. Parameters keep the keras layout (kernel [F,4U], recurrent
[U,4U], bias [4U], gate order i, f, g, o) so islx's numpy params carry
across as they are. The BatchNorms' running ``mean``/``var`` are buffers,
updated by the training loop's EMA (:mod:`islx_torch.isl.train`), never by
gradients; in train mode a BN normalizes by its batch's mean and
population variance, and dropout draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from islx_torch.core.config import TranslatorConfig
from islx_torch.parallel import mesh as M

Params = Dict[str, Dict[str, np.ndarray]]


def init_params(cfg: TranslatorConfig = TranslatorConfig(),
                seed: int = 0) -> Params:
    """Seeded keras-style init: glorot-uniform kernels, orthogonal
    recurrent blocks, unit forget bias, He-normal hidden denses."""
    rng = np.random.RandomState(seed)
    u, f = cfg.lstm_units, cfg.feature_dim

    def lstm(in_dim):
        lim = np.sqrt(6.0 / (in_dim + 4 * u))
        rec = np.concatenate([np.linalg.qr(rng.randn(u, u))[0]
                              for _ in range(4)], axis=1)
        bias = np.zeros(4 * u)
        bias[u:2 * u] = 1.0
        return {"kernel": rng.uniform(-lim, lim, (in_dim, 4 * u)),
                "recurrent": rec, "bias": bias}

    def bn(dim):
        return {"gamma": np.ones(dim), "beta": np.zeros(dim),
                "mean": np.zeros(dim), "var": np.ones(dim)}

    d, n = cfg.dense_units, cfg.n_classes
    lim3 = np.sqrt(6.0 / (d + n))
    params = {
        "bn0": bn(f),
        "lstm1_fwd": lstm(f), "lstm1_bwd": lstm(f),
        "lstm2_fwd": lstm(2 * u), "lstm2_bwd": lstm(2 * u),
        "dense1": {"kernel": rng.randn(2 * u, d) * np.sqrt(2.0 / (2 * u))},
        "bn1": bn(d),
        "dense2": {"kernel": rng.randn(d, d) * np.sqrt(2.0 / d)},
        "bn2": bn(d),
        "dense3": {"kernel": rng.uniform(-lim3, lim3, (d, n)),
                   "bias": np.zeros(n)},
    }
    return {name: {k: np.asarray(v, np.float32) for k, v in e.items()}
            for name, e in params.items()}


def save_npz(path: str, params: Params) -> None:
    """The head as an islx ``.npz`` checkpoint (``{layer}/{name}`` keys)."""
    flat = {f"{name}/{k}": np.asarray(v)
            for name, entry in params.items() for k, v in entry.items()}
    np.savez(path, **flat)


def load_npz(path: str) -> Params:
    """islx head checkpoint (``islx.models.translator.save_npz``)."""
    params: Params = {}
    with np.load(path) as data:
        for key in data.files:
            name, k = key.split("/")
            params.setdefault(name, {})[k] = np.asarray(data[key])
    return params


# ---------------------------------------------------------------- keras I/O
#
# The weighted layers of the reference's keras head, in model order
# (Masking, Dropout and Activation carry no weights): bn0, bilstm1,
# bilstm2, dense1, bn1, dense2, bn2, dense3.
_LAYER_ORDER = ["bn0", ("lstm1_fwd", "lstm1_bwd"), ("lstm2_fwd", "lstm2_bwd"),
                "dense1", "bn1", "dense2", "bn2", "dense3"]


def from_keras_weights(weight_lists: list) -> Params:
    """Params from keras ``get_weights()`` lists, one a weighted layer in
    model order. BN = [gamma, beta, mean, var]; a bidirectional LSTM =
    [fwd kernel, fwd recurrent, fwd bias, bwd kernel, bwd recurrent, bwd
    bias]; Dense = [kernel(, bias)]."""
    params: Params = {}
    for ours, ws in zip(_LAYER_ORDER, weight_lists):
        ws = [np.asarray(w) for w in ws]
        if isinstance(ours, tuple):
            fwd, bwd = ours
            params[fwd] = dict(zip(("kernel", "recurrent", "bias"), ws[:3]))
            params[bwd] = dict(zip(("kernel", "recurrent", "bias"), ws[3:]))
        elif ours.startswith("bn"):
            params[ours] = dict(zip(("gamma", "beta", "mean", "var"), ws))
        else:
            params[ours] = dict(zip(("kernel", "bias"), ws))
    return params


def to_keras_weights(params: Params) -> list:
    """Inverse of :func:`from_keras_weights`: the ``get_weights()`` lists
    of each weighted layer (the head in the reference's keras stack)."""
    out = []
    for ours in _LAYER_ORDER:
        if isinstance(ours, tuple):
            out.append([np.asarray(params[name][k]) for name in ours
                        for k in ("kernel", "recurrent", "bias")])
        elif ours.startswith("bn"):
            out.append([np.asarray(params[ours][k])
                        for k in ("gamma", "beta", "mean", "var")])
        else:
            out.append([np.asarray(params[ours][k])
                        for k in ("kernel", "bias") if k in params[ours]])
    return out


def _saved_vars(group) -> list:
    """A keras 3 layer group's variables in ``get_weights()`` order: its
    own ``vars/0..n``, then a wrapper's forward and backward layers."""
    ws = []
    if "vars" in group:
        ws += [np.asarray(group["vars"][k])
               for k in sorted(group["vars"], key=int)]
    for sub in ("forward_layer", "backward_layer", "cell"):
        if sub in group:
            ws += _saved_vars(group[sub])
    return ws


def _str(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def keras_weight_lists(group, entry: dict) -> list:
    """The ``get_weights()`` list of every weighted layer of the keras 3
    model whose config ``entry`` is given and whose weights are under the
    h5 ``group``, in model order. keras saves a model's layers under
    ``layers/<class in snake case>[_n]``, counted in that order (a
    Sequential's InputLayer is not among them)."""
    from islx_torch.models.keras_export import snake

    seen: Dict[str, int] = {}
    out = []
    for layer in entry["config"]["layers"]:
        if (layer["class_name"] == "InputLayer"
                and entry["class_name"] == "Sequential"):
            continue
        base = snake(layer["class_name"])
        n = seen.get(base, -1) + 1
        seen[base] = n
        sub = group["layers"].get(base if n == 0 else f"{base}_{n}")
        ws = _saved_vars(sub) if sub is not None else []
        if ws:
            out.append(ws)
    return out


def _keras_weight_lists(path: str) -> list:
    """The ``get_weights()`` list of every weighted layer of a saved keras
    model, in model order, read with h5py: a keras 3 ``.keras`` archive
    (the layer order from its ``config.json``, the variables from its
    ``model.weights.h5``) or a legacy HDF5 ``.h5`` (``layer_names`` and
    ``weight_names``). keras itself is not imported: keras 3 imports JAX
    (its orbax callback, and tensorflow.lite under the tensorflow
    backend), which the port never imports."""
    import h5py

    out = []
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            config = json.loads(z.read("config.json"))
            weights = io.BytesIO(z.read("model.weights.h5"))
        with h5py.File(weights, "r") as f:
            return keras_weight_lists(f, config)
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name in root.attrs["layer_names"]:
            group = root[_str(name)]
            ws = [np.asarray(group[_str(w)])
                  for w in group.attrs["weight_names"]]
            if ws:
                out.append(ws)
    return out


def keras_head_entry(cfg: Optional[TranslatorConfig] = None,
                     name: str = "islx_head") -> dict:
    """The config entry of the reference's keras head
    (demo_isl_translate.py:72-100), the Sequential islx's
    ``build_keras_head`` builds, written without keras."""
    from islx_torch.models.keras_export import DTYPE, initializer

    cfg = cfg or TranslatorConfig()
    w, f, u = cfg.window_size, cfg.feature_dim, cfg.lstm_units
    d = cfg.dense_units

    def entry(cls, config, build=None):
        e = {"module": "keras.layers", "class_name": cls, "config": config,
             "registered_name": None}
        if build is not None:
            e["build_config"] = {"input_shape": build}
        return e

    def base(lname):
        return {"name": lname, "trainable": True, "dtype": DTYPE}

    def bn(lname, dim):
        return entry("BatchNormalization", {
            **base(lname), "axis": -1, "momentum": 0.99, "epsilon": 0.001,
            "center": True, "scale": True,
            "beta_initializer": initializer("Zeros"),
            "gamma_initializer": initializer("Ones"),
            "moving_mean_initializer": initializer("Zeros"),
            "moving_variance_initializer": initializer("Ones"),
            "beta_regularizer": None, "gamma_regularizer": None,
            "beta_constraint": None, "gamma_constraint": None,
            "synchronized": False}, [None] + dim)

    def lstm(lname, seq, backwards, shape):
        return entry("LSTM", {
            **base(lname), "return_sequences": seq, "return_state": False,
            "go_backwards": backwards, "stateful": False, "unroll": False,
            "zero_output_for_mask": seq, "units": u, "activation": "tanh",
            "recurrent_activation": "sigmoid", "use_bias": True,
            "kernel_initializer": initializer("GlorotUniform",
                                              {"seed": None}),
            "recurrent_initializer": initializer("Orthogonal",
                                                 {"seed": None, "gain": 1.0}),
            "bias_initializer": initializer("Zeros"),
            "unit_forget_bias": True, "kernel_regularizer": None,
            "recurrent_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "recurrent_constraint": None, "bias_constraint": None,
            "dropout": 0.0, "recurrent_dropout": 0.2, "seed": None}, shape)

    def bilstm(lname, suffix, seq, shape):
        return entry("Bidirectional", {
            **base(lname), "merge_mode": "concat",
            "layer": lstm(f"forward_lstm{suffix}", seq, False, shape),
            "backward_layer": lstm(f"backward_lstm{suffix}", seq, True,
                                   shape)}, shape)

    def dropout(lname):
        return entry("Dropout", {**base(lname), "rate": 0.2, "seed": None,
                                 "noise_shape": None})

    def act(lname):
        return entry("Activation", {**base(lname), "activation": "elu"})

    def dense(lname, units, activation, bias, kinit, dim):
        return entry("Dense", {
            **base(lname), "units": units, "activation": activation,
            "use_bias": bias, "kernel_initializer": kinit,
            "bias_initializer": initializer("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "kernel_constraint": None, "bias_constraint": None,
            "quantization_config": None}, [None, dim])

    he = initializer("HeNormal", {"seed": None})
    layers = [
        entry("InputLayer", {"batch_shape": [None, w, f], "dtype": "float32",
                             "sparse": False, "ragged": False,
                             "name": "input_layer", "optional": False}),
        entry("Masking", {**base("masking"), "mask_value": 0.0}),
        bn("batch_normalization", [w, f]),
        bilstm("bidirectional", "", True, [None, w, f]),
        dropout("dropout"),
        bilstm("bidirectional_1", "_1", False, [None, w, 2 * u]),
        act("activation"),
        dense("dense", d, "linear", False, he, 2 * u),
        bn("batch_normalization_1", [d]),
        dropout("dropout_1"),
        act("activation_1"),
        dense("dense_1", d, "linear", False, he, d),
        bn("batch_normalization_2", [d]),
        act("activation_2"),
        dropout("dropout_2"),
        dense("dense_2", cfg.n_classes, "softmax", True,
              initializer("GlorotUniform", {"seed": None}), d),
    ]
    return {"module": "keras", "class_name": "Sequential",
            "config": {"name": name, "trainable": True, "dtype": DTYPE,
                       "layers": layers, "build_input_shape": [None, w, f]},
            "registered_name": None,
            "build_config": {"input_shape": [None, w, f]},
            "compile_config": {}}


def save_keras_head(group, params: Params, name: str = "islx_head") -> None:
    """The head's weights as keras 3 saves a Sequential's under ``group``
    (``layers/<class>[_n]/vars``, a Bidirectional's in its
    ``forward_layer/cell`` and ``backward_layer/cell``): the counterpart
    of ``build_keras_head(...).set_weights(to_keras_weights(params))``."""
    lists = iter(to_keras_weights(params))
    lg = group.create_group("layers")

    def put(g, lname, ws=()):
        v = g.create_group("vars")
        v.attrs["name"] = lname
        for i, a in enumerate(ws):
            v.create_dataset(str(i), data=np.asarray(a, np.float32))

    for path, lname in (
            ("masking", None), ("batch_normalization", "w"),
            ("bidirectional", ""), ("dropout", None),
            ("bidirectional_1", "_1"), ("activation", None),
            ("dense", "w"), ("batch_normalization_1", "w"),
            ("dropout_1", None), ("activation_1", None), ("dense_1", "w"),
            ("batch_normalization_2", "w"), ("activation_2", None),
            ("dropout_2", None), ("dense_2", "w")):
        g = lg.create_group(path)
        if path.startswith("bidirectional"):
            ws = next(lists)
            for side, part in (("forward", ws[:3]), ("backward", ws[3:])):
                sg = g.create_group(f"{side}_layer")
                put(sg.create_group("cell"), "lstm_cell", part)
                put(sg, f"{side}_lstm{lname}")
            put(g, path)
        else:
            put(g, path, next(lists) if lname == "w" else ())
    group.create_group("vars").attrs["name"] = name


def export_keras_head(params: Params, path: str,
                      cfg: Optional[TranslatorConfig] = None) -> None:
    """The head as a ``.keras`` file that stock keras, islx's and the
    port's :func:`load_keras` read (h5py, no keras)."""
    from islx_torch.models.keras_export import write_keras

    if not path.endswith(".keras"):
        raise ValueError(f"{path}: the port writes .keras archives only")
    write_keras(path, keras_head_entry(cfg),
                lambda f: save_keras_head(f, params))


def load_keras(path: str) -> Params:
    """A reference-trained ``.keras``/``.h5`` head checkpoint (reference
    demo_isl_translate.py:100), read with h5py
    (:func:`_keras_weight_lists`); where h5py is missing, as on a machine
    with only PyTorch, convert the head to ``.npz`` on one that has it."""
    return from_keras_weights(_keras_weight_lists(path))


def _lstm(parts, xs: torch.Tensor, mask: torch.Tensor, reverse: bool):
    """Masked LSTM over time. ``parts``: the weights' gate-column parts
    ({kernel, recurrent, bias} each) on the devices that hold them, one
    part when the gates are not split (tensor parallelism: each part's
    columns of the gate pre-activations are computed on its device and
    gathered on xs's every step). xs [B,T,F], mask [B,T] bool ->
    (outputs [B,T,U], last output [B,U])."""
    units = parts[0]["recurrent"].shape[0]
    b, t_len = xs.shape[0], xs.shape[1]
    zx = [torch.matmul(xs.to(p["kernel"].device), p["kernel"]) + p["bias"]
          for p in parts]                                  # [B,T,4U/n]
    h = xs.new_zeros((b, units))
    c = xs.new_zeros((b, units))
    out = xs.new_zeros((b, units))
    outs = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        zs = [(z[:, t] + h.to(z.device) @ p["recurrent"]).to(xs.device)
              for z, p in zip(zx, parts)]
        z = zs[0] if len(zs) == 1 else torch.cat(zs, -1)
        i, f, g, o = torch.split(z, units, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out = torch.where(m, h, out)
        outs[t] = out
    return torch.stack(outs, dim=1), out


BN_KEYS = ("mean", "var")   # running statistics: buffers, not parameters


def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population variance (islx's ``x.var``) over every axis
    but the last; masked zero timesteps count, as in islx."""
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(axes)
    return mean, (x - mean).square().mean(axes)


def _keep(shape, rate: float, generator: torch.Generator) -> torch.Tensor:
    """A dropout keep mask of ``shape``, on the generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < 1.0 - rate


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator], train: bool,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``; the identity outside train mode, at rate 0 or
    without a generator (islx's ``rng=None``). ``keep``: x's slice of a
    mask drawn for a larger batch, else one is drawn for x."""
    if not train or generator is None or rate == 0.0:
        return x
    if keep is None:
        keep = _keep(x.shape, rate, generator)
    return torch.where(keep.to(x.device), x / (1.0 - rate),
                       torch.zeros_like(x))


class _AllGatherRows(torch.autograd.Function):
    """Every process's rows, in rank order (equal counts). The backward
    sums the gradient of all rows over the processes, since every
    process's loss reads every row, and keeps this process's rows."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rank, ctx.n = dist.get_rank(), x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n]


class TranslatorHead(nn.Module):
    """The BiLSTM head; ``forward(x [B,T,156]) -> probabilities [B,167]``.

    A timestep is masked where every feature is 0 (keras
    ``Masking(mask_value=0.)``, the zero-padded window tail). Every weight
    is a parameter (``{layer}__{name}``) but the BNs' ``mean``/``var``,
    which are buffers.

    ``mesh`` (:mod:`islx_torch.parallel.mesh`): islx's tensor-parallel
    rules (:func:`~islx_torch.parallel.mesh.translator_param_spec`) and
    data parallelism, as islx's SPMD program runs them. A weight that the
    rules split over ``model`` is held as ``n_model`` column parts, part
    ``j`` on device ``(0, j)`` (``{layer}__{name}__{j}``); the others, and
    the BN statistics, on the mesh's first device. ``forward`` splits this
    process's rows over the data axis; row ``i`` works on differentiable
    copies of the weights on its own devices, so the gradients of all rows
    add up in the one master copy. Each model device computes its columns
    of the LSTM gate pre-activations and of the dense outputs, which the
    row's first device gathers (at every timestep, for the LSTMs). In
    train mode every BN normalizes by the moments of the global batch (of
    every row, and of every process when a process group of more than one
    is initialised), and dropout draws one mask over the global batch's
    shape, so the step equals the unmeshed head's given the same
    generator. Without a mesh the head is the one-part, one-row case on
    the device it was moved to."""

    def __init__(self, params: Mapping[str, Mapping[str, np.ndarray]],
                 cfg: TranslatorConfig = TranslatorConfig(), mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.rank, self.world = ((0, 1) if mesh is None
                                 else M.process_rank())
        n_model = 1 if mesh is None else mesh.shape[M.MODEL_AXIS]
        self._keys = {name: list(entry) for name, entry in params.items()}
        self._split: Dict[Tuple[str, str], int] = {}   # -> split dim
        for name, entry in params.items():
            for k, v in entry.items():
                t = torch.from_numpy(np.array(v, np.float32))
                spec = M.translator_param_spec(name, k, t.shape, n_model)
                if name.startswith("bn") and k in BN_KEYS:
                    self.register_buffer(f"{name}__{k}", self._place(t))
                elif spec:
                    dim = spec.index(M.MODEL_AXIS)
                    self._split[(name, k)] = dim
                    for j, part in enumerate(t.chunk(n_model, dim)):
                        self.register_parameter(
                            f"{name}__{k}__{j}", nn.Parameter(
                                self._place(part.contiguous(), j)))
                else:
                    self.register_parameter(f"{name}__{k}",
                                            nn.Parameter(self._place(t)))

    def _place(self, t: torch.Tensor, j: int = 0) -> torch.Tensor:
        return t if self.mesh is None else t.to(self.mesh.devices[0, j])

    def _grid(self):
        """The mesh, or the 1x1 mesh of the device the head is on."""
        return self.mesh or M.single(self.dense3__bias.device)

    # -- parameters ------------------------------------------------------

    def parts(self, name: str, k: str) -> list:
        """The master copies of one weight: its column parts, or itself."""
        if (name, k) in self._split:
            n = self.mesh.shape[M.MODEL_AXIS]
            return [getattr(self, f"{name}__{k}__{j}") for j in range(n)]
        return [getattr(self, f"{name}__{k}")]

    def split_dim(self, name: str, k: str) -> Optional[int]:
        """The dimension a weight is split on over ``model``, or None."""
        return self._split.get((name, k))

    def _on(self, grid, name: str, k: str, i: int, j: int = 0):
        """Part ``j`` of a weight (the weight, if it is not split) on data
        row ``i``'s device ``j``."""
        parts = self.parts(name, k)
        j = j if len(parts) > 1 else 0
        return parts[j].to(grid.devices[i, j])

    def to_params(self) -> Params:
        """The head's weights and statistics as islx-layout numpy params
        (what :func:`save_npz` writes), the parts joined."""
        out: Params = {}
        for name, keys in self._keys.items():
            out[name] = {}
            for k in keys:
                if name.startswith("bn") and k in BN_KEYS:
                    v = getattr(self, f"{name}__{k}").detach().cpu()
                else:
                    parts = [p.detach().cpu() for p in self.parts(name, k)]
                    dim = self.split_dim(name, k)
                    v = parts[0] if dim is None else torch.cat(parts, dim)
                out[name][k] = v.numpy().copy()
        return out

    # -- forward ---------------------------------------------------------

    def _global(self, grid, rows):
        """The rows of every shard (and process) in batch order, on the
        first device."""
        x = M.batch_sharding(grid).gather(rows)
        return _AllGatherRows.apply(x) if self.world > 1 else x

    def _bn(self, grid, name: str, rows, train: bool, stats=None,
            eps: float = 1e-3):
        """keras BatchNormalization: running statistics, or in train mode
        the global batch's moments (recorded in ``stats``)."""
        if train:
            mean, var = _moments(self._global(grid, rows))
            if stats is not None:
                stats[name] = (mean, var)
        else:
            mean = getattr(self, f"{name}__mean")
            var = getattr(self, f"{name}__var")
        out = []
        for i, h in enumerate(rows):
            dev = h.device
            out.append((h - mean.to(dev)) * torch.rsqrt(var.to(dev) + eps)
                       * self._on(grid, name, "gamma", i)
                       + self._on(grid, name, "beta", i))
        return out

    def _dropout(self, rows, generator, train: bool):
        """:func:`_dropout` with one mask over the global batch's shape,
        each row taking its slice."""
        rate = self.cfg.dropout
        if not train or generator is None or rate == 0.0:
            return rows
        n = sum(r.shape[0] for r in rows)
        keep = _keep((n * self.world,) + tuple(rows[0].shape[1:]), rate,
                     generator)
        out, first = [], self.rank * n
        for r in rows:
            out.append(_dropout(r, rate, generator, train,
                                keep[first:first + r.shape[0]]))
            first += r.shape[0]
        return out

    def _dense(self, grid, name: str, rows):
        """``h @ kernel``, each model device its columns, gathered."""
        n = len(self.parts(name, "kernel"))
        out = []
        for i, h in enumerate(rows):
            cols = [(h.to(grid.devices[i, j])
                     @ self._on(grid, name, "kernel", i, j)).to(h.device)
                    for j in range(n)]
            out.append(cols[0] if n == 1 else torch.cat(cols, -1))
        return out

    def _lstm(self, grid, name: str, xs, mask, i: int, reverse: bool):
        """:func:`_lstm` on data row ``i``, the gate columns over the
        row's model devices."""
        n = len(self.parts(name, "kernel"))
        return _lstm([{k: self._on(grid, name, k, i, j)
                       for k in ("kernel", "recurrent", "bias")}
                      for j in range(n)], xs, mask, reverse)

    def _run(self, x: torch.Tensor, train: bool, generator, stats=None):
        grid = self._grid()
        sharding = M.batch_sharding(grid)
        rows = sharding.put(x.float())
        masks = [(r != 0.0).any(dim=-1) for r in rows]
        h = self._bn(grid, "bn0", rows, train, stats)
        seq = []
        for i, (r, m) in enumerate(zip(h, masks)):
            f, _ = self._lstm(grid, "lstm1_fwd", r, m, i, reverse=False)
            b, _ = self._lstm(grid, "lstm1_bwd", r, m, i, reverse=True)
            seq.append(torch.cat([f, b], dim=-1))
        seq = self._dropout(seq, generator, train)
        h = []
        for i, (r, m) in enumerate(zip(seq, masks)):
            _, f = self._lstm(grid, "lstm2_fwd", r, m, i, reverse=False)
            _, b = self._lstm(grid, "lstm2_bwd", r, m, i, reverse=True)
            h.append(F.elu(torch.cat([f, b], dim=-1)))
        h = self._bn(grid, "bn1", self._dense(grid, "dense1", h), train,
                     stats)
        h = [F.elu(t) for t in self._dropout(h, generator, train)]
        h = self._bn(grid, "bn2", self._dense(grid, "dense2", h), train,
                     stats)
        if stats is not None:
            return None
        h = self._dropout([F.elu(t) for t in h], generator, train)
        return sharding.gather([
            torch.softmax(t @ self._on(grid, "dense3", "kernel", i)
                          + self._on(grid, "dense3", "bias", i), dim=-1)
            for i, t in enumerate(h)])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Probabilities [B,167] of this process's rows (on the mesh's
        first device). ``train``: batch statistics in every BN and, with a
        ``generator``, dropout at ``cfg.dropout``."""
        return self._run(x, train, generator)

    def batch_stats(self, x: torch.Tensor
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Batch mean and population variance at every BN's input under
        the train-mode forward without dropout (islx's ``batch_stats``):
        what the training loop's EMA moves the running statistics to."""
        stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._run(x, True, None, stats)
        return stats


def from_islx_params(params: Mapping[str, Mapping[str, np.ndarray]],
                     device="cpu",
                     cfg: TranslatorConfig = TranslatorConfig()
                     ) -> TranslatorHead:
    """islx's head params (numpy, islx's layout) -> a trainable head on
    ``device``: weights as parameters, the BN statistics as buffers."""
    return TranslatorHead(params, cfg).to(device)


def build_head(params: Optional[Params], device,
               cfg: TranslatorConfig = TranslatorConfig()) -> TranslatorHead:
    """The head on ``device`` for inference, built of numpy params in
    islx's layout (seeded init when None)."""
    head = TranslatorHead(params if params is not None
                          else init_params(cfg), cfg)
    return head.to(device).eval().requires_grad_(False)
