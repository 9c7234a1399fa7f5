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
        names = [layer["config"]["name"]
                 for layer in config["config"]["layers"]]
        with h5py.File(weights, "r") as f:
            for name in names:
                group = f.get(f"layers/{name}")
                ws = _saved_vars(group) if group is not None else []
                if ws:
                    out.append(ws)
        return out
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name in root.attrs["layer_names"]:
            group = root[_str(name)]
            ws = [np.asarray(group[_str(w)])
                  for w in group.attrs["weight_names"]]
            if ws:
                out.append(ws)
    return out


def load_keras(path: str) -> Params:
    """A reference-trained ``.keras``/``.h5`` head checkpoint (reference
    demo_isl_translate.py:100), read with h5py
    (:func:`_keras_weight_lists`); where h5py is missing, as on a machine
    with only PyTorch, convert the head to ``.npz`` on one that has it."""
    return from_keras_weights(_keras_weight_lists(path))


def _lstm(p: Mapping[str, torch.Tensor], xs: torch.Tensor,
          mask: torch.Tensor, reverse: bool):
    """Masked LSTM over time. xs [B,T,F], mask [B,T] bool ->
    (outputs [B,T,U], last output [B,U])."""
    units = p["recurrent"].shape[0]
    b, t_len = xs.shape[0], xs.shape[1]
    zx = torch.matmul(xs, p["kernel"]) + p["bias"]        # [B,T,4U]
    h = xs.new_zeros((b, units))
    c = xs.new_zeros((b, units))
    out = xs.new_zeros((b, units))
    outs = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        z = zx[:, t] + h @ p["recurrent"]
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


def _bn(p: Mapping[str, torch.Tensor], x: torch.Tensor, train: bool = False,
        eps: float = 1e-3) -> torch.Tensor:
    """keras BatchNormalization: running statistics, or in train mode the
    batch's moments."""
    mean, var = _moments(x) if train else (p["mean"], p["var"])
    return (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator], train: bool
             ) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``; the identity outside train mode, at rate 0 or
    without a generator (islx's ``rng=None``)."""
    if not train or generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class TranslatorHead(nn.Module):
    """The BiLSTM head; ``forward(x [B,T,156]) -> probabilities [B,167]``.

    A timestep is masked where every feature is 0 (keras
    ``Masking(mask_value=0.)``, the zero-padded window tail). Every weight
    is a parameter (``{layer}__{name}``) but the BNs' ``mean``/``var``,
    which are buffers."""

    def __init__(self, params: Mapping[str, Mapping[str, np.ndarray]],
                 cfg: TranslatorConfig = TranslatorConfig()):
        super().__init__()
        self.cfg = cfg
        self._keys = {name: list(entry) for name, entry in params.items()}
        for name, entry in params.items():
            for k, v in entry.items():
                t = torch.from_numpy(np.array(v, np.float32))
                if name.startswith("bn") and k in BN_KEYS:
                    self.register_buffer(f"{name}__{k}", t)
                else:
                    self.register_parameter(f"{name}__{k}", nn.Parameter(t))

    def _p(self, name: str) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"{name}__{k}") for k in self._keys[name]}

    def _lstms(self, h: torch.Tensor, mask: torch.Tensor, generator,
               train: bool) -> torch.Tensor:
        """Both BiLSTMs (and the dropout between): -> [B, 2U]."""
        f, _ = _lstm(self._p("lstm1_fwd"), h, mask, reverse=False)
        b, _ = _lstm(self._p("lstm1_bwd"), h, mask, reverse=True)
        h = _dropout(torch.cat([f, b], dim=-1), self.cfg.dropout, generator,
                     train)
        _, f = _lstm(self._p("lstm2_fwd"), h, mask, reverse=False)
        _, b = _lstm(self._p("lstm2_bwd"), h, mask, reverse=True)
        return torch.cat([f, b], dim=-1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Probabilities [B,167]. ``train``: batch statistics in every BN
        and, with a ``generator``, dropout at ``cfg.dropout``."""
        x = x.float()
        mask = (x != 0.0).any(dim=-1)
        rate = self.cfg.dropout
        h = _bn(self._p("bn0"), x, train)
        h = F.elu(self._lstms(h, mask, generator, train))
        h = _bn(self._p("bn1"), h @ self._p("dense1")["kernel"], train)
        h = F.elu(_dropout(h, rate, generator, train))
        h = _bn(self._p("bn2"), h @ self._p("dense2")["kernel"], train)
        h = _dropout(F.elu(h), rate, generator, train)
        d3 = self._p("dense3")
        return torch.softmax(h @ d3["kernel"] + d3["bias"], dim=-1)

    def batch_stats(self, x: torch.Tensor
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Batch mean and population variance at every BN's input under
        the train-mode forward without dropout (islx's ``batch_stats``):
        what the training loop's EMA moves the running statistics to."""
        x = x.float()
        mask = (x != 0.0).any(dim=-1)
        out = {"bn0": _moments(x)}
        h = _bn(self._p("bn0"), x, train=True)
        h = F.elu(self._lstms(h, mask, None, False))
        h = h @ self._p("dense1")["kernel"]
        out["bn1"] = _moments(h)
        h = F.elu(_bn(self._p("bn1"), h, train=True))
        out["bn2"] = _moments(h @ self._p("dense2")["kernel"])
        return out

    def to_params(self) -> Params:
        """The head's weights and statistics as islx-layout numpy params
        (what :func:`save_npz` writes)."""
        return {name: {k: v.detach().cpu().numpy().copy()
                       for k, v in self._p(name).items()}
                for name in self._keys}


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
