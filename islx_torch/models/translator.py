"""ISL translation head: masked BiLSTM classifier over 167 expressions
(port of ``islx/models/translator.py``, inference).

    Input[20,156] -> Masking(0.) -> BatchNorm -> BiLSTM(32, seq)
    -> BiLSTM(32) -> ELU -> Dense32(no bias) -> BN -> ELU
    -> Dense32(no bias) -> BN -> ELU -> Dense(167, softmax)

The LSTMs are hand loops over the T=20 steps with keras masking: a masked
step passes h, c and the output through unchanged, which ``nn.LSTM`` cannot
express. Parameters keep the keras layout (kernel [F,4U], recurrent
[U,4U], bias [4U], gate order i, f, g, o) so islx's numpy params carry
across as they are.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

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


def load_npz(path: str) -> Params:
    """islx head checkpoint (``islx.models.translator.save_npz``)."""
    params: Params = {}
    with np.load(path) as data:
        for key in data.files:
            name, k = key.split("/")
            params.setdefault(name, {})[k] = np.asarray(data[key])
    return params


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


def _bn(p: Mapping[str, torch.Tensor], x: torch.Tensor,
        eps: float = 1e-3) -> torch.Tensor:
    """keras BatchNormalization, inference (running statistics)."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["gamma"] \
        + p["beta"]


class TranslatorHead(nn.Module):
    """The BiLSTM head; ``forward(x [B,T,156]) -> probabilities [B,167]``.

    A timestep is masked where every feature is 0 (keras
    ``Masking(mask_value=0.)``, the zero-padded window tail)."""

    def __init__(self, params: Params):
        super().__init__()
        for name, entry in params.items():
            for k, v in entry.items():
                self.register_buffer(
                    f"{name}__{k}",
                    torch.from_numpy(np.array(v, np.float32)))

    def _p(self, name: str) -> Dict[str, torch.Tensor]:
        pre = f"{name}__"
        return {k[len(pre):]: v for k, v in self.named_buffers()
                if k.startswith(pre)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mask = (x != 0.0).any(dim=-1)
        h = _bn(self._p("bn0"), x)
        f, _ = _lstm(self._p("lstm1_fwd"), h, mask, reverse=False)
        b, _ = _lstm(self._p("lstm1_bwd"), h, mask, reverse=True)
        h = torch.cat([f, b], dim=-1)
        _, f = _lstm(self._p("lstm2_fwd"), h, mask, reverse=False)
        _, b = _lstm(self._p("lstm2_bwd"), h, mask, reverse=True)
        h = F.elu(torch.cat([f, b], dim=-1))
        h = F.elu(_bn(self._p("bn1"), h @ self._p("dense1")["kernel"]))
        h = F.elu(_bn(self._p("bn2"), h @ self._p("dense2")["kernel"]))
        d3 = self._p("dense3")
        return torch.softmax(h @ d3["kernel"] + d3["bias"], dim=-1)


def build_head(params: Optional[Params], device,
               cfg: TranslatorConfig = TranslatorConfig()) -> TranslatorHead:
    """The head on ``device`` built of numpy params in islx's layout
    (seeded init when None)."""
    return TranslatorHead(params if params is not None
                          else init_params(cfg)).to(device).eval()
