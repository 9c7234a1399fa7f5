"""Training for the ISL translator head (port of ``islx/isl/train.py``).

Loss: categorical cross-entropy on the softmax output (the keras head's
compile-time loss), ``-log(max(p, 1e-12))`` of the label's probability.
Adam with optax's defaults. A step runs in islx's order: the gradient, the
Adam update of the weights (the BatchNorms' running statistics are buffers,
outside the optimizer), then the EMA (momentum 0.99) of every BN's
statistics toward :meth:`TranslatorHead.batch_stats` of the batch under the
UPDATED weights.

:func:`fit` shuffles as islx's does: one ``np.random.RandomState(seed)``
shuffles the same index array every epoch, and the last partial batch is
dropped. Dropout draws from a ``torch.Generator`` seeded with ``seed + 1``.
With a ``checkpoint_dir`` it saves the state every epoch (``latest.pt``,
and ``meta.json`` holding ``{"epoch": k}``) and resumes from it. A resumed
run equals an uninterrupted one bit for bit: it replays the skipped
epochs' shuffles and restores the dropout generator. islx's resume starts
its shuffles and its dropout key over from the seed (ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from islx_torch.core import checkpoint as ckpt
from islx_torch.core.config import TranslatorConfig
from islx_torch.core.runtime import resolve_device
from islx_torch.models import translator as T


@dataclasses.dataclass
class TrainState:
    head: T.TranslatorHead
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, lr: float = 1e-3) -> torch.optim.Adam:
    """optax.adam(lr)'s defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(head: T.TranslatorHead, x: torch.Tensor, y: torch.Tensor,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,20,156], y [B] int labels -> (mean CE loss, metrics), the
    train-mode forward (dropout only with a generator)."""
    probs = head(x, train=True, generator=generator)
    logp = torch.log(torch.clamp_min(probs, 1e-12))
    ce = -logp.gather(1, y.long()[:, None])[:, 0]
    acc = (probs.argmax(-1) == y).float()
    loss = ce.mean()
    return loss, {"loss": loss.detach(), "accuracy": acc.mean()}


@torch.no_grad()
def _update_bn_stats(head: T.TranslatorHead, x: torch.Tensor,
                     momentum: float = 0.99) -> None:
    """EMA of EVERY BatchNorm's running mean/var toward the batch's
    train-mode statistics, so inference normalizes as training saw."""
    for name, (mean, var) in head.batch_stats(x).items():
        for key, batch in (("mean", mean), ("var", var)):
            run = getattr(head, f"{name}__{key}")
            run.copy_(momentum * run + (1 - momentum) * batch)


def make_train_step(state: TrainState):
    """-> step(x, y, generator=None) -> metrics, updating ``state``."""

    def step(x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.head, x, y, generator)
        loss.backward()
        state.optimizer.step()
        _update_bn_stats(state.head, x)
        state.step += 1
        return metrics

    return step


def init_state(cfg: TranslatorConfig = TranslatorConfig(), lr: float = 1e-3,
               params: Optional[T.Params] = None, seed: int = 0,
               device=None) -> TrainState:
    """A trainable head on ``device`` (the port's seeded init, or islx's
    params carried across) with its Adam, at step 0."""
    head = T.from_islx_params(
        params if params is not None else T.init_params(cfg, seed),
        resolve_device(device), cfg)
    return TrainState(head, make_optimizer(head.parameters(), lr))


def fit(x: np.ndarray, y: np.ndarray, epochs: int = 10, batch_size: int = 32,
        lr: float = 1e-3, cfg: TranslatorConfig = TranslatorConfig(),
        seed: int = 0, verbose: bool = True,
        checkpoint_dir: Optional[str] = None,
        params: Optional[T.Params] = None, device=None) -> T.Params:
    """Train the head on (windows, labels) -> its params (islx's layout).

    ``params``: the starting head (islx's, to train from the same start);
    the port's init of ``seed`` when None."""
    dev = resolve_device(device)
    state = init_state(cfg, lr, params, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    start_epoch = 0
    latest = meta_p = None
    if checkpoint_dir:
        latest = os.path.join(checkpoint_dir, "latest")
        meta_p = os.path.join(checkpoint_dir, "meta.json")
        if ckpt.exists(latest) and os.path.exists(meta_p):
            with open(meta_p) as f:
                start_epoch = json.load(f)["epoch"] + 1
            tree = ckpt.load_pytree(latest, like=_state_tree(state, gen))
            state.head.load_state_dict(tree["head"])
            state.optimizer.load_state_dict(tree["optimizer"])
            state.step = int(tree["step"])
            gen.set_state(tree["generator"])
    step = make_train_step(state)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    yt = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    n = x.shape[0]
    order = np.arange(n)
    rs = np.random.RandomState(seed)
    for _ in range(start_epoch):        # the skipped epochs' shuffles
        rs.shuffle(order)
    for epoch in range(start_epoch, epochs):
        rs.shuffle(order)
        sums = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size].copy()).to(dev)
            m = step(xt[idx], yt[idx], gen)
            sums.append(torch.stack([m["loss"], m["accuracy"]]))
        if verbose and sums:
            loss, acc = (torch.stack(sums).mean(0)).tolist()
            print(f"epoch {epoch}: loss {loss:.4f} acc {acc:.4f}")
        if checkpoint_dir:
            ckpt.save_pytree(latest, _state_tree(state, gen))
            with open(meta_p, "w") as f:
                json.dump({"epoch": epoch}, f)
    return state.head.to_params()


def _state_tree(state: TrainState, gen: torch.Generator) -> Dict:
    return {"head": state.head.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "generator": gen.get_state()}
