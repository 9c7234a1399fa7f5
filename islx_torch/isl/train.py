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

On a (data, model) mesh (``fit(..., mesh=)``, :func:`shard_state`) the
head is a :class:`~islx_torch.models.translator.TranslatorHead` on it:
windows over ``data``, the gate and dense kernels over ``model``, BN
statistics and dropout over the global batch, so a step equals the
unsharded one. Across processes (a ``torch.distributed`` group of more
than one) each process steps on its rows of every batch and the gradients
are summed over the processes. Checkpoints keep the unsharded layout, so
a run resumes on any mesh; the loaded Adam moments are split as the
weights are.
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
    y = y.to(probs.device)
    logp = torch.log(torch.clamp_min(probs, 1e-12))
    ce = -logp.gather(1, y.long()[:, None])[:, 0]
    acc = (probs.argmax(-1) == y).float()
    world = head.world
    if world == 1:
        loss = ce.mean()
        return loss, {"loss": loss.detach(), "accuracy": acc.mean()}
    # this process's share of the global mean; the sums over processes
    # are the global loss and gradients
    import torch.distributed as dist

    n = ce.shape[0] * world
    loss = ce.sum() / n
    metrics = torch.stack([loss.detach(), acc.sum() / n])
    dist.all_reduce(metrics)
    return loss, {"loss": metrics[0], "accuracy": metrics[1]}


@torch.no_grad()
def _update_bn_stats(head: T.TranslatorHead, x: torch.Tensor,
                     momentum: float = 0.99) -> None:
    """EMA of EVERY BatchNorm's running mean/var toward the batch's
    train-mode statistics, so inference normalizes as training saw."""
    for name, (mean, var) in head.batch_stats(x).items():
        for key, batch in (("mean", mean), ("var", var)):
            run = getattr(head, f"{name}__{key}")
            run.copy_(momentum * run + (1 - momentum) * batch)


def make_train_step(state: TrainState, mesh=None):
    """-> step(x, y, generator=None) -> metrics, updating ``state``. With
    a ``mesh`` an unsharded state is sharded on it first
    (:func:`shard_state`); x and y are this process's rows."""
    if mesh is not None and state.head.mesh is not mesh:
        sharded = shard_state(state, mesh)
        state.head, state.optimizer = sharded.head, sharded.optimizer
    world = state.head.world

    def step(x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.head, x, y, generator)
        loss.backward()
        if world > 1:
            import torch.distributed as dist

            for p in state.head.parameters():
                dist.all_reduce(p.grad)
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


def shard_state(state: TrainState, mesh=None, device=None) -> TrainState:
    """The state's head and Adam on ``mesh`` (None: whole, on ``device``,
    by default the head's first device; what a checkpoint holds): the
    weights and the Adam moments joined from their parts and split again
    as the TP rules split the weights on the new mesh
    (islx/isl/train.py:141-165)."""
    src = state.head
    head = T.TranslatorHead(src.to_params(), src.cfg, mesh)
    if mesh is None:
        head = head.to(device or src.dense3__bias.device)
    opt = make_optimizer(head.parameters(),
                         state.optimizer.param_groups[0]["lr"])
    for name, keys in src._keys.items():
        for k in keys:
            if name.startswith("bn") and k in T.BN_KEYS:
                continue
            moments = [state.optimizer.state.get(p, {})
                       for p in src.parts(name, k)]
            if not moments[0]:
                continue
            whole = {}
            for key in ("exp_avg", "exp_avg_sq"):
                vs = [m[key].to(moments[0][key].device) for m in moments]
                whole[key] = (vs[0] if len(vs) == 1
                              else torch.cat(vs, src.split_dim(name, k)))
            parts, dim = head.parts(name, k), head.split_dim(name, k)
            for j, part in enumerate(parts):
                st = {"step": moments[0]["step"].clone()}
                for key, v in whole.items():
                    if dim is not None:
                        v = v.chunk(len(parts), dim)[j]
                    st[key] = v.to(part.device, copy=True)
                opt.state[part] = st
    return TrainState(head, opt, state.step)


def fit(x: np.ndarray, y: np.ndarray, epochs: int = 10, batch_size: int = 32,
        lr: float = 1e-3, cfg: TranslatorConfig = TranslatorConfig(),
        seed: int = 0, verbose: bool = True,
        checkpoint_dir: Optional[str] = None,
        params: Optional[T.Params] = None, device=None,
        mesh=None) -> T.Params:
    """Train the head on (windows, labels) -> its params (islx's layout).

    ``params``: the starting head (islx's, to train from the same start);
    the port's init of ``seed`` when None. ``mesh``: data- and
    tensor-parallel over it (the module doc); across processes each takes
    its rows of every batch, and only rank 0 writes checkpoints."""
    from islx_torch.parallel.mesh import process_rank

    dev = mesh.first if mesh is not None else resolve_device(device)
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
    if mesh is not None:
        state = shard_state(state, mesh)
    step = make_train_step(state)
    rank, world = ((0, 1) if mesh is None else process_rank())
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
            rows = order[i:i + batch_size]
            share = batch_size // world           # this process's rows
            rows = rows[rank * share:(rank + 1) * share]
            idx = torch.from_numpy(rows.copy()).to(dev)
            m = step(xt[idx], yt[idx], gen)
            sums.append(torch.stack([m["loss"], m["accuracy"]]))
        if verbose and sums:
            loss, acc = (torch.stack(sums).mean(0)).tolist()
            print(f"epoch {epoch}: loss {loss:.4f} acc {acc:.4f}")
        if checkpoint_dir and rank == 0:
            ckpt.save_pytree(latest, _state_tree(shard_state(state), gen))
            with open(meta_p, "w") as f:
                json.dump({"epoch": epoch}, f)
    return state.head.to_params()


def _state_tree(state: TrainState, gen: torch.Generator) -> Dict:
    return {"head": state.head.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "generator": gen.get_state()}
