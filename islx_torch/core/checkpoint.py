"""Checkpoints: training state and whole-translator bundles (port of
``islx/core/checkpoint.py``).

* :func:`save_pytree` / :func:`load_pytree` / :func:`exists`: a training
  state (state dicts of parameters, buffers and the optimizer, the step, a
  generator's state) as one ``torch.save`` file, ``<path>.pt``, read back
  with ``torch.load(weights_only=True)``: tensors and plain containers
  only, no pickled code.
* :func:`save_bundle` / :func:`load_bundle`: the translator in one
  directory, ``bundle.json`` (``model_type``, ``format``) beside
  ``body.npz`` and ``hand.npz`` (islx's flat weight files, which
  :func:`islx_torch.core.weights.load_npz` and islx's ``weights.load``
  read) and ``head.npz`` (:func:`islx_torch.models.translator.save_npz`).
* Training resume: :func:`islx_torch.isl.train.fit` with a
  ``checkpoint_dir`` saves every epoch and resumes from the latest.

islx's states and bundles are orbax directories or pickled JAX treedefs,
which cannot be read without JAX; the port's bundles have their own
``format``, which islx's ``load_bundle`` does not read either. A bundle's
weight files, and a head ``.npz``, load on both sides.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from islx_torch.core import weights as W
from islx_torch.models import translator as T

BUNDLE_FORMAT = "islx_torch-npz"
_BUNDLE_META = "bundle.json"


def save_pytree(path: str, tree: Dict[str, Any]) -> None:
    """Persist a training state (nested dicts and lists of tensors and
    numbers) to ``<path>.pt``, atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".pt.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path + ".pt")


def load_pytree(path: str, like: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """A state saved by :func:`save_pytree`, on the CPU. With ``like``
    (an example state) its top-level keys must match."""
    tree = torch.load(os.path.abspath(path) + ".pt", map_location="cpu",
                      weights_only=True)
    if like is not None and set(tree) != set(like):
        raise ValueError(f"{path}: keys {sorted(tree)} do not match "
                         f"{sorted(like)}")
    return tree


def exists(path: str) -> bool:
    return os.path.exists(os.path.abspath(path) + ".pt")


def save_bundle(out_dir: str, body_params: W.State, hand_params: W.State,
                head_params: T.Params, model_type: str = "body25") -> None:
    """One-directory translator bundle (cf. the reference's
    isl-translate-v1.keras): float weight states and the head's params."""
    os.makedirs(out_dir, exist_ok=True)
    W.save_npz(os.path.join(out_dir, "body.npz"), body_params)
    W.save_npz(os.path.join(out_dir, "hand.npz"), hand_params)
    T.save_npz(os.path.join(out_dir, "head.npz"), head_params)
    with open(os.path.join(out_dir, _BUNDLE_META), "w") as f:
        json.dump({"model_type": model_type, "format": BUNDLE_FORMAT}, f)


def load_bundle(out_dir: str):
    """-> (body state, hand state, head params, model_type)."""
    with open(os.path.join(out_dir, _BUNDLE_META)) as f:
        meta = json.load(f)
    if meta.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            f"{out_dir}: bundle format {meta.get('format')!r} is not the "
            f"port's {BUNDLE_FORMAT!r} (islx's orbax or pickled bundles "
            f"need JAX to read; export their weights as .npz)")
    model_type = meta["model_type"]
    body = W.load_npz(os.path.join(out_dir, "body.npz"), model_type)
    hand = W.load_npz(os.path.join(out_dir, "hand.npz"), "hand")
    head = T.load_npz(os.path.join(out_dir, "head.npz"))
    return body, hand, head, model_type
