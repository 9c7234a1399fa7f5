"""Whole-translator single-artifact export and import (``.keras``), without
keras (port of ``islx/models/one_model.py``).

The reference can run end to end from one saved keras file,
``model/isl-translate-v1.keras`` (demo_isl_translate_one_model.py:121).
islx's portable equivalent is one ``.keras`` artifact holding the body
CPM, the hand CPM and the translation head as nested sub-models
(``islx_body25`` or ``islx_coco``, ``islx_hand``, ``islx_head``) of a
multi-input functional model (image -> body outputs, crop -> hand
heatmap, feature window -> expression softmax); the pose post-processing
between those tensors is not part of it.

The port writes that archive itself (:mod:`islx_torch.models.keras_export`
for the CPMs, :func:`islx_torch.models.translator.keras_head_entry` and
``save_keras_head`` for the head) and reads it with h5py: its artifacts
load in stock keras and in islx's ``import_one_model``, and islx's
(``.keras``, or the legacy ``.h5``) load here.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Optional, Tuple

import numpy as np

from islx_torch.core.config import TranslatorConfig
from islx_torch.models import keras_export as KE
from islx_torch.models import translator as T

BODY_NAME = "islx_body25"
COCO_NAME = "islx_coco"
HAND_NAME = "islx_hand"
HEAD_NAME = "islx_head"
MODEL_NAME = "islx_translate_one_model"


def _submodel(g: KE.Graph, x: KE.Tensor, sub: KE.Graph, sub_in, sub_outs
              ) -> list:
    """Call a functional sub-model on ``x`` (its node 1: node 0 is its
    own construction)."""
    layer = KE.Layer("Functional", sub.name, None, [x],
                     entry=KE.functional_entry(
                         sub.model_config([sub_in], sub_outs, True)),
                     kwargs={"mask": None},
                     save=lambda grp: sub.save_weights(
                         grp, sub.ordered(sub_outs)))
    return g.add(layer, [t.shape for t in sub_outs], node=1)


def export_one_model(body_state, hand_state, head_params: T.Params,
                     path: str, model_type: str = "body25",
                     cfg: Optional[TranslatorConfig] = None) -> None:
    """Save body + hand + head as one ``.keras`` artifact."""
    if not path.endswith(".keras"):
        raise ValueError(f"{path}: the port writes .keras archives only")
    cfg = cfg or TranslatorConfig()
    g = KE.Graph(MODEL_NAME)
    img = g.input("image", [None, None, None, 3])
    crop = g.input("hand_crop", [None, None, None, 3])
    window = g.input("feature_window",
                     [None, cfg.window_size, cfg.feature_dim])
    body = KE.cpm_graph(model_type, body_state,
                        BODY_NAME if model_type == "body25" else COCO_NAME)
    hand = KE.cpm_graph("hand", hand_state, HAND_NAME)
    outs = _submodel(g, img, *body) + _submodel(g, crop, *hand)
    head = KE.Layer("Sequential", HEAD_NAME, None, [window],
                    entry=T.keras_head_entry(cfg, HEAD_NAME),
                    kwargs={"mask": None},
                    save=lambda grp: T.save_keras_head(grp, head_params,
                                                       HEAD_NAME))
    outs += g.add(head, [[None, cfg.n_classes]])
    inputs = [img, crop, window]
    config = KE.functional_entry(g.model_config(inputs, outs, False))
    KE.write_keras(path, config,
                   lambda f: g.save_weights(f, g.ordered(outs)))


def _foreign(names) -> ValueError:
    return ValueError(f"not an islx one-model artifact: layers "
                      f"{sorted(names)} (expected one of {BODY_NAME}/"
                      f"{COCO_NAME}, {HAND_NAME}, {HEAD_NAME})")


def model_type_of(path: str) -> str:
    """"body25" or "coco": the pose sub-model a one-model artifact holds."""
    import h5py

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            config = json.loads(z.read("config.json"))
        names = {la.get("name")
                 for la in config["config"].get("layers", [])}
    else:
        with h5py.File(path, "r") as f:
            names = set(f["model_weights"] if "model_weights" in f else f)
    return "coco" if COCO_NAME in names else "body25"


def import_one_model(path: str, model_type: str = "body25"
                     ) -> Tuple[dict, dict, T.Params]:
    """A one-model artifact (the port's or islx's, ``.keras`` or legacy
    ``.h5``) -> (body state, hand state, head params), read with h5py."""
    import h5py

    pose_name = BODY_NAME if model_type == "body25" else COCO_NAME
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            config = json.loads(z.read("config.json"))
            data = io.BytesIO(z.read("model.weights.h5"))
        entries = {la.get("name"): la
                   for la in config["config"].get("layers", [])}
        with h5py.File(data, "r") as f:
            groups = [KE.find_model(f, n)
                      for n in (pose_name, HAND_NAME, HEAD_NAME)]
            if any(g is None for g in groups) or HEAD_NAME not in entries:
                raise _foreign(n for n in entries if n)
            body = KE.state_from_vars(KE.layer_vars(groups[0]), model_type)
            hand = KE.state_from_vars(KE.layer_vars(groups[1]), "hand")
            head = T.from_keras_weights(T.keras_weight_lists(
                groups[2], entries[HEAD_NAME]))
        return body, hand, head
    with h5py.File(path, "r") as f:
        subs = KE.legacy_weights(f)
    if not {pose_name, HAND_NAME, HEAD_NAME} <= set(subs):
        raise _foreign(subs)
    by_layer: dict = {}
    for wname, arr in subs[HEAD_NAME].items():
        by_layer.setdefault(wname.split("/")[1], []).append(np.asarray(arr))
    return (KE.legacy_state(subs[pose_name], model_type),
            KE.legacy_state(subs[HAND_NAME], "hand"),
            T.from_keras_weights(list(by_layer.values())))
