"""Pose nets <-> Keras ``.keras`` files, without keras (port of
``islx/models/keras_export.py``).

islx builds a functional keras model from the CPM spec tables
(channels-last, every Conv2D named by its caffe blob name, ReLU, PReLU
with ``shared_axes=[1, 2]``, MaxPooling2D and Concatenate) and saves it
with keras. keras 3 imports JAX, which the port never imports, so the port
writes the same ``.keras`` archive itself:

* ``metadata.json``, and ``config.json``: the functional model's config,
  its layers in the order keras lists them (``keras.src.ops.function.
  map_graph``: by depth from the inputs, ties in the order a depth-first
  walk from the outputs meets them), which is the order keras reloads
  them in;
* ``model.weights.h5`` (h5py): under ``layers/<class in snake case>[_n]``
  in that order, each layer's ``vars/0..`` (a Conv2D's kernel HWIO and
  bias, a PReLU's alpha [1,1,C]) and a ``vars`` group named after it.

A file written here loads in stock keras (``keras.models.load_model``)
and in islx's ``params_from_keras``; :func:`params_from_keras` reads the
port's files and islx's (``.keras``, and the legacy ``.h5``) with h5py.
Graphs built here nest, which :mod:`islx_torch.models.one_model` uses.

    python -m islx_torch.cli.convert SRC DST.keras --model-type body25 \\
        --to-keras
"""
from __future__ import annotations

import io
import json
import re
import time
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from islx_torch.models import cpm

KERAS_VERSION = "3.13.1"    # the config format written here
DTYPE = {"module": "keras", "class_name": "DTypePolicy",
         "config": {"name": "float32"}, "registered_name": None}


def initializer(name: str, config: Optional[dict] = None) -> dict:
    return {"module": "keras.initializers", "class_name": name,
            "config": config or {}, "registered_name": None}


def snake(class_name: str) -> str:
    """keras's ``naming.to_snake_case``: Conv2D -> conv2d, PReLU ->
    p_re_lu, MaxPooling2D -> max_pooling2d."""
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", class_name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", s).lower()


# ---------------------------------------------------------------------------
# A keras functional graph, written as keras writes it
# ---------------------------------------------------------------------------

class Tensor:
    """A symbolic output: ``keras_history`` (layer, node, index), shape."""

    def __init__(self, layer: "Layer", node: int, index: int, shape):
        self.layer, self.node, self.index = layer, node, index
        self.shape = list(shape)

    def config(self) -> dict:
        return {"class_name": "__keras_tensor__",
                "config": {"shape": self.shape, "dtype": "float32",
                           "keras_history": [self.layer.name, self.node,
                                             self.index]}}


class Layer:
    """One layer of a graph, called once. ``weights``: its variables in
    keras's order; ``save``: writes a nested model's weights instead."""

    def __init__(self, class_name: str, name: str, config: dict,
                 inputs: List[Tensor], build_config: Optional[dict] = None,
                 weights: Sequence[np.ndarray] = (), kwargs=None,
                 list_args: bool = False, entry: Optional[dict] = None,
                 save=None):
        self.class_name, self.name = class_name, name
        self.config, self.inputs = config, inputs
        self.build_config, self.weights = build_config, list(weights)
        self.kwargs = {} if kwargs is None else kwargs
        self.list_args, self.entry, self.save = list_args, entry, save

    def layer_config(self) -> dict:
        if self.entry is not None:
            out = dict(self.entry)
        else:
            out = {"module": "keras.layers", "class_name": self.class_name,
                   "config": self.config, "registered_name": None}
            if self.build_config is not None:
                out["build_config"] = self.build_config
        out["name"] = self.name
        if self.class_name == "InputLayer":
            out["inbound_nodes"] = []
        else:
            args = [t.config() for t in self.inputs]
            out["inbound_nodes"] = [{"args": [args] if self.list_args
                                     else args, "kwargs": self.kwargs}]
        return out


class Graph:
    """A functional model under construction."""

    def __init__(self, name: str):
        self.name = name
        self.names: Dict[str, int] = {}

    def auto_name(self, base: str) -> str:
        n = self.names.get(base, 0)
        self.names[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def add(self, layer: Layer, shapes, node: int = 0) -> List[Tensor]:
        """``layer``'s outputs, of ``shapes``, made by its node ``node``
        (a graph's layers are those its outputs reach: :meth:`ordered`)."""
        return [Tensor(layer, node, i, s) for i, s in enumerate(shapes)]

    def input(self, name: str, shape) -> Tensor:
        cfg = {"batch_shape": list(shape), "dtype": "float32",
               "sparse": False, "ragged": False, "name": name,
               "optional": False}
        return self.add(Layer("InputLayer", name, cfg, []), [shape])[0]

    def ordered(self, outputs: List[Tensor]) -> List[Layer]:
        """The layers as keras's ``map_graph`` orders them."""
        order: Dict[int, int] = {}
        finished: set = set()
        nodes: List[Layer] = []

        def walk(t: Tensor):
            layer = t.layer
            if id(layer) in finished:
                return
            order.setdefault(id(layer), len(order))
            for x in layer.inputs:
                walk(x)
            finished.add(id(layer))
            nodes.append(layer)

        for t in outputs:
            walk(t)
        depth: Dict[int, int] = {}
        for layer in reversed(nodes):
            d = depth.setdefault(id(layer), 0)
            for x in layer.inputs:
                depth[id(x.layer)] = max(d + 1, depth.get(id(x.layer), 0))
        return sorted(nodes, key=lambda la: (-depth[id(la)], order[id(la)]))

    def model_config(self, inputs: List[Tensor], outputs: List[Tensor],
                     single_input: bool) -> dict:
        layers = self.ordered(outputs)
        ins = [[t.layer.name, t.node, t.index] for t in inputs]
        return {"name": self.name, "trainable": True,
                "layers": [la.layer_config() for la in layers],
                "input_layers": ins[0] if single_input else ins,
                "output_layers": [[t.layer.name, t.node, t.index]
                                  for t in outputs]}

    def save_weights(self, group, layers: List[Layer]) -> None:
        """keras's ``_save_container_state`` for ``layers`` under
        ``group``, then the model's own (empty) ``vars``."""
        seen: Dict[str, int] = {}
        lg = group.create_group("layers")
        for la in layers:
            base = snake(la.class_name)
            n = seen.get(base, -1) + 1
            seen[base] = n
            g = lg.create_group(base if n == 0 else f"{base}_{n}")
            if la.save is not None:
                la.save(g)
                continue
            v = g.create_group("vars")
            v.attrs["name"] = la.name
            for i, w in enumerate(la.weights):
                v.create_dataset(str(i), data=np.asarray(w, np.float32))
        group.create_group("vars").attrs["name"] = self.name


def write_keras(path: str, config: dict, save_weights) -> None:
    """A ``.keras`` zip: metadata, config and ``model.weights.h5`` (h5py,
    imported here), stored uncompressed as keras stores them."""
    import h5py

    buf = io.BytesIO()
    with h5py.File(buf, "w") as f:
        save_weights(f)
    meta = {"keras_version": KERAS_VERSION,
            "date_saved": time.strftime("%Y-%m-%d@%H:%M:%S")}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("metadata.json", json.dumps(meta))
        z.writestr("config.json", json.dumps(config))
        z.writestr("model.weights.h5", buf.getvalue())


# ---------------------------------------------------------------------------
# The CPM graphs (islx/models/keras_export.py:65-112)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def _shape(c: int):
    return [None, None, None, c]


class _CPMLayers:
    def __init__(self, g: Graph, state):
        self.g, self.state = g, state

    def conv(self, x: Tensor, c: cpm.Conv) -> Tensor:
        e = self.state[c.name] if self.state is not None else None
        cfg = {"name": c.name, "trainable": True, "dtype": DTYPE,
               "filters": c.cout, "kernel_size": [c.k, c.k],
               "strides": [1, 1], "padding": "same" if c.pad else "valid",
               "data_format": "channels_last", "dilation_rate": [1, 1],
               "groups": 1, "activation": "linear", "use_bias": True,
               "kernel_initializer": initializer("GlorotUniform",
                                                 {"seed": None}),
               "bias_initializer": initializer("Zeros"),
               "kernel_regularizer": None, "bias_regularizer": None,
               "activity_regularizer": None, "kernel_constraint": None,
               "bias_constraint": None}
        w = () if e is None else (_np(e["w"]).transpose(2, 3, 1, 0),
                                  _np(e["b"]))
        x = self.g.add(Layer("Conv2D", c.name, cfg, [x],
                             build_config={"input_shape": x.shape},
                             weights=w), [_shape(c.cout)])[0]
        if c.act == "relu":
            cfg = {"name": f"relu_{c.name}", "trainable": True,
                   "dtype": DTYPE, "max_value": None, "negative_slope": 0.0,
                   "threshold": 0.0}
            x = self.g.add(Layer("ReLU", cfg["name"], cfg, [x]),
                           [x.shape])[0]
        elif c.act == "prelu":
            cfg = {"name": f"prelu_{c.name}", "trainable": True,
                   "dtype": DTYPE,
                   "alpha_initializer": initializer("Zeros"),
                   "alpha_regularizer": None, "alpha_constraint": None,
                   "shared_axes": [1, 2]}
            w = () if e is None else (_np(e["p"]).reshape(1, 1, -1),)
            x = self.g.add(Layer("PReLU", cfg["name"], cfg, [x],
                                 build_config={"input_shape": x.shape},
                                 weights=w), [x.shape])[0]
        return x

    def pool(self, x: Tensor, p: cpm.Pool) -> Tensor:
        name = self.g.auto_name("max_pooling2d")
        cfg = {"name": name, "trainable": True, "dtype": DTYPE,
               "pool_size": [p.k, p.k], "padding": "valid",
               "strides": [p.s, p.s], "data_format": "channels_last"}
        return self.g.add(Layer("MaxPooling2D", name, cfg, [x]),
                          [x.shape])[0]

    def concat(self, xs: List[Tensor]) -> Tensor:
        name = self.g.auto_name("concatenate")
        cfg = {"name": name, "trainable": True, "dtype": DTYPE, "axis": -1}
        return self.g.add(Layer("Concatenate", name, cfg, list(xs),
                                build_config={"input_shape":
                                              [x.shape for x in xs]},
                                list_args=True),
                          [_shape(sum(x.shape[-1] for x in xs))])[0]

    def seq(self, x: Tensor, layers) -> Tensor:
        for layer in layers:
            x = (self.pool(x, layer) if isinstance(layer, cpm.Pool)
                 else self.conv(x, layer))
        return x

    def dense_block(self, x: Tensor, convs) -> Tensor:
        outs = []
        for c in convs:
            x = self.conv(x, c)
            outs.append(x)
        return self.concat(outs)


def cpm_graph(model_type: str, state=None, name: Optional[str] = None):
    """The CPM as a keras functional graph -> (graph, input, outputs), the
    same graph islx's ``build_keras_model`` builds. ``state``: the port's
    weights (``{name: {"w" OIHW, "b"[, "p"]}}``), or None for the config
    alone."""
    g = Graph(name or f"islx_{model_type}")
    b = _CPMLayers(g, state)
    inp = g.input("image", _shape(3))
    if model_type == "body25":
        spec = cpm.body25_spec()
        st = spec["stages"]

        def run_stage(t, s, L):
            t = b.dense_block(t, st[f"Mconv1_stage{s}_{L}"])
            for i in range(2, 6):
                t = b.dense_block(t, st[f"Mconv{i}_stage{s}_{L}"])
            for c in st[f"Mconv6_7_stage{s}_{L}"]:
                t = b.conv(t, c)
            return t

        out0 = b.seq(inp, spec["trunk"])
        t, paf = out0, None
        for s in range(4):
            paf = run_stage(t, s, "L2")
            t = b.concat([out0, paf])
        heat0 = run_stage(t, 0, "L1")
        t = b.concat([out0, heat0, paf])
        outputs = [paf, run_stage(t, 1, "L1")]
    elif model_type == "coco":
        heads = cpm.coco_spec()["heads"]
        out1 = b.seq(inp, cpm.coco_spec()["trunk"])
        a = b.seq(out1, heads["block1_L1"])
        c = b.seq(out1, heads["block1_L2"])
        for i in range(2, 7):
            x2 = b.concat([a, c, out1])
            a = b.seq(x2, heads[f"block{i}_L1"])
            c = b.seq(x2, heads[f"block{i}_L2"])
        outputs = [a, c]
    elif model_type == "hand":
        spec = cpm.hand_spec()
        trunk = b.seq(inp, spec["trunk"])
        out = b.seq(trunk, spec["stage1"])
        for i in range(2, 7):
            out = b.seq(b.concat([out, trunk]),
                        spec["stages"][f"stage{i}"])
        outputs = [out]
    else:
        raise ValueError(model_type)
    return g, inp, outputs


def functional_entry(config: dict) -> dict:
    """A functional model's entry in a config: the whole model, or a
    nested layer of another."""
    return {"module": "keras.src.models.functional",
            "class_name": "Functional", "config": config,
            "registered_name": "Functional",
            "build_config": {"input_shape": None}, "compile_config": {}}


def export_keras(state, model_type: str, path: str) -> None:
    """The CPM with ``state``'s weights as a ``.keras`` file (islx's
    ``export_keras`` for a ``.keras`` path)."""
    if not path.endswith(".keras"):
        raise ValueError(f"{path}: the port writes .keras archives only")
    g, inp, outs = cpm_graph(model_type, state)
    config = functional_entry(g.model_config([inp], outs, True))
    write_keras(path, config,
                lambda f: g.save_weights(f, g.ordered(outs)))


# ---------------------------------------------------------------------------
# Reading (h5py only)
# ---------------------------------------------------------------------------

def layer_vars(group) -> Dict[str, List[np.ndarray]]:
    """``{layer name: [vars/0, vars/1, ...]}`` of a keras 3 model group's
    ``layers/*`` (the names from each ``vars`` group's ``name``)."""
    out = {}
    for g in group["layers"].values():
        v = g.get("vars")
        if v is None:
            continue
        out[str(v.attrs["name"])] = [np.asarray(v[k])
                                     for k in sorted(v, key=int)]
    return out


def find_model(group, name: str):
    """The nested model group named ``name`` (its ``vars`` name) under a
    keras 3 weights group, or None."""
    for g in group.get("layers", {}).values():
        v = g.get("vars")
        if v is not None and str(v.attrs.get("name", "")) == name:
            return g
    return None


def legacy_weights(f) -> Dict[str, Dict[str, np.ndarray]]:
    """A legacy keras ``.h5``: ``{top layer: {weight name: array}}``."""
    root = f["model_weights"] if "model_weights" in f else f
    out = {}
    for lname, g in root.items():
        names = [n.decode() if isinstance(n, bytes) else str(n)
                 for n in g.attrs.get("weight_names", [])]
        if names:
            out[lname] = {n: np.asarray(g[n]) for n in names}
    return out


def state_from_vars(vars_by_layer: Dict[str, List[np.ndarray]],
                    model_type: str):
    """Conv2D [kernel HWIO, bias] and PReLU [alpha] lists -> port state."""
    state = {}
    for c in cpm.conv_layers(model_type):
        w, b = vars_by_layer[c.name]
        e = {"w": torch.from_numpy(np.ascontiguousarray(
                 np.asarray(w, np.float32).transpose(3, 2, 0, 1))),
             "b": torch.from_numpy(np.array(b, np.float32))}
        if c.act == "prelu":
            (alpha,) = vars_by_layer[f"prelu_{c.name}"]
            e["p"] = torch.from_numpy(np.array(alpha, np.float32)
                                      .reshape(-1))
        state[c.name] = e
    return state


def legacy_state(weights: Dict[str, np.ndarray], model_type: str):
    """A legacy group's ``{"<layer>/kernel": ...}`` -> port state."""
    by_layer: Dict[str, List[np.ndarray]] = {}
    for wname, arr in weights.items():
        parts = wname.split("/")
        by_layer.setdefault(parts[-2], []).append(arr)
    return state_from_vars(by_layer, model_type)


def params_from_keras(path: str, model_type: str):
    """A CPM ``.keras`` (the port's or islx's) or legacy ``.h5`` file ->
    port state (``{name: {"w" OIHW, "b"[, "p"]}}``), read with h5py."""
    import h5py

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            data = io.BytesIO(z.read("model.weights.h5"))
        with h5py.File(data, "r") as f:
            return state_from_vars(layer_vars(f), model_type)
    with h5py.File(path, "r") as f:
        merged = {}
        for ws in legacy_weights(f).values():
            merged.update(ws)
    return legacy_state(merged, model_type)
