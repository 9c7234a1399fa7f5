"""CPM weights for the port: carried across out of islx, loaded, or made.

The port's weight state is ``{caffe_layer: {"w" OIHW, "b"[, "p"]}}`` of f32
CPU tensors; :meth:`islx_torch.models.cpm.CPM.load_params` takes it. An
int8 layer (:mod:`islx_torch.models.quant`) holds ``{"w_q" int8 OIHW,
"s_w", "a_scale", "b"[, "p"]}`` in place of ``w``.

* :func:`from_islx_params` carries islx's params (``{name: {"w" HWIO, "b",
  "p"}}`` as numpy) across, so both packages run the very same weights.
* :func:`load` reads islx ``.npz`` files (``islx.core.weights.save_npz``),
  reference ``.pt``/``.pth`` flat caffe dicts, ``.caffemodel`` files
  (:mod:`islx_torch.core.caffe_reader`) and the port's state files
  (:func:`save_state`: a float or int8 state, as ``python -m
  islx_torch.cli.quantize`` writes it); :func:`save_npz` writes the
  ``.npz``.
* :func:`init_params` is the port's own seeded He-normal init. It does not
  reproduce JAX's threefry bits; comparisons carry islx's params across.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from islx_torch.models import cpm

State = Dict[str, Dict[str, torch.Tensor]]


def _prelu_key(conv_name: str) -> str:
    """Caffe PReLU blob name: conv4_2 -> prelu4_2, Mconv.. -> Mprelu.."""
    if conv_name.startswith("Mconv"):
        return "Mprelu" + conv_name[len("Mconv"):]
    return "prelu" + conv_name[len("conv"):]


def _strip_module_prefix(name: str) -> str:
    """Strip torch module paths (reference src/util.py:35-44)."""
    parts = name.split(".")
    if len(parts) > 4:
        return ".".join(parts[3:])
    if len(parts) > 2:
        return ".".join(parts[1:])
    return name


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_islx_params(params: Mapping[str, Mapping[str, np.ndarray]]
                     ) -> State:
    """islx params ({name: {"w" HWIO, "b"[, "p"]}}, or a quantized entry's
    {"w_q" int8 HWIO, "s_w", "a_scale", "b"[, "p"]}, numpy) -> port
    state."""
    state: State = {}
    for name, entry in params.items():
        out = {}
        for k, v in entry.items():
            v = np.asarray(v)
            if k == "w_q":
                out[k] = torch.from_numpy(np.ascontiguousarray(
                    v.astype(np.int8).transpose(3, 2, 0, 1)))
            elif k == "w":
                out[k] = _t(v.transpose(3, 2, 0, 1))
            else:
                out[k] = _t(v)
        state[name] = out
    return state


def to_islx_params(state: State) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`from_islx_params` (HWIO numpy)."""
    return {name: {k: (v.numpy().transpose(2, 3, 1, 0) if k in ("w", "w_q")
                       else v.numpy()) for k, v in entry.items()}
            for name, entry in state.items()}


def from_flat_dict(flat: Mapping[str, np.ndarray], model_type: str) -> State:
    """Flat ``{caffe_name}.weight/.bias`` mapping (OIHW) -> port state."""
    norm = {_strip_module_prefix(k): np.asarray(v) for k, v in flat.items()}
    state: State = {}
    for c in cpm.conv_layers(model_type):
        w = norm[f"{c.name}.weight"]
        if w.shape != (c.cout, c.cin, c.k, c.k):
            raise ValueError(f"{c.name}: expected OIHW "
                             f"{(c.cout, c.cin, c.k, c.k)}, got {w.shape}")
        entry = {"w": _t(w), "b": _t(norm[f"{c.name}.bias"])}
        if c.act == "prelu":
            entry["p"] = _t(norm[f"{_prelu_key(c.name)}.weight"].reshape(-1))
        state[c.name] = entry
    return state


def to_flat_dict(state: State) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_flat_dict`."""
    flat: Dict[str, np.ndarray] = {}
    for name, entry in state.items():
        flat[f"{name}.weight"] = entry["w"].numpy()
        flat[f"{name}.bias"] = entry["b"].numpy()
        if "p" in entry:
            flat[f"{_prelu_key(name)}.weight"] = entry["p"].numpy()
    return flat


def load_npz(path: str, model_type: str) -> State:
    """islx ``save_npz`` file ({name}/w HWIO, /b, /p) -> port state."""
    with np.load(path) as data:
        params = {}
        for c in cpm.conv_layers(model_type):
            entry = {"w": data[f"{c.name}/w"], "b": data[f"{c.name}/b"]}
            if c.act == "prelu":
                entry["p"] = data[f"{c.name}/p"]
            params[c.name] = entry
    return from_islx_params(params)


def save_npz(path: str, state: State) -> None:
    """A port state as islx's flat ``.npz`` ({name}/w HWIO, /b, /p), the
    file :func:`load_npz` and islx's ``weights.load`` read."""
    np.savez(path, **{f"{name}/{k}": v
                      for name, entry in to_islx_params(state).items()
                      for k, v in entry.items()})


STATE_FORMAT = "islx_torch-state"


def save_state(path: str, state: State, model_type: str) -> str:
    """A weight state, float or int8 (``w_q``/``s_w``/``a_scale``
    entries), as one ``torch.save`` file at ``path``, which must end in
    ``.pt``, that :func:`load` reads back (islx writes orbax directories
    or pickled treedefs here, which need JAX to read). -> the file
    written."""
    if not path.endswith(".pt"):
        raise ValueError(f"{path}: a state file's name ends in .pt")
    out = os.path.abspath(path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({"format": STATE_FORMAT, "model_type": model_type,
                "params": {name: dict(entry)
                           for name, entry in state.items()}},
               out + ".tmp")
    os.replace(out + ".tmp", out)
    return out


def _checked_state(blob, path: str, model_type: str) -> State:
    if blob["model_type"] != model_type:
        raise ValueError(f"{path}: a {blob['model_type']} state, not "
                         f"{model_type}")
    names = [c.name for c in cpm.conv_layers(model_type)]
    if set(blob["params"]) != set(names):
        raise ValueError(f"{path}: its layers are not {model_type}'s")
    return {n: blob["params"][n] for n in names}


def load(path: str, model_type: str) -> State:
    """Weights from an islx ``.npz``, a reference ``.pt``/``.pth`` flat
    caffe dict, a ``.caffemodel``, or a ``.pt`` state file of
    :func:`save_state`."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        return load_npz(path, model_type)
    if ext in (".pt", ".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if sd.get("format") == STATE_FORMAT:
            return _checked_state(sd, path, model_type)
        return from_flat_dict({k: v.numpy() for k, v in sd.items()},
                              model_type)
    if ext == ".caffemodel":
        from islx_torch.core.caffe_reader import read_caffemodel

        return from_flat_dict(read_caffemodel(path), model_type)
    raise ValueError(f"unsupported checkpoint format: {path}")


def init_params(model_type: str, seed: int = 0) -> State:
    """Seeded He-normal init (zero bias, PReLU slope 0.25)."""
    g = torch.Generator().manual_seed(seed)
    state: State = {}
    for c in cpm.conv_layers(model_type):
        fan_in = c.k * c.k * c.cin
        entry = {"w": torch.randn((c.cout, c.cin, c.k, c.k), generator=g)
                 * float(np.sqrt(2.0 / fan_in)),
                 "b": torch.zeros(c.cout)}
        if c.act == "prelu":
            entry["p"] = torch.full((c.cout,), 0.25)
        state[c.name] = entry
    return state


def build(model_type: str, state: State, device, compute_dtype
          ) -> cpm.CPM:
    """A CPM net on ``device`` with ``state`` loaded and the float
    layers' weights cast (int8 layers stay int8)."""
    net = cpm.CPM(model_type).load_params(state)
    return net.to(device).cast(compute_dtype).eval()
