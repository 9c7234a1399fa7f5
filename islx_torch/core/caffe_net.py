"""The Caffe API on PyTorch: ``Net`` / ``Blob`` / ``SGDSolver`` (port of
``islx/core/caffe_net.py``).

The reference converter's caffe shim
(caffemodel2pytorch/caffemodel2pytorch.py:61-296) builds one torch module
per prototxt layer and runs them eagerly; so does this module:

* a layer object per prototxt layer (:data:`_REGISTRY`: the reference's
  Convolution, InnerProduct, Pooling, Softmax, ReLU, Dropout, Eltwise and
  LRN; PReLU, Concat and the OpenPose prototxts' inputs; the losses
  SGDSolver needs, SoftmaxWithLoss and EuclideanLoss), run in prototxt
  order on the net's device;
* parameters in ``net.params`` as ``{layer: {"weight", "bias"}}`` tensors,
  OIHW / [O, I] as the ``.caffemodel`` stores them; a layer without
  loaded weights is initialised from its filler on first use, from the
  net's own seeded ``torch.Generator``;
* ``Net.forward`` returns the output blobs as numpy and fills
  ``net.blobs``; ``SGDSolver.step`` runs the forward under autograd and
  applies SGD with momentum, weight decay, ``lr_mult``/``decay_mult`` and
  the ``step`` learning-rate policy, as islx's solver does.

The device is explicit: ``Net(..., device=)``, else the one chosen by
:func:`set_mode_cpu` / :func:`set_mode_gpu` / :func:`set_device`, else
CUDA; with no GPU and no request it raises. f32 convolutions and matmuls
run in full f32 (``runtime.true_f32``), forward and the solver's backward,
as islx's do.

One deliberate difference: Dropout is random in the TRAIN phase (the
reference shim's ``nn.Dropout``), drawn from the net's generator; islx's
passes its input through in both phases. In TEST both are the identity.

The prototxt is read with islx's small protobuf-text reader (copied): no
protoc round trip. Weights load from ``.caffemodel`` (wire format,
:mod:`islx_torch.core.caffe_reader`), ``.h5`` (h5py), ``.npz`` or ``.pt``.
"""
from __future__ import annotations

import functools
import operator
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from islx_torch.core.runtime import resolve_device, true_f32

TRAIN, TEST = 0, 1

_MODE = {"device": None}


def set_mode_cpu() -> None:
    """Nets and solvers made from now on run on the CPU."""
    _MODE["device"] = "cpu"


def set_mode_gpu() -> None:
    """Nets and solvers made from now on run on the GPU (the default)."""
    _MODE["device"] = "cuda"


def set_device(device_id: int) -> None:
    """The GPU that nets made from now on run on."""
    _MODE["device"] = f"cuda:{device_id}"


# ---------------------------------------------------------------------------
# protobuf text-format parsing (prototxt), islx's reader
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r'"(?:[^"\\]|\\.)*"|[{}:]|[^\s{}:]+')


def _tokenize(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        out.extend(_TOKEN.findall(line))
    return out


def _coerce(tok: str):
    if tok.startswith('"'):
        return tok[1:-1]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok  # enum name (e.g. MAX, TRAIN)


def _parse_msg(toks: List[str], i: int) -> Tuple[Dict[str, list], int]:
    """One message body; every field is a list (repeated-by-default)."""
    msg: Dict[str, list] = {}
    n = len(toks)
    while i < n and toks[i] != "}":
        key = toks[i]
        if i + 1 < n and toks[i + 1] == ":":
            val, i = _coerce(toks[i + 2]), i + 3
        elif i + 1 < n and toks[i + 1] == "{":
            val, i = _parse_msg(toks, i + 2)
        else:
            raise ValueError(f"prototxt parse error near token {i}: {key!r}")
        msg.setdefault(key, []).append(val)
    return msg, i + 1


def parse_prototxt(text: str) -> Dict[str, list]:
    msg, _ = _parse_msg(_tokenize(text) + ["}"], 0)
    return msg


def _one(msg: Dict[str, list], key: str, default=None):
    v = msg.get(key)
    return v[0] if v else default


# ---------------------------------------------------------------------------
# Blob
# ---------------------------------------------------------------------------

class _AssignmentAdapter:
    """Placeholder accepting ``blob.data[...] = x`` before a shape exists
    (the reference's Blob.AssignmentAdapter, caffemodel2pytorch.py:165)."""

    contents: Optional[np.ndarray] = None

    @property
    def shape(self):
        return None if self.contents is None else self.contents.shape

    def __setitem__(self, idx, values):
        self.contents = np.asarray(values)


class Blob:
    """NCHW view over a tensor (fetched to numpy on first access)."""

    def __init__(self, data=None, diff=None):
        self.data_ = data if data is not None else _AssignmentAdapter()
        self.diff_ = diff if diff is not None else _AssignmentAdapter()
        self.shape_: Optional[Tuple[int, ...]] = None

    def reshape(self, *args):
        self.shape_ = tuple(args)

    def count(self, *axis):
        sl = slice(*(list(axis) + [None])[:2]) if axis else slice(None)
        return functools.reduce(operator.mul, self.shape[sl], 1)

    @property
    def data(self):
        if isinstance(self.data_, torch.Tensor):
            self.data_ = self.data_.detach().cpu().numpy()
        return self.data_

    @property
    def diff(self):
        if isinstance(self.diff_, torch.Tensor):
            self.diff_ = self.diff_.detach().cpu().numpy()
        return self.diff_

    @property
    def shape(self):
        if self.shape_ is not None:
            return self.shape_
        return tuple(self.data_.shape)

    @property
    def num(self):
        return self.shape[0]

    @property
    def channels(self):
        return self.shape[1]

    @property
    def height(self):
        return self.shape[2]

    @property
    def width(self):
        return self.shape[3]


# ---------------------------------------------------------------------------
# Layers: one object per prototxt layer. ``init(in_shapes, generator)`` ->
# its parameters (or None), ``forward(params, inputs)`` -> its tops. All
# tensors NCHW (caffe's blob layout); weights OIHW / [O, I] as the
# .caffemodel stores them.
# ---------------------------------------------------------------------------

def _ints(param, key, default):
    v = param.get(key)
    if not v:
        return (default, default)
    return (v[0], v[0]) if len(v) == 1 else (v[0], v[1])


def _filler_std(param, fan_in):
    f = _one(param, "weight_filler", {})
    t = _one(f, "type", "gaussian") if f else "gaussian"
    if t == "xavier":
        return float(np.sqrt(1.0 / max(fan_in, 1)))
    if t == "msra":
        return float(np.sqrt(2.0 / max(fan_in, 1)))
    return float(_one(f, "std", 0.01)) if f else 0.01


class _LayerSpec:
    """One prototxt ``layer { }`` message."""

    def __init__(self, msg: Dict[str, list]):
        self.name: str = _one(msg, "name", "")
        t = _one(msg, "type", "")
        self.type: str = t if isinstance(t, str) else str(t)
        self.bottom: List[str] = list(msg.get("bottom", []))
        self.top: List[str] = list(msg.get("top", []))
        self.param: Dict[str, list] = next(
            (v[0] for k, v in msg.items() if k.endswith("_param") and v), {})
        self.opt_params: List[Dict[str, list]] = list(msg.get("param", []))
        lw = msg.get("loss_weight")
        default_lw = 1.0 if self.type.upper().endswith("LOSS") else 0.0
        self.loss_weight: List[float] = (
            [float(x) for x in lw] if lw else [default_lw] * len(self.top))
        phases = [_one(r, "phase") for r in msg.get("include", [])]
        self.phase: Optional[int] = (
            {"TRAIN": TRAIN, "TEST": TEST}.get(phases[0]) if phases else None)


class Layer:
    """A prototxt layer: its spec, and the phase its net runs in."""

    def __init__(self, spec: _LayerSpec, phase: int):
        self.spec, self.p, self.phase = spec, spec.param, phase

    def init(self, in_shapes, generator) -> Optional[Dict[str, torch.Tensor]]:
        return None

    def forward(self, params, inputs) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError


class Convolution(Layer):
    def init(self, in_shapes, generator):
        cout = _one(self.p, "num_output")
        kh, kw = _ints(self.p, "kernel_size", 1)
        # caffe stores grouped weights as [O, I/g, kh, kw]
        cin = in_shapes[0][1] // _one(self.p, "group", 1)
        std = _filler_std(self.p, cin * kh * kw)
        return {"weight": torch.randn((cout, cin, kh, kw),
                                      generator=generator) * std,
                "bias": torch.zeros(cout)}

    def forward(self, params, inputs):
        return (F.conv2d(inputs[0], params["weight"], params.get("bias"),
                         _ints(self.p, "stride", 1), _ints(self.p, "pad", 0),
                         _ints(self.p, "dilation", 1),
                         _one(self.p, "group", 1)),)


class InnerProduct(Layer):
    def init(self, in_shapes, generator):
        cout = _one(self.p, "num_output")
        cin = int(np.prod(in_shapes[0][1:]))
        std = _filler_std(self.p, cin)
        return {"weight": torch.randn((cout, cin), generator=generator) * std,
                "bias": torch.zeros(cout)}

    def forward(self, params, inputs):
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        return (x @ params["weight"].T + params["bias"],)


class Pooling(Layer):
    def forward(self, params, inputs):
        kh, kw = _ints(self.p, "kernel_size", 1)
        sh, sw = _ints(self.p, "stride", 1)
        ph, pw = _ints(self.p, "pad", 0)
        x = inputs[0]
        h, w = x.shape[2], x.shape[3]
        # caffe sizes pooling with CEIL: out = ceil((H + 2p - k)/s) + 1,
        # then drops a last window that would start in the bottom or right
        # padding (PoolingLayer::Reshape: if ((pooled-1)*stride >= height +
        # pad) --pooled)
        oh = -(-(h + 2 * ph - kh) // sh) + 1
        ow = -(-(w + 2 * pw - kw) // sw) + 1
        if ph and (oh - 1) * sh >= h + ph:
            oh -= 1
        if pw and (ow - 1) * sw >= w + pw:
            ow -= 1
        eh = max((oh - 1) * sh + kh - (h + 2 * ph), 0)
        ew = max((ow - 1) * sw + kw - (w + 2 * pw), 0)
        is_max = _one(self.p, "pool", "MAX") in ("MAX", 0)
        x = F.pad(x, (pw, pw + ew, ph, ph + eh),
                  value=-float("inf") if is_max else 0.0)
        if is_max:
            y = F.max_pool2d(x, (kh, kw), (sh, sw))
        else:     # islx's window sum over kh*kw, padding included
            y = F.avg_pool2d(x, (kh, kw), (sh, sw))
        return (y[:, :, :oh, :ow],)


class ReLU(Layer):
    def forward(self, params, inputs):
        slope = _one(self.p, "negative_slope", 0.0)
        x = inputs[0]
        return (torch.where(x > 0, x, slope * x) if slope
                else torch.clamp_min(x, 0.0),)


class PReLU(Layer):
    def init(self, in_shapes, generator):
        return {"weight": torch.full((in_shapes[0][1],), 0.25)}

    def forward(self, params, inputs):
        x = inputs[0]
        a = (params["weight"][None, :, None, None] if x.ndim == 4
             else params["weight"])
        return (torch.where(x >= 0, x, a * x),)


class Softmax(Layer):
    def forward(self, params, inputs):
        return (torch.softmax(inputs[0], dim=_one(self.p, "axis", 1)),)


class Dropout(Layer):
    """The identity in TEST; in TRAIN, caffe's inverted dropout at
    ``dropout_ratio`` (0.5 by default) from the net's generator."""

    generator: Optional[torch.Generator] = None

    def forward(self, params, inputs):
        x = inputs[0]
        rate = float(_one(self.p, "dropout_ratio", 0.5))
        if self.phase != TRAIN or rate == 0.0:
            return (x,)
        keep = torch.rand(x.shape, generator=self.generator).to(x.device)
        return (torch.where(keep >= rate, x / (1.0 - rate),
                            torch.zeros_like(x)),)


class Eltwise(Layer):
    def forward(self, params, inputs):
        op = _one(self.p, "operation", "SUM")
        out = inputs[0]
        if op in ("PROD", 0):
            for x in inputs[1:]:
                out = out * x
            return (out,)
        if op in ("MAX", 2):
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return (out,)
        coeffs = self.p.get("coeff") or [1.0] * len(inputs)
        out = coeffs[0] * inputs[0]
        for c, x in zip(coeffs[1:], inputs[1:]):
            out = out + c * x
        return (out,)


class LRN(Layer):
    """Across channels: x / (k + alpha/size * sum of x^2 over the
    ``local_size`` channels around)^beta."""

    def forward(self, params, inputs):
        size = _one(self.p, "local_size", 5)
        alpha, beta = _one(self.p, "alpha", 1.0), _one(self.p, "beta", 0.75)
        k = _one(self.p, "k", 1.0)
        x = inputs[0]
        half = size // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, half))
        acc = sq.unfold(1, size, 1).sum(-1)
        return (x / (k + (alpha / size) * acc) ** beta,)


class Concat(Layer):
    def forward(self, params, inputs):
        return (torch.cat(inputs, dim=_one(self.p, "axis", 1)),)


class SoftmaxWithLoss(Layer):
    """Softmax over axis 1, the NLL averaged over the batch and every
    spatial position (caffe's normalize=true; for [N,C,H,W] scores with
    [N,H,W] labels, torch's ``cross_entropy`` 'mean')."""

    def forward(self, params, inputs):
        scores, labels = inputs[0], inputs[1]
        n, c = scores.shape[0], scores.shape[1]
        logp = torch.log_softmax(scores, dim=1).reshape(n, c, -1)
        lbl = labels.to(torch.int64).reshape(n, -1)
        nll = -torch.gather(logp, 1, lbl[:, None, :])[:, 0, :]
        return (nll.mean(),)


class EuclideanLoss(Layer):
    def forward(self, params, inputs):
        a, b = inputs[0], inputs[1]
        return (((a - b) ** 2).sum() / (2.0 * a.shape[0]),)


_REGISTRY = {cls.__name__: cls for cls in (
    Convolution, InnerProduct, Pooling, ReLU, PReLU, Softmax, Dropout,
    Eltwise, LRN, Concat, SoftmaxWithLoss, EuclideanLoss)}


# ---------------------------------------------------------------------------
# Net
# ---------------------------------------------------------------------------

def _read_weights(weights: str) -> Dict[str, np.ndarray]:
    if weights.endswith(".caffemodel"):
        from islx_torch.core.caffe_reader import read_caffemodel

        return read_caffemodel(weights)
    if weights.endswith((".h5", ".hdf5")):
        import h5py

        with h5py.File(weights, "r") as h:
            return {k: np.array(v) for k, v in h.items()}
    if weights.endswith(".npz"):
        with np.load(weights) as z:
            return dict(z)
    sd = torch.load(weights, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


class Net:
    """A caffe net: prototxt layers run in order on ``device``.

    ``Net(prototxt, weights=None, phase=None, device=None, seed=0)``: both
    caffe constructor forms, positionally as the reference shim
    (caffemodel2pytorch.py:62-69). ``forward(data=..., **variables)``
    returns ``{output blob: np.ndarray}`` and fills ``net.blobs``.
    """

    def __init__(self, prototxt: str, *args, device=None, seed: int = 0,
                 **kwargs):
        kwargs.pop("caffe_proto", None)  # compat; no protoc needed here
        weights = kwargs.pop("weights", None) or (tuple(args) + (None,))[0]
        phase = kwargs.pop("phase", None)
        if phase is None and len(args) > 1:
            phase = args[1]
        self.phase = TEST if phase is None else phase
        self.device = resolve_device(device if device is not None
                                     else _MODE["device"])
        self.generator = torch.Generator().manual_seed(seed)

        with open(prototxt) as f:
            self.net_param = parse_prototxt(f.read())

        self.layers: List[Layer] = []
        for msg in self.net_param.get("layer", []):
            spec = _LayerSpec(msg)
            if spec.phase is not None and spec.phase != self.phase:
                continue
            if spec.type in ("Input", "Data"):
                continue  # data enters through forward() kwargs
            if spec.type not in _REGISTRY:
                print(f"caffe_net: skipping layer [{spec.name}, {spec.type}]"
                      ": not in registry")
                continue
            layer = _REGISTRY[spec.type](spec, self.phase)
            if isinstance(layer, Dropout):
                layer.generator = self.generator
            self.layers.append(layer)

        self.input_names = list(self.net_param.get("input", []))
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.blobs: Dict[str, Blob] = {}
        self.blob_loss_weights: Dict[str, float] = {
            t: w for layer in self.layers
            for t, w in zip(layer.spec.top, layer.spec.loss_weight)}
        self._grad = False
        if weights is not None:
            self.copy_from(weights)

    # -- parameters --------------------------------------------------------

    def copy_from(self, weights: str) -> None:
        """Load ``{layer}.weight`` / ``{layer}.bias`` blobs for the net's
        layers from a .caffemodel, .h5, .npz or .pt file."""
        flat = _read_weights(weights)
        for layer in self.layers:
            name = layer.spec.name
            entry = {}
            for part in ("weight", "bias"):
                v = flat.get(f"{name}.{part}")
                if v is not None:
                    entry[part] = torch.from_numpy(
                        np.array(v, np.float32)).to(self.device)
            if entry:
                self.params[name] = entry

    def save(self, weights: str) -> None:
        import h5py

        with h5py.File(weights, "w") as h:
            for name, entry in self.params.items():
                for part, v in entry.items():
                    h[f"{name}.{part}"] = v.detach().cpu().numpy()

    # -- execution ---------------------------------------------------------

    def _run(self, variables: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Every layer in order; a layer's parameters are initialised from
        its filler on first use (the reference's lazy modules,
        caffemodel2pytorch.py:320-354)."""
        variables = dict(variables)
        with true_f32():
            for layer in self.layers:
                spec = layer.spec
                inputs = [variables[b] for b in spec.bottom]
                if spec.name not in self.params:
                    p = layer.init([tuple(x.shape) for x in inputs],
                                   self.generator)
                    if p is not None:
                        self.params[spec.name] = {
                            k: v.to(self.device).requires_grad_(self._grad)
                            for k, v in p.items()}
                variables.update(zip(spec.top, layer.forward(
                    self.params.get(spec.name), inputs)))
        return variables

    def _output_names(self) -> set:
        tops = {t for layer in self.layers for t in layer.spec.top}
        consumed = {b for layer in self.layers for b in layer.spec.bottom
                    if b not in layer.spec.top}  # in-place tops stay outputs
        return tops - consumed

    def _inputs(self, variables) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                for k, v in variables.items()}

    def forward(self, data=None, **variables) -> Dict[str, np.ndarray]:
        if data is not None:
            variables["data"] = data
        with torch.no_grad():
            out = self._run(self._inputs(variables))
        self.blobs.update({k: Blob(data=v) for k, v in out.items()})
        outputs = self._output_names()
        return {k: v.cpu().numpy() for k, v in out.items() if k in outputs}

    __call__ = forward


# ---------------------------------------------------------------------------
# SGDSolver
# ---------------------------------------------------------------------------

class SGDSolver:
    """A caffe solver prototxt -> SGD with momentum and weight decay on the
    net's autograd (reference: caffemodel2pytorch.py:238-285). Each of
    ``iter_size`` sub-steps applies an update at ``base_lr / iter_size``,
    as islx's solver does."""

    def __init__(self, solver_prototxt: str, device=None, seed: int = 0):
        with open(solver_prototxt) as f:
            sp = parse_prototxt(f.read())
        self.net = Net(_one(sp, "train_net") or _one(sp, "net"), phase=TRAIN,
                       device=device, seed=seed)
        self.net._grad = True
        self.iter = 1
        self.iter_size = int(_one(sp, "iter_size", 1))
        self.base_lr = float(_one(sp, "base_lr", 0.01)) / self.iter_size
        self.momentum = float(_one(sp, "momentum", 0.0))
        self.weight_decay = float(_one(sp, "weight_decay", 0.0))
        self.lr_policy = _one(sp, "lr_policy", "fixed")
        self.step_size = int(_one(sp, "stepsize", 0) or 0)
        self.gamma = float(_one(sp, "gamma", 1.0))
        self._velocity: Dict[Tuple[str, str], torch.Tensor] = {}

    def _lr(self) -> float:
        if self.lr_policy == "step" and self.step_size:
            return self.base_lr * self.gamma ** (self.iter // self.step_size)
        return self.base_lr

    def _multipliers(self, name: str) -> Dict[str, Tuple[float, float]]:
        """(lr_mult, decay_mult) of each of a layer's blobs, from its
        repeated ``param {}`` entries in blob order (weight, then bias);
        lr_mult 0 freezes the blob (caffemodel2pytorch.py:98-99)."""
        spec = next(layer.spec for layer in self.net.layers
                    if layer.spec.name == name)
        entry = self.net.params[name]
        order = [p for p in ("weight", "bias") if p in entry]
        order += [p for p in entry if p not in order]
        return {part: (float(_one(opt, "lr_mult", 1)),
                       float(_one(opt, "decay_mult", 1)))
                for part, opt in zip(order, list(spec.opt_params) + [{}, {}])}

    def _update(self, variables) -> float:
        net = self.net
        for entry in net.params.values():
            for p in entry.values():
                p.requires_grad_(True)
                p.grad = None
        with true_f32():      # the backward's convolutions too
            out = net._run(variables)
            lw = net.blob_loss_weights
            loss = sum(lw[t] * out[t].sum() for t, w in lw.items() if w)
            loss.backward()
        lr = self._lr()
        with torch.no_grad():
            for name, entry in net.params.items():
                mults = self._multipliers(name)
                for part, p in entry.items():
                    lm, dm = mults.get(part, (1.0, 1.0))
                    v = self._velocity.setdefault((name, part),
                                                  torch.zeros_like(p))
                    if lm == 0.0 or p.grad is None:
                        continue
                    g = p.grad + self.weight_decay * dm * p
                    v.copy_(self.momentum * v + lr * lm * g)
                    p.sub_(v)
        return float(loss.detach())

    def step(self, iterations: int = 1, **inputs) -> float:
        variables = self.net._inputs(inputs)
        total = 0.0
        for _ in range(iterations):
            loss = 0.0
            for _ in range(self.iter_size):
                loss += self._update(variables) / self.iter_size
            total += loss
            self.iter += 1
        return total
