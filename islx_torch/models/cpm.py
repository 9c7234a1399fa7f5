"""Convolutional Pose Machine nets (BODY_25, COCO-18 and the hand CPM) in
PyTorch.

Port of ``islx/models/cpm.py`` (float path). Layer names equal the caffe
blob names, so weights carry across by name. Public inputs and outputs keep
the JAX package's NHWC layout; inside, activations are NCHW tensors in
``channels_last`` memory, which is the same bytes as NHWC.

Epilogue order follows the reference exactly: a non-head conv accumulates
in f32, rounds to the compute dtype, then adds the bias and activates in
that dtype; a head conv (``Conv.head``, the 1x1 stage outputs the peak and
PAF math reads) keeps an f32 epilogue. In bf16 a head conv therefore runs
on the bf16-valued input and weight upcast to f32, which is the f32
accumulation of the same products.

A state whose entries hold ``w_q`` (:mod:`islx_torch.models.quant`) makes
those layers int8 :class:`~islx_torch.models.quant.QConvLayer` s. Where
the JAX code chains them (its ``_seq``), the int8 activations stay int8
between consecutive quantized convs: each epilogue writes int8 at the next
conv's scale and the 2x2 pools between run on int8. Its dense blocks and
BODY_25's ``Mconv6``/``Mconv7`` are not chained (each conv quantizes its
float input).

Training (:mod:`islx_torch.models.pose_train`) runs a float net that was
never cast: :meth:`CPM.trainable` makes its f32 master weights, biases and
PReLU slopes require gradients, and ``ConvLayer.forward`` rounds them to
the compute dtype at use. Int8 layers are inference-only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from islx_torch.core.runtime import true_f32
from islx_torch.models import quant


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    pad: int
    act: str  # 'relu' | 'prelu' | 'none'
    head: bool = False


@dataclasses.dataclass(frozen=True)
class Pool:
    k: int = 2
    s: int = 2


Layer = Union[Conv, Pool]

# ---------------------------------------------------------------------------
# Layer spec tables (islx/models/cpm.py:66-199). Names are caffe blob names.
# ---------------------------------------------------------------------------


def _vgg_trunk(prelu_tail: bool) -> List[Layer]:
    act_tail = "prelu" if prelu_tail else "relu"
    return [
        Conv("conv1_1", 3, 64, 3, 1, "relu"),
        Conv("conv1_2", 64, 64, 3, 1, "relu"),
        Pool(),
        Conv("conv2_1", 64, 128, 3, 1, "relu"),
        Conv("conv2_2", 128, 128, 3, 1, "relu"),
        Pool(),
        Conv("conv3_1", 128, 256, 3, 1, "relu"),
        Conv("conv3_2", 256, 256, 3, 1, "relu"),
        Conv("conv3_3", 256, 256, 3, 1, "relu"),
        Conv("conv3_4", 256, 256, 3, 1, "relu"),
        Pool(),
        Conv("conv4_1", 256, 512, 3, 1, "relu"),
        Conv("conv4_2", 512, 512, 3, 1, act_tail),
        Conv("conv4_3_CPM", 512, 256, 3, 1, act_tail),
        Conv("conv4_4_CPM", 256, 128, 3, 1, act_tail),
    ]


def _b25_dense_block(i: int, s: int, L: str, cin: int, c: int) -> List[Conv]:
    base = f"Mconv{i}_stage{s}_{L}"
    return [
        Conv(f"{base}_0", cin, c, 3, 1, "prelu"),
        Conv(f"{base}_1", c, c, 3, 1, "prelu"),
        Conv(f"{base}_2", c, c, 3, 1, "prelu"),
    ]


def _b25_stage(s: int, L: str, cin: int, c: int, c6: int, cout: int
               ) -> Dict[str, List[Conv]]:
    blocks = {f"Mconv1_stage{s}_{L}": _b25_dense_block(1, s, L, cin, c)}
    for i in range(2, 6):
        blocks[f"Mconv{i}_stage{s}_{L}"] = _b25_dense_block(i, s, L, 3 * c, c)
    blocks[f"Mconv6_7_stage{s}_{L}"] = [
        Conv(f"Mconv6_stage{s}_{L}", 3 * c, c6, 1, 0, "prelu"),
        Conv(f"Mconv7_stage{s}_{L}", c6, cout, 1, 0, "none", head=True),
    ]
    return blocks


def body25_spec() -> Dict[str, object]:
    """Full BODY_25 spec: 4 PAF stages (L2) + 2 heatmap stages (L1)."""
    stages: Dict[str, List[Conv]] = {}
    stages.update(_b25_stage(0, "L2", 128, 96, 256, 52))
    for s in range(1, 4):
        stages.update(_b25_stage(s, "L2", 180, 128, 512, 52))
    stages.update(_b25_stage(0, "L1", 180, 96, 256, 26))
    stages.update(_b25_stage(1, "L1", 206, 128, 512, 26))
    return {"trunk": _vgg_trunk(prelu_tail=True), "stages": stages}


def coco_spec() -> Dict[str, object]:
    """COCO-18 spec (islx/models/cpm.py:130): VGG trunk with ReLU tail, then
    six stages of two branches, L1 (38 PAF channels) and L2 (19 heat)."""
    heads: Dict[str, List[Conv]] = {}
    for L, cout in (("L1", 38), ("L2", 19)):
        heads[f"block1_{L}"] = [
            Conv(f"conv5_1_CPM_{L}", 128, 128, 3, 1, "relu"),
            Conv(f"conv5_2_CPM_{L}", 128, 128, 3, 1, "relu"),
            Conv(f"conv5_3_CPM_{L}", 128, 128, 3, 1, "relu"),
            Conv(f"conv5_4_CPM_{L}", 128, 512, 1, 0, "relu"),
            Conv(f"conv5_5_CPM_{L}", 512, cout, 1, 0, "none", head=True),
        ]
        for i in range(2, 7):
            # the reference's no-ReLU list names Mconv7_stage6_L1 twice and
            # never Mconv7_stage6_L2, so the final heatmap head is
            # ReLU-clamped while every other stage head is linear
            head_act = "relu" if (i == 6 and L == "L2") else "none"
            heads[f"block{i}_{L}"] = [
                Conv(f"Mconv1_stage{i}_{L}", 185, 128, 7, 3, "relu"),
                Conv(f"Mconv2_stage{i}_{L}", 128, 128, 7, 3, "relu"),
                Conv(f"Mconv3_stage{i}_{L}", 128, 128, 7, 3, "relu"),
                Conv(f"Mconv4_stage{i}_{L}", 128, 128, 7, 3, "relu"),
                Conv(f"Mconv5_stage{i}_{L}", 128, 128, 7, 3, "relu"),
                Conv(f"Mconv6_stage{i}_{L}", 128, 128, 1, 0, "relu"),
                Conv(f"Mconv7_stage{i}_{L}", 128, cout, 1, 0, head_act,
                     head=True),
            ]
    return {"trunk": _vgg_trunk(prelu_tail=False), "heads": heads}


def hand_spec() -> Dict[str, object]:
    """CPM hand spec: VGG trunk + stage1 + 5 refinement stages."""
    trunk: List[Layer] = [
        Conv("conv1_1", 3, 64, 3, 1, "relu"),
        Conv("conv1_2", 64, 64, 3, 1, "relu"),
        Pool(),
        Conv("conv2_1", 64, 128, 3, 1, "relu"),
        Conv("conv2_2", 128, 128, 3, 1, "relu"),
        Pool(),
        Conv("conv3_1", 128, 256, 3, 1, "relu"),
        Conv("conv3_2", 256, 256, 3, 1, "relu"),
        Conv("conv3_3", 256, 256, 3, 1, "relu"),
        Conv("conv3_4", 256, 256, 3, 1, "relu"),
        Pool(),
        Conv("conv4_1", 256, 512, 3, 1, "relu"),
        Conv("conv4_2", 512, 512, 3, 1, "relu"),
        Conv("conv4_3", 512, 512, 3, 1, "relu"),
        Conv("conv4_4", 512, 512, 3, 1, "relu"),
        Conv("conv5_1", 512, 512, 3, 1, "relu"),
        Conv("conv5_2", 512, 512, 3, 1, "relu"),
        Conv("conv5_3_CPM", 512, 128, 3, 1, "relu"),
    ]
    stage1 = [
        Conv("conv6_1_CPM", 128, 512, 1, 0, "relu"),
        Conv("conv6_2_CPM", 512, 22, 1, 0, "none", head=True),
    ]
    stages = {}
    for i in range(2, 7):
        stages[f"stage{i}"] = [
            Conv(f"Mconv1_stage{i}", 150, 128, 7, 3, "relu"),
            Conv(f"Mconv2_stage{i}", 128, 128, 7, 3, "relu"),
            Conv(f"Mconv3_stage{i}", 128, 128, 7, 3, "relu"),
            Conv(f"Mconv4_stage{i}", 128, 128, 7, 3, "relu"),
            Conv(f"Mconv5_stage{i}", 128, 128, 7, 3, "relu"),
            Conv(f"Mconv6_stage{i}", 128, 128, 1, 0, "relu"),
            Conv(f"Mconv7_stage{i}", 128, 22, 1, 0, "none", head=True),
        ]
    return {"trunk": trunk, "stage1": stage1, "stages": stages}


SPECS = {"body25": body25_spec, "coco": coco_spec, "hand": hand_spec}


def _iter_convs(node):
    if isinstance(node, Conv):
        yield node
    elif isinstance(node, (list, tuple)):
        for x in node:
            yield from _iter_convs(x)
    elif isinstance(node, dict):
        for x in node.values():
            yield from _iter_convs(x)


def conv_layers(model_type: str) -> List[Conv]:
    return list(_iter_convs(SPECS[model_type]()))


def conv_params(c: Conv) -> int:
    """Weights, bias and PReLU slopes of one conv layer."""
    return (c.k * c.k * c.cin * c.cout + c.cout
            + (c.cout if c.act == "prelu" else 0))


def param_count(model_type: str) -> int:
    """Weights, biases and PReLU slopes of every conv layer."""
    return sum(conv_params(c) for c in conv_layers(model_type))


# ---------------------------------------------------------------------------
# Wiring: each net is a chain of cells (islx/parallel/pipeline.py's). A
# cell is (name, the conv names it owns, fn(net, state, cd) -> state); a
# state is a dict of NCHW activations, {"x": the input} before the first
# cell. CPM's forwards run the chain; the pipelined CPM
# (islx_torch/parallel/pipeline.py) cuts it into segments.
# ---------------------------------------------------------------------------

Cell = Tuple[str, List[str], Callable]


def _names(node) -> List[str]:
    return [c.name for c in _iter_convs(node)]


def _b25_cells(spec) -> List[Cell]:
    """src/model.py:179-207: four PAF stages (L2), then two heatmap
    stages (L1)."""
    st = spec["stages"]

    def stage_names(s: int, L: str) -> List[str]:
        return _names([st[f"Mconv{i}_stage{s}_{L}"] for i in range(1, 6)]
                      + [st[f"Mconv6_7_stage{s}_{L}"]])

    def trunk(net, state, cd):
        out0 = net._seq(state["x"], spec["trunk"], cd)
        return {"out0": out0, "tout": out0}

    def l2(s):
        def fn(net, state, cd):
            paf = net._b25_stage(state["tout"], s, "L2", cd)
            return {"out0": state["out0"], "paf": paf,
                    "tout": net._cat([state["out0"], paf])}
        return fn

    def l1_0(net, state, cd):
        heat0 = net._b25_stage(state["tout"], 0, "L1", cd)
        return {"paf": state["paf"],
                "tout": net._cat([state["out0"], heat0, state["paf"]])}

    def l1_1(net, state, cd):
        return {"paf": state["paf"],
                "heat": net._b25_stage(state["tout"], 1, "L1", cd)}

    cells: List[Cell] = [("trunk", _names(spec["trunk"]), trunk)]
    for s in range(4):
        cells.append((f"L2s{s}", stage_names(s, "L2"), l2(s)))
    cells.append(("L1s0", stage_names(0, "L1"), l1_0))
    cells.append(("L1s1", stage_names(1, "L1"), l1_1))
    return cells


def _coco_cells(spec) -> List[Cell]:
    """islx/models/cpm.py:433-447: each branch of a stage is a ``_seq``
    chain, as in islx."""
    heads = spec["heads"]

    def trunk_b1(net, state, cd):
        out1 = net._seq(state["x"], spec["trunk"], cd)
        return {"out1": out1,
                "a": net._seq(out1, heads["block1_L1"], cd),
                "b": net._seq(out1, heads["block1_L2"], cd)}

    def block(i):
        def fn(net, state, cd):
            x2 = net._cat([state["a"], state["b"], state["out1"]])
            return {"out1": state["out1"],
                    "a": net._seq(x2, heads[f"block{i}_L1"], cd),
                    "b": net._seq(x2, heads[f"block{i}_L2"], cd)}
        return fn

    cells: List[Cell] = [("trunk_b1", _names(
        [spec["trunk"], heads["block1_L1"], heads["block1_L2"]]), trunk_b1)]
    for i in range(2, 7):
        cells.append((f"block{i}", _names(
            [heads[f"block{i}_L1"], heads[f"block{i}_L2"]]), block(i)))
    return cells


def _hand_cells(spec) -> List[Cell]:
    """The trunk and stage 1, then five refinement stages; every cell's
    ``out`` is its stage's head."""

    def trunk_s1(net, state, cd):
        t = net._seq(state["x"], spec["trunk"], cd)
        return {"trunk": t, "out": net._seq(t, spec["stage1"], cd)}

    def stage(i):
        def fn(net, state, cd):
            x2 = net._cat([state["out"], state["trunk"]])
            return {"trunk": state["trunk"],
                    "out": net._seq(x2, spec["stages"][f"stage{i}"], cd)}
        return fn

    cells: List[Cell] = [("trunk_s1", _names(
        [spec["trunk"], spec["stage1"]]), trunk_s1)]
    for i in range(2, 7):
        cells.append((f"stage{i}", _names(spec["stages"][f"stage{i}"]),
                      stage(i)))
    return cells


_CELLS = {"body25": _b25_cells, "coco": _coco_cells, "hand": _hand_cells}
# a net's outputs, in forward()'s order, as keys of the last cell's state
OUT_KEYS = {"body25": ("paf", "heat"), "coco": ("a", "b"), "hand": ("out",)}


def cells(model_type: str, spec=None) -> List[Cell]:
    """The net's chain of cells (over ``spec``, default a fresh one)."""
    return _CELLS[model_type](spec or SPECS[model_type]())


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ConvLayer(nn.Module):
    """One conv + bias + activation with the reference's epilogue order.

    ``weight`` is OIHW, stored in the compute dtype once the net is cast
    (:meth:`CPM.cast`); ``bias`` and the PReLU slope stay f32 and are
    rounded to the epilogue dtype at use, as the JAX code does."""

    def __init__(self, c: Conv):
        super().__init__()
        self.spec = c
        self.weight = nn.Parameter(torch.zeros(c.cout, c.cin, c.k, c.k),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c.cout), requires_grad=False)
        self.prelu = (nn.Parameter(torch.full((c.cout,), 0.25),
                                   requires_grad=False)
                      if c.act == "prelu" else None)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype
                ) -> torch.Tensor:
        c = self.spec
        obs = quant.observer()          # int8 calibration hook
        if obs is not None:
            obs(c.name, x)
        w = self.weight.to(compute_dtype)
        xin = x.to(compute_dtype)
        if c.head:
            epi = torch.float32
            out = F.conv2d(xin.float(), w.float(), padding=c.pad)
        else:
            epi = compute_dtype
            out = F.conv2d(xin, w, padding=c.pad)
        out = out + self.bias.to(epi).view(1, -1, 1, 1)
        if c.act == "relu":
            out = torch.relu(out)
        elif c.act == "prelu":
            a = self.prelu.to(epi).view(1, -1, 1, 1)
            out = torch.where(out >= 0, out, a * out)
        return out


def maxpool2_int8(x_q: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool ("VALID": a last odd row or column dropped)
    of int8 NHWC [B,H,W,C]; it commutes with the monotone quantization."""
    b, h, w, c = x_q.shape
    x = x_q[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax((2, 4))


class CPM(nn.Module):
    """A CPM net (``"body25"``, ``"coco"`` or ``"hand"``) with caffe-named
    layers.

    ``forward`` takes NHWC input and returns NHWC f32 maps at /8:
    body25 -> (paf [B,h,w,52], heat [B,h,w,26]); coco -> (paf [B,h,w,38],
    heat [B,h,w,19]); hand -> heat [B,h,w,22].
    """

    def __init__(self, model_type: str):
        super().__init__()
        self.model_type = model_type
        self.spec = SPECS[model_type]()
        self.cells = cells(model_type, self.spec)
        self.layers = nn.ModuleDict(
            {c.name: ConvLayer(c) for c in conv_layers(model_type)})

    def load_params(self, state: Dict[str, Dict[str, torch.Tensor]]
                    ) -> "CPM":
        """Copy a port weight state ({name: {"w" OIHW, "b"[, "p"]}}); an
        entry with ``w_q`` makes its layer an int8 QConvLayer."""
        for name in list(self.layers):
            layer, entry = self.layers[name], state[name]
            if "w_q" in entry:
                self.layers[name] = quant.QConvLayer(layer.spec, entry)
                continue
            layer.weight.data = entry["w"].to(torch.float32).clone()
            layer.bias.data = entry["b"].to(torch.float32).clone()
            if layer.prelu is not None:
                layer.prelu.data = entry["p"].to(torch.float32).clone()
        return self

    def trainable(self) -> "CPM":
        """Make the conv weights, biases and PReLU slopes (kept f32: a
        trained net is never cast) require gradients."""
        if self.quantized:
            raise ValueError("int8 layers are inference-only: train the "
                             "float net, then quantize it")
        return self.requires_grad_(True)

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The float weights as a port weight state (f32 CPU tensors, what
        :meth:`load_params` takes)."""
        out = {}
        for name, layer in self.layers.items():
            if isinstance(layer, quant.QConvLayer):
                raise ValueError(f"{name} is an int8 layer")
            entry = {"w": layer.weight, "b": layer.bias}
            if layer.prelu is not None:
                entry["p"] = layer.prelu
            out[name] = {k: v.detach().float().cpu().clone()
                         for k, v in entry.items()}
        return out

    def cast(self, dtype: torch.dtype) -> "CPM":
        """Store conv weights in the compute dtype once (channels_last),
        so a step converts no weights; biases and slopes stay f32. Int8
        layers keep their int8 weights."""
        for layer in self.layers.values():
            if isinstance(layer, quant.QConvLayer):
                continue
            layer.weight.data = layer.weight.data.to(dtype).contiguous(
                memory_format=torch.channels_last)
        return self

    @property
    def quantized(self) -> bool:
        """Whether any layer is an int8 QConvLayer."""
        return any(isinstance(m, quant.QConvLayer)
                   for m in self.layers.values())

    # The wiring below reaches activations only through these three
    # (and the int8 chain of _seq); the striped net of
    # islx_torch/parallel/sharding.py overrides them to run on width
    # stripes.
    def _conv(self, x, name: str, cd):
        return self.layers[name](x, cd)

    def _pool(self, x, layer: Pool):
        return F.max_pool2d(x, layer.k, layer.s)

    def _cat(self, xs):
        return torch.cat(xs, dim=1)

    def _seq(self, x, layers: Sequence[Layer], cd):
        """A chain of convs and pools (islx/models/cpm.py:339-381): the
        activations stay int8 (NHWC) between consecutive quantized convs,
        and the pools between them run on int8."""
        n, i, x_q = len(layers), 0, None
        while i < n:
            layer = layers[i]
            if isinstance(layer, Pool):
                x = self._pool(x, layer)
                i += 1
                continue
            mod = self.layers[layer.name]
            if not isinstance(mod, quant.QConvLayer):
                x = self._conv(x, layer.name, cd)
                i += 1
                continue
            if x_q is None:
                x_q = mod.quantize(x)
            j = i + 1                           # next conv, skipping pools
            while j < n and isinstance(layers[j], Pool):
                j += 1
            nxt = self.layers[layers[j].name] if j < n else None
            if isinstance(nxt, quant.QConvLayer) and not layer.head:
                x_q = mod.core(x_q, cd, out_inv=nxt.inv)
                for _ in range(i + 1, j):
                    x_q = maxpool2_int8(x_q)
                i = j
            else:
                x = mod.core(x_q, cd).permute(0, 3, 1, 2)
                x_q = None
                i += 1
        return x

    def _dense_block(self, x, convs: Sequence[Conv], cd):
        outs = []
        for c in convs:
            x = self._conv(x, c.name, cd)
            outs.append(x)
        return self._cat(outs)

    def _b25_stage(self, x, s: int, L: str, cd):
        st = self.spec["stages"]
        for i in range(1, 6):
            x = self._dense_block(x, st[f"Mconv{i}_stage{s}_{L}"], cd)
        for c in st[f"Mconv6_7_stage{s}_{L}"]:      # unchained, as in islx
            x = self._conv(x, c.name, cd)
        return x

    def chain(self, x, cd, n: Optional[int] = None):
        """The state after each of the first ``n`` cells (all of them by
        default), NCHW."""
        state = {"x": x}
        for _, _, fn in self.cells[:n]:
            state = fn(self, state, cd)
            yield state

    def outputs(self, x, cd) -> Tuple:
        """NCHW -> the net's outputs, NCHW (:data:`OUT_KEYS`)."""
        *_, state = self.chain(x, cd)
        return tuple(state[k] for k in OUT_KEYS[self.model_type])

    def hand(self, x: torch.Tensor, cd, stages: int = 6) -> List[
            torch.Tensor]:
        """NCHW -> the heat NCHW of stages 1..``stages`` (the reference
        consumes the last)."""
        if not 1 <= stages <= 6:
            raise ValueError(f"hand stages must be in [1, 6], got {stages}")
        return [state["out"] for state in self.chain(x, cd, stages)]

    def forward(self, x_nhwc: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                stages: int = 6):
        # an NHWC tensor permuted to NCHW is channels_last already
        x = x_nhwc.permute(0, 3, 1, 2)
        with true_f32():
            if self.model_type in ("body25", "coco"):
                paf, heat = self.outputs(x, compute_dtype)
                return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)
            return self.hand(x, compute_dtype, stages)[-1].permute(
                0, 2, 3, 1)

    def hand_forward_stages(self, x_nhwc: torch.Tensor,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> List[torch.Tensor]:
        """All six hand stage heads, NHWC [B,h,w,22] each (training's deep
        supervision, islx/models/cpm.py:472-488)."""
        with true_f32():
            return [o.permute(0, 2, 3, 1) for o in
                    self.hand(x_nhwc.permute(0, 3, 1, 2), compute_dtype)]
