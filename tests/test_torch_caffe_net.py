"""The port's Caffe API (islx_torch.core.caffe_net: Net, Blob, SGDSolver)
against islx's (islx.core.caffe_net) on the same prototxt and the same
parameters (islx's lazily initialised ``net.params`` carried across), on
the CPU; each of islx's tests/test_caffe_net.py cases has a counterpart.

Tolerances: f32 outputs within rtol 1e-5 (atol 1e-6 where values cross
zero; the convolutions and reductions sum in another order); integer-
valued outputs (max pooling, shapes, ReLU of the same words, concat)
equal; solver losses and parameters after 3 steps within rtol 1e-5; a
blob with ``lr_mult: 0`` unchanged word for word.
"""
import h5py
import numpy as np
import pytest
import torch

import jax

from islx.core import caffe_net as JC
from islx_torch.core import caffe_net as TC
from test_torch_caffe import blob, caffemodel, layer

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _carry(params):
    """islx's ``net.params`` -> the port's (CPU tensors)."""
    return {n: {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in e.items()} for n, e in params.items()}


def _pair(path, phase=None, **inputs):
    """islx's Net and the port's on ``path``; islx's forward on ``inputs``
    initialises its params, which the port's net then takes. -> (islx net,
    port net, islx outputs, port outputs)."""
    kw = {} if phase is None else {"phase": phase}
    j = JC.Net(path, **kw)
    want = j.forward(**inputs)
    t = TC.Net(path, device="cpu", **kw)
    t.params = _carry(j.params)
    got = t.forward(**inputs)
    return j, t, want, got


def _close(got, want, exact=False):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


NET_PROTOTXT = """
name: "tiny"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1 }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer {
  name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
}
layer {
  name: "fc" type: "InnerProduct" bottom: "pool1" top: "fc"
  inner_product_param { num_output: 5 }
}
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


def test_prototxt_parser_matches_islx():
    texts = ['name: "n"  # comment\ninput_dim: 1 input_dim: 3\n'
             'layer { name: "a" flag: true x: 1.5 }\n'
             'layer { name: "b" pool: MAX }',
             NET_PROTOTXT,
             'layer { name: "q" param { lr_mult: 0 decay_mult: 2 } '
             'include { phase: TRAIN } s: "a b" f: False }']
    for text in texts:
        assert TC.parse_prototxt(text) == JC.parse_prototxt(text)
    with pytest.raises(ValueError, match="parse error"):
        TC.parse_prototxt("layer name")


def test_dataflow_and_blobs(tmp_path, rng):
    """Only the terminal blob is an output (the in-place ReLU keeps conv1
    a non-output); every blob is filled, with the NCHW accessors."""
    path = _write(tmp_path, "net.prototxt", NET_PROTOTXT)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    j, t, want, got = _pair(path, data=x)
    assert set(got) == {"prob"}
    _close(got, want)
    assert set(t.blobs) == set(j.blobs)
    for k in j.blobs:
        np.testing.assert_allclose(t.blobs[k].data,
                                   np.asarray(j.blobs[k].data), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert t.blobs["conv1"].channels == 4
    assert t.blobs["pool1"].height == t.blobs["pool1"].width == 4
    assert t.blobs["data"].num == 2 and t.blobs["pool1"].count() == 128
    assert t.blobs["pool1"].count(1) == 64
    np.testing.assert_allclose(got["prob"].sum(1), 1.0, rtol=1e-5)


def test_conv_matches_torch_and_islx(tmp_path, rng):
    path = _write(tmp_path, "net.prototxt", NET_PROTOTXT)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    j, t, _, _ = _pair(path, data=x)
    w = t.params["conv1"]["weight"]
    ref = torch.relu(torch.nn.functional.conv2d(
        torch.from_numpy(x), w, t.params["conv1"]["bias"], padding=1))
    np.testing.assert_allclose(t.blobs["conv1"].data, ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(t.blobs["conv1"].data,
                               np.asarray(j.blobs["conv1"].data), rtol=RTOL,
                               atol=ATOL)


def test_grouped_conv(tmp_path, rng):
    """group 2: weights [O, I/g, kh, kw] (caffemodel2pytorch.py:320-340)."""
    proto = """
input: "data"
layer {
  name: "gconv" type: "Convolution" bottom: "data" top: "gconv"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 group: 2
                      stride: 2 dilation: 1 }
}
"""
    path = _write(tmp_path, "g.prototxt", proto)
    x = rng.randn(2, 6, 9, 9).astype(np.float32)
    _, t, want, got = _pair(path, data=x)
    assert tuple(t.params["gconv"]["weight"].shape) == (4, 3, 3, 3)
    assert got["gconv"].shape == (2, 4, 5, 5)
    _close(got, want)


@pytest.mark.parametrize("pool,hw,k,s,pad,want_hw", [
    ("MAX", 7, 2, 2, 0, 4),     # ceil: (7-2)/2 -> 4 (floor mode: 3)
    ("MAX", 5, 2, 2, 1, 3),     # the pad clamp: 3, not ceil-only 4
    ("MAX", 8, 3, 2, 1, 5),
    ("AVE", 7, 3, 2, 0, 3),
    ("AVE", 6, 3, 2, 1, 4)])
def test_pool_sizing_and_pad_clamp(tmp_path, rng, pool, hw, k, s, pad,
                                   want_hw):
    proto = f"""
input: "data"
layer {{ name: "p" type: "Pooling" bottom: "data" top: "p"
        pooling_param {{ pool: {pool} kernel_size: {k} stride: {s}
                         pad: {pad} }} }}
"""
    path = _write(tmp_path, "p.prototxt", proto)
    x = rng.randn(1, 2, hw, hw).astype(np.float32)
    _, _, want, got = _pair(path, data=x)
    assert got["p"].shape == (1, 2, want_hw, want_hw)
    _close(got, want, exact=pool == "MAX")
    if pool == "MAX":            # torch's ceil_mode has caffe's rule
        ref = torch.nn.MaxPool2d(k, s, padding=pad, ceil_mode=True)(
            torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got["p"], ref)


def test_eltwise_concat_prelu(tmp_path, rng):
    proto = """
input: "a" input: "b"
layer { name: "s" type: "Eltwise" bottom: "a" bottom: "b" top: "s" }
layer { name: "m" type: "Eltwise" bottom: "a" bottom: "b" top: "m"
        eltwise_param { operation: MAX } }
layer { name: "x" type: "Eltwise" bottom: "a" bottom: "b" top: "x"
        eltwise_param { operation: PROD } }
layer { name: "w" type: "Eltwise" bottom: "a" bottom: "b" top: "w"
        eltwise_param { operation: SUM coeff: 0.5 coeff: -2.0 } }
layer { name: "c" type: "Concat" bottom: "s" bottom: "m" bottom: "x"
        bottom: "w" top: "c" }
layer { name: "pr" type: "PReLU" bottom: "c" top: "pr" }
"""
    path = _write(tmp_path, "e.prototxt", proto)
    a = rng.randn(1, 2, 3, 3).astype(np.float32)
    b = rng.randn(1, 2, 3, 3).astype(np.float32)
    _, t, want, got = _pair(path, a=a, b=b)
    _close(got, want, exact=True)
    cat = np.concatenate([a + b, np.maximum(a, b), a * b,
                          0.5 * a - 2.0 * b], axis=1)
    np.testing.assert_allclose(got["pr"], np.where(cat >= 0, cat, 0.25 * cat),
                               atol=1e-6)


def test_relu_slope_softmax_axis_lrn_dropout(tmp_path, rng):
    """ReLU's negative_slope, Softmax on another axis, LRN across
    channels, and Dropout in TEST (the identity)."""
    proto = """
input: "data"
layer { name: "r" type: "ReLU" bottom: "data" top: "r"
        relu_param { negative_slope: 0.1 } }
layer { name: "d" type: "Dropout" bottom: "r" top: "d"
        dropout_param { dropout_ratio: 0.5 } }
layer { name: "n" type: "LRN" bottom: "d" top: "n"
        lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 k: 2.0 } }
layer { name: "sm" type: "Softmax" bottom: "n" top: "sm"
        softmax_param { axis: 2 } }
"""
    path = _write(tmp_path, "r.prototxt", proto)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    _, t, want, got = _pair(path, data=x)
    _close(got, want)
    np.testing.assert_array_equal(t.blobs["d"].data, t.blobs["r"].data)
    np.testing.assert_allclose(got["sm"].sum(2), 1.0, rtol=1e-5)


def test_dropout_is_random_only_in_train(tmp_path, rng):
    """TRAIN: inverted dropout from the net's seeded generator (the same
    seed gives the same mask, another seed another); rate 0 and TEST are
    the identity, as islx's in both phases."""
    proto = """
input: "data"
layer { name: "d" type: "Dropout" bottom: "data" top: "d"
        dropout_param { dropout_ratio: %s } }
"""
    x = rng.rand(4, 8, 6, 6).astype(np.float32) + 0.5
    path = _write(tmp_path, "d.prototxt", proto % "0.25")
    outs = [TC.Net(path, phase=TC.TRAIN, device="cpu", seed=s).forward(
        data=x)["d"] for s in (3, 3, 4)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    kept = outs[0] != 0
    assert 0.65 < kept.mean() < 0.85
    np.testing.assert_allclose(outs[0][kept], x[kept] / 0.75, rtol=1e-6)
    for ratio, phase in (("0.0", TC.TRAIN), ("0.25", TC.TEST)):
        path = _write(tmp_path, "d.prototxt", proto % ratio)
        _, _, want, got = _pair(path, phase=phase, data=x)
        _close(got, want, exact=True)
        np.testing.assert_array_equal(got["d"], x)


def test_softmax_loss_spatial(tmp_path, rng):
    """SoftmaxWithLoss on [N,C,H,W] scores with [N,H,W] labels averages
    the NLL over batch and space (torch's cross_entropy 'mean')."""
    proto = """
input: "data"
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "data" bottom: "label"
        top: "loss" }
"""
    path = _write(tmp_path, "sl.prototxt", proto)
    x = rng.randn(2, 3, 4, 4).astype(np.float32)
    lbl = rng.randint(0, 3, size=(2, 4, 4)).astype(np.float32)
    _, _, want, got = _pair(path, data=x, label=lbl)
    _close(got, want)
    ref = float(torch.nn.functional.cross_entropy(
        torch.from_numpy(x), torch.from_numpy(lbl).long()))
    assert float(got["loss"]) == pytest.approx(ref, rel=1e-6)


def test_load_save_roundtrip(tmp_path, rng):
    """``save`` writes an .h5 both nets read; .npz, .pt and .caffemodel
    weights load into equal params on both sides."""
    path = _write(tmp_path, "net.prototxt", NET_PROTOTXT)
    x = rng.randn(1, 3, 8, 8).astype(np.float32)
    _, t, _, first = _pair(path, data=x)
    t.save(str(tmp_path / "w.h5"))
    with h5py.File(tmp_path / "w.h5") as h:
        assert sorted(h) == ["conv1.bias", "conv1.weight", "fc.bias",
                         "fc.weight"]
    flat = {f"{n}.{k}": v.numpy() for n, e in t.params.items()
            for k, v in e.items()}
    np.savez(tmp_path / "w.npz", **flat)
    torch.save({k: torch.from_numpy(v) for k, v in flat.items()},
               tmp_path / "w.pt")
    with open(tmp_path / "w.caffemodel", "wb") as f:
        f.write(caffemodel([(False, layer(n, [blob(flat[f"{n}.weight"]),
                                              blob(flat[f"{n}.bias"])]))
                            for n in ("conv1", "fc")]))
    for ext in ("h5", "npz", "pt", "caffemodel"):
        w = str(tmp_path / f"w.{ext}")
        t2 = TC.Net(path, weights=w, device="cpu")
        for n, e in t.params.items():
            for k, v in e.items():
                assert torch.equal(t2.params[n][k], v), (ext, n, k)
        np.testing.assert_array_equal(t2.forward(data=x)["prob"],
                                      first["prob"])
        if ext != "pt":        # islx reads .pt with weights_only=False
            j2 = JC.Net(path, weights=w)
            for n, e in t.params.items():
                for k, v in e.items():
                    np.testing.assert_array_equal(
                        np.asarray(j2.params[n][k]), v.numpy())


TRAIN_PROTOTXT = """
name: "trainable"
layer {
  name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  param { lr_mult: 1 } param { lr_mult: 2 }
  inner_product_param { num_output: 1 }
}
layer { name: "loss" type: "EuclideanLoss" bottom: "fc" bottom: "label"
        top: "loss" }
"""

FROZEN_PROTOTXT = """
layer {
  name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  param { lr_mult: 0 } param { lr_mult: 0 }
  inner_product_param { num_output: 1 }
}
layer { name: "loss" type: "EuclideanLoss" bottom: "fc" bottom: "label"
        top: "loss" }
"""

CONV_TRAIN_PROTOTXT = """
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
        param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
        convolution_param { num_output: 6 kernel_size: 3 pad: 1
                            weight_filler { type: "msra" } } }
layer { name: "p1" type: "PReLU" bottom: "c1" top: "c1" }
layer { name: "pool" type: "Pooling" bottom: "c1" top: "pool"
        pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "c2" type: "Convolution" bottom: "pool" top: "c2"
        param { lr_mult: 0 } param { lr_mult: 1 }
        convolution_param { num_output: 4 kernel_size: 1 group: 2 } }
layer { name: "r2" type: "ReLU" bottom: "c2" top: "c2" }
layer { name: "cat" type: "Concat" bottom: "c2" bottom: "pool" top: "cat" }
layer { name: "c3" type: "Convolution" bottom: "cat" top: "c3"
        convolution_param { num_output: 3 kernel_size: 3 pad: 1
                            weight_filler { type: "xavier" } } }
layer { name: "d" type: "Dropout" bottom: "c3" top: "c3"
        dropout_param { dropout_ratio: 0.0 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "c3" bottom: "label"
        top: "loss" loss_weight: 0.5 }
"""


def _solver(tmp_path, net_path, **kw):
    lines = [f'net: "{net_path}"', "base_lr: 0.05", "momentum: 0.9"]
    lines += [f"{k}: {v}" for k, v in kw.items()]
    return _write(tmp_path, "solver.prototxt", "\n".join(lines))


def _solver_pair(solver_path, **inputs):
    """islx's and the port's SGDSolver; islx's lazily initialised params
    carried across."""
    j = JC.SGDSolver(solver_path)
    j.net._ensure_params({k: np.asarray(v, np.float32)
                          for k, v in inputs.items()})
    t = TC.SGDSolver(solver_path, device="cpu")
    t.net.params = _carry(j.net.params)
    return j, t


def _params_close(t, j, rtol=RTOL):
    assert set(t.net.params) == set(j.net.params)
    for n, e in j.net.params.items():
        for k, v in e.items():
            np.testing.assert_allclose(t.net.params[n][k].detach().numpy(),
                                       np.asarray(v), rtol=rtol, atol=1e-7,
                                       err_msg=f"{n}.{k}")


@pytest.mark.parametrize("proto,kw", [
    (TRAIN_PROTOTXT, {}),
    (TRAIN_PROTOTXT, {"weight_decay": 0.01, "iter_size": 2}),
    (CONV_TRAIN_PROTOTXT, {"weight_decay": 0.005, "lr_policy": '"step"',
                           "stepsize": 2, "gamma": 0.5}),
], ids=["fc", "fc-decay-iter2", "conv-step"])
def test_solver_steps_match_islx(tmp_path, rng, proto, kw):
    """Losses and parameters after each of 3 steps within rtol 1e-5 of
    islx's, over momentum, weight decay, lr_mult/decay_mult, iter_size and
    the step policy."""
    net_path = _write(tmp_path, "train.prototxt", proto)
    if proto is TRAIN_PROTOTXT:
        x = rng.randn(16, 4).astype(np.float32)
        y = (x @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
             + 0.7).astype(np.float32)
    else:
        x = rng.randn(2, 3, 9, 9).astype(np.float32)
        y = rng.randint(0, 3, size=(2, 4, 4)).astype(np.float32)
    j, t = _solver_pair(_solver(tmp_path, net_path, **kw), data=x, label=y)
    for _ in range(3):
        want = j.step(1, data=x, label=y)
        got = t.step(1, data=x, label=y)
        assert got == pytest.approx(want, rel=RTOL)
        _params_close(t, j)
    assert t.iter == j.iter == 4


def test_loss_decreases_on_regression(tmp_path, rng):
    net_path = _write(tmp_path, "train.prototxt", TRAIN_PROTOTXT)
    solver = TC.SGDSolver(_solver(tmp_path, net_path), device="cpu")
    x = rng.randn(16, 4).astype(np.float32)
    y = (x @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
         + 0.7).astype(np.float32)
    first = solver.step(1, data=x, label=y)
    solver.step(150, data=x, label=y)
    last = solver.step(1, data=x, label=y)
    assert last < first * 0.05
    assert solver.iter == 153


def test_lr_mult_zero_freezes(tmp_path, rng):
    """lr_mult 0 keeps both blobs word for word, on both sides; in the
    conv net only c2's weight is frozen."""
    net_path = _write(tmp_path, "frozen.prototxt", FROZEN_PROTOTXT)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    j, t = _solver_pair(_solver(tmp_path, net_path), data=x, label=y)
    w0 = {k: v.clone() for k, v in t.net.params["fc"].items()}
    t.step(3, data=x, label=y)
    j.step(3, data=x, label=y)
    for k, v in w0.items():
        assert torch.equal(t.net.params["fc"][k], v), k
        np.testing.assert_array_equal(np.asarray(j.net.params["fc"][k]),
                                      v.numpy())
    net_path = _write(tmp_path, "conv.prototxt", CONV_TRAIN_PROTOTXT)
    x = rng.randn(2, 3, 9, 9).astype(np.float32)
    y = rng.randint(0, 3, size=(2, 4, 4)).astype(np.float32)
    j, t = _solver_pair(_solver(tmp_path, net_path), data=x, label=y)
    before = {n: {k: v.clone() for k, v in e.items()}
              for n, e in t.net.params.items()}
    t.step(2, data=x, label=y)
    for n, e in before.items():
        for k, v in e.items():
            frozen = (n, k) == ("c2", "weight")
            assert torch.equal(t.net.params[n][k], v) == frozen, (n, k)


def test_solver_backward_runs_without_tf32(tmp_path, rng, monkeypatch):
    """The solver's gradients are computed with cuDNN's TF32 off, as the
    forward is: each param's gradient hook sees allow_tf32 False (on the
    card a TF32 backward drifts from the CPU's updates by ~1e-2)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    net_path = _write(tmp_path, "conv.prototxt", CONV_TRAIN_PROTOTXT)
    x = rng.randn(2, 3, 9, 9).astype(np.float32)
    y = rng.randint(0, 3, size=(2, 4, 4)).astype(np.float32)
    solver = TC.SGDSolver(_solver(tmp_path, net_path), device="cpu")
    solver.step(1, data=x, label=y)
    seen = []
    for e in solver.net.params.values():
        for p in e.values():
            p.register_hook(
                lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    solver.step(1, data=x, label=y)
    assert seen and not any(seen)
    assert torch.backends.cudnn.allow_tf32


def test_step_lr_policy(tmp_path):
    net_path = _write(tmp_path, "train.prototxt", TRAIN_PROTOTXT)
    solver = TC.SGDSolver(_solver(tmp_path, net_path, lr_policy='"step"',
                                  stepsize=10, gamma=0.1), device="cpu")
    assert solver._lr() == pytest.approx(0.05)
    solver.iter = 25
    assert solver._lr() == pytest.approx(0.05 * 0.01)


def test_solver_batches_are_arguments(tmp_path, rng):
    """Another batch of the same shape gives another loss (the batch is
    not baked into the solver), and the velocity persists across calls."""
    net_path = _write(tmp_path, "train.prototxt", TRAIN_PROTOTXT)
    solver = TC.SGDSolver(_solver(tmp_path, net_path), device="cpu")
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    solver.step(1, data=x, label=y)
    v = solver._velocity[("fc", "weight")].clone()
    assert v.abs().sum() > 0
    l_a = solver.step(1, data=x, label=y)
    l_b = solver.step(1, data=x + 1.0, label=y)
    assert l_a != l_b


def test_lazy_init_is_seeded_and_fillers(tmp_path, rng):
    """Lazy init draws from the net's own seeded generator: the same seed
    gives the same params, another seed others; msra/xavier/gaussian
    scales; zero biases; PReLU slopes 0.25."""
    path = _write(tmp_path, "c.prototxt", CONV_TRAIN_PROTOTXT.replace(
        'layer { name: "loss"', 'layer { name: "x"').replace(
        'type: "SoftmaxWithLoss"', 'type: "Concat"').replace(
        ' bottom: "label"', ""))
    x = rng.randn(2, 3, 9, 9).astype(np.float32)
    nets = [TC.Net(path, device="cpu", seed=s) for s in (1, 1, 2)]
    for n in nets:
        n.forward(data=x)
    a, b, c = (n.params for n in nets)
    assert torch.equal(a["c1"]["weight"], b["c1"]["weight"])
    assert not torch.equal(a["c1"]["weight"], c["c1"]["weight"])
    assert float(a["c1"]["weight"].std()) == pytest.approx(
        np.sqrt(2.0 / 27), rel=0.3)
    assert float(a["c3"]["weight"].std()) == pytest.approx(
        np.sqrt(1.0 / (7 * 9)), rel=0.3)
    assert float(a["c2"]["weight"].abs().max()) < 0.05    # gaussian 0.01
    assert not a["c1"]["bias"].any()
    assert torch.equal(a["p1"]["weight"], torch.full((6,), 0.25))


def test_device_choice(tmp_path, monkeypatch):
    """No GPU and no request raises; set_mode_cpu chooses the CPU;
    set_mode_gpu (and set_device) the GPU, which raises here; an explicit
    device wins."""
    path = _write(tmp_path, "net.prototxt", NET_PROTOTXT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(TC._MODE, "device", None)
    with pytest.raises(RuntimeError, match="none is available"):
        TC.Net(path)
    TC.set_mode_cpu()
    assert TC.Net(path).device.type == "cpu"
    TC.set_mode_gpu()
    with pytest.raises(RuntimeError, match="none is available"):
        TC.Net(path)
    assert TC.Net(path, device="cpu").device.type == "cpu"
    TC.set_device(1)
    assert TC._MODE["device"] == "cuda:1"
    with pytest.raises(RuntimeError, match="none is available"):
        TC.SGDSolver(_solver(tmp_path, path))


def test_unknown_layers_are_skipped(tmp_path, rng, capsys):
    proto = NET_PROTOTXT + """
layer { name: "bn" type: "BatchNorm" bottom: "prob" top: "bn" }
layer { name: "in" type: "Input" top: "other" }
layer { name: "only_train" type: "ReLU" bottom: "prob" top: "t"
        include { phase: TRAIN } }
"""
    path = _write(tmp_path, "u.prototxt", proto)
    x = rng.randn(1, 3, 8, 8).astype(np.float32)
    _, t, want, got = _pair(path, data=x)
    assert "skipping layer [bn, BatchNorm]" in capsys.readouterr().out
    assert [layer.spec.name for layer in t.layers] == \
        ["conv1", "relu1", "pool1", "fc", "prob"]
    _close(got, want)


def test_islx_params_tree_is_carried(tmp_path, rng):
    """The carried params are islx's leaves, word for word."""
    path = _write(tmp_path, "net.prototxt", NET_PROTOTXT)
    j, t, _, _ = _pair(path, data=rng.randn(1, 3, 8, 8).astype(np.float32))
    leaves = jax.tree_util.tree_leaves(j.params)
    assert sum(v.numel() for e in t.params.values() for v in e.values()) \
        == sum(np.size(v) for v in leaves)
