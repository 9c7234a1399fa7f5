"""islx_torch's int8 W8A8 CPMs (islx_torch.models.quant, ops.conv_q) against
islx.models.quant on the CPU, on the same seeded inputs and weights.

Tolerances: the quantized weights, quantized activations and every int8
conv output word are equal (the conv sums exactly in both packages, and
the epilogue rounds at the same points: one FMA, then the activation,
then the conversion). Calibration runs the float nets, which the port
matches only to ~1e-5 (its f32 convs sum in another order), so the scales
agree within rtol 1e-4; the word-equal forwards carry islx's quantized
params across.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.models import cpm as JC
from islx.models import quant as JQ
from islx_torch.core import weights as W
from islx_torch.models import cpm as TC
from islx_torch.models import quant as TQ
from islx_torch.ops import conv_q as CQ


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores, and more threads a process
    oversubscribe them (six concurrent copies of a torch-only test ran
    ~10x slower with the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a) -> np.ndarray:
    """An array's bits as unsigned ints of its width (bf16 via f32)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(np.float32)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tnp(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.fixture(scope="module")
def float_params():
    """Full-width islx params of both nets (seeded), as numpy."""
    return {mt: jax.tree.map(np.asarray,
                             JC.init_params(mt, jax.random.PRNGKey(i + 1)))
            for i, mt in enumerate(("body25", "hand"))}


@pytest.fixture(scope="module")
def quantized(float_params):
    """islx's quantized params of both nets, calibrated on seeded inputs."""
    rng = np.random.RandomState(0)
    out = {}
    for mt, size in (("body25", 48), ("hand", 40)):
        x = rng.rand(2, size, size, 3).astype(np.float32) - 0.5
        out[mt] = jax.tree.map(np.asarray, JQ.quantize_model(
            float_params[mt], mt, [x]))
    return out


def test_quantize_params_words_equal(float_params):
    """w_q, s_w, a_scale, b and p equal islx's, with an all-zero weight
    (s_w 1), a scale below 1e-8 (clamped) and a skipped layer."""
    p = {n: dict(float_params["hand"][n])
         for n in ("conv1_1", "conv1_2", "conv2_1", "conv2_2")}
    p["conv1_2"]["w"] = np.zeros_like(p["conv1_2"]["w"])
    scales = {"conv1_1": 0.73, "conv1_2": 1e-9, "conv2_1": 3.2,
              "conv2_2": 11.0}
    want = jax.tree.map(np.asarray, JQ.quantize_params(p, scales,
                                                       skip=["conv2_2"]))
    got = W.to_islx_params(TQ.quantize_params(W.from_islx_params(p), scales,
                                              skip=["conv2_2"]))
    assert "w" in got["conv2_2"] and "w_q" in got["conv2_1"]
    for name, entry in want.items():
        assert sorted(entry) == sorted(got[name])
        for k, v in entry.items():
            assert got[name][k].dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(_words(got[name][k]), _words(v))


def test_quantize_act_words_equal():
    """int8 words == islx's jitted quantize_act, f32 and bf16 inputs, at
    scales including islx's 1e-8 floor; the factor 127/a_scale is XLA's
    true quotient."""
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 33, 17, 26) * 3).astype(np.float32)
    x.flat[::97] = 0.5 + np.arange(x.size)[::97] % 7   # ties at 127
    f = jax.jit(JQ.quantize_act)
    for a in (np.float32(1.0), np.float32(2.7), np.float32(127.0),
              np.float32(9.31e-3), np.float32(1e-8)):
        assert TQ.act_inv(a) == float(jax.jit(lambda s: 127.0 / s)(a))
        for dt, tdt in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
            xj = jnp.asarray(x, dt)
            want = np.asarray(f(xj, jnp.asarray(a)))
            got = TQ.quantize_act(torch.from_numpy(np.array(
                xj.astype(jnp.float32))).to(tdt), TQ.act_inv(a))
            np.testing.assert_array_equal(got.numpy(), want)


def test_epilogue_scale_is_xlas():
    """The epilogue factor == islx's ``s_w * (a_scale / 127.0)`` as XLA
    compiles it, which multiplies by f32(1/127): a true division gives
    other words for ~4% of the scales."""
    rng = np.random.RandomState(5)
    s_w = (rng.rand(64) * 0.02).astype(np.float32)
    a = (rng.rand(400) * 20).astype(np.float32)
    f = jax.jit(lambda s, v: (s * (v / 127.0)).astype(jnp.float32))
    want = np.stack([np.asarray(f(s_w, v)) for v in a])
    got = np.stack([TQ.epilogue_scale(s_w, v) for v in a])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    div = np.stack([s_w * (v / np.float32(127.0)) for v in a])
    assert (div != want).any()


def _layer(rng, cin, cout, k, act, head):
    """A seeded conv quantized by islx (scale from its input's max|x|):
    -> (islx Conv, islx quantized params, port QConvLayer, input x)."""
    x = (rng.randn(2, 23, 19, cin) * 1.5).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
         ).astype(np.float32)
    entry = {"w": w, "b": (rng.randn(cout) * 0.3).astype(np.float32)}
    if act == "prelu":
        entry["p"] = rng.uniform(0.05, 0.5, cout).astype(np.float32)
    c = JC.Conv("c", cin, cout, k, (k - 1) // 2, act, head=head)
    qp = jax.tree.map(np.asarray, JQ.quantize_params(
        {"c": entry}, {"c": float(np.abs(x).max())}))["c"]
    layer = TQ.QConvLayer(TC.Conv("c", cin, cout, k, (k - 1) // 2, act,
                                  head=head),
                          W.from_islx_params({"c": qp})["c"])
    return c, qp, layer, x


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("act", ["relu", "prelu", "none"])
@pytest.mark.parametrize("out", ["f32", "bf16", "int8"])
def test_conv_q_core_words_equal(k, act, out):
    """QConvLayer.core (conv_q_plain on the CPU) == islx's jitted conv_q_core,
    word for word, on 2x23x19x128 = 111,872 outputs a case: f32 (head),
    bf16 (unchained, compute dtype) and int8 (chained) outputs; a missing
    FMA in the epilogue changes ~28% of the f32 words."""
    rng = np.random.RandomState(k * 10 + len(act))
    c, qp, layer, x = _layer(rng, 26, 128, k, act, head=(out == "f32"))
    x_q = np.array(jax.jit(JQ.quantize_act)(jnp.asarray(x),
                                            jnp.asarray(qp["a_scale"])))
    nxt = np.float32(2.9)                    # the next conv's a_scale
    pj = {n: jnp.asarray(v) for n, v in qp.items()}
    if out == "int8":
        want = jax.jit(lambda xq, p, s: JQ.conv_q_core(
            xq, p, c, jnp.bfloat16, out_inv=127.0 / s))(
                jnp.asarray(x_q), pj, jnp.asarray(nxt))
        got = layer.core(torch.from_numpy(x_q), torch.bfloat16,
                         out_inv=TQ.act_inv(nxt))
    else:
        want = jax.jit(lambda xq, p: JQ.conv_q_core(
            xq, p, c, jnp.bfloat16))(jnp.asarray(x_q), pj)
        got = layer.core(torch.from_numpy(x_q), torch.bfloat16)
    want = np.asarray(want)
    assert got.shape == want.shape and want.size >= 10 ** 5
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(_words(_tnp(got)), _words(want))
    # the first conv of a net quantizes its f32 input as it is
    q = layer.quantize(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert q.shape[-1] == CQ.channel_stride(26)
    np.testing.assert_array_equal(q[..., :26].numpy(), x_q)


@pytest.mark.parametrize("mt", ["body25", "hand"])
@pytest.mark.parametrize("out", ["f32", "bf16", "int8"])
def test_patch_conv1_1_words_equal(quantized, mt, out):
    """conv1_1 of both nets (3x3 over 3 channels) in patch mode: the
    quantized 3x3x3 neighbourhoods ([B,H,W,32], zero outside the frame
    and in channels 27-31) through the weights packed as a 1x1 conv over 27
    inputs == islx's jitted conv_q_core on its quantize_act, word for word,
    in f32 (as a head), bf16 and int8 (chained) outputs, on an odd map."""
    qp = quantized[mt]["conv1_1"]
    c = JC.Conv("conv1_1", 3, 64, 3, 1, "relu", head=(out == "f32"))
    layer = TQ.QConvLayer(TC.Conv("conv1_1", 3, 64, 3, 1, "relu",
                                  head=(out == "f32")),
                          W.from_islx_params({"conv1_1": qp})["conv1_1"])
    assert layer.patch == 3 and layer.cin == 27
    assert tuple(layer.w_pack.shape) == (128, 1, 32)
    x = (np.random.RandomState(7).rand(2, 29, 37, 3) - 0.5).astype(
        np.float32)
    pj = {n: jnp.asarray(v) for n, v in qp.items()}
    x_q = np.asarray(jax.jit(JQ.quantize_act)(jnp.asarray(x),
                                              pj["a_scale"]))
    patches = layer.quantize(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert patches.shape == (2, 29, 37, 32) and patches.dtype == torch.int8
    pad = np.pad(x_q, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want_p = np.concatenate([pad[:, ky:ky + 29, kx:kx + 37]
                             for ky in range(3) for kx in range(3)], -1)
    np.testing.assert_array_equal(patches[..., :27].numpy(), want_p)
    assert not patches[..., 27:].any()
    nxt = np.float32(1.7)
    if out == "int8":
        want = jax.jit(lambda xq, p, s: JQ.conv_q_core(
            xq, p, c, jnp.bfloat16, out_inv=127.0 / s))(
                jnp.asarray(x_q), pj, jnp.asarray(nxt))
        got = layer.core(patches, torch.bfloat16, out_inv=TQ.act_inv(nxt))
    else:
        want = jax.jit(lambda xq, p: JQ.conv_q_core(xq, p, c, jnp.bfloat16))(
            jnp.asarray(x_q), pj)
        got = layer.core(patches, torch.bfloat16)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 29, 37, 64)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(_words(_tnp(got)), _words(want))
    with pytest.raises(ValueError):         # a chained int8 input
        layer.core(torch.zeros(2, 29, 37, 64, dtype=torch.int8),
                   torch.bfloat16)


@pytest.mark.parametrize("mt,size", [("hand", (37, 29)),
                                     ("body25", (43, 35))])
def test_int8_forwards_word_equal_with_patch_path(quantized, mt, size):
    """The int8 forwards with conv1_1 in patch mode, on maps of odd sizes
    (the patches' zero border on every side of the frame): every output
    word equal to islx's jitted forward, in bf16 compute."""
    x = (np.random.RandomState(8).rand(1, *size, 3) - 0.5).astype(
        np.float32)
    kw = {"stages": 2} if mt == "hand" else {}
    want = jax.jit(lambda p, v: JC.FORWARDS[mt](p, v, jnp.bfloat16, **kw))(
        quantized[mt], jnp.asarray(x))
    net = W.build(mt, W.from_islx_params(quantized[mt]), torch.device("cpu"),
                  torch.bfloat16)
    assert net.layers["conv1_1"].patch == 3
    with torch.inference_mode():
        got = net(torch.from_numpy(x), torch.bfloat16, **kw)
    if mt == "hand":
        want, got = [want], [got]
    for wv, gv in zip(want, got):
        assert gv.shape == wv.shape
        np.testing.assert_array_equal(_words(gv.numpy()), _words(wv))


@pytest.mark.parametrize("mt,size,percentile", [("hand", 40, None),
                                                ("body25", 48, None),
                                                ("hand", 40, 99.0)])
def test_calibrate_scales_matches_islx(float_params, mt, size, percentile):
    """Each conv input's max|x| (or 99th percentile of |x|) within rtol 1e-4
    of islx's, on the same float weights and inputs."""
    x = np.random.RandomState(2).rand(2, size, size, 3).astype(np.float32)
    x -= 0.5
    want = JQ.calibrate_scales(float_params[mt], mt, [x],
                               percentile=percentile)
    got = TQ.calibrate_scales(W.from_islx_params(float_params[mt]), mt, [x],
                              percentile=percentile, device="cpu")
    assert sorted(got) == sorted(want) == sorted(
        c.name for c in TC.conv_layers(mt))
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=1e-4, err_msg=name)


def test_chaining_map_matches_islx(monkeypatch, quantized):
    """Which convs write int8 (chained), f32 (heads) or the compute dtype,
    in call order, per net, equal islx's; every conv is quantized."""
    calls = {"islx": [], "port": []}
    j_core, t_core = JQ.conv_q_core, TQ.QConvLayer.core

    def j_rec(x_q, p, c, *a, **kw):
        out = j_core(x_q, p, c, *a, **kw)
        calls["islx"].append((c.name, str(out.dtype)))
        return out

    def t_rec(self, *a, **kw):
        out = t_core(self, *a, **kw)
        calls["port"].append((self.spec.name, str(out.dtype).split(".")[1]))
        return out

    monkeypatch.setattr(JQ, "conv_q_core", j_rec)
    monkeypatch.setattr(TQ.QConvLayer, "core", t_rec)
    x = np.random.RandomState(3).rand(1, 16, 16, 3).astype(np.float32) - 0.5
    for mt in ("body25", "hand"):
        calls["islx"].clear()
        calls["port"].clear()
        JC.FORWARDS[mt](quantized[mt], jnp.asarray(x), jnp.bfloat16)
        net = W.build(mt, W.from_islx_params(quantized[mt]),
                      torch.device("cpu"), torch.bfloat16)
        with torch.inference_mode():
            net(torch.from_numpy(x), torch.bfloat16)
        assert calls["port"] == calls["islx"]
        assert len(calls["port"]) == len(TC.conv_layers(mt))
        kinds = [k for _, k in calls["port"]]
        assert {"int8", "float32", "bfloat16"} <= set(kinds)
    # the hand net's trunk chains all but its last conv (fused step's
    # 160 px crops: 14 int8 outputs before conv5_3_CPM's bf16)
    assert kinds[:15] == ["int8"] * 14 + ["bfloat16"]


@pytest.mark.parametrize("mt,size", [("hand", 40), ("body25", 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forwards_word_equal(quantized, mt, size, dtype):
    """hand_forward (5 stages) and body25_forward with islx's quantized
    params carried across: every output map word equal to islx's jitted
    forward, in f32 and bf16 compute."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = {"stages": 5} if mt == "hand" else {}
    x = np.random.RandomState(4).rand(2, size, size, 3).astype(np.float32)
    x -= 0.5
    want = jax.jit(lambda p, v: JC.FORWARDS[mt](p, v, jdt, **kw))(
        quantized[mt], jnp.asarray(x))
    net = W.build(mt, W.from_islx_params(quantized[mt]), torch.device("cpu"),
                  tdt)
    assert net.quantized
    with torch.inference_mode():
        got = net(torch.from_numpy(x), tdt, **kw)
    if mt == "hand":
        want, got = [want], [got]
    for wv, gv in zip(want, got):
        assert gv.dtype == torch.float32 and gv.shape == wv.shape
        np.testing.assert_array_equal(_words(gv.numpy()), _words(wv))
        assert np.isfinite(gv.numpy()).all() and gv.abs().max() > 0


def test_quantized_tree_round_trips(quantized):
    """to_islx_params(from_islx_params(q)) == q for a quantized tree: same
    keys, dtypes and words (w_q HWIO int8 <-> the port's OIHW)."""
    for mt, q in quantized.items():
        state = W.from_islx_params(q)
        assert state["conv1_1"]["w_q"].dtype == torch.int8
        assert tuple(state["conv1_1"]["w_q"].shape) == (64, 3, 3, 3)
        back = W.to_islx_params(state)
        assert sorted(back) == sorted(q)
        for name, entry in q.items():
            assert sorted(back[name]) == sorted(entry)
            for k, v in entry.items():
                assert back[name][k].dtype == v.dtype
                np.testing.assert_array_equal(back[name][k], v)


def test_build_keeps_int8_and_casts_float_layers(quantized, float_params):
    """build: quantized layers keep int8 weights whatever the compute
    dtype; float layers of a partly quantized state are cast."""
    state = W.from_islx_params(quantized["hand"])
    state["conv1_1"] = W.from_islx_params(
        {"conv1_1": float_params["hand"]["conv1_1"]})["conv1_1"]
    net = W.build("hand", state, torch.device("cpu"), torch.bfloat16)
    assert isinstance(net.layers["conv1_1"], TC.ConvLayer)
    assert net.layers["conv1_1"].weight.dtype == torch.bfloat16
    q = net.layers["Mconv1_stage2"]           # 7x7, 150 -> 128
    w_q = state["Mconv1_stage2"]["w_q"]
    assert isinstance(q, TQ.QConvLayer)
    assert q.w_pack.shape == (128, 49, 160) and q.w_pack.dtype == torch.int8
    np.testing.assert_array_equal(
        q.w_pack[:, :, :150].reshape(128, 7, 7, 150).numpy(),
        w_q.permute(0, 2, 3, 1).numpy())
    assert not q.w_pack[:, :, 150:].any()
    assert torch.equal(CQ.unpack_weights(q.w_pack, 150, 128), w_q)
