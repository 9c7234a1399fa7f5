"""islx_torch nets against islx on the same weights (CPU): BODY_25 and hand
CPM forwards (f32 with TF32 off, and bf16), the conv epilogue order, and
the masked BiLSTM translation head."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.models import cpm as JC
from islx.models import translator as JT
from islx_torch.core import weights as W
from islx_torch.models import cpm as TC
from islx_torch.models import translator as TT

_CD = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


def _params(model_type, seed):
    return jax.tree.map(np.asarray,
                        JC.init_params(model_type, jax.random.PRNGKey(seed)))


def _net(model_type, params, cd):
    return TC.CPM(model_type).load_params(W.from_islx_params(params)).cast(cd)


def test_spec_tables_equal():
    for mt in ("body25", "hand"):
        want = [(c.name, c.cin, c.cout, c.k, c.pad, c.act, c.head)
                for c in JC.conv_layers(mt)]
        got = [(c.name, c.cin, c.cout, c.k, c.pad, c.act, c.head)
               for c in TC.conv_layers(mt)]
        assert want == got


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("head", [False, True])
def test_conv_epilogue_order(rng, cd, head):
    """One conv: non-head rounds to the compute dtype before bias+act, head
    keeps an f32 epilogue. f32: summation order only (atol 1e-5); bf16:
    within one bf16 rounding of the output (rtol 2^-7)."""
    jcd, tcd = _CD[cd]
    c = JC.Conv("conv4_2", 16, 24, 3, 1, "prelu", head=head)
    p = {"w": rng.randn(3, 3, 16, 24).astype(np.float32) * 0.3,
         "b": rng.randn(24).astype(np.float32) * 0.1,
         "p": rng.rand(24).astype(np.float32)}
    x = rng.randn(2, 9, 7, 16).astype(np.float32)
    want = np.asarray(JC._conv(jnp.asarray(x), p, c, jcd)).astype(np.float32)
    layer = TC.ConvLayer(TC.Conv(c.name, 16, 24, 3, 1, "prelu", head=head))
    layer.weight.data = torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())
    layer.bias.data = torch.from_numpy(p["b"])
    layer.prelu.data = torch.from_numpy(p["p"])
    layer.weight.data = layer.weight.data.to(tcd)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2), tcd)
    assert got.dtype == (torch.float32 if head else tcd)
    got = got.permute(0, 2, 3, 1).float().numpy()
    if cd == "f32":
        np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(want, got, rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("model_type,shape,stages",
                         [("body25", (2, 32, 40, 3), 6),
                          ("hand", (2, 48, 48, 3), 6),
                          ("hand", (2, 48, 48, 3), 5)])
def test_cpm_forward_f32(rng, model_type, shape, stages):
    """Full-width nets, f32 (TF32 off): summation order only, atol 2e-5 on
    maps of magnitude ~1."""
    p = _params(model_type, 3)
    x = rng.rand(*shape).astype(np.float32) - 0.5
    net = _net(model_type, p, torch.float32)
    with torch.no_grad():
        if model_type == "body25":
            want = JC.body25_forward(p, jnp.asarray(x))
            got = net(torch.from_numpy(x))
        else:
            want = (JC.hand_forward(p, jnp.asarray(x), stages=stages),)
            got = (net(torch.from_numpy(x), torch.float32, stages),)
    for a, b in zip(want, got):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=2e-5)


def test_cpm_forward_bf16_body25(rng):
    """bf16 compute: the two frameworks round at the same points but sum in
    other orders, so over ~60 layers the maps drift; held to 3% of the
    reference's largest magnitude, and 0.5% on average."""
    p = _params("body25", 4)
    x = rng.rand(2, 32, 40, 3).astype(np.float32) - 0.5
    want = JC.body25_forward(p, jnp.asarray(x), jnp.bfloat16)
    with torch.no_grad():
        got = _net("body25", p, torch.bfloat16)(torch.from_numpy(x),
                                                torch.bfloat16)
    for a, b in zip(want, got):
        a = np.asarray(a).astype(np.float32)
        assert b.dtype == torch.float32
        d = np.abs(a - b.numpy())
        scale = np.abs(a).max()
        assert d.max() <= 0.03 * scale, (d.max(), scale)
        assert d.mean() <= 0.005 * scale, (d.mean(), scale)


def test_hand_stages_out_of_range():
    with pytest.raises(ValueError):
        TC.CPM("hand")(torch.zeros(1, 16, 16, 3), torch.float32, 7)


def _head_inputs(rng, b=5):
    x = rng.randn(b, 20, 156).astype(np.float32) * 30
    x[1, 15:] = 0.0                     # masked tail
    x[2, :4] = 0.0                      # masked head
    x[3, 7] = 0.0                       # masked middle step
    x[4] = 0.0                          # all masked
    return x


def test_translator_head_matches(rng):
    """BiLSTM head on islx's params, windows with masked steps: atol 1e-5."""
    params = jax.tree.map(np.asarray, JT.init_params())
    # non-trivial BN statistics
    for name, dim in (("bn0", 156), ("bn1", 32), ("bn2", 32)):
        params[name]["mean"] = rng.randn(dim).astype(np.float32)
        params[name]["var"] = rng.rand(dim).astype(np.float32) + 0.5
    x = _head_inputs(rng)
    want = np.asarray(JT.forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = TT.build_head(params, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(want, got, atol=1e-5)
    np.testing.assert_array_equal(want.argmax(-1), got.argmax(-1))


def test_translator_head_npz_roundtrip(rng, tmp_path):
    params = jax.tree.map(np.asarray, JT.init_params(
        key=jax.random.PRNGKey(7)))
    JT.save_npz(str(tmp_path / "head.npz"), params)
    loaded = TT.load_npz(str(tmp_path / "head.npz"))
    assert loaded.keys() == params.keys()
    x = _head_inputs(rng)
    want = np.asarray(JT.forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = TT.build_head(loaded, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(want, got, atol=1e-5)


def test_translator_seeded_init():
    a, b = TT.init_params(seed=1), TT.init_params(seed=1)
    ref = jax.tree.map(np.asarray, JT.init_params())
    assert a.keys() == ref.keys()
    for name in a:
        assert a[name].keys() == ref[name].keys()
        for k in a[name]:
            assert a[name][k].shape == ref[name][k].shape
            np.testing.assert_array_equal(a[name][k], b[name][k])
