"""CPM training on the CPU: islx_torch.models.pose_train against
islx.models.pose_train on the same seeded inputs, targets and full-width
weights (islx's init carried across), at 24x24 (3x3 maps).

Tolerances, and why:
- targets: word-equal (the same numpy arithmetic);
- hand stage heads (f32): rtol 1e-4, atol 1e-5 (convs summed in another
  order, tests/test_torch_pose.py's);
- f32 loss: rtol 1e-5; f32 gradients: each tensor within 1e-4 of its
  largest magnitude (the backward's sums in another order; measured
  <= 1.1e-5);
- bf16: the loss within rtol 5e-4 of islx's bf16 loss; the whole gradient
  within 0.2 of JAX's bf16 gradient in norm, cosine >= 0.98. bf16 rounding
  alone moves JAX's own gradient 0.04-0.15 from its f32 gradient at these
  sizes (random full-depth nets), and the port's rounds in other places.

JAX 0.9.0 has no transpose for islx's bf16 conv (``conv_general_dilated``
on bf16 operands with ``preferred_element_type=f32``,
islx/models/cpm.py:305): ``jax.grad`` of islx's bf16 ``loss_fn`` raises
``TypeError``. The bf16 reference here is that same function with the
transpose supplied: the exact f32 products of the cotangent and the bf16
operands, rounded to the operand's bf16 (ROADMAP.md §3).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.models import cpm as JC
from islx.models import pose_train as JPT
from islx_torch.core import weights as W
from islx_torch.models import cpm
from islx_torch.models import pose_train as PT
from islx_torch.models import quant

S = 24
CASES = [("hand", 0.0, False), ("hand", 2.0, True), ("body25", 0.0, False),
         ("body25", 2.0, False)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_with_bf16_transpose(orig):
    """``conv_general_dilated`` whose bf16-operand, f32-result form has a
    VJP: the f32 convolutions of the cotangent with the operands, rounded
    to the operands' dtype."""

    def conv(lhs, rhs, window_strides, padding, dimension_numbers=None,
             preferred_element_type=None, **kw):
        if preferred_element_type is None or \
                lhs.dtype == preferred_element_type:
            return orig(lhs, rhs, window_strides, padding,
                        dimension_numbers=dimension_numbers,
                        preferred_element_type=preferred_element_type, **kw)
        f = functools.partial(orig, window_strides=window_strides,
                              padding=padding,
                              dimension_numbers=dimension_numbers, **kw)

        @jax.custom_vjp
        def c(a, b):
            return f(a, b, preferred_element_type=preferred_element_type)

        def fwd(a, b):
            return c(a, b), (a, b)

        def bwd(res, ct):
            a, b = res
            _, vjp = jax.vjp(f, a.astype(ct.dtype), b.astype(ct.dtype))
            ga, gb = vjp(ct)
            return ga.astype(a.dtype), gb.astype(b.dtype)

        c.defvjp(fwd, bwd)
        return c(lhs, rhs)

    return conv


def samples(model_type, seed, b=2, size=S):
    """Seeded inputs and targets from two people's keypoints a sample,
    a fifth of the joints invisible."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, size, size, 3).astype(np.float32) - 0.5
    j = 21 if model_type == "hand" else 25
    heats, pafs = [], []
    for _ in range(b):
        kp = rng.rand(2, j, 2).astype(np.float32) * (size - 2) + 1
        heat, paf = PT.pose_targets(kp, rng.rand(2, j) > 0.2, size // 8,
                                    size // 8, model_type)
        heats.append(heat)
        pafs.append(paf if paf is not None
                    else np.zeros((size // 8, size // 8, 0), np.float32))
    return x, np.stack(heats).astype(np.float32), \
        np.stack(pafs).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """islx's f32 loss and gradients, and its bf16 loss and gradient
    with the conv transpose supplied (the forward is islx's own), for
    every case."""
    out = {}
    params = {mt: jax.tree.map(np.asarray,
                               JC.init_params(mt, jax.random.PRNGKey(1)))
              for mt in ("hand", "body25")}
    grad = jax.jit(jax.value_and_grad(JPT.loss_fn, has_aux=True),
                   static_argnums=(4, 5, 6, 7))
    for mt, pw, deep in CASES:
        x, heat, paf = samples(mt, 0)
        args = (params[mt], jnp.asarray(x), jnp.asarray(heat),
                jnp.asarray(paf), mt)
        (l32, _), g32 = grad(*args, jnp.float32, pw, deep)
        out[mt, pw, deep] = dict(x=x, heat=heat, paf=paf, loss32=float(l32),
                                 grads32=jax.tree.map(np.asarray, g32))
    orig = jax.lax.conv_general_dilated
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "conv_general_dilated",
                   _conv_with_bf16_transpose(orig))
        grad16 = jax.jit(jax.value_and_grad(JPT.loss_fn, has_aux=True),
                         static_argnums=(4, 5, 6, 7))
        for (mt, pw, deep), ref in out.items():
            (l16, _), g16 = grad16(params[mt], jnp.asarray(ref["x"]),
                                   jnp.asarray(ref["heat"]),
                                   jnp.asarray(ref["paf"]), mt, jnp.bfloat16,
                                   pw, deep)
            ref["loss16"] = float(l16)
            ref["grads16"] = jax.tree.map(np.asarray, g16)
    return params, out


def port_grads(model_type, params, ref, dtype, pw, deep):
    state = PT.init_state(model_type, params=W.from_islx_params(params),
                          device="cpu")
    loss, metrics = PT.loss_fn(state.net, torch.from_numpy(ref["x"]),
                               torch.from_numpy(ref["heat"]),
                               torch.from_numpy(ref["paf"]), model_type,
                               dtype, pw, deep)
    loss.backward()
    grads = {}
    for name, layer in state.net.layers.items():
        entry = {"w": layer.weight.grad.numpy().transpose(2, 3, 1, 0),
                 "b": layer.bias.grad.numpy()}
        if layer.prelu is not None:
            entry["p"] = layer.prelu.grad.numpy()
        grads[name] = entry
    return float(metrics["loss"]), grads


@pytest.mark.parametrize("model_type,pos_weight,deep", CASES)
def test_f32_loss_and_gradients_match_jax_grad(reference, model_type,
                                               pos_weight, deep):
    params, out = reference
    ref = out[model_type, pos_weight, deep]
    loss, grads = port_grads(model_type, params[model_type], ref,
                             torch.float32, pos_weight, deep)
    np.testing.assert_allclose(loss, ref["loss32"], rtol=1e-5)
    assert set(grads) == set(ref["grads32"])
    for name, entry in ref["grads32"].items():
        assert set(grads[name]) == set(entry), name
        for k, want in entry.items():
            np.testing.assert_allclose(grads[name][k], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("model_type,pos_weight,deep", CASES)
def test_bf16_loss_and_gradients_match_jax(reference, model_type,
                                           pos_weight, deep):
    params, out = reference
    ref = out[model_type, pos_weight, deep]
    loss, grads = port_grads(model_type, params[model_type], ref,
                             torch.bfloat16, pos_weight, deep)
    np.testing.assert_allclose(loss, ref["loss16"], rtol=5e-4)
    names = sorted(ref["grads16"])
    got = np.concatenate([grads[n][k].ravel() for n in names
                          for k in sorted(grads[n])])
    want = np.concatenate([ref["grads16"][n][k].ravel() for n in names
                           for k in sorted(grads[n])])
    assert np.isfinite(got).all()
    cos = got @ want / np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.98, cos
    assert np.linalg.norm(got - want) <= 0.2 * np.linalg.norm(want)


def test_pos_weight_and_deep_supervision_change_the_loss(reference):
    """The weighted and the deep-supervised losses are other functions
    than the plain one (a background-only weight would not move)."""
    _, out = reference
    plain = out["hand", 0.0, False]["loss32"]
    weighted = out["hand", 2.0, True]["loss32"]
    assert weighted > plain * 1.5
    x, heat, _ = samples("hand", 0)
    t = torch.from_numpy(heat)
    pred = torch.zeros_like(t)
    w0 = PT._weighted_heat_mse(pred, t, 0.0)
    w1 = PT._weighted_heat_mse(pred, t, 2.0)
    bg_only = t.clone()
    bg_only[..., :-1] = 0.0
    assert float(w1) > float(w0)
    assert float(PT._weighted_heat_mse(pred, bg_only, 2.0)) == \
        float(PT._weighted_heat_mse(pred, bg_only, 0.0))


def test_hand_forward_stages_match_islx(reference):
    params, out = reference
    x = out["hand", 0.0, False]["x"]
    want = JC.hand_forward_stages(params["hand"], jnp.asarray(x))
    net = cpm.CPM("hand").load_params(W.from_islx_params(params["hand"]))
    with torch.no_grad():
        got = net.hand_forward_stages(torch.from_numpy(x))
        last = net(torch.from_numpy(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert torch.equal(last, got[-1])


def test_training_keeps_f32_master_weights():
    """A bf16 step leaves f32 weights that moved, and trains every conv."""
    state = PT.init_state("hand", params=W.init_params("hand", 3),
                          device="cpu")
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    x, heat, paf = samples("hand", 5)
    step = PT.make_train_step(state, "hand", torch.bfloat16)
    metrics = step(torch.from_numpy(x), torch.from_numpy(heat),
                   torch.from_numpy(paf))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    for k, v in state.net.state_dict().items():
        assert v.dtype == torch.float32, k
        assert not torch.equal(v, before[k]), k


def test_training_a_quantized_net_raises():
    state = W.init_params("hand")
    q = quant.quantize_params(state, {n: 1.0 for n in state})
    with pytest.raises(ValueError, match="inference-only"):
        PT.init_state("hand", params=q, device="cpu")
    net = cpm.CPM("hand").load_params(q)
    with pytest.raises(ValueError, match="inference-only"):
        net.trainable()
    with pytest.raises(ValueError, match="int8"):
        net.state()


def test_gaussian_heatmap_targets_word_equal():
    rng = np.random.RandomState(2)
    kp = rng.rand(3, 25, 2).astype(np.float32) * 180
    vis = rng.rand(3, 25) > 0.3
    want = JPT.gaussian_heatmap_targets(kp, vis, 23, 18)
    got = PT.gaussian_heatmap_targets(kp, vis, 23, 18)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for kw in (dict(stride=4, sigma=3.0), dict(sigma=11.0)):
        assert np.array_equal(PT.gaussian_heatmap_targets(kp, vis, 9, 7,
                                                          **kw),
                              JPT.gaussian_heatmap_targets(kp, vis, 9, 7,
                                                           **kw))


def test_paf_targets_word_equal():
    rng = np.random.RandomState(3)
    limbs = rng.rand(2, 24, 2, 2).astype(np.float32) * 150
    limbs[0, 3, 1] = limbs[0, 3, 0]               # a zero-length limb
    valid = rng.rand(2, 24) > 0.25
    for kw in ({}, dict(stride=4, width=2.0)):
        want = JPT.paf_targets(limbs, valid, 20, 19, **kw)
        got = PT.paf_targets(limbs, valid, 20, 19, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("model_type,people", [("body25", 1), ("body25", 3),
                                               ("hand", 1), ("hand", 2)])
def test_pose_targets_word_equal(model_type, people):
    """Single and multi-person; with three people two of them overlap, so
    their PAFs are count-averaged."""
    rng = np.random.RandomState(people)
    j = 21 if model_type == "hand" else 25
    kp = rng.rand(people, j, 2).astype(np.float32) * 120 + 20
    if people == 3:
        kp[1] = kp[0] + np.float32(3.0)                # overlapping limbs
    vis = rng.rand(people, j) > 0.2
    heat, paf = PT.pose_targets(kp, vis, 20, 20, model_type)
    jheat, jpaf = JPT.pose_targets(kp, vis, 20, 20, model_type)
    assert heat.dtype == jheat.dtype and np.array_equal(heat, jheat)
    if model_type == "hand":
        assert paf is None and jpaf is None
        return
    assert paf.dtype == jpaf.dtype and np.array_equal(paf, jpaf)
    if people == 3:            # an averaged cell is no longer a unit vector
        norm = np.hypot(paf[..., 0::2], paf[..., 1::2])
        assert ((norm > 0.01) & (norm < 0.99)).any()
