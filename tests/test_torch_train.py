"""Translator-head training on the CPU: islx_torch's train mode, loss,
step and fit against islx's on the same seeded windows and islx's own
initial parameters, in f32.

Tolerances, and why:
- forward probabilities and batch statistics: rtol 1e-5, atol 1e-6 (the
  same f32 arithmetic summed in another order);
- loss: rtol 1e-5; gradients: rtol 1e-4, atol 1e-6 (the backward of a
  20-step LSTM accumulates the order differences);
- parameters after one Adam step: within 1e-6 of islx's, except where
  islx's gradient is within 1e-6 of zero: Adam's first step is
  ``-lr * g / (|g| + 1e-8)``, about ``-lr * sign(g)``, so a gradient
  inside rounding of zero may flip its sign and move 2*lr apart;
- running statistics after the step's EMA: rtol 1e-4, atol 1e-6;
- a 2-epoch ``fit`` with dropout 0 (8 steps): atol 2e-5 over the weights
  and 1e-4 relative over the statistics, where no gradient sat at zero
  (the data's features are all live);
- a resumed ``fit`` equals an uninterrupted one bit for bit, dropout on.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.core.config import TranslatorConfig as JCfg
from islx.isl import train as JTR
from islx.models import translator as JT
from islx_torch.core.config import TranslatorConfig
from islx_torch.isl import train as TR
from islx_torch.models import translator as T

CFG0 = TranslatorConfig(dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def windows(seed, n):
    """Seeded windows with zero-padded tails of 0-12 steps, and labels."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 20, 156).astype(np.float32)
    for i, keep in enumerate(rng.randint(8, 21, n)):
        x[i, keep:] = 0.0
    return x, rng.randint(0, 167, n).astype(np.int32)


def islx_params(seed=0):
    return jax.tree.map(np.asarray,
                        JT.init_params(jcfg(), jax.random.PRNGKey(seed)))


def jcfg(dropout=0.0):
    return JCfg(dropout=dropout)


def assert_params_close(got, want, rtol, atol, keys=None):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            if keys is not None and k not in keys:
                continue
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name}/{k}")


@pytest.fixture(scope="module")
def reference():
    """islx's train-mode forward, batch statistics, loss and gradients,
    and one full step, once for the module."""
    params = islx_params(0)
    x, y = windows(1, 16)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    probs = np.asarray(JT.forward(params, jx, train=True, rng=None,
                                  cfg=jcfg()))
    stats = jax.tree.map(np.asarray, JT.batch_stats(params, jx, jcfg()))
    (loss, metrics), grads = jax.value_and_grad(JTR.loss_fn, has_aux=True)(
        params, jx, jy, jax.random.PRNGKey(5), jcfg())
    opt = JTR.make_optimizer(1e-3)
    state = JTR.TrainState(params, opt.init(params), jnp.int32(0))
    state, _ = JTR.make_train_step(opt, jcfg())(state, jx, jy,
                                                jax.random.PRNGKey(5))
    return dict(params=params, x=x, y=y, probs=probs, stats=stats,
                loss=float(loss), accuracy=float(metrics["accuracy"]),
                grads=jax.tree.map(np.asarray, grads),
                stepped=jax.tree.map(np.asarray, state.params))


def test_train_forward_and_batch_stats_match_islx(reference):
    head = T.from_islx_params(reference["params"], "cpu", CFG0)
    x = torch.from_numpy(reference["x"])
    with torch.no_grad():
        probs = head(x, train=True).numpy()
        stats = head.batch_stats(x)
        infer = head(x).numpy()
    np.testing.assert_allclose(probs, reference["probs"], rtol=1e-5,
                               atol=1e-6)
    assert set(stats) == {"bn0", "bn1", "bn2"}
    for name, (mean, var) in stats.items():
        jm, jv = reference["stats"][name]
        np.testing.assert_allclose(mean.numpy(), jm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), jv, rtol=1e-5, atol=1e-6)
    # inference mode reads the running statistics, not the batch's
    want = JT.forward(reference["params"], jnp.asarray(reference["x"]),
                      train=False, cfg=jcfg())
    np.testing.assert_allclose(infer, np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(infer, probs, atol=1e-3)


def test_bn_statistics_are_buffers():
    head = T.from_islx_params(islx_params(0), "cpu", CFG0)
    params = {n for n, _ in head.named_parameters()}
    buffers = {n for n, _ in head.named_buffers()}
    assert buffers == {f"bn{i}__{k}" for i in range(3)
                       for k in ("mean", "var")}
    assert "bn0__gamma" in params and "lstm1_fwd__recurrent" in params
    assert not params & buffers


def test_loss_and_gradients_match_jax_grad(reference):
    head = T.from_islx_params(reference["params"], "cpu", CFG0)
    loss, metrics = TR.loss_fn(head, torch.from_numpy(reference["x"]),
                               torch.from_numpy(reference["y"]))
    loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), reference["loss"],
                               rtol=1e-5)
    assert float(metrics["accuracy"]) == reference["accuracy"]
    named = dict(head.named_parameters())
    assert len(named) == 22
    for key, p in named.items():
        name, k = key.split("__")
        np.testing.assert_allclose(p.grad.numpy(),
                                   reference["grads"][name][k],
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_one_step_matches_islx(reference):
    """Adam update, BN statistics kept out of it, then the EMA of every
    BN's statistics on the UPDATED weights, as islx's make_train_step."""
    state = TR.init_state(CFG0, 1e-3, reference["params"], device="cpu")
    metrics = TR.make_train_step(state)(torch.from_numpy(reference["x"]),
                                        torch.from_numpy(reference["y"]))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), reference["loss"],
                               rtol=1e-5)
    got, want = state.head.to_params(), reference["stepped"]
    for name in want:
        for k in want[name]:
            if name.startswith("bn") and k in ("mean", "var"):
                np.testing.assert_allclose(got[name][k], want[name][k],
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name}/{k}")
                assert not np.array_equal(want[name][k],
                                          reference["params"][name][k])
                continue
            flip = np.abs(reference["grads"][name][k]) <= 1e-6
            err = np.abs(got[name][k] - want[name][k])
            assert (err <= 1e-6 + 2e-3 * flip).all(), (name, k, err.max())


def test_fit_two_epochs_matches_islx():
    x, y = windows(2, 64)
    init = islx_params(3)
    want = jax.tree.map(np.asarray, JTR.fit(
        x, y, epochs=2, batch_size=16, lr=1e-3, cfg=jcfg(), seed=3,
        verbose=False))
    got = TR.fit(x, y, epochs=2, batch_size=16, lr=1e-3, cfg=CFG0, seed=3,
                 verbose=False, params=init, device="cpu")
    stats = ("mean", "var")
    assert_params_close(got, want, 0, 2e-5,
                        keys=("kernel", "recurrent", "bias", "gamma",
                              "beta"))
    assert_params_close(got, want, 1e-4, 1e-6, keys=stats)
    # the weights moved: 8 Adam steps of 1e-3
    assert np.abs(got["dense3"]["kernel"] - init["dense3"]["kernel"]).max() \
        > 5e-3


def test_fit_permutation_is_islx_rule():
    """One RandomState(seed) shuffles the same order array every epoch;
    the last partial batch is dropped."""
    seen = []
    real = TR.make_train_step

    def spy(state):
        step = real(state)

        def wrapped(x, y, generator=None):
            seen.append(y.numpy().copy())
            return step(x, y, generator)
        return wrapped

    x, y = windows(4, 21)
    y = np.arange(21, dtype=np.int32)
    TR.make_train_step = spy
    try:
        TR.fit(x, y, epochs=3, batch_size=5, cfg=CFG0, seed=7,
               verbose=False, device="cpu")
    finally:
        TR.make_train_step = real
    order, rs, want = np.arange(21), np.random.RandomState(7), []
    for _ in range(3):
        rs.shuffle(order)
        want += [order[i:i + 5].copy() for i in range(0, 17, 5)]
    assert len(seen) == 12
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


def test_dropout_keep_rate_scale_and_determinism():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(11)
    out = T._dropout(x, 0.2, g, True)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    np.testing.assert_array_equal(out[kept].numpy(),
                                  np.float32(1.0) / np.float32(0.8))
    again = T._dropout(x, 0.2, torch.Generator().manual_seed(11), True)
    assert torch.equal(out, again)
    assert not torch.equal(out, T._dropout(x, 0.2, g, True))
    # the identity without train mode, a generator or a rate
    for args in ((0.2, g, False), (0.2, None, True), (0.0, g, True)):
        assert T._dropout(x, *args) is x


def test_resume_is_bit_equal_to_uninterrupted(tmp_path, capsys):
    x, y = windows(5, 48)
    cfg = TranslatorConfig()                 # dropout 0.2, drawn
    kw = dict(batch_size=16, cfg=cfg, seed=1, device="cpu")
    want = TR.fit(x, y, epochs=3, verbose=False, **kw)
    ck = str(tmp_path / "ck")
    TR.fit(x, y, epochs=1, checkpoint_dir=ck, verbose=False, **kw)
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f) == {"epoch": 0}
    capsys.readouterr()
    got = TR.fit(x, y, epochs=3, checkpoint_dir=ck, verbose=True, **kw)
    ran = [line.split(":")[0] for line in
           capsys.readouterr().out.splitlines()]
    assert ran == ["epoch 1", "epoch 2"]          # resumed, not restarted
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f) == {"epoch": 2}
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k],
                                          err_msg=f"{name}/{k}")
