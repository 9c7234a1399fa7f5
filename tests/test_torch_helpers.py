"""The last public helpers of islx and their ports, on the same inputs on the
CPU: ``resize_by_factor`` and the single ``dynamic_crop_resize``
(islx/ops/resize.py), ``pad_normalize_batch`` (islx/ops/preprocess.py),
``expression`` and ``N_CLASSES`` (islx/isl/expressions.py),
``param_count`` (islx/models/translator.py) and ``native.available`` /
``get_lib`` (islx/ops/native.py).

Every comparison is word for word but one: a float (not uint8) resize by
a factor is held within rtol 1e-5, atol 1e-6, as ``resize_cubic`` is
(tests/test_torch_pose.py): its matrices are contracted in another order.
The single crop is held against islx's function as a jitted step runs it
(its weights' multiply-adds fused), at shapes whose sum orders are probed
(islx_torch/ops/resize.py::SUM_ORDER and its rule).
"""
import ctypes
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.isl import expressions as JE
from islx.models import translator as JT
from islx.ops import native as JN
from islx.ops import preprocess as JP
from islx.ops import resize as JR
from islx_torch.isl import expressions as TE
from islx_torch.models import translator as TT
from islx_torch.ops import native as TN
from islx_torch.ops import preprocess as TP
from islx_torch.ops import resize as TR


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,fy,fx", [((50, 70), 1.7, 1.7),
                                         ((93, 121), 0.5, 0.5),
                                         ((92, 120), 0.4, 0.75)])
@pytest.mark.parametrize("saturate", [True, False])
def test_resize_by_factor(shape, fy, fx, saturate):
    rng = np.random.RandomState(shape[0])
    img = ((rng.rand(*shape, 3) * 255).astype(np.uint8) if saturate
           else rng.randn(*shape, 3).astype(np.float32))
    want = np.asarray(JR.resize_by_factor(jnp.asarray(img), fy, fx,
                                          saturate_uint8=saturate))
    got = TR.resize_by_factor(torch.from_numpy(img), fy, fx,
                              saturate_uint8=saturate).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if saturate:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


_crop_jit = jax.jit(JR.dynamic_crop_resize, static_argnums=(4, 5))


@pytest.mark.parametrize("h,w,size", [(60, 80, 46), (48, 48, 92),
                                      (184, 144, 184), (184, 328, 160)])
def test_dynamic_crop_resize(h, w, size):
    """Word-equal to islx's jitted single crop at islx's own test shape
    (46 px of 60x80, tests/test_ops.py) and at the port's crop shapes,
    before and after the rounding, on crops at the frame's corners and
    edges and random ones; and equal to the batched form."""
    rng = np.random.RandomState(size)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    n = 8
    cw = np.concatenate([[1, 2, min(h, w)], rng.randint(8, min(h, w), n - 3)])
    x0 = np.concatenate([[0, w - 2, 0], rng.randint(0, w - cw[3:] + 1)])
    y0 = np.concatenate([[0, h - 2, 0], rng.randint(0, h - cw[3:] + 1)])
    ti = torch.from_numpy(img)
    for saturate in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # every shape here is probed
            got = [TR.dynamic_crop_resize(ti, int(a), int(b), int(c), size,
                                          saturate).numpy()
                   for a, b, c in zip(x0, y0, cw)]
            batch = TR.dynamic_crop_resize_batch(
                ti[None], torch.zeros(n, dtype=torch.int32),
                *(torch.from_numpy(v.astype(np.int32)) for v in (x0, y0, cw)),
                size, saturate).numpy()
        for i in range(n):
            want = np.asarray(_crop_jit(jnp.asarray(img), jnp.int32(x0[i]),
                                        jnp.int32(y0[i]), jnp.int32(cw[i]),
                                        size, saturate))
            assert got[i].shape == want.shape == (size, size, 3)
            np.testing.assert_array_equal(got[i].view(np.uint32),
                                          want.view(np.uint32))
            np.testing.assert_array_equal(got[i], batch[i])


@pytest.mark.parametrize("shape,stride,pad", [((3, 37, 50, 3), 8, 128),
                                              ((2, 48, 48, 3), 8, 128),
                                              ((1, 45, 61, 3), 16, 0)])
def test_pad_normalize_batch(shape, stride, pad):
    imgs = (np.random.RandomState(1).rand(*shape) * 255).astype(np.uint8)
    want, wpad = JP.pad_normalize_batch(jnp.asarray(imgs), stride, pad)
    got, gpad = TP.pad_normalize_batch(torch.from_numpy(imgs), stride, pad)
    assert gpad == wpad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_expressions():
    assert TE.N_CLASSES == JE.N_CLASSES == 167
    for i in range(TE.N_CLASSES):
        assert TE.expression(i) == JE.expression(i)
        assert TE.expression(np.int64(i)) == JE.expression(np.int64(i))
    with pytest.raises(KeyError):
        TE.expression(TE.N_CLASSES)


def test_param_count():
    """The same count of islx's default head params, carried across, and
    of the port's own init."""
    jp = jax.tree.map(np.asarray, JT.init_params())
    assert TT.param_count(jp) == JT.param_count(jp)
    assert TT.param_count(TT.init_params()) == JT.param_count(jp)


@pytest.mark.parametrize("no_native", ["", "1"])
def test_native_available_and_get_lib(monkeypatch, no_native):
    """``available`` follows ``ISLX_NO_NATIVE`` as islx's does, and
    ``get_lib`` gives the loaded grouping library."""
    monkeypatch.setenv("ISLX_NO_NATIVE", no_native)
    assert TN.available() == JN.available() == (not no_native)
    lib = TN.get_lib()
    assert isinstance(lib, ctypes.CDLL)
    assert hasattr(lib, "islx_assemble_batch")
    assert TN.get_lib() is lib
