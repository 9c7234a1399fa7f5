"""islx_torch.ops.augment against islx.ops.augment on the CPU: rotated and
solarized frames word-equal to islx's jitted functions on the same u8
frames and angles, the f32 cos/sin words equal to XLA's, and
``random_augment`` held to its contract (islx's jax key stream is not
reproduced)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.ops import augment as JA
from islx_torch.ops import augment as TA

ANGLES = [0.0, 90.0, -90.0, 180.0, 270.0, 360.0, 3.3, -7.77, 9.1234, 1e-6]


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


def _frame(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)
                                               ).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(720, 1280), (184, 328), (37, 53), (1, 1),
                                 (2, 3)])
def test_rotate_nearest_word_equal(h, w):
    img = _frame(h * 7 + w, h, w)
    angles = ANGLES + list(np.random.RandomState(w).uniform(-10, 10, 6))
    for deg in angles:
        want = np.asarray(JA.rotate_nearest(jnp.asarray(img),
                                            jnp.float32(deg)))
        got = TA.rotate_nearest(torch.from_numpy(img), deg).numpy()
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{deg} degrees")


def test_rotation_source_pixel_at_every_output_pixel():
    """On an image whose value is its own flat index, every output pixel
    names the source pixel islx picks (or 0 outside), at 24 angles in +-10
    degrees: the cos/sin words and the FMA rounding of the coordinates."""
    h, w = 184, 328
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w, 1)
    for deg in np.random.RandomState(0).uniform(-10, 10, 24):
        want = np.asarray(JA.rotate_nearest(jnp.asarray(idx),
                                            jnp.float32(deg)))
        got = TA.rotate_nearest(torch.from_numpy(idx), deg).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{deg} degrees")


def test_cos_sin_words_equal_xla():
    degs = np.random.RandomState(1).uniform(-10, 10, 500).astype(np.float32)

    @jax.jit
    def cs(d):
        t = jnp.deg2rad(d.astype(jnp.float32))
        return jnp.cos(t), jnp.sin(t)

    for d in list(degs) + ANGLES:
        wc, ws = (np.asarray(v) for v in cs(jnp.float32(d)))
        gc, gs = TA.cos_sin_f32(d)
        assert (gc.view(np.int32), gs.view(np.int32)) == \
            (wc.view(np.int32), ws.view(np.int32)), d


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("threshold", [128.0, 192.0, 0.0, 255.5])
def test_solarize_word_equal(dtype, threshold):
    img = _frame(3, 40, 56).astype(dtype)
    want = np.asarray(JA.solarize(jnp.asarray(img), threshold))
    got = TA.solarize(torch.from_numpy(img), threshold).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_random_augment_contract():
    """Shape and type kept; the same generator seed draws the same frames;
    each frame turned by an angle within +-max_degrees (read back from an
    image whose value is its own flat index), the angles spread over the
    range; about half of many frames solarized; no angle and no solarize
    when both are off."""
    h = w = 64
    idx = torch.arange(1, h * w + 1, dtype=torch.int32).reshape(h, w, 1)
    x = idx.expand(64, h, w, 1).contiguous()
    out = TA.random_augment(x, torch.Generator().manual_seed(0),
                            max_degrees=10.0, solarize_prob=0.0)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, TA.random_augment(
        x, torch.Generator().manual_seed(0), solarize_prob=0.0))
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64) - 31.5,
                            torch.arange(w, dtype=torch.float64) - 31.5,
                            indexing="ij")
    angles = []
    for o in out[..., 0]:
        keep = o > 0
        src = (o[keep] - 1).double()
        sy, sx = src // w - 31.5, src % w - 31.5
        a = torch.stack([xx[keep], yy[keep]], 1)
        # sy = sin * xx + cos * yy (nearest-rounded): least squares
        s, c = torch.linalg.lstsq(a, sy[:, None]).solution[:, 0]
        angles.append(float(torch.rad2deg(torch.atan2(s, c))))
        assert sx.numel() > h * w // 2
    angles = np.array(angles)
    assert np.abs(angles).max() <= 10.5
    assert angles.min() < -7 and angles.max() > 7

    frames = torch.from_numpy(np.stack([_frame(i, 4, 4) for i in range(100)]))
    sol = TA.random_augment(frames, torch.Generator().manual_seed(2),
                            max_degrees=0.0, solarize_threshold=192.0)
    flipped = [torch.equal(o, TA.solarize(f, 192.0)) and not torch.equal(o, f)
               for o, f in zip(sol, frames)]
    kept = [torch.equal(o, f) for o, f in zip(sol, frames)]
    assert all(a or b for a, b in zip(flipped, kept))
    assert 30 <= sum(flipped) <= 70
    assert torch.equal(TA.random_augment(frames[:4], None, max_degrees=0.0,
                                         solarize_prob=0.0), frames[:4])
