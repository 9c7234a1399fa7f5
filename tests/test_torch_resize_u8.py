"""The port's u8 bicubic resize (islx_torch/ops/resize_u8.py) against
cv2.resize(INTER_CUBIC) as installed here (its Intel IPP path).

The plain version is word-equal to cv2 at the bucket shapes chip_smoke.py
holds the CUDA kernel to (phase 3), at held-out camera sizes from QCIF to
5 MP (landscape, portrait, upscales), and on frames built to put the
horizontal sums on rounding ties, where each f32 rounding of the model
shows. The kernel itself runs only on a GPU (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

from islx_torch.ops import resize_u8 as R
from islx_torch.pipeline.batch_pose import bucket_for

cv2 = pytest.importorskip("cv2")

# (source H, W) -> (H, W): chip_smoke.py phase 3's shapes, the last one
# ragged
PHASE3 = [((480, 640), (184, 248)), ((720, 1280), (184, 328)),
          ((1080, 1920), (184, 328)), ((240, 320), (184, 248)),
          ((1280, 720), (184, 104)), ((184, 328), (184, 184)),
          ((97, 131), (61, 203))]
# camera frames to their 184-row buckets: QCIF to 5 MP, portrait, and the
# upscales of small frames
HELD_OUT = [(144, 176), (120, 160), (240, 320), (288, 352), (360, 640),
            (480, 640), (480, 854), (540, 960), (600, 800), (576, 720),
            (720, 1280), (768, 1024), (960, 1280), (1080, 1920),
            (1200, 1600), (1944, 2592), (640, 480), (1280, 720),
            (1920, 1080), (176, 144), (96, 128), (100, 100), (150, 200),
            (1080, 2560)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)
                                               ).astype(np.uint8)


def _cv2(frames, h, w):
    return np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC)
                     for f in frames])


@pytest.mark.parametrize("src,dst", PHASE3)
def test_plain_word_equal_to_cv2_at_phase3_shapes(src, dst):
    frames = _frames(2, *src, seed=sum(src))
    got = R.resize_u8(torch.from_numpy(frames), *dst)
    assert got.dtype == torch.uint8 and got.shape == (2, *dst, 3)
    np.testing.assert_array_equal(got.numpy(), _cv2(frames, *dst))


@pytest.mark.parametrize("h,w", HELD_OUT)
def test_plain_word_equal_to_cv2_held_out(h, w):
    hb, wb = bucket_for(h, w, target_h=184)
    frame = _frames(1, h, w, seed=h * 7 + w)
    got = R.resize_u8_plain(torch.from_numpy(frame), hb, wb).numpy()
    np.testing.assert_array_equal(got, _cv2(frame, hb, wb))


def _tie_frames(n_in, n_out, rows, seed):
    """[rows, n_in] u8 rows whose taps put the horizontal sums of every
    output column that owns its taps within 3e-5 of a .5 (the exact sum of
    the f32 weights): there each rounding of the f32 arithmetic decides
    the output."""
    rng = np.random.RandomState(seed)
    idx, w = R.taps(n_in, n_out)
    img = rng.randint(0, 256, (rows, n_in)).astype(np.uint8)
    used = np.zeros(n_in, bool)
    for c in range(n_out):
        if used[idx[c]].any():
            continue
        used[idx[c]] = True
        t = rng.randint(0, 256, (200000, 4))
        s = t @ w[c].astype(np.float64)
        keep = (np.abs(s - np.floor(s) - 0.5) < 3e-5) & (s > 1) & (s < 254)
        t = t[keep][:rows]
        img[:len(t), idx[c]] = t
    return img


@pytest.mark.parametrize("n_in,n_out", [(1280, 328), (640, 248), (100, 333)])
def test_plain_word_equal_to_cv2_on_rounding_ties(n_in, n_out):
    """Rows on rounding ties, resized along their length (the vertical
    pass is then exact) and, transposed, along the other axis: a weight
    one f32 step off, a product rounded where the FMA keeps it, or another
    sum order gives other words on tens of these values."""
    rows = _tie_frames(n_in, n_out, 300, n_in + n_out)
    img = np.repeat(rows[:, :, None], 3, 2)
    got = R.resize_u8_plain(torch.from_numpy(img), 300, n_out).numpy()[0]
    np.testing.assert_array_equal(got, _cv2(img[None], 300, n_out)[0])
    col = np.ascontiguousarray(img.transpose(1, 0, 2))
    got = R.resize_u8_plain(torch.from_numpy(col), n_out, 300).numpy()[0]
    np.testing.assert_array_equal(got, _cv2(col[None], n_out, 300)[0])


def test_taps_are_cached_and_read_only():
    idx, w = R.taps(720, 184)
    assert R.taps(720, 184)[0] is idx
    assert idx.dtype == np.int32 and w.dtype == np.float32
    assert idx.shape == w.shape == (184, 4)
    assert idx.min() >= 0 and idx.max() <= 719
    with pytest.raises(ValueError):
        idx[0, 0] = 1
    same_i, same_w = R.taps(50, 50)
    np.testing.assert_array_equal(same_w, np.tile([0, 1, 0, 0], (50, 1)))
    np.testing.assert_array_equal(same_i[:, 1], np.arange(50))


def _round_f32(r):
    """The f32 nearest the rational ``r``, ties to even."""
    from fractions import Fraction

    f = np.float32(float(r))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - r),
                                    int(np.array(v).view(np.int32)) & 1))


def test_fma_rounds_once():
    """_fma of f32 values held in f64 == the correctly rounded a*b + c,
    which differs from the twice-rounded f32(f32(a*b) + c) on some of
    these values."""
    from fractions import Fraction

    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(20000).astype(np.float32) * 100 for _ in range(3))
    got = R._fma(*(torch.from_numpy(x.astype(np.float64)) for x in (a, b, c)
                   )).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float64)
    np.testing.assert_array_equal(got, want)
    assert ((a * b).astype(np.float32) + c != want).any()


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    frames = torch.from_numpy(_frames(2, 30, 40, 1))
    before = R.resize_u8.launches
    np.testing.assert_array_equal(R.resize_u8(frames, 18, 24).numpy(),
                                  R.resize_u8_plain(frames, 18, 24).numpy())
    np.testing.assert_array_equal(R.resize_u8(frames[0], 18, 24).numpy(),
                                  R.resize_u8_plain(frames, 18, 24)[:1]
                                  .numpy())
    assert R.resize_u8.launches == before     # no kernel on the CPU
    with pytest.raises(TypeError):
        R.resize_u8(frames.float(), 18, 24)
    with pytest.raises(ValueError):
        R.resize_u8(frames[..., :2], 18, 24)
    with pytest.raises(ValueError, match="unsupported device"):
        R.resize_u8(frames.to("meta"), 18, 24)


def test_resize_frames_and_bucket_resize():
    """Host frames in, host frames out (resize_frames) or frames on the
    device asked for (upload_resized, what the entry points step on); a
    frame at its size passes through as it is."""
    frames = _frames(3, 60, 80, 2)
    hb, wb = bucket_for(60, 80, target_h=184)
    got = R.resize_frames(list(frames), hb, wb, "cpu")
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, _cv2(frames, hb, wb))
    up = R.upload_resized(frames[1], hb, wb, "cpu")
    assert isinstance(up, torch.Tensor) and up.shape == (1, hb, wb, 3)
    np.testing.assert_array_equal(up[0].numpy(), got[1])
    at_size = _frames(1, hb, wb, 3)[0]
    assert np.shares_memory(R.resize_frames(at_size, hb, wb, "cpu"), at_size)
    np.testing.assert_array_equal(
        R.upload_resized([at_size], hb, wb, "cpu")[0].numpy(), at_size)


def values_off(h, w, oh, ow, seed=0) -> int:
    """How many values of a seeded random frame's resize differ from
    cv2's (0 wherever cv2 takes its IPP path)."""
    frame = _frames(1, h, w, seed)
    got = R.resize_u8_plain(torch.from_numpy(frame), oh, ow).numpy()
    return int((got != _cv2(frame, oh, ow)).sum())


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_resize_u8.py H W OH OW ...:
    # the values off cv2's INTER_CUBIC for each (H, W) -> (OH, OW)
    import sys

    args = [int(a) for a in sys.argv[1:]]
    for i in range(0, len(args) - 3, 4):
        h, w, oh, ow = args[i:i + 4]
        print(f"{h}x{w} -> {oh}x{ow}: {values_off(h, w, oh, ow)} of "
              f"{oh * ow * 3} values off cv2")
