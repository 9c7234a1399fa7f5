"""The port's batched hand-crop resize against islx's as its fused step runs
it (``jax.jit`` on the CPU): word-equal crops before and after the rounding
to integers, at every (frame shape, crop size) of
``islx_torch.ops.resize.SUM_ORDER``, on seeded frames and crops that
include taps clamped at the crop's and the frame's borders.

islx contracts two dense weight matrices; XLA's CPU program computes their
entries with fused multiply-adds and sums each dot's <= 4 nonzero taps in an
order its Eigen contraction picks. The port gathers the taps and sums them
in that order, so no word may differ. :func:`probe_orders` finds that order
for a new shape: ``PYTHONPATH=. python tests/test_torch_crop_resize.py H W
SIZE`` prints the (first dot, second dot) orders that give islx's words.
The table was probed on an Intel Xeon (family 6, model 207, AVX-512);
Eigen's blocking may pick other orders on another instruction set.
"""
import itertools
import sys
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islx.ops import resize as JR
from islx_torch.ops import resize as TR

# (frame H, frame W, crop size): the frames and crops that the port's tests
# and chip_smoke.py cut, and the fused step's 184-row buckets of portrait
# 16:9 (104), square (184), 4:3 (248) and 3:2 (280) frames at both crop
# sizes (portrait 4:3 is the 144 bucket, 16:9 the 328 one)
SHAPES = [(48, 48, 92), (48, 48, 160), (48, 48, 184), (40, 56, 46),
          (40, 56, 92), (184, 96, 92), (184, 144, 160), (184, 144, 184),
          (184, 328, 160), (184, 328, 184), (184, 104, 160), (184, 104, 184),
          (184, 184, 160), (184, 184, 184), (184, 248, 160), (184, 248, 184),
          (184, 280, 160), (184, 280, 184)]
ORDERS = (TR.CHAIN, TR.EVEN_ODD, TR.MOD4)
_jitted = jax.jit(JR.dynamic_crop_resize_batch, static_argnums=(5, 6))


def _crops(h, w, n, seed):
    """(fidx, x0, y0, w) [n] int32: crops at the frame's corners and edges
    (taps clamped into the crop), 1-px and 2-px crops (all 4 taps on 1 or 2
    pixels), one wider than the frame's remaining height, and random ones."""
    rng = np.random.RandomState(seed)
    side = min(h, w)
    fixed = [(0, 0, 0, side // 3), (1, w - 5, h - 5, 5), (0, 3, h - 1, 1),
             (1, w - 2, 0, 2), (0, w // 2, h // 3, side), (1, 1, 2, 7)]
    boxes = [list(b) for b in fixed]
    for _ in range(n - len(fixed)):
        s = int(rng.randint(1, side + 1))
        boxes.append([int(rng.randint(0, 2)), int(rng.randint(0, w)),
                      int(rng.randint(0, h)), s])
    return [np.array(col, np.int32) for col in zip(*boxes)]


def _inputs(h, w, size):
    frames = (np.random.RandomState(h * w + size).rand(2, h, w, 3) * 255
              ).astype(np.uint8)
    return frames, _crops(h, w, 10, size)


def probe_orders(h, w, size) -> list:
    """The (first dot, second dot) pairs of orders under which the port's
    unrounded crops of [2,h,w,3] frames are islx's jitted ones, word for
    word, on this host's CPU."""
    frames, boxes = _inputs(h, w, size)
    want = np.asarray(_jitted(jnp.asarray(frames), *map(jnp.asarray, boxes),
                              size, False)).view(np.uint32)
    tb = [torch.from_numpy(b) for b in boxes]
    found = []
    for first, second in itertools.product(ORDERS, ORDERS):
        with mock.patch.dict(TR.SUM_ORDER, {(size, w * 3, h): first,
                                            (size * 3, size, w): second}):
            got = TR.dynamic_crop_resize_batch(torch.from_numpy(frames), *tb,
                                               size, False).numpy()
        if np.array_equal(got.view(np.uint32), want):
            found.append((first, second))
    return found


@pytest.mark.parametrize("h,w,size", SHAPES)
def test_crop_resize_word_equal_to_islx_jitted(h, w, size):
    frames, boxes = _inputs(h, w, size)
    tb = [torch.from_numpy(b) for b in boxes]
    for saturate in (False, True):
        want = np.asarray(_jitted(jnp.asarray(frames),
                                  *map(jnp.asarray, boxes), size, saturate))
        got = TR.dynamic_crop_resize_batch(torch.from_numpy(frames), *tb,
                                           size, saturate).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (10, size, size, 3)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    # the rounded crops hold values that sit near .5 before the rounding
    assert (want >= 0).all() and (want <= 255).all()


@pytest.mark.parametrize("h,w,size", SHAPES)
def test_sum_order_is_the_one_order_with_islx_words(h, w, size):
    """Of the nine (first dot, second dot) pairs of orders, the table's is
    the only one that gives islx's words: each entry is what the probe
    finds, and the seeded crops tell the three orders apart."""
    assert probe_orders(h, w, size) == [
        (TR.SUM_ORDER[(size, w * 3, h)], TR.SUM_ORDER[(size * 3, size, w)])]


def test_unprobed_shape_warns():
    """A frame or crop size outside the table sums as a chain and says
    so; a probed one is silent."""
    frames = torch.zeros(1, 184, 200, 3, dtype=torch.uint8)
    box = [torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.full((1,), 9, dtype=torch.int32)]
    with pytest.warns(UserWarning, match="no probed summation order"):
        TR.dynamic_crop_resize_batch(frames, *box, 160)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TR.dynamic_crop_resize_batch(frames[:, :, :184], *box, 160)


def test_sum_orders_cover_both_dots_of_each_shape():
    """Every shape of SHAPES has a probed order for both dots: (crop size,
    W*C, H) for the first, (crop size * C, crop size, W) for the second;
    the table holds no other shape."""
    keys = set()
    for h, w, size in SHAPES:
        keys |= {(size, w * 3, h), (size * 3, size, w)}
    assert keys == set(TR.SUM_ORDER)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(probe_orders(*map(int, sys.argv[1:4])))
