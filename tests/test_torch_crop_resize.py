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


# (frame H, frame W, crop size): the frames and crops that the port's tests
# and chip_smoke.py cut (48x64 and 48x72: the serve test's 64x96 and 80x96
# requests at target_h 48), and the fused step's 184-row buckets of portrait
# 16:9 (104), square (184), 4:3 (248) and 3:2 (280) frames at both crop
# sizes (portrait 4:3 is the 144 bucket, 16:9 the 328 one)
SHAPES = [(48, 48, 92), (48, 48, 160), (48, 48, 184), (40, 56, 46),
          (40, 56, 92), (48, 64, 92), (48, 72, 92), (184, 96, 92),
          (184, 144, 160), (184, 144, 184),
          (184, 328, 160), (184, 328, 184), (184, 104, 160), (184, 104, 184),
          (184, 184, 160), (184, 184, 184), (184, 248, 160), (184, 248, 184),
          (184, 280, 160), (184, 280, 184),
          # islx's single-crop test (tests/test_ops.py), 46 px from 60x80
          (60, 80, 46)]
# every other 184-row bucket a server meets (``bucket_for`` at target_h 184:
# 96 to 432 wide, 1:2 portrait to 21:9) at both crop sizes
BUCKETS = [(184, w, size) for w in range(96, 433, 8) for size in (160, 184)
           if (184, w, size) not in SHAPES]
# shapes the sum-order rule (first dot by W mod 64, second by crop size)
# was not fitted on, each probed before it was adopted: widths beyond the
# buckets (64-88, 440-648), frame heights 48-240, crops of 64-368 px;
# none of them is in SUM_ORDER
HELD_OUT = [(184, 440, 160), (184, 464, 184), (184, 488, 160),
            (184, 512, 184), (184, 544, 160), (184, 648, 184),
            (184, 88, 160), (184, 64, 184), (184, 72, 160), (184, 80, 184),
            (160, 328, 160), (160, 288, 184), (160, 200, 160),
            (160, 144, 184), (240, 328, 160), (240, 432, 184),
            (240, 256, 160), (240, 104, 184), (184, 328, 128),
            (184, 144, 128), (184, 256, 128), (184, 328, 368),
            (184, 144, 368), (184, 200, 368), (184, 144, 92),
            (184, 328, 92), (184, 104, 92), (184, 256, 92), (184, 96, 128),
            (184, 96, 368), (184, 584, 184), (200, 328, 160),
            (160, 200, 64), (240, 256, 80), (184, 440, 88), (184, 256, 64),
            (200, 328, 80), (48, 72, 88)]
# the shapes the rule's second-dot orders at 64, 80 and 88 px were read
# at (the first dot's by W mod 64 held at each); not in SUM_ORDER
RULE_SIZES = [(48, 48, 64), (48, 64, 64), (184, 144, 64), (48, 48, 80),
              (184, 144, 80), (184, 328, 80), (48, 48, 88), (184, 144, 88)]
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


@pytest.mark.parametrize("h,w,size",
                         SHAPES + BUCKETS + HELD_OUT + RULE_SIZES)
def test_crop_resize_word_equal_to_islx_jitted(h, w, size):
    frames, boxes = _inputs(h, w, size)
    tb = [torch.from_numpy(b) for b in boxes]
    for saturate in (False, True):
        with warnings.catch_warnings():   # every shape here has an order
            warnings.simplefilter("error")
            got = TR.dynamic_crop_resize_batch(torch.from_numpy(frames),
                                               *tb, size, saturate).numpy()
        want = np.asarray(_jitted(jnp.asarray(frames),
                                  *map(jnp.asarray, boxes), size, saturate))
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


def test_rule_fits_every_table_entry():
    """The sum-order rule gives the table's order at every entry inside its
    region (first dot: 3 channels, W a multiple of 8, a crop of >= 92 px;
    second dot: a crop size it names), and the held-out shapes are outside
    the table and inside the rule."""
    fitted = 0
    for (rows, cols, k), order in TR.SUM_ORDER.items():
        if rows == 3 * cols:                      # second dot
            rule = TR._second_order(cols, 3, k)
        elif cols % 3 == 0:                       # first dot, 3 channels
            rule = TR._first_order(rows, cols // 3, 3, k)
        else:
            rule = None
        if rule is not None:
            assert rule == order, (rows, cols, k)
            fitted += 1
    # (46,168,40), (138,46,56), (46,240,60), (138,46,80): 46 px crops
    assert fitted == len(TR.SUM_ORDER) - 4
    for h, w, size in HELD_OUT + RULE_SIZES:
        assert (size, w * 3, h) not in TR.SUM_ORDER
        assert TR._first_order(size, w, 3, h) is not None
        assert TR._second_order(size, 3, w) is not None


def test_unprobed_shape_warns():
    """A frame or crop size outside the table sums as a chain and says
    so; a probed one is silent."""
    frames = torch.zeros(1, 184, 204, 3, dtype=torch.uint8)   # no bucket
    box = [torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.full((1,), 9, dtype=torch.int32)]
    with pytest.warns(UserWarning, match="no probed summation order"):
        TR.dynamic_crop_resize_batch(frames, *box, 160)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TR.dynamic_crop_resize_batch(frames[:, :, :184], *box, 160)


@pytest.mark.parametrize("h,w,size", [(720, 1280, 368), (720, 648, 184),
                                      (368, 1280, 184), (184, 97, 92),
                                      (184, 144, 46)])
def test_shapes_outside_the_rule_warn(h, w, size):
    """Shapes where no order of the three gives islx's words (probed:
    frames over 240 rows or 648 columns, an odd width, a 46 px crop of a
    184-row frame) are outside the rule, so they warn."""
    assert (TR._first_order(size, w, 3, h) is None
            or TR._second_order(size, 3, w) is None)
    frames = torch.zeros(1, h, w, 3, dtype=torch.uint8)
    box = [torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.full((1,), 9, dtype=torch.int32)]
    with pytest.warns(UserWarning, match="no probed summation order"):
        TR.dynamic_crop_resize_batch(frames, *box, size)


def test_sum_orders_cover_both_dots_of_each_shape():
    """Every shape of SHAPES and BUCKETS has a probed order for both dots:
    (crop size, W*C, H) for the first, (crop size * C, crop size, W) for the
    second; the table holds no other shape."""
    keys = set()
    for h, w, size in SHAPES + BUCKETS:
        keys |= {(size, w * 3, h), (size * 3, size, w)}
    assert keys == set(TR.SUM_ORDER)


@pytest.mark.parametrize("size", [160, 184])
def test_every_serving_bucket_is_probed(size):
    """Each 184-row bucket that ``bucket_for`` gives a frame from 1:2
    portrait to 21:9 (every width a multiple of 8 from 96 to 432) has both
    dots' keys in the table at both crop sizes, so a served request cuts
    its crops without the unprobed-shape warning."""
    from islx_torch.pipeline.batch_pose import bucket_for

    widths = {bucket_for(h, w)[1] for h, w in
              [(720, 360), (720, 1680), (1080, 1920), (480, 640),
               (1920, 1080)]}
    assert min(widths) >= 96 and max(widths) <= 432
    for w in range(96, 433, 8):
        assert (size, w * 3, 184) in TR.SUM_ORDER, w
        assert (size * 3, size, w) in TR.SUM_ORDER, w
    frames = torch.zeros(1, 184, 432, 3, dtype=torch.uint8)
    box = [torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.full((1,), 9, dtype=torch.int32)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for w in range(96, 433, 8):
            TR.dynamic_crop_resize_batch(frames[:, :, :w], *box, size)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(probe_orders(*map(int, sys.argv[1:4])))


@pytest.mark.parametrize("size", [160, 184])
def test_every_bucket_width_of_the_rule_is_silent(size):
    """Every width ``bucket_for`` gives at 184 rows up to RULE_MAX_W (each
    multiple of 8 from 8 to 648: a frame from aspect 1:23 to 3.52:1, which
    any camera size reaches now that frames are resized to their bucket on
    the card) has an order for both dots at both hand crop sizes, with no
    warning."""
    from islx_torch.pipeline.batch_pose import bucket_for

    assert bucket_for(1840, 80)[1] == 8
    assert bucket_for(184, 648)[1] == TR.RULE_MAX_W
    frames = torch.zeros(1, 184, TR.RULE_MAX_W, 3, dtype=torch.uint8)
    box = [torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.full((1,), 9, dtype=torch.int32)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for w in range(8, TR.RULE_MAX_W + 1, 8):
            assert TR._sum_order((size, w * 3, 184),
                                 TR._first_order(size, w, 3, 184)) in (
                TR.CHAIN, TR.EVEN_ODD, TR.MOD4), w
            assert TR._sum_order((size * 3, size, w),
                                 TR._second_order(size, 3, w)) in (
                TR.CHAIN, TR.EVEN_ODD, TR.MOD4), w
            TR.dynamic_crop_resize_batch(frames[:, :, :w], *box, size)


@pytest.mark.parametrize("size", [160, 184])
def test_bucket_wider_than_the_rule_warns(size):
    """A frame wider than aspect 3.52 (1280x360: a 656-wide bucket) is
    outside the rule: its crops sum as a chain and warn, as documented."""
    from islx_torch.pipeline.batch_pose import bucket_for

    hb, wb = bucket_for(360, 1280)
    assert (hb, wb) == (184, 656) and wb > TR.RULE_MAX_W
    frames = torch.zeros(1, hb, wb, 3, dtype=torch.uint8)
    box = [torch.zeros(1, dtype=torch.int32)] * 3 + [
        torch.full((1,), 9, dtype=torch.int32)]
    with pytest.warns(UserWarning, match="no probed summation order"):
        TR.dynamic_crop_resize_batch(frames, *box, size)
