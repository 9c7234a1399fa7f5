"""The PAF sampling kernel's host side (``islx_torch/ops/paf_sample.py``:
the limb table made once, the sample positions, the block plan), and its
plain version against islx's ``score_limbs`` with such a table."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islx.ops import paf as JP
from islx_torch.ops import paf_sample as PS


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

@pytest.mark.parametrize("mid_num", [1, 2, 3, 7, 10, 11])
def test_kernel_sample_positions_are_samples_t(mid_num):
    """The kernel computes t[m] as ``m * step`` with one f32 rounding and an
    exact 1.0 last (``t_at`` in csrc/paf_sample.cu), ``step`` from
    ``_scalars``: the same words as ``_samples_t``, which the plain version
    uses."""
    step = np.float32(PS._scalars(0.05, mid_num, 100.0)[-1])
    t = np.float32(np.arange(mid_num, dtype=np.float32) * step)
    if mid_num > 1:
        t[-1] = 1.0
    np.testing.assert_array_equal(t, PS._samples_t(mid_num, "cpu").numpy())


@pytest.mark.parametrize("k", [1, 2, 12, 16, 32, 33, 64, 100, 1024])
def test_block_rows_fit_a_block(k):
    """A block takes at least one row of K pairs, at most K rows, and at
    most 1024 threads."""
    rows = PS.block_rows(k)
    assert 1 <= rows <= k
    assert rows * k <= PS.MAX_THREADS
    assert rows * k <= max(PS.BLOCK_PAIRS, k)


def test_limb_table_checks_once():
    """A LimbTable holds its rows and the largest part and channel, and
    refuses negative entries; paf_sample takes its
    limbs only as a LimbTable, and the plain version scores more limbs
    than the kernel takes."""
    t = PS.LimbTable(JP.LIMB_SEQ_BODY25, JP.MAP_IDX_BODY25)
    assert len(t) == 24 and t.max_part == 24 and t.max_chan == 51
    assert list(t.c_rows) == t.rows.reshape(-1).tolist()
    assert t.rows.dtype == torch.int32
    with pytest.raises(ValueError):
        PS.LimbTable([[0, -1]], [[0, 1]])
    args = (torch.zeros(4, 5, 52), torch.zeros(25, 3, 2, dtype=torch.int32),
            torch.zeros(25, 3, dtype=torch.bool))
    with pytest.raises(TypeError):
        PS.paf_sample(*args, JP.LIMB_SEQ_BODY25, JP.MAP_IDX_BODY25)
    many = PS.LimbTable(np.zeros((PS.MAX_LIMBS + 1, 2)),
                        np.zeros((PS.MAX_LIMBS + 1, 2)))
    score, ok = PS.paf_sample(*args, many)
    assert score.shape == ok.shape == (PS.MAX_LIMBS + 1, 3, 3)


@pytest.mark.parametrize("mid_num", [1, 2, 10, 11])
def test_limb_table_scores_as_islx(rng, mid_num):
    """paf_sample with a LimbTable made once and used twice == islx's
    score_limbs on the two host tables, bit for bit."""
    h, w, k, c = 46, 40, 8, 25
    paf = rng.rand(h, w, 52).astype(np.float32) - 0.4
    xy = np.stack([rng.randint(0, w, (c, k)), rng.randint(0, h, (c, k))],
                  -1).astype(np.int32)
    valid = rng.rand(c, k) > 0.2
    t = (torch.from_numpy(paf), torch.from_numpy(xy), torch.from_numpy(valid))
    table = PS.LimbTable(JP.LIMB_SEQ_BODY25, JP.MAP_IDX_BODY25)
    s1, o1 = PS.paf_sample(*t, table, 0.05, mid_num, float(h))
    s2, o2 = PS.paf_sample(*t, table, 0.05, mid_num, float(h))
    want = JP.score_limbs(jnp.asarray(paf), jnp.asarray(xy),
                          jnp.asarray(valid), jnp.asarray(JP.LIMB_SEQ_BODY25),
                          jnp.asarray(JP.MAP_IDX_BODY25), 0.05, mid_num,
                          orig_h=jnp.float32(h))
    for s, o in ((s1, o1), (s2, o2)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(want.score))
        np.testing.assert_array_equal(o.numpy(), np.asarray(want.ok))
