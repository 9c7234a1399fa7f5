"""islx_torch's CUDA kernels on the card. These tests skip on a machine
without a GPU. They import neither JAX nor islx, so they also run where JAX
is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest
import torch

from islx_torch.ops import nms_mask as N


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a CUDA kernel has no CPU mode)")


@pytest.mark.gpu
def test_nms_kernel_bit_equal_on_card():
    """The sm_90a kernel == its plain version, bit for bit, at the main
    path's shapes and a ragged one, with plateaus and thre1 ties."""
    _need_gpu()
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(4, 25, 184, 144), (2, 25, 184, 328), (3, 5, 7, 130),
                  (1, 2, 1, 1)]:
        x = torch.rand(shape, device="cuda", generator=g)
        x[..., ::3, ::5] = 0.5
        before = N.nms_mask_rows.launches
        m, c = N.nms_mask_rows(x, 0.5)
        torch.cuda.synchronize()
        assert N.nms_mask_rows.launches == before + 1
        mp, cp = N.nms_mask_rows_plain(x, 0.5)
        assert torch.equal(m, mp) and torch.equal(c, cp)


@pytest.mark.gpu
def test_nms_kernel_refuses_what_it_cannot_take():
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    _need_gpu()
    x = torch.rand(2, 3, 8, 9, device="cuda")
    before = N.nms_mask_rows.launches
    for bad in (x.double(), x[0], x.transpose(2, 3)):
        with pytest.raises((TypeError, ValueError)):
            N.nms_mask_rows(bad, 0.5)
    assert N.nms_mask_rows.launches == before
