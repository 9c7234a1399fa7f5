"""The row-band plan of the NMS kernels (``csrc/nms_first_k.cu`` and
``csrc/nms_mask.cu``): each [H, W] plane is cut into bands of whole rows,
and a block stages a band with a halo row above and below in shared
memory."""
from __future__ import annotations

# A band aims at this many pixels (16 KB of f32): thousands of blocks at
# the parity Body's 25 planes, and a band read whole in one go of copies.
BAND_PX = 4096
# Shared memory one block may take on sm_90 (227 KB), less room for the
# kernel's static shared variables.
MAX_SMEM = 227 * 1024 - 256
# Blocks a launch should keep: eight waves of the eight 256-thread blocks
# that each of an H100's 132 SMs holds at once.
MIN_BLOCKS = 8 * 8 * 132


def band_plan(h: int, w: int):
    """-> (rows a band, bands a plane, shared-memory bytes a block) for
    [.., H, W] planes: bands of about BAND_PX pixels, as even as the rows
    allow, that cover rows 0..H-1 once each; a block stages its band and a
    halo row above and below, plus up to 3 floats of alignment pad."""
    rows = max(1, -(-BAND_PX // w))
    bands = -(-h // rows)
    rows = -(-h // bands)          # the same number of bands, evened out
    return rows, bands, ((rows + 2) * w + 3) * 4


def bands_per_block(planes: int, bands: int) -> int:
    """Consecutive bands of one plane that a block reads in turn: up to 4,
    as long as the launch keeps MIN_BLOCKS blocks. A block leaves at its
    first band that holds k peaks, so on dense maps fewer blocks are
    launched only to find their band after the plane's cutoff."""
    group = 1
    while group < 4 and planes * -(-bands // (group + 1)) >= MIN_BLOCKS:
        group += 1
    return group
