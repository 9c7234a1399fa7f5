"""Bicubic resize with cv2 INTER_CUBIC semantics (A=-0.75), as matmuls
(port of islx/ops/resize.py).

Static resizes use host-built [n_out, n_in] matrices, contracted in f32
(``resize_cubic`` inside ``true_f32``). The batched hand-crop resize gathers
each output's 4 taps from each crop's (start, width) on the device and sums
them in the order of islx's jitted program, word for word at every probed
shape (``SUM_ORDER``) and wherever its rule holds.
"""
from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from islx_torch.core.runtime import fma_rn, true_f32

_A = -0.75  # cv2's bicubic coefficient


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """cv2 interpolateCubic: 4 tap weights for fractional offset x in [0,1)."""
    A = _A
    w = np.empty(x.shape + (4,), np.float64)
    w[..., 0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    w[..., 1] = ((A + 2) * x - (A + 3)) * x * x + 1
    w[..., 2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    w[..., 3] = 1.0 - w[..., 0] - w[..., 1] - w[..., 2]
    return w


@functools.lru_cache(maxsize=256)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] cubic interpolation matrix (border replicate)."""
    scale = n_in / n_out
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    w = _cubic_coeffs(src - i0)
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    for t in range(4):
        cols = np.clip(i0 - 1 + t, 0, n_in - 1)
        np.add.at(mat, (rows, cols), w[:, t].astype(np.float32))
    return mat


def cv2_round(x: float) -> int:
    """cvRound: round half to even (cv2 uses it for fx/fy -> dsize)."""
    return int(np.rint(x))


def output_size(size: int, f: float) -> int:
    return cv2_round(size * f)


def resize_cubic(img: torch.Tensor, h_out: int, w_out: int,
                 saturate_uint8: bool = False) -> torch.Tensor:
    """Resize [..., H, W, C] (channels last) to (h_out, w_out), cv2
    INTER_CUBIC, in f32. ``saturate_uint8`` rounds half to even and clips
    to [0, 255], as cv2's uint8 resize does."""
    dev = img.device
    r = torch.from_numpy(_resize_matrix(img.shape[-3], h_out)).to(dev)
    c = torch.from_numpy(_resize_matrix(img.shape[-2], w_out)).to(dev)
    with true_f32():
        x = torch.einsum("oh,...hwc->...owc", r, img.float())
        x = torch.einsum("pw,...owc->...opc", c, x)
    if saturate_uint8:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x


def resize_by_factor(img: torch.Tensor, fy: float, fx: float,
                     saturate_uint8: bool = False) -> torch.Tensor:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy, INTER_CUBIC)``: the output
    size rounded as cv2 rounds it (:func:`output_size`), then
    :func:`resize_cubic`."""
    return resize_cubic(img, output_size(img.shape[-3], fy),
                        output_size(img.shape[-2], fx), saturate_uint8)


# XLA's CPU program sums each dot of the batched crop resize over an
# output's <= 4 taps (the other weights are zero) in one of three orders,
# picked by the dot's shape: (rows, columns, contracted length) of its
# [rows, K] x [K, columns] product, a batch of one a crop. The first dot
# (``noh,nhwc``) is (crop size, W*C, H); the second (``npw,nowc``, which XLA
# runs as [crop size * C, W] x [W, crop size]) is (crop size * C, crop size,
# W). CHAIN: one FMA chain in tap order; EVEN_ODD: FMA chains over the taps
# at even and at odd source positions, then added; MOD4: four products, one
# per source position mod 4, added as ``(a0 + a1) + (a2 + a3)``. The dots
# run as calls into the Eigen contraction compiled into jaxlib, whose
# blocking picks the order; it was read from the outputs of islx's jitted
# ``dynamic_crop_resize_batch`` (word-equal at every entry,
# tests/test_torch_crop_resize.py) on an Intel Xeon (family 6, model 207:
# AVX2, FMA, AVX-512 F/BW/VL/VNNI/BF16/FP16, AMX), and may differ on
# another instruction set.
#
# The orders follow a rule (``_first_order``, ``_second_order``): the first
# dot's by the frame width W mod 64 (W a multiple of 8, 3 channels, a crop
# of at least 64 px), the second's by the crop size, both for frames of at
# most 240 rows and 648 columns. It fits every entry of the table below
# inside that region, and held at 38 shapes it was not fitted on: W 64-88
# and 440-648, frame heights 48-240, crops of 64-368 px
# (tests/test_torch_crop_resize.py HELD_OUT; the second dot's orders at
# 64, 80 and 88 px were read at RULE_SIZES' shapes). Outside it only the
# table's entries are known, and any other shape sums as a chain and warns
# (:func:`_sum_order`): a crop value there may round unlike islx's. What
# the probes found outside it: 46 px crops of 184-row frames, and odd
# frame widths, sum in none of the three orders; even widths off the
# multiples of 8 sum in one of them, by no rule found in W mod 64; frames
# of 720 x 648 (184 px crops) and 368-720 x 880-1280 (184 px) sum in none
# of them, while 720 x 648 at 160 px, 720 x 328 and 368 x 1280 at 368 px
# keep the rule's orders: Eigen's blocking depends on all three lengths
# of the dot. E.g. (168 columns, 40 long) sums as a chain at 46 rows and
# mod 4 at 92.
CHAIN, EVEN_ODD, MOD4 = "chain", "even_odd", "mod4"
SUM_ORDER = {
    # first dot, (crop size, W * C, H): 48x48, 40x56, 48x64, 48x72 and
    # 184x96 frames
    (92, 144, 48): MOD4, (160, 144, 48): MOD4, (184, 144, 48): MOD4,
    (46, 168, 40): CHAIN, (92, 168, 40): MOD4, (92, 192, 48): CHAIN,
    (92, 216, 48): EVEN_ODD, (92, 288, 184): EVEN_ODD,
    # second dot, (crop size * C, crop size, W)
    (138, 46, 56): MOD4, (276, 92, 48): EVEN_ODD, (276, 92, 56): EVEN_ODD,
    (276, 92, 64): EVEN_ODD, (276, 92, 72): EVEN_ODD,
    (276, 92, 96): EVEN_ODD, (480, 160, 48): EVEN_ODD,
    (552, 184, 48): CHAIN,
    # islx's single-crop test (tests/test_ops.py): 46 px from 60x80
    (46, 240, 60): CHAIN, (138, 46, 80): MOD4,
}
# The 184-row buckets, by width: the first dot's order, the same at 160 and
# 184 px crops; the second dot sums even/odd at 160 px and as a chain at 184
# px at every width.
_BUCKET_FIRST = {
    EVEN_ODD: (96, 136, 160, 200, 224, 264, 288, 328, 352, 392, 416),
    MOD4: (112, 120, 144, 152, 176, 184, 208, 216, 240, 248, 272, 280, 304,
           312, 336, 344, 368, 376, 400, 408, 432),
    CHAIN: (104, 128, 168, 192, 232, 256, 296, 320, 360, 384, 424),
}
for _order, _widths in _BUCKET_FIRST.items():
    for _w in _widths:
        SUM_ORDER[(160, _w * 3, 184)] = SUM_ORDER[(184, _w * 3, 184)] = _order
        SUM_ORDER[(480, 160, _w)] = EVEN_ODD
        SUM_ORDER[(552, 184, _w)] = CHAIN
del _order, _widths, _w

# the rule: the first dot's order by W mod 64, the second's by crop size
FIRST_BY_W64 = {0: CHAIN, 8: EVEN_ODD, 16: MOD4, 24: MOD4, 32: EVEN_ODD,
                40: CHAIN, 48: MOD4, 56: MOD4}
SECOND_BY_SIZE = {64: CHAIN, 80: MOD4, 88: EVEN_ODD, 92: EVEN_ODD,
                  128: CHAIN, 160: EVEN_ODD, 184: CHAIN, 368: MOD4}
RULE_MIN_CROP = 64
RULE_MAX_H, RULE_MAX_W = 240, 648


def _first_order(size: int, w: int, c: int, h: int):
    """The first dot's order by the rule, or None outside its region."""
    if (c == 3 and size >= RULE_MIN_CROP and w % 8 == 0
            and h <= RULE_MAX_H and w <= RULE_MAX_W):
        return FIRST_BY_W64[w % 64]
    return None


def _second_order(size: int, c: int, w: int):
    """The second dot's order by the rule, or None outside its region."""
    return SECOND_BY_SIZE.get(size) if c == 3 and w <= RULE_MAX_W else None


def _sum_order(shape, rule=None) -> str:
    """The order of a dot of shape (rows, columns, contracted length): the
    table's entry, else the rule's (``rule``), else a chain, with a
    warning."""
    order = SUM_ORDER.get(shape) or rule
    if order is None:
        warnings.warn(
            f"dynamic_crop_resize_batch: dot shape {shape} has no probed "
            f"summation order (ops/resize.py::SUM_ORDER); it sums as a "
            f"chain, and its crops may round unlike islx's",
            stacklevel=3)
        return CHAIN
    return order


def _cubic_weight(t: torch.Tensor) -> torch.Tensor:
    """cv2 bicubic kernel value at offset t (A=-0.75), as XLA's CPU
    program evaluates islx's polynomials: each multiply-add contracted into
    an FMA, so ``w1 = fma(fma(a, 1.25, -2.25) * a, a, 1)`` and ``w2 =
    fma(fma(fma(a, -0.75, 3.75), a, -6), a, 3)``."""
    a = torch.abs(t)

    def c(v):
        return torch.full((), v, dtype=a.dtype, device=a.device)

    w1 = fma_rn(fma_rn(a, c(_A + 2), c(-(_A + 3))) * a, a, c(1.0))
    w2 = fma_rn(fma_rn(fma_rn(a, c(_A), c(-5 * _A)), a, c(8 * _A)), a,
                c(-4 * _A))
    return torch.where(a < 1, w1, torch.where(a < 2, w2, c(0.0)))


def _axis_taps(n_in, out_size: int, start: torch.Tensor,
               width: torch.Tensor):
    """The cubic taps of crops [start, start+width) resized to out_size,
    as the rows of islx's ``_dynamic_axis_matrix`` inside its jitted step,
    for A axes at once: n_in (A ints), start [A,N], width [N] -> (index
    [A,N,out,4] int64 into the axis, weight [A,N,out,4] f32, odd [A,N,out]
    bool: whether the first tap's source position is odd).

    src = start + ((j + 0.5) * width) * f32(1/out) - 0.5 with the multiply
    and the add fused (XLA rewrites the division by a constant into a
    multiply by its reciprocal), then floor, 4 taps clamped into the crop
    (replicate border). Taps that the clamp makes coincide are merged by the
    matrix's adds in d = -1..2 order; tap t sits at the first one's position
    + t, with weight 0 past the last distinct one and past the frame (the
    matrix has no column there)."""
    dev = start.device
    start = start.float()[..., None]                         # [A,N,1]
    width = width.float()[None, :, None]                     # [1,N,1]
    j = torch.arange(out_size, dtype=torch.float32, device=dev)
    recip = torch.full((), np.float32(1.0) / np.float32(out_size),
                       device=dev)
    src = fma_rn((j + 0.5) * width, recip, start) - 0.5      # [A,N,out]
    d = torch.arange(-1, 3, dtype=torch.float32, device=dev)
    taps = torch.floor(src)[..., None] + d                   # [A,N,out,4]
    wgt = _cubic_weight(src[..., None] - taps)
    clamped = torch.minimum(torch.maximum(taps, start[..., None]),
                            (start + width - 1.0)[..., None])
    first = clamped[..., :1]
    pos = first + (d + 1.0)                                  # tap t's position
    s = torch.where(clamped[..., None, :] == pos[..., :, None],
                    wgt[..., None, :], 0.0)                  # [A,N,out,t,d]
    weight = ((s[..., 0] + s[..., 1]) + s[..., 2]) + s[..., 3]
    last = torch.tensor(n_in, dtype=torch.float32, device=dev)[
        :, None, None, None] - 1.0
    weight = torch.where(pos <= last, weight, 0.0)
    index = torch.minimum(pos, last).long()
    odd = torch.remainder(first[..., 0], 2.0) == 1.0
    return index, weight, odd


def _tap_sum(prods, taps, order: str, odd: torch.Tensor) -> torch.Tensor:
    """Sum of 4 weighted taps in XLA's ``order``: ``prods(t)`` is tap t's
    f32 product, ``taps(t)`` its (weight, value) for an FMA; ``odd`` (the
    first tap's source position, broadcast like the values) picks the
    pairing of MOD4. XLA's accumulators start at +0, so a product of -0
    (a zero weight on a negative value) sums to +0."""
    if order == CHAIN:
        acc = prods(0)
        for t in range(1, 4):
            acc = fma_rn(*taps(t), acc)
        return acc
    if order == EVEN_ODD:      # taps t and t + 2 share a parity
        return fma_rn(*taps(2), prods(0)) + fma_rn(*taps(3), prods(1))
    p = [prods(t) for t in range(4)]
    return torch.where(odd, (p[3] + p[0]) + (p[1] + p[2]),
                       (p[0] + p[1]) + (p[2] + p[3]))


def dynamic_crop_resize_batch(frames: torch.Tensor, fidx: torch.Tensor,
                              x0: torch.Tensor, y0: torch.Tensor,
                              w: torch.Tensor, out_size: int,
                              saturate_uint8: bool = True) -> torch.Tensor:
    """frames [B,H,W,C], per-crop (fidx, x0, y0, w) [N] -> crops
    [N,out,out,C] f32: crop [y0:y0+w, x0:x0+w] of frame fidx, cv2-cubic
    resized, then (``saturate_uint8``) rounded half to even and clipped to
    [0, 255].

    islx contracts two dense [out, n_in] matrices; here each output
    gathers its 4 taps and sums them in the order of XLA's CPU program
    (:data:`SUM_ORDER` and its rule), so the crops are islx's words on
    every device at every shape the table or the rule covers (others
    warn)."""
    h, wd, c = frames.shape[1], frames.shape[2], frames.shape[3]
    n = fidx.shape[0]
    index, weight, odd = _axis_taps((h, wd), out_size,
                                    torch.stack([y0, x0]), w)
    iy, wy, ix, wx = index[0], weight[0], index[1], weight[1]  # [N,out,4]
    src = frames[fidx.long()].float()                       # [N,H,W,C]

    def rows(t):                   # tap t of each output row: [N,o,W,C]
        return torch.gather(src, 1, iy[:, :, t, None, None].expand(
            n, out_size, wd, c))

    def wrow(t):
        return wy[:, :, t, None, None]

    order = _sum_order((out_size, wd * c, h),
                       _first_order(out_size, wd, c, h))
    x = _tap_sum(lambda t: wrow(t) * rows(t) + 0.0,
                 lambda t: (wrow(t), rows(t)), order,
                 odd[0, :, :, None, None])

    def cols(t):                   # tap t of each output column: [N,o,p,C]
        return torch.gather(x, 2, ix[:, None, :, t, None].expand(
            n, out_size, out_size, c))

    def wcol(t):
        return wx[:, None, :, t, None]

    order = _sum_order((out_size * c, out_size, wd),
                       _second_order(out_size, c, wd))
    x = _tap_sum(lambda t: wcol(t) * cols(t) + 0.0,
                 lambda t: (wcol(t), cols(t)), order,
                 odd[1, :, None, :, None])
    if saturate_uint8:        # + 0: XLA's clip gives +0 for a -0 (rint(-0.3))
        x = torch.clamp(torch.round(x), 0.0, 255.0) + 0.0
    return x


def dynamic_crop_resize(img: torch.Tensor, x0, y0, w, out_size: int,
                        saturate_uint8: bool = True) -> torch.Tensor:
    """One crop: img [H,W,C], ints or 0-d tensors x0, y0, w -> [out,out,C]
    f32, ``img[y0:y0+w, x0:x0+w]`` cv2-cubic resized (islx's
    ``dynamic_crop_resize``). It is :func:`dynamic_crop_resize_batch` over
    a batch of one crop, so it sums in the same probed orders."""
    def one(v):
        return torch.as_tensor(v, dtype=torch.int32,
                               device=img.device).reshape(1)

    return dynamic_crop_resize_batch(img[None], one(0), one(x0), one(y0),
                                     one(w), out_size, saturate_uint8)[0]
