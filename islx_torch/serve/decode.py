"""Image bytes -> u8 BGR frames without cv2: the POST bodies the server
takes, decoded to what ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` returns for
them (islx decodes with cv2; the port's machine has none).

    decode(data) -> np.ndarray [H, W, 3] u8, or None

Taken: 8-bit PNG (colour types 0, 2, 3, 4 and 6, plain or Adam7-interlaced)
and one-scan baseline or extended-sequential Huffman JPEG (grey, or YCbCr
sampled 4:4:4, 4:2:2, 4:2:0 or 4:4:0; restart markers; Motion-JPEG frames
that carry no Huffman tables), each turned by its EXIF
orientation as cv2 turns it (a JPEG's APP1 Exif segment; a PNG's eXIf
chunk too, which cv2 honours, so an 8-bit PNG that carries one is not
served sideways). Everything else gives None, as do bytes cv2 would
refuse: PNG of 1, 2, 4 or 16 bits; progressive, lossless or
arithmetic-coded JPEG, multi-scan JPEG, other samplings, RGB or CMYK
JPEG; other formats
(WebP, TIFF, ...); truncated or corrupt data; a JPEG frame of more blocks
than its body can code (4 a byte), a PNG whose data inflates to fewer
bytes than its rows, and any image over ``MAX_PIXELS``: each refused
before anything is allocated for its pixels.

The PNG chunks are read and checked here and the IDAT stream is inflated
with the standard library's zlib; the scanlines, and the whole JPEG, are
decoded by ``islx_torch/csrc/image_decode.cpp`` (g++ at first use, through
:mod:`islx_torch.ops._build`), called through ``ctypes`` without the GIL,
so the server's handler threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Optional

import numpy as np

from islx_torch.ops import _build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"

# PNG colour type -> samples a pixel (8 bits each: other depths are refused)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# cv2's default limit on a decoded image (CV_IO_MAX_IMAGE_PIXELS)
MAX_PIXELS = 1 << 30


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("image_decode")
    lib.islx_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.islx_jpeg_info.restype = ctypes.c_int
    lib.islx_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.islx_jpeg_decode.restype = ctypes.c_int
    lib.islx_png_unfilter.argtypes = ([ctypes.c_char_p, ctypes.c_size_t]
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_char_p, ctypes.c_void_p])
    lib.islx_png_unfilter.restype = ctypes.c_int
    return lib


def orientation(tiff: bytes) -> int:
    """The EXIF orientation (1-8) in a TIFF-headed EXIF block: IFD0's tag
    0x0112; 1 where it is missing, out of range or unreadable."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    off = struct.unpack(e + "I", tiff[4:8])[0]
    if off + 2 > len(tiff):
        return 1
    for i in range(struct.unpack(e + "H", tiff[off:off + 2])[0]):
        p = off + 2 + 12 * i
        if p + 10 > len(tiff):
            break
        if struct.unpack(e + "H", tiff[p:p + 2])[0] == 0x0112:
            v = struct.unpack(e + "H", tiff[p + 8:p + 10])[0]
            return v if 1 <= v <= 8 else 1
    return 1


def orient(img: np.ndarray, code: int) -> np.ndarray:
    """``img`` turned as cv2 turns a frame of EXIF orientation ``code``."""
    if code >= 5:
        img = img.transpose(1, 0, 2)
    if code in (2, 3, 6, 7):
        img = img[:, ::-1]
    if code in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _jpeg(data: bytes) -> Optional[np.ndarray]:
    lib = _lib()
    info = (ctypes.c_int64 * 4)()
    if lib.islx_jpeg_info(data, len(data), info) != 0:
        return None
    h, w, exif_off, exif_len = info
    if h * w > MAX_PIXELS:
        return None
    out = np.empty((h, w, 3), np.uint8)
    if lib.islx_jpeg_decode(data, len(data), out.ctypes.data, h, w) != 0:
        return None
    return orient(out, orientation(data[exif_off:exif_off + exif_len])
                  if exif_len else 1)


def _goes_on(stream) -> bool:
    """After the rows, libpng reads on towards the end of the zlib stream:
    True where it ends, or gives more bytes first (libpng's benign "too
    much image data"); False where the IDAT data stops short of it or is
    bad ("not enough image data", an inflate error)."""
    while not stream.eof:
        tail = stream.unconsumed_tail
        if not tail:
            return False
        try:
            if stream.decompress(tail, 1):
                return True
        except zlib.error:
            return False
    return True


def _png(data: bytes) -> Optional[np.ndarray]:
    pos, n = len(PNG_SIGNATURE), len(data)
    header = None
    plte = bytearray(768)
    idat = []
    exif = b""
    while True:
        if pos + 12 > n:
            return None                  # no IEND: the data ends early
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + size > n:
            return None
        if kind == b"IEND":
            break                        # cv2 does not check IEND's CRC
        body = data[pos + 8:pos + 8 + size]
        crc = struct.unpack(">I", data[pos + 8 + size:pos + 12 + size])[0]
        pos += 12 + size
        critical = not kind[0] & 0x20
        if zlib.crc32(kind + body) != crc:
            if critical:
                return None
            continue                     # a damaged ancillary chunk is dropped
        if header is None and kind != b"IHDR":
            return None
        if kind == b"IHDR":
            if header is not None or size != 13:
                return None
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if size % 3 or size > 768:
                return None
            plte[:size] = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            if not idat:
                exif = body
        elif critical:
            return None
    w, h, depth, ctype, method, filt, interlace = header
    if (w == 0 or h == 0 or w * h > MAX_PIXELS or method or filt
            or interlace > 1 or depth != 8 or ctype not in _PNG_CHANNELS):
        return None
    ch = _PNG_CHANNELS[ctype]
    need = sum(-(-(h - y0) // dy) * (1 + -(-(w - x0) // dx) * ch)
               for x0, y0, dx, dy in (_ADAM7 if interlace else
                                      ((0, 0, 1, 1),))
               if w > x0 and h > y0)
    stream = zlib.decompressobj()
    try:            # what the rows need, no more (a zlib bomb stops there)
        raw = stream.decompress(b"".join(idat), need)
    except zlib.error:
        return None
    if len(raw) < need or not _goes_on(stream):
        return None
    out = np.empty((h, w, 3), np.uint8)
    if _lib().islx_png_unfilter(raw, len(raw), w, h, ctype, interlace,
                                bytes(plte), out.ctypes.data) != 0:
        return None
    return orient(out, orientation(exif))


def decode(data) -> Optional[np.ndarray]:
    """Image bytes -> u8 BGR [H, W, 3], what ``cv2.imdecode(...,
    cv2.IMREAD_COLOR)`` gives, or None for bytes this decoder does not take
    (see the module's docstring)."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        return _png(data)
    if data.startswith(JPEG_SIGNATURE):
        return _jpeg(data)
    return None
