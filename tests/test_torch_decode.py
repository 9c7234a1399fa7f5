"""The port's image decoder (islx_torch/serve/decode.py, csrc/image_decode.cpp)
against cv2.imdecode(IMREAD_COLOR), and the server on POST bodies without
cv2.

Every JPEG and PNG below is made here (cv2.imencode, or this file's PNG
writer for the colour types and interlacing cv2 does not write) and decoded
by both sides: the pixels are word-equal. Formats the decoder refuses give
None, and the server answers 400: PNG of fewer or more than 8 bits, JPEG
sampled other than 4:4:4, 4:2:2, 4:2:0 or 4:4:0, RGB JPEG, multi-scan and
progressive JPEG (cv2 decodes them all), and a JPEG frame with more blocks
than 4 a byte of its body (cv2 decodes such a body when its data ends at a
marker, grey past the marker; ROADMAP.md §3).

``tests/decode_fixtures.json`` keeps a few small bodies, two camera-sized
JPEGs and the sha256 of cv2's decoded pixels: chip_smoke.py checks the
decoder with them on a machine without cv2. Rewrite it (only when the
fixtures change) with

    PYTHONPATH=. python tests/test_torch_decode.py

and tally seeded corruptions of small JPEGs and PNGs decoded by both
(ROADMAP.md §1 item 9) with

    PYTHONPATH=. python tests/test_torch_decode.py fuzz
"""
import base64
import hashlib
import json
import os
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from islx_torch.serve import PoseServer
from islx_torch.serve.decode import decode

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "decode_fixtures.json")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING = ("444", "422", "420", "440", "411")
REFUSED_SAMPLING = ("411",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: the suite runs several test
    processes at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def natural(h, w, seed, noise=6.0):
    """A seeded smooth u8 BGR frame with some noise (photo-like for a JPEG
    encoder)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = rng.rand(3, 2) * 6
    img = np.stack([128 + 90 * np.sin(x / (9 + 7 * c) + ph[c, 0])
                    * np.cos(y / (13 + 5 * c) - ph[c, 1]) for c in range(3)],
                   -1)
    img += rng.randn(h, w, 3) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg(img, quality=75, sampling="420", restart=0, optimize=False,
         progressive=False) -> bytes:
    import cv2

    flags = [cv2.IMWRITE_JPEG_QUALITY, quality,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
             cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
             cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
             cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def exif_tiff(orientation: int, big_endian: bool) -> bytes:
    """A TIFF-headed EXIF block whose IFD0 holds only the orientation."""
    e = ">" if big_endian else "<"
    return ((b"MM\x00\x2a" if big_endian else b"II\x2a\x00")
            + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


def with_exif(jpg: bytes, orientation: int, big_endian=False) -> bytes:
    """The JPEG with an APP1 Exif segment after its APP0 (JFIF)."""
    payload = b"Exif\x00\x00" + exif_tiff(orientation, big_endian)
    app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    at = 4 + struct.unpack(">H", jpg[4:6])[0]      # after APP0
    return jpg[:at] + app1 + jpg[at:]


# ---------------------------------------------------------------- PNG writer

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows, bpp, rng) -> bytes:
    """Rows filtered with a seeded filter type each (0-4)."""
    out = bytearray()
    prev = bytes(len(rows[0]))
    for r in rows:
        kind = rng.randint(5)
        f = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) // 2,
                    _paeth(a, prev[i], c))[kind]
            f[i] = (r[i] - pred) & 255
        out += bytes([kind]) + f
        prev = r
    return bytes(out)


def _packed(samples, depth):
    """[rows, n] samples of ``depth`` bits -> packed row bytes."""
    if depth == 8:
        return [bytes(row.astype(np.uint8)) for row in samples]
    out = []
    for row in samples:
        bits = "".join(format(int(v), f"0{depth}b") for v in row)
        bits += "0" * (-len(bits) % 8)
        out.append(bytes(int(bits[i:i + 8], 2)
                         for i in range(0, len(bits), 8)))
    return out


def png(samples, ctype, depth, interlace=False, plte=None, exif=None,
        seed=0) -> bytes:
    """A PNG of ``samples`` [h, w, channels] (ints of ``depth`` bits)."""
    h, w, ch = samples.shape
    assert ch == _CHANNELS[ctype]
    rng = np.random.RandomState(seed)
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_packed(sub.reshape(sub.shape[0], -1), depth),
                             bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if exif is not None:
        out += _chunk(b"eXIf", exif)
    if plte is not None:
        out += _chunk(b"PLTE", bytes(plte))
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def png_case(h, w, ctype, depth, interlace, seed):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 1 << depth, (h, w, _CHANNELS[ctype]))
    plte = None
    if ctype == 3:   # one index past the palette's entries: black
        plte = rng.randint(0, 256, 3 * max(1, (1 << depth) - 1)).astype(
            np.uint8)
    return png(s, ctype, depth, interlace, plte, seed=seed)


# ------------------------------------------------------------------ checks

def cv2_decode(data: bytes):
    import cv2

    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def assert_refused(data: bytes):
    """cv2 decodes the body; the port's decoder refuses it."""
    assert cv2_decode(data) is not None
    assert decode(data) is None


def assert_same_as_cv2(data: bytes):
    want = cv2_decode(data)
    got = decode(data)
    assert want is not None and got is not None
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", SAMPLING)
def test_jpeg_word_equal_to_cv2(quality, sampling):
    """Each quality and sampling, at a camera size and at sizes off the
    MCU grid (down to 1x1 and widths of 2, where libjpeg-turbo takes the
    box filter), with and without restart markers and optimized tables.
    4:1:1 is refused (None where cv2 decodes)."""
    pytest.importorskip("cv2")
    check = (assert_refused if sampling in REFUSED_SAMPLING
             else assert_same_as_cv2)
    for i, (h, w) in enumerate([(480, 640), (37, 53), (9, 17), (17, 2),
                                (2, 3), (1, 1)]):
        img = natural(h, w, i)
        for kw in ({}, {"restart": 3}, {"optimize": True}):
            check(jpeg(img, quality, sampling, **kw))


@pytest.mark.parametrize("h,w", [(480, 640), (33, 17), (1, 9)])
def test_grey_jpeg_word_equal_to_cv2(h, w):
    cv2 = pytest.importorskip("cv2")
    grey = cv2.cvtColor(natural(h, w, 5), cv2.COLOR_BGR2GRAY)
    for q in (50, 95):
        ok, buf = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, q,
                                              cv2.IMWRITE_JPEG_RST_INTERVAL,
                                              2])
        assert_same_as_cv2(buf.tobytes())


def test_rgb_jpeg_word_equal_to_cv2():
    """RGB JPEG is refused: three components named 'R', 'G', 'B' and no
    JFIF segment, or an Adobe segment with transform 0 (libjpeg reads RGB
    and cv2 decodes both); an Adobe segment with transform 1 is YCbCr and
    word-equal."""
    pytest.importorskip("cv2")
    base = jpeg(natural(24, 40, 6), 90, "444")
    data = bytearray(base)
    data = data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:]
    sof, sos = data.find(b"\xff\xc0"), data.find(b"\xff\xda")
    for c, name in enumerate(b"RGB"):
        data[sof + 10 + 3 * c] = name
        data[sos + 5 + 2 * c] = name
    assert_refused(bytes(data))
    no_jfif = base[:2] + base[4 + struct.unpack(">H", base[4:6])[0]:]
    for transform, check in ((0, assert_refused), (1, assert_same_as_cv2)):
        app14 = (b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                 + bytes([transform]))
        check(no_jfif[:2] + app14 + no_jfif[2:])


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_as_cv2(orientation):
    """cv2.imdecode turns a frame by its EXIF orientation (1-8; others are
    1), a JPEG's APP1 and a PNG's eXIf chunk, in either byte order."""
    pytest.importorskip("cv2")
    img = natural(30, 40, 7)
    for big in (False, True):
        assert_same_as_cv2(with_exif(jpeg(img, 90, "422"), orientation, big))
        assert_same_as_cv2(png(img[:, :, ::-1].astype(np.int64), 2, 8,
                               exif=exif_tiff(orientation, big)))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8),
                                         (2, 8), (3, 1), (3, 2), (3, 4),
                                         (3, 8), (4, 8), (6, 8)])
@pytest.mark.parametrize("interlace", [False, True])
def test_png_word_equal_to_cv2(ctype, depth, interlace):
    """Each colour type at 8 bits, plain and Adam7, at sizes that leave
    passes empty; 1, 2 and 4 bits are refused (None where cv2 decodes)."""
    pytest.importorskip("cv2")
    check = assert_same_as_cv2 if depth == 8 else assert_refused
    for i, (h, w) in enumerate([(1, 1), (5, 3), (13, 17), (33, 40)]):
        check(png_case(h, w, ctype, depth, interlace, i))


def test_refused_and_broken_bodies_give_none():
    """A progressive JPEG and a 16-bit PNG (which cv2 decodes), other
    formats, and truncated or damaged data (which cv2 refuses too) give
    None."""
    cv2 = pytest.importorskip("cv2")
    img = natural(30, 40, 8)
    good_jpg, good_png = jpeg(img), png(img.astype(np.int64), 2, 8)
    ok, png16 = cv2.imencode(".png", img.astype(np.uint16) * 257)
    ok, webp = cv2.imencode(".webp", img)
    for data in (jpeg(img, progressive=True), png16.tobytes(),
                 webp.tobytes()):
        assert cv2_decode(data) is not None
        assert decode(data) is None
    idat = good_png.find(b"IDAT")
    bad_crc = bytearray(good_png)
    bad_crc[idat + 6] ^= 1
    huge = bytearray(good_jpg)          # a 60000x60000 frame: over cv2's
    sof = huge.find(b"\xff\xc0")        # 2**30-pixel limit
    huge[sof + 5:sof + 9] = struct.pack(">HH", 60000, 60000)
    no_table = bytearray(good_jpg)      # Cb names a table no DQT defined
    no_table[sof + 10 + 3 + 2] = 3
    big_mcu = bytearray(good_jpg)       # luma 4x4: 18 blocks an MCU
    big_mcu[sof + 10 + 1] = 0x44
    sos = good_jpg.find(b"\xff\xda")
    long_sos = bytearray(good_jpg)      # an SOS segment 2 bytes too long
    long_sos[sos + 3] += 2
    unknown = good_jpg[:2] + b"\xff\xf3\x00\x02" + good_jpg[2:]  # JPG3
    for data in (b"not an image", good_jpg[:len(good_jpg) // 2],
                 good_jpg[:-2], good_png[:len(good_png) // 2],
                 bytes(bad_crc), bytes(no_table), bytes(big_mcu),
                 bytes(long_sos), unknown):
        assert cv2_decode(data) is None
        assert decode(data) is None
    with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
        cv2_decode(bytes(huge))
    assert decode(bytes(huge)) is None
    assert decode(b"") is None
    assert decode(good_jpg + b"trailing bytes") is not None
    assert_refused(three_scans())


def three_scans() -> bytes:
    """A sequential JPEG of three non-interleaved scans, one a component:
    a flat 16x16 frame at 128 (every coefficient 0), coded with the
    standard Huffman tables cv2 writes (DC category 0 '00', luma EOB
    '1010', chroma EOB '00')."""
    base = jpeg(np.full((16, 16, 3), 128, np.uint8), 75, "444")
    out = base[:base.find(b"\xff\xda")]
    luma = int("001010" * 4, 2).to_bytes(3, "big")
    for cid, tables, data in ((1, 0x00, luma), (2, 0x11, b"\x00\x00"),
                              (3, 0x11, b"\x00\x00")):
        out += b"\xff\xda\x00\x08\x01" + bytes([cid, tables, 0, 63, 0]) + data
    return out + b"\xff\xd9"


def test_frames_without_huffman_tables_as_cv2():
    """Motion-JPEG camera frames carry no DHT: libjpeg-turbo takes the
    standard tables for slots 0 and 1, and so does the decoder."""
    pytest.importorskip("cv2")
    for sampling in ("420", "422", "444"):
        data = jpeg(natural(48, 64, 17), 85, sampling, restart=2)
        out, i = data[:2], 2
        while data[i + 1] != 0xDA:
            seg = 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
            if data[i + 1] != 0xC4:
                out += data[i:i + seg]
            i += seg
        out += data[i:]
        assert b"\xff\xc4" not in out[:out.find(b"\xff\xda")]
        assert_same_as_cv2(out)


def test_header_segments_libjpeg_skips_as_cv2():
    """Segments libjpeg skips before the frame (DNL, COM, an APPn) change
    nothing; a second SOI is refused by both."""
    pytest.importorskip("cv2")
    data = jpeg(natural(20, 28, 18), 90, "422")
    for seg in (b"\xff\xdc\x00\x04\x00\x10", b"\xff\xfe\x00\x05abc",
                b"\xff\xe7\x00\x02"):
        assert_same_as_cv2(data[:2] + seg + data[2:])
    twice = data[:2] + b"\xff\xd8" + data[2:]
    assert cv2_decode(twice) is None and decode(twice) is None


def test_png_data_around_the_rows_as_cv2():
    """What cv2 (libpng) makes of a PNG's end: IEND's CRC is not checked,
    zlib data after the rows is ignored, a stream that stops after the
    rows without its end, or data that ends before IEND, gives None."""
    pytest.importorskip("cv2")
    body = png_case(13, 17, 2, 8, False, 1)
    idat = body.find(b"IDAT")
    size = struct.unpack(">I", body[idat - 4:idat])[0]
    raw = zlib.decompress(body[idat + 4:idat + 4 + size])

    def with_stream(comp):
        return (body[:idat - 4] + _chunk(b"IDAT", comp)
                + body[idat + 8 + size:])

    extra = zlib.compress(raw + bytes(range(40)))
    open_end = zlib.compressobj()
    open_end = open_end.compress(raw) + open_end.flush(zlib.Z_SYNC_FLUSH)
    bad_iend = body[:-1] + bytes([body[-1] ^ 0x5A])
    assert_same_as_cv2(bad_iend)
    assert_same_as_cv2(with_stream(extra))
    for data in (with_stream(open_end), body[:-12], body[:-6]):
        assert cv2_decode(data) is None
        assert decode(data) is None


def test_three_scans_is_a_flat_frame_to_cv2():
    """The multi-scan body the decoder refuses is a real JPEG: cv2 decodes
    it to the flat frame it codes."""
    pytest.importorskip("cv2")
    np.testing.assert_array_equal(cv2_decode(three_scans()),
                                  np.full((16, 16, 3), 128, np.uint8))


def _scan_bounds(data: bytes):
    """(start, end) of the entropy-coded data of the (single) scan."""
    sos = data.find(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    return start, data.rfind(b"\xff\xd9")


@pytest.mark.parametrize("sampling,restart", [("420", 0), ("444", 2),
                                              ("422", 1)])
def test_data_ending_at_a_marker_as_cv2(sampling, restart):
    """Scan data cut short by a marker (EOI, or an RST of a restart
    interval): libjpeg decodes the MCU that runs out from zero bits and
    leaves the rest of its interval zero; the decoder gives cv2's
    pixels."""
    pytest.importorskip("cv2")
    data = jpeg(natural(40, 56, 12), 80, sampling, restart=restart)
    start, end = _scan_bounds(data)
    for frac in (0.0, 0.1, 0.37, 0.5, 0.83, 0.99):
        cut = start + int(frac * (end - start))
        while data[cut - 1] == 0xFF:      # not inside an 0xFF00 or RSTn
            cut -= 1
        assert_same_as_cv2(data[:cut] + b"\xff\xd9")
        if restart:                       # and resumes at the next RST
            nxt = next((i for i in range(cut, end - 1) if data[i] == 0xFF
                        and 0xD0 <= data[i + 1] <= 0xD7), None)
            if nxt is not None:
                assert_same_as_cv2(data[:cut] + data[nxt:])


def test_restart_markers_out_of_order_as_cv2():
    """RSTn markers dropped, repeated or out of order: the decoder
    resynchronises as jpeg_resync_to_restart does."""
    pytest.importorskip("cv2")
    data = jpeg(natural(48, 64, 13), 85, "420", restart=1)
    start, end = _scan_bounds(data)
    rst = [i for i in range(start, end - 1)
           if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    assert len(rst) > 8
    cases = []
    for k in (1, 3, 4):
        a = rst[k]
        cases.append(data[:a] + data[a + 2:])                  # dropped
        cases.append(data[:a] + data[a:a + 2] + data[a:])      # repeated
        for n in (1, 2, 3, 6, 7):                              # renumbered
            m = bytearray(data)
            m[a + 1] = 0xD0 + (m[a + 1] - 0xD0 + n) % 8
            cases.append(bytes(m))
        b = rst[k + 1]                                         # swapped
        cases.append(data[:a] + data[b:b + 2] + data[a + 2:b]
                     + data[a:a + 2] + data[b + 2:])
    for case in cases:
        assert_same_as_cv2(case)


def test_what_follows_the_scan_as_cv2():
    """After the one scan has ended at a marker, the image is cv2's
    whatever follows (libjpeg reads it after the rows are out): a second
    scan, a bad table, another frame, a segment and the end of the data,
    junk before EOI. Data that ends with the scan gives None on both."""
    pytest.importorskip("cv2")
    for sampling in ("444", "420"):
        a = jpeg(natural(32, 48, 14), 75, sampling)
        b = jpeg(natural(32, 48, 15), 75, sampling)
        end = a.rfind(b"\xff\xd9")
        sof = a.find(b"\xff\xc0")
        for tail in (b[b.find(b"\xff\xda"):],
                     b"\xff\xdb\x00\x03\x00\xff\xd9",
                     a[sof:sof + 19] + b"\xff\xd9",
                     b"\xff\xe5\x00\x04ab", b"abc\xff\xd9"):
            assert_same_as_cv2(a[:end] + tail)
        for tail in (b"", b"\xff"):
            assert cv2_decode(a[:end] + tail) is None
            assert decode(a[:end] + tail) is None


_PEAK_RSS = """
import resource, sys, time
from islx_torch.serve.decode import decode
small, big = (open(p, "rb").read() for p in sys.argv[1:3])
assert decode(small) is not None          # the library loaded
r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
t0 = time.perf_counter()
got = decode(big)
print(got is None, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - r0,
      time.perf_counter() - t0)
"""


def test_frame_larger_than_its_body_is_refused(tmp_path):
    """A 32767x32767 4:4:4 header (just under cv2's 2**30-pixel limit) on
    a body of about 1 KB: refused before anything is allocated for it
    (peak RSS of a fresh process grows < 64 MiB). At 2000x2000 a body
    whose scan ends at EOI is refused too, where cv2 decodes it grey past
    the marker: each coded block takes at least 2 bits, so no complete
    body of that length holds the frame (ROADMAP.md §3)."""
    import subprocess

    cv2 = pytest.importorskip("cv2")
    small = jpeg(natural(30, 40, 16), 75, "444")
    start, end = _scan_bounds(small)
    sof = small.find(b"\xff\xc0")
    for side in (32767, 2000):
        big = bytearray(small[:start + 40] + b"\xff\xd9")
        big[sof + 5:sof + 9] = struct.pack(">HH", side, side)
        assert len(big) < 4 * 3 * (side // 8) ** 2
        (tmp_path / "small.jpg").write_bytes(small)
        (tmp_path / f"big{side}.jpg").write_bytes(big)
    got = subprocess.run(
        [sys.executable, "-c", _PEAK_RSS, str(tmp_path / "small.jpg"),
         str(tmp_path / "big32767.jpg")], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert got.returncode == 0, got.stderr
    refused, grew_kib, _ = got.stdout.split()
    assert refused == "True" and int(grew_kib) < 64 * 1024, got.stdout
    grey = bytes((tmp_path / "big2000.jpg").read_bytes())
    want = cv2.imdecode(np.frombuffer(grey, np.uint8), cv2.IMREAD_COLOR)
    assert want is not None and want.shape == (2000, 2000, 3)
    assert decode(grey) is None


def test_fixture_digests():
    """The committed bodies decode to the pixels whose sha256 was recorded
    from cv2 (here, cv2 decodes them to those pixels as well)."""
    with open(FIXTURES) as f:
        fixtures = json.load(f)
    assert {"camera_640x480", "camera_1280x720"} <= set(fixtures)
    for name, fx in fixtures.items():
        data = base64.b64decode(fx["data"])
        got = decode(data)
        assert got is not None, name
        assert list(got.shape) == fx["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == fx["sha256"], name
        if _have_cv2():
            np.testing.assert_array_equal(got, cv2_decode(data))


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


class _NoPipe:
    """A pipeline the batcher never reaches (every request here is
    refused before it)."""


def test_server_answers_400_for_refused_formats():
    cv2 = pytest.importorskip("cv2")
    img = natural(30, 40, 9)
    ok, png16 = cv2.imencode(".png", img.astype(np.uint16) * 257)
    server = PoseServer(_NoPipe(), port=0, max_batch=1)
    server.start()
    try:
        for body in (jpeg(img, progressive=True), png16.tobytes()):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/pose", data=body,
                method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 400
            assert json.loads(ei.value.read()) == {
                "error": "undecodable image"}
        assert server.batcher.stats()["batches"] == 0
    finally:
        server.close()


def test_decodes_in_parallel_threads():
    """Handler threads decode at once (ctypes drops the GIL): four threads
    give four results equal to one thread's."""
    data = jpeg(natural(240, 320, 10))
    want = decode(data)
    got = [None] * 4

    def run(i):
        got[i] = decode(data)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for g in got:
        np.testing.assert_array_equal(g, want)


# -------------------------------------------------- serving without cv2

from test_torch_serve import _port_pipe, params  # noqa: E402,F401


def test_post_jpeg_without_cv2_serves_islx_result(params, monkeypatch):
    """cv2 unimportable in the port: a JPEG POST of a 200x150 frame returns
    islx's result for the same frame decoded and resized by cv2."""
    import cv2

    from islx.serve import MicroBatcher as JMicroBatcher
    from test_torch_serve import _islx_pipe

    monkeypatch.setenv("ISLX_PALLAS_MASK", "1")
    monkeypatch.delenv("ISLX_PALLAS_NMS", raising=False)
    body = jpeg(natural(200, 150, 11), 90)
    jb = JMicroBatcher(_islx_pipe(params), max_batch=1, target_h=48)
    try:
        want = jb.pose(cv2.imdecode(np.frombuffer(body, np.uint8),
                                    cv2.IMREAD_COLOR), timeout=600)
    finally:
        jb.close()
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    server = PoseServer(_port_pipe(params), port=0, max_batch=1)
    server.batcher.target_h = 48
    server.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/pose",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            got = json.loads(resp.read())
    finally:
        server.close()
    cand = np.array(got["candidate"], np.float64).reshape(-1, 4)
    assert len(cand) > 0
    np.testing.assert_array_equal(cand[:, [0, 1, 3]],
                                  want.candidate[:, [0, 1, 3]])
    np.testing.assert_allclose(cand[:, 2], want.candidate[:, 2],
                               rtol=2 ** -10, atol=1e-7)
    subset = np.array(got["subset"], np.float64).reshape(
        -1, want.subset.shape[1])
    np.testing.assert_array_equal(subset[:, :-2], want.subset[:, :-2])
    np.testing.assert_allclose(subset[:, -2:], want.subset[:, -2:],
                               rtol=1e-3)
    assert [np.array(h).tolist() for h in got["hands"]] == \
        [h.tolist() for h in want.hands]


# ------------------------------------------------------------ the fixtures

def make_fixtures() -> dict:
    """name -> body bytes: small JPEGs of each kind and PNGs of each colour
    type, and the two camera-sized JPEGs the card's POST check sends."""
    small = natural(48, 64, 20)
    return {
        "jpeg_420_q75": jpeg(small, 75, "420"),
        "jpeg_422_rst_exif6": with_exif(jpeg(natural(30, 40, 21), 95, "422",
                                             restart=2), 6),
        "jpeg_440_q90": jpeg(natural(40, 24, 22), 90, "440"),
        "jpeg_444_optimized": jpeg(natural(17, 33, 23), 60, "444",
                                   optimize=True),
        "jpeg_grey": jpeg(natural(33, 17, 24)[:, :, 0], 50),
        "png_rgb": png(natural(9, 11, 25).astype(np.int64), 2, 8),
        "png_rgba_interlaced": png(np.random.RandomState(26).randint(
            0, 256, (13, 17, 4)), 6, 8, interlace=True, seed=26),
        "png_palette_interlaced": png_case(11, 13, 3, 8, True, 27),
        "png_grey": png_case(7, 9, 0, 8, False, 28),
        "png_grey_alpha": png_case(6, 5, 4, 8, False, 29),
        "camera_640x480": jpeg(natural(480, 640, 30, 2.0), 75, "420"),
        "camera_1280x720": jpeg(natural(720, 1280, 31, 2.0), 75, "420"),
    }


def write_fixtures(path: str = FIXTURES) -> None:
    out = {}
    for name, data in make_fixtures().items():
        img = cv2_decode(data)
        out[name] = {"shape": list(img.shape),
                     "sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                     "data": base64.b64encode(data).decode()}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def fuzz(n: int = 4000, seed: int = 0) -> dict:
    """Seeded corruptions of small JPEGs (scan bytes changed, a header byte
    changed, a marker put in the scan, the scan cut and closed with EOI),
    each decoded by cv2 and the port: the tally of outcomes."""
    import collections

    rng = np.random.RandomState(seed)
    bases = [jpeg(natural(h, w, i), q, smp, restart=r)
             for i, (h, w, q, smp, r) in enumerate(
                 [(40, 56, 80, "420", 0), (33, 17, 60, "422", 2),
                  (24, 40, 95, "444", 1), (31, 45, 70, "440", 3)])]
    bases.append(jpeg(natural(33, 17, 9)[:, :, 0], 50))
    kinds = ("scan bytes", "header byte", "marker in scan", "cut")
    tally = collections.Counter()
    for it in range(n):
        d = bytearray(bases[it % len(bases)])
        start, end = _scan_bounds(bytes(d))
        kind = rng.randint(4)
        if kind == 0:
            for _ in range(rng.randint(1, 4)):
                d[rng.randint(start, end)] = rng.randint(256)
        elif kind == 1:
            d[rng.randint(2, start)] = rng.randint(256)
        elif kind == 2:
            p = rng.randint(start, end)
            d[p:p] = bytes([0xFF, rng.choice([0xD0 + rng.randint(8), 0xD9,
                                              0xC4, 0x01, 0xE3])])
        else:
            d = d[:rng.randint(start, end)] + b"\xff\xd9"
        try:
            want = cv2_decode(bytes(d))
        except Exception:          # cv2.error
            want = None
        got = decode(bytes(d))
        outcome = ("both None" if want is None and got is None else
                   "port None" if got is None else
                   "cv2 None" if want is None else
                   "equal" if np.array_equal(want, got) else "differ")
        tally[(kinds[kind], outcome)] += 1
    return dict(sorted(tally.items()))


def fuzz_png(n: int = 3000, seed: int = 0) -> dict:
    """Seeded corruptions of small 8-bit PNGs (IDAT bytes changed under a
    good CRC, a byte changed anywhere, rows with extra zlib data, a broken
    Adler-32, the body cut after the IDAT chunk, the zlib stream cut), each
    decoded by cv2 and the port: the tally of outcomes."""
    import collections

    rng = np.random.RandomState(seed)
    bases = [png_case(13, 17, 2, 8, False, 1), png_case(9, 11, 6, 8, True, 2),
             png_case(10, 12, 3, 8, False, 3), png_case(7, 9, 0, 8, True, 4),
             png_case(8, 8, 4, 8, False, 5)]
    kinds = ("IDAT bytes", "any byte", "extra zlib data", "Adler-32",
             "cut after IDAT", "zlib cut")
    tally = collections.Counter()
    for it in range(n):
        d = bytearray(bases[it % len(bases)])
        at = d.find(b"IDAT")
        size = struct.unpack(">I", d[at - 4:at])[0]
        comp = bytes(d[at + 4:at + 4 + size])
        kind = rng.randint(6)
        if kind == 0:
            comp = bytearray(comp)
            for _ in range(rng.randint(1, 3)):
                comp[rng.randint(size)] = rng.randint(256)
        elif kind == 1:
            d[rng.randint(8, len(d))] = rng.randint(256)
        elif kind == 2:
            comp = zlib.compress(zlib.decompress(comp) + bytes(
                rng.randint(0, 256, rng.randint(1, 40)).astype(np.uint8)))
        elif kind == 3:
            comp = bytearray(comp)
            comp[-1 - rng.randint(4)] ^= 1 + rng.randint(255)
        elif kind == 4:
            end = at + 8 + size
            d = d[:end + rng.randint(0, len(d) - end + 1)]
        else:
            comp = comp[:rng.randint(2, len(comp))]
        if kind not in (1, 4):
            d = d[:at - 4] + _chunk(b"IDAT", bytes(comp)) + d[at + 8 + size:]
        try:
            want = cv2_decode(bytes(d))
        except Exception:          # cv2.error
            want = None
        got = decode(bytes(d))
        outcome = ("both None" if want is None and got is None else
                   "port None" if got is None else
                   "cv2 None" if want is None else
                   "equal" if np.array_equal(want, got) else "differ")
        tally[(kinds[kind], outcome)] += 1
    return dict(sorted(tally.items()))


if __name__ == "__main__":
    if sys.argv[1:] == ["fuzz"]:
        for name, tally in (("JPEG", fuzz()), ("PNG", fuzz_png())):
            for (kind, outcome), count in tally.items():
                print(f"{name:4s} {kind:15s} {outcome:10s} {count}")
    else:
        write_fixtures()
        print(f"wrote {FIXTURES} ({os.path.getsize(FIXTURES)} bytes)")
