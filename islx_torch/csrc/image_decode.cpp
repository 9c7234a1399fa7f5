// Image decoding on the host: baseline and extended-sequential Huffman JPEG,
// and the PNG scanline stage, to u8 BGR pixels equal to what
// cv2.imdecode(buf, cv2.IMREAD_COLOR) gives for the same bytes.
//
// Replaces no TPU kernel: islx decodes POST bodies with cv2 on the host
// (islx/serve/http.py), and the port's machine has no cv2. The work is
// sequential by nature (Huffman bit streams, PNG's Paeth filter along a
// row), so it stays on the host; islx_torch/serve/decode.py binds it.
//
// JPEG: what libjpeg-turbo (3.1) computes as cv2 calls it (JCS_EXT_BGR
// output, its default options):
//   - one scan of every component (interleaved, or the one component of a
//     grey frame), decoded and written out one iMCU row at a time as
//     libjpeg's single-pass mode does: what follows the scan does not
//     change the image;
//   - Huffman decoding (the standard tables in slots 0 and 1 that no DHT
//     defined, as Motion-JPEG frames need), restart markers
//     (resynchronised as jpeg_resync_to_restart does), DC prediction, and
//     libjpeg's rule for data that ends at a marker: the MCU that runs out
//     is decoded from zero bits and the rest of its restart interval is
//     left zero;
//   - the ISLOW integer IDCT (jidctint.c: 13-bit constants, 2 pass bits)
//     in the 16- and 32-bit lanes of its AVX2 form, which cv2 runs;
//   - "fancy" upsampling (jdsample.c): the triangle filter for h2v1 and h2v2
//     where the chroma is more than 2 samples wide (else the box filter, as
//     libjpeg-turbo chooses) and for h1v2; edges replicate;
//   - the jdcolor.c YCbCr->RGB tables (16-bit fixed point), grey replicated.
// Taken: 1 component, or 3 (YCbCr) sampled 4:4:4, 4:2:2, 4:2:0 or 4:4:0
// (luma 1x1, 2x1, 2x2 or 1x2 over 1x1 chroma). Refused (the caller returns
// None): progressive, lossless, hierarchical and arithmetic-coded frames,
// precision other than 8 bits, 2 or 4 components, other samplings, RGB
// frames (Adobe transform 0, or component ids 'R','G','B' without JFIF),
// frames of several sequential scans, a DNL height, a frame of more blocks
// than 4 a byte of the data (each coded block takes at least 2 bits: a
// body that short cannot hold the frame, and nothing is allocated for it),
// and data that ends before the scan's closing marker (cv2 refuses those
// too). Memory holds one iMCU row of coefficients and 16 sample rows a
// component besides the output.
//
// PNG: the caller (Python) checks the chunks and inflates the IDAT stream
// with zlib; this unfilters the scanlines (None, Sub, Up, Average, Paeth),
// walks the Adam7 passes, and expands 8-bit grey, grey+alpha, RGB, RGBA and
// palette pixels to BGR as libpng's transforms under cv2 do (grey
// replicated, alpha dropped, palette entries past the PLTE chunk black).
//
// ABI (islx_torch/serve/decode.py): plain C, raw pointers, caller-allocated
// outputs; nothing here touches Python, so ctypes runs it without the GIL.
// Built at first use by islx_torch/ops/_build.py with
// g++ -O3 -shared -fPIC -std=c++17.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ JPEG

// zig-zag -> natural order, with 16 extra entries that send a run past
// coefficient 63 to 63, as libjpeg's table does for corrupt data
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Status { kOk = 0, kRefused = 1, kBad = 2, kShort = 3 };

// A DHT body of the standard tables (JPEG Annex K.3: luma DC, chroma DC,
// luma AC, chroma AC in slots 0 and 1). libjpeg-turbo takes them for the
// slots 0 and 1 that no DHT defined: Motion-JPEG camera frames carry none.
const uint8_t kStdDht[416] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06,
    0x07, 0x08, 0x09, 0x0a, 0x0b, 0x10, 0x00, 0x02, 0x01, 0x03, 0x03, 0x02,
    0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01, 0x7d, 0x01, 0x02,
    0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42,
    0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09,
    0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a,
    0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47,
    0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77,
    0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8,
    0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4,
    0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6,
    0xf7, 0xf8, 0xf9, 0xfa, 0x01, 0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01,
    0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02,
    0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b, 0x11, 0x00, 0x02,
    0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04, 0x00, 0x01,
    0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06,
    0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62,
    0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19,
    0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a,
    0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a,
    0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85,
    0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;        // a DHT gave it
  bool built = false;          // derived at the first scan that uses it
  uint8_t bits[16];
  uint8_t val[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  // (length << 8 | symbol) of each kLookBits-bit prefix; 0 where the code
  // is longer
  uint16_t look[1 << kLookBits];
};

// libjpeg's jpeg_make_d_derived_tbl (run when a scan first uses the table,
// as libjpeg runs it); false on a table it rejects.
bool build_huff(Huff& t, bool dc) {
  int size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = t.bits[l - 1];
    if (p + n > 256) return false;
    while (n--) size[p++] = l;
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l - 1]) {
      t.valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += t.bits[l - 1];
      t.maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (t.val[i] > 15) return false;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l)
    for (int i = 0; i < t.bits[l - 1]; ++i, ++p) {
      const uint32_t first = code_of[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
        t.look[first + k] = static_cast<uint16_t>(l << 8 | t.val[p]);
    }
  t.built = true;
  return true;
}

// libjpeg's next_marker from d[pos]: skip to an 0xFF, swallow fill 0xFFs
// and take the byte after them (an 0xFF00 is data: skip it and go on).
// Returns the marker with pos past it, 0 when the data ends first.
int find_marker(const uint8_t* d, size_t n, size_t& pos) {
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return 0;
    const int m = d[pos++];
    if (m) return m;
  }
}

// The entropy-coded segment's bits: 0xFF00 is a data 0xFF, fill 0xFFs are
// skipped, and a marker ends the data (zeros follow, as in libjpeg). Bytes
// that run out before a marker is seen fail the decode (cv2's source has
// no more data to give, and libjpeg suspends).
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int left = 0;
  int real = 0;              // leading bits of buf that came from the data
  int marker = 0;            // the marker that ended the data, 0 before one
  bool short_data = false;
  bool insufficient = false; // a bit past the marker was used (libjpeg's
                             // insufficient_data)

  void fill() {
    while (left <= 56) {
      uint32_t c = 0;
      if (!marker) {
        if (pos >= n) {
          short_data = true;
        } else {
          c = d[pos++];
          if (c == 0xFF) {
            uint32_t m = 0;
            do {
              if (pos >= n) {
                short_data = true;
                break;
              }
              m = d[pos++];
            } while (m == 0xFF);
            if (short_data) {
              c = 0;
            } else if (m != 0) {
              marker = static_cast<int>(m);
              c = 0;
            }
          }
          if (!marker && !short_data) real += 8;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - left);
      left += 8;
    }
  }
  uint32_t peek(int k) {
    if (left < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    left -= k;
    if (k > real) insufficient = true;
    real = std::max(real - k, 0);
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  // libjpeg's read_restart_marker with jpeg_resync_to_restart: throw away
  // the buffered bits, take the next marker, and consume it when it is
  // the expected RSTn (want) or too far from it; leave it for the decoder
  // (which then reads zeros) when it is another marker or one of the next
  // two RSTs; skip to the next marker past one of the two before.
  void restart(int want) {
    buf = 0;
    left = real = 0;
    if (!marker) marker = find_marker(d, n, pos);
    while (marker) {
      const int k = marker - 0xD0;
      int action = 1;
      if (marker < 0xC0)
        action = 2;
      else if (k < 0 || k > 7 || k == ((want + 1) & 7) ||
               k == ((want + 2) & 7))
        action = 3;
      else if (k == ((want - 1) & 7) || k == ((want - 2) & 7))
        action = 2;
      if (action == 1) {
        marker = 0;
        insufficient = false;
        return;
      }
      if (action == 3) return;
      marker = find_marker(d, n, pos);
    }
    short_data = true;
  }
};

int decode_sym(Bits& b, const Huff& t) {
  const uint32_t look = t.look[b.peek(kLookBits)];
  if (look) {
    b.skip(look >> 8);
    return look & 0xFF;
  }
  int l = kLookBits + 1;
  int32_t code = static_cast<int32_t>(b.get(l));
  while (code > t.maxcode[l]) {
    code = (code << 1) | static_cast<int32_t>(b.get(1));
    ++l;
  }
  if (l > 16) return 0;                // bad code: libjpeg fakes a zero
  return t.val[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---- ISLOW IDCT (jidctint.c) in the lanes of libjpeg-turbo's AVX2 form
//
// The same arithmetic in 16- and 32-bit lanes: dequantized coefficients
// wrap to 16 bits, the sums in0 + in4, in7 + in3 and in5 + in1 are 16-bit
// adds, the products (pairs of 16-bit terms, the rotations folded in) and
// the sums after them wrap at 32 bits; pass 1's outputs saturate to 16
// bits, pass 2's to 16 and then 8 bits; a block whose rows 1-7 are zero
// takes the DC path (a 16-bit shift). On valid data nothing wraps or
// saturates before the output and this is jidctint.c's integer result; on
// corrupt data it is still cv2's.

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int32_t wrap16(int64_t x) {
  return static_cast<int16_t>(static_cast<uint16_t>(x));
}
inline int32_t wrap32(int64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}
inline int32_t sat(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// (x + 2^(n-1)) >> n in a 32-bit lane
inline int32_t descale(int32_t x, int n) {
  return wrap32(int64_t{x} + (1 << (n - 1))) >> n;
}
// a * ca + b * cb, one vpmaddwd lane
inline int32_t madd(int32_t a, int32_t ca, int32_t b, int32_t cb) {
  return wrap32(int64_t{a} * ca + int64_t{b} * cb);
}
inline int32_t add(int32_t a, int32_t b) { return wrap32(int64_t{a} + b); }
inline int32_t sub(int32_t a, int32_t b) { return wrap32(int64_t{a} - b); }

// One 1-D pass over 8 16-bit inputs, stride `step` -> 8 32-bit sums
// before their descale.
void idct_pass(const int32_t* in, int step, int32_t* o) {
  auto x = [&](int k) { return in[k * step]; };
  const int32_t tmp3 = madd(x(2), F0541 + F0765, x(6), F0541);
  const int32_t tmp2 = madd(x(2), F0541, x(6), F0541 - F1847);
  const int64_t one = int64_t{1} << kConstBits;
  const int32_t tmp0 = wrap32(wrap16(x(0) + x(4)) * one);
  const int32_t tmp1 = wrap32(wrap16(x(0) - x(4)) * one);
  const int32_t tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
  const int32_t tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  const int32_t z3 = wrap16(x(7) + x(3)), z4 = wrap16(x(5) + x(1));
  const int32_t r3 = madd(z3, F1175 - F1961, z4, F1175);
  const int32_t r4 = madd(z3, F1175, z4, F1175 - F0390);
  const int32_t o0 = add(madd(x(7), F0298 - F0899, x(1), -F0899), r3);
  const int32_t o3 = add(madd(x(7), -F0899, x(1), F1501 - F0899), r4);
  const int32_t o1 = add(madd(x(5), F2053 - F2562, x(3), -F2562), r4);
  const int32_t o2 = add(madd(x(5), -F2562, x(3), F3072 - F2562), r3);
  o[0] = add(tmp10, o3);
  o[7] = sub(tmp10, o3);
  o[1] = add(tmp11, o2);
  o[6] = sub(tmp11, o2);
  o[2] = add(tmp12, o1);
  o[5] = sub(tmp12, o1);
  o[3] = add(tmp13, o0);
  o[4] = sub(tmp13, o0);
}

void idct_islow(const int16_t* in, const uint16_t* qt, uint8_t* out,
                size_t stride) {
  int32_t dq[64], ws[64], o[8];
  bool ac = false;
  for (int i = 0; i < 64; ++i) {
    dq[i] = wrap16(int64_t{in[i]} * qt[i]);
    ac = ac || (i >= 8 && in[i]);
  }
  for (int c = 0; c < 8; ++c) {
    if (!ac) {
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = wrap16(dq[c] * (1 << kPass1Bits));
      continue;
    }
    idct_pass(dq + c, 8, o);
    for (int r = 0; r < 8; ++r)
      ws[8 * r + c] =
          sat(descale(o[r], kConstBits - kPass1Bits), -32768, 32767);
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, 1, o);
    for (int c = 0; c < 8; ++c) {
      const int32_t v = sat(descale(o[c], kConstBits + kPass1Bits + 3),
                            -32768, 32767);
      out[r * stride + c] = static_cast<uint8_t>(sat(v, -128, 127) + 128);
    }
  }
}

// ---- upsampling of one output row of a component (jdsample.c)

// plane: a ring of `ring` rows of the component's samples, stride pw;
// (dw, dh) its valid size; (hr, vr) in {1, 2}. sums: scratch for dw + 2
// ints. Edges replicate (libjpeg's special first and last columns and its
// context rows come to the same).
void upsample_row(const uint8_t* plane, size_t pw, int ring, int dw, int dh,
                  int hr, int vr, int y, int width, uint8_t* out, int* sums) {
  auto at = [&](int r) {
    return plane + static_cast<size_t>(r % ring) * pw;
  };
  if (hr == 1 && vr == 1) {
    std::memcpy(out, at(y), width);
    return;
  }
  const bool fancy_h = hr == 2 && dw > 2;
  const uint8_t* in0 = at(vr == 2 ? y >> 1 : y);
  // the next nearest row of a vertical triangle filter
  const uint8_t* in1 =
      vr != 2 ? nullptr
              : at((y & 1) ? std::min((y >> 1) + 1, dh - 1)
                           : std::max((y >> 1) - 1, 0));
  if (hr == 2 && vr == 1 && fancy_h) {
    int* s = sums + 1;
    for (int c = 0; c < dw; ++c) s[c] = in0[c];
    s[-1] = s[0];
    s[dw] = s[dw - 1];
    for (int c = 0; 2 * c < width; ++c) {
      out[2 * c] = static_cast<uint8_t>((s[c] * 3 + s[c - 1] + 1) >> 2);
      if (2 * c + 1 < width)
        out[2 * c + 1] = static_cast<uint8_t>((s[c] * 3 + s[c + 1] + 2) >> 2);
    }
    return;
  }
  if (hr == 1 && vr == 2) {
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < width; ++x)
      out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    return;
  }
  if (hr == 2 && vr == 2 && fancy_h) {
    int* s = sums + 1;                 // column sums of the two rows
    for (int c = 0; c < dw; ++c) s[c] = in0[c] * 3 + in1[c];
    s[-1] = s[0];
    s[dw] = s[dw - 1];
    for (int c = 0; 2 * c < width; ++c) {
      out[2 * c] = static_cast<uint8_t>((s[c] * 3 + s[c - 1] + 8) >> 4);
      if (2 * c + 1 < width)
        out[2 * c + 1] = static_cast<uint8_t>((s[c] * 3 + s[c + 1] + 7) >> 4);
    }
    return;
  }
  // the box filter: h2v1 and h2v2 on chroma at most 2 samples wide
  const uint8_t* in = at(y / vr);
  for (int x = 0; x < width; ++x) out[x] = in[x / hr];
}

// jdcolor.c's YCbCr->RGB tables (16-bit fixed point)
constexpr int kScale = 16;
struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << kScale) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t limit(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int hr = 1, vr = 1;          // upsampling ratios (hmax / h, vmax / v)
  int bw = 0, bh = 0;          // blocks of the interleaved grid
  int dw = 0, dh = 0;          // downsampled size in samples
  int nbw = 0, nbh = 0;        // blocks that hold samples (a
                               // non-interleaved scan's)
  int dc_tbl = 0, ac_tbl = 0;
  uint16_t qt[64] = {};        // the table the scan found for tq
  std::vector<int16_t> coef;   // one iMCU row: v * bw * 64
  int ring = 0;                // sample rows plane holds, 16 v (a ring)
  std::vector<uint8_t> plane;  // ring * bw * 8

  int16_t* block(int bx, int by) {
    return &coef[(static_cast<size_t>(by % v) * bw + bx) * 64];
  }
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Comp comp[3];
  uint16_t q[4][64];
  bool q_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  size_t exif_off = 0, exif_len = 0;
  // the output: [height, width, 3] BGR, rows written so far, scratch
  uint8_t* out = nullptr;
  int y_out = 0;
  std::vector<uint8_t> rows;
  std::vector<int> sums;

  int next_marker() { return find_marker(d, n, pos); }
  bool segment(size_t& start, size_t& len) {
    if (pos + 2 > n) return false;
    len = (static_cast<size_t>(d[pos]) << 8) | d[pos + 1];
    if (len < 2 || pos + len > n) return false;
    start = pos + 2;
    len -= 2;
    pos += len + 2;
    return true;
  }

  int read_dqt(const uint8_t* s, size_t len) {
    size_t i = 0;
    while (i < len) {
      const int pq = s[i] >> 4, tq = s[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) return kBad;
      const size_t need = pq ? 128 : 64;
      if (i + need > len) return kBad;
      for (int k = 0; k < 64; ++k)
        q[tq][kNatural[k]] = pq ? static_cast<uint16_t>(s[i + 2 * k] << 8 |
                                                        s[i + 2 * k + 1])
                                : s[i + k];
      q_defined[tq] = true;
      i += need;
    }
    return kOk;
  }
  // with only_undefined, the tables of slots no DHT gave (std_huff_tables)
  int read_dht(const uint8_t* s, size_t len, bool only_undefined = false) {
    size_t i = 0;
    while (i < len) {
      if (i + 17 > len) return kBad;
      const int tc = s[i] >> 4, th = s[i] & 15;
      const uint8_t* bits = s + i + 1;
      int total = 0;
      for (int l = 0; l < 16; ++l) total += bits[l];
      if (tc > 1 || th > 3 || total > 256 || i + 17 + total > len)
        return kBad;
      Huff& t = tc ? ac[th] : dc[th];
      if (only_undefined && t.defined) {
        i += 17 + total;
        continue;
      }
      std::memcpy(t.bits, bits, 16);
      std::memset(t.val, 0, sizeof(t.val));
      std::memcpy(t.val, s + i + 17, total);
      t.defined = true;
      t.built = false;
      i += 17 + total;
    }
    return kOk;
  }
  int read_sof(const uint8_t* s, size_t len) {
    if (frame || len < 6) return kBad;
    if (s[0] != 8) return kRefused;
    height = s[1] << 8 | s[2];
    width = s[3] << 8 | s[4];
    ncomp = s[5];
    if (height == 0) return kRefused;      // DNL
    if (width == 0) return kBad;
    if (ncomp != 1 && ncomp != 3) return kRefused;
    if (len != 6 + 3 * static_cast<size_t>(ncomp)) return kBad;
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return kBad;
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    // 4:4:4, 4:2:2, 4:2:0 or 4:4:0
    if (ncomp == 3 && (comp[0].h > 2 || comp[0].v > 2 || comp[1].h != 1 ||
                       comp[1].v != 1 || comp[2].h != 1 || comp[2].v != 1))
      return kRefused;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    int64_t blocks = 0;
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      k.hr = hmax / k.h;
      k.vr = vmax / k.v;
      k.dw = static_cast<int>((static_cast<int64_t>(width) * k.h + hmax - 1)
                              / hmax);
      k.dh = static_cast<int>((static_cast<int64_t>(height) * k.v + vmax - 1)
                              / vmax);
      k.nbw = (k.dw + 7) / 8;
      k.nbh = (k.dh + 7) / 8;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      blocks += static_cast<int64_t>(k.nbw) * k.nbh;
    }
    // every coded block takes at least 2 bits (a DC and an AC code)
    if (blocks > 4 * static_cast<int64_t>(n)) return kRefused;
    frame = true;
    return kOk;
  }

  // A colour frame with RGB components (libjpeg's default_decompress_parms)
  bool rgb() const {
    if (ncomp != 3 || jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // Markers up to the first SOS (exclusive): tables, frame, APPn.
  int header() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kBad;
    for (;;) {
      const int m = next_marker();
      if (m == 0) return kShort;
      if (m == 0xDA) {
        if (!frame) return kBad;
        // a first scan without every component: a multi-scan frame
        if (rgb() || (pos + 2 < n && d[pos + 2] != ncomp)) return kRefused;
        return kOk;
      }
      if (m == 0xD9) return kBad;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      // a second SOI, JPG, DHP, EXP, JPGn or RESn: libjpeg's
      // JERR_SOI_DUPLICATE or JERR_UNKNOWN_MARKER
      if (m < 0xC0 || m == 0xC8 || m == 0xD8 || m == 0xDE || m == 0xDF ||
          (m >= 0xF0 && m <= 0xFD))
        return kBad;
      size_t s, len;
      if (!segment(s, len)) return kShort;
      int st = kOk;
      if (m == 0xC0 || m == 0xC1) {
        st = read_sof(d + s, len);
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8) {
        st = kRefused;         // progressive, lossless, arithmetic, ...
      } else if (m == 0xDB) {
        st = read_dqt(d + s, len);
      } else if (m == 0xC4) {
        st = read_dht(d + s, len);
      } else if (m == 0xDD) {
        if (len != 2) return kBad;
        restart_interval = d[s] << 8 | d[s + 1];
      } else if (m == 0xE0) {
        if (len >= 5 && !std::memcmp(d + s, "JFIF\0", 5)) jfif = true;
      } else if (m == 0xE1) {
        if (!exif_len && len > 6 && !std::memcmp(d + s, "Exif\0\0", 6)) {
          exif_off = s + 6;
          exif_len = len - 6;
        }
      } else if (m == 0xEE) {
        if (len >= 12 && !std::memcmp(d + s, "Adobe", 5)) {
          adobe = true;
          adobe_transform = d[s + 11];
        }
      }
      if (st != kOk) return st;
    }
  }

  // Output row y: each component upsampled from its ring, then to BGR.
  void emit_row(int y) {
    const int w = width;
    for (int c = 0; c < ncomp; ++c) {
      const Comp& k = comp[c];
      upsample_row(k.plane.data(), static_cast<size_t>(k.bw) * 8, k.ring,
                   k.dw, k.dh, k.hr, k.vr, y, w,
                   rows.data() + static_cast<size_t>(c) * w, sums.data());
    }
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    const uint8_t* c0 = rows.data();
    if (ncomp == 1) {
      for (int x = 0; x < w; ++x)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
      return;
    }
    const uint8_t* c1 = c0 + w;
    const uint8_t* c2 = c1 + w;
    const ColorTables& t = color_tables();
    for (int x = 0; x < w; ++x) {
      const int yv = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x + 2] = limit(yv + t.cr_r[cr]);
      o[3 * x + 1] =
          limit(yv + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> kScale));
      o[3 * x] = limit(yv + t.cb_b[cb]);
    }
  }

  // The IDCT of iMCU row m's blocks into the components' rings, then every
  // output row whose samples (with the triangle filter's next row) are in.
  void imcu_row(int m) {
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      const size_t pw = static_cast<size_t>(k.bw) * 8;
      for (int by = m * k.v; by < std::min((m + 1) * k.v, k.nbh); ++by)
        for (int bx = 0; bx < k.nbw; ++bx)
          idct_islow(k.block(bx, by), k.qt,
                     &k.plane[(by * 8 % k.ring) * pw + bx * 8], pw);
    }
    for (; y_out < height; ++y_out) {
      bool ready = true;
      for (int c = 0; c < ncomp && m < mcuy - 1; ++c) {
        const Comp& k = comp[c];
        ready = ready && std::min(y_out / k.vr + 1, k.dh - 1) <
                             std::min((m + 1) * k.v * 8, k.dh);
      }
      if (!ready) break;
      emit_row(y_out);
    }
  }

  // The scan of every component, written out an iMCU row at a time.
  int scan(const uint8_t* s, size_t len) {
    if (len < 1) return kBad;
    const int ns = s[0];
    if (ns != ncomp || len != 4 + 2 * static_cast<size_t>(ns)) return kBad;
    read_dht(kStdDht, sizeof(kStdDht), true);
    Comp* in[3];
    for (int i = 0; i < ns; ++i) {
      const int id = s[1 + 2 * i];
      int c = 0;
      while (c < ncomp && comp[c].id != id) ++c;
      if (c == ncomp || std::find(in, in + i, &comp[c]) != in + i)
        return kBad;
      Comp& k = comp[c];
      in[i] = &k;
      k.dc_tbl = s[2 + 2 * i] >> 4;
      k.ac_tbl = s[2 + 2 * i] & 15;
      if (k.dc_tbl > 3 || k.ac_tbl > 3) return kBad;
      Huff& hd = dc[k.dc_tbl];
      Huff& ha = ac[k.ac_tbl];
      if (!hd.defined || !ha.defined) return kBad;
      if ((!hd.built && !build_huff(hd, true)) ||
          (!ha.built && !build_huff(ha, false)))
        return kBad;
      if (!q_defined[k.tq]) return kBad;   // latch_quant_tables
      std::memcpy(k.qt, q[k.tq], sizeof(k.qt));
    }
    Bits b{d, n, pos};
    uint32_t pred[3] = {0, 0, 0};
    const bool inter = ns > 1;
    const int per_row = inter ? mcux : in[0]->nbw;
    const int nrows = inter ? mcuy : in[0]->nbh;
    const int imcu = inter ? 1 : in[0]->v;   // MCU rows an iMCU row
    int todo = restart_interval, want = 0;
    for (int u = 0; u < per_row * nrows; ++u) {
      if (restart_interval) {
        if (todo == 0) {
          b.restart(want);
          if (b.short_data) return kShort;
          want = (want + 1) & 7;
          pred[0] = pred[1] = pred[2] = 0;
          todo = restart_interval;
        }
        --todo;
      }
      const int row = u / per_row, col = u % per_row;
      if (col == 0 && row % imcu == 0)
        for (int i = 0; i < ns; ++i)
          std::fill(in[i]->coef.begin(), in[i]->coef.end(), 0);
      // once the data ran out at a marker, later MCUs stay zero (the one
      // that ran out is decoded to its end from zero bits)
      const bool skip = b.insufficient;
      for (int i = 0; i < ns && !skip; ++i) {
        Comp& k = *in[i];
        const Huff& hd = dc[k.dc_tbl];
        const Huff& ha = ac[k.ac_tbl];
        const int nx = inter ? k.h : 1, ny = inter ? k.v : 1;
        const int bx0 = col * nx, by0 = row * ny;
        for (int yy = 0; yy < ny; ++yy)
          for (int xx = 0; xx < nx; ++xx) {
            int16_t* blk = k.block(bx0 + xx, by0 + yy);
            const int t = decode_sym(b, hd);
            const int diff = t ? extend(static_cast<int>(b.get(t)), t) : 0;
            pred[i] += static_cast<uint32_t>(diff);
            blk[0] = static_cast<int16_t>(pred[i]);
            for (int kk = 1; kk < 64; ++kk) {
              const int rs = decode_sym(b, ha);
              const int r = rs >> 4, sz = rs & 15;
              if (sz) {
                kk += r;
                const int v = extend(static_cast<int>(b.get(sz)), sz);
                blk[kNatural[kk]] = static_cast<int16_t>(v);
              } else {
                if (r != 15) break;
                kk += 15;
              }
            }
          }
      }
      if (b.short_data) return kShort;
      if (col == per_row - 1 &&
          ((row + 1) % imcu == 0 || row == nrows - 1))
        imcu_row(row / imcu);
    }
    // the scan's data has to end at a marker inside the buffer; what
    // follows is read by libjpeg only after cv2 has the rows
    size_t p = b.pos;
    return b.marker || find_marker(d, n, p) ? kOk : kShort;
  }

  // From just past the first SOS marker to the image in out.
  int body(uint8_t* dst) {
    out = dst;
    rows.assign(static_cast<size_t>(width) * ncomp, 0);
    sums.assign(static_cast<size_t>(width) + 2, 0);
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      k.coef.assign(static_cast<size_t>(k.v) * k.bw * 64, 0);
      k.ring = 16 * k.v;
      k.plane.assign(static_cast<size_t>(k.ring) * k.bw * 8, 0);
    }
    size_t s, len;
    if (!segment(s, len)) return kShort;
    return scan(d + s, len);
  }
};

// ------------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Unfilter one row in place; prev is the previous unfiltered row (zeros for
// the first); false on an unknown filter type.
bool unfilter(int type, uint8_t* row, const uint8_t* prev, size_t len,
              int bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < len; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < len; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < len; ++i) {
        const int a = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
        row[i] += static_cast<uint8_t>((a + prev[i]) >> 1);
      }
      return true;
    case 4:
      for (size_t i = 0; i < len; ++i) {
        const bool left = i >= static_cast<size_t>(bpp);
        row[i] += static_cast<uint8_t>(paeth(left ? row[i - bpp] : 0, prev[i],
                                             left ? prev[i - bpp] : 0));
      }
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// JPEG header: info[0..3] = height, width, offset and length of the first
// APP1 Exif payload (the TIFF header on; 0 0 without one). Returns 0 for a
// frame this decoder takes, 1 for one it refuses, 2 for bad data, 3 for
// data that ends too early.
int islx_jpeg_info(const uint8_t* data, size_t n, int64_t* info) {
  Jpeg j;
  j.d = data;
  j.n = n;
  const int st = j.header();
  if (st != kOk) return st;
  info[0] = j.height;
  info[1] = j.width;
  info[2] = static_cast<int64_t>(j.exif_off);
  info[3] = static_cast<int64_t>(j.exif_len);
  return kOk;
}

// Decode a JPEG into out [height, width, 3] u8 BGR (the sizes
// islx_jpeg_info gave). Same return codes.
int islx_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int height,
                     int width) {
  Jpeg j;
  j.d = data;
  j.n = n;
  const int st = j.header();
  if (st != kOk) return st;
  if (j.height != height || j.width != width) return kBad;
  return j.body(out);
}

// PNG scanlines: raw is the inflated IDAT stream (n bytes), filtered rows of
// a width x height 8-bit image of colour type 0, 2, 3, 4 or 6, interlaced
// (Adam7) when interlace is 1; plte holds 256 RGB entries (zeros past the
// PLTE chunk's). Writes out [height, width, 3] u8 BGR. Returns 0, 2 for an
// unknown filter type, 3 when raw is too short.
int islx_png_unfilter(const uint8_t* raw, size_t n, int width, int height,
                      int color_type, int interlace, const uint8_t* plte,
                      uint8_t* out) {
  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                  {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                  {0, 1, 1, 2}};
  static const int kWhole[4] = {0, 0, 1, 1};
  const int chans = color_type == 2 ? 3 : color_type == 4 ? 2
                                      : color_type == 6 ? 4 : 1;
  size_t at = 0;
  std::vector<uint8_t> row, prev;
  for (int p = 0; p < (interlace ? 7 : 1); ++p) {
    const int* pass = interlace ? kPass[p] : kWhole;
    const int x0 = pass[0], y0 = pass[1], dx = pass[2], dy = pass[3];
    const int pw = (width - x0 + dx - 1) / dx;
    const int ph = (height - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t len = static_cast<size_t>(pw) * chans;
    prev.assign(len, 0);
    row.resize(len);
    for (int r = 0; r < ph; ++r) {
      if (at + 1 + len > n) return kShort;
      const int type = raw[at];
      std::memcpy(row.data(), raw + at + 1, len);
      at += 1 + len;
      if (!unfilter(type, row.data(), prev.data(), len, chans)) return kBad;
      uint8_t* o = out + (static_cast<size_t>(y0 + r * dy) * width + x0) * 3;
      const size_t step = static_cast<size_t>(dx) * 3;
      const uint8_t* s = row.data();
      for (int i = 0; i < pw; ++i, o += step, s += chans) {
        switch (color_type) {
          case 0:
          case 4:
            o[0] = o[1] = o[2] = s[0];
            break;
          case 3:
            o[0] = plte[3 * s[0] + 2];
            o[1] = plte[3 * s[0] + 1];
            o[2] = plte[3 * s[0]];
            break;
          default:               // 2, 6
            o[0] = s[2];
            o[1] = s[1];
            o[2] = s[0];
        }
      }
      std::swap(row, prev);
    }
  }
  return kOk;
}

}  // extern "C"
