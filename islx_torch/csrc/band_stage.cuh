// Row-band staging and the 4-neighbour peak test shared by the NMS kernels
// (nms_first_k.cu, nms_mask.cu), CUDA C++ for sm_90a.
//
// A band is rows [y0, y1) of one [h, w] plane (the wrappers' band_plan,
// islx_torch/ops/_bands.py). A block copies the band and one halo row
// above and below into shared memory with 16-byte cp.async copies, all
// issued before any is waited for; a row start off a 16-byte boundary
// goes through a scalar head and tail.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Peak bits of kPx consecutive pixels of one row, the first at shared slot
// p, row y, column x: bit t is pixel x + t. kPx = 4 reads them as float4
// (p and the row length w are multiples of 4 floats, so a quad never
// straddles two rows); kPx = 1 is the general path.
template <int kPx>
__device__ __forceinline__ unsigned peak_bits(const float* p, int y, int x,
                                              int h, int w, float thre,
                                              float border);

template <>
__device__ __forceinline__ unsigned peak_bits<1>(const float* p, int y, int x,
                                                 int h, int w, float thre,
                                                 float border) {
  const float v = p[0];
  const float up = y > 0 ? p[-w] : border;
  const float down = y < h - 1 ? p[w] : border;
  const float left = x > 0 ? p[-1] : border;
  const float right = x < w - 1 ? p[1] : border;
  return (v >= up) && (v >= down) && (v >= left) && (v >= right) &&
         (v > thre);
}

template <>
__device__ __forceinline__ unsigned peak_bits<4>(const float* p, int y, int x,
                                                 int h, int w, float thre,
                                                 float border) {
  const float4 b4 = make_float4(border, border, border, border);
  const float4 c = *reinterpret_cast<const float4*>(p);
  const float4 u = y > 0 ? *reinterpret_cast<const float4*>(p - w) : b4;
  const float4 d = y < h - 1 ? *reinterpret_cast<const float4*>(p + w) : b4;
  const float l = x > 0 ? p[-1] : border;
  const float r = x + 4 < w ? p[4] : border;
  const bool p0 = c.x >= u.x && c.x >= d.x && c.x >= l && c.x >= c.y &&
                  c.x > thre;
  const bool p1 = c.y >= u.y && c.y >= d.y && c.y >= c.x && c.y >= c.z &&
                  c.y > thre;
  const bool p2 = c.z >= u.z && c.z >= d.z && c.z >= c.y && c.z >= c.w &&
                  c.z > thre;
  const bool p3 = c.w >= u.w && c.w >= d.w && c.w >= c.z && c.w >= r &&
                  c.w > thre;
  return p0 | (p1 << 1) | (p2 << 2) | (p3 << 3);
}

// Where a staged band lies: rows [y0, y1) of the plane, its first pixel
// at shared slot off (the halo row above, if any, comes before it).
struct Band {
  int y0, y1, off;
};

// Issues the copies of band `band` of `plane` (rows `rows` a band) and
// its halo rows into shared memory s; the scalar head and tail are stored
// at once, the cp.async copies are left in flight: the caller waits.
template <int kThreads>
__device__ __forceinline__ Band stage_band(float* s, const float* in,
                                           int plane, int band, int rows,
                                           int h, int w) {
  const int tid = threadIdx.x;
  // stage rows [ys, ye): the band [y0, y1) and its halo rows
  const int y0 = band * rows;
  const int y1 = min(y0 + rows, h);
  const int ys = max(y0 - 1, 0);
  const int ye = min(y1 + 1, h);
  const float* g = in + (static_cast<int64_t>(plane) * h + ys) * w;
  const int n = (ye - ys) * w;
  // s[pad + i] = g[i], with pad = g's offset in floats from a 16-byte
  // boundary, so the float4 copies are aligned on both sides
  const int pad =
      static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  const int head = min((4 - pad) & 3, n);
  const int quads = (n - head) >> 2;
  float* dst = s + pad;
  for (int i = tid; i < head; i += kThreads) dst[i] = g[i];
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  const unsigned s4 =
      static_cast<unsigned>(__cvta_generic_to_shared(dst + head));
  for (int i = tid; i < quads; i += kThreads)
    cp_async16(s4 + 16u * i, g4 + i);
  for (int i = head + 4 * quads + tid; i < n; i += kThreads) dst[i] = g[i];
  return {y0, y1, pad + (y0 - ys) * w};
}

}  // namespace
