// u8 BGR bicubic resize, cv2.resize(INTER_CUBIC) as its Intel IPP path
// computes it, word for word; CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: islx resizes each served frame to its 184-row
// bucket with cv2 on the host (islx/serve/batcher.py), and the port's
// machine has no cv2. Contract, for src [B, H, W, 3] u8 and the per-axis
// taps of islx_torch/ops/resize_u8.py::taps (indices int32 [n, 4], then
// weights f32 [n, 4], both clamped and rounded on the host):
//   h_r[c]    = fma(p3,w3, fma(p2,w2, fma(p1,w1, p0*w0)))   over source
//               row r's four columns (f32, each FMA rounded once)
//   out[c]    = rint(fma(h0,v0, h1*v1) + fma(h2,v2, h3*v3)), clamped to
//               0..255, over the four rows' h
// The plain version (resize_u8_plain) does the same f32 operations in the
// same order. The intrinsics below fix each rounding: nvcc may not fuse a
// __fmul_rn/__fadd_rn into an FMA, nor split a __fmaf_rn.
//
// Bound: memory traffic. Each source sector that holds a tapped pixel is
// read once from device memory (every row at B=8 720p -> 184x328: 22.1 MB
// read; 736 of 1080 rows at 1080p) and each output byte written once (1.45
// MB); the 16 taps of a pixel are re-read from L1/L2, and the arithmetic
// (44 flops a channel) is far below the card's rate.
//
// Design: the first, simple one. One thread an output pixel (its three
// channels), consecutive threads on consecutive output columns of a row,
// so a warp's taps fall on neighbouring source bytes; the row's four
// horizontal sums are recomputed by each output row that needs them
// rather than staged in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resize_u8_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int4* __restrict__ xi, const float4* __restrict__ xw,
                 const int4* __restrict__ yi, const float4* __restrict__ yw,
                 int b, int h, int w, int oh, int ow) {
  const int64_t total = static_cast<int64_t>(b) * oh * ow;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= total) return;
  const int ox = static_cast<int>(p % ow);
  const int64_t rest = p / ow;
  const int oy = static_cast<int>(rest % oh);
  const int n = static_cast<int>(rest / oh);
  const int4 cx = xi[ox];
  const float4 wx = xw[ox];
  const int4 cy = yi[oy];
  const float4 wy = yw[oy];
  const uint8_t* frame = src + static_cast<int64_t>(n) * h * w * 3;
  const int rows[4] = {cy.x, cy.y, cy.z, cy.w};
  float hs[4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint8_t* line = frame + static_cast<int64_t>(rows[r]) * w * 3;
    const uint8_t* q0 = line + cx.x * 3;
    const uint8_t* q1 = line + cx.y * 3;
    const uint8_t* q2 = line + cx.z * 3;
    const uint8_t* q3 = line + cx.w * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = __fmul_rn(static_cast<float>(q0[c]), wx.x);
      acc = __fmaf_rn(static_cast<float>(q1[c]), wx.y, acc);
      acc = __fmaf_rn(static_cast<float>(q2[c]), wx.z, acc);
      acc = __fmaf_rn(static_cast<float>(q3[c]), wx.w, acc);
      hs[r][c] = acc;
    }
  }
  uint8_t* o = dst + p * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = __fmaf_rn(hs[0][c], wy.x, __fmul_rn(hs[1][c], wy.y));
    const float d = __fmaf_rn(hs[2][c], wy.z, __fmul_rn(hs[3][c], wy.w));
    const float v = rintf(__fadd_rn(a, d));
    o[c] = static_cast<uint8_t>(fminf(fmaxf(v, 0.0f), 255.0f));
  }
}

}  // namespace

extern "C" {

// src [b, h, w, 3] u8 -> dst [b, oh, ow, 3] u8. tx: int32 [2, ow, 4] (tap
// columns, then the f32 weights' bits), ty: int32 [2, oh, 4], both on the
// device. Returns the launch's cudaError_t.
int islx_resize_u8(const uint8_t* src, uint8_t* dst, const int32_t* tx,
                   const int32_t* ty, int b, int h, int w, int oh, int ow,
                   cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(b) * oh * ow;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  resize_u8_kernel<<<blocks, kThreads, 0, stream>>>(
      src, dst, reinterpret_cast<const int4*>(tx),
      reinterpret_cast<const float4*>(tx + 4 * ow),
      reinterpret_cast<const int4*>(ty),
      reinterpret_cast<const float4*>(ty + 4 * oh), b, h, w, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
