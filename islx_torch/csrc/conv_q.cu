// Int8 W8A8 convolution with the requantize epilogue fused, and the
// activation quantization of its unchained inputs, CUDA C++ for sm_90a.
//
// Replaces islx's int8 conv, islx/models/quant.py::conv_q_core (chained by
// islx/models/cpm.py::_seq), which XLA ran on the TPU as
// lax.conv_general_dilated with int32 accumulation; no Pallas kernel backs
// it, and stock PyTorch has no CUDA int8 convolution. It computes, for
// NHWC int8 x [B,H,W,cs] (cin channels used) and int8 weights, a k x k
// conv with pad (k-1)/2 and stride 1 summed exactly in int32: |sum| <=
// 127 * 127 * k * k * cin, at most 127^2 * 49 * 150 = 118,540,350 < 2^31
// on the CPM nets (7x7 over 150 channels), and the wrapper refuses a K for
// which it could pass 2^31. Then, per output channel c:
//   o = fmaf(float(y), scale[c], bias[c])      one rounding: XLA's CPU
//                                              program fuses y*scale + b
//   o = fmaxf(o, 0) | (o >= 0 ? o : slope[c] * o) | o     relu, prelu, none
//   out = o (f32) | bf16 round-to-nearest-even | int8
//         clip(rintf(o * out_inv), -127, 127)
// Every other multiply is an explicit round-to-nearest intrinsic, which
// nvcc does not contract. The plain version, islx_torch/ops/conv_q.py::
// conv_q_plain, rounds at the same points, so the two agree bit for bit.
//
// Bound: operations. At the CPMs' shapes a conv does 2*M*N*K int8
// operations for M = B*H*W pixels, N = cout, K = k*k*cin, against reading
// x (M*cin bytes, once with an ideal cache) and writing M*N outputs: from
// ~250 operations a byte up, near or above the card's int8 ridge (1,979
// TOP/s over 3.35 TB/s, ~590). So the design is an implicit GEMM on
// Hopper's int8 tensor cores:
// - wgmma.mma_async m64nNk32 s8 x s8 -> s32, both operands K-major from
//   shared memory in the canonical swizzled layout: a K step is one tap's
//   chunk of 128 input channels (128-byte rows, 128-byte swizzle), the
//   last chunk of a tap 32, 64 or 128 channels wide (32-, 64- or 128-byte
//   swizzle);
// - TMA brings both operands into a ring of K steps (as many as fit the
//   227 KB beside the epilogue's staging: 4 to 6), each guarded by a full
//   and an empty mbarrier: the activations by its im2col mode (the tile's
//   output pixels linear over B*H*W, copies of 128; the tap's (ky, kx)
//   an offset of the copy; the zero halo and the channels past the
//   input's stride filled by the hardware), the weights by its tiled mode
//   (zero from cin on: packed zeros, then filled past cin32 and past the
//   packed rows);
// - a block is a producer warpgroup, one warp of which keeps the TMA
//   copies in flight (setmaxnreg hands its registers to the consumers),
//   and 2 consumer warpgroups, each half of the tile's BM output pixels
//   (one or two m64 wgmma a K slice) x N output channels: N = 128 with the
//   tiles over N where cout > 96, else the next wgmma width (24, 32, 64,
//   96), padded channels never stored. BM is 256 where that still gives
//   four waves of tiles, else 128: 256 pixels a tile read each weight byte
//   from L2 half as often as 128 did (the 128 x 128 tiles of the first TMA
//   design reached ~625 TOP/s on the 7x7 convs on an NVIDIA H100 80GB HBM3
//   at 700 W, about what L2 can feed at their 128 operations a byte;
//   PERF.md section 6), but fewer tiles leave SMs idle in the last wave;
// - the role of each warp is a shuffle's result, and the consumers release
//   a stage by a predicated arrive, so that no wgmma is on a path that the
//   compiler takes for divergent (it serialises them there);
// - the grid is persistent, one block an SM walking the output tiles, so
//   that a tile's epilogue overlaps the next tile's copies;
// - the epilogue runs on the accumulator fragments in registers, stages
//   64 rows at a time in shared memory and stores them in coalesced
//   16-byte (or narrower, where a row's bytes demand it) pieces.
// The weights are packed once per layer, [cout padded to 128][k*k][cin
// padded to 32], zero in the padding; the input's channel stride is a
// multiple of 16. The TMA descriptors are encoded on the host for each
// call, through the entry points that cudaGetDriverEntryPoint
// returns (no link against libcuda).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBox = 128;        // pixels an im2col copy
constexpr int kKC = 128;         // input channels a full K step
constexpr int kMaxStages = 6;
constexpr int kSmem = 232448;    // shared memory a block can have
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's

// The TMA descriptors of a call: the activations (im2col) and the weights
// (tiled), each for a tap's full 128-channel K step and for its last one.
struct Maps {
  CUtensorMap x_full, x_last, w_full, w_last;
};

struct Args {
  const int8_t* x;       // [B,H,W,cs]
  const int8_t* w;       // [cout padded to 128][k*k][cin32]
  const float* scale;    // [cout]
  const float* bias;     // [cout]
  const float* slope;    // [cout], prelu only
  void* out;             // [B,H,W,cout]: f32, bf16 or s8
  int b, h, w_, cin, cs, cout, cin32, k, act, mode;
  float out_inv;
  int stages;            // the ring's K steps, as many as fit
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The width of a tap's last K step: 32, 64 or 128 channels.
__host__ __device__ __forceinline__ int tail_width(int cin) {
  const int rem = cin - ((cin - 1) / kKC) * kKC;
  return rem <= 32 ? 32 : rem <= 64 ? 64 : 128;
}

// A wgmma matrix descriptor of a K-major tile whose rows are `width`
// bytes (32, 64 or 128) in the matching swizzle: layout 3, 2 or 1, the
// 8-row groups 8 * width bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t tile_desc(const void* p, int width) {
  const uint64_t layout = width == 128 ? 1 : width == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * width) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32, K-major) * B (N x 32, K-major)^T, s8 -> s32;
// scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<24>(int (&d)[12], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(int (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(int (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<96>(int (&d)[48], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Arrives where `pred`, by a predicated instruction: no branch between
// the wgmma of the consumers' loop.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// 128 pixels x `width` channels of the activations, from output pixel
// (n, y, x)'s window corner (y - pad, x - pad) shifted by the tap (ky, kx).
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map,
                                           uint64_t* bar, int c, int x,
                                           int y, int n, int kx, int ky) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(c), "r"(x),
      "r"(y), "r"(n), "h"(static_cast<uint16_t>(kx)),
      "h"(static_cast<uint16_t>(ky))
      : "memory");
}
// N weight rows x `width` channels of tap `tap`.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int tap,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(c),
      "r"(tap), "r"(row)
      : "memory");
}

// An output channel's epilogue constants, loaded once for the rows of a
// thread that share the channel.
struct Chan {
  float scale, bias, slope;
};

__device__ __forceinline__ Chan chan(const Args& a, int c) {
  return {__ldg(a.scale + c), __ldg(a.bias + c),
          a.act == 2 ? __ldg(a.slope + c) : 0.0f};
}

__device__ __forceinline__ float epilogue(const Args& a, int y, Chan k) {
  float o = __fmaf_rn(__int2float_rn(y), k.scale, k.bias);
  if (a.act == 1) {
    o = fmaxf(o, 0.0f);
  } else if (a.act == 2) {
    o = o >= 0.0f ? o : __fmul_rn(k.slope, o);
  }
  return o;
}

__device__ __forceinline__ int8_t to_s8(float o, float inv) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(o, inv)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

// The epilogue of 64 x N accumulators of warpgroup g (output pixels m0 ..
// m0 + 63): outputs (row, c) and (row, c + 1) of each fragment pair,
// written as the output type into the warpgroup's staging rows (`stride`
// bytes apart), then the valid rows' first `ncols` channels stored in the
// widest pieces that the output's row bytes allow.
template <int N>
__device__ __forceinline__ void store_tile(const Args& a, int (&acc)[N / 2],
                                           int8_t* stage, int g, int64_t m0,
                                           int n0, int64_t m_total) {
  const int t = threadIdx.x & 127;
  const int es = a.mode == 0 ? 4 : a.mode == 1 ? 2 : 1;
  const int stride = ((N * es + 15) & ~15) + 16;
  const int ncols = min(N, a.cout - n0);
  const int row0 = (t >> 5) * 16 + ((t & 31) >> 2);
  const int col0 = (t & 3) * 2;
  // the previous tile's stores have read the staging rows
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + col0;
    if (col >= ncols) continue;        // cout is even: a pair or nothing
    const Chan k0 = chan(a, n0 + col), k1 = chan(a, n0 + col + 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      const float o0 = epilogue(a, acc[j * 4 + half * 2], k0);
      const float o1 = epilogue(a, acc[j * 4 + half * 2 + 1], k1);
      int8_t* dst = stage + row * stride + col * es;
      if (a.mode == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else if (a.mode == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __nv_bfloat162(__float2bfloat16_rn(o0), __float2bfloat16_rn(o1));
      } else {
        *reinterpret_cast<char2*>(dst) =
            make_char2(to_s8(o0, a.out_inv), to_s8(o1, a.out_inv));
      }
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
  const int64_t left = m_total - m0;
  const int rows = static_cast<int>(left < 64 ? (left > 0 ? left : 0) : 64);
  const int rb = ncols * es;
  const int cb = a.cout * es;
  int unit = 16;
  while ((cb | rb) & (unit - 1)) unit >>= 1;
  const int upr = rb / unit;
  int8_t* out = static_cast<int8_t*>(a.out) + (m0 * a.cout + n0) * es;
  for (int i = t; i < rows * upr; i += 128) {
    const int r = i / upr;
    const int c = (i - r * upr) * unit;
    const int8_t* src = stage + r * stride + c;
    int8_t* dst = out + static_cast<int64_t>(r) * cb + c;
    switch (unit) {
      case 16: *reinterpret_cast<uint4*>(dst) =
                   *reinterpret_cast<const uint4*>(src); break;
      case 8: *reinterpret_cast<uint2*>(dst) =
                  *reinterpret_cast<const uint2*>(src); break;
      case 4: *reinterpret_cast<uint32_t*>(dst) =
                  *reinterpret_cast<const uint32_t*>(src); break;
      case 2: *reinterpret_cast<uint16_t*>(dst) =
                  *reinterpret_cast<const uint16_t*>(src); break;
      default: *dst = *src;
    }
  }
}

// One K step of a warpgroup: its S 64-row slices of A against B, KS
// slices of 32 channels each.
template <int N, int S, int KS>
__device__ __forceinline__ void mma_step(int (&acc)[S][N / 2], uint64_t da,
                                         uint64_t db, int slice_desc,
                                         int first) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      wgmma<N>(acc[i], da + i * slice_desc + 2 * ks, db + 2 * ks,
               !first || ks > 0);
    }
  }
}

template <int N, int S>
__device__ __forceinline__ void fence_acc(int (&acc)[S][N / 2]) {
#pragma unroll
  for (int i = 0; i < S; ++i) fence_regs(acc[i]);
}

// The persistent kernel: block b takes tiles b, b + gridDim.x, ... of the
// (M tiles) x (N tiles) grid of BM x N output tiles, N fastest. Warp 8
// (of the producer warpgroup) copies; warpgroups 0 and 1 each multiply and
// store BM / 2 of a tile's pixels, in S = BM / 128 slices of 64 rows.
template <int N, int BM>
__global__ void __launch_bounds__(kThreads, 1)
    conv_q_kernel(__grid_constant__ const Maps maps, const Args a) {
  constexpr int S = BM / 128;
  extern __shared__ __align__(1024) int8_t smem[];
  constexpr int kA = BM * kKC;         // bytes of a stage's A tile
  constexpr int kB = N * kKC;          // ... and of its B tile
  const int es = a.mode == 0 ? 4 : a.mode == 1 ? 2 : 1;
  const int stride = ((N * es + 15) & ~15) + 16;
  int8_t* ring = smem;                 // [stage][A | B], 1024-aligned
  int8_t* staging = smem + a.stages * (kA + kB);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * 64 * stride);
  uint64_t* empty = full + kMaxStages;
  // warp-uniform to the compiler (a shuffle), so that the wgmma of the
  // consumers' path are not in a divergent one
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const bool lane0 = (threadIdx.x & 31) == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t m_total = static_cast<int64_t>(a.b) * a.h * a.w_;
  const int n_tiles = (a.cout + N - 1) / N;
  const int tiles = static_cast<int>((m_total + BM - 1) / BM) * n_tiles;
  const int kk = a.k * a.k;
  const int q = (a.cin + kKC - 1) / kKC;     // K steps a tap
  const int tw = tail_width(a.cin);
  const int iters = kk * q;

  if (wg == 2) {                             // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      const int pad = (a.k - 1) / 2;
      const int64_t hw = static_cast<int64_t>(a.h) * a.w_;
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t m0 = static_cast<int64_t>(tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * N;
        int px[S][3];                        // (n, y, x) of each box's
        for (int i = 0; i < S; ++i) {        // first pixel
          const int64_t m = m0 + i * kBox;
          px[i][0] = static_cast<int>(m / hw);
          const int rem = static_cast<int>(m - px[i][0] * hw);
          px[i][1] = rem / a.w_;
          px[i][2] = rem - px[i][1] * a.w_;
        }
        for (int it = 0; it < iters; ++it) {
          const int tap = it / q;
          const int ch = it - tap * q;
          const bool last = ch == q - 1;
          const int width = last ? tw : kKC;
          const int ky = tap / a.k;
          const CUtensorMap* xm = last ? &maps.x_last : &maps.x_full;
          int8_t* sa = ring + stage * (kA + kB);
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect(full + stage, (BM + N) * width);
          for (int i = 0; i < S; ++i) {
            tma_im2col(sa + i * kBox * width, xm, full + stage, ch * kKC,
                       px[i][2] - pad, px[i][1] - pad, px[i][0],
                       tap - ky * a.k, ky);
          }
          tma_tile(sa + kA, last ? &maps.w_last : &maps.w_full,
                   full + stage, ch * kKC, tap, n0);
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {                                   // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int8_t* my_staging = staging + wg * 64 * stride;
    int acc[S][N / 2];
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[i][j] = 0;
    }
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 =
          static_cast<int64_t>(tile / n_tiles) * BM + wg * (BM / 2);
      const int n0 = (tile % n_tiles) * N;
      int prev = 0;
      for (int it = 0; it < iters; ++it) {
        const int width = it % q == q - 1 ? tw : kKC;
        const int8_t* sa = ring + stage * (kA + kB);
        const uint64_t da = tile_desc(sa + wg * (BM / 2) * width, width);
        const uint64_t db = tile_desc(sa + kA, width);
        const int slice_desc = (64 * width) >> 4;
        mbar_wait(full + stage, phase);
        fence_acc<N, S>(acc);
        wgmma_fence();
        if (width == 128) {
          mma_step<N, S, 4>(acc, da, db, slice_desc, it == 0);
        } else if (width == 64) {
          mma_step<N, S, 2>(acc, da, db, slice_desc, it == 0);
        } else {
          mma_step<N, S, 1>(acc, da, db, slice_desc, it == 0);
        }
        wgmma_commit();
        wgmma_wait<1>();                     // step it - 1 is read
        fence_acc<N, S>(acc);
        mbar_arrive_if(empty + prev, it > 0 && lane0);
        prev = stage;
        if (++stage == a.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<N, S>(acc);
      mbar_arrive_if(empty + prev, lane0);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        store_tile<N>(a, acc[i], my_staging, wg, m0 + i * 64, n0, m_total);
      }
    }
  }
}

// Shared memory of a launch: the ring's stages, the two warpgroups' 64-row
// staging for the output type, the barriers.
int stage_bytes(int n, int bm) { return (bm + n) * kKC; }
int staging_bytes(int n, int es) {
  return 2 * 64 * (((n * es + 15) & ~15) + 16);
}
int smem_bytes(int n, int bm, int es, int stages) {
  return stages * stage_bytes(n, bm) + staging_bytes(n, es) +
         2 * kMaxStages * 8;
}

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

void* entry_point(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess) {
    return nullptr;
  }
#else
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) !=
      cudaSuccess) {
    return nullptr;
  }
#endif
  return found == cudaDriverEntryPointSuccess ? fn : nullptr;
}

CUtensorMapSwizzle swizzle(int width) {
  return width == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : width == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The activations [B,H,W,cs] seen as a 4-D tensor {cs, W, H, B} whose
// im2col copies bring 128 pixels x `width` channels; the window corners
// run over [-pad, W - 1 - pad] x [-pad, H - 1 - pad]. Channels cin..cs-1
// meet zero weights.
bool encode_x(CUtensorMap* map, const Args& a, int width) {
  static const auto encode =
      reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return false;
  const int pad = (a.k - 1) / 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.cs),
                              static_cast<cuuint64_t>(a.w_),
                              static_cast<cuuint64_t>(a.h),
                              static_cast<cuuint64_t>(a.b)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(a.cs),
      static_cast<cuuint64_t>(a.cs) * a.w_,
      static_cast<cuuint64_t>(a.cs) * a.w_ * a.h};
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - (a.k - 1), pad - (a.k - 1)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<int8_t*>(a.x), dims, strides, lower, upper,
                static_cast<cuuint32_t>(width), kBox, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(width),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The packed weights [rows][k*k][cin32] seen as {cin32, k*k, rows}
// (zero from cin on), copied as boxes of n rows x `width` channels of one
// tap.
bool encode_w(CUtensorMap* map, const Args& a, int rows, int n, int width) {
  static const auto encode =
      reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.cin32),
                              static_cast<cuuint64_t>(a.k * a.k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(a.cin32),
      static_cast<cuuint64_t>(a.cin32) * a.k * a.k};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), 1,
                             static_cast<cuuint32_t>(n)};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<int8_t*>(a.w), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(width),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

// The ring's stages at a tile height: as many as fit beside the staging.
int ring_stages(int n, int bm, int es) {
  const int s = (kSmem - staging_bytes(n, es) - 2 * kMaxStages * 8) /
                stage_bytes(n, bm);
  return s < kMaxStages ? s : kMaxStages;
}

// BM = 256 pixels a tile where that still gives 4 waves of tiles and a
// ring of 4 stages: a tile of 256 reads each weight byte from L2 half as
// often as one of 128, which keeps the 7x7 convs fed, but fewer tiles leave
// SMs idle in the last wave (BODY_25's 23x18 maps: 311 tiles of 256, 621
// of 128), and f32 outputs 128 wide leave room for 3 stages only.
template <int N, int BM>
int launch_bm(Args a, const Maps& maps, int64_t tiles, int sms,
              cudaStream_t stream) {
  const int es = a.mode == 0 ? 4 : a.mode == 1 ? 2 : 1;
  a.stages = ring_stages(N, BM, es);
  static const cudaError_t set = cudaFuncSetAttribute(
      conv_q_kernel<N, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (a.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid =
      static_cast<unsigned int>(tiles < sms ? tiles : sms);
  conv_q_kernel<N, BM>
      <<<grid, kThreads, smem_bytes(N, BM, es, a.stages), stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(const Args& a, int rows, int64_t m, cudaStream_t stream) {
  static const int sms = sm_count();
  Maps maps;
  const int tw = tail_width(a.cin);
  if (!encode_x(&maps.x_full, a, kKC) || !encode_x(&maps.x_last, a, tw) ||
      !encode_w(&maps.w_full, a, rows, N, kKC) ||
      !encode_w(&maps.w_last, a, rows, N, tw) || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (a.cout + N - 1) / N;
  const int64_t tiles256 = (m + 255) / 256 * n_tiles;
  const int es = a.mode == 0 ? 4 : a.mode == 1 ? 2 : 1;
  if (tiles256 >= 4 * sms && ring_stages(N, 256, es) >= 4) {
    return launch_bm<N, 256>(a, maps, tiles256, sms, stream);
  }
  return launch_bm<N, 128>(a, maps, (m + 127) / 128 * n_tiles, sms, stream);
}

// Activation quantization (islx/models/quant.py::quantize_act, an XLA
// elementwise fusion on the TPU), the input of every conv that is not
// chained: x [M,C] f32 or bf16 -> q [M,cs] s8, q = clip(rintf(x * inv),
// -127, 127) with the product rounded once (__fmul_rn), channels C..cs-1
// zero. Bound by bytes: a thread reads 4 channels of a pixel and writes
// them as one 4-byte word; the plain version
// (islx_torch/ops/conv_q.py::quantize_plain) gives the same words.
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ q, int64_t m, int c,
                                int cs, float inv) {
  const int words = cs / 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= m * words) return;
  const int64_t p = i / words;
  const int c0 = static_cast<int>(i - p * words) * 4;
  char4 v;
  int8_t* out = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = c0 + j;
    out[j] = to_s8(ch < c ? load_f32(x + p * c + ch) : 0.0f, inv);
  }
  *reinterpret_cast<char4*>(q + p * cs + c0) = v;
}

// The same quantization in patch mode, for a 3x3 conv over 3 channels run
// as a 1x1 conv over 27 (conv1_1): x [B,H,W,3] -> q [B,H,W,32], each
// pixel's 3x3 neighbourhood of quantized values in (ky, kx, c) order, zero
// outside the frame and past 27. A thread writes one pixel's 32 bytes with
// 16-byte stores.
template <typename T>
__global__ void patch_kernel(const T* __restrict__ x,
                             int8_t* __restrict__ q, int64_t m, int h, int w,
                             float inv) {
  constexpr int C = 3, kCs = 32;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= m) return;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t img = p / hw;
  const int y = static_cast<int>((p - img * hw) / w);
  const int xc = static_cast<int>(p - img * hw - static_cast<int64_t>(y) * w);
  alignas(16) int8_t v[kCs];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1;
    const int xx = xc + tap % 3 - 1;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const T* src = x + ((img * h + yy) * w + xx) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[tap * C + c] = to_s8(in ? load_f32(src + c) : 0.0f, inv);
    }
  }
#pragma unroll
  for (int j = 9 * C; j < kCs; ++j) v[j] = 0;
#pragma unroll
  for (int j = 0; j < kCs / 16; ++j) {
    reinterpret_cast<uint4*>(q + p * kCs)[j] =
        reinterpret_cast<const uint4*>(v)[j];
  }
}

template <typename T>
void quantize_launch(const T* x, int8_t* q, int64_t m, int c, int cs, int h,
                     int w, int k, float inv, cudaStream_t s) {
  constexpr int kThreadsQ = 256;
  if (k == 1) {
    const int64_t n = m * (cs / 4);
    quantize_kernel<T><<<static_cast<unsigned int>(
                             (n + kThreadsQ - 1) / kThreadsQ),
                         kThreadsQ, 0, s>>>(x, q, m, c, cs, inv);
    return;
  }
  const auto grid = static_cast<unsigned int>((m + kThreadsQ - 1) / kThreadsQ);
  patch_kernel<T><<<grid, kThreadsQ, 0, s>>>(x, q, m, h, w, inv);
}

}  // namespace

// x [B,H,W,cs] s8 (cs % 16 == 0, 16-byte aligned, cin <= cs channels
// used), w [ceil(cout/128)*128][k*k][cin32] s8, scale/bias/slope [cout] f32
// (slope read only for act 2) -> out [B,H,W,cout]: mode 0 f32, 1 bf16,
// 2 s8 at out_inv. act: 0 none, 1 relu, 2 prelu. Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// cannot take.
extern "C" int islx_conv_q(const int8_t* x, const int8_t* w,
                           const float* scale, const float* bias,
                           const float* slope, void* out, int b, int h,
                           int w_, int cin, int cs, int cout, int cin32,
                           int k, int act, int mode, float out_inv,
                           void* stream) {
  const int64_t m = static_cast<int64_t>(b) * h * w_;
  if (b < 1 || h < 1 || w_ < 1 || cin < 1 || cs < cin || cs % 16 != 0 ||
      cout < 1 || cout % 2 != 0 || cin32 % 32 != 0 || cin32 < cin ||
      k < 1 || k % 2 == 0 || act < 0 || act > 2 || mode < 0 || mode > 2 ||
      (act == 2 && slope == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, w, scale, bias, slope, out, b, h, w_, cin, cs, cout,
               cin32, k, act, mode, out_inv, 0};
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = (cout + 127) / 128 * 128;     // the packed weight rows
  if (cout <= 24) return launch<24>(a, rows, m, s);
  if (cout <= 32) return launch<32>(a, rows, m, s);
  if (cout <= 64) return launch<64>(a, rows, m, s);
  if (cout <= 96) return launch<96>(a, rows, m, s);
  return launch<128>(a, rows, m, s);
}

// x [M,C] (bf16 when `bf16`, else f32) -> q [M,cs] s8 (cs % 16 == 0,
// cs >= C, 16-byte aligned); with k = 3 and C = 3, M = B*h*w pixels of
// [B,h,w,3] and q their 3x3 patches (cs = 32). Launches
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape it cannot take.
extern "C" int islx_quantize(const void* x, int8_t* q, int64_t m, int c,
                             int cs, int bf16, int h, int w, int k,
                             float inv, void* stream) {
  const bool patch = k != 1;
  if (m < 1 || c < 1 || cs < c || cs % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      (patch && (k != 3 || c != 3 || cs != 32 || h < 1 || w < 1 ||
                 m % (static_cast<int64_t>(h) * w) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    quantize_launch(static_cast<const __nv_bfloat16*>(x), q, m, c, cs, h, w,
                    k, inv, s);
  } else {
    quantize_launch(static_cast<const float*>(x), q, m, c, cs, h, w, k, inv,
                    s);
  }
  return static_cast<int>(cudaGetLastError());
}
