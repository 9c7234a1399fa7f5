// Int8 W8A8 convolution with the requantize epilogue fused, CUDA C++ for
// sm_90a.
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
// TOP/s over 3.35 TB/s, ~590). So the design is an implicit GEMM on the
// int8 tensor cores:
// - a block computes a tile of 128 output pixels x kBN output channels,
//   a warp 64 x 32 of it as 4 x 4 mma.sync.m16n8k32 s8 tiles with int32
//   accumulators in registers: kBN 128 (8 warps) where cout > 64, else 64
//   (4 warps);
// - the K loop runs over the taps (ky, kx) and chunks of 32 input
//   channels; a stage of the 3-stage cp.async ring holds kSub such steps
//   (2 at kBN 128, 1 at 64): the tap's 32 channels of the block's 128
//   pixels (the zero halo and the channel tail zero-filled by cp.async's
//   source size) and kBN weight rows of 32 bytes, by 16-byte copies;
// - staged rows are 48 bytes apart, so that the fragment loads of a warp
//   (8 rows x 4 words) fall in 32 different banks;
// - the epilogue runs on the accumulators in registers and stores pairs of
//   channels.
// On the card (PERF.md, section 6) the 128-channel tiles with two steps a
// stage took 16% less time than 64 x 1 at the hand's 7x7 convs. No
// variant was faster: ldmatrix fragment loads; each kernel row's pixels
// staged once for its k taps (2.5-7x fewer copies from L2); 64 x 64 warp
// tiles; 256-pixel blocks; four steps a stage. So neither shared memory
// nor L2 bandwidth alone bounds it at ~320 TOP/s; what does is not
// identified (ncu does not run on the card's machine).
// The weights are packed once per layer, [cout padded to 128][k*k][cin
// padded to 32], zero in the padding, so a weight row of a step is 32
// contiguous bytes and the channel tail multiplies by zero; the input's
// channel stride is a multiple of 16, so each 16-byte half of a staged row
// is one aligned copy (a half that starts at or past cin is zero-filled,
// and one that starts below it reads only the row's own bytes).
// wgmma with TMA, and a pool or quantize fused in, are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;         // output pixels a block
constexpr int kBK = 32;          // input channels a K step
constexpr int kRow = 48;         // bytes between staged rows (32 used)
constexpr int kStages = 3;
constexpr int kWarpM = 64;       // a warp's tile: 64 pixels x 32 channels
constexpr int kWarpN = 32;

struct Args {
  const int8_t* x;       // [B,H,W,cs]
  const int8_t* w;       // [cout padded to 128][k*k][cin32]
  const float* scale;    // [cout]
  const float* bias;     // [cout]
  const float* slope;    // [cout], prelu only
  void* out;             // [B,H,W,cout]: f32, bf16 or s8
  int b, h, w_, cin, cs, cout, cin32, k, act, mode;
  float out_inv;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;   // 0: no bytes read, 16 zeros written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x32, row) * b (32x8, col), s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float epilogue(const Args& a, int y, int c) {
  float o = __fmaf_rn(__int2float_rn(y), __ldg(a.scale + c),
                      __ldg(a.bias + c));
  if (a.act == 1) {
    o = fmaxf(o, 0.0f);
  } else if (a.act == 2) {
    o = o >= 0.0f ? o : __fmul_rn(__ldg(a.slope + c), o);
  }
  return o;
}

__device__ __forceinline__ int8_t to_s8(float o, float inv) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(o, inv)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

// Outputs (m, c) and (m, c + 1), the second where c + 1 < cout; cout is
// even, so a pair is aligned to its size.
__device__ __forceinline__ void store_pair(const Args& a, int64_t m, int c,
                                           int y0, int y1) {
  const bool two = c + 1 < a.cout;
  const float o0 = epilogue(a, y0, c);
  const float o1 = two ? epilogue(a, y1, c + 1) : 0.0f;
  const int64_t at = m * a.cout + c;
  if (a.mode == 0) {
    float* out = static_cast<float*>(a.out) + at;
    if (two) {
      *reinterpret_cast<float2*>(out) = make_float2(o0, o1);
    } else {
      *out = o0;
    }
  } else if (a.mode == 1) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + at;
    if (two) {
      *reinterpret_cast<__nv_bfloat162*>(out) =
          __nv_bfloat162(__float2bfloat16_rn(o0), __float2bfloat16_rn(o1));
    } else {
      *out = __float2bfloat16_rn(o0);
    }
  } else {
    int8_t* out = static_cast<int8_t*>(a.out) + at;
    if (two) {
      *reinterpret_cast<char2*>(out) =
          make_char2(to_s8(o0, a.out_inv), to_s8(o1, a.out_inv));
    } else {
      *out = to_s8(o0, a.out_inv);
    }
  }
}

// kBN output channels a block (kBN * 2 threads: 2 warps along M x kBN/32
// along N), kSub K steps a stage.
template <int kBN, int kSub>
__global__ void __launch_bounds__(kBN * 2) conv_q_kernel(const Args a) {
  constexpr int kT = kBN * 2;
  constexpr int kWn = kBN / kWarpN;
  constexpr int kJa = kBM * 2 * kSub / kT;    // A halves a thread stages
  constexpr int kJb = kBN * 2 * kSub / kT;    // B halves a thread stages
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sa = smem;                                   // [stage][sub][kBM]
  int8_t* sb = smem + kStages * kSub * kBM * kRow;     // [stage][sub][kBN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m_total = static_cast<int64_t>(a.b) * a.h * a.w_;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // the A halves this thread stages: (step of the stage, row, half), and
  // the row's pixel
  const int64_t hw = static_cast<int64_t>(a.h) * a.w_;
  int64_t rpb[kJa];
  int ry[kJa], rx[kJa], rrow[kJa], rsub[kJa], rhalf[kJa];
  bool rok[kJa];
#pragma unroll
  for (int j = 0; j < kJa; ++j) {
    const int i = tid + j * kT;
    rhalf[j] = i & 1;
    rrow[j] = (i >> 1) % kBM;
    rsub[j] = (i >> 1) / kBM;
    const int64_t am = m0 + rrow[j];
    rok[j] = am < m_total;
    rpb[j] = 0;
    ry[j] = 0;
    rx[j] = 0;
    if (rok[j]) {
      rpb[j] = am / hw;
      const int rem = static_cast<int>(am - rpb[j] * hw);
      ry[j] = rem / a.w_;
      rx[j] = rem - ry[j] * a.w_;
    }
  }
  const int kk = a.k * a.k;
  const int pad = (a.k - 1) / 2;
  const int chunks = a.cin32 / kBK;
  const int steps = kk * chunks;
  const int n_stages = (steps + kSub - 1) / kSub;

  // stage `st` (steps st*kSub ..) into ring slot s; a step past the last
  // is staged as zeros
  auto stage = [&](int st, int s) {
#pragma unroll
    for (int j = 0; j < kJa; ++j) {
      const int it = st * kSub + rsub[j];
      const int tap = it / chunks;
      const int c0 = (it - tap * chunks) * kBK + rhalf[j] * 16;
      const int ky = tap / a.k;
      const int yy = ry[j] + ky - pad;
      const int xx = rx[j] + (tap - ky * a.k) - pad;
      const bool in = it < steps && rok[j] && yy >= 0 && yy < a.h &&
                      xx >= 0 && xx < a.w_;
      const int8_t* src =
          in ? a.x + ((rpb[j] * a.h + yy) * a.w_ + xx) * a.cs + c0 : a.x;
      cp_async16(sa + ((s * kSub + rsub[j]) * kBM + rrow[j]) * kRow +
                     rhalf[j] * 16,
                 src, in && c0 < a.cin);
    }
#pragma unroll
    for (int j = 0; j < kJb; ++j) {
      const int i = tid + j * kT;
      const int half = i & 1;
      const int row = (i >> 1) % kBN;
      const int sub = (i >> 1) / kBN;
      const int it = st * kSub + sub;
      const int tap = it / chunks;
      const int c0 = (it - tap * chunks) * kBK + half * 16;
      const bool ok = it < steps;
      const int8_t* wsrc =
          ok ? a.w + (static_cast<int64_t>(n0 + row) * kk + tap) * a.cin32 +
                   c0
             : a.w;
      cp_async16(sb + ((s * kSub + sub) * kBN + row) * kRow + half * 16,
                 wsrc, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int wm = (warp / kWn) * kWarpM;
  const int wn = (warp % kWn) * kWarpN;
  const int g = lane >> 2;   // fragment row (A, C) / column (B)
  const int t = lane & 3;    // fragment word within the row

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) stage(s, s);
    cp_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_wait<kStages - 2>();   // stage st's copies have landed (this thread)
    __syncthreads();          // ... every thread's; and st - 1 is read
    const int next = st + kStages - 1;
    if (next < n_stages) stage(next, next % kStages);
    cp_commit();
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      const int8_t* A = sa + ((st % kStages) * kSub + sub) * kBM * kRow;
      const int8_t* B = sb + ((st % kStages) * kSub + sub) * kBN * kRow;
      unsigned af[4][4];
      unsigned bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r = A + (wm + i * 16 + g) * kRow + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(r);
        af[i][1] = *reinterpret_cast<const unsigned*>(r + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(r + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(r + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* r = B + (wn + j * 8 + g) * kRow + t * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(r);
        bf[j][1] = *reinterpret_cast<const unsigned*>(r + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_wait<0>();

  // accumulator (i, j): rows g and g + 8 of the m16 tile, columns 2t and
  // 2t + 1 of the n8 tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + i * 16 + g + half * 8;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + t * 2;
        if (c < a.cout) {
          store_pair(a, m, c, acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        }
      }
    }
  }
}

template <int kBN, int kSub>
int launch(const Args& a, int64_t m, cudaStream_t stream) {
  constexpr int kSmem = kStages * kSub * (kBM + kBN) * kRow;
  static const cudaError_t set = cudaFuncSetAttribute(
      conv_q_kernel<kBN, kSub>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((m + kBM - 1) / kBM),
                  static_cast<unsigned int>((a.cout + kBN - 1) / kBN));
  conv_q_kernel<kBN, kSub><<<grid, kBN * 2, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Activation quantization (islx/models/quant.py::quantize_act, an XLA
// elementwise fusion on the TPU), the input of every conv that is not
// chained: x [M,C] f32 or bf16 -> q [M,cs] s8, q = clip(rintf(x * inv),
// -127, 127) with the product rounded once (__fmul_rn), channels C..cs-1
// zero. Bound by bytes: a thread reads 4 channels of a pixel and writes
// them as one 4-byte word; the plain version
// (islx_torch/ops/conv_q.py::quantize_plain) gives the same words.
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
    float f = 0.0f;
    if (ch < c) {
      if constexpr (sizeof(T) == 2) {
        f = __bfloat162float(x[p * c + ch]);
      } else {
        f = x[p * c + ch];
      }
    }
    out[j] = to_s8(f, inv);
  }
  *reinterpret_cast<char4*>(q + p * cs + c0) = v;
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
      cout < 1 || cout % 2 != 0 || cin32 % kBK != 0 || cin32 < cin ||
      k < 1 || k % 2 == 0 || act < 0 || act > 2 || mode < 0 || mode > 2 ||
      (act == 2 && slope == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, w, scale, bias, slope, out, b, h, w_, cin, cs, cout,
               cin32, k, act, mode, out_inv};
  const auto s = static_cast<cudaStream_t>(stream);
  return cout > 64 ? launch<128, 2>(a, m, s) : launch<64, 1>(a, m, s);
}

// x [M,C] (bf16 when `bf16`, else f32) -> q [M,cs] s8 (cs % 16 == 0,
// cs >= C, 16-byte aligned). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int islx_quantize(const void* x, int8_t* q, int64_t m, int c,
                             int cs, int bf16, float inv, void* stream) {
  if (m < 1 || c < 1 || cs < c || cs % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kThreadsQ = 256;
  const int64_t n = m * (cs / 4);
  const dim3 grid(static_cast<unsigned int>((n + kThreadsQ - 1) / kThreadsQ));
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    quantize_kernel<__nv_bfloat16><<<grid, kThreadsQ, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q, m, c, cs, inv);
  } else {
    quantize_kernel<float><<<grid, kThreadsQ, 0, s>>>(
        static_cast<const float*>(x), q, m, c, cs, inv);
  }
  return static_cast<int>(cudaGetLastError());
}
