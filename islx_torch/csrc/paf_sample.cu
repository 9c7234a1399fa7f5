// Exact PAF line-integral scoring of every limb's K x K candidate pairs,
// CUDA C++ for sm_90a.
//
// Replaces islx/ops/pallas_paf.py::_sample_kernel (reached through
// _gather_paf_pallas and score_limbs_pallas), which gathers the PAF samples
// as a one-hot contraction; here the gather and the score math around it
// (islx/ops/paf.py::_score_one_limb) are one kernel. For limb l with joint
// channels (a, b) and PAF channels (cx, cy), and candidates i of a, j of b:
//   vec  = xy[b,j] - xy[a,i];  norm = max(sqrt(vx*vx + vy*vy), 0.001)
//   unit = vec / norm;  for m < mid: pt = xy[a,i] + vec * t[m], rounded
//   half to even and clipped into the map; s_m = paf[pt,cx]*ux + paf[pt,cy]*uy
//   score = sum(s_m) / mid + min(half_h / norm - 1, 0)
//   ok    = #(s_m > thre2) > crit && score > 0 && valid[a,i] && valid[b,j]
// The rounding follows the JAX code as XLA compiles it for the CPU (the
// reference the tests hold the port to): the sample point, s_m, the mean's
// running sum and the mean plus prior are fused multiply-adds (fmaf), the
// mean sums the 2*mid products in (sample, x/y) order, in the `vf` lanes
// over the first `vec` samples that XLA's vectorised loop uses at some
// mids (ops/paf_sample.py::SUM_LANES), and multiplies by the f32
// reciprocal of mid. Every other multiply and add is an explicit
// round-to-nearest intrinsic, which nvcc does not contract, since a single
// rounding could move a rint at .5 or a `> thre2` count. Division and
// square root are IEEE (no fast math). The plain version in
// islx_torch/ops/paf_sample.py rounds at the same points, so the two agree
// bit for bit. t[m] is linspace(0, 1, mid)'s f32 word, m * step with an
// exact 1.0 last, as ops/paf_sample.py::_samples_t makes it.
//
// Bound: the gathered sectors. Each sample reads two floats of one pixel,
// one 32 B sector, at pixels that follow no pattern; at L=24, K=32, mid=10
// that is at most ~7.9 MB, less where samples share pixels: a few
// microseconds at most. So the kernel is bound by the latency of its
// dependent loads (peaks, then the map) and by its launch.
// Design, against that latency:
// - a thread a (limb, i, j) pair; a block a limb's `rows` rows of i, so
//   that a launch of K x K pairs a limb spreads over every SM;
// - the block stages its a peaks and the limb's K b peaks (coordinates and
//   valid bits) in shared memory once, then every thread issues all of its
//   pair's map loads before it uses any: at mid = 10 the sample loop is
//   unrolled at compile time, at another mid the samples go in chunks of
//   kChunk loads (a runtime-mid loop of 10 at mid 10 was slower);
// - two 4-byte loads a sample, x channel and y channel: one 8-byte load
//   where the channels pair up gained nothing beyond the spread.
// A pair's first and last samples lie on its peaks, which the pairs of a
// block share; staging those words in shared memory once a block was
// slower than each pair's own loads, which L1 serves. The sum keeps its
// order: one thread runs its pair's chain. The measurements: PERF.md §6.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLimbs = 64;
constexpr int kMaxThreads = 1024;
constexpr int kChunk = 8;      // inner samples in flight at a runtime mid

// The limb table (a part, b part, x channel, y channel) a row, passed by
// value: no device copy of it, and a block reads its row from the
// parameter bank.
struct Limbs {
  int32_t v[kMaxLimbs * 4];
};

// A staged peak: its coordinates as f32 and its valid bit.
struct Peak {
  float x, y;
  int valid;
  int pad;
};

__device__ __forceinline__ int clip_rint(float v, int n) {
  return min(max(static_cast<int>(rintf(v)), 0), n - 1);
}

// The words of channels cx and cy at pixel (xi, yi).
__device__ __forceinline__ float2 word(const float* __restrict__ paf, int xi,
                                       int yi, int w, int p, int cx, int cy) {
  const float* s = paf + (static_cast<int64_t>(yi) * w + xi) * p;
  return make_float2(__ldg(s + cx), __ldg(s + cy));
}

// The sample point's coordinate, as ops/paf_sample.py rounds it.
__device__ __forceinline__ float t_at(int m, int mid, float step) {
  return (mid > 1 && m == mid - 1) ? 1.0f
                                   : __fmul_rn(static_cast<float>(m), step);
}

// The map words of samples m0 .. m0 + kIn - 1 below `end`, every load
// issued before any is used.
template <int kIn>
__device__ __forceinline__ void load_samples(float2 (&s)[kIn], int m0,
                                             int end, int mid, float step,
                                             const float* __restrict__ paf,
                                             float vx, float vy, float ax,
                                             float ay, int h, int w, int p,
                                             int cx, int cy) {
#pragma unroll
  for (int c = 0; c < kIn; ++c) {
    if (m0 + c < end) {
      const float t = t_at(m0 + c, mid, step);
      s[c] = word(paf, clip_rint(__fmaf_rn(vx, t, ax), w),
                  clip_rint(__fmaf_rn(vy, t, ay), h), w, p, cx, cy);
    }
  }
}

// kMid > 0: mid is kMid, every sample's load in flight at once; else
// kChunk at a time. kVf: the lanes of the mean's sum (vec samples in them,
// a multiple of kVf; at kMid > 0, kVf is 1 and vec 0).
template <int kMid, int kVf>
__global__ void __launch_bounds__(kMaxThreads)
paf_sample_kernel(const float* __restrict__ paf,
                  const int32_t* __restrict__ xy,
                  const uint8_t* __restrict__ valid,
                  const __grid_constant__ Limbs limbs,
                  float* __restrict__ score, uint8_t* __restrict__ ok, int h,
                  int w, int p, int k, int mid_rt, int rows, int vec,
                  float thre2, float half_h, float crit, float inv_mid,
                  float step) {
  constexpr int kIn = kMid > 0 ? kMid : kChunk;
  static_assert(kIn % kVf == 0, "a chunk holds whole rounds of the lanes");
  const int mid = kMid > 0 ? kMid : mid_rt;
  extern __shared__ Peak smem[];
  Peak* pa = smem;                                  // [rows]
  Peak* pb = pa + rows;                             // [k]

  const int tiles = (k + rows - 1) / rows;
  const int li = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - li * tiles) * rows;
  const int cx = limbs.v[li * 4 + 2];
  const int cy = limbs.v[li * 4 + 3];
  const int tid = threadIdx.x;
  const int r = tid / k;
  const int j = tid - r * k;
  const int i = i0 + r;

  // the limb's b peaks and the block's a peaks, once
  if (tid < k) {
    const int q = limbs.v[li * 4 + 1] * k + tid;
    pb[tid] = Peak{static_cast<float>(xy[2 * q]),
                   static_cast<float>(xy[2 * q + 1]), valid[q], 0};
  }
  if (tid < rows && i0 + tid < k) {
    const int q = limbs.v[li * 4 + 0] * k + i0 + tid;
    pa[tid] = Peak{static_cast<float>(xy[2 * q]),
                   static_cast<float>(xy[2 * q + 1]), valid[q], 0};
  }
  __syncthreads();
  if (i >= k) return;

  const Peak a = pa[r];
  const Peak b = pb[j];
  const float vx = __fsub_rn(b.x, a.x);
  const float vy = __fsub_rn(b.y, a.y);
  const float norm =
      fmaxf(__fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy))),
            0.001f);
  const float ux = __fdiv_rn(vx, norm);
  const float uy = __fdiv_rn(vy, norm);
  int hits = 0;
  float2 s[kIn];
  // the lanes: sample m into lane m % kVf (m0 is a multiple of kIn, so
  // that is c % kVf, known at compile time); with one lane there are none,
  // and the chain below starts at sample 0 at compile time
  float sum = 0.0f;
  int tail = 0;
  if constexpr (kVf > 1) {
    float lane[kVf];
#pragma unroll
    for (int v = 0; v < kVf; ++v) lane[v] = v == 0 ? 0.0f : -0.0f;
    for (int m0 = 0; m0 < vec; m0 += kIn) {
      load_samples(s, m0, vec, mid, step, paf, vx, vy, a.x, a.y, h, w, p,
                   cx, cy);
#pragma unroll
      for (int c = 0; c < kIn; ++c) {
        if (m0 + c < vec) {
          float& acc = lane[c % kVf];
          acc = __fmaf_rn(s[c].y, uy, __fmaf_rn(s[c].x, ux, acc));
          hits += __fmaf_rn(s[c].y, uy, __fmul_rn(s[c].x, ux)) > thre2;
        }
      }
    }
#pragma unroll
    for (int n = kVf / 2; n > 0; n /= 2) {
#pragma unroll
      for (int v = 0; v < n; ++v) lane[v] = __fadd_rn(lane[v], lane[v + n]);
    }
    sum = lane[0];
    tail = vec;
  }
  // the samples from `tail` on, chained onto the lanes' sum in order
  for (int m0 = tail; m0 < mid; m0 += kIn) {
    load_samples(s, m0, mid, mid, step, paf, vx, vy, a.x, a.y, h, w, p, cx,
                 cy);
#pragma unroll
    for (int c = 0; c < kIn; ++c) {
      if (m0 + c < mid) {
        const float s_m = __fmaf_rn(s[c].y, uy, __fmul_rn(s[c].x, ux));
        sum = __fmaf_rn(s[c].y, uy, __fmaf_rn(s[c].x, ux, sum));
        hits += s_m > thre2 ? 1 : 0;
      }
    }
  }
  const float prior = fminf(__fsub_rn(__fdiv_rn(half_h, norm), 1.0f), 0.0f);
  const float swdp = __fmaf_rn(sum, inv_mid, prior);
  const int64_t g = (static_cast<int64_t>(li) * k + i) * k + j;
  score[g] = swdp;
  ok[g] = (static_cast<float>(hits) > crit) && (swdp > 0.0f) && a.valid &&
          b.valid;
}

}  // namespace

// paf [H,W,P] f32, xy [C,K,2] s32, valid [C,K] u8, limb_rows [L,4] s32 in
// host memory (a part, b part, x channel, y channel) -> score [L,K,K] f32,
// ok [L,K,K] u8. `rows` rows of candidates i a block (rows * K <= 1024);
// the mean's sum in `vf` lanes (1, 2, 4 or 8) over its first `vec`
// samples; `step` = f32(1 / (mid - 1)). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int islx_paf_sample(const float* paf, const int32_t* xy,
                               const uint8_t* valid, const int32_t* limb_rows,
                               float* score, uint8_t* ok, int h, int w, int p,
                               int l, int k, int mid, int rows, int vf,
                               int vec, float thre2, float half_h, float crit,
                               float inv_mid, float step, void* stream) {
  if (l < 1 || l > kMaxLimbs || k < 1 || rows < 1 || mid < 1 ||
      rows * k > kMaxThreads || vec < 0 || vec > mid || vf < 1 ||
      vec % vf != 0 || (vf == 1 && vec != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Limbs limbs{};
  std::memcpy(limbs.v, limb_rows, sizeof(int32_t) * 4 * l);
  const int tiles = (k + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned int>(l * tiles));
  const dim3 block(static_cast<unsigned int>(rows * k));
  const size_t smem = sizeof(Peak) * (rows + k);
  const auto s = static_cast<cudaStream_t>(stream);
#define ISLX_PAF_LAUNCH(MID, VF)                                          \
  paf_sample_kernel<MID, VF><<<grid, block, smem, s>>>(                   \
      paf, xy, valid, limbs, score, ok, h, w, p, k, mid, rows, vec, thre2, \
      half_h, crit, inv_mid, step)
  if (mid == 10 && vf == 1) {
    ISLX_PAF_LAUNCH(10, 1);
  } else if (vf == 1) {
    ISLX_PAF_LAUNCH(0, 1);
  } else if (vf == 2) {
    ISLX_PAF_LAUNCH(0, 2);
  } else if (vf == 4) {
    ISLX_PAF_LAUNCH(0, 4);
  } else if (vf == 8) {
    ISLX_PAF_LAUNCH(0, 8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ISLX_PAF_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
