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
// mean sums the 2*mid products in (sample, x/y) order and multiplies by the
// f32 reciprocal of mid. Every other multiply and add is an explicit
// round-to-nearest intrinsic, which nvcc does not contract, since a single
// rounding could move a rint at .5 or a `> thre2` count. Division and
// square root are IEEE (no fast math). The plain version in
// islx_torch/ops/paf_sample.py rounds at the same points, so the two agree
// bit for bit; XLA sums the mean in another order in some programs, so the
// score agrees with islx within rtol 1e-6, atol 1e-7, and ok exactly.
//
// Bound: the gathered sectors. Each sample reads two floats of one pixel's
// channels from device memory, one 32 B sector; at L=24, K=32, mid=10 that
// is ~7.9 MB, a few microseconds, so the kernel is bound by its launch.
// Design: one thread per (limb, i, j) pair loops over its samples and reads
// the PAF straight from device memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
paf_sample_kernel(const float* __restrict__ paf, const int32_t* __restrict__ xy,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ limbs,
                  const float* __restrict__ t, float* __restrict__ score,
                  uint8_t* __restrict__ ok, int h, int w, int p, int l, int k,
                  int mid, float thre2, float half_h, float crit,
                  float inv_mid) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= static_cast<int64_t>(l) * k * k) return;
  const int j = static_cast<int>(g % k);
  const int i = static_cast<int>((g / k) % k);
  const int li = static_cast<int>(g / (static_cast<int64_t>(k) * k));
  const int a_part = limbs[li * 4 + 0];
  const int b_part = limbs[li * 4 + 1];
  const int cx = limbs[li * 4 + 2];
  const int cy = limbs[li * 4 + 3];
  const float ax = static_cast<float>(xy[(a_part * k + i) * 2 + 0]);
  const float ay = static_cast<float>(xy[(a_part * k + i) * 2 + 1]);
  const float bx = static_cast<float>(xy[(b_part * k + j) * 2 + 0]);
  const float by = static_cast<float>(xy[(b_part * k + j) * 2 + 1]);
  const float vx = __fsub_rn(bx, ax);
  const float vy = __fsub_rn(by, ay);
  const float norm =
      fmaxf(__fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy))),
            0.001f);
  const float ux = __fdiv_rn(vx, norm);
  const float uy = __fdiv_rn(vy, norm);
  float sum = 0.0f;
  int hits = 0;
  for (int m = 0; m < mid; ++m) {
    const float px = __fmaf_rn(vx, t[m], ax);
    const float py = __fmaf_rn(vy, t[m], ay);
    const int xi = min(max(static_cast<int>(rintf(px)), 0), w - 1);
    const int yi = min(max(static_cast<int>(rintf(py)), 0), h - 1);
    const float* s = paf + (static_cast<int64_t>(yi) * w + xi) * p;
    const float sx = s[cx];
    const float sy = s[cy];
    sum = __fmaf_rn(sy, uy, __fmaf_rn(sx, ux, sum));
    hits += __fmaf_rn(sy, uy, __fmul_rn(sx, ux)) > thre2 ? 1 : 0;
  }
  const float prior = fminf(__fsub_rn(__fdiv_rn(half_h, norm), 1.0f), 0.0f);
  const float swdp = __fmaf_rn(sum, inv_mid, prior);
  score[g] = swdp;
  ok[g] = (static_cast<float>(hits) > crit) && (swdp > 0.0f) &&
          valid[a_part * k + i] && valid[b_part * k + j];
}

}  // namespace

// paf [H,W,P] f32, xy [C,K,2] s32, valid [C,K] u8, limbs [L,4] s32
// (a part, b part, x channel, y channel), t [mid] f32 -> score [L,K,K] f32,
// ok [L,K,K] u8. Launches on `stream` and returns cudaGetLastError().
extern "C" int islx_paf_sample(const float* paf, const int32_t* xy,
                               const uint8_t* valid, const int32_t* limbs,
                               const float* t, float* score, uint8_t* ok,
                               int h, int w, int p, int l, int k, int mid,
                               float thre2, float half_h, float crit,
                               float inv_mid, void* stream) {
  const int64_t n = static_cast<int64_t>(l) * k * k;
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    paf_sample_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        paf, xy, valid, limbs, t, score, ok, h, w, p, l, k, mid, thre2,
        half_h, crit, inv_mid);
  }
  return static_cast<int>(cudaGetLastError());
}
