// 4-neighbour plateau NMS + each plane's first K peak indices, CUDA C++ for
// sm_90a.
//
// Replaces islx/ops/pallas_peaks.py::_nms_first_k_kernel (called through
// nms_first_k). Contract, for blurred maps b[R, H, W] f32 (R = B*C):
//   peak[r,y,x] = b >= up && b >= down && b >= left && b >= right && b > thre
//   (neighbours outside the image take the value `border`: 0.0f for the
//   nms_first_k contract, -inf for islx/ops/peaks.py::_nms_mask; any
//   comparison with NaN is false)
//   idx[r, :] = the flat indices y*W+x of the first K peaks of plane r in
//   row-major order, ascending, then the sentinel H*W.
//
// Bound: memory traffic. The plane is read once (4 B a pixel) until its K-th
// peak; the output is 4*K bytes a plane. There is no arithmetic to speak of.
// Design: one block of 1024 threads per plane walks it in row-major chunks
// of kThreads pixels (the parity path has only 25 planes, one block each,
// so a wide block walks its plane in fewer chunks). Each thread computes
// its pixel's peak bit; a warp ranks its peaks with __ballot_sync + __popc,
// and adds the counts of the warps before it (per-warp counts in shared
// memory, summed by __reduce_add_sync) and the running total of the chunks
// before. A thread writes its index when its rank is below K. The
// total is the same in every thread, so the loop leaves as one once it
// reaches K, and the slots past the last peak get the sentinel. There are
// no K sequential min-extractions as in the TPU design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
nms_first_k_kernel(const float* __restrict__ in, int32_t* __restrict__ idx,
                   float thre, float border, int h, int w, int k) {
  __shared__ int warp_cnt[kWarps];
  const int n = h * w;
  const float* p = in + static_cast<int64_t>(blockIdx.x) * n;
  int32_t* out = idx + static_cast<int64_t>(blockIdx.x) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int total = 0;                        // peaks in the chunks before
  for (int base = 0; base < n && total < k; base += kThreads) {
    const int i = base + threadIdx.x;
    bool peak = false;
    if (i < n) {
      const int y = i / w;
      const int x = i - y * w;
      const float v = p[i];
      const float up = y > 0 ? p[i - w] : border;
      const float down = y < h - 1 ? p[i + w] : border;
      const float left = x > 0 ? p[i - 1] : border;
      const float right = x < w - 1 ? p[i + 1] : border;
      peak = (v >= up) && (v >= down) && (v >= left) && (v >= right) &&
             (v > thre);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, peak);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    // lane j holds warp j's count: one shared read a thread, two reductions
    const unsigned cnt = lane < kWarps ? warp_cnt[lane] : 0u;
    const int before = total + static_cast<int>(__reduce_add_sync(
        0xffffffffu, lane < warp ? cnt : 0u));
    const int chunk = static_cast<int>(__reduce_add_sync(0xffffffffu, cnt));
    if (peak) {
      const int rank = before + __popc(ballot & ((1u << lane) - 1u));
      if (rank < k) out[rank] = i;
    }
    total += chunk;
    __syncthreads();                    // warp_cnt is rewritten next chunk
  }
  for (int s = total + threadIdx.x; s < k; s += kThreads) out[s] = n;
}

}  // namespace

// planes = B*C. Launches on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller instead of silently skipped.
extern "C" int islx_nms_first_k(const float* in, int32_t* idx, float thre,
                                float border, int64_t planes, int h, int w,
                                int k, void* stream) {
  if (planes > 0 && k > 0) {
    nms_first_k_kernel<<<static_cast<unsigned int>(planes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        in, idx, thre, border, h, w, k);
  }
  return static_cast<int>(cudaGetLastError());
}
