// 4-neighbour plateau NMS mask + per-row peak counts, CUDA C++ for sm_90a.
//
// Replaces islx/ops/pallas_peaks.py::_nms_mask_kernel (called through
// nms_mask_rows). Contract, for blurred maps b[R, H, W] f32 (R = B*C):
//   mask[r,y,x] = b >= up && b >= down && b >= left && b >= right && b > thre
//   (neighbours outside the image are 0.0f; any comparison with NaN is false)
//   row_cnt[r,y] = number of set mask pixels in row (r, y).
//
// Bound: memory traffic. Each pixel is read once (4 B) and written once as a
// byte; each row adds one 4 B count. There is no arithmetic to speak of.
// Design: one block per (r, y) row, 128 threads striding over W. Neighbour
// reads of the rows above and below are the same lines the neighbouring
// blocks read as their own row, so they mostly hit L1/L2 and device memory
// sees about one read per pixel. The row count comes from
// __syncthreads_count over a loop whose trip count is uniform across the
// block, so no shared memory and no atomics are needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
nms_mask_rows_kernel(const float* __restrict__ in, uint8_t* __restrict__ mask,
                     int32_t* __restrict__ row_cnt, float thre, int h, int w) {
  const int64_t row = blockIdx.x;              // r * h + y
  const int y = static_cast<int>(row % h);
  const float* p = in + row * w;
  uint8_t* m = mask + row * w;
  int count = 0;
  for (int x0 = 0; x0 < w; x0 += kThreads) {   // uniform trip count
    const int x = x0 + threadIdx.x;
    bool peak = false;
    if (x < w) {
      const float v = p[x];
      const float up = y > 0 ? p[x - w] : 0.0f;
      const float down = y < h - 1 ? p[x + w] : 0.0f;
      const float left = x > 0 ? p[x - 1] : 0.0f;
      const float right = x < w - 1 ? p[x + 1] : 0.0f;
      peak = (v >= up) && (v >= down) && (v >= left) && (v >= right) &&
             (v > thre);
      m[x] = peak ? 1 : 0;
    }
    count += __syncthreads_count(peak);
  }
  if (threadIdx.x == 0) row_cnt[row] = count;
}

}  // namespace

// rows = B*C. Launches on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller instead of silently skipped.
extern "C" int islx_nms_mask_rows(const float* in, uint8_t* mask,
                                  int32_t* row_cnt, float thre, int64_t rows,
                                  int h, int w, void* stream) {
  const int64_t blocks = rows * h;
  if (blocks > 0 && w > 0) {
    nms_mask_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        in, mask, row_cnt, thre, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
