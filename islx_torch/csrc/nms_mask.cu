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
//
// Why the first design fell short: one 128-thread block a (r, y) row, each
// pixel and its four neighbours scalar loads, a byte store a pixel and a
// __syncthreads_count every 128 pixels. At [192,25,184,144] that is 883,200
// blocks of 144 pixels, the second pass of each row with 16 of 128 lanes
// busy; block launch and retirement set the pace: 0.65-0.69 ms against a
// 0.19 ms bound on an H100.
//
// This design: each plane is cut into row bands of about 4096 pixels (the
// wrapper's band_plan, islx_torch/ops/_bands.py), one 256-thread block a
// band: 33,600 blocks at [192,25,184,144]. Blocks are numbered
// plane-major, so the halo rows that two blocks share are read close
// together in time (L2). A band and its halo rows are staged in shared
// memory with 16-byte cp.async copies, all issued before the first wait
// (band_stage.cuh). Each thread then takes four pixels of one row a step
// from float4 reads where rows are multiples of 4 floats (else one pixel),
// and writes their mask bytes as one 32-bit store, so a warp writes 128
// contiguous bytes. Bands cover whole rows, so a block owns its rows'
// counts: a shared counter a row, added to (atomicAdd on shared memory)
// only by a thread that found peaks, written out as coalesced int32 stores
// after one barrier. One launch, no scratch, no global atomics. A block
// that read 4 bands in turn, the next band's copies in flight while it
// worked on the current one, was no faster on an H100 (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

#include "band_stage.cuh"

namespace {

constexpr int kThreads = 256;

// Masks band pixels [0, np) (row y0 + j / w, column j % w; shared slot
// off + j), kPx a thread a step: mask bytes to m (the band's first pixel
// in the mask), each row's peaks added to cnt[row - y0].
template <int kPx>
__device__ __forceinline__ void mask_band(const float* s, int off, int np,
                                          int y0, int h, int w, float thre,
                                          uint8_t* m, int* cnt) {
  for (int j = kPx * threadIdx.x; j < np; j += kPx * kThreads) {
    const int r = j / w;
    const unsigned bits =
        peak_bits<kPx>(s + off + j, y0 + r, j - r * w, h, w, thre, 0.0f);
    if constexpr (kPx == 4) {
      // bit t -> byte t; m + j is 4-byte aligned (w and j are multiples
      // of 4, the mask starts on an allocation)
      *reinterpret_cast<uint32_t*>(m + j) = (bits & 1u) | (bits & 2u) << 7 |
                                            (bits & 4u) << 14 |
                                            (bits & 8u) << 21;
    } else {
      m[j] = static_cast<uint8_t>(bits);
    }
    if (bits) atomicAdd(cnt + r, __popc(bits));
  }
}

// Block b masks band b % bands of plane b / bands. Shared memory: the
// band buffer ((rows + 2) * w + 3 floats, band_plan's bytes), then `rows`
// row counters.
__global__ void __launch_bounds__(kThreads)
nms_mask_kernel(const float* __restrict__ in, uint8_t* __restrict__ mask,
                int32_t* __restrict__ row_cnt, float thre, int h, int w,
                int rows, int bands) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  int* cnt = reinterpret_cast<int*>(s + (rows + 2) * w + 3);
  const int plane = static_cast<int>(blockIdx.x / bands);
  const int band = static_cast<int>(blockIdx.x - plane * bands);
  const int tid = threadIdx.x;
  for (int i = tid; i < rows; i += kThreads) cnt[i] = 0;
  const Band bd = stage_band<kThreads>(s, in, plane, band, rows, h, w);
  cp_async_wait_all();
  __syncthreads();                    // the band is staged, counters zero

  const int np = (bd.y1 - bd.y0) * w;
  const int64_t row0 = static_cast<int64_t>(plane) * h + bd.y0;
  uint8_t* m = mask + row0 * w;
  if ((w & 3) == 0 && (bd.off & 3) == 0)   // rows on 16-byte boundaries
    mask_band<4>(s, bd.off, np, bd.y0, h, w, thre, m, cnt);
  else
    mask_band<1>(s, bd.off, np, bd.y0, h, w, thre, m, cnt);
  __syncthreads();                    // the counts are done

  for (int i = tid; i < bd.y1 - bd.y0; i += kThreads)
    row_cnt[row0 + i] = cnt[i];
}

}  // namespace

// planes = B*C; the wrapper's band plan gives rows a band, bands a plane
// and the shared bytes a block. Launches on `stream` and returns the first
// error that is not cudaSuccess, so a refused launch is reported to the
// caller instead of silently skipped.
extern "C" int islx_nms_mask_rows(const float* in, uint8_t* mask,
                                  int32_t* row_cnt, float thre, int planes,
                                  int h, int w, int rows, int bands,
                                  int smem_bytes, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaGetLastError());
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_mask_kernel<<<static_cast<unsigned>(planes) * bands, kThreads,
                    smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      in, mask, row_cnt, thre, h, w, rows, bands);
  return static_cast<int>(cudaGetLastError());
}
