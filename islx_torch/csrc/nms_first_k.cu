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
// Bound: memory traffic. A plane is read once (4 B a pixel) up to its K-th
// peak; the output is 4*K bytes a plane. There is no arithmetic to speak of.
//
// Why the first design fell short: one block of 1024 threads walked a whole
// plane in 1024-pixel chunks, one 4 KB chunk in flight at a time, with two
// barriers each. At 25 planes (the parity Body) that is 25 blocks on 132
// SMs and ~100 KB in flight; the card needs some 3 MB in flight (3.35 TB/s
// times ~1 us of latency) to reach its bandwidth.
//
// This design: each plane is cut into row bands of about 4096 pixels (the
// wrapper's band_plan), and a block reads one band, or up to 4 consecutive
// bands of one plane in turn where the launch still has enough blocks
// (bands_per_block): the parity shape runs 4500 blocks of one band, the
// select step's 9600 blocks of four. For each band, the block copies it and
// one halo row above and below into shared memory with 16-byte cp.async
// copies, all issued before any is waited for; a row start off a 16-byte
// boundary goes through a scalar head and tail. Each warp then takes a
// contiguous row-major segment of the band and finds its peaks from shared
// memory, four pixels a lane from float4 reads where rows are multiples of
// 4 floats, else one; one barrier shares the warp counts, and a warp with
// peaks before the band's K-th walks its segment again to write each one's
// rank-ordered index. So pass 1 (band_kernel) writes each band's count and
// its first min(count, K) indices to scratch. Pass 2 (gather_kernel), one
// warp a plane, scans the band counts in order, copies each band's indices
// to their output slots until K are placed, and fills the sentinel.
//
// Early exit for dense planes: blocks are numbered band-major (every
// plane's first bands first), and a band whose own count reaches K lowers
// its plane's cutoff to its index with atomicMin and ends its block. A
// block whose next band lies after its plane's cutoff skips its read and
// ends. Pass 2 reads only the bands up to the final cutoff: the cutoff band
// alone holds K peaks, and no band up to it was skipped.
#include <cstdint>
#include <cuda_runtime.h>

#include "band_stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Walks warp segment [j0, j1) of the band (pixel j of the band is row
// y0 + j / w, column j % w; its shared slot is off + j), each lane kPx
// pixels a step, and calls visit(bits, j) with the lane's peak bits and
// first pixel; stops when visit returns true (uniformly in the warp). y
// and x follow j without a division a pixel.
template <int kPx, typename Visit>
__device__ __forceinline__ void walk(const float* s, int off, int j0, int j1,
                                     int y0, int h, int w, float thre,
                                     float border, Visit visit) {
  const int lane = threadIdx.x & 31;
  int j = j0 + kPx * lane;
  int y = y0 + j / w;
  int x = j - (y - y0) * w;
  for (int base = j0; base < j1; base += 32 * kPx) {
    const unsigned bits =
        j < j1 ? peak_bits<kPx>(s + off + j, y, x, h, w, thre, border) : 0u;
    if (visit(bits, j)) return;
    j += 32 * kPx;
    x += 32 * kPx;
    while (x >= w) {
      x -= w;
      ++y;
    }
  }
}

// One band's peak count, and its first min(count, k) indices in order,
// from the band staged in shared memory.
template <int kPx>
__device__ __forceinline__ void rank_band(const float* s, int off, int np,
                                          int y0, int h, int w, float thre,
                                          float border, int k, int* warp_cnt,
                                          int32_t* out, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // each warp a contiguous row-major segment of whole steps
  const int seg = (np + kThreads * kPx - 1) / (kThreads * kPx) * 32 * kPx;
  const int j0 = min(warp * seg, np);
  const int j1 = min(j0 + seg, np);
  int count = 0;
  walk<kPx>(s, off, j0, j1, y0, h, w, thre, border, [&](unsigned bits, int) {
    count += static_cast<int>(__reduce_add_sync(kFull, __popc(bits)));
    return false;
  });
  if (lane == 0) warp_cnt[warp] = count;
  __syncthreads();
  // lane j holds warp j's count
  const int cnt = lane < kWarps ? warp_cnt[lane] : 0;
  const int before = __reduce_add_sync(kFull, lane < warp ? cnt : 0);
  *total = __reduce_add_sync(kFull, cnt);
  if (count == 0 || before >= k) return;   // uniform in the warp
  const int base = y0 * w;
  int rank0 = before;                      // peaks before this step
  walk<kPx>(s, off, j0, j1, y0, h, w, thre, border,
            [&](unsigned bits, int j) {
              const int c = __popc(bits);
              int incl = c;                // scan of the lanes' counts
              for (int d = 1; d < 32; d <<= 1) {
                const int t = __shfl_up_sync(kFull, incl, d);
                if (lane >= d) incl += t;
              }
              int rank = rank0 + incl - c;
              for (unsigned b = bits; b && rank < k; b &= b - 1)
                out[rank++] = base + j + __ffs(b) - 1;
              rank0 += __shfl_sync(kFull, incl, 31);
              return rank0 >= k;
            });
}

__global__ void __launch_bounds__(kThreads)
band_kernel(const float* __restrict__ in, int32_t* __restrict__ band_idx,
            int32_t* __restrict__ band_cnt, uint32_t* __restrict__ cutoff,
            float thre, float border, int planes, int h, int w, int rows,
            int bands, int group, int k) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_cnt[kWarps];
  __shared__ int skip;
  float* s = reinterpret_cast<float*>(smem4);
  const int plane = static_cast<int>(blockIdx.x % planes);
  const int first = static_cast<int>(blockIdx.x / planes) * group;
  const int last = min(first + group, bands);
  const int tid = threadIdx.x;
  for (int band = first; band < last; ++band) {
    if (band > 0) {                     // band 0 is never after a cutoff
      if (tid == 0)
        skip = static_cast<uint32_t>(band) >
               *reinterpret_cast<volatile const uint32_t*>(cutoff + plane);
      __syncthreads();
      if (skip) return;
    }

    const Band bd = stage_band<kThreads>(s, in, plane, band, rows, h, w);
    cp_async_wait_all();
    __syncthreads();

    const int y0 = bd.y0;
    const int np = (bd.y1 - y0) * w;
    const int off = bd.off;
    const int64_t slot = static_cast<int64_t>(plane) * bands + band;
    int32_t* out = band_idx + slot * k;
    int total;
    if ((w & 3) == 0 && (off & 3) == 0)   // rows on 16-byte boundaries
      rank_band<4>(s, off, np, y0, h, w, thre, border, k, warp_cnt, out,
                   &total);
    else
      rank_band<1>(s, off, np, y0, h, w, thre, border, k, warp_cnt, out,
                   &total);
    if (tid == 0) {
      band_cnt[slot] = total;
      if (total >= k) atomicMin(cutoff + plane, static_cast<uint32_t>(band));
    }
    if (total >= k) return;             // the rest of the group is after it
    __syncthreads();                    // s and warp_cnt are reused
  }
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ band_idx,
              const int32_t* __restrict__ band_cnt,
              const uint32_t* __restrict__ cutoff, int32_t* __restrict__ idx,
              int planes, int bands, int k, int n) {
  const int64_t plane =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (plane >= planes) return;          // whole warps; no block barrier
  const int lane = threadIdx.x & 31;
  const int32_t* cnt = band_cnt + plane * bands;
  const int32_t* src = band_idx + plane * bands * k;
  int32_t* out = idx + plane * k;
  // bands after the cutoff were skipped, and the cutoff band alone holds
  // k peaks: only bands up to it count
  const int used = static_cast<int>(
      min(cutoff[plane], static_cast<uint32_t>(bands - 1))) + 1;
  // each lane a run of bands; an exclusive scan of the runs' counts
  const int per = (used + 31) / 32;
  const int b0 = min(lane * per, used);
  const int b1 = min(b0 + per, used);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += cnt[b];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  int pre = incl - sum;
  for (int b = b0; b < b1 && pre < k; ++b) {
    const int c = cnt[b];
    const int32_t* from = src + static_cast<int64_t>(b) * k;
    for (int j = 0; j < c && pre + j < k; ++j) out[pre + j] = from[j];
    pre += c;
  }
  const int total = min(__shfl_sync(kFull, incl, 31), k);
  for (int s = total + lane; s < k; s += 32) out[s] = n;
}

}  // namespace

// planes = B*C; the wrapper's band plan gives rows a band, bands a plane
// and the shared-memory bytes a block. `scratch` (int32, from the wrapper)
// holds band_idx [planes, bands, k], band_cnt [planes, bands] and the
// cutoffs [planes], which are reset here. Launches both passes on `stream`
// and returns the first error that is not cudaSuccess, so a refused launch
// is reported to the caller instead of silently skipped.
extern "C" int islx_nms_first_k(const float* in, int32_t* idx,
                                int32_t* scratch, float thre, float border,
                                int planes, int h, int w, int rows, int bands,
                                int group, int k, int smem_bytes,
                                void* stream) {
  if (planes <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t slots = static_cast<int64_t>(planes) * bands;
  int32_t* band_idx = scratch;
  int32_t* band_cnt = band_idx + slots * k;
  uint32_t* cutoff = reinterpret_cast<uint32_t*>(band_cnt + slots);
  // no cutoff yet: all ones, above every band index
  cudaError_t err = cudaMemsetAsync(cutoff, 0xff, planes * sizeof(uint32_t),
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(band_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>(planes) * ((bands + group - 1) / group);
  band_kernel<<<blocks, kThreads, smem_bytes, st>>>(
      in, band_idx, band_cnt, cutoff, thre, border, planes, h, w, rows, bands,
      group, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<<<static_cast<unsigned>((planes + kWarps - 1) / kWarps),
                  kThreads, 0, st>>>(band_idx, band_cnt, cutoff, idx, planes,
                                     bands, k, h * w);
  return static_cast<int>(cudaGetLastError());
}
