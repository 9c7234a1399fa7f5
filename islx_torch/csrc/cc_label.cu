// 8-connected component labels of binary maps, CUDA C++ for sm_90a.
//
// Replaces islx/ops/pallas_cc.py::_cc_kernel (called through
// label_components_pallas). Contract, for fg[H, W, C] u8 (C innermost):
//   label[y,x,c] = the smallest row-major index y'*W+x' of the pixels of
//   (y,x)'s 8-connected component in channel c, or H*W for background.
//
// The TPU kernel keeps a channel's whole label map in VMEM and sweeps 3x3
// minima to a fixpoint. An int32 map of a 368x368 crop is 529 KiB, over the
// 227 KB a block can hold, and a sweep moves a label one pixel, so a thin
// spiral needs as many sweeps as it has pixels. Here the labels live in
// device memory as a union-find forest (ECL-CC style):
//   1. init: parent[p] = p for foreground, H*W for background;
//   2. merge: each foreground pixel unions with its W, NW, N and NE
//      foreground neighbours. A root is linked only by atomicCAS while it
//      is still a root, always from the larger index to the smaller, and a
//      find shortens the path it walks with plain stores of ancestors;
//   3. flatten: label[p] = the root of p, found by a walk that writes
//      nothing but p's own slot. (A walk that also shortened paths here
//      could store a mere ancestor over a slot that its own thread had
//      already set to the root.)
// A parent is never larger than its child and trees never split, so each
// root is its component's smallest index, whatever order the threads run
// in: the result is exact and deterministic.
//
// Bound: memory traffic, a read of the map and a write of the labels (5 B a
// pixel), plus the forest's pointer chasing, which depends on the shapes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Root of pixel p in channel c; shortens the path to it on the way.
__device__ int32_t find_root(int32_t* lab, int32_t p, int c, int cs) {
  volatile int32_t* v = lab;
  int32_t curr = v[static_cast<int64_t>(p) * cs + c];
  if (curr != p) {
    int32_t prev = p;
    int32_t next;
    while (curr > (next = v[static_cast<int64_t>(curr) * cs + c])) {
      v[static_cast<int64_t>(prev) * cs + c] = next;
      prev = curr;
      curr = next;
    }
  }
  return curr;
}

// Root of pixel p in channel c, read-only.
__device__ int32_t root_of(const int32_t* lab, int32_t p, int c, int cs) {
  const volatile int32_t* v = lab;
  int32_t curr = p;
  int32_t next;
  while (curr > (next = v[static_cast<int64_t>(curr) * cs + c])) curr = next;
  return curr;
}

__device__ void unite(int32_t* lab, int32_t p, int32_t q, int c, int cs) {
  int32_t a = find_root(lab, p, c, cs);
  int32_t b = find_root(lab, q, c, cs);
  while (a != b) {
    if (a < b) {
      const int32_t s = a;
      a = b;
      b = s;
    }
    // link root a under b; a CAS that fails returns a's new parent, which
    // is smaller than a, so the loop ends
    const int32_t ret = atomicCAS(&lab[static_cast<int64_t>(a) * cs + c], a, b);
    if (ret == a) break;
    a = ret;
  }
}

__global__ void __launch_bounds__(kThreads)
cc_init(const uint8_t* __restrict__ fg, int32_t* __restrict__ lab, int64_t n,
        int cs, int32_t bg) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g < n) lab[g] = fg[g] ? static_cast<int32_t>(g / cs) : bg;
}

__global__ void __launch_bounds__(kThreads)
cc_merge(const uint8_t* __restrict__ fg, int32_t* lab, int64_t n, int w,
         int cs) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n || !fg[g]) return;
  const int c = static_cast<int>(g % cs);
  const int32_t p = static_cast<int32_t>(g / cs);
  const int y = p / w;
  const int x = p - y * w;
  const int64_t row = static_cast<int64_t>(w) * cs;
  if (x > 0 && fg[g - cs]) unite(lab, p, p - 1, c, cs);
  if (y > 0) {
    if (x > 0 && fg[g - row - cs]) unite(lab, p, p - w - 1, c, cs);
    if (fg[g - row]) unite(lab, p, p - w, c, cs);
    if (x < w - 1 && fg[g - row + cs]) unite(lab, p, p - w + 1, c, cs);
  }
}

__global__ void __launch_bounds__(kThreads)
cc_flatten(const uint8_t* __restrict__ fg, int32_t* lab, int64_t n, int cs) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n || !fg[g]) return;
  const int32_t root =
      root_of(lab, static_cast<int32_t>(g / cs), static_cast<int>(g % cs),
              cs);
  lab[g] = root;
}

}  // namespace

// fg [H,W,C] u8 -> labels [H,W,C] s32. Three launches on `stream`; returns
// the first cudaGetLastError() that is not cudaSuccess.
extern "C" int islx_cc_label(const uint8_t* fg, int32_t* lab, int h, int w,
                             int c, void* stream) {
  const int64_t n = static_cast<int64_t>(h) * w * c;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cc_init<<<blocks, kThreads, 0, s>>>(fg, lab, n, c, h * w);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  cc_merge<<<blocks, kThreads, 0, s>>>(fg, lab, n, w, c);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  cc_flatten<<<blocks, kThreads, 0, s>>>(fg, lab, n, c);
  return static_cast<int>(cudaGetLastError());
}
