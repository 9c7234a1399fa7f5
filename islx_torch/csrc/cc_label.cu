// 8-connected component labels of binary maps, CUDA C++ for sm_90a.
//
// Replaces islx/ops/pallas_cc.py::_cc_kernel (called through
// label_components_pallas). Contract, for fg[H, W, C] u8 (C innermost):
//   label[y,x,c] = the smallest row-major index y'*W+x' of the pixels of
//   (y,x)'s 8-connected component in channel c, or H*W for background.
//
// The TPU kernel keeps a channel's whole label map in VMEM and sweeps 3x3
// minima to a fixpoint; a sweep moves a label one pixel, so a thin spiral
// needs as many sweeps as it has pixels. Here it is block-based union-find
// in three launches, on tiles of th x kTw pixels of all C channels (the
// wrapper's tile_plan, islx_torch/ops/cc_label.py):
//   1. cc_tile, a block a tile, a thread a (row, channel) of it: the
//      tile's rows of fg are staged in shared memory by 16-byte cp.async
//      copies (a scalar head and tail where a row starts off 16 bytes).
//      A union-find forest a channel runs in shared memory over tile-local
//      slots: each thread points each run of foreground in its row at the
//      run's first slot; then lists each pair (run, run above it touches)
//      once; then the block unites the listed pairs, one pair a thread,
//      linking the larger root under the smaller by atomicMin, so a tile
//      root is the smallest pixel of its tile component. Each pixel's tile
//      root is written as a global pixel index straight into the label
//      map, H*W for background. No init pass.
//   2. cc_border, a thread a run of four slots of a tile's top row or left
//      column: the 8-neighbour links that cross a tile edge, corners
//      included (the top row's N, or NW and NE where N is background; the
//      left column's W, or NW and SW), once for each pair of labels. The
//      forest is the label map itself (a pixel's parent
//      is label[parent*C + c]); links go from the larger root to the
//      smaller by atomicCAS, and a find halves the path it walks. A chain
//      is as long as the tile components it joins, not as its pixel count.
//   3. cc_final, a thread a (row, tile column, channel): each foreground
//      pixel's label becomes its root, found by a read-only walk once for
//      each run of pixels that share a label.
// A parent is never larger than its child and trees never split, so each
// root is its component's smallest index, whatever order the threads run
// in: the result is exact and deterministic.
//
// Bound: memory traffic, a read of fg and a write of the labels (5 B a
// slot). The kernel moves 13 B a slot at most (fg once; the labels
// written, read back and rewritten where the root lies in another tile)
// plus the border pass's pointer walks; those walks, a chain of dependent
// L2 loads each, and the tile pass's union-find in shared memory set its
// time (PERF.md, the cc_label findings).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTw = 16;        // tile width, pixels (tile_plan's TILE_W)

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Root of tile-local slot s.
__device__ __forceinline__ int local_root(const volatile int* par, int s) {
  int p;
  while ((p = par[s]) != s) s = p;
  return s;
}

// Unites the trees of tile-local slots a and b (Playne and Hawick): the
// larger root takes the smaller as its parent by atomicMin; if it has
// meanwhile taken another parent, that parent is united with b in turn.
__device__ void local_unite(int* par, int a, int b) {
  while (true) {
    a = local_root(par, a);
    b = local_root(par, b);
    if (a == b) return;
    if (a < b) {
      const int s = a;
      a = b;
      b = s;
    }
    const int old = atomicMin(&par[a], b);
    if (old == a) return;
    a = old;
  }
}

// A label read from L2, where every block's writes meet (a volatile load
// would compile to a system-scope one).
__device__ __forceinline__ int32_t label_at(const int32_t* lab, int32_t p,
                                            int c, int cs) {
  return __ldcg(lab + static_cast<int64_t>(p) * cs + c);
}

// Root of pixel p in channel c of the label map; halves the path it walks.
__device__ int32_t find_root(int32_t* lab, int32_t p, int c, int cs) {
  int32_t curr = label_at(lab, p, c, cs);
  if (curr != p) {
    int32_t prev = p;
    int32_t next;
    while (curr > (next = label_at(lab, curr, c, cs))) {
      __stcg(lab + static_cast<int64_t>(prev) * cs + c, next);
      prev = curr;
      curr = next;
    }
  }
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

// Where a tile lies: block b of a grid of tiles_x tiles a row.
struct Tile {
  int y0, x0, rows, cols;
};

__device__ __forceinline__ Tile tile_of(int b, int tiles_x, int th, int tw,
                                        int h, int w) {
  const int ty = b / tiles_x;
  const int y0 = ty * th;
  const int x0 = (b - ty * tiles_x) * tw;
  return {y0, x0, min(th, h - y0), min(tw, w - x0)};
}

// Offset of row r of a tile from a 16-byte boundary, the tile's first row
// starting `base_pad` bytes off one and rows `stride` bytes apart.
__device__ __forceinline__ int row_pad(int base_pad, int64_t stride, int r) {
  return (base_pad + r * static_cast<int>(stride & 15)) & 15;
}

// Blocks of cc_tile: a thread a (row, channel) of the tile, up to 1024.
inline int tile_threads(int th, int cs) {
  const int n = (th * cs + 31) / 32 * 32;
  return n < 1024 ? n : 1024;
}

// A block a tile of th x kTw pixels; a thread a (row, channel) item.
__global__ void __launch_bounds__(1024)
cc_tile(const uint8_t* __restrict__ fg, int32_t* __restrict__ lab, int h,
        int w, int cs, int th, int tiles_x, int row_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_links;
  const int row = kTw * cs;                         // slots a tile row
  const int slots = th * row;
  // fg rows (16-byte aligned starts), the forest, then the links
  unsigned char* fgs = smem;
  int* par = reinterpret_cast<int*>(smem + th * row_bytes);
  unsigned* links = reinterpret_cast<unsigned*>(par + slots);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Tile t = tile_of(blockIdx.x, tiles_x, th, kTw, h, w);
  const int rb = t.cols * cs;                       // bytes a tile row
  const uint8_t* g0 = fg + (static_cast<int64_t>(t.y0) * w + t.x0) * cs;
  const int64_t stride = static_cast<int64_t>(w) * cs;
  const int base_pad = static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 15);

  // 1. stage: a warp a row; row r lands at fgs + r*row_bytes + its pad, so
  //    both sides of the 16-byte copies align
  const int lane = tid & 31;
  for (int r = tid >> 5; r < t.rows; r += nt >> 5) {
    const uint8_t* g = g0 + r * stride;
    const int pad = row_pad(base_pad, stride, r);
    unsigned char* d = fgs + r * row_bytes + pad;
    const int head = min((16 - pad) & 15, rb);
    const int quads = (rb - head) >> 4;
    if (lane < head) d[lane] = g[lane];
    const unsigned s16 =
        static_cast<unsigned>(__cvta_generic_to_shared(d + head));
    for (int i = lane; i < quads; i += 32)
      cp_async16(s16 + 16u * i, g + head + 16 * i);
    for (int i = head + 16 * quads + lane; i < rb; i += 32) d[i] = g[i];
  }
  if (tid == 0) n_links = 0;
  cp_async_wait_all();
  __syncthreads();

  // 2. runs: a thread scans a (row, channel) and points each run of
  //    foreground at its first slot. Slot s = (ly*kTw + lx)*cs + c; -1 is
  //    background.
  const int items = t.rows * cs;
  for (int i = tid; i < items; i += nt) {
    const int ly = i / cs;
    const int c = i - ly * cs;
    const unsigned char* f =
        fgs + ly * row_bytes + row_pad(base_pad, stride, ly) + c;
    int* p = par + ly * row + c;
    int start = -1;
#pragma unroll 1
    for (int lx = 0; lx < kTw; ++lx) {
      if (lx < t.cols && f[lx * cs]) {
        if (start < 0) start = ly * row + lx * cs + c;
      } else {
        start = -1;
      }
      p[lx * cs] = start;
    }
  }
  __syncthreads();

  // 3. links: a thread scans a (row, channel) below the first and lists
  //    each pair (run, run above it touches through N, NW or NE) once, as
  //    the two runs' first slots (below 2^16: tile_plan). Two rows' runs
  //    and their links form a forest, so a tile has fewer links than
  //    th * (kTw + 1) * cs.
  for (int i = tid + cs; i < items; i += nt) {
    const int ly = i / cs;
    const int c = i - ly * cs;
    const unsigned char* f =
        fgs + ly * row_bytes + row_pad(base_pad, stride, ly) + c;
    const int* up = par + (ly - 1) * row + c;
    const int* own = par + ly * row + c;
    int run = -1;     // this row's run at lx, and the last run above it
    int last = -1;    // touches (the runs above come in order of x)
#pragma unroll 1
    for (int lx = 0; lx < t.cols; ++lx) {
      if (!f[lx * cs]) continue;
      if (own[lx * cs] != run) {
        run = own[lx * cs];
        last = -1;
      }
      const int lo = max(lx - 1, 0);
      const int hi = min(lx + 1, t.cols - 1);
      for (int ux = lo; ux <= hi; ++ux) {
        const int v = up[ux * cs];
        if (v >= 0 && v != last) {
          last = v;
          links[atomicAdd(&n_links, 1)] =
              (static_cast<unsigned>(run) << 16) | v;
        }
      }
    }
  }
  __syncthreads();

  // 4. unite the linked runs' trees: the larger root takes the smaller as
  //    parent, so a tile root is the smallest pixel of its tile component
  for (int k = tid; k < n_links; k += nt)
    local_unite(par, static_cast<int>(links[k] >> 16),
                static_cast<int>(links[k] & 0xffff));
  __syncthreads();

  // 5. each pixel's tile root, as a global pixel index, into the label
  //    map, found once a run; H*W for background
  const int32_t bg = h * w;
  for (int i = tid; i < items; i += nt) {
    const int ly = i / cs;
    const int c = i - ly * cs;
    const int* p = par + ly * row + c;
    int32_t* out = lab + (static_cast<int64_t>(t.y0 + ly) * w + t.x0) * cs + c;
    int start = -2;
    int32_t root = bg;
#pragma unroll 1
    for (int lx = 0; lx < t.cols; ++lx) {
      const int s = p[lx * cs];
      if (s != start) {
        start = s;
        root = bg;
        if (s >= 0) {
          const int rq = local_root(par, s) / cs;
          root = (t.y0 + rq / kTw) * w + t.x0 + rq % kTw;
        }
      }
      out[lx * cs] = root;
    }
  }
}

constexpr int kSeg = 4;   // border pixels a thread
// A thread a (tile, run of kSeg pixels of its top row or left column,
// channel), neighbouring lanes on neighbouring channels. The top row links
// to N where it is foreground (its W and E links, inside a tile or
// crossing a column edge, join NW and NE), else to NW and NE; the left
// column to W where it is foreground (its N and S links join NW and SW),
// else to NW and SW. A link unites the labels of its two pixels (ancestors
// of both); a thread skips a link whose pair of labels is its last one's.
__global__ void __launch_bounds__(kThreads)
cc_border(const uint8_t* __restrict__ fg, int32_t* lab, int h, int w, int cs,
          int th, int tiles_x, int64_t items) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= items) return;
  const int64_t rest = i / cs;
  const int c = static_cast<int>(i - rest * cs);
  const int nseg = (kTw + th + kSeg - 1) / kSeg;   // top segments, then left
  const int seg = static_cast<int>(rest % nseg);
  const Tile t = tile_of(static_cast<int>(rest / nseg), tiles_x, th, kTw, h, w);
  const int topseg = kTw / kSeg;
  const bool is_top = seg < topseg;
  const int k0 = (is_top ? seg : seg - topseg) * kSeg;
  const int n = is_top ? t.cols : t.rows;
  if (is_top ? t.y0 == 0 : t.x0 == 0) return;
  const int64_t up = static_cast<int64_t>(w) * cs;
  int32_t last_a = -1, last_b = -1;
#pragma unroll
  for (int d = 0; d < kSeg; ++d) {
    const int k = k0 + d;
    if (k >= n) break;
    const int y = is_top ? t.y0 : t.y0 + k;
    const int x = is_top ? t.x0 + k : t.x0;
    const int32_t p = y * w + x;
    const int64_t at = static_cast<int64_t>(p) * cs + c;
    if (!fg[at]) continue;
    int32_t q[2] = {-1, -1};
    if (fg[is_top ? at - up : at - cs]) {
      q[0] = is_top ? p - w : p - 1;
    } else {
      if (x > 0 && y > 0 && fg[at - up - cs]) q[0] = p - w - 1;
      if ((is_top ? x + 1 < w : y + 1 < h) &&
          fg[is_top ? at - up + cs : at + up - cs])
        q[1] = is_top ? p - w + 1 : p + w - 1;
    }
    for (int l = 0; l < 2; ++l) {
      if (q[l] < 0) continue;
      const int32_t a = label_at(lab, p, c, cs);
      const int32_t b = label_at(lab, q[l], c, cs);
      if (a != last_a || b != last_b) {
        unite(lab, a, b, c, cs);
        last_a = a;
        last_b = b;
      }
    }
  }
}

// A thread a (row, tile column, channel): each foreground pixel's label
// becomes the root of its tree, found by a read-only walk once for each
// run of pixels with the same tile root. Each thread writes only its own
// slots, and only where the label changes: a walk that also shortened
// paths could store a mere ancestor over a slot that its own thread had
// already set to the root.
__global__ void __launch_bounds__(kThreads)
cc_final(int32_t* lab, int h, int w, int cs, int tiles_x, int64_t items) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= items) return;
  const int64_t rest = i / cs;
  const int c = static_cast<int>(i - rest * cs);
  const int y = static_cast<int>(rest / tiles_x);
  const int x0 = static_cast<int>(rest - static_cast<int64_t>(y) * tiles_x)
                 * kTw;
  const int cols = min(kTw, w - x0);
  const int32_t bg = h * w;
  const int64_t g0 = (static_cast<int64_t>(y) * w + x0) * cs + c;
  int32_t val[kTw];
#pragma unroll
  for (int lx = 0; lx < kTw; ++lx)
    val[lx] = lx < cols ? __ldcg(lab + g0 + lx * cs) : bg;
  int32_t from = bg;
  int32_t root = bg;
#pragma unroll
  for (int lx = 0; lx < kTw; ++lx) {
    if (val[lx] == bg) continue;
    if (val[lx] != from) {
      from = val[lx];
      int32_t next;
      root = from;
      while (root > (next = label_at(lab, root, c, cs))) root = next;
    }
    if (root != val[lx]) lab[g0 + lx * cs] = root;
  }
}

}  // namespace

// fg [H,W,C] u8 -> labels [H,W,C] s32, for tiles of th x 16 pixels
// (tiles_y x tiles_x of them), each staged in row_bytes a row and smem
// bytes in all (the wrapper's tile_plan). Three launches on `stream`, one
// where a single tile covers the map; returns the first CUDA error, 0 if
// none.
extern "C" int islx_cc_label(const uint8_t* fg, int32_t* lab, int h, int w,
                             int c, int th, int tiles_y, int tiles_x,
                             int row_bytes, int smem, void* stream) {
  if (static_cast<int64_t>(h) * w * c == 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (smem > 48 * 1024) {
    err = static_cast<int>(cudaFuncSetAttribute(
        cc_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
  }
  const unsigned int tiles = static_cast<unsigned int>(tiles_y) * tiles_x;
  cc_tile<<<tiles, tile_threads(th, c), smem, s>>>(fg, lab, h, w, c, th,
                                                   tiles_x, row_bytes);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || tiles == 1) return err;
  const int64_t edges = static_cast<int64_t>(tiles) *
                        ((kTw + th + kSeg - 1) / kSeg) * c;
  cc_border<<<static_cast<unsigned int>((edges + kThreads - 1) / kThreads),
              kThreads, 0, s>>>(fg, lab, h, w, c, th, tiles_x, edges);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t runs = static_cast<int64_t>(h) * tiles_x * c;
  cc_final<<<static_cast<unsigned int>((runs + kThreads - 1) / kThreads),
             kThreads, 0, s>>>(lab, h, w, c, tiles_x, runs);
  return static_cast<int>(cudaGetLastError());
}
