// class_sor_sweep<T>: one full class SOR sweep, in place on x, K-free.
//
// The rows are cut into tiles of `class_size` consecutive rows (a class of
// the (block, class) ordering made at setup); the tiles are walked in
// storage order, and within a tile every row gathers from the same x
// (class-Jacobi) before any of them is written:
//     x_i += [mask_i] omega_i / d_i (b_i - lagc_i x_lag - (A x)_i)
// That is exact Gauss-Seidel over the tiles (ops/smoothers.py _gs_sweep).
// Rows the smoother does not update (mask 0: Dirichlet and Neumann rows,
// padding rows with d = 1) are never written.
//
// Replaces three TPU kernels of the reference package, which compute this
// same function in their layouts:
//   meshlessmultigridpoisson_tpu/ops/kernels.py:586 sor_sweep_tpu2 (role
//     "sweep2", the v2-fallback level smoother: class by class inside
//     `block_rows` blocks, foreign x patches frozen for a block, its own
//     patch refreshed before every class)
//   meshlessmultigridpoisson_tpu/ops/kernels4.py:464 sor_sweep_tpu4 (role
//     "sweep4", probes.ktime: the in-block coupling as a dense matrix on
//     the MXU)
//   meshlessmultigridpoisson_tpu/ops/kernels.py:303 sor_sweep_tpu (role
//     "sweep1", probes.kexp: the v1 (block, class) sweep)
//
// What bounds it on an H100: the dependent chain, not bytes.  Exact GS
// forbids two tiles side by side (the storage-order tile graph is nearly
// serial), so the sweep is one chain of n / class_size links on one SM;
// its bytes would take ~0.02 ms on the slice's fine level.  The parent
// design (kept as the timing-only role "sweep2_tilewalk", below) put every
// load of a tile on its link: the rows' values and columns from device
// memory over the full width, the x gather, a block-wide shuffle
// reduction, the five row vectors, two __syncthreads() over 32 x
// class_size threads: 0.75-1.6 us a tile on the H100.  Here the link
// reads only shared memory and only the x-dependent work stays on it:
//   * Windows.  The rows are cut into windows of `window` rows (whole
//     tiles).  Each row's nonzero prefix was reordered on the host
//     (ops/gpu_kernels.class_window_tables) so that its first seg[i]
//     entries are its "chain" entries, columns in [w0 - window, its tile's
//     first row): the previous window and the earlier tiles of its own.
//     Every other term (its own tile, the diagonal included, later tiles,
//     every other window) reads x values that do not change between the
//     start of the previous window's chain and its own tile's update, so
//     it is summed in bulk, off the chain, one window ahead: the JAX
//     kernel's frozen foreign patches, widened by one window.  Its own
//     tile's terms come from the old x, which keeps the class-Jacobi rule
//     (gather, then write) with no barrier inside the tile.
//   * Warp roles (1024 threads).  Warp 0 is the chain: class_size rows of
//     a tile at once, G = 32 / class_size (a power of two) lanes a row,
//     each row's chain entries gathered from its staged slot and the
//     shared x ring (every gather of a chunk issued before the first
//     product), a G-lane shuffle sum, the update written to the ring,
//     then __syncwarp(): one warp, no CTA barrier on the link.  Its lane 0
//     stages the tiles' rows (values and columns, full width; up to
//     kStageRows rows a copy) into a ring of shared slots with
//     cp.async.bulk on mbarriers, refilling a slot as soon as its last
//     tile is read, and prefetches the windows kAheadWindows on into L2.
//     Warps 1-31 sum the next window's bulk terms (4 lanes a row, each row
//     read from seg[i] to lens[i], every load of a chunk issued before the
//     first product) into shared memory while the chain walks the current
//     window: g_i = b_i - lagc_i x_lag - bulk_i and coef_i = [mask_i]
//     omega_i / d_i, and copy the next window's x into the ring.  The chain
//     writes its window's x to device memory once, coalesced, and meets
//     the bulk warps on one named barrier (bar.sync 1) a window.
//   * The shared x ring holds 3 windows (the previous, the current, the
//     next one being copied) at x[c & (xring - 1)].
//   * The shared layout, the slot size and the ring's depth are computed
//     by the launcher from the card's shared memory (a compile-time
//     layout cost storage_chain 11-18% on the H100).
// A rectangular sweep: the tables may hold the first n rows of a longer x
// (a shard's frontier rows over its extended vector [own rows | neighbour
// frontiers], parallel/sharded.py).  A column at or past n lies past every
// tile's first row, so it is never a chain entry: it is read in the bulk
// sums from device memory (values no sweep of this launch writes), and
// only rows below n are staged into the ring or written back.
// Loads are issued a chunk at a time before their products because a load
// under the entry's predicate, consumed at once, costs one full latency per
// entry (PERF.md §6).  A slot's bulk copy is the 16-byte-aligned
// span around its rows (the tables are 16-byte aligned and n_pad * width a
// multiple of 4): the chain offsets into the slot.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sweep_common.cuh"

namespace {

using mmp_sweep::bulk_load;
using mmp_sweep::bulk_prefetch_l2;
using mmp_sweep::kWarp;
using mmp_sweep::mbar_expect;
using mmp_sweep::mbar_init;
using mmp_sweep::mbar_wait;

constexpr int kMaxClass = 32;
constexpr int kThreads = 1024;
constexpr int kBulkWarps = kThreads / kWarp - 1;  // warps 1..31
constexpr int kBulkLanes = 4;                     // lanes a row in the bulk sums
constexpr int kBulkRows = kWarp / kBulkLanes;     // rows a bulk warp sums at once
constexpr int kBulkChunk = 8;   // entries a bulk lane loads before gathering
constexpr int kChunk = 8;       // chain entries a lane holds in registers
constexpr int kTail = 4;        // entries a lane gathers at once past them
constexpr int kMaxRing = 32;    // ring slots
constexpr int kStageRows = 128;  // rows a slot holds (one copy), where it fits
constexpr int kMinDepth = 2;     // slots in the ring at least, else smaller slots
constexpr int kAheadWindows = 2;  // L2 prefetch distance, in windows
constexpr int kBarWindow = 1;     // named barrier: chain + bulk warps

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ void bar_window() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBarWindow), "r"((kBulkWarps + 1) * kWarp)
               : "memory");
}

__host__ __device__ inline unsigned al128(unsigned v) {
  return (v + 127u) & ~127u;
}

// Shared memory, offsets in bytes: the mbarriers (full[kMaxRing]), the
// ring of slots (each `stage` tiles: values, then
// columns at `cols`), the x ring, then per window (two buffers) g, coef
// and seg.
struct ClassLayout {
  unsigned slot, cols, ring, xs, g, coef, seg, total;
  int depth, stage;  // slots in the ring; tiles a slot (one copy)
};

template <typename T>
__host__ inline ClassLayout class_layout(int width, int class_size, int window,
                                         int xring, int stage, unsigned optin) {
  ClassLayout L;
  L.stage = stage;
  // a slot's span: its tiles' bytes and up to 12 more on each side
  const unsigned rows = stage * class_size;
  L.cols = al128(rows * width * sizeof(T) + 32);
  L.slot = L.cols + al128(rows * width * sizeof(int) + 32);
  L.ring = al128(kMaxRing * sizeof(uint64_t));
  const unsigned fixed = al128(xring * sizeof(T)) + 2 * al128(2 * window * sizeof(T)) +
                         al128(2 * window * sizeof(int));
  const long room = static_cast<long>(optin) - L.ring - fixed;
  L.depth = room > 0 ? static_cast<int>(room / L.slot) : 0;
  if (L.depth > kMaxRing) L.depth = kMaxRing;
  L.xs = L.ring + L.depth * L.slot;
  L.g = L.xs + al128(xring * sizeof(T));
  L.coef = L.g + al128(2 * window * sizeof(T));
  L.seg = L.coef + al128(2 * window * sizeof(T));
  L.total = L.seg + al128(2 * window * sizeof(int));
  return L;
}

template <typename T>
struct ClassArgs {
  const T* vals;     // [n, width] row-major ELL, chain entries first a row
  const int* cols;   // global int32 columns
  const int* lens;   // one past each row's last nonzero
  const short* seg;  // each row's chain entries (a prefix)
  int width, n, class_size, window, xmask, ahead;
  const T* diag;
  const T* b;
  const T* mask;
  const T* omega;
  const T* lagc;
  const T* xlag;
  ClassLayout L;
  T* x;  // read and written: no __restrict__
};

// the 16-byte-aligned span around [lo, hi) bytes of p (a hint), clamped to
// the first `total` bytes
__device__ __forceinline__ void prefetch_span(const void* p, size_t lo, size_t hi,
                                              size_t total) {
  lo &= ~size_t(15);
  hi = (hi + 15) & ~size_t(15);
  if (hi > (total & ~size_t(15))) hi = total & ~size_t(15);
  if (hi > lo) {
    bulk_prefetch_l2(static_cast<const char*>(p) + lo, static_cast<uint32_t>(hi - lo));
  }
}

// window W's rows (values, columns, lens, seg, row vectors) into L2
template <typename T>
__device__ void prefetch_window(const ClassArgs<T>& a, int W) {
  const size_t w = a.width, n = a.n;
  const size_t r0 = static_cast<size_t>(W) * a.window;
  const size_t r1 = r0 + a.window < n ? r0 + a.window : n;
  prefetch_span(a.vals, r0 * w * sizeof(T), r1 * w * sizeof(T), n * w * sizeof(T));
  prefetch_span(a.cols, r0 * w * 4, r1 * w * 4, n * w * 4);
  prefetch_span(a.lens, r0 * 4, r1 * 4, n * 4);
  prefetch_span(a.seg, r0 * 2, r1 * 2, n * 2);
  const T* vecs[5] = {a.diag, a.b, a.mask, a.omega, a.lagc};
  for (const T* v : vecs) prefetch_span(v, r0 * sizeof(T), r1 * sizeof(T), n * sizeof(T));
}

// stage k (tiles [k, k + 1) * L.stage) into ring slot k % depth: the
// 16-byte-aligned spans of its rows' values and columns, on full[slot]
template <typename T>
__device__ void issue_stage(const ClassArgs<T>& a, unsigned char* smem, uint64_t* full,
                            int k) {
  const size_t sv = static_cast<size_t>(a.L.stage) * a.class_size * a.width * sizeof(T);
  const size_t sc = static_cast<size_t>(a.L.stage) * a.class_size * a.width * sizeof(int);
  const size_t nv = static_cast<size_t>(a.n) * a.width * sizeof(T);
  const size_t nc = static_cast<size_t>(a.n) * a.width * sizeof(int);
  const int s = k % a.L.depth;
  // the chain's generic-proxy reads of the slot are done (a __syncwarp)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const size_t v0 = k * sv, c0 = k * sc;
  const size_t vlo = v0 & ~size_t(15), vhi = (v0 + sv + 15) & ~size_t(15);
  const size_t clo = c0 & ~size_t(15), chi = (c0 + sc + 15) & ~size_t(15);
  const uint32_t vb = static_cast<uint32_t>((vhi < nv ? vhi : nv) - vlo);
  const uint32_t cb = static_cast<uint32_t>((chi < nc ? chi : nc) - clo);
  unsigned char* slot = smem + a.L.ring + s * a.L.slot;
  mbar_expect(&full[s], vb + cb);
  bulk_load(slot, reinterpret_cast<const char*>(a.vals) + vlo, vb, &full[s]);
  bulk_load(slot + a.L.cols, reinterpret_cast<const char*>(a.cols) + clo, cb, &full[s]);
}

// warps 1..31: window W's bulk terms and x into shared memory (buffer W & 1)
template <typename T>
__device__ void bulk_window(const ClassArgs<T>& a, unsigned char* smem, int W, T xl) {
  const int lane = threadIdx.x % kWarp;
  const int bw = threadIdx.x / kWarp - 1;
  const int sub = lane % kBulkLanes;
  const int w0 = W * a.window;
  const int rows = min(a.window, a.n - w0);
  const int buf = (W & 1) * a.window;
  T* xs = reinterpret_cast<T*>(smem + a.L.xs);
  T* g = reinterpret_cast<T*>(smem + a.L.g) + buf;
  T* coef = reinterpret_cast<T*>(smem + a.L.coef) + buf;
  int* seg = reinterpret_cast<int*>(smem + a.L.seg) + buf;
  for (int lr0 = bw * kBulkRows; lr0 < rows; lr0 += kBulkWarps * kBulkRows) {
    const int lr = lr0 + lane / kBulkLanes;
    const bool in = lr < rows;
    const int row = in ? w0 + lr : w0;
    const int e1 = in ? a.seg[row] : 0;
    const int len = in ? a.lens[row] : 0;
    // the row's own data, in flight during the sums
    const T bq = a.b[row], lq = a.lagc[row], mq = a.mask[row], oq = a.omega[row],
            dq = a.diag[row], xq = a.x[row];
    const T* v = a.vals + static_cast<size_t>(row) * a.width;
    const int* c = a.cols + static_cast<size_t>(row) * a.width;
    T acc = T(0);
    for (int k0 = e1 + sub; k0 < len; k0 += kBulkLanes * kBulkChunk) {
      // every load of the chunk issued before the first product (indices
      // past the row clamped to its last entry, their values zero)
      int cq[kBulkChunk];
      T vq[kBulkChunk], xv[kBulkChunk];
#pragma unroll
      for (int q = 0; q < kBulkChunk; ++q) {
        const int k = k0 + q * kBulkLanes;
        const int kc = min(k, len - 1);
        cq[q] = c[kc];
        vq[q] = v[kc];
      }
#pragma unroll
      for (int q = 0; q < kBulkChunk; ++q) xv[q] = a.x[cq[q]];
#pragma unroll
      for (int q = 0; q < kBulkChunk; ++q) {
        acc += k0 + q * kBulkLanes < len ? vq[q] * xv[q] : T(0);
      }
    }
#pragma unroll
    for (int off = kBulkLanes / 2; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (in && sub == 0) {
      g[lr] = bq - lq * xl - acc;
      coef[lr] = mq > T(0) ? oq / dq : T(0);
      seg[lr] = e1;
      xs[row & a.xmask] = xq;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) class_window_kernel(const ClassArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int nwin = (a.n + a.window - 1) / a.window;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.L.depth; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const T xl = *a.xlag;
  if (warp >= 1) {
    bulk_window(a, smem, 0, xl);
    bar_window();
    for (int W = 0; W < nwin; ++W) {
      if (W + 1 < nwin) bulk_window(a, smem, W + 1, xl);
      bar_window();
    }
    return;
  }

  // warp 0: the chain.  Lane (r, sub): row r of the tile, G lanes a row.
  const int S = a.class_size;
  int G = 1;
  while (2 * G * S <= kWarp) G *= 2;
  const int r = lane / G, sub = lane % G;
  const bool active = r < S;
  const int depth = a.L.depth, U = a.L.stage, ntiles = a.n / S;
  const int xmask = a.xmask, width = a.width;
  T* x = a.x;
  const int nstages = (ntiles + U - 1) / U;
  const size_t tv = static_cast<size_t>(S) * a.width * sizeof(T);
  const size_t tc = static_cast<size_t>(S) * a.width * sizeof(int);
  T* xs = reinterpret_cast<T*>(smem + a.L.xs);
  // the lane's row of tile t in its slot, and its first chunk of entries
  const T* tvp = nullptr;
  const int* tcp = nullptr;
  int cq[kChunk];
  T vq[kChunk];
  // the stage (k), its slot (s) and parity (ph), the tile within it (u):
  // carried from tile to tile, no division on the link
  int k = 0, s = 0, ph = 0, u = 0;
  const unsigned stage_v = static_cast<unsigned>(U * tv), stage_c = static_cast<unsigned>(U * tc);
  unsigned vo = 0, co = 0;  // the stage's first byte mod 16 in its span
  auto stage = [&](int t) {
    if (t > 0 && ++u == U) {
      u = 0;
      ++k;
      vo = (vo + stage_v) & 15u;
      co = (co + stage_c) & 15u;
      if (++s == depth) {
        s = 0;
        ph ^= 1;
      }
    }
    if (u == 0) mbar_wait(&full[s], ph);
    const unsigned char* slot = smem + a.L.ring + s * a.L.slot;
    tvp = reinterpret_cast<const T*>(slot + vo + u * static_cast<unsigned>(tv)) + r * width;
    tcp = reinterpret_cast<const int*>(slot + a.L.cols + co + u * static_cast<unsigned>(tc)) +
          r * width;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int e = q * G + sub;
      const bool in = active && e < width;
      cq[q] = in ? tcp[e] : 0;
      vq[q] = in ? tvp[e] : T(0);
    }
  };
  int pw = -1;  // the last window prefetched into L2
  if (lane == 0) {
    while (pw < a.ahead && pw + 1 < nwin) prefetch_window(a, ++pw);
    for (int k0 = 0; k0 < depth && k0 < nstages; ++k0) issue_stage(a, smem, full, k0);
  }
  stage(0);
  bar_window();  // window 0's bulk terms and x
  int t = 0;
  for (int W = 0; W < nwin; ++W) {
    const int w0 = W * a.window;
    const int tiles = min(a.window, a.n - w0) / S;
    const int buf = (W & 1) * a.window;
    const T* g = reinterpret_cast<const T*>(smem + a.L.g) + buf;
    const T* coef = reinterpret_cast<const T*>(smem + a.L.coef) + buf;
    const int* seg = reinterpret_cast<const int*>(smem + a.L.seg) + buf;
    if (lane == 0 && pw + 1 < nwin) prefetch_window(a, ++pw);
    for (int j = 0; j < tiles; ++j, ++t) {
      const int lr = j * S + r;
      const int row = w0 + lr;
      int e1 = 0;
      T gi = T(0), ci = T(0), xo = T(0);
      if (active) {
        e1 = seg[lr];
        gi = g[lr];
        ci = coef[lr];
        xo = xs[row & xmask];
      }
      // every gather of the chunk issued before the first product
      T xv[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) xv[q] = xs[cq[q] & xmask];
      // entries past seg gathered ring slots that may hold no x yet: the
      // product is dropped, not computed from a zeroed value (0 x NaN)
      T acc0 = T(0), acc1 = T(0);
#pragma unroll
      for (int q = 0; q < kChunk; q += 2) {
        acc0 += q * G + sub < e1 ? vq[q] * xv[q] : T(0);
        acc1 += (q + 1) * G + sub < e1 ? vq[q + 1] * xv[q + 1] : T(0);
      }
      // rows past the chunk: kTail entries a lane in flight at once
      for (int e0 = kChunk * G + sub; e0 < e1; e0 += kTail * G) {
        int c4[kTail];
        T v4[kTail];
#pragma unroll
        for (int q = 0; q < kTail; ++q) {
          const int e = min(e0 + q * G, width - 1);
          c4[q] = tcp[e];
          v4[q] = tvp[e];
        }
#pragma unroll
        for (int q = 0; q < kTail; ++q) {
          const T p = v4[q] * xs[c4[q] & xmask];
          acc0 += e0 + q * G < e1 ? p : T(0);
        }
      }
      T acc = acc0 + acc1;
      for (int off = G / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (active && sub == 0 && ci != T(0)) xs[row & xmask] = xo + ci * (gi - acc);
      __syncwarp();
      // the slot's last tile is read: refill it with the stage depth on
      if (lane == 0 && u == U - 1 && k + depth < nstages) {
        issue_stage(a, smem, full, k + depth);
      }
      if (t + 1 < ntiles) stage(t + 1);
      __syncwarp();  // the tile's writes before the next tile's gathers
    }
    // the window's x to device memory once, coalesced: the next window's
    // bulk sums (after the barrier) read it there
    for (int i = lane; i < tiles * S; i += kWarp) x[w0 + i] = xs[(w0 + i) & xmask];
    bar_window();  // window W written; window W + 1's bulk terms and x ready
  }
}

template <typename T>
int launch_class_window(ClassArgs<T> a, void* stream, int* info) {
  if (a.class_size < 1 || a.class_size > kMaxClass || a.n % a.class_size != 0 ||
      a.window < a.class_size || a.window % a.class_size != 0 ||
      (static_cast<long>(a.n) * a.width) % 4 != 0 || a.xmask + 1 < 3 * a.window ||
      ((a.xmask + 1) & a.xmask) != 0 || a.width < 1 || a.width > 32767 ||
      (reinterpret_cast<uintptr_t>(a.vals) | reinterpret_cast<uintptr_t>(a.cols)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // kStageRows rows a slot, fewer where the ring would hold under kMinDepth
  int stage = kStageRows / a.class_size;
  if (stage < 1) stage = 1;
  a.L = class_layout<T>(a.width, a.class_size, a.window, a.xmask + 1, stage,
                        static_cast<unsigned>(optin));
  while (a.L.depth < kMinDepth && stage > 1) {
    stage /= 2;
    a.L = class_layout<T>(a.width, a.class_size, a.window, a.xmask + 1, stage,
                          static_cast<unsigned>(optin));
  }
  a.ahead = kAheadWindows;

  if (info != nullptr) {
    info[0] = a.L.depth;
    info[1] = static_cast<int>(a.L.total);
    info[2] = a.L.stage;
  }
  // a ring of 2 slots at least
  if (a.L.depth < 2 || a.L.total > static_cast<unsigned>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n == 0) return static_cast<int>(cudaSuccess);
  auto kern = class_window_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(a.L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, kThreads, a.L.total, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the parent design: role "sweep2_tilewalk" (timing only) -------------
// One CTA of 32 x class_size threads walks the tiles, one warp a row over
// the full width (consecutive lanes on consecutive entries, a shuffle sum);
// lane 0 computes the update before the first barrier and stores it after
// it, a second barrier before the next tile gathers.

template <typename T>
__global__ void __launch_bounds__(kWarp * kMaxClass)
tilewalk_kernel(const T* __restrict__ vals, const int* __restrict__ cols, int width,
                int ntiles, int class_size, const T* __restrict__ diag,
                const T* __restrict__ b, const T* __restrict__ mask,
                const T* __restrict__ omega, const T* __restrict__ lagc,
                const T* __restrict__ xlag_ptr,
                T* x) {  // read and written: no __restrict__
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const T xlag = *xlag_ptr;

  for (int t = 0; t < ntiles; ++t) {
    const size_t row = static_cast<size_t>(t) * class_size + warp;
    const size_t base = row * static_cast<size_t>(width);
    T acc = T(0);
    for (int k = lane; k < width; k += kWarp) {
      acc += vals[base + k] * x[cols[base + k]];
    }
    acc = warp_sum(acc);
    T xi = T(0);
    bool upd = false;
    if (lane == 0) {
      const T xt = x[row];
      const T d = diag[row];
      const T w = omega[row];
      const T off = acc + lagc[row] * xlag - d * xt;
      xi = (T(1) - w) * xt + w / d * (b[row] - off);
      upd = mask[row] > T(0);
    }
    // every row of the tile has gathered: now they may be written
    __syncthreads();
    if (upd) x[row] = xi;
    // the next tile gathers the new rows
    __syncthreads();
  }
}

template <typename T>
int launch_tilewalk(const T* vals, const int* cols, int width, int n_pad, int class_size,
                    const T* diag, const T* b, const T* mask, const T* omega,
                    const T* lagc, const T* xlag, T* x, void* stream) {
  if (class_size < 1 || class_size > kMaxClass || n_pad % class_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad > 0) {
    tilewalk_kernel<T><<<1, kWarp * class_size, 0, static_cast<cudaStream_t>(stream)>>>(
        vals, cols, width, n_pad / class_size, class_size, diag, b, mask, omega, lagc,
        xlag, x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One sweep of rows [0, n_pad); x (n_pad rows or more) in place.  seg:
// each row's chain entries (ops/gpu_kernels class_window_tables, for this
// class_size and window); xring: a power of two >= 3 windows.  info (3
// ints, may be null): the ring's slots, the shared bytes, the tiles a slot.
#define MMP_CLASS_ENTRY(NAME, TILEWALK, T)                                         \
  extern "C" int NAME(const T* vals, const int* cols, const int* lens,             \
                      const short* seg, int width, int n_pad, int class_size,      \
                      int window, int xring, const T* diag, const T* b,            \
                      const T* mask, const T* omega, const T* lagc, const T* xlag, \
                      T* x, void* stream, int* info) {                             \
    ClassArgs<T> a;                                                                \
    a.vals = vals;                                                                 \
    a.cols = cols;                                                                 \
    a.lens = lens;                                                                 \
    a.seg = seg;                                                                   \
    a.width = width;                                                               \
    a.n = n_pad;                                                                   \
    a.class_size = class_size;                                                     \
    a.window = window;                                                             \
    a.xmask = xring - 1;                                                           \
    a.diag = diag;                                                                 \
    a.b = b;                                                                       \
    a.mask = mask;                                                                 \
    a.omega = omega;                                                               \
    a.lagc = lagc;                                                                 \
    a.xlag = xlag;                                                                 \
    a.x = x;                                                                       \
    return launch_class_window<T>(a, stream, info);                                \
  }                                                                                \
  extern "C" int TILEWALK(const T* vals, const int* cols, int width, int n_pad,    \
                          int class_size, const T* diag, const T* b,               \
                          const T* mask, const T* omega, const T* lagc,            \
                          const T* xlag, T* x, void* stream) {                     \
    return launch_tilewalk<T>(vals, cols, width, n_pad, class_size, diag, b, mask, \
                              omega, lagc, xlag, x, stream);                       \
  }

MMP_CLASS_ENTRY(mmp_class_sweep_f32, mmp_class_tilewalk_f32, float)
MMP_CLASS_ENTRY(mmp_class_sweep_f64, mmp_class_tilewalk_f64, double)
