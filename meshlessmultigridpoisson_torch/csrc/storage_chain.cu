// storage_chain<T, KT>: one sweep of the storage-order block Gauss-Seidel
// chain in one CTA.
//
// For every 128-row block `blk` of the list `order`, in order:
//     t      = b - A x - lag_col * x_lag          (over the block's rows,
//                                                  reading x as it stands)
//     x_blk += K_blk t                            (128 x 128 product)
// with K_blk the block's one-shot SOR matrix stored transposed
// (kT[blk][c][r] = K_blk[r][c]; rows off the smoothing mask are zero): what
// block_oneshot_sweep.cu's serial path computes (its K product summed in
// the same order, a row's sum in another).  f32, f64, and f32 vectors with
// bf16 K (t rounded to bf16, products exact in f32, as the TPU's fast
// mode).  The list may name a block once only (a sweep's storage order).
//
// Replaces the reference package's
//   meshlessmultigridpoisson_tpu/ops/kernels6.py:515 sor_sweep_tpu6  (role
//     "sweep6": the storage-order levels of `--sweep-order exact` and any
//     level the colored rule refuses that coarse_smooth cannot hold)
//   meshlessmultigridpoisson_tpu/ops/kernels4.py:620 sor_sweep_tpu5  (role
//     "sweep5", probes.ktime)
// The parent design, block_oneshot_sweep.cu run on one CTA, stays as the
// timing-only role "sweep6_chain".
//
// What bounds it on an H100: the chain is serial.  Each block reads x rows
// the previous blocks wrote (kd-tile order puts each block beside its
// predecessor: the block graph's longest path is every block), so its
// bytes (~0.025 ms a sweep of the 133k-row fine level) do not bound it;
// the latency of one link does, times the blocks.  The parent's link was
// ~13 us: the block's K (64 KB in f32) and ELL rows fetched cold from
// device memory on the critical path, each warp walking its 8 rows one
// after another, every row read to the full width.  Here a link's critical
// path holds only the x gather, the row sums, the 128 x 128 product and
// the x write; what does not depend on x comes off it (one thread issues
// every copy, on mbarriers):
//   * K ahead: the next block's K tile is staged into shared memory with
//     cp.async.bulk (1-D TMA) as soon as the product that read the buffer
//     has passed its barrier;
//   * the block's ELL rows (values and columns, full width) are staged
//     into a shared-memory tile the same way, where the tile fits beside
//     the K buffer (f32 and bf16 K up to ~150 entries a row; not f64,
//     whose 128 KB K tile leaves too little; the launcher decides),
//     refilled with the next block's rows as soon as the gather has passed
//     its barrier, so the copy runs during the product;
//   * the values, columns, lens, b, lag_col and K of the block kAhead
//     further on are brought into L2 with cp.async.bulk.prefetch.L2, so
//     those copies (or, without a tile, the gather's row loads) hit L2.
//   On the H100 (PERF.md §6, PR 10) a second K buffer gained nothing (the
//   copy is not on the path), the ELL tile 10-13% a sweep, the L2
//   prefetch 5-10%, and 6 blocks ahead no more than 3;
//   * the next block's lens, b and lag_col are loaded into registers while
//     the current block's product runs, and the block's own x rows (which
//     no earlier block writes) while its gather runs;
//   * the gather issues all 128 rows at once: warp w sums rows w, w + 16,
//     ..., w + 112 together, two 32-entry steps of each in flight (every
//     value and column loaded before any x is gathered), each row
//     read only to lens[r] (one past its last nonzero), each step's lanes
//     starting at the 8-entry boundary below the row's first entry.
// x is cached in L1: one CTA writes and reads it, and its own writes are
// visible to it after __syncthreads(), so the gather reads x with plain
// (L1-allocating) loads, never the non-coherent path.  (colored_smooth,
// whose CTAs read each other's writes, must read x at L2.)
//
// The stale-program sweep (role "sweep7_stale", gpu_kernels.stale_sweep)
// computes the reference's
//   meshlessmultigridpoisson_tpu/ops/kernels6.py:812
//     sor_sweep_tpu7(stale_program=True)  (kernel body :762-809)
// on a storage-order list that starts at a multiple of kGroup: for each
// group of kGroup consecutive blocks (1,024 rows; the reference's MB, its
// segments MB-aligned), every block j of the group computes
//     t = b - A x_g - lag_col * x_lag,   x_blk = x_g,blk + K_blk t
// with x_g x as the group began (the reference's per-program snapshot, no
// scratch write-back), groups in order, the last one possibly partial.
// The fixed point is the exact sweep's; only the contraction rate moves.
// Its kernel is stale_cluster_kernel below: a cluster of kGroup CTAs, the
// group's blocks gathered and multiplied side by side, only the
// group-to-group dependence on the chain.  f32, f64 and bf16 K.
// The first design, the compile-time mode kStale of storage_chain_kernel,
// is kept as the timing role "sweep7_stale_walk" (and as probe_hoist):
// one CTA gathers the group's rows against x as the group began, block
// after block (a block's loads issued after the previous block's row
// sums; rows from device memory, prefetched into L2 a group ahead), then
// runs the group's products one after another on the K buffers (two in
// f32 and bf16 K; one in f64, whose two 128 KB tiles would not fit the
// card's 227 KB of shared memory), a barrier pair a product.

// Timing-only variants (the reference's scripts/ksweepprobe.py:110
// make_sweep_variant; probes/ksweepprobe.py): the kernel is templated on a
// compile-time Mode, and the production entry points instantiate kBase,
// whose code is the same as before the variants existed (checked on the
// SASS: probes/sassloads.py compare).  The sweep probe's "probe_base" is that
// production f32 instance itself, and its "probe_hoist" the kStale f32
// instance (the stale walk above).  The others compute other functions,
// are f32 only, and never reach a solve; each drops one part of a link so
// that the base time minus the variant's is that part's cost:
//   kNoDot     no K product (no K staged or prefetched): x_blk += t
//   kNoGather  no gather and row sum (no ELL rows staged or prefetched):
//              t = b - lag_col * x_lag, then x_blk += K t
// Base minus stale is NOT the link's wait on x: the stale walk has no ELL
// tile (its rows come from L2), gathers the group's blocks one after
// another and runs a barrier pair a product, costs that no mode separates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_sweep_common.cuh"

namespace {

using mmp_sweep::bulk_load;
using mmp_sweep::bulk_prefetch_l2;
using mmp_sweep::k_val;
using mmp_sweep::kBlk;
using mmp_sweep::kSplit;
using mmp_sweep::kThreads;
using mmp_sweep::kWarp;
using mmp_sweep::mbar_expect;
using mmp_sweep::mbar_init;
using mmp_sweep::mbar_wait;
using mmp_sweep::t_in;

constexpr int kWarps = kThreads / kWarp;     // 16
constexpr int kRowsPerWarp = kBlk / kWarps;  // 8 gather rows a warp
constexpr int kSector = 8;  // f32 values / int32 columns a 32-byte sector
constexpr int kSteps = 2;   // 32-entry steps of each row in flight
constexpr int kAhead = 3;   // blocks whose rows and K are prefetched into L2
constexpr int kGroup = 8;   // blocks a kStale group (the reference's MB)

enum ChainMode : int { kBase = 0, kStale = 1, kNoDot = 2, kNoGather = 3 };

template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Shared memory, offsets in bytes: the mbarriers (128 B), the K tile, the
// ELL tile where it is staged (the block's values, then its columns at a
// 128-byte boundary), t, the product's partial sums.  The launcher
// computes it and the kernel reads it at run time: on the H100 the same
// code with the ELL tile at an address fixed at compile time ran the
// sweep slower (PERF.md §6, PR 10).
struct ChainLayout {
  unsigned ebuf, ecols, t, part, total;
};

__host__ __device__ inline unsigned al128(unsigned v) {
  return (v + 127u) & ~127u;
}

template <typename T, typename KT>
__host__ __device__ inline ChainLayout chain_layout(int ne, int width) {
  ChainLayout L;
  L.ebuf = 128u + kBlk * kBlk * sizeof(KT);
  L.ecols = L.ebuf + al128(kBlk * width * sizeof(T));
  L.t = ne ? L.ecols + al128(kBlk * width * sizeof(int)) : L.ebuf;
  L.part = L.t + kBlk * sizeof(T);
  L.total = L.part + kThreads * sizeof(T);
  return L;
}

template <typename T, typename KT>
struct ChainArgs {
  const T* vals;   // [n_pad, width] row-major ELL
  const int* cols;  // global int32 columns
  const int* lens;  // one past each row's last nonzero
  int width;
  const T* b;
  const T* lagc;
  const T* xlag;
  const KT* kT;     // [nb, 128, 128]
  const int* order;  // block ids in execution order
  int nblk;
  int ne;           // 1: the block's ELL rows staged in a shared tile
  ChainLayout L;
  T* x;             // read and written: no __restrict__
};

// the 16-byte-aligned span around [p, p + bytes) into L2 (a hint)
__device__ __forceinline__ void prefetch_span(const void* p, size_t bytes) {
  const uint64_t lo = reinterpret_cast<uint64_t>(p) & ~uint64_t(15);
  const uint64_t hi = (reinterpret_cast<uint64_t>(p) + bytes + 15) & ~uint64_t(15);
  bulk_prefetch_l2(reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo));
}

// Bring block blk's rows (values, columns, lens, b, lag_col) and K into L2
// (what the mode reads of them).
template <int Mode, typename T, typename KT>
__device__ __forceinline__ void prefetch_block(const ChainArgs<T, KT>& a,
                                               int blk) {
  const size_t e0 = static_cast<size_t>(blk) * kBlk * a.width;
  const size_t r0 = static_cast<size_t>(blk) * kBlk;
  if constexpr (Mode != kNoGather) {
    prefetch_span(a.vals + e0, kBlk * a.width * sizeof(T));
    prefetch_span(a.cols + e0, kBlk * a.width * sizeof(int));
    prefetch_span(a.lens + r0, kBlk * sizeof(int));
  }
  prefetch_span(a.b + r0, kBlk * sizeof(T));
  prefetch_span(a.lagc + r0, kBlk * sizeof(T));
  if constexpr (Mode != kNoDot) {
    prefetch_span(a.kT + r0 * kBlk, kBlk * kBlk * sizeof(KT));
  }
}

template <typename T, typename KT>
__device__ __forceinline__ void load_k(const ChainArgs<T, KT>& a,
                                       unsigned char* kbuf, uint64_t* kbar,
                                       int blk) {
  constexpr uint32_t ktile = kBlk * kBlk * sizeof(KT);
  // generic-proxy reads of this buffer are done (a barrier passed)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(kbar, ktile);
  bulk_load(kbuf, a.kT + static_cast<size_t>(blk) * kBlk * kBlk, ktile, kbar);
}

// block blk's ELL rows (values and columns, full width) into the ELL tile
template <typename T, typename KT>
__device__ __forceinline__ void load_e(const ChainArgs<T, KT>& a,
                                       unsigned char* smem, uint64_t* ebar,
                                       int blk) {
  const size_t e0 = static_cast<size_t>(blk) * kBlk * a.width;
  const uint32_t vb = kBlk * a.width * sizeof(T), cb = kBlk * a.width * sizeof(int);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(ebar, vb + cb);
  bulk_load(smem + a.L.ebuf, a.vals + e0, vb, ebar);
  bulk_load(smem + a.L.ecols, a.cols + e0, cb, ebar);
}

// acc[q] = (A x) of row erow0 + w + 16 q of the table (vals, cols) for
// warp w, the row's length in lane q's `len` (entry offsets: the wrapper
// keeps n_pad * width below 2^31).  Every (row, step) slot's value and
// column first, Steps 32-entry steps a row at a time, then the gathers; x
// read with plain (L1) loads, or at L2 (ld.global.cg) where other CTAs
// write it (kL2).
template <typename T, int Steps = kSteps, bool kL2 = false>
__device__ __forceinline__ void gather_rows(const T* vals, const int* cols,
                                            int erow0, int width, int len,
                                            const T* x, T (&acc)[kRowsPerWarp]) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int beg[kRowsPerWarp], end[kRowsPerWarp];
  int n = 0;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int lq_len = __shfl_sync(0xffffffffu, len, q);
    beg[q] = (erow0 + warp + q * kWarps) * width;
    end[q] = beg[q] + lq_len;
    const int start = beg[q] & ~(kSector - 1);
    n = max(n, lq_len > 0 ? (end[q] - start + kWarp - 1) / kWarp : 0);
    acc[q] = T(0);
  }
  for (int s = 0; s < n; s += Steps) {
    int c[kRowsPerWarp][Steps];
    T v[kRowsPerWarp][Steps];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
      for (int t = 0; t < Steps; ++t) {
        const int e = (beg[q] & ~(kSector - 1)) + (s + t) * kWarp + lane;
        const bool in = e >= beg[q] && e < end[q];
        c[q][t] = in ? cols[e] : -1;
        v[q][t] = in ? vals[e] : T(0);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
      for (int t = 0; t < Steps; ++t) {
        if constexpr (kL2) {
          if (c[q][t] >= 0) acc[q] += v[q][t] * __ldcg(x + c[q][t]);
        } else {
          if (c[q][t] >= 0) acc[q] += v[q][t] * x[c[q][t]];
        }
      }
    }
  }
}

// lane q < 8 of warp w: the x-independent data of row w + 16 q of block blk
template <typename T, typename KT>
__device__ __forceinline__ void load_rows(const ChainArgs<T, KT>& a, int blk,
                                          T xl, int& len, T& bq, T& lq) {
  const int lane = threadIdx.x % kWarp;
  if (lane < kRowsPerWarp) {
    const int r = blk * kBlk + threadIdx.x / kWarp + lane * kWarps;
    len = a.lens[r];
    bq = a.b[r];
    lq = a.lagc[r] * xl;
  }
}

// K tile buffers of the stale walk: two where they fit beside t and the
// partial sums (f32, bf16 K), one in f64
template <typename KT>
__host__ __device__ constexpr int stale_kbufs() {
  return sizeof(KT) > 4 ? 1 : 2;
}

// kStale: groups of kGroup blocks, each gathered whole against x as the
// group began, then its products; K on stale_kbufs() buffers (the K tile's
// barrier and the unused ELL barrier), block j's in buffer j % nk; t of the
// whole group at L.t.
template <typename T, typename KT>
__device__ __forceinline__ void stale_walk(const ChainArgs<T, KT>& a,
                                           unsigned char* smem) {
  constexpr uint32_t ktile = kBlk * kBlk * sizeof(KT);
  constexpr int nk = stale_kbufs<KT>();
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem);
  T* t_s = reinterpret_cast<T*>(smem + a.L.t);
  T* part = reinterpret_cast<T*>(smem + a.L.part);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = threadIdx.x % kBlk;
  const int h = threadIdx.x / kBlk;
  const T xl = *a.xlag;
  if (threadIdx.x == 0) {
    mbar_init(kbar);
    mbar_init(kbar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < nk && s < a.nblk; ++s) {
      load_k(a, smem + 128 + s * ktile, kbar + s, a.order[s]);
    }
    for (int d = 0; d < 2 * kGroup && d < a.nblk; ++d) {
      prefetch_block<kStale>(a, a.order[d]);
    }
  }
  __syncthreads();
  for (int g = 0; g < a.nblk; g += kGroup) {
    const int gsize = min(kGroup, a.nblk - g);
    if (threadIdx.x == 0) {  // the group after next into L2
      for (int d = g + 2 * kGroup; d < g + 3 * kGroup && d < a.nblk; ++d) {
        prefetch_block<kStale>(a, a.order[d]);
      }
    }
    // every row of the group gathers from x as it stands now
    for (int jj = 0; jj < gsize; ++jj) {
      const int blk = a.order[g + jj];
      int len = 0;
      T bq = T(0), lq = T(0);
      load_rows(a, blk, xl, len, bq, lq);
      T acc[kRowsPerWarp];
      gather_rows<T>(a.vals, a.cols, blk * kBlk, a.width, len, a.x, acc);
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const T sum = warp_allsum(acc[q]);
        const T bqq = __shfl_sync(0xffffffffu, bq, q);
        const T lqq = __shfl_sync(0xffffffffu, lq, q);
        if (lane == q) {
          t_s[jj * kBlk + warp + q * kWarps] = t_in<T, KT>(bqq - sum - lqq);
        }
      }
    }
    __syncthreads();
    // the group's products: x_blk += K_blk t_blk (no block of the group
    // writes another's rows, so x_blk is still the group's start value)
    for (int jj = 0; jj < gsize; ++jj) {
      const unsigned j = g + jj;
      const int s = j % nk;
      const int row0 = a.order[j] * kBlk;
      const T xo = h == 0 ? a.x[row0 + r] : T(0);
      mbar_wait(kbar + s, (j / nk) & 1);
      const KT* kb = reinterpret_cast<const KT*>(smem + 128 + s * ktile);
      const T* tb = t_s + jj * kBlk;
      T dx = T(0);
#pragma unroll 8
      for (int c = h * (kBlk / kSplit); c < (h + 1) * (kBlk / kSplit); ++c) {
        dx += k_val(kb[c * kBlk + r]) * tb[c];
      }
      part[threadIdx.x] = dx;
      __syncthreads();
      if (h == 0) {
        T sum = T(0);
        for (int q = 0; q < kSplit; ++q) sum += part[r + q * kBlk];
        a.x[row0 + r] = xo + sum;
      }
      __syncthreads();  // buffer s and part are free
      if (threadIdx.x == 0 && j + nk < static_cast<unsigned>(a.nblk)) {
        load_k(a, smem + 128 + s * ktile, kbar + s, a.order[j + nk]);
      }
    }
  }
}

template <typename T, typename KT, int Mode>
__global__ void __launch_bounds__(kThreads, 1)
    storage_chain_kernel(const ChainArgs<T, KT> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (Mode == kStale) {
    stale_walk(a, smem);
  } else {
    uint64_t* kbar = reinterpret_cast<uint64_t*>(smem);
    uint64_t* ebar = kbar + 1;
    unsigned char* kbuf = smem + 128;
    T* t_s = reinterpret_cast<T*>(smem + a.L.t);
    T* part = reinterpret_cast<T*>(smem + a.L.part);
    const T* tile_v = reinterpret_cast<const T*>(smem + a.L.ebuf);
    const int* tile_c = reinterpret_cast<const int*>(smem + a.L.ecols);
    const int warp = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    const T xl = *a.xlag;

    if (threadIdx.x == 0) {
      mbar_init(kbar);
      mbar_init(ebar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if constexpr (Mode != kNoDot) load_k(a, kbuf, kbar, a.order[0]);
      if (a.ne) load_e(a, smem, ebar, a.order[0]);
      for (int d = 0; d < kAhead && d < a.nblk; ++d) prefetch_block<Mode>(a, a.order[d]);
    }
    __syncthreads();

    int len = 0;
    T bq = T(0), lq = T(0);
    int blk = a.order[0];
    load_rows(a, blk, xl, len, bq, lq);
    for (int j = 0; j < a.nblk; ++j) {
      const int row0 = blk * kBlk;
      if (threadIdx.x == 0 && j + kAhead < a.nblk) {
        prefetch_block<Mode>(a, a.order[j + kAhead]);
      }
      // the own rows' x: no earlier block of the list writes them
      const int r = threadIdx.x % kBlk;
      const int h = threadIdx.x / kBlk;
      const T xo = h == 0 ? a.x[row0 + r] : T(0);

      // t = b - A x - lag_col * x_lag: warp w's rows w + 16 q, all at once,
      // from the ELL tile (ne = 1) or device memory
      T acc[kRowsPerWarp];
      if constexpr (Mode != kNoGather) {
        if (a.ne) {
          mbar_wait(ebar, j & 1);
          gather_rows<T>(tile_v, tile_c, 0, a.width, len, a.x, acc);
        } else {
          gather_rows<T>(a.vals, a.cols, row0, a.width, len, a.x, acc);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        T sum = T(0);
        if constexpr (Mode != kNoGather) sum = warp_allsum(acc[q]);
        const T bqq = __shfl_sync(0xffffffffu, bq, q);
        const T lqq = __shfl_sync(0xffffffffu, lq, q);
        if (lane == q) t_s[warp + q * kWarps] = t_in<T, KT>(bqq - sum - lqq);
      }
      __syncthreads();  // t complete, the ELL tile free

      // the next block's id, rows and x-independent row data, in flight
      // during the product
      const int next = j + 1 < a.nblk ? a.order[j + 1] : 0;
      if (j + 1 < a.nblk) {
        if (a.ne && threadIdx.x == 0) load_e(a, smem, ebar, next);
        load_rows(a, next, xl, len, bq, lq);
      }

      if constexpr (Mode == kNoDot) {
        if (h == 0) a.x[row0 + r] = xo + t_s[r];
      } else {
        // x_blk += K_blk t: thread (h, r) sums inputs [h, h + 1) * 128 / 4 of
        // output row r; thread (0, r) adds the 4 partial sums
        mbar_wait(kbar, j & 1);
        const KT* kb = reinterpret_cast<const KT*>(kbuf);
        T dx = T(0);
#pragma unroll 8
        for (int c = h * (kBlk / kSplit); c < (h + 1) * (kBlk / kSplit); ++c) {
          dx += k_val(kb[c * kBlk + r]) * t_s[c];
        }
        part[threadIdx.x] = dx;
        __syncthreads();
        if (h == 0) {
          T s = T(0);
          for (int q = 0; q < kSplit; ++q) s += part[r + q * kBlk];
          a.x[row0 + r] = xo + s;
        }
      }
      // the next block reads the new rows; the K buffer and t are free
      __syncthreads();
      if constexpr (Mode != kNoDot) {
        if (threadIdx.x == 0 && j + 1 < a.nblk) load_k(a, kbuf, kbar, next);
      }
      blk = next;
    }
  }
}

// ---- the stale-program sweep on a cluster (role "sweep7_stale") -----------
//
// One cluster of kGroup CTAs; CTA j owns block j of every group.  A group
// costs one gather round, one product and two cluster barriers, whatever
// its number of blocks: CTA j gathers its block's 128 rows against x at
// L2 (other CTAs write x: ld.global.cg, never L1 or the non-coherent
// path), computes t and x_blk + K_blk t into registers, then
//   barrier.cluster (arrive after the gather, wait after the product): no
//     CTA writes a row of the group before every CTA has read x for it;
//   writes its rows;
//   barrier.cluster: the group's rows are at L2 before the next gather.
// What does not depend on x comes off that path: thread 0 of each CTA
// streams its block's K tiles on a ring of nk buffers (cp.async.bulk on
// mbarriers, nk groups ahead) and prefetches its block's rows kStaleAhead
// groups further on into L2; the next block's lens, b, lag_col and own x
// rows are loaded into registers during the product.  The rows are
// gathered from L2, never staged in shared memory.  The launcher takes
// nk = 2 where two K tiles fit the card's shared memory (f32 and bf16 K),
// else 1 (f64: one 128 KB tile).
constexpr int kStaleSteps = 3;  // 32-entry steps of each row in flight
constexpr int kStaleAhead = 2;  // groups whose own block is prefetched into L2

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, typename KT>
__global__ void __cluster_dims__(kGroup, 1, 1) __launch_bounds__(kThreads, 1)
    stale_cluster_kernel(const ChainArgs<T, KT> a, const int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t ktile = kBlk * kBlk * sizeof(KT);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem);  // the K ring's
  T* t_s = reinterpret_cast<T*>(smem + a.L.t);
  T* part = reinterpret_cast<T*>(smem + a.L.part);
  const int j = blockIdx.x;  // the grid is one cluster: j is the CTA's rank
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = threadIdx.x % kBlk;
  const int h = threadIdx.x / kBlk;
  const int ngroups = (a.nblk + kGroup - 1) / kGroup;
  const int mine = (a.nblk - j + kGroup - 1) / kGroup;  // groups with a block j
  const T xl = *a.xlag;
  auto blk_of = [&](int gi) { return a.order[gi * kGroup + j]; };
  auto kbuf = [&](int s) { return smem + 128 + s * ktile; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < nk; ++s) mbar_init(kbar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < nk && s < mine; ++s) load_k(a, kbuf(s), kbar + s, blk_of(s));
    for (int d = 0; d <= kStaleAhead && d < mine; ++d) {
      prefetch_block<kBase>(a, blk_of(d));
    }
  }
  __syncthreads();

  int len = 0;
  T bq = T(0), lq = T(0), xo = T(0);
  if (mine > 0) {
    load_rows(a, blk_of(0), xl, len, bq, lq);
    if (h == 0) xo = __ldcg(a.x + blk_of(0) * kBlk + r);
  }
  for (int gi = 0; gi < ngroups; ++gi) {
    const bool own = gi < mine;
    const int row0 = own ? blk_of(gi) * kBlk : 0;
    if (own) {
      if (threadIdx.x == 0 && gi + kStaleAhead + 1 < mine) {
        prefetch_block<kBase>(a, blk_of(gi + kStaleAhead + 1));
      }
      // t = b - A x_g - lag_col * x_lag: warp w's rows w + 16 q, all at once
      T acc[kRowsPerWarp];
      gather_rows<T, kStaleSteps, true>(a.vals, a.cols, row0, a.width, len, a.x, acc);
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const T sum = warp_allsum(acc[q]);
        const T bqq = __shfl_sync(0xffffffffu, bq, q);
        const T lqq = __shfl_sync(0xffffffffu, lq, q);
        if (lane == q) t_s[warp + q * kWarps] = t_in<T, KT>(bqq - sum - lqq);
      }
      __syncthreads();  // t complete
    }
    cluster_arrive();  // this CTA has read x for the group
    T xn = T(0);
    if (own) {
      T xo_next = T(0);
      if (gi + 1 < mine) {
        load_rows(a, blk_of(gi + 1), xl, len, bq, lq);
        if (h == 0) xo_next = __ldcg(a.x + blk_of(gi + 1) * kBlk + r);
      }
      // x_blk + K_blk t: thread (h, r) sums inputs [h, h + 1) * 128 / 4 of
      // output row r; thread (0, r) adds the 4 partial sums
      const int s = gi % nk;
      mbar_wait(kbar + s, (gi / nk) & 1);
      const KT* kb = reinterpret_cast<const KT*>(kbuf(s));
      T dx = T(0);
#pragma unroll 8
      for (int c = h * (kBlk / kSplit); c < (h + 1) * (kBlk / kSplit); ++c) {
        dx += k_val(kb[c * kBlk + r]) * t_s[c];
      }
      part[threadIdx.x] = dx;
      __syncthreads();
      if (h == 0) {
        T sum = T(0);
        for (int q = 0; q < kSplit; ++q) sum += part[r + q * kBlk];
        xn = xo + sum;
      }
      xo = xo_next;
      __syncthreads();  // K buffer s, t and part are free
      if (threadIdx.x == 0 && gi + nk < mine) load_k(a, kbuf(s), kbar + s, blk_of(gi + nk));
    }
    cluster_wait();  // every CTA has read x for the group
    if (own && h == 0) a.x[row0 + r] = xn;
    cluster_arrive();  // the group's rows written
    cluster_wait();
  }
}

// The stale cluster's layout: its nk K tiles, then t of its block, then
// the partial sums
template <typename T, typename KT>
ChainLayout stale_cluster_layout(int nk) {
  ChainLayout L;
  L.ebuf = L.ecols = 0;  // no ELL tile
  L.t = 128u + nk * kBlk * kBlk * sizeof(KT);
  L.part = L.t + kBlk * sizeof(T);
  L.total = L.part + kThreads * sizeof(T);
  return L;
}

// kStale's layout: its K tiles, then t of a group, then the partial sums
template <typename T, typename KT>
ChainLayout stale_layout() {
  ChainLayout L;
  L.ebuf = L.ecols = 0;  // no ELL tile
  L.t = 128u + stale_kbufs<KT>() * kBlk * kBlk * sizeof(KT);
  L.part = L.t + kGroup * kBlk * sizeof(T);
  L.total = L.part + kThreads * sizeof(T);
  return L;
}

// The ELL tile is taken where it fits beside the K tile in the card's
// shared memory (f32 and bf16 K at the slice's widths, not f64), and where
// the mode gathers one block at a time.
template <typename T, typename KT, int Mode = kBase>
int launch_chain(ChainArgs<T, KT> a, void* stream, int* info) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (Mode == kStale || Mode == kNoGather) {
    a.ne = 0;
  } else {
    a.ne = chain_layout<T, KT>(1, a.width).total <= static_cast<unsigned>(optin) ? 1 : 0;
  }
  a.L = Mode == kStale ? stale_layout<T, KT>() : chain_layout<T, KT>(a.ne, a.width);
  const unsigned bytes = a.L.total;
  if (bytes > static_cast<unsigned>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  if (info != nullptr) {
    info[0] = a.ne;
    info[1] = static_cast<int>(bytes);
  }
  if (a.nblk < 1) return static_cast<int>(cudaSuccess);
  auto kern = storage_chain_kernel<T, KT, Mode>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT, int Mode = kBase>
int chain_entry(const T* vals, const int* cols, const int* lens, int width,
                const T* b, const T* lagc, const T* xlag, const KT* kT,
                const int* order, int nblk, T* x, void* stream, int* info) {
  ChainArgs<T, KT> a;
  a.vals = vals;
  a.cols = cols;
  a.lens = lens;
  a.width = width;
  a.b = b;
  a.lagc = lagc;
  a.xlag = xlag;
  a.kT = kT;
  a.order = order;
  a.nblk = nblk;
  a.ne = 0;
  a.x = x;
  return launch_chain<T, KT, Mode>(a, stream, info);
}

// The stale cluster's nk: 2 where two K tiles fit the card's shared
// memory, else 1.
template <typename T, typename KT>
int stale_cluster_entry(const T* vals, const int* cols, const int* lens, int width,
                        const T* b, const T* lagc, const T* xlag, const KT* kT,
                        const int* order, int nblk, T* x, void* stream, int* info) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  ChainArgs<T, KT> a;
  a.vals = vals;
  a.cols = cols;
  a.lens = lens;
  a.width = width;
  a.b = b;
  a.lagc = lagc;
  a.xlag = xlag;
  a.kT = kT;
  a.order = order;
  a.nblk = nblk;
  a.ne = 0;
  a.x = x;
  const int nk =
      stale_cluster_layout<T, KT>(2).total <= static_cast<unsigned>(optin) ? 2 : 1;
  a.L = stale_cluster_layout<T, KT>(nk);
  if (a.L.total > static_cast<unsigned>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  if (info != nullptr) {
    info[0] = nk;
    info[1] = static_cast<int>(a.L.total);
  }
  if (nblk < 1) return static_cast<int>(cudaSuccess);
  auto kern = stale_cluster_kernel<T, KT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(a.L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<kGroup, kThreads, a.L.total, static_cast<cudaStream_t>(stream)>>>(a, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One storage-order sweep over the nblk blocks of order; x in place.
// info (2 ints, may be null): 1 if the ELL rows were staged in a shared
// tile, else 0; the shared bytes.  kT (and, for an ELL tile, vals and
// cols) 16-byte aligned (the bulk copies).
#define MMP_CHAIN_ENTRY(NAME, T, KT)                                       \
  extern "C" int NAME(const T* vals, const int* cols, const int* lens,     \
                      int width, const T* b, const T* lagc, const T* xlag, \
                      const KT* kT, const int* order, int nblk, T* x,      \
                      void* stream, int* info) {                           \
    return chain_entry<T, KT>(vals, cols, lens, width, b, lagc, xlag, kT,  \
                              order, nblk, x, stream, info);               \
  }

MMP_CHAIN_ENTRY(mmp_storage_chain_f32, float, float)
MMP_CHAIN_ENTRY(mmp_storage_chain_f64, double, double)
MMP_CHAIN_ENTRY(mmp_storage_chain_f32_bf16k, float, __nv_bfloat16)

// One stale-program sweep by the walk (kStale; role "sweep7_stale_walk")
// over the nblk blocks of order, groups of kGroup consecutive entries; x in
// place; info as above (no ELL tile).  The
// caller passes a storage-order list starting at a multiple of kGroup
// (gpu_kernels.stale_sweep checks it).
#define MMP_STALE_ENTRY(NAME, T, KT)                                         \
  extern "C" int NAME(const T* vals, const int* cols, const int* lens,       \
                      int width, const T* b, const T* lagc, const T* xlag,   \
                      const KT* kT, const int* order, int nblk, T* x,        \
                      void* stream, int* info) {                             \
    return chain_entry<T, KT, kStale>(vals, cols, lens, width, b, lagc, xlag, \
                                      kT, order, nblk, x, stream, info);     \
  }

MMP_STALE_ENTRY(mmp_storage_chain_stale_f32, float, float)
MMP_STALE_ENTRY(mmp_storage_chain_stale_f64, double, double)
MMP_STALE_ENTRY(mmp_storage_chain_stale_f32_bf16k, float, __nv_bfloat16)

// One stale-program sweep on a cluster of kGroup CTAs (role "sweep7_stale";
// the walk above is the timing role "sweep7_stale_walk"); the list and x as
// above; info (2 ints, may be null): the K tiles a CTA holds; its shared
// bytes.  kT 16-byte aligned (the bulk copies).
#define MMP_STALE_CLUSTER_ENTRY(NAME, T, KT)                                  \
  extern "C" int NAME(const T* vals, const int* cols, const int* lens,       \
                      int width, const T* b, const T* lagc, const T* xlag,   \
                      const KT* kT, const int* order, int nblk, T* x,        \
                      void* stream, int* info) {                             \
    return stale_cluster_entry<T, KT>(vals, cols, lens, width, b, lagc, xlag, \
                                      kT, order, nblk, x, stream, info);     \
  }

MMP_STALE_CLUSTER_ENTRY(mmp_stale_cluster_f32, float, float)
MMP_STALE_CLUSTER_ENTRY(mmp_stale_cluster_f64, double, double)
MMP_STALE_CLUSTER_ENTRY(mmp_stale_cluster_f32_bf16k, float, __nv_bfloat16)

// The sweep probe's modes (f32, one CTA, storage order; mode a ChainMode):
// kBase is the production f32 instance above, kStale the stale walk's f32
// instance.  Returns
// cudaErrorInvalidValue for an unknown mode.
extern "C" int mmp_chain_probe_f32(const float* vals, const int* cols,
                                   const int* lens, int width, const float* b,
                                   const float* lagc, const float* xlag,
                                   const float* kT, const int* order, int nblk,
                                   int mode, float* x, void* stream, int* info) {
  switch (mode) {
    case kBase:
      return chain_entry<float, float, kBase>(vals, cols, lens, width, b, lagc,
                                              xlag, kT, order, nblk, x, stream,
                                              info);
    case kStale:
      return chain_entry<float, float, kStale>(vals, cols, lens, width, b,
                                               lagc, xlag, kT, order, nblk, x,
                                               stream, info);
    case kNoDot:
      return chain_entry<float, float, kNoDot>(vals, cols, lens, width, b,
                                               lagc, xlag, kT, order, nblk, x,
                                               stream, info);
    case kNoGather:
      return chain_entry<float, float, kNoGather>(vals, cols, lens, width, b,
                                                  lagc, xlag, kT, order, nblk,
                                                  x, stream, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
