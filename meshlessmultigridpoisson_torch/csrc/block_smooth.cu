// block_smooth<T, KT>: one smoother call of the multigrid V-cycle in ONE
// launch: `iters` repetitions of
//   1. the block Gauss-Seidel sweep, block by block in the sweep's order:
//        t      = b - A x - lag_col * x_lag     (the block's 128 rows)
//        x_blk += K_blk t                       (128 x 128 product)
//      with K_blk the block's one-shot SOR matrix stored transposed
//      (kT[blk][c][r] = K_blk[r][c]; rows off the smoothing mask are zero);
//   2. if the level has a Lagrange border, its relax
//        x_lag = (1 - omega) x_lag + omega (b_lag - lag_row . x);
//   3. if the level has Neumann boundary rows, their re-solve in place
//        x[r] = (b[r] - (C x - d x[r])) / d     (compact_rows mode 0; legal
//      in place because no boundary row reads another one: the repack's
//      check_resolve_in_place), each row read to its lens.
// This is the reference's tpu_backend.smooth scan
// (meshlessmultigridpoisson_tpu/mg/tpu_backend.py:341-379) with its sweep
// kernel inside; the math is block_oneshot_sweep.cu's and compact_rows.cu's,
// summed in the same order.
//
// The V-cycle's own re-solves of the fine level run in the same launch:
//   * resolve_first: before the first sweep, the re-solve of the boundary
//     rows from x as the launch got it (x_in), then the Dirichlet pin
//     x = dvals where dmask > 0 (the V-cycle's start, mg/vcycle.py: the
//     reference's re-solve, then apply_dirichlet, then the smoother).  The
//     re-solve reads x_in only and writes the pinned output, and the copy
//     of x_in into the output pins every row: a grid barrier after each;
//   * resolve_last: after the last sweep's re-solve, one more (the
//     preconditioner's, mg/krylov.py _precond).  Each warp re-solves the
//     rows it re-solved last, whose only x written since the last grid
//     barrier is their own target, written by the same warp: a warp
//     barrier orders them.
// The pin (dmask, dvals) belongs to resolve_first: the pointers are given
// exactly when it is set (the launcher refuses anything else).
//
// Two kernels, both templated on (T, KT): f32, f64, and f32 vectors with
// bf16 K (t rounded to bf16, products exact in f32, as the TPU's fast mode).
//
// colored_smooth (role "sweep8") replaces
//   meshlessmultigridpoisson_tpu/ops/kernels8.py:428 sor_sweep_tpu8: the
//   colored block order of the fine levels.  One persistent cooperative
//   launch (cudaLaunchCooperativeKernel): grid = min(largest color's
//   blocks, CTAs resident at once); CTA i takes blocks i, i + grid, ... of
//   each color, with a grid barrier (cooperative_groups this_grid().sync())
//   between colors.  Each block first copies the 128-row x patches it
//   reads (its own and its neighbours') into shared memory with coalesced
//   loads, then gathers from there through int16 local columns (patch
//   slot * 128 + row in the patch), as the TPU's kernels6 tables do: x
//   changes within the launch, so the gather cannot read it through L1,
//   and scattered 4-byte loads from L2 were the larger part of a
//   fine-level block's time.  The Lagrange dot: each CTA sums lag_row *
//   x_new over the rows it writes (every row is written once a sweep, by
//   the CTA that owns its block) and stores the partial in a scratch
//   vector (double-buffered by sweep parity); after the color's barrier
//   every CTA adds the partials in the same fixed order, so all CTAs hold
//   the same x_lag and a rerun gives the same bits (no float atomics).
//   The re-solve rows are spread over the CTAs' warps, then a grid
//   barrier.  x written by other CTAs in this launch is read past the
//   non-coherent L1 (__ldcg), never __ldg.
//
// coarse_smooth (role "sweep7") replaces
//   meshlessmultigridpoisson_tpu/ops/kernels6.py:812 sor_sweep_tpu7: the
//   storage-order chain of the coarsest level.  One CTA holds x, b, the
//   Lagrange column and row, and the boundary rows' targets and diagonals in
//   shared memory for the whole call (the TPU kernel keeps x whole in VMEM
//   for the same reason), walks the blocks in order `iters` times with the
//   relax and re-solve on the shared copy, and writes x and x_lag back once.
//   Shared-memory limit: one K tile, four level vectors, the boundary rows'
//   targets and diagonals and the fixed scratch must fit the card's opt-in
//   shared memory (227 KB on an H100): n_pad <= 10,240 rows in f32,
//   2,944 in f64 (ops/gpu_kernels.smooth_smem_bytes mirrors make_layout,
//   coarse_smooth_fits applies it; a level over it runs role "sweep6",
//   the chain of block_oneshot_sweep.cu, by the repack's rule).  The boundary rows'
//   values and columns stay in device memory.
//
// Hopper staging, both kernels.  K and the ELL rows do not depend on x.
// One thread copies each block's K tile (64 KB f32, 32 KB bf16, 128 KB f64)
// and, where it fits, its ELL values and columns into shared memory with
// cp.async.bulk (1-D TMA), completing on an mbarrier, ahead of the block:
// a ring of nk K buffers and ne ELL buffers (nk in {1, 2}, ne in {0, 1, 2};
// the launcher takes the first of (2,2), (2,1), (1,1), (2,0), (1,0) that
// fits).  The ELL buffer of block j is refilled with block j + ne's rows as
// soon as block j's gather has passed its barrier (during the product and
// the colored kernel's grid barrier); the K buffer of block j with block
// j + nk's tile as soon as the product has passed its barrier.  After a
// grid barrier only the x patches' copy and the gather lie on the
// dependent path.
//
// What bounds it on an H100.  The colored sweep of the 133k-row fine level
// moves ~68 MB of K a sweep (bound ~0.025 ms), but the parent design spent
// 7-18 us of device time and ~15 us of host time on each of its 13-20
// launches a sweep (PERF.md): latency, not bytes.  Here a smoother call is
// one launch; a color costs a grid barrier plus a shared-memory-fed chain
// (~9 us a color on that level, PERF.md: far above its bytes still).
// The coarse chain (20 blocks) was 5.9 us a block of dependent device-memory
// loads; here its gather reads shared memory only.  Per block the loads
// that wait for nothing but the block id (b, lag_col, the own rows' x and
// lag_row) are issued first, and the gather keeps two 32-entry chunks of
// each of a warp's 8 rows in flight.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "block_sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mmp_sweep::bulk_load;
using mmp_sweep::k_val;
using mmp_sweep::kBlk;
using mmp_sweep::kSplit;
using mmp_sweep::kThreads;
using mmp_sweep::kWarp;
using mmp_sweep::mbar_expect;
using mmp_sweep::mbar_init;
using mmp_sweep::mbar_wait;
using mmp_sweep::t_in;
using mmp_sweep::warp_sum;

constexpr int kWarps = kThreads / kWarp;         // 16
constexpr int kRowsPerWarp = kBlk / kWarps;      // 8 gather rows a warp
constexpr int kResolveBatch = 4;  // boundary rows a warp sums at once
constexpr int kBars = 4;          // mbarriers: 2 K buffers, 2 ELL buffers

template <typename T, typename KT>
struct SmoothArgs {
  const T* vals;  // [n_pad, width] level matrix, row-major ELL
  const int* cols;   // global columns (coarse_smooth)
  // colored_smooth's x patches: block b reads x rows pids[b][s] * 128 + l
  // for its npid[b] slots s; lcols[row][k] = s * 128 + l (int16)
  const short* lcols;
  const int* pids;   // [nb, npmax]
  const int* npid;   // [nb]
  int npmax;
  int width;
  int n_pad;
  const T* b;
  const T* lagc;   // Lagrange column
  const KT* kT;    // [nb, 128, 128]
  const int* order;  // block ids in execution order
  const int* ptr;    // [nphases + 1] phase (color) offsets into order
  int nphases;
  int iters;
  T omega;
  const T* lagr;   // Lagrange row; nullptr: no relax
  const T* blag;   // Lagrange right-hand side (read when lagr is set)
  const T* xlag_in;
  T* xlag_out;     // nullptr: not written
  const T* bvals;  // boundary rows (compact ELL, global columns)
  const int* bcols;
  const int* blens;  // one past each boundary row's last nonzero
  const int* brows;  // target rows; >= n_pad: padding slot
  const T* bdiag;
  int bwidth;
  int bnrows;      // 0: no re-solve
  const T* dmask;  // the pin: x = dvals where dmask > 0 before the first
  const T* dvals;  //   sweep; given exactly when resolve_first is set
  int resolve_first;  // re-solve the boundary rows before the first sweep
  int resolve_last;   // and once more after the last
  const T* x_in;   // == x: in place
  T* x;
  T* partials;     // [2 * grid] colored kernel's Lagrange partials
  int nk, ne;      // K and ELL buffers
};

// Shared-memory layout (bytes), the same on host and device: the mbarriers,
// nk K tiles, ne ELL tiles (values, then columns of cbytes each), the
// colored kernel's x patches (npx values), t, the product's partial sums,
// the reduction scratch, then the coarse kernel's four level vectors and
// the boundary rows' diagonals and targets.  Regions are 128-aligned.
struct Layout {
  unsigned ktile, kbuf, evals, etile, ebuf, xp, t, part, red, vec, bdiag,
      brow, total;
};

__host__ __device__ inline unsigned al128(unsigned v) {
  return (v + 127u) & ~127u;
}

template <typename T, typename KT>
__host__ __device__ inline Layout make_layout(int nk, int ne, int width,
                                              int cbytes, int npx, int n_vec,
                                              int m) {
  Layout L;
  unsigned off = 128;  // kBars mbarriers
  L.ktile = kBlk * kBlk * sizeof(KT);
  L.kbuf = off;
  off += nk * L.ktile;
  L.evals = kBlk * width * sizeof(T);
  L.etile = al128(L.evals + kBlk * width * cbytes);
  L.ebuf = off;
  off += ne * L.etile;
  L.xp = off;
  off += al128(npx * sizeof(T));
  L.t = off;
  off += al128(kBlk * sizeof(T));
  L.part = off;
  off += al128(kThreads * sizeof(T));
  L.red = off;
  off += al128((kWarps + 1) * sizeof(T));
  L.vec = off;
  off += al128(4u * n_vec * sizeof(T));
  L.bdiag = off;
  off += al128(m * sizeof(T));
  L.brow = off;
  off += al128(m * sizeof(int));
  L.total = off;
  return L;
}

// ---- the walk: a CTA's blocks, colors in order, `iters` sweeps ------------

struct Cursor {
  int it, c, i;  // sweep, phase, index within the phase
};

template <typename T, typename KT>
__device__ __forceinline__ void settle(Cursor& q, const SmoothArgs<T, KT>& a) {
  while (q.it < a.iters && q.i >= a.ptr[q.c + 1] - a.ptr[q.c]) {
    q.i = blockIdx.x;
    if (++q.c == a.nphases) {
      q.c = 0;
      ++q.it;
    }
  }
}

template <typename T, typename KT>
__device__ __forceinline__ void advance(Cursor& q, const SmoothArgs<T, KT>& a) {
  q.i += gridDim.x;
  settle(q, a);
}

// The staging ring; thread 0 issues every copy.  Slot s of the K (ELL) ring
// completes on kbar[s] (ebar[s]); a buffer's u-th fill completes the
// barrier's phase of parity u & 1.
template <typename T, typename KT>
struct Ring {
  uint64_t* kbar;
  uint64_t* ebar;
  unsigned char* kbuf;
  unsigned char* ebuf;
  Layout L;

  __device__ void load_k(const SmoothArgs<T, KT>& a, int slot, int blk) {
    // generic-proxy reads of this buffer are done (a barrier passed)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(kbar + slot, L.ktile);
    bulk_load(kbuf + slot * L.ktile,
              a.kT + static_cast<size_t>(blk) * kBlk * kBlk, L.ktile,
              kbar + slot);
  }

  __device__ void load_e(const SmoothArgs<T, KT>& a, int slot, int blk) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const size_t e0 = static_cast<size_t>(blk) * kBlk * a.width;
    const unsigned ncol =
        kBlk * a.width * (a.lcols != nullptr ? sizeof(short) : sizeof(int));
    const void* csrc = a.lcols != nullptr ? static_cast<const void*>(a.lcols + e0)
                                          : static_cast<const void*>(a.cols + e0);
    unsigned char* dst = ebuf + slot * L.etile;
    mbar_expect(ebar + slot, L.evals + ncol);
    bulk_load(dst, a.vals + e0, L.evals, ebar + slot);
    bulk_load(dst + L.evals, csrc, ncol, ebar + slot);
  }
};

// ---- vector access: device memory (colored) or shared memory (coarse) -----

template <typename T>
struct GlobalVecs {
  T* x;
  const T* b;
  const T* lagc;
  const T* lagr;
  // x is written by other CTAs of this launch: read it at L2
  __device__ T ld_x(int i) const { return __ldcg(x + i); }
  __device__ void st_x(int i, T v) const { __stcg(x + i, v); }
  __device__ T ld_b(int i) const { return b[i]; }
  __device__ T ld_lagc(int i) const { return lagc[i]; }
  __device__ T ld_lagr(int i) const { return lagr[i]; }
};

template <typename T>
struct SharedVecs {
  T* x;
  const T* b;
  const T* lagc;
  const T* lagr;
  __device__ T ld_x(int i) const { return x[i]; }
  __device__ void st_x(int i, T v) const { x[i] = v; }
  __device__ T ld_b(int i) const { return b[i]; }
  __device__ T ld_lagc(int i) const { return lagc[i]; }
  __device__ T ld_lagr(int i) const { return lagr[i]; }
};

// the colored kernel's gather: x from the block's patches in shared memory
template <typename T>
struct PatchX {
  const T* xp;
  __device__ T ld_x(int i) const { return xp[i]; }
};

// v, or the pinned value of row i where the pin (dmask, dvals) holds it
template <typename T>
__device__ __forceinline__ T pinned(const T* dmask, const T* dvals, int i, T v) {
  return dmask != nullptr && dmask[i] > T(0) ? dvals[i] : v;
}

// the first re-solve: x read as the launch got it (x_in, which nothing in
// the launch writes), each row written pinned into x (device memory for
// colored_smooth, shared memory for coarse_smooth)
template <typename T, bool kShared>
struct FirstVecs {
  const T* x_in;
  T* x;
  const T* b;
  const T* dmask;
  const T* dvals;
  __device__ T ld_x(int i) const { return x_in[i]; }
  __device__ T ld_b(int i) const { return b[i]; }
  __device__ void st_x(int i, T v) const {
    v = pinned(dmask, dvals, i, v);
    if constexpr (kShared) {
      x[i] = v;
    } else {
      __stcg(x + i, v);
    }
  }
};

// t = b - A x - lag_col * x_lag over the block's rows (v, c: the block's
// ELL rows, in shared or device memory; bq, lq: lane 0's b and lag_col *
// x_lag of its rows, loaded before).  Warp w sums rows w, w + 16, ...,
// w + 112 together, two 32-entry chunks of each at a time, so 16 of its
// loads are in flight at once; each row is summed as block_oneshot_sweep.cu
// sums it (lane-strided, then the warp).
template <typename T, typename KT, typename CT, class V>
__device__ __forceinline__ void gather_t(const T* v, const CT* c, int width,
                                         const V& vec, const T (&bq)[kRowsPerWarp],
                                         const T (&lq)[kRowsPerWarp], T* t_s) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  T acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = T(0);
  for (int k = lane; k < width; k += 2 * kWarp) {
    const bool second = k + kWarp < width;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int e = (warp + q * kWarps) * width + k;
      acc[q] += v[e] * vec.ld_x(c[e]);
      if (second) acc[q] += v[e + kWarp] * vec.ld_x(c[e + kWarp]);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const T s = warp_sum(acc[q]);
    if (lane == 0) t_s[warp + q * kWarps] = t_in<T, KT>(bq[q] - s - lq[q]);
  }
}

// x_blk += K_blk t (K tile and t in shared memory), as block_oneshot_sweep.cu
// adds it (xo, lr: thread r's own row's x and lag_row, loaded before);
// returns this thread's lag_row * x_new (0 without a relax).  Ends with the
// block barrier.
template <typename T, typename KT, class V>
__device__ __forceinline__ T k_update(const KT* kb, const T* t_s, T* part,
                                      const V& vec, int row0, T xo, T lr) {
  const int r = threadIdx.x % kBlk;
  const int h = threadIdx.x / kBlk;
  T dx = T(0);
  for (int c = h * (kBlk / kSplit); c < (h + 1) * (kBlk / kSplit); ++c) {
    dx += k_val(kb[c * kBlk + r]) * t_s[c];
  }
  part[threadIdx.x] = dx;
  __syncthreads();
  T lag = T(0);
  if (h == 0) {
    T acc = T(0);
    for (int q = 0; q < kSplit; ++q) acc += part[r + q * kBlk];
    const T xn = xo + acc;
    vec.st_x(row0 + r, xn);
    if (vec.lagr != nullptr) lag = lr * xn;
  }
  __syncthreads();
  return lag;
}

// the sum of v over the CTA, in a fixed order; every thread gets it
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  const T s = red[kWarps];
  __syncthreads();
  return s;
}

// The boundary rows' re-solve (compact_rows.cu mode 0): warp `first` of
// `stride` warps takes rows first, first + stride, ...; kResolveBatch of them
// at once, each read to its lens.  brows, bdiag: in shared or device memory.
template <typename T, typename KT, class V>
__device__ __forceinline__ void resolve(const SmoothArgs<T, KT>& a,
                                        const V& vec, const int* brows,
                                        const T* bdiag, int first,
                                        int stride) {
  const int lane = threadIdx.x % kWarp;
  for (int i0 = first; i0 < a.bnrows; i0 += kResolveBatch * stride) {
    T acc[kResolveBatch];
    int len[kResolveBatch];
    int kmax = 0;
#pragma unroll
    for (int q = 0; q < kResolveBatch; ++q) {
      const int i = i0 + q * stride;
      acc[q] = T(0);
      len[q] = i < a.bnrows ? a.blens[i] : 0;
      kmax = max(kmax, len[q]);
    }
    for (int k = lane; k < kmax; k += kWarp) {
#pragma unroll
      for (int q = 0; q < kResolveBatch; ++q) {
        if (k < len[q]) {
          const size_t e = static_cast<size_t>(i0 + q * stride) * a.bwidth + k;
          acc[q] += a.bvals[e] * vec.ld_x(a.bcols[e]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kResolveBatch; ++q) {
      const T s = warp_sum(acc[q]);
      const int i = i0 + q * stride;
      if (lane == 0 && i < a.bnrows) {
        const int r = brows[i];
        if (r >= 0 && r < a.n_pad) {  // padding slots write nothing
          const T d = bdiag[i];
          vec.st_x(r, (vec.ld_b(r) - (s - d * vec.ld_x(r))) / d);
        }
      }
    }
  }
}

// Common prologue: barriers initialised, then the first nk K tiles and ne
// ELL tiles of this CTA's walk in flight.  Returns the issue cursors.
template <typename T, typename KT>
__device__ __forceinline__ void start_ring(const SmoothArgs<T, KT>& a,
                                           Ring<T, KT>& ring, Cursor& kc,
                                           Cursor& ec) {
  kc = Cursor{0, 0, static_cast<int>(blockIdx.x)};
  ec = kc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBars; ++s) mbar_init(ring.kbar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    settle(kc, a);
    settle(ec, a);
    for (int s = 0; s < a.nk && kc.it < a.iters; ++s) {
      ring.load_k(a, s, a.order[a.ptr[kc.c] + kc.i]);
      advance(kc, a);
    }
    for (int s = 0; s < a.ne && ec.it < a.iters; ++s) {
      ring.load_e(a, s, a.order[a.ptr[ec.c] + ec.i]);
      advance(ec, a);
    }
  }
  __syncthreads();
}

// One block of the walk (the j-th of this CTA): (colored: copy the block's
// x patches into shared memory,) wait for its ELL rows (or read them from
// device memory), gather, refill the ELL buffer, wait for K, the product,
// refill the K buffer.  Returns this thread's lag_row * x_new.
template <typename T, typename KT, bool kPatches, class V>
__device__ __forceinline__ T block_step(const SmoothArgs<T, KT>& a,
                                        Ring<T, KT>& ring, Cursor& kc,
                                        Cursor& ec, int j, int blk,
                                        const V& vec, T xl, T* xp, T* t_s,
                                        T* part) {
  using CT = typename std::conditional<kPatches, short, int>::type;
  const int row0 = blk * kBlk;
  // loads that wait for nothing but the block id: the rows' b and lag_col *
  // x_lag (lane 0 of each warp), the own rows' x and lag_row (threads <
  // 128; nothing else writes these rows until this block's update)
  T bq[kRowsPerWarp], lq[kRowsPerWarp];
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int r = row0 + threadIdx.x / kWarp + q * kWarps;
      bq[q] = vec.ld_b(r);
      lq[q] = vec.ld_lagc(r) * xl;
    }
  }
  T xo = T(0), lr = T(0);
  if (threadIdx.x < kBlk) {
    xo = vec.ld_x(row0 + threadIdx.x);
    if (vec.lagr != nullptr) lr = vec.ld_lagr(row0 + threadIdx.x);
  }
  if constexpr (kPatches) {  // coalesced: 128 rows of x a patch
    const int* pl = a.pids + static_cast<size_t>(blk) * a.npmax;
    const int n = a.npid[blk] * kBlk;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      xp[i] = vec.ld_x(pl[i / kBlk] * kBlk + i % kBlk);
    }
  }
  const T* v;
  const CT* c;
  const size_t e0 = static_cast<size_t>(row0) * a.width;
  if (a.ne > 0) {
    const int s = j % a.ne;
    mbar_wait(ring.ebar + s, (j / a.ne) & 1);
    v = reinterpret_cast<const T*>(ring.ebuf + s * ring.L.etile);
    c = reinterpret_cast<const CT*>(ring.ebuf + s * ring.L.etile +
                                    ring.L.evals);
  } else {
    v = a.vals + e0;
    if constexpr (kPatches) {
      c = a.lcols + e0;
    } else {
      c = a.cols + e0;
    }
  }
  if constexpr (kPatches) {
    __syncthreads();  // the patches are in
    gather_t<T, KT>(v, c, a.width, PatchX<T>{xp}, bq, lq, t_s);
  } else {
    gather_t<T, KT>(v, c, a.width, vec, bq, lq, t_s);
  }
  __syncthreads();
  if (threadIdx.x == 0 && a.ne > 0 && ec.it < a.iters) {
    ring.load_e(a, j % a.ne, a.order[a.ptr[ec.c] + ec.i]);
    advance(ec, a);
  }
  const int s = j % a.nk;
  mbar_wait(ring.kbar + s, (j / a.nk) & 1);
  const T lag = k_update<T, KT>(
      reinterpret_cast<const KT*>(ring.kbuf + s * ring.L.ktile), t_s, part,
      vec, row0, xo, lr);
  if (threadIdx.x == 0 && kc.it < a.iters) {
    ring.load_k(a, s, a.order[a.ptr[kc.c] + kc.i]);
    advance(kc, a);
  }
  return lag;
}

template <typename T, typename KT>
__device__ __forceinline__ Ring<T, KT> make_ring(unsigned char* smem,
                                                 const Layout& L) {
  Ring<T, KT> ring;
  ring.kbar = reinterpret_cast<uint64_t*>(smem);
  ring.ebar = ring.kbar + 2;
  ring.kbuf = smem + L.kbuf;
  ring.ebuf = smem + L.ebuf;
  ring.L = L;
  return ring;
}

template <typename T, typename KT>
__global__ void __launch_bounds__(kThreads, 1)
    colored_smooth_kernel(const SmoothArgs<T, KT> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T, KT>(a.nk, a.ne, a.width, sizeof(short),
                                      a.npmax * kBlk, 0, 0);
  Ring<T, KT> ring = make_ring<T, KT>(smem, L);
  T* xp = reinterpret_cast<T*>(smem + L.xp);
  T* t_s = reinterpret_cast<T*>(smem + L.t);
  T* part = reinterpret_cast<T*>(smem + L.part);
  T* red = reinterpret_cast<T*>(smem + L.red);
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;

  Cursor kc, ec;
  start_ring(a, ring, kc, ec);
  const int rwarp = blockIdx.x * kWarps + threadIdx.x / kWarp;  // re-solve
  if (a.x_in != a.x) {  // out of place: copy (pinned), then every CTA sees it
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n_pad;
         i += G * kThreads) {
      __stcg(a.x + i, pinned(a.dmask, a.dvals, i, a.x_in[i]));
    }
    grid.sync();
  }
  if (a.resolve_first && a.bnrows > 0) {  // over the copy's target rows
    resolve<T, KT>(a, FirstVecs<T, false>{a.x_in, a.x, a.b, a.dmask, a.dvals},
                   a.brows, a.bdiag, rwarp, G * kWarps);
    grid.sync();
  }
  const GlobalVecs<T> vec{a.x, a.b, a.lagc, a.lagr};
  T xl = *a.xlag_in;
  const T blag = a.lagr != nullptr ? *a.blag : T(0);

  int j = 0;
  for (int it = 0; it < a.iters; ++it) {
    T lag = T(0);
    for (int c = 0; c < a.nphases; ++c) {
      const int p0 = a.ptr[c];
      const int cnt = a.ptr[c + 1] - p0;
      for (int i = blockIdx.x; i < cnt; i += G, ++j) {
        lag += block_step<T, KT, true>(a, ring, kc, ec, j, a.order[p0 + i], vec,
                                       xl, xp, t_s, part);
      }
      const bool last = c + 1 == a.nphases;
      if (last && a.lagr != nullptr) {
        const T dot = block_sum(lag, red);
        if (threadIdx.x == 0) __stcg(a.partials + (it & 1) * G + blockIdx.x, dot);
      }
      if (!last || it + 1 < a.iters || a.lagr != nullptr || a.bnrows > 0) {
        grid.sync();
      }
    }
    if (a.lagr != nullptr) {  // every CTA adds the partials in one order
      if (threadIdx.x < kWarp) {
        T s = T(0);
        for (int p = threadIdx.x; p < G; p += kWarp) {
          s += __ldcg(a.partials + (it & 1) * G + p);
        }
        s = warp_sum(s);
        if (threadIdx.x == 0) {
          red[kWarps] = (T(1) - a.omega) * xl + a.omega * (blag - s);
        }
      }
      __syncthreads();
      xl = red[kWarps];
      __syncthreads();
    }
    if (a.bnrows > 0) {
      resolve<T, KT>(a, vec, a.brows, a.bdiag, rwarp, G * kWarps);
      if (it + 1 < a.iters) grid.sync();
    }
  }
  if (a.resolve_last && a.bnrows > 0) {  // the same rows on the same warps
    __syncwarp();
    resolve<T, KT>(a, vec, a.brows, a.bdiag, rwarp, G * kWarps);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.xlag_out != nullptr) {
    *a.xlag_out = xl;
  }
}

template <typename T, typename KT>
__global__ void __launch_bounds__(kThreads, 1)
    coarse_smooth_kernel(const SmoothArgs<T, KT> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m = a.bnrows;
  const Layout L = make_layout<T, KT>(a.nk, a.ne, a.width, sizeof(int), 0,
                                      a.n_pad, m);
  Ring<T, KT> ring = make_ring<T, KT>(smem, L);
  T* t_s = reinterpret_cast<T*>(smem + L.t);
  T* part = reinterpret_cast<T*>(smem + L.part);
  T* red = reinterpret_cast<T*>(smem + L.red);
  T* xs = reinterpret_cast<T*>(smem + L.vec);
  T* bs = xs + a.n_pad;
  T* lcs = bs + a.n_pad;
  T* lrs = lcs + a.n_pad;
  T* bds = reinterpret_cast<T*>(smem + L.bdiag);
  int* brs = reinterpret_cast<int*>(smem + L.brow);

  Cursor kc, ec;
  start_ring(a, ring, kc, ec);  // the K and ELL copies overlap the loads
  for (int i = threadIdx.x; i < a.n_pad; i += kThreads) {
    xs[i] = pinned(a.dmask, a.dvals, i, a.x_in[i]);
    bs[i] = a.b[i];
    lcs[i] = a.lagc[i];
    if (a.lagr != nullptr) lrs[i] = a.lagr[i];
  }
  for (int i = threadIdx.x; i < m; i += kThreads) {
    bds[i] = a.bdiag[i];
    brs[i] = a.brows[i];
  }
  __syncthreads();
  if (a.resolve_first && m > 0) {
    resolve<T, KT>(a, FirstVecs<T, true>{a.x_in, xs, bs, a.dmask, a.dvals}, brs,
                   bds, threadIdx.x / kWarp, kWarps);
    __syncthreads();
  }
  const SharedVecs<T> vec{xs, bs, lcs, a.lagr != nullptr ? lrs : nullptr};
  T xl = *a.xlag_in;
  const T blag = a.lagr != nullptr ? *a.blag : T(0);

  int j = 0;
  for (int it = 0; it < a.iters; ++it) {
    T lag = T(0);
    for (int c = 0; c < a.nphases; ++c) {
      const int p0 = a.ptr[c];
      const int cnt = a.ptr[c + 1] - p0;
      for (int i = 0; i < cnt; ++i, ++j) {
        lag += block_step<T, KT, false>(a, ring, kc, ec, j, a.order[p0 + i], vec,
                                        xl, nullptr, t_s, part);
      }
    }
    if (a.lagr != nullptr) {
      const T dot = block_sum(lag, red);
      xl = (T(1) - a.omega) * xl + a.omega * (blag - dot);
    }
    if (m > 0) {
      resolve<T, KT>(a, vec, brs, bds, threadIdx.x / kWarp, kWarps);
      __syncthreads();
    }
  }
  if (a.resolve_last && m > 0) {
    resolve<T, KT>(a, vec, brs, bds, threadIdx.x / kWarp, kWarps);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < a.n_pad; i += kThreads) a.x[i] = xs[i];
  if (threadIdx.x == 0 && a.xlag_out != nullptr) *a.xlag_out = xl;
}

// (nk, ne) in order of preference; the first that fits is taken
constexpr int kPlans[][2] = {{2, 2}, {2, 1}, {1, 1}, {2, 0}, {1, 0}};

template <typename T, typename KT>
int launch_smooth(SmoothArgs<T, KT> a, int coarse, int max_phase,
                  void* stream, int* info) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_vec = coarse ? a.n_pad : 0;
  const int m = coarse ? a.bnrows : 0;
  const int cbytes = coarse ? sizeof(int) : sizeof(short);
  const int npx = coarse ? 0 : a.npmax * kBlk;
  if (!coarse && (a.lcols == nullptr || a.pids == nullptr || a.npid == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned bytes = 0;
  a.nk = 0;
  for (const auto& p : kPlans) {
    const Layout L = make_layout<T, KT>(p[0], p[1], a.width, cbytes, npx, n_vec, m);
    if (L.total <= static_cast<unsigned>(optin)) {
      a.nk = p[0];
      a.ne = p[1];
      bytes = L.total;
      break;
    }
  }
  // the first re-solve reads x_in whole while the output is written; the
  // pin comes with it and only with it
  const bool pin = a.dmask != nullptr;
  if (a.nk == 0 || max_phase < 1 || a.iters < 1 ||
      (a.resolve_first && a.x_in == a.x) || (a.bnrows > 0 && a.blens == nullptr) ||
      pin != (a.dvals != nullptr) || pin != (a.resolve_first != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = coarse ? coarse_smooth_kernel<T, KT> : colored_smooth_kernel<T, KT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  int grid = 1;
  if (coarse) {
    kern<<<1, kThreads, bytes, st>>>(a);
    err = cudaGetLastError();
  } else {
    // CTAs resident at once at this shared-memory size (cached per size)
    static std::mutex mu;
    static unsigned cached_bytes = 0;
    static int cached_per_sm = 0;
    int per_sm = 0;
    {
      std::lock_guard<std::mutex> lock(mu);
      if (cached_bytes != bytes) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        cached_bytes = bytes;
        cached_per_sm = per_sm;
      }
      per_sm = cached_per_sm;
    }
    grid = max_phase < per_sm * sms ? max_phase : per_sm * sms;
    if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), grid,
                                      kThreads, args, bytes, st);
  }
  if (info != nullptr) {
    info[0] = grid;
    info[1] = a.nk;
    info[2] = a.ne;
    info[3] = static_cast<int>(bytes);
  }
  return static_cast<int>(err);
}

template <typename T, typename KT>
int smooth_entry(int coarse, const T* vals, const int* cols,
                 const short* lcols, const int* pids, const int* npid,
                 int npmax, int width,
                 int n_pad, const T* b, const T* lagc, const KT* kT,
                 const int* order, const int* ptr, int nphases, int max_phase,
                 int iters, double omega, const T* lagr, const T* blag,
                 const T* xlag_in, T* xlag_out, const T* bvals,
                 const int* bcols, const int* blens, const int* brows,
                 const T* bdiag, int bwidth, int bnrows, const T* dmask,
                 const T* dvals, int resolve_first, int resolve_last,
                 const T* x_in, T* x, T* partials, void* stream, int* info) {
  SmoothArgs<T, KT> a;
  a.vals = vals;
  a.cols = cols;
  a.lcols = lcols;
  a.pids = pids;
  a.npid = npid;
  a.npmax = npmax;
  a.width = width;
  a.n_pad = n_pad;
  a.b = b;
  a.lagc = lagc;
  a.kT = kT;
  a.order = order;
  a.ptr = ptr;
  a.nphases = nphases;
  a.iters = iters;
  a.omega = static_cast<T>(omega);
  a.lagr = lagr;
  a.blag = blag;
  a.xlag_in = xlag_in;
  a.xlag_out = xlag_out;
  a.bvals = bvals;
  a.bcols = bcols;
  a.blens = blens;
  a.brows = brows;
  a.bdiag = bdiag;
  a.bwidth = bwidth;
  a.bnrows = bnrows;
  a.dmask = dmask;
  a.dvals = dvals;
  a.resolve_first = resolve_first;
  a.resolve_last = resolve_last;
  a.x_in = x_in;
  a.x = x;
  a.partials = partials;
  a.nk = a.ne = 0;
  return launch_smooth<T, KT>(a, coarse, max_phase, stream, info);
}

}  // namespace

// coarse: 0 colored_smooth (cooperative grid; lcols, pids, npid, npmax:
// its x patches), 1 coarse_smooth (one CTA; the patch arguments unread).
// dmask, dvals: the pin, non-null exactly when resolve_first is set;
// resolve_first needs x_in != x.
// info (4 ints, may be null): grid, K buffers, ELL buffers, shared bytes.
#define MMP_SMOOTH_ENTRY(NAME, T, KT)                                        \
  extern "C" int NAME(int coarse, const T* vals, const int* cols,            \
                      const short* lcols, const int* pids, const int* npid,  \
                      int npmax, int width,                                  \
                      int n_pad, const T* b, const T* lagc, const KT* kT,    \
                      const int* order, const int* ptr, int nphases,         \
                      int max_phase, int iters, double omega, const T* lagr, \
                      const T* blag, const T* xlag_in, T* xlag_out,          \
                      const T* bvals, const int* bcols, const int* blens,    \
                      const int* brows, const T* bdiag, int bwidth,          \
                      int bnrows, const T* dmask, const T* dvals,            \
                      int resolve_first, int resolve_last, const T* x_in,    \
                      T* x, T* partials, void* stream, int* info) {          \
    return smooth_entry<T, KT>(coarse, vals, cols, lcols, pids, npid, npmax, \
                               width, n_pad, b, lagc,                        \
                               kT, order, ptr, nphases, max_phase, iters,    \
                               omega, lagr, blag, xlag_in, xlag_out, bvals,  \
                               bcols, blens, brows, bdiag, bwidth, bnrows,   \
                               dmask, dvals, resolve_first, resolve_last,    \
                               x_in, x, partials, stream, info);             \
  }

MMP_SMOOTH_ENTRY(mmp_block_smooth_f32, float, float)
MMP_SMOOTH_ENTRY(mmp_block_smooth_f64, double, double)
MMP_SMOOTH_ENTRY(mmp_block_smooth_f32_bf16k, float, __nv_bfloat16)
