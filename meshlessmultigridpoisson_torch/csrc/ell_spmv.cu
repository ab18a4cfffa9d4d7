// ell_spmv<T>: y = A x for a row-major ELL matrix.
//
// Replaces two TPU kernels of the reference package, which differ only in
// their table layout:
//   meshlessmultigridpoisson_tpu/ops/kernels6.py:spmv_tpu6  (coarsest-level
//     matvec, every restriction and prolongation)
//   meshlessmultigridpoisson_tpu/ops/kernels8.py:spmv_tpu8  (fine-level
//     matvec over the colored sweep tables)
// and, through its double instance, the XLA gather that computes the f64
// outer residual of the mixed-precision solve (mg/mixed.py).
//
// The TPU layouts (i16 patch<<7|lane columns, 128-lane window tiles, SMEM
// patch lists, segment-ragged widths) are Mosaic constraints and are not
// carried over: here a row is `width` contiguous (value, column) pairs,
// padding entries carry value 0 and a valid column.
//
// What bounds it on an H100: bytes per nonzero.  Each nonzero streams a
// value (4 or 8 B) and a column (4 B, or 2 B in the u16 format) once and
// gathers x[col]; the gathered x of a kd-tile-ordered operator is spatially
// local and stays in L1/L2, so the kernel is a stream of 6-12 B per nonzero
// against 3.35 TB/s.
//
// The production kernel, ell_spmv_blk<T, Col> (every solve role), does two
// things about that stream:
//   * it reads each row only to lens[r], one past its last nonzero (an
//     int32 a row, built at repack).  Implicit condensation widens the rows
//     next to the boundary and the ELL pads every row to the widest, so a
//     Neumann level's rows are half padding (fill 54-55%): the full-width
//     walk streamed ~1.85x the nonzeros' bytes;
//   * one CTA takes a 128-row block (8 warps, 16 rows each), the mapping the
//     kiso7 probe measured 15% faster than 8 rows a CTA; on a table too
//     small to give two CTAs an SM that way (the coarse transfers), 64 to
//     8 rows.  A warp sums four rows at once (one below four rows a warp,
//     whose first steps it loads before the row's length arrives), two
//     32-entry steps of each in flight (every value and column loaded
//     before any x is gathered), each row's lanes starting at the 8-entry
//     boundary below the row's first entry, so that every load of a warp
//     covers whole 32-byte sectors of values and int32 columns; the row
//     sums leave in one coalesced store.
//   Column format, by the repack's rule: int32 global columns (kColI32), or
//   (kColU16) a 16-bit unsigned offset from the int32 base column of the
//   row's 128-row block, where every block's columns span at most 65,535
//   and no sweep reads the table (the transfers and the f64 outer
//   operator).
// The parent design, one warp per row over the full width, 8 rows a CTA
// (ell_spmv_kernel <kBase, kColI32, kAffine> below), stays as the entry
// points mmp_ell_spmv_f32/f64: the timing-only role "spmv_rowwarp", and the
// probes below.
//
// Timing-only variants (the reference's scripts/kprobe.py:138
// spmv4_variant; probes/kprobe.py): the kernel is templated on a
// compile-time Mode.  The parent entry points ("spmv_rowwarp") instantiate
// kBase only, and their code is the same as before the variants existed.  The others
// compute other functions, are f32 only and never reach a solve; each
// drops one part of the row's work so that the base time minus the
// variant's time is that part's cost:
//   kNoGather  no x: acc += v * float(col) * 1e-9 (values and columns are
//              read as before; the reference multiplies its packed local
//              column, this the global one)
//   kNoReduce  no warp-shuffle reduction: lane row % 32 writes its own
//              partial (the entries k = lane, lane + 32, ...) to y[row];
//              every lane's loads stay live, since the writing lane is
//              known only at run time (the reference replaces its MXU row
//              sum by a plain sum over tile rows: another partial)
//   kNeither   both

// The kiso probes (the reference's scripts/kiso6.py:98 and kiso7.py:86
// spmv_var; probes/kiso6.py, probes/kiso7.py) add two more compile-time
// axes, f32 and kBase only, timing probes that never reach a solve:
//   column format  kColI32  the global int32 column (8 B per f32 entry);
//                  kColU16  a 16-bit unsigned offset from the int32 base
//                           column of the row's 128-row block (6 B per f32
//                           entry; the host prep refuses a block whose
//                           columns span more than 65,535)
//   row source     kAffine  y row r = A row r (the parent mapping: one
//                           warp per row, 8 rows per CTA);
//                  kIds     y block j = A block ids[j];
//                  kIdsGuarded / kIdsUnguarded: the same on an id table
//                           padded with -1; guarded, a CTA whose id is < 0
//                           writes nothing; unguarded, it computes block
//                           max(id, 0) = 0 and writes it into its block.
//                  The id sources run one CTA per 128-row output block
//                  (8 warps, a warp per row, 16 rows each): its id (and,
//                  for kColU16, its base column) is read once by one
//                  thread and shared, so the dependent load is paid once
//                  a block.  The row's arithmetic is the parent code's.
// The parent entry points are <kBase, kColI32, kAffine>.
//
// ell_rowsum_mma<Passes> (the reference's scripts/kiso8.py:136 spmv_var,
// its MXU row sums; probes/kiso8.py): y = A x with the row sums taken by
// the tensor cores.  One warp owns 16 rows; for each chunk of 8 entries a
// row, each lane forms four products v * x[col] in f32 and puts them, as
// TF32, straight into its registers of an mma.sync m16n8k8 A fragment
// (lane l: rows l/4 and l/4 + 8, slots l%4 and l%4 + 4; slot order within
// a chunk is free, since B is all ones: lane l takes the row's entries
// 8c + 2(l%4) and + 1).  Column n of the f32 accumulator holds the 16 row
// sums for every n; lanes l%4 == 0 write column 0.  The width must be a
// multiple of 8 (the host pads with value 0 and a valid column).  Passes =
// 2, the counterpart of the reference's Precision.HIGHEST: hi =
// cvt.rna.tf32(p), lo = cvt.rna.tf32(p - hi), two mma a chunk (ones are
// exact in TF32, so B needs no split), p kept to ~2^-22 relative.  Passes
// = 1, the counterpart of DEFAULT: one TF32 pass, ~3 decimal digits,
// timing only.
// Bounded like the SpMV by its stream of 8 B per entry: the tensor cores
// do 1/16 of an mma's work per entry.  The parent design
// (ell_rowsum_mma_v1, timing roles kiso8_mxu_v1 / kiso8_mxudef_v1; 47-55%
// of that bound) reads the fragment layout straight from device memory: a
// lane's 8-byte loads of values and columns land in eight rows' sectors at
// once (eight L1 wavefronts an instruction for 256 B, shared with the x
// gathers), and how many chunks' loads a warp keeps in flight is the
// compiler's choice (fewer for one pass than for two).  The production
// design stages a warp's 16 rows of values and columns into
// shared memory with the bulk-copy engine (cp.async.bulk on one mbarrier a
// warp: two copies where the 16 rows are contiguous in both places, else
// one a row, by 32 lanes at once) and reads its fragments there; the
// device-memory stream then takes no load instruction and no L1 wavefront,
// and a CTA of 4 warps (37 KB at width 72) leaves room for 6 CTAs an SM,
// ~220 KB of rows in flight.  The shared rows' stride keeps stride / 8 odd
// (width, or width + 8) so that a warp's 8-byte fragment read is its two
// wavefronts.  The fragment layout and the sums are the parent's.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "block_sweep_common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerCta = 8;  // one warp per row, 256 threads per CTA
constexpr int kBlockRows = 128;  // rows of an id-table block and a u16 base

enum SpmvMode : int { kBase = 0, kNoGather = 1, kNoReduce = 2, kNeither = 3 };
enum ColFormat : int { kColI32 = 0, kColU16 = 1 };
enum RowSource : int { kAffine = 0, kIds = 1, kIdsGuarded = 2, kIdsUnguarded = 3 };

template <int Col>
using ColT = std::conditional_t<Col == kColU16, unsigned short, int>;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// One warp: A row `arow` (entries base .. base + width) into y[yrow].
// col0: the base column of the row's block (kColU16; 0 otherwise).
template <typename T, int Mode, int Col>
__device__ __forceinline__ void spmv_row(const T* __restrict__ vals,
                                         const ColT<Col>* __restrict__ cols,
                                         int col0, int width, int arow,
                                         int yrow, int lane,
                                         const T* __restrict__ x,
                                         T* __restrict__ y) {
  constexpr bool kGather = Mode == kBase || Mode == kNoReduce;
  constexpr bool kReduce = Mode == kBase || Mode == kNoGather;
  const size_t base = static_cast<size_t>(arow) * width;
  T acc = T(0);
  for (int k = lane; k < width; k += kWarp) {
    int c;
    if constexpr (Col == kColU16) {
      c = col0 + static_cast<int>(cols[base + k]);
    } else {
      c = cols[base + k];
    }
    if constexpr (kGather) {
      acc += vals[base + k] * x[c];
    } else {
      acc += vals[base + k] * static_cast<T>(c) * T(1e-9);
    }
  }
  if constexpr (kReduce) {
    acc = warp_sum(acc);
    if (lane == 0) y[yrow] = acc;
  } else {
    if (lane == yrow % kWarp) y[yrow] = acc;
  }
}

template <typename T, int Mode, int Col = kColI32, int Src = kAffine>
__global__ void __launch_bounds__(kWarp * kRowsPerCta)
ell_spmv_kernel(const T* __restrict__ vals, const ColT<Col>* __restrict__ cols,
                const int* __restrict__ col_base, const int* __restrict__ ids,
                int width, int nrows, const T* __restrict__ x,
                T* __restrict__ y) {
  const int lane = threadIdx.x % kWarp;
  if constexpr (Src == kAffine) {
    const int row = blockIdx.x * kRowsPerCta + threadIdx.x / kWarp;
    if (row >= nrows) return;  // whole warp leaves together
    const int col0 = Col == kColU16 ? col_base[row / kBlockRows] : 0;
    spmv_row<T, Mode, Col>(vals, cols, col0, width, row, row, lane, x, y);
  } else {
    // one CTA per output block (grid = the id table's length)
    __shared__ int s_id, s_col0;
    if (threadIdx.x == 0) {
      int id = ids[blockIdx.x];
      if constexpr (Src == kIdsUnguarded) id = max(id, 0);
      s_id = id;
      s_col0 = (Col == kColU16 && id >= 0) ? col_base[id] : 0;
    }
    __syncthreads();
    const int id = s_id, col0 = s_col0;
    if constexpr (Src == kIdsGuarded) {
      if (id < 0) return;  // the whole CTA: a padded block writes nothing
    }
    for (int r = threadIdx.x / kWarp; r < kBlockRows; r += kRowsPerCta) {
      spmv_row<T, Mode, Col>(vals, cols, col0, width, id * kBlockRows + r,
                             blockIdx.x * kBlockRows + r, lane, x, y);
    }
  }
}

template <typename T, int Mode = kBase, int Col = kColI32, int Src = kAffine>
int launch_ell_spmv(const T* vals, const ColT<Col>* cols, const int* col_base,
                    const int* ids, int width, int nrows, const T* x, T* y,
                    void* stream) {
  // kAffine: nrows rows; the id sources: nrows = the id table's length
  const int grid = Src == kAffine ? (nrows + kRowsPerCta - 1) / kRowsPerCta
                                  : nrows;
  if (grid > 0) {
    ell_spmv_kernel<T, Mode, Col, Src><<<grid, kWarp * kRowsPerCta, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        vals, cols, col_base, ids, width, nrows, x, y);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- ell_spmv_blk: the production kernel (see the header) ---------------

constexpr int kBlkWarps = 8;    // 256 threads a CTA
constexpr int kRowsAtOnce = 4;  // rows a warp sums together
constexpr int kSteps = 2;       // 32-entry steps of each row in flight
constexpr int kSector = 8;      // f32 values / int32 columns a 32-byte sector

template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// A CTA takes 8 * rpw consecutive rows (rpw = 1, 2, 4, 8 or 16 rows a
// warp: 8 to 128 rows, within one 128-row block, so a u16 table's base
// column is the CTA's), warp w rows w * rpw .. + rpw - 1, G at a time:
// G = 4, or G = 1 below 4 rows a warp.  G = 1 serves the tables too small
// to hide a load: each row's first kSteps steps are loaded before its
// length arrives, bounded by the row's width (past lens lie zero-valued
// padding entries with valid columns), and summed only below lens.
template <int Col>
__device__ __forceinline__ int col_at(const ColT<Col>* __restrict__ cols,
                                      int col0, int e) {
  if constexpr (Col == kColU16) {
    return col0 + static_cast<int>(cols[e]);
  } else {
    return cols[e];
  }
}

template <typename T, int Col, int G>
__global__ void __launch_bounds__(kWarp * kBlkWarps)
ell_spmv_blk_kernel(const T* __restrict__ vals,
                    const ColT<Col>* __restrict__ cols,
                    const int* __restrict__ col_base,
                    const int* __restrict__ lens, int width, int nrows,
                    int rpw, const T* __restrict__ x, T* __restrict__ y) {
  const int lane = threadIdx.x % kWarp;
  const int cta0 = blockIdx.x * kBlkWarps * rpw;
  const int r0 = cta0 + (threadIdx.x / kWarp) * rpw;
  const int col0 = Col == kColU16 ? col_base[cta0 / kBlockRows] : 0;
  // lane i < rpw holds the length of the warp's row r0 + i (0 past nrows)
  const int my_len = (lane < rpw && r0 + lane < nrows) ? lens[r0 + lane] : 0;
  T mine = T(0);  // lane i < rpw: row r0 + i's sum
  for (int g = 0; g < rpw; g += G) {
    // entry offsets: the wrapper keeps nrows * width below 2^31
    int beg[G], end[G], start[G];
    T acc[G];
    int s0 = 0;
    int c0[kSteps];
    T v0[kSteps];
    if constexpr (G == 1) {  // the first steps, before the length
      beg[0] = (r0 + g) * width;
      start[0] = beg[0] & ~(kSector - 1);
      const bool row = r0 + g < nrows;
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const int e = start[0] + t * kWarp + lane;
        const bool in = row && e >= beg[0] && e < beg[0] + width;
        c0[t] = in ? col_at<Col>(cols, col0, e) : -1;
        v0[t] = in ? vals[e] : T(0);
      }
      s0 = kSteps;
    }
    int n = 0;  // 32-entry steps, the most any of the rows needs
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int len = __shfl_sync(0xffffffffu, my_len, g + q);
      beg[q] = (r0 + g + q) * width;
      end[q] = beg[q] + len;
      start[q] = beg[q] & ~(kSector - 1);
      n = max(n, len > 0 ? (end[q] - start[q] + kWarp - 1) / kWarp : 0);
      acc[q] = T(0);
    }
    if constexpr (G == 1) {
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const int e = start[0] + t * kWarp + lane;
        if (c0[t] >= 0 && e < end[0]) acc[0] += v0[t] * x[c0[t]];
      }
    }
    for (int s = s0; s < n; s += kSteps) {
      // every (row, step) slot's value and column first, then the gathers
      int c[G][kSteps];
      T v[G][kSteps];
#pragma unroll
      for (int q = 0; q < G; ++q) {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          const int e = start[q] + (s + t) * kWarp + lane;
          const bool in = e >= beg[q] && e < end[q];
          c[q][t] = in ? col_at<Col>(cols, col0, e) : -1;
          v[q][t] = in ? vals[e] : T(0);
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          if (c[q][t] >= 0) acc[q] += v[q][t] * x[c[q][t]];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const T sum = warp_allsum(acc[q]);
      if (lane == g + q) mine = sum;
    }
  }
  if (lane < rpw && r0 + lane < nrows) y[r0 + lane] = mine;
}

// rows a warp: 16 (a CTA a 128-row block) where that gives at least
// kFillCtas CTAs, else 8, 4, 2 or 1, so that a small table still spreads
// over the card (a 2,560-row transfer is 20 blocks of 128 rows)
constexpr int kFillCtas = 264;  // two CTAs an SM of an H100

inline int rows_per_warp(int nrows) {
  for (int rpw = 16; rpw > 1; rpw /= 2) {
    if ((nrows + kBlkWarps * rpw - 1) / (kBlkWarps * rpw) >= kFillCtas) return rpw;
  }
  return 1;
}

template <typename T, int Col>
int launch_ell_spmv_blk(const T* vals, const ColT<Col>* cols,
                        const int* col_base, const int* lens, int width,
                        int nrows, const T* x, T* y, void* stream) {
  const int rpw = rows_per_warp(nrows);
  const int grid = (nrows + kBlkWarps * rpw - 1) / (kBlkWarps * rpw);
  auto st = static_cast<cudaStream_t>(stream);
  if (grid > 0 && rpw >= kRowsAtOnce) {
    ell_spmv_blk_kernel<T, Col, kRowsAtOnce><<<grid, kWarp * kBlkWarps, 0, st>>>(
        vals, cols, col_base, lens, width, nrows, rpw, x, y);
  } else if (grid > 0) {
    ell_spmv_blk_kernel<T, Col, 1><<<grid, kWarp * kBlkWarps, 0, st>>>(
        vals, cols, col_base, lens, width, nrows, rpw, x, y);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMmaWarps = 8;  // parent design: 8 warps x 16 rows a CTA

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// d += A (16 x 8, TF32, row-major fragment a) * ones (8 x 8)
__device__ __forceinline__ void mma_ones(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3) {
  const uint32_t one = 0x3f800000u;  // 1.0f, exact in TF32
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(one), "r"(one));
}

// one chunk's four products (rows g and g + 8, slots t and t + 4) into d
template <int Passes>
__device__ __forceinline__ void mma_products(float (&d)[4], float p0, float p1,
                                             float p2, float p3) {
  const uint32_t h0 = to_tf32(p0), h1 = to_tf32(p1), h2 = to_tf32(p2),
                 h3 = to_tf32(p3);
  mma_ones(d, h0, h1, h2, h3);
  if constexpr (Passes == 2) {
    mma_ones(d, to_tf32(p0 - __uint_as_float(h0)),
             to_tf32(p1 - __uint_as_float(h1)),
             to_tf32(p2 - __uint_as_float(h2)),
             to_tf32(p3 - __uint_as_float(h3)));
  }
}

// The parent design (timing roles kiso8_mxu_v1 / kiso8_mxudef_v1):
// each lane loads its chunk's values and columns straight from device
// memory, 8 B a load, one chunk at a time.
template <int Passes>
__global__ void __launch_bounds__(kWarp * kMmaWarps)
ell_rowsum_mma_v1_kernel(const float* __restrict__ vals,
                         const int* __restrict__ cols, int width, int nrows,
                         const float* __restrict__ x, float* __restrict__ y) {
  const int lane = threadIdx.x % kWarp;
  const int row0 = (blockIdx.x * kMmaWarps + threadIdx.x / kWarp) * 16;
  if (row0 >= nrows) return;  // whole warp: nrows is a multiple of 16
  const int g = lane / 4, t = lane % 4;
  const size_t ra = static_cast<size_t>(row0 + g) * width;  // row g
  const size_t rb = ra + static_cast<size_t>(8) * width;    // row g + 8
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  // every lane runs the same count of chunks: width % 8 == 0, 2t < 8
  for (int k = 2 * t; k < width; k += 8) {
    const float2 va = *reinterpret_cast<const float2*>(vals + ra + k);
    const float2 vb = *reinterpret_cast<const float2*>(vals + rb + k);
    const int2 ca = *reinterpret_cast<const int2*>(cols + ra + k);
    const int2 cb = *reinterpret_cast<const int2*>(cols + rb + k);
    // a0: row g, slot t; a1: row g + 8, slot t; a2, a3: slot t + 4
    mma_products<Passes>(d, va.x * x[ca.x], vb.x * x[cb.x], va.y * x[ca.y],
                         vb.y * x[cb.y]);
  }
  if (t == 0) {  // d[0]: (row g, column 0); d[2]: (row g + 8, column 0)
    y[row0 + g] = d[0];
    y[row0 + g + 8] = d[2];
  }
}

// ell_rowsum_mma: the production design (see the header comment).
constexpr int kStageWarps = 4;     // 4 warps x 16 rows = 64 rows a CTA
constexpr size_t kSmemOptin = 232448;  // shared memory a CTA may opt in to
constexpr int kStageBarBytes = 128;  // the warps' mbarriers, then the rows
constexpr int kStageGroup = 3;       // chunks whose gathers are in flight at once
constexpr int kStageCtasPerSm = 6;   // 37 KB a CTA at width 72

// Shared-memory row stride (in entries) of the staged rows: the width where
// width / 8 is odd, else width + 8.  Lane (g, t) reads 8 B at word g *
// stride + 8c + 2t: with stride / 8 odd, rows g and g + 1 .. g + 3 sit on
// other banks, so a warp's 8-byte read is its two wavefronts and no more.
__host__ __device__ __forceinline__ int mma_stride(int width) {
  return (width / 8) % 2 ? width : width + 8;
}

__host__ __device__ __forceinline__ size_t mma_stage_bytes(int width,
                                                           int warps) {
  return kStageBarBytes +
         static_cast<size_t>(warps) * 16 * mma_stride(width) * 8;
}

template <int Passes>
__global__ void __launch_bounds__(kWarp * kStageWarps, kStageCtasPerSm)
ell_rowsum_mma_kernel(const float* __restrict__ vals,
                      const int* __restrict__ cols, int width, int nrows,
                      const float* __restrict__ x, float* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  const int row0 = (blockIdx.x * warps + warp) * 16;
  if (row0 >= nrows) return;  // whole warp: nrows is a multiple of 16
  const int stride = mma_stride(width);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp;
  float* sv = reinterpret_cast<float*>(smem + kStageBarBytes) +
              static_cast<size_t>(warp) * 32 * stride;
  int* sc = reinterpret_cast<int*>(sv + 16 * stride);
  const size_t base = static_cast<size_t>(row0) * width;
  const uint32_t row_bytes = static_cast<uint32_t>(width) * 4;
  if (lane == 0) {
    mmp_sweep::mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mmp_sweep::mbar_expect(bar, 32 * row_bytes);
  }
  __syncwarp();
  if (stride == width) {  // the 16 rows are contiguous here and there
    if (lane == 0) {
      mmp_sweep::bulk_load(sv, vals + base, 16 * row_bytes, bar);
      mmp_sweep::bulk_load(sc, cols + base, 16 * row_bytes, bar);
    }
  } else {  // a row a lane: lanes 0-15 the values, 16-31 the columns
    const int r = lane % 16;
    if (lane < 16) {
      mmp_sweep::bulk_load(sv + r * stride, vals + base + r * width, row_bytes,
                           bar);
    } else {
      mmp_sweep::bulk_load(sc + r * stride, cols + base + r * width, row_bytes,
                           bar);
    }
  }
  const int g = lane / 4, t = lane % 4;
  const float* va_s = sv + g * stride + 2 * t;  // row g
  const float* vb_s = va_s + 8 * stride;        // row g + 8
  const int* ca_s = sc + g * stride + 2 * t;
  const int* cb_s = ca_s + 8 * stride;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mmp_sweep::mbar_wait(bar, 0);
  // a group of chunks: every fragment read, then every gather, then the
  // mma (without the grouping the one-pass instance interleaved its gathers
  // with its mma, one chunk's latency at a time)
  int k = 0;
  for (; k + 8 * kStageGroup <= width; k += 8 * kStageGroup) {
    float2 va[kStageGroup], vb[kStageGroup];
    int2 ca[kStageGroup], cb[kStageGroup];
    float xs[kStageGroup][4];
#pragma unroll
    for (int c = 0; c < kStageGroup; ++c) {
      va[c] = *reinterpret_cast<const float2*>(va_s + k + 8 * c);
      vb[c] = *reinterpret_cast<const float2*>(vb_s + k + 8 * c);
      ca[c] = *reinterpret_cast<const int2*>(ca_s + k + 8 * c);
      cb[c] = *reinterpret_cast<const int2*>(cb_s + k + 8 * c);
    }
#pragma unroll
    for (int c = 0; c < kStageGroup; ++c) {
      xs[c][0] = __ldg(x + ca[c].x);
      xs[c][1] = __ldg(x + cb[c].x);
      xs[c][2] = __ldg(x + ca[c].y);
      xs[c][3] = __ldg(x + cb[c].y);
    }
#pragma unroll
    for (int c = 0; c < kStageGroup; ++c) {
      mma_products<Passes>(d, va[c].x * xs[c][0], vb[c].x * xs[c][1],
                           va[c].y * xs[c][2], vb[c].y * xs[c][3]);
    }
  }
  for (; k < width; k += 8) {
    const float2 va = *reinterpret_cast<const float2*>(va_s + k);
    const float2 vb = *reinterpret_cast<const float2*>(vb_s + k);
    const int2 ca = *reinterpret_cast<const int2*>(ca_s + k);
    const int2 cb = *reinterpret_cast<const int2*>(cb_s + k);
    mma_products<Passes>(d, va.x * __ldg(x + ca.x), vb.x * __ldg(x + cb.x),
                         va.y * __ldg(x + ca.y), vb.y * __ldg(x + cb.y));
  }
  if (t == 0) {
    y[row0 + g] = d[0];
    y[row0 + g + 8] = d[2];
  }
}

// parent: the parent design (ell_rowsum_mma_v1) instead of the staged one
template <int Passes>
int launch_rowsum_mma(const float* vals, const int* cols, int width,
                      int nrows, const float* x, float* y, bool parent,
                      void* stream) {
  if (width % 8 != 0 || nrows % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  if (parent) {
    const int rows_per_cta = 16 * kMmaWarps;
    ell_rowsum_mma_v1_kernel<Passes>
        <<<(nrows + rows_per_cta - 1) / rows_per_cta, kWarp * kMmaWarps, 0,
           st>>>(vals, cols, width, nrows, x, y);
    return static_cast<int>(cudaGetLastError());
  }
  // a wide row stages fewer warps a CTA (one warp: widths up to ~1,800)
  int warps = kStageWarps;
  while (warps > 1 && mma_stage_bytes(width, warps) > kSmemOptin) --warps;
  const size_t bytes = mma_stage_bytes(width, warps);
  if (bytes > kSmemOptin) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ell_rowsum_mma_kernel<Passes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemOptin));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows_per_cta = 16 * warps;
  ell_rowsum_mma_kernel<Passes>
      <<<(nrows + rows_per_cta - 1) / rows_per_cta, kWarp * warps, bytes, st>>>(
          vals, cols, width, nrows, x, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The production SpMV.  cols: int32 global columns (u16 = 0) or the
// unsigned 16-bit offsets from col_base, one int32 a 128-row block (u16 =
// 1); lens: one past each row's last nonzero.
extern "C" int mmp_ell_spmv_blk_f32(const float* vals, const void* cols,
                                    const int* col_base, const int* lens,
                                    int width, int nrows, const float* x,
                                    float* y, int u16, void* stream) {
  if (u16) {
    return launch_ell_spmv_blk<float, kColU16>(
        vals, static_cast<const unsigned short*>(cols), col_base, lens, width,
        nrows, x, y, stream);
  }
  return launch_ell_spmv_blk<float, kColI32>(
      vals, static_cast<const int*>(cols), nullptr, lens, width, nrows, x, y,
      stream);
}

extern "C" int mmp_ell_spmv_blk_f64(const double* vals, const void* cols,
                                    const int* col_base, const int* lens,
                                    int width, int nrows, const double* x,
                                    double* y, int u16, void* stream) {
  if (u16) {
    return launch_ell_spmv_blk<double, kColU16>(
        vals, static_cast<const unsigned short*>(cols), col_base, lens, width,
        nrows, x, y, stream);
  }
  return launch_ell_spmv_blk<double, kColI32>(
      vals, static_cast<const int*>(cols), nullptr, lens, width, nrows, x, y,
      stream);
}

// The parent design (role "spmv_rowwarp", timing only): a warp per row over
// the full width, 8 rows a CTA, int32 columns.
extern "C" int mmp_ell_spmv_f32(const float* vals, const int* cols, int width,
                                int nrows, const float* x, float* y,
                                void* stream) {
  return launch_ell_spmv<float>(vals, cols, nullptr, nullptr, width, nrows, x,
                                y, stream);
}

extern "C" int mmp_ell_spmv_f64(const double* vals, const int* cols,
                                int width, int nrows, const double* x,
                                double* y, void* stream) {
  return launch_ell_spmv<double>(vals, cols, nullptr, nullptr, width, nrows,
                                 x, y, stream);
}

// the timing-only variants (f32); mode is a SpmvMode.  Returns
// cudaErrorInvalidValue for an unknown mode.
extern "C" int mmp_spmv_probe_f32(const float* vals, const int* cols,
                                  int width, int nrows, const float* x,
                                  float* y, int mode, void* stream) {
  switch (mode) {
    case kBase:
      return launch_ell_spmv<float, kBase>(vals, cols, nullptr, nullptr,
                                           width, nrows, x, y, stream);
    case kNoGather:
      return launch_ell_spmv<float, kNoGather>(vals, cols, nullptr, nullptr,
                                               width, nrows, x, y, stream);
    case kNoReduce:
      return launch_ell_spmv<float, kNoReduce>(vals, cols, nullptr, nullptr,
                                               width, nrows, x, y, stream);
    case kNeither:
      return launch_ell_spmv<float, kNeither>(vals, cols, nullptr, nullptr,
                                              width, nrows, x, y, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kiso probes (f32).  variant: 0-3 the kiso6 instances
// <kColU16|kColI32, kIdsGuarded|kIdsUnguarded> as (i16, guarded) = (1, 1),
// (1, 0), (0, 1), (0, 0) -> 0, 1, 2, 3; 4 kiso7 affine (the parent
// production instance), 5 kiso7 ids; 6 / 7 ell_rowsum_mma<2> / <1>, 8 / 9
// their parent design (ell_rowsum_mma_v1<2> / <1>).  cols is int32
// or, for the u16 variants, the unsigned 16-bit offsets; col_base (u16
// only) one int32 a 128-row block; ids (id variants) one a 128-row output
// block.  nrows: the rows of y for variants 4 and 6-9, the id table's length
// for the id variants.  Returns cudaErrorInvalidValue for an unknown
// variant, or an mma width or row count that is not a multiple of 8 / 16.
extern "C" int mmp_kiso_spmv_f32(const float* vals, const void* cols,
                                 const int* col_base, const int* ids,
                                 int width, int nrows, const float* x,
                                 float* y, int variant, void* stream) {
  const auto* u16 = static_cast<const unsigned short*>(cols);
  const auto* i32 = static_cast<const int*>(cols);
  switch (variant) {
    case 0:
      return launch_ell_spmv<float, kBase, kColU16, kIdsGuarded>(
          vals, u16, col_base, ids, width, nrows, x, y, stream);
    case 1:
      return launch_ell_spmv<float, kBase, kColU16, kIdsUnguarded>(
          vals, u16, col_base, ids, width, nrows, x, y, stream);
    case 2:
      return launch_ell_spmv<float, kBase, kColI32, kIdsGuarded>(
          vals, i32, nullptr, ids, width, nrows, x, y, stream);
    case 3:
      return launch_ell_spmv<float, kBase, kColI32, kIdsUnguarded>(
          vals, i32, nullptr, ids, width, nrows, x, y, stream);
    case 4:
      return launch_ell_spmv<float>(vals, i32, nullptr, nullptr, width, nrows,
                                    x, y, stream);
    case 5:
      return launch_ell_spmv<float, kBase, kColI32, kIds>(
          vals, i32, nullptr, ids, width, nrows, x, y, stream);
    case 6:
      return launch_rowsum_mma<2>(vals, i32, width, nrows, x, y, false, stream);
    case 7:
      return launch_rowsum_mma<1>(vals, i32, width, nrows, x, y, false, stream);
    case 8:
      return launch_rowsum_mma<2>(vals, i32, width, nrows, x, y, true, stream);
    case 9:
      return launch_rowsum_mma<1>(vals, i32, width, nrows, x, y, true, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
