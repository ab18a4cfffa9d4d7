// ell_spmv<T>: y = A x for a row-major ELL matrix with global int32 columns.
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
// What bounds it on an H100: bytes per stored entry.  Each entry streams a
// value (4 or 8 B) and a column (4 B) once and gathers x[col]; the gathered x
// of a kd-tile-ordered operator is spatially local and stays in L1/L2, so the
// kernel is a stream of 8 (f32) or 12 (f64) B per entry against 3.35 TB/s.
// The design keeps that stream coalesced: one warp per row reads the row's
// entries with consecutive lanes on consecutive addresses (a 70-entry
// deg-6 row is three 32-lane passes), sums in registers, and reduces with
// warp shuffles.  No shared memory, no atomics.
//
// Timing-only variants (the reference's scripts/kprobe.py:138
// spmv4_variant; probes/kprobe.py): the kernel is templated on a
// compile-time Mode.  The production entry points instantiate kBase only,
// and their code is the same as before the variants existed.  The others
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

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerCta = 8;  // one warp per row, 256 threads per CTA

enum SpmvMode : int { kBase = 0, kNoGather = 1, kNoReduce = 2, kNeither = 3 };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, int Mode>
__global__ void __launch_bounds__(kWarp * kRowsPerCta)
ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                int width, int nrows, const T* __restrict__ x,
                T* __restrict__ y) {
  constexpr bool kGather = Mode == kBase || Mode == kNoReduce;
  constexpr bool kReduce = Mode == kBase || Mode == kNoGather;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * width;
  T acc = T(0);
  for (int k = lane; k < width; k += kWarp) {
    if constexpr (kGather) {
      acc += vals[base + k] * x[cols[base + k]];
    } else {
      acc += vals[base + k] * static_cast<T>(cols[base + k]) * T(1e-9);
    }
  }
  if constexpr (kReduce) {
    acc = warp_sum(acc);
    if (lane == 0) y[row] = acc;
  } else {
    if (lane == row % kWarp) y[row] = acc;
  }
}

template <typename T, int Mode = kBase>
int launch_ell_spmv(const T* vals, const int* cols, int width, int nrows,
                    const T* x, T* y, void* stream) {
  if (nrows > 0) {
    const int grid = (nrows + kRowsPerCta - 1) / kRowsPerCta;
    ell_spmv_kernel<T, Mode><<<grid, kWarp * kRowsPerCta, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        vals, cols, width, nrows, x, y);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmp_ell_spmv_f32(const float* vals, const int* cols, int width,
                                int nrows, const float* x, float* y,
                                void* stream) {
  return launch_ell_spmv<float>(vals, cols, width, nrows, x, y, stream);
}

extern "C" int mmp_ell_spmv_f64(const double* vals, const int* cols,
                                int width, int nrows, const double* x,
                                double* y, void* stream) {
  return launch_ell_spmv<double>(vals, cols, width, nrows, x, y, stream);
}

// the timing-only variants (f32); mode is a SpmvMode.  Returns
// cudaErrorInvalidValue for an unknown mode.
extern "C" int mmp_spmv_probe_f32(const float* vals, const int* cols,
                                  int width, int nrows, const float* x,
                                  float* y, int mode, void* stream) {
  switch (mode) {
    case kBase:
      return launch_ell_spmv<float, kBase>(vals, cols, width, nrows, x, y,
                                           stream);
    case kNoGather:
      return launch_ell_spmv<float, kNoGather>(vals, cols, width, nrows, x,
                                               y, stream);
    case kNoReduce:
      return launch_ell_spmv<float, kNoReduce>(vals, cols, width, nrows, x,
                                               y, stream);
    case kNeither:
      return launch_ell_spmv<float, kNeither>(vals, cols, width, nrows, x, y,
                                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
