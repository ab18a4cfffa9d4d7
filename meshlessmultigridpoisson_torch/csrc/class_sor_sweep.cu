// class_sor_sweep<T>: one full class SOR sweep, in place on x, K-free.
//
// The rows are cut into tiles of `class_size` consecutive rows (a class of
// the (block, class) ordering made at setup); the tiles are walked in
// storage order, and within a tile every row gathers from the same x
// (class-Jacobi) before any of them is written:
//     y_i  = sum_j A_ij x_j                     (the whole row, diagonal too)
//     x_i <- mask_i ? (1 - w_i) x_i
//                     + w_i / d_i (b_i - (y_i + lagc_i x_lag - d_i x_i))
//                   : x_i
// That is exact Gauss-Seidel over the tiles (ops/smoothers.py _gs_sweep).
// Rows the smoother does not update (mask 0: Dirichlet and Neumann rows,
// padding rows with d = 1) never move.
//
// Replaces two TPU kernels of the reference package, which compute this
// same function in two layouts:
//   meshlessmultigridpoisson_tpu/ops/kernels.py:586 sor_sweep_tpu2 (the
//     v2-fallback level smoother: class by class inside `block_rows`
//     blocks, per-block x patch tables refreshed before every class)
//   meshlessmultigridpoisson_tpu/ops/kernels4.py:464 sor_sweep_tpu4 (the
//     in-block coupling as a dense [128, 128] matrix on the MXU, one masked
//     full-lane blend per class)
// Patch tables, lane slices and the dense in-block matrix are TPU layout;
// the row-major ELL with global int32 columns (ell_spmv.cu) carries the
// same operator here.
//
// What bounds it on an H100: the dependent chain, not bytes.  Exact GS
// forbids two tiles side by side, so one CTA walks all n / class_size tiles
// while the card's other 131 SMs idle; each tile is a gather (column and
// value loads, then the x gather), a warp reduction, a barrier, the
// update's store and a second barrier, some 1-3 us of latency against the
// ~100 ns its bytes would take at 3.35 TB/s.  This first version keeps it
// simple: one warp per row of the tile (consecutive lanes on consecutive
// entries, a shuffle sum), lane 0 computes the update before the first
// barrier and stores it after it, so all rows of a tile have gathered
// before any of them is written — the class-Jacobi rule inside a tile,
// which the slice's permuted operators never exercise (their tiles are
// independent sets) but a natural ordering does.  Prefetching the next
// tile's rows while the current one reduces is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxClass = 32;  // one warp per row: at most 1024 threads

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kMaxClass)
class_sor_sweep_kernel(const T* __restrict__ vals,
                       const int* __restrict__ cols, int width, int ntiles,
                       int class_size, const T* __restrict__ diag,
                       const T* __restrict__ b, const T* __restrict__ mask,
                       const T* __restrict__ omega,
                       const T* __restrict__ lagc,
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
int launch_class_sweep(const T* vals, const int* cols, int width, int n_pad,
                       int class_size, const T* diag, const T* b,
                       const T* mask, const T* omega, const T* lagc,
                       const T* xlag, T* x, void* stream) {
  if (class_size < 1 || class_size > kMaxClass || n_pad % class_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad > 0) {
    class_sor_sweep_kernel<T><<<1, kWarp * class_size, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        vals, cols, width, n_pad / class_size, class_size, diag, b, mask,
        omega, lagc, xlag, x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmp_class_sweep_f32(const float* vals, const int* cols,
                                   int width, int n_pad, int class_size,
                                   const float* diag, const float* b,
                                   const float* mask, const float* omega,
                                   const float* lagc, const float* xlag,
                                   float* x, void* stream) {
  return launch_class_sweep<float>(vals, cols, width, n_pad, class_size, diag,
                                   b, mask, omega, lagc, xlag, x, stream);
}

extern "C" int mmp_class_sweep_f64(const double* vals, const int* cols,
                                   int width, int n_pad, int class_size,
                                   const double* diag, const double* b,
                                   const double* mask, const double* omega,
                                   const double* lagc, const double* xlag,
                                   double* x, void* stream) {
  return launch_class_sweep<double>(vals, cols, width, n_pad, class_size,
                                    diag, b, mask, omega, lagc, xlag, x,
                                    stream);
}
