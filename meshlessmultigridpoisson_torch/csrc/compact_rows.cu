// compact_rows<T>: y = C x over a compact table of rows of a big operator,
// with a scatter epilogue into the big row space.
//
// The table holds m_pad rows as a row-major ELL with global int32 columns
// (padding entries: value 0, a valid column), the target row r_i of each
// compact row in the big (permuted, padded) row space, and the big matrix's
// diagonal d_i at that row.  For compact row i, y_i = sum_k vals[i,k] *
// x[cols[i,k]]; then, with r = rows[i]:
//   mode 0, re-solve (Neumann boundary rows, role "bound2"):
//       x[r] = (b[r] - (y_i - d_i * x[r])) / d_i      (out aliases x)
//     y_i includes the diagonal term and d_i * x[r] is subtracted after the
//     sum, in the reference's own order of operations;
//   mode 1, pushdown (condensation rows, role "push2"):
//       out[r] = b[r] - y_i                           (x is b, out a copy)
//   mode 2, scatter (the compatible PPE's Neumann rows, role "ppe2"):
//       out[r] = y_i      (out is the matvec's y, never x; b unread: the
//                          wrapper passes x there)
// Padding slots carry r >= n_pad (the table's sentinel, n_pad + 1) and
// write nothing: the reference's scatter with mode="drop".
//
// Replaces the reference package's
//   meshlessmultigridpoisson_tpu/ops/kernels.py:spmv_tpu2  (per-block patch
//     tables) as it serves mg/tpu_backend.py:bound_eval_neumann and
//     push_inhomog_to_rhs, and models/fracstep_tpu.py:_mv32 (the scatter
//     of the compact Neumann rows' products into the compatible PPE
//     matvec), fusing the XLA take/scatter epilogue into the kernel.
//
// In-place safety: the reference scatters after every row is computed
// (Jacobi across the table's rows).  Here a row's epilogue may run while
// another row still gathers, which is the same only if no compact row reads
// the target row of another compact row.  Neumann stencils exclude other
// boundary points, and mg/gpu_backend.py checks it when it repacks a level
// (it raises otherwise); the pushdown runs out of place, and the scatter
// writes a vector it never reads.
//
// What bounds it on an H100: nothing on the card — a few hundred to a few
// thousand rows of ~20-70 entries (tens of KB) per call; it is a launch.
// The design is ell_spmv's: one warp per row reads the row's entries with
// consecutive lanes on consecutive addresses, sums in registers, reduces with
// warp shuffles, and lane 0 runs the epilogue.  No shared memory, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerCta = 8;  // one warp per row, 256 threads per CTA

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerCta)
compact_rows_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                    int width, int nrows, const int* __restrict__ rows,
                    const T* __restrict__ diag, int n_pad,
                    const T* x,  // re-solve: aliases out, so no __restrict__
                    const T* __restrict__ b, T* out, int mode) {
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * width;
  T acc = T(0);
  for (int k = lane; k < width; k += kWarp) {
    acc += vals[base + k] * x[cols[base + k]];
  }
  acc = warp_sum(acc);
  if (lane != 0) return;
  const int r = rows[row];
  // sentinel rows point past the end: test before any load or store at r
  if (r < 0 || r >= n_pad) return;
  if (mode == 0) {
    const T d = diag[row];
    out[r] = (b[r] - (acc - d * x[r])) / d;
  } else if (mode == 1) {
    out[r] = b[r] - acc;
  } else {
    out[r] = acc;
  }
}

template <typename T>
int launch_compact_rows(const T* vals, const int* cols, int width, int nrows,
                        const int* rows, const T* diag, int n_pad, const T* x,
                        const T* b, T* out, int mode, void* stream) {
  if (nrows > 0) {
    const int grid = (nrows + kRowsPerCta - 1) / kRowsPerCta;
    compact_rows_kernel<T><<<grid, kWarp * kRowsPerCta, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        vals, cols, width, nrows, rows, diag, n_pad, x, b, out, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmp_compact_rows_f32(const float* vals, const int* cols,
                                    int width, int nrows, const int* rows,
                                    const float* diag, int n_pad,
                                    const float* x, const float* b, float* out,
                                    int mode, void* stream) {
  return launch_compact_rows<float>(vals, cols, width, nrows, rows, diag,
                                    n_pad, x, b, out, mode, stream);
}

extern "C" int mmp_compact_rows_f64(const double* vals, const int* cols,
                                    int width, int nrows, const int* rows,
                                    const double* diag, int n_pad,
                                    const double* x, const double* b,
                                    double* out, int mode, void* stream) {
  return launch_compact_rows<double>(vals, cols, width, nrows, rows, diag,
                                     n_pad, x, b, out, mode, stream);
}
