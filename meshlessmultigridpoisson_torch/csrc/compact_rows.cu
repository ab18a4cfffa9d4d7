// compact_rows<T>: y = C x over a compact table of rows of a big operator,
// with a scatter epilogue into the big row space; and ppe_tail<T>, the
// compatible PPE matvec's tail around the same table.
//
// The table holds m_pad rows as a row-major ELL with global int32 columns
// (padding entries: value 0, a valid column), each row's lens (one past its
// last nonzero: a row is read no further), the target row r_i of each
// compact row in the big (permuted, padded) row space, and the big matrix's
// diagonal d_i at that row.  For compact row i, y_i = sum_k vals[i,k] *
// x[cols[i,k]]; then, with r = rows[i]:
//   mode 0, re-solve (Neumann boundary rows, role "bound2"):
//       x[r] = (b[r] - (y_i - d_i * x[r])) / d_i      (out aliases x)
//     y_i includes the diagonal term and d_i * x[r] is subtracted after the
//     sum, in the reference's own order of operations;
//   mode 1, pushdown (condensation rows, role "push2"):
//       out[r] = b[r] - y_i                           (x is b, out a copy)
//   mode 2, scatter (role "ppe2_scatter": the compatible PPE's Neumann rows
//     as the parent design scattered them, one launch of its own; timing
//     only):
//       out[r] = y_i      (out is the matvec's y, never x; b unread: the
//                          wrapper passes x there)
// Padding slots carry r >= n_pad (the table's sentinel, n_pad + 1) and
// write nothing: the reference's scatter with mode="drop".
//
// ppe_tail (role "ppe2") is everything the compatible PPE matvec does after
// its four SpMVs, in one launch: for every row r of the fine level,
//   y_r = y_i (the compact row i whose target is r, slot[r] = i), else
//         p_r + q_r  (p = dx(dx x), q = dy(dy x));
//   y_r = live_r ? y_r : x_r;   y_r += lag_col_r * x_lag
// in the reference's order (models/fracstep_tpu.py:120-131 _mv32: the
// SpMVs' sum, the scatter, the identity on rows neither smoothed nor
// Neumann, the Lagrange column), the border product rounded on its own (no
// fused multiply-add), as the elementwise ops of the plain version round
// it.  The first CTAs take a row a thread and skip the compact rows'
// targets; the others a compact row a warp, as mode 2 sums it, sentinel
// slots writing nothing.
//
// Replaces the reference package's
//   meshlessmultigridpoisson_tpu/ops/kernels.py:spmv_tpu2  (per-block patch
//     tables) as it serves mg/tpu_backend.py:bound_eval_neumann and
//     push_inhomog_to_rhs, and models/fracstep_tpu.py:_mv32 (the scatter
//     of the compact Neumann rows' products into the compatible PPE
//     matvec), fusing the XLA take/scatter epilogue into the kernel.  The
//     V-cycle's re-solves of a fine level that runs block_smooth.cu run
//     inside that launch (its resolve phase is mode 0's).
//
// In-place safety: the reference scatters after every row is computed
// (Jacobi across the table's rows).  Here a row's epilogue may run while
// another row still gathers, which is the same only if no compact row reads
// the target row of another compact row.  Neumann stencils exclude other
// boundary points, and mg/gpu_backend.py checks it when it repacks a level
// (it raises otherwise); the pushdown runs out of place, and the scatter
// and the tail write a vector they never read.
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
constexpr int kThreadsPerCta = kWarp * kRowsPerCta;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// a product rounded on its own (never contracted into an add)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// (C x)_row, read to the row's lens, valid in lane 0
template <typename T>
__device__ __forceinline__ T row_sum(const T* __restrict__ vals,
                                     const int* __restrict__ cols,
                                     const int* __restrict__ lens, int width,
                                     int row, const T* x, int lane) {
  const size_t base = static_cast<size_t>(row) * width;
  const int len = lens[row];
  T acc = T(0);
  for (int k = lane; k < len; k += kWarp) {
    acc += vals[base + k] * x[cols[base + k]];
  }
  return warp_sum(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsPerCta)
compact_rows_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                    const int* __restrict__ lens, int width, int nrows,
                    const int* __restrict__ rows, const T* __restrict__ diag,
                    int n_pad,
                    const T* x,  // re-solve: aliases out, so no __restrict__
                    const T* __restrict__ b, T* out, int mode) {
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;  // whole warp leaves together
  const T acc = row_sum(vals, cols, lens, width, row, x, lane);
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
__global__ void __launch_bounds__(kThreadsPerCta)
ppe_tail_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ lens, int width, int m_pad,
                const int* __restrict__ rows, const int* __restrict__ slot,
                const unsigned char* __restrict__ live,
                const T* __restrict__ lagc, const T* __restrict__ xlag,
                const T* __restrict__ p, const T* __restrict__ q,
                const T* __restrict__ x, T* __restrict__ y, int n_pad,
                int row_ctas) {
  const T xl = *xlag;
  if (static_cast<int>(blockIdx.x) < row_ctas) {  // a row a thread
    const int r = blockIdx.x * kThreadsPerCta + threadIdx.x;
    if (r >= n_pad || slot[r] >= 0) return;  // a compact row's warp writes it
    const T v = live[r] ? p[r] + q[r] : x[r];
    y[r] = v + mul_rn(lagc[r], xl);
    return;
  }
  const int i = (blockIdx.x - row_ctas) * kRowsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= m_pad) return;  // whole warp leaves together
  const int r = rows[i];
  if (r < 0 || r >= n_pad) return;  // sentinel slot: nothing to write
  const T acc = row_sum(vals, cols, lens, width, i, x, lane);
  if (lane == 0) y[r] = (live[r] ? acc : x[r]) + mul_rn(lagc[r], xl);
}

template <typename T>
int launch_compact_rows(const T* vals, const int* cols, const int* lens,
                        int width, int nrows, const int* rows, const T* diag,
                        int n_pad, const T* x, const T* b, T* out, int mode,
                        void* stream) {
  if (nrows > 0) {
    const int grid = (nrows + kRowsPerCta - 1) / kRowsPerCta;
    compact_rows_kernel<T><<<grid, kThreadsPerCta, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        vals, cols, lens, width, nrows, rows, diag, n_pad, x, b, out, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ppe_tail(const T* vals, const int* cols, const int* lens, int width,
                    int m_pad, const int* rows, const int* slot,
                    const unsigned char* live, const T* lagc, const T* xlag,
                    const T* p, const T* q, const T* x, T* y, int n_pad,
                    void* stream) {
  if (n_pad > 0) {
    const int row_ctas = (n_pad + kThreadsPerCta - 1) / kThreadsPerCta;
    const int grid = row_ctas + (m_pad + kRowsPerCta - 1) / kRowsPerCta;
    ppe_tail_kernel<T><<<grid, kThreadsPerCta, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        vals, cols, lens, width, m_pad, rows, slot, live, lagc, xlag, p, q, x,
        y, n_pad, row_ctas);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MMP_COMPACT_ENTRIES(SUFFIX, T)                                         \
  extern "C" int mmp_compact_rows_##SUFFIX(                                    \
      const T* vals, const int* cols, const int* lens, int width, int nrows,   \
      const int* rows, const T* diag, int n_pad, const T* x, const T* b,       \
      T* out, int mode, void* stream) {                                        \
    return launch_compact_rows<T>(vals, cols, lens, width, nrows, rows, diag,  \
                                  n_pad, x, b, out, mode, stream);             \
  }                                                                            \
  extern "C" int mmp_ppe_tail_##SUFFIX(                                        \
      const T* vals, const int* cols, const int* lens, int width, int m_pad,   \
      const int* rows, const int* slot, const unsigned char* live,             \
      const T* lagc, const T* xlag, const T* p, const T* q, const T* x, T* y,  \
      int n_pad, void* stream) {                                               \
    return launch_ppe_tail<T>(vals, cols, lens, width, m_pad, rows, slot,      \
                              live, lagc, xlag, p, q, x, y, n_pad, stream);    \
  }

MMP_COMPACT_ENTRIES(f32, float)
MMP_COMPACT_ENTRIES(f64, double)
