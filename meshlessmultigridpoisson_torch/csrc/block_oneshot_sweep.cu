// block_oneshot_sweep<T>: one phase of the exact block Gauss-Seidel sweep.
//
// For every 128-row block `blk` of the phase:
//     t      = b - A x - lag_col * x_lag          (over the block's rows,
//                                                  reading x as it stands)
//     x_blk += K_blk t                            (128 x 128 product)
// where K_blk = (D/omega + L_blk)^-1 is the block's one-shot SOR matrix
// (L_blk the strictly-lower class coupling inside the block; rows the
// smoother does not update have zero K rows), stored TRANSPOSED as
// kT[blk][c][r] = K_blk[r][c] — the reference's `kinvT` orientation.
//
// Replaces two TPU kernels of the reference package:
//   meshlessmultigridpoisson_tpu/ops/kernels8.py:sor_sweep_tpu8  (fine
//     levels: colored block order; same-color blocks are independent, so a
//     phase = one color, one CTA per block, launched once per color)
//   meshlessmultigridpoisson_tpu/ops/kernels6.py:sor_sweep_tpu7  (coarsest
//     level: storage block order, each block sees the previous result; a
//     phase = all blocks, walked in order by a single CTA)
// The same code serves both: CTA i handles blocks i, i + gridDim.x, ... of
// the phase list, with a block barrier between consecutive blocks, so a
// grid of one CTA is the exact storage-order chain and a grid of one CTA
// per block is the parallel color phase.
//
// What bounds it on an H100: the K stream (64 KB per block in f32, the
// largest per-block read — about 78 MB per sweep of the 150k-row fine
// level) plus the gather of the block's ELL rows, and the serial chain of
// phases: the colored order needs one launch per color, the storage order
// one block after another on one SM.  This first version keeps both simple:
// the K product reads kT with consecutive threads on consecutive addresses
// (coalesced 512 B rows), the 512 threads split the 128 inputs in four
// quarters to keep every thread busy, and t lives in shared memory.  512
// threads per CTA (16 warps, 8 rows each for the gather) measured 1.7x
// faster per fine sweep than 256 and ahead of 1024 end to end on the slice
// (H100, PERF.md).  TMA/wgmma staging of K and fusing colors into a
// persistent kernel are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlk = 128;      // rows per block (the reference's lane width)
constexpr int kThreads = 512;  // 16 warps: 8 rows each for the gather
constexpr int kSplit = kThreads / kBlk;  // partial sums per output row

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_oneshot_sweep_kernel(const T* __restrict__ vals,
                           const int* __restrict__ cols, int width,
                           const T* __restrict__ b,
                           const T* __restrict__ lagc,
                           const T* __restrict__ xlag_ptr,
                           const T* __restrict__ kT,
                           const int* __restrict__ blk_ids, int nblk,
                           T* x) {  // read and written: no __restrict__
  __shared__ T t_s[kBlk];
  __shared__ T part[kThreads];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const T xlag = *xlag_ptr;

  for (int i = blockIdx.x; i < nblk; i += gridDim.x) {
    const int blk = blk_ids[i];
    const size_t row0 = static_cast<size_t>(blk) * kBlk;

    // t = b - A x - lag_col * x_lag: one warp per row
    for (int r = warp; r < kBlk; r += kThreads / kWarp) {
      const size_t base = (row0 + r) * static_cast<size_t>(width);
      T acc = T(0);
      for (int k = lane; k < width; k += kWarp) {
        acc += vals[base + k] * x[cols[base + k]];
      }
      acc = warp_sum(acc);
      if (lane == 0) t_s[r] = b[row0 + r] - acc - lagc[row0 + r] * xlag;
    }
    __syncthreads();

    // dx = K t: thread (h, r) sums inputs [h, h + 1) * kBlk / kSplit for
    // output row r; thread (0, r) adds the kSplit partial sums
    const int r = threadIdx.x % kBlk;
    const int h = threadIdx.x / kBlk;
    const T* kb = kT + static_cast<size_t>(blk) * kBlk * kBlk;
    T dx = T(0);
    for (int c = h * (kBlk / kSplit); c < (h + 1) * (kBlk / kSplit); ++c) {
      dx += kb[c * kBlk + r] * t_s[c];
    }
    part[threadIdx.x] = dx;
    __syncthreads();
    if (h == 0) {
      T acc = T(0);
      for (int q = 0; q < kSplit; ++q) acc += part[r + q * kBlk];
      x[row0 + r] += acc;
    }
    // the next block of this CTA (storage-order chain) reads the new rows
    __syncthreads();
  }
}

template <typename T>
int launch_sweep(const T* vals, const int* cols, int width, const T* b,
                 const T* lagc, const T* xlag, const T* kT,
                 const int* blk_ids, int nblk, int serial, T* x,
                 void* stream) {
  if (nblk > 0) {
    const int grid = serial ? 1 : nblk;
    block_oneshot_sweep_kernel<T><<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        vals, cols, width, b, lagc, xlag, kT, blk_ids, nblk, x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmp_block_sweep_f32(const float* vals, const int* cols,
                                   int width, const float* b,
                                   const float* lagc, const float* xlag,
                                   const float* kT, const int* blk_ids,
                                   int nblk, int serial, float* x,
                                   void* stream) {
  return launch_sweep<float>(vals, cols, width, b, lagc, xlag, kT, blk_ids,
                             nblk, serial, x, stream);
}

extern "C" int mmp_block_sweep_f64(const double* vals, const int* cols,
                                   int width, const double* b,
                                   const double* lagc, const double* xlag,
                                   const double* kT, const int* blk_ids,
                                   int nblk, int serial, double* x,
                                   void* stream) {
  return launch_sweep<double>(vals, cols, width, b, lagc, xlag, kT, blk_ids,
                              nblk, serial, x, stream);
}
