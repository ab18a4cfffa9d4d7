// block_oneshot_sweep<T, KT>: one phase of the exact block Gauss-Seidel sweep.
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
// The parent design of two kernels that now run elsewhere, kept as
// timing-only roles (the bench and chip_smoke.py time each beside its
// redesign):
//   "sweep6_chain": the storage-order chain on one CTA, the parent of
//     storage_chain.cu (roles "sweep6", meshlessmultigridpoisson_tpu/ops/
//     kernels6.py:515 sor_sweep_tpu6, which on the TPU reloads each block's
//     x patches instead of keeping an 8-block union in a <= 32-slot
//     scratch, a VMEM constraint, not math; and "sweep5", ops/kernels4.py:620
//     sor_sweep_tpu5, probes.ktime);
//   "sweep8_percolor": the colored sweep (kernels8.py sor_sweep_tpu8), one
//     launch per color, the parent of block_smooth.cu's colored_smooth; the
//     coarsest storage-order sweep (kernels6.py sor_sweep_tpu7) runs in
//     block_smooth.cu's coarse_smooth.
// CTA i handles blocks i, i + gridDim.x, ... of the phase list, with a
// block barrier between consecutive blocks, so a grid of one CTA is the
// exact storage-order chain and a grid of one CTA per block is one color's
// parallel phase.  (The sweep probe's modes run on storage_chain.cu.)
//
// K in bf16 (`solve --fast-k`): the instance with KT = __nv_bfloat16 takes
// f32 vals/x/b/lag_col and computes what the TPU's fast mode computes
// (kernels6.py:500-504, kernels8.py:350): t rounded to bf16, each product of
// two bf16 values exact in f32, the sum in f32.
//
// What bounds it on an H100.  Colored order: the K stream (64 KB per block
// in f32, 32 KB in bf16 — about 68 MB per f32 sweep of the 133k-row fine
// level) plus the gather of the block's ELL rows, and one launch per color.
// Storage order: the serial chain — one block after another on one SM, each
// a gather, a barrier, a 128 x 128 product and a barrier, ~13 us per block
// (H100, PERF.md), 13.6 ms per sweep of the 1,041-block 133k level; the
// card's other 131 SMs idle.  This first version keeps both simple: the K product
// reads kT with consecutive threads on consecutive addresses (coalesced
// 512 B rows in f32), the 512 threads split the 128 inputs in four quarters
// to keep every thread busy, and t lives in shared memory.  512 threads per
// CTA (16 warps, 8 rows each for the gather) measured 1.7x faster per fine
// sweep than 256 and ahead of 1024 end to end on the slice (H100, PERF.md).
// block_smooth.cu stages K by TMA and fuses a smoother call's colors and
// sweeps into one launch; storage_chain.cu shortens the storage-order
// chain's link (K and ELL rows fetched ahead, all 128 rows gathered at
// once, each row read to its last nonzero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_sweep_common.cuh"

namespace {

using mmp_sweep::k_val;
using mmp_sweep::kBlk;
using mmp_sweep::kSplit;
using mmp_sweep::kThreads;
using mmp_sweep::kWarp;
using mmp_sweep::t_in;
using mmp_sweep::warp_sum;

// (A x)_row by one warp, valid in lane 0
template <typename T>
__device__ __forceinline__ T row_sum(const T* __restrict__ vals,
                                     const int* __restrict__ cols, int width,
                                     const T* x, size_t row, int lane) {
  T acc = T(0);
  const size_t base = row * static_cast<size_t>(width);
  for (int k = lane; k < width; k += kWarp) {
    acc += vals[base + k] * x[cols[base + k]];
  }
  return warp_sum(acc);
}

// x_blk += K_blk t (t in shared memory): thread (h, r) sums inputs
// [h, h + 1) * kBlk / kSplit for output row r; thread (0, r) adds the
// kSplit partial sums.  Ends with the block barrier.
template <typename T, typename KT>
__device__ __forceinline__ void add_k_product(const KT* __restrict__ kb,
                                              const T* t_s, T* part, T* x,
                                              size_t row0) {
  const int r = threadIdx.x % kBlk;
  const int h = threadIdx.x / kBlk;
  T dx = T(0);
  for (int c = h * (kBlk / kSplit); c < (h + 1) * (kBlk / kSplit); ++c) {
    dx += k_val(kb[c * kBlk + r]) * t_s[c];
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

template <typename T, typename KT>
__global__ void __launch_bounds__(kThreads)
block_oneshot_sweep_kernel(const T* __restrict__ vals,
                           const int* __restrict__ cols, int width,
                           const T* __restrict__ b,
                           const T* __restrict__ lagc,
                           const T* __restrict__ xlag_ptr,
                           const KT* __restrict__ kT,
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
      const T acc = row_sum(vals, cols, width, x, row0 + r, lane);
      if (lane == 0) {
        t_s[r] = t_in<T, KT>(b[row0 + r] - acc - lagc[row0 + r] * xlag);
      }
    }
    __syncthreads();
    add_k_product<T, KT>(kT + static_cast<size_t>(blk) * kBlk * kBlk, t_s,
                         part, x, row0);
  }
}

template <typename T, typename KT>
int launch_sweep(const T* vals, const int* cols, int width, const T* b,
                 const T* lagc, const T* xlag, const KT* kT,
                 const int* blk_ids, int nblk, int serial, T* x,
                 void* stream) {
  if (nblk > 0) {
    const int grid = serial ? 1 : nblk;
    block_oneshot_sweep_kernel<T, KT>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  return launch_sweep<float, float>(vals, cols, width, b, lagc, xlag, kT,
                                    blk_ids, nblk, serial, x, stream);
}

extern "C" int mmp_block_sweep_f64(const double* vals, const int* cols,
                                   int width, const double* b,
                                   const double* lagc, const double* xlag,
                                   const double* kT, const int* blk_ids,
                                   int nblk, int serial, double* x,
                                   void* stream) {
  return launch_sweep<double, double>(vals, cols, width, b, lagc, xlag, kT,
                                      blk_ids, nblk, serial, x, stream);
}

extern "C" int mmp_block_sweep_f32_bf16k(const float* vals, const int* cols,
                                         int width, const float* b,
                                         const float* lagc, const float* xlag,
                                         const __nv_bfloat16* kT,
                                         const int* blk_ids, int nblk,
                                         int serial, float* x, void* stream) {
  return launch_sweep<float, __nv_bfloat16>(vals, cols, width, b, lagc, xlag,
                                            kT, blk_ids, nblk, serial, x,
                                            stream);
}
