// Shared by block_oneshot_sweep.cu and block_smooth.cu: the 128-row block,
// the warp reduction and the bf16-K arithmetic of the one-shot sweep.
#pragma once

#include <cuda_bf16.h>

namespace mmp_sweep {

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

// K element and product input in the accumulation type T: identity when K
// is stored in T; bf16 K widens exactly and rounds t to bf16 first
template <typename T>
__device__ __forceinline__ T k_val(T k) { return k; }
__device__ __forceinline__ float k_val(__nv_bfloat16 k) {
  return __bfloat162float(k);
}
template <typename T, typename KT>
__device__ __forceinline__ T t_in(T t) { return t; }
template <>
__device__ __forceinline__ float t_in<float, __nv_bfloat16>(float t) {
  return __bfloat162float(__float2bfloat16(t));
}

}  // namespace mmp_sweep
