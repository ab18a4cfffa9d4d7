// Shared by block_oneshot_sweep.cu, block_smooth.cu and storage_chain.cu:
// the 128-row block, the warp reduction, the bf16-K arithmetic of the
// one-shot sweep, and the Hopper bulk copies (1-D TMA) on mbarriers.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

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

// ---- TMA and mbarrier (inline PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16; src and dst 16-byte aligned) from device memory
// into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a hint: bring bytes (a multiple of 16, src 16-byte aligned) into L2
__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

}  // namespace mmp_sweep
