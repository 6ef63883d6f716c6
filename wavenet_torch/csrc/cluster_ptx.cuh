// PTX helpers of the thread-block-cluster decode kernels (sampler_cluster.cu,
// sampler_tiles.cu): shared-memory addresses, mbarriers, and asynchronous
// stores into another CTA's shared memory that complete on its mbarrier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The address of `p` (in this CTA's shared memory) in CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// This CTA's arrival on its own mbarrier for a phase that also waits for
// `bytes` of asynchronous stores.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Store v at `addr` in another CTA's shared memory; the store completes
// its bytes on the mbarrier at `remote_bar` in that CTA.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

// Wait for the phase of `parity` to complete. A wait of more than ~2**36
// cycles (tens of seconds) is a fault, reported as one rather than a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 36)) __trap();
  }
}

}  // namespace
