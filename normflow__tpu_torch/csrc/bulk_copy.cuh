// Hopper's asynchronous bulk copies between global and shared memory, and
// the mbarrier that a load completes on (PTX ISA 8.0, sm_90), and the
// kernels' dynamic shared memory.  Used by the tiled kernels
// (rqs_coupling.cu, rqs_coupling_bwd.cu, phi4_action.cu); the copies need
// no tensor map, so
// the library links nothing beyond the CUDA runtime.
//
// - A load `bulk_load` moves `bytes` (a multiple of 16, both addresses
//   16-byte aligned) from global to shared memory and counts them off the
//   mbarrier's expected transaction bytes, set by `mbar_arrive_expect_tx`;
//   `mbar_wait` returns once that phase of the barrier has completed.
// - A store `bulk_store` moves bytes from shared to global memory in the
//   issuing thread's bulk group; `bulk_commit` closes the group,
//   `bulk_wait_read` waits until the shared source of every committed group
//   may be overwritten, `bulk_wait_all` until the writes are done.
// - Threads that wrote shared memory with ordinary stores make the writes
//   visible to the copy engine with `fence_proxy_async` before the barrier
//   that precedes the store.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The kernel's dynamic shared memory, 128-byte aligned.
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char nf_dynamic_smem[];
  return nf_dynamic_smem;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "NF_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra NF_WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace
