// Asynchronous copies into shared memory and the mbarriers that track them,
// for the kernels of this directory (sm_90a).
//
//  - cp.async of 4 or 16 bytes by a thread (zero-filled when the source is
//    out of range), grouped by commit / wait, or reported to an mbarrier;
//  - bulk copies by the TMA engine: contiguous bytes (cp.async.bulk) or a
//    box of a tensor described by a CUtensorMap (cp.async.bulk.tensor), each
//    completing transaction bytes on an mbarrier;
//  - mbarrier init, arrive (plain, or with the bytes a phase also waits
//    for), and a wait on a phase's parity;
//  - the proxy fence a consumer of a TMA-filled stage needs before it
//    releases the stage.
#pragma once

#include <cuda.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes, zero-filled (nothing read) when ok is false.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// An arrive on bar once every cp.async this thread issued so far has landed;
// it is one of the arrivals the barrier was initialised to expect (.noinc).
__device__ __forceinline__ void copy_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A phase of bar completes after `count` arrivals and the transaction bytes
// announced in it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive, and add `bytes` that the TMA engine will complete on bar.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Arrive with `bytes` and copy them, contiguous, by the TMA engine.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"(smem_addr(dst)), "l"(src)
      : "memory");
}

// Copy `bytes` contiguous bytes by the TMA engine, completing them on bar,
// whose phase must expect them (mbar_expect).
__device__ __forceinline__ void bulk_copy_tx(void* dst, const void* src,
                                             unsigned bytes,
                                             unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The box at element coordinates (c0, c1, c2) of the tensor map (innermost
// first) into dst, by the TMA engine; elements outside the tensor are zeros.
// The map must be a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tensor_copy_3d(void* dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2,
                                               unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory (its reads
// of a stage) before later async-proxy ones (the TMA writes that refill the
// stage once it is released).  Without it a producer's refill can overwrite
// a stage under a consumer that is still reading it: the mbarrier's
// release and acquire order the generic proxy only.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

}  // namespace
