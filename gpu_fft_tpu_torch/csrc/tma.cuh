// Bulk (TMA) copies into shared memory and the mbarriers that count them,
// shared by the kernels that keep a table on chip: S3, S2F, K3F and K3LF
// (dot_bf16.cuh) and K1F / K2F (whole_bf16.cu).
//
// One thread arms a barrier with the bytes it expects and issues the
// copies; the hardware counts each copy's bytes on the barrier as they
// land, and every thread that reads the table waits on the barrier's phase
// first.  A multicast copy lands at the same offset in the shared memory of
// every block of its cluster mask and counts on each block's barrier at the
// barrier's own offset, so the blocks of a cluster must have initialised
// their barriers (and made that visible with a cluster barrier) before any
// of them issues one.
#pragma once

#include <cstdint>

namespace gft {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialises the barrier at `bar` for `count` arrivals; mbar_init_fence
// then makes the block's initialisations visible to the async proxy and to
// the cluster (one fence after all of them).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival at `bar` that also expects `bytes` more to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// A bulk copy of `bytes` from global `src` to shared `dst`; the barrier at
// `bar` counts the bytes as they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same copy landing in every block of the cluster whose bit is set in
// `mask`, at `dst`'s offset, counted on each one's barrier at `bar`'s.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Waits until the barrier at `bar` completes the phase of parity `parity`
// (its first phase: 0, the next: 1, and so on alternately).
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Waits until the barrier at `bar` completes its first phase.
__device__ __forceinline__ void wait_phase0(uint32_t bar) { wait_parity(bar, 0); }

}  // namespace gft
