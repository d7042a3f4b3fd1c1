// Copies and barriers shared by the two cluster kernels, santa_waves.cu and
// santa_scan.cu (Hopper, sm_90a).
//
// Rows are F = M(4k+1) floats, 648 B at (M, k) = (2, 20): not a multiple of
// 16 and only 4-byte aligned, so the copies into shared memory are 4-byte
// cp.async (16-byte cp.async and TMA would need a padded row stride).
//
// Cluster barrier. Every thread of the cluster arrives before any waits
// past it: the arrive (barrier.cluster.arrive.release, a MEMBAR.ALL.GPU and
// the arrive) releases the thread's earlier writes and completed reads, the
// wait (barrier.cluster.wait.acquire) acquires every arrived thread's across
// the cluster's SMs: sm_90a compiles it to the barrier wait and an L1
// invalidation (CCTL.IVALL), so a cp.async.ca after it reads what another
// SM wrote before its arrive.

#pragma once

namespace santa {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group are in
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The 64M threads of lane slot l of the block (named barrier 1 + l).
__device__ __forceinline__ void lane_sync(int l, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + l), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace santa
