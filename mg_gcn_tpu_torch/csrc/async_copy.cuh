// Asynchronous copies into shared memory, their barriers, and the launch
// geometry report, shared by the kernels that stage operands in a ring of
// shared-memory stages: pattern_fwd.cuh (spmm_pattern.cu,
// spmm_pattern_ring.cu), spmm_pattern_sparse.cu and spmm_tiled.cu; the row
// walk of csr_walk.cuh reports its geometry through write_geometry too.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies N bytes (4, 8 or 16) from ``src`` to shared address ``dst``
// through L1; the last N - src_bytes bytes are filled with zeros.
template <int N>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, int src_bytes = N) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

// Copies 16 bytes from ``src`` to shared address ``dst``, bypassing L1;
// the last 16 - src_bytes bytes are filled with zeros.
__device__ __forceinline__ void cp_async_cg16(uint32_t dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// Closes the thread's copies issued since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Has the barrier at ``bar`` count one arrival when the thread's copies
// issued so far have landed (no pending-count increment: the barrier's
// init count includes it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Writes the launch geometry of ``kernel`` with ``threads`` threads and
// ``smem`` bytes of dynamic shared memory over ``grid`` to out[0..6]: grid
// x, grid y, threads, dynamic shared memory, stages, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and resident blocks on
// the card (at most the grid's). Returns a cudaError_t.
template <typename Kernel>
cudaError_t write_geometry(Kernel kernel, int threads, int smem, dim3 grid, int stages, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)grid.x * grid.y, resident = (long long)per_sm * sms;
  const int vals[7] = {(int)grid.x, (int)grid.y, threads, smem, stages, per_sm,
                       (int)(blocks < resident ? blocks : resident)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
}

}  // namespace async_copy
