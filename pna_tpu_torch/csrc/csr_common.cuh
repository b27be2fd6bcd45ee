// What all four kernels share: index clamping, a launch that may ask for
// more than 48 KB of dynamic shared memory, and asynchronous copies from
// device to shared memory (cp.async, the LDGSTS path: the bytes go to shared
// memory without passing through registers, and a thread can have many in
// flight).
//
// With -DPNA_HOST_CHECK the sources compile with a host C++ compiler against a
// stub cuda_runtime.h that runs a block's threads as OS threads; cp.async is
// then a plain copy and its waits do nothing.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdlib>

namespace pna {

constexpr int kWarp = 32;
// dynamic shared memory of a block: 227 KB less the kernels' static tables
constexpr size_t kSmemLimit = 225 * 1024;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// 4 bytes (any float address) or 16 bytes (both addresses 16-byte aligned)
// from device to shared memory, asynchronously; the 16-byte form bypasses L1.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
#ifdef PNA_HOST_CHECK
  *dst = *src;
#else
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#endif
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
#ifdef PNA_HOST_CHECK
  // the card faults on a misaligned 16-byte copy, and so does the check
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
      15) {
    abort();
  }
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#else
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#endif
}

// Closes the group of this thread's copies started so far.
__device__ __forceinline__ void cp_async_commit() {
#ifndef PNA_HOST_CHECK
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most kPending of this thread's groups are unfinished.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
#ifndef PNA_HOST_CHECK
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
#endif
}

// Launches `kernel` on `st`, allowing it the dynamic shared memory it asks
// for.
template <typename Kernel, typename... Args>
cudaError_t launch_dynamic(Kernel kernel, dim3 grid, dim3 block, size_t smem,
                           cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<grid, block, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace pna
