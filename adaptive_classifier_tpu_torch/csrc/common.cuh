// Pieces shared by the bf16 attention tile loop (attention_tile.cuh) and the
// int8 weight ring (int8_tile.cuh): asynchronous copies into shared memory
// (16-byte cp.async), ldmatrix, and the host-side report of a kernel's
// instantiation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ac_common {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most n (0, 1 or 2; a constant once the caller's loop is
// unrolled) committed groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each); lanes
// 8j .. 8j + 7 give the row addresses of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// two such matrices; lanes 8j .. 8j + 7 give the rows of matrix j
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// info: registers per thread, shared bytes per block (dynamic + static),
// threads per block, blocks resident per SM, local (spill) bytes per thread
template <typename Kernel>
cudaError_t kernel_info(Kernel* kernel, size_t smem, int threads, int* info) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return err;
  // raise the kernel's cap on dynamic shared memory to smem, never lower
  // it: a launch may have raised it further
  if (at.maxDynamicSharedSizeBytes < (int)smem)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = at.numRegs;
  info[1] = (int)(smem + at.sharedSizeBytes);
  info[2] = threads;
  info[3] = blocks;
  info[4] = (int)at.localSizeBytes;
  return err;
}

}  // namespace ac_common
