// Hopper's asynchronous path, as kernel B4 (knn_sims.cu) uses it, written
// for reuse by the other kernels: mbarriers, TMA tile loads, warpgroup
// matrix products (wgmma) on operands in shared memory, register hand-over
// between warpgroups (setmaxnreg), and the 3xTF32 split of an f32 operand.
// sm_90a only (wgmma and setmaxnreg do not exist for plain sm_90).
//
// Layout that the helpers assume: an operand tile of R rows and 32 f32
// columns (128 bytes a row), row-major ("K-major": the contraction runs
// along the row), as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B: each
// 128-byte row is one swizzle atom, its eight 16-byte chunks permuted by
// chunk ^ (row % 8), and every tile starts on a 1024-byte boundary.  The
// wgmma descriptor of such a tile (sw128_desc) steps 1024 bytes from one
// group of 8 rows to the next; a step of 8 columns (k8 for TF32, 32 bytes)
// advances its start address by 32 bytes and the hardware applies the
// same permutation.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "common.cuh"

namespace ac_hopper {

using ac_common::smem_addr;

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// counts its phase before the first as completed, so a producer waits on
// an empty slot with parity 1 on its first round.  The polling loop is
// inside one asm block: to the compiler a straight line, so no branch sits
// between a wgmma and its wait_group.  After 2^26 polls it traps, so a
// fault in the protocol fails the launch instead of holding the card.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred ready;\n.reg .u32 polls;\nmov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], %1;\n"
      "@ready bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.lt.u32 ready, polls, 67108864;\n"
      "@ready bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// tile of the 2-D tensor map at element coordinates (x = column, y = row)
// -> shared memory; completes `bytes` of the barrier's transactions (rows
// and columns outside the tensor arrive as zeros and count all the same)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(smem_addr(bar))
      : "memory");
}

// box of the 4-D tensor map at element coordinates (c0 innermost) ->
// shared memory, as tma_load_2d
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands written by ordinary stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// box of the 2-D tensor map at element coordinates (x = column, y = row)
// <- shared memory (as tma_load_2d lays it out); rows and columns outside
// the tensor are not written.  Completes in the thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int x,
                                             int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(x), "r"(y)
      : "memory");
}

// bytes (a multiple of 16) of global memory from p (16-byte aligned) into
// the L2, asynchronously, with nothing to wait on
__device__ __forceinline__ void bulk_prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(reinterpret_cast<uint64_t>(p)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// thread block clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster: arrive, then wait for all (release, acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of `p` (a shared variable of this block) in
// the block of rank `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

// one arrival on a barrier of another block of the cluster (its
// shared::cluster address), releasing this thread's prior writes at
// cluster scope
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait_phase with acquire at cluster scope: for phases completed by the
// arrivals of other blocks of the cluster
__device__ __forceinline__ void wait_phase_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred ready;\n.reg .u32 polls;\nmov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 ready, [%0], %1;\n"
      "@ready bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.lt.u32 ready, polls, 67108864;\n"
      "@ready bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------------------
// warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// (see the top): start address >> 4 in bits 0-13, leading byte offset
// (unused for a swizzled K-major tile; 1 by convention) in bits 16-29,
// stride byte offset 1024 >> 4 (8 rows of 128 bytes) in bits 32-45,
// swizzle mode 1 (128 bytes) in bits 62-63.  Adding n to the descriptor
// moves its start by 16 n bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3ffffu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Tie the accumulator registers to this point: the compiler may neither
// read them before an earlier wgmma_wait nor move them across it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64] (+)= A[64 x 8] . B[128 x 8]^T, TF32 operands from shared memory
// (both K-major), f32 accumulators: with scale_d 0 the product overwrites
// d.  Thread t of the warpgroup holds, for j = 0..15, rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4j] (row, col), d[4j+1] (row, col+1), d[4j+2] (row+8, col),
// d[4j+3] (row+8, col+1).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// ---------------------------------------------------------------------------
// the 3xTF32 split
// ---------------------------------------------------------------------------

// The tensor cores read an f32 in shared memory as TF32 by keeping its top
// 19 bits: hi(x) = x with the low 13 bits cleared.  tf32_rest(x) = x - hi(x),
// exact in f32, rounded to the nearest TF32 value: the lo operand, so that
// hi.lo + lo.hi + hi.hi carries x.y to ~2^-20 of |x||y| (the lo.lo term
// and the rounding of lo dropped).
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ float tf32_rest(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x - tf32_hi(x)));
  return __uint_as_float(r);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda by the runtime's entry-point
// query, so that a library built by one nvcc call needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Bind the current device's primary context to the calling host thread.
// The encoder (libcuda's cuTensorMapEncodeTiled) fails with
// CUDA_ERROR_INVALID_CONTEXT in a host thread that has no context current.
// The runtime binds the device's primary context to a thread only at that
// thread's first call that needs it, and a launch from a new thread (a
// serving worker) whose tensors all came from PyTorch's allocator cache
// may reach the encoder first: cudaSetDevice binds it (CUDA 12).
inline cudaError_t bind_device(int* device) {
  cudaError_t err = cudaGetDevice(device);
  return err == cudaSuccess ? cudaSetDevice(*device) : err;
}

// What launches of one kernel need to know of a device (its SMs, the
// shared memory a block may take, the kernel's attributes set there),
// made by make(device, &value) on the kernel's first launch on the current
// device and kept: later launches there read it back without asking the
// CUDA runtime.  Keyed by device only (up to 16; past that, made every launch).
template <typename T>
class PerDevice {
 public:
  template <typename Make>
  cudaError_t get(T* out, Make make) {
    int device = 0;
    cudaError_t err = bind_device(&device);
    if (err != cudaSuccess) return err;
    if (device >= N) return make(device, out);
    if (!made_[device].load(std::memory_order_acquire)) {
      std::lock_guard<std::mutex> lock(mu_);
      if (!made_[device].load(std::memory_order_relaxed)) {
        err = make(device, &value_[device]);
        if (err != cudaSuccess) return err;
        made_[device].store(true, std::memory_order_release);
      }
    }
    *out = value_[device];
    return cudaSuccess;
  }

 private:
  static constexpr int N = 16;
  T value_[N] = {};
  std::atomic<bool> made_[N] = {};
  std::mutex mu_;
};

// Tensor map of a row-major f32 matrix [rows, cols] (cols % 4 == 0, ptr
// 16-byte aligned) read in boxes of box_rows x 32 columns, 128-byte swizzle,
// zeros outside the matrix.
inline cudaError_t f32_rows_map(CUtensorMap* map, const float* ptr, int rows, int cols,
                                int box_rows) {
  int device = 0;
  const cudaError_t bound = bind_device(&device);
  if (bound != cudaSuccess) return bound;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                          const_cast<float*>(ptr), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ac_hopper
