// Kernel B4: masked exp(-d^2) similarities of queries to class prototypes.
//
// Replaces the TPU kernel adaptive_classifier_tpu/ops/knn.py:78
// `masked_sims_pallas` (pallas_call at :97, body `_knn_kernel` :62).
//
// Computes out[b, c] = valid[c] ? exp(-max(|q_b|^2 + |p_c|^2 - 2 q_b.p_c, 0)) : 0
// for q [B, D], p [C, D] f32 and valid [C] bool, out [B, C] f32, all
// row-major and contiguous.  Everything is f32 on the CUDA cores; TF32 is
// not used (its ~3 digits would move exp(-d^2) by ~1e-3 and reorder near
// neighbours).
//
// What bounds it on an H100: operations.  The function does 2*B*C*D FLOP
// against 4*(B*D + C*D + B*C) bytes; at the main path's B = 256, C = 16384,
// D = 512 that is 4.3 GFLOP (64 us at the 67 TFLOP/s f32 peak outside the
// tensor cores) against 50 MB (15 us at 3.35 TB/s).
//
// Design: one block of 256 threads per 64x64 output tile, the contraction
// in shared-memory steps of 16 columns (knn_tile.cuh: a 4x4 register tile per
// thread, the row norms taken from the same shared slices).  The clamp, the
// exp and the validity mask run on the accumulators in registers, so d^2
// never reaches device memory: the only write is the [B, C] result the
// function returns.  The Pallas wrapper's padding of B, C and D to 128 is a
// TPU tiling artifact; here the ragged edges are masked in the kernel.  A
// 4x4 f32 micro-tile on the CUDA cores leaves the kernel well below the f32
// peak; wider register tiles and asynchronous copies (cp.async/TMA) are the
// next steps.

#include <cuda_runtime.h>

#include "knn_tile.cuh"

namespace {

using namespace ac_knn;

__global__ void __launch_bounds__(THREADS)
masked_sims_kernel(const float* __restrict__ q, const float* __restrict__ p,
                   const unsigned char* __restrict__ valid,
                   float* __restrict__ out, int B, int C, int D) {
  __shared__ TileSmem s;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  float acc[4][4];
  dot_tile(q, p, B, C, D, row0, col0, s, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= B) continue;
    const float qn = s.qn[4 * ty + i];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + 4 * tx + j;
      if (c >= C) continue;
      out[(size_t)r * C + c] =
          valid[c] ? sim_from_dot(qn, s.pn[4 * tx + j], acc[i][j]) : 0.f;
    }
  }
}

}  // namespace

// q [B, D] f32, p [C, D] f32, valid [C] bool (one byte each), out [B, C]
// f32, all contiguous on the current device.  Returns the launch's
// cudaError_t.
extern "C" int ac_masked_sims(const float* q, const float* p,
                              const unsigned char* valid, float* out,
                              int B, int C, int D, void* stream) {
  if (B <= 0 || C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int row_tiles = (B + TM - 1) / TM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + TN - 1) / TN, row_tiles);
  masked_sims_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, p, valid, out, B, C, D);
  return (int)cudaGetLastError();
}
