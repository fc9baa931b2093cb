// One 64x64 tile of query-prototype dot products and row norms, in f32 on
// the CUDA cores (kernel B4, knn_sims.cu), and the score of a pair, shared
// by kernels B4 and B5 (knn_topk.cu):
//     d2 = max(|q|^2 + |p|^2 - 2 q.p, 0)
// the expansion the TPU kernels use (adaptive_classifier_tpu/ops/knn.py:62-74,
// ops/knn_topk.py:75-85), not the sum of (q - p)^2.
//
// B4 and B5 now form q.p differently: B4 by f32 FMAs in dot_tile below, B5
// on the tensor cores in three TF32 products a pair (knn_topk.cu).  Both
// errors are at f32's level (~1e-7 on unit rows), so a pair's two scores
// may differ in their last bits; each kernel is held to its plain version
// to 1e-5.
//
// dot_tile: a block of 256 threads walks the contraction in steps of TK
// columns.  Each step copies a [64, TK] slice of the queries and of the
// prototypes from device memory into shared memory, stored k-major so that
// a thread reads its four rows of a column as one 16-byte load.  Thread
// (ty, tx) of the 16x16 thread grid accumulates the 4x4 outputs at rows
// 4ty..4ty+3 and columns 4tx..4tx+3.  While the slices sit in shared
// memory, threads 0-63 add the squares of one query row's slice and
// threads 64-127 those of one prototype row's, so the norms cost no second
// read of device memory.  Rows past B or C and columns past D load as zero:
// any B, C and D work and the ragged edges need no padding by the caller.
// No TF32: every product and sum is an f32 FMA.
#pragma once

#include <cuda_runtime.h>

namespace ac_knn {

constexpr int TM = 64;        // query rows per tile
constexpr int TN = 64;        // prototype rows per tile
constexpr int TK = 16;        // contraction columns per shared-memory step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDS = TM + 4;   // padded row of the k-major tiles (16-byte aligned)

static_assert(TM == TN, "one loader covers both tiles");
static_assert(TM * TK == 4 * THREADS, "each thread loads four elements per tile");

struct __align__(16) TileSmem {
  float a[TK][LDS];   // queries, k-major
  float b[TK][LDS];   // prototypes, k-major
  float qn[TM];       // |q|^2 of the tile's query rows
  float pn[TN];       // |p|^2 of the tile's prototype rows
};

// acc[i][j] = q[row0 + 4ty + i] . p[col0 + 4tx + j]; on return s.qn and s.pn
// hold the tile's squared row norms, and every thread has passed a barrier
// after writing them.
__device__ __forceinline__ void dot_tile(const float* __restrict__ q,
                                         const float* __restrict__ p,
                                         int B, int C, int D, int row0, int col0,
                                         TileSmem& s, float acc[4][4]) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;

  for (int k0 = 0; k0 < D; k0 += TK) {
    #pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = t + r * THREADS;
      const int row = e / TK, k = e % TK;
      const int gk = k0 + k;
      const int gq = row0 + row, gp = col0 + row;
      s.a[k][row] = (gq < B && gk < D) ? q[(size_t)gq * D + gk] : 0.f;
      s.b[k][row] = (gp < C && gk < D) ? p[(size_t)gp * D + gk] : 0.f;
    }
    __syncthreads();
    if (t < TM) {
      #pragma unroll
      for (int k = 0; k < TK; ++k) norm = fmaf(s.a[k][t], s.a[k][t], norm);
    } else if (t < TM + TN) {
      #pragma unroll
      for (int k = 0; k < TK; ++k) norm = fmaf(s.b[k][t - TM], s.b[k][t - TM], norm);
    }
    #pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&s.a[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[k][4 * tx]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (t < TM) s.qn[t] = norm;
  else if (t < TM + TN) s.pn[t - TM] = norm;
  __syncthreads();
}

// exp(-max(|q|^2 + |p|^2 - 2 q.p, 0)) for one pair
__device__ __forceinline__ float sim_from_dot(float qn, float pn, float dot) {
  const float d2 = fmaxf(qn + pn - 2.f * dot, 0.f);
  return expf(-d2);
}

}  // namespace ac_knn
