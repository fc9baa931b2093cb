// The score of a query-prototype pair, shared by kernels B4 (knn_sims.cu)
// and B5 (knn_topk.cu):
//     d2 = max(|q|^2 + |p|^2 - 2 q.p, 0)
// the expansion the TPU kernels use (adaptive_classifier_tpu/ops/knn.py:62-74,
// ops/knn_topk.py:75-85), not the sum of (q - p)^2.
//
// Both kernels form q.p on the tensor cores in three TF32 products a pair,
// each slice's products summed apart and IEEE-added to the running dot
// product: B4 by wgmma from shared memory (knn_sims.cu, hopper.cuh), B5 by
// mma.sync from registers (knn_topk.cu).  Both errors are at f32's level
// (~1e-7 on unit rows), so a pair's two scores may differ in their last
// bits; each kernel is held to its plain version to 1e-5.
#pragma once

#include <cuda_runtime.h>

namespace ac_knn {

// exp(-max(|q|^2 + |p|^2 - 2 q.p, 0)) for one pair
__device__ __forceinline__ float sim_from_dot(float qn, float pn, float dot) {
  const float d2 = fmaxf(qn + pn - 2.f * dot, 0.f);
  return expf(-d2);
}

}  // namespace ac_knn
