// Kernels B2 and B9: the int8 projections of the encoder layer.
//
// B2 replaces the TPU kernel adaptive_classifier_tpu/ops/matmul_int8.py:80
// `quant_matmul_int8` (pallas_call at :94, body `_matmul_kernel` :48):
//     out[M, N] = (q(x) @ w_q) * x_scale * w_scale + b        (in x's type)
// with q(x) the per-row symmetric int8 quantization of x (scale = absmax *
// (1/127), floor 1e-8), w_q [K, N] int8 with per-output-channel scales,
// and an int32 accumulator.  It is the fused QKV projection of the int8
// forward (models/encoder_int8.py:165): K = D = 512, N = 3D = 1536.
//
// B9 replaces ops/matmul_int8.py:115 `proj_residual_ln_int8` (pallas_call
// at :135, body `_proj_ln_kernel` :59):
//     out[M, D] = LayerNorm(q(x) @ w_q * x_scale * w_scale + b + res)
// with f32 statistics, in x's type.  No path of either package calls it
// (the JAX package's only caller is its test); it is held against its
// plain version.
//
// What bounds B2 on an H100: bytes.  At the banking chunk (M = 8,192) the
// function reads M*K*2 + K*N + 8N bytes and writes M*N*2: 34.4 MB, 10.3 us
// at 3.35 TB/s, against 2*M*K*N = 12.9 GOP, 6.5 us at the 1,979 TOP/s int8
// tensor-core peak.  B9 at the same M: 6*M*D + D*D bytes, 25.4 MB, 7.6 us.
//
// Design.  The Pallas kernel is weight-stationary: one grid step holds the
// whole [K, N] weight in VMEM.  Here the 0.75 MB of QKV weights stay in the
// 50 MB L2, and each block owns a tile of rows instead: B2's block
// quantizes its 64 rows of x once into shared memory (int8, one scale per
// row) and walks N in 64-column tiles, staging [512, 64] weight slices
// transposed into shared memory (int8_tile.cuh) and multiplying with
// mma.sync.m16n8k32 (s8 x s8 -> s32); its 8 warps each own a 32 x 16 piece
// of the 64 x 64 output tile.  The int8 operands and the int32 sums are
// exactly the plain version's; the epilogue rounds each step as it does.
// Each weight byte is read from L2 once per row tile (M/64 times), which
// with mma.sync (no wgmma, no TMA, no pipelined copies) keeps the kernel
// above its byte bound.  B9 uses 16-row tiles and the same walk over its
// D output columns, adds the residual and the bias in f32 into a [16, D]
// f32 tile in shared memory, then normalizes each row with one warp.
// Ragged M is masked in the kernel: no padding to a tile multiple.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace ac_int8;

constexpr int B2_ROWS = 64;
constexpr int B9_ROWS = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ ws, const float* __restrict__ bias,
                    T* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = K + 16;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + B2_ROWS * lda);
  int8_t* bs = reinterpret_cast<int8_t*>(xs + B2_ROWS);
  const int m0 = blockIdx.x * B2_ROWS;

  quant_rows_global<true>(x, M, K, m0, B2_ROWS, xq, lda, xs);
  gemm_rows<2, 2, 4>(xq, lda, w, K, N, bs,
      [&](int n0, int row0, int col0, int (&acc)[2][2][4]) {
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int n = 0; n < 2; ++n)
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = row0 + 16 * m + acc_row(i);
              const int c = n0 + col0 + 8 * n + acc_col(i);
              if (m0 + r < M)
                out[(size_t)(m0 + r) * N + c] =
                    from_f32<T>(dequant(acc[m][n][i], xs[r], ws[c], bias[c]));
            }
      });
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
proj_residual_ln_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ ws, const float* __restrict__ bias,
                        const T* __restrict__ res, const float* __restrict__ g,
                        const float* __restrict__ beta, float eps,
                        T* __restrict__ out, int M, int D) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldy = D + 4;
  const int lda = D + 16;
  float* ys = reinterpret_cast<float*>(smem);
  int8_t* xq = reinterpret_cast<int8_t*>(ys + B9_ROWS * ldy);
  float* xs = reinterpret_cast<float*>(xq + B9_ROWS * lda);
  int8_t* bs = reinterpret_cast<int8_t*>(xs + B9_ROWS);
  const int m0 = blockIdx.x * B9_ROWS;

  quant_rows_global<true>(x, M, D, m0, B9_ROWS, xq, lda, xs);
  gemm_rows<1, 1, 8>(xq, lda, w, D, D, bs,
      [&](int n0, int row0, int col0, int (&acc)[1][1][4]) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + acc_row(i);
          const int c = n0 + col0 + acc_col(i);
          const float rv = m0 + r < M ? to_f32(res[(size_t)(m0 + r) * D + c]) : 0.f;
          ys[r * ldy + c] = __fadd_rn(dequant(acc[0][0][i], xs[r], ws[c], bias[c]), rv);
        }
      });
  __syncthreads();
  layer_norm_rows<true>(ys, ldy, D, B9_ROWS, g, beta, eps, out, m0, M);
}

size_t quant_matmul_smem(int K) {
  return (size_t)B2_ROWS * (K + 16) + B2_ROWS * sizeof(float) + TN * (MAX_TKS + 16);
}

size_t proj_ln_smem(int D) {
  return (size_t)B9_ROWS * (D + 4) * sizeof(float) + (size_t)B9_ROWS * (D + 16) +
         B9_ROWS * sizeof(float) + TN * (MAX_TKS + 16);
}

template <typename T>
cudaError_t launch_matmul(const void* x, const int8_t* w, const float* ws,
                          const float* b, void* out, int M, int K, int N,
                          cudaStream_t stream) {
  const size_t smem = quant_matmul_smem(K);
  cudaError_t err = cudaFuncSetAttribute(
      quant_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + B2_ROWS - 1) / B2_ROWS;
  quant_matmul_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, ws, b, static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_proj_ln(const void* x, const int8_t* w, const float* ws,
                           const float* b, const void* res, const float* g,
                           const float* beta, float eps, void* out, int M, int D,
                           cudaStream_t stream) {
  const size_t smem = proj_ln_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      proj_residual_ln_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + B9_ROWS - 1) / B9_ROWS;
  proj_residual_ln_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, ws, b, static_cast<const T*>(res), g, beta, eps,
      static_cast<T*>(out), M, D);
  return cudaGetLastError();
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % 128 != 0 || N % TN != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  x [M, K], w [K, N]
// int8, ws and b [N] f32, out [M, N], all contiguous on the current
// device; K % 128 == 0, N % 64 == 0.  Returns the launch's cudaError_t.
extern "C" int ac_quant_matmul_int8(const void* x, const void* w, const void* ws,
                                    const void* b, void* out, int M, int K, int N,
                                    int dtype, void* stream) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(ws);
  const float* bb = static_cast<const float*>(b);
  switch (dtype) {
    case 0: return (int)launch_matmul<float>(x, wq, s, bb, out, M, K, N, st);
    case 1: return (int)launch_matmul<__nv_bfloat16>(x, wq, s, bb, out, M, K, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype as above, of x, res and out.  x, res, out [M, D]; w [D, D] int8;
// ws, b, g, beta [D] f32; D % 128 == 0.  Returns the launch's cudaError_t.
extern "C" int ac_proj_residual_ln_int8(const void* x, const void* w, const void* ws,
                                        const void* b, const void* res, const void* g,
                                        const void* beta, float eps, void* out, int M,
                                        int D, int dtype, void* stream) {
  if (bad_shape(M, D, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(ws);
  const float* bb = static_cast<const float*>(b);
  const float* gg = static_cast<const float*>(g);
  const float* be = static_cast<const float*>(beta);
  switch (dtype) {
    case 0: return (int)launch_proj_ln<float>(x, wq, s, bb, res, gg, be, eps, out, M, D, st);
    case 1:
      return (int)launch_proj_ln<__nv_bfloat16>(x, wq, s, bb, res, gg, be, eps, out, M, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
