// Kernels B2 and B9: the int8 projections of the encoder layer.
//
// B2 replaces the TPU kernel adaptive_classifier_tpu/ops/matmul_int8.py:80
// `quant_matmul_int8` (pallas_call at :94, body `_matmul_kernel` :48):
//     out[M, N] = (q(x) @ w_q) * x_scale * w_scale + b        (in x's type)
// with q(x) the per-row symmetric int8 quantization of x (scale = absmax *
// (1/127), floor 1e-8), w_q [K, N] int8 with per-output-channel scales,
// and an int32 accumulator.  It is the fused QKV projection of the int8
// forward (models/encoder_int8.py:165): K = D, N = 3D (1,536 for the zoo's
// encoder, 2,304 for bert-base).
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
// B2's design.  The Pallas kernel is weight-stationary: one grid step holds
// the whole [K, N] weight in VMEM.  Here the weights stay in the 50 MB L2
// and each block owns a tile of 64 rows by a group of 384 columns: the grid
// is row tiles x column groups (4 groups at N 1,536, 6 at 2,304), so even
// bert-base's 4,096 rows launch 384 blocks on the 132 SMs.  A block
// quantizes its rows into shared memory (int8, one scale per row; once per
// column group, an L2 read of its x rows each time) and walks its columns
// in chunks of 128 through ring_gemm (int8_tile.cuh): the weight's
// K-contiguous copy [N, K], made once per weight by the wrapper, in [128,
// 128] slices through a two-slot cp.async ring, both operands by
// ldmatrix, 8 warps of 2 x 4 m16n8k32 tiles.  The epilogue dequantizes and
// stores two columns at a time.  The int8 operands and the int32 sums are
// exactly the plain version's; the epilogue rounds each step as it does.
// A block holds 66 KB of shared memory at K 512 (q(x) 34 KB, the ring
// 32 KB) and at most 80 registers a thread, so three run on one SM (two at
// K 768).  Measured on an H100 (PERF.md), the deeper slices beat [128, 64]
// ones in a three-slot ring by 10-20%, and the third block beat a third
// slot at the hallucination-detector chunk's 2,048 blocks.
//
// B9 keeps the first port's gemm_rows: 16-row tiles, [K, N] weights staged
// transposed through registers, the residual and the bias added in f32
// into a [16, D] f32 tile in shared memory, then one warp normalizes each
// row.
// Ragged M is masked in the kernels: no padding to a tile multiple.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace ac_int8;

// B2: 64 rows by 128 columns a ring_gemm chunk, three chunks a block
using B2Gemm = Ring<2, 4, 2, 4, 128>;
constexpr int B2_RING = 2;
constexpr int B2_GROUP = 3 * B2Gemm::NC;
constexpr int B9_ROWS = 16;

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Block b: rows (b / groups) * 64.., columns (b % groups) * B2_GROUP.. of
// out, so the groups of one row tile run side by side.  wt [N][K] is w_q's
// K-contiguous copy.
template <typename T>
__global__ void __launch_bounds__(B2Gemm::THREADS, 3)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                    const float* __restrict__ ws, const float* __restrict__ bias,
                    T* __restrict__ out, int M, int K, int N) {
  static_assert(B2Gemm::THREADS == THREADS, "quant_rows_global takes WARPS warps");
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = K + 16;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + (size_t)B2Gemm::ROWS * lda);
  int8_t* ring = reinterpret_cast<int8_t*>(xs + B2Gemm::ROWS);
  const int groups = (N + B2_GROUP - 1) / B2_GROUP;
  const int m0 = (int)(blockIdx.x / groups) * B2Gemm::ROWS;
  const int c0 = (int)(blockIdx.x % groups) * B2_GROUP;
  const int nc = min(B2_GROUP, N - c0);

  quant_rows_global<true>(x, M, K, m0, B2Gemm::ROWS, xq, lda, xs);
  ring_gemm<B2Gemm, B2_RING>(xq, lda, wt + (size_t)c0 * K, K, nc, ring,
      [&](int n0, int row0, int col0, int (&acc)[2][4][4]) {
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            if (m0 + r >= M) continue;
            #pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int c = n0 + col0 + 8 * n + acc_col(0);
              if (c >= nc) continue;
              const int col = c0 + c;
              store_pair(out + (size_t)(m0 + r) * N + col,
                         dequant(acc[m][n][2 * hf], xs[r], ws[col], bias[col]),
                         dequant(acc[m][n][2 * hf + 1], xs[r], ws[col + 1], bias[col + 1]));
            }
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
  layer_norm_rows(ys, ldy, D, B9_ROWS, g, beta, eps, out, m0, M);
}

size_t quant_matmul_smem(int K) {
  return (size_t)B2Gemm::ROWS * (K + 16) + B2Gemm::ROWS * sizeof(float) +
         B2_RING * (size_t)B2Gemm::SLOT;
}

size_t proj_ln_smem(int D) {
  return (size_t)B9_ROWS * (D + 4) * sizeof(float) + (size_t)B9_ROWS * (D + 16) +
         B9_ROWS * sizeof(float) + TN * (MAX_TKS + 16);
}

// info set: report the instantiation (int8_tile.cuh kernel_info; then rows
// and columns a block, blocks in the grid) instead of launching
template <typename T>
cudaError_t launch_matmul(const void* x, const int8_t* wt, const float* ws,
                          const float* b, void* out, int M, int K, int N,
                          cudaStream_t stream, int* info) {
  auto* kernel = quant_matmul_kernel<T>;
  const size_t smem = quant_matmul_smem(K);
  int dev = 0, have = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&have, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)have) return cudaErrorInvalidValue;
  const long long blocks = (long long)((M + B2Gemm::ROWS - 1) / B2Gemm::ROWS) *
                           ((N + B2_GROUP - 1) / B2_GROUP);
  if (info) {
    info[5] = B2Gemm::ROWS;
    info[6] = B2_GROUP;
    info[7] = (int)blocks;
    return ac_common::kernel_info(kernel, smem, B2Gemm::THREADS, info);
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, B2Gemm::THREADS, smem, stream>>>(
      static_cast<const T*>(x), wt, ws, b, static_cast<T*>(out), M, K, N);
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

int quant_matmul(const void* x, const void* wt, const void* ws, const void* b, void* out,
                 int M, int K, int N, int dtype, void* stream, int* info) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(wt);
  const float* s = static_cast<const float*>(ws);
  const float* bb = static_cast<const float*>(b);
  switch (dtype) {
    case 0: return (int)launch_matmul<float>(x, wq, s, bb, out, M, K, N, st, info);
    case 1: return (int)launch_matmul<__nv_bfloat16>(x, wq, s, bb, out, M, K, N, st, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// B2.  dtype: 0 = float32, 1 = bfloat16 (of x and out).  x [M, K], wt
// [N, K] int8 (w_q transposed: K contiguous), ws and b [N] f32, out [M,
// N], all contiguous on the current device; K % 128 == 0, N % 64 == 0.
// Returns the launch's cudaError_t.
extern "C" int ac_quant_matmul_int8(const void* x, const void* wt, const void* ws,
                                    const void* b, void* out, int M, int K, int N,
                                    int dtype, void* stream) {
  return quant_matmul(x, wt, ws, b, out, M, K, N, dtype, stream, nullptr);
}

// The kernel ac_quant_matmul_int8 would launch for [M, K] rows of dtype and
// N columns: info[8] = registers per thread, shared bytes per block,
// threads per block, blocks resident per SM, local (spill) bytes per
// thread, rows and columns a block, blocks in the grid.  Launches nothing.
extern "C" int ac_quant_matmul_int8_info(int M, int K, int N, int dtype, int* info) {
  return quant_matmul(nullptr, nullptr, nullptr, nullptr, nullptr, M, K, N, dtype, nullptr,
                      info);
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
