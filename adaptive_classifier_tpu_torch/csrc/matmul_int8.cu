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
// What bounds them on an H100: bytes.  At the banking chunk (M = 8,192) B2
// reads M*K*2 + K*N + 8N bytes and writes M*N*2: 34.4 MB, 10.3 us at 3.35
// TB/s, against 2*M*K*N = 12.9 GOP, 6.5 us at the 1,979 TOP/s int8
// tensor-core peak.  B9 at the same M: 6*M*D + D*D bytes, 25.4 MB, 7.6 us,
// against 4.3 GOP, 2.2 us.
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
// B9's design.  The LayerNorm needs whole rows, so a block owns rows by all
// D columns: 32 rows at D <= 512 (16 above, where 32 rows' accumulators
// would not fit the registers of two blocks an SM), 8 warps side by side
// over the columns (D / 64 each), so M = 8,192 launches 256 blocks, two an
// SM.  The product is B2's ring_gemm on the weight's K-contiguous copy, in
// [D, 64] slices through a two-slot ring.  Its epilogue is B8's
// O-projection stage without the re-quantization: the dequantized rows
// plus bias and residual stay in the accumulators' registers, ln_stats reduces each row's sum and squared deviations across
// the 8 column warps through shared memory, and each thread writes its
// normalized values straight to out.  No f32 tile of the rows and no
// scratch: 82 KB of shared memory at D 512 (q(x) 17 KB, the ring 64 KB).
// Every block reads the whole weight from L2 (256 KB at D 512).
// Ragged M is masked in the kernels: no padding to a tile multiple.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "int8_tile.cuh"

namespace {

using namespace ac_int8;

// B2: 64 rows by 128 columns a ring_gemm chunk, three chunks a block
using B2Gemm = Ring<2, 4, 2, 4, 128>;
constexpr int B2_RING = 2;
constexpr int B2_GROUP = 3 * B2Gemm::NC;

// B9: all D columns a block over 8 warps (NT = D / 64 n8 tiles each), MT
// m16 tiles of rows: 32 rows (MT 2) up to D B9_WIDE_MAX_D, else 16
template <int MT, int NT>
using B9Gemm = Ring<1, 8, MT, NT, 64>;
constexpr int B9_RING = 2;
constexpr int B9_WIDE_MAX_D = 512;
constexpr int B9_MAX_D = 1024;

// Block b: rows (b / groups) * 64.., columns (b % groups) * B2_GROUP.. of
// out, so the groups of one row tile run side by side.  wt [N][K] is w_q's
// K-contiguous copy.
template <typename T>
__global__ void __launch_bounds__(B2Gemm::THREADS, 3)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                    const float* __restrict__ ws, const float* __restrict__ bias,
                    T* __restrict__ out, int M, int K, int N) {
  static_assert(B2Gemm::THREADS == THREADS, "quant_rows_global takes WARPS warps");
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
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
              store2(out, BF16, (size_t)(m0 + r) * N + col,
                     dequant(acc[m][n][2 * hf], xs[r], ws[col], bias[col]),
                     dequant(acc[m][n][2 * hf + 1], xs[r], ws[col + 1], bias[col + 1]));
            }
          }
      });
}

// B9.  Block b: rows b * G::ROWS.., all D columns; wt [D][D] is w_q's
// K-contiguous copy.
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(THREADS, 2)
proj_residual_ln_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ ws, const float* __restrict__ bias,
                        const T* __restrict__ res, const float* __restrict__ g,
                        const float* __restrict__ beta, float eps,
                        T* __restrict__ out, int M, int D) {
  using G = B9Gemm<MT, NT>;
  static_assert(G::THREADS == THREADS, "quant_rows_global takes WARPS warps");
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = D + 16;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + (size_t)G::ROWS * lda);
  float* red = xs + G::ROWS;                                 // [ROWS][WN]
  int8_t* ring = reinterpret_cast<int8_t*>(red + G::ROWS * G::WN);
  const int m0 = blockIdx.x * G::ROWS;

  quant_rows_global<true>(x, M, D, m0, G::ROWS, xq, lda, xs);
  ring_gemm<G, B9_RING>(xq, lda, wt, D, D, ring,
      [&](int, int row0, int col0, int (&acc)[MT][NT][4]) {
        // q(x) @ W * s_x * s_w + b + res, in the accumulators' own
        // registers (each sum is read before its slot is rewritten)
        float (&y)[MT][NT][4] = reinterpret_cast<float (&)[MT][NT][4]>(acc);
        #pragma unroll
        for (int m = 0; m < MT; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            const bool live = m0 + r < M;
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float2 rv = live ? load2(res, BF16, (size_t)(m0 + r) * D + c)
                                     : make_float2(0.f, 0.f);
              const int a0 = acc[m][n][2 * hf], a1 = acc[m][n][2 * hf + 1];
              y[m][n][2 * hf] = __fadd_rn(dequant(a0, xs[r], ws[c], bias[c]), rv.x);
              y[m][n][2 * hf + 1] = __fadd_rn(dequant(a1, xs[r], ws[c + 1], bias[c + 1]), rv.y);
            }
          }
        float mean[MT][2], inv[MT][2];
        ln_stats<G::WN>(y, red, row0, D, eps, mean, inv);
        #pragma unroll
        for (int m = 0; m < MT; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            if (m0 + r >= M) continue;
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float a = (y[m][n][2 * hf] - mean[m][hf]) * inv[m][hf] * g[c] + beta[c];
              const float b =
                  (y[m][n][2 * hf + 1] - mean[m][hf]) * inv[m][hf] * g[c + 1] + beta[c + 1];
              store2(out, BF16, (size_t)(m0 + r) * D + c, a, b);
            }
          }
      });
}

size_t quant_matmul_smem(int K) {
  return (size_t)B2Gemm::ROWS * (K + 16) + B2Gemm::ROWS * sizeof(float) +
         B2_RING * (size_t)B2Gemm::SLOT;
}

size_t proj_ln_smem(int rows, int D) {
  return (size_t)rows * (D + 16) + (size_t)rows * (1 + WARPS) * sizeof(float) +
         B9_RING * (size_t)D * 64;
}

// the card's opt-in shared memory a block may hold
cudaError_t smem_limit(size_t* have) {
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *have = (size_t)v;
  return err;
}

// info set: report the instantiation (int8_tile.cuh kernel_info; then rows
// and columns a block, blocks in the grid) instead of launching
template <typename T>
cudaError_t launch_matmul(const void* x, const int8_t* wt, const float* ws,
                          const float* b, void* out, int M, int K, int N,
                          cudaStream_t stream, int* info) {
  auto* kernel = quant_matmul_kernel<T>;
  const size_t smem = quant_matmul_smem(K);
  size_t have = 0;
  cudaError_t err = smem_limit(&have);
  if (err != cudaSuccess) return err;
  if (smem > have) return cudaErrorInvalidValue;
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

struct ProjLnArgs {
  const void *x, *res;
  const int8_t* wt;
  const float *ws, *b, *g, *beta;
  float eps;
  void* out;
  int M, D;
  cudaStream_t stream;
  int* info;        // set: report the instantiation instead of launching
};

template <typename T, int NT>
cudaError_t launch_proj_ln(const ProjLnArgs& a) {
  constexpr int MT = NT * 64 <= B9_WIDE_MAX_D ? 2 : 1;
  using G = B9Gemm<MT, NT>;
  auto* kernel = proj_residual_ln_kernel<T, MT, NT>;
  const size_t smem = proj_ln_smem(G::ROWS, a.D);
  size_t have = 0;
  cudaError_t err = smem_limit(&have);
  if (err != cudaSuccess) return err;
  if (smem > have) return cudaErrorInvalidValue;
  const int blocks = (a.M + G::ROWS - 1) / G::ROWS;
  if (a.info) {
    a.info[5] = G::ROWS;
    a.info[6] = blocks;
    return ac_common::kernel_info(kernel, smem, G::THREADS, a.info);
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, G::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.wt, a.ws, a.b, static_cast<const T*>(a.res), a.g,
      a.beta, a.eps, static_cast<T*>(a.out), a.M, a.D);
  return cudaGetLastError();
}

// the instantiation for D = 64 NT (NT even: D % 128 == 0)
template <typename T, int NT = 2>
cudaError_t launch_proj_ln_width(const ProjLnArgs& a) {
  if constexpr (NT * 64 > B9_MAX_D) {
    return cudaErrorInvalidValue;
  } else {
    if (a.D == NT * 64) return launch_proj_ln<T, NT>(a);
    return launch_proj_ln_width<T, NT + 2>(a);
  }
}

int proj_ln(const ProjLnArgs& a, int dtype) {
  if (a.M <= 0 || a.D <= 0 || a.D % 128 != 0 || a.D > B9_MAX_D)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_proj_ln_width<float>(a);
    case 1: return (int)launch_proj_ln_width<__nv_bfloat16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % 128 != 0 || N % 64 != 0;
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

// B9.  dtype as above, of x, res and out.  x, res, out [M, D]; wt [D, D]
// int8 (w_q transposed: K contiguous); ws, b, g, beta [D] f32; all
// contiguous on the current device; D % 128 == 0, D <= 1,024.  Returns the
// launch's cudaError_t.
extern "C" int ac_proj_residual_ln_int8(const void* x, const void* wt, const void* ws,
                                        const void* b, const void* res, const void* g,
                                        const void* beta, float eps, void* out, int M,
                                        int D, int dtype, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return proj_ln({x, res, static_cast<const int8_t*>(wt), f(ws), f(b), f(g), f(beta), eps,
                  out, M, D, static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

// The kernel ac_proj_residual_ln_int8 would launch for [M, D] rows of
// dtype: info[7] = registers per thread, shared bytes per block, threads per
// block, blocks resident per SM, local (spill) bytes per thread, rows a
// block, blocks in the grid.  Launches nothing.
extern "C" int ac_proj_residual_ln_int8_info(int M, int D, int dtype, int* info) {
  return proj_ln({nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0.f,
                  nullptr, M, D, nullptr, info}, dtype);
}
