// Kernel B8: the whole post-attention body of an encoder layer as one
// kernel (B3, the FFN block alone, is ffn_block_int8.cu).
//
// Replaces the TPU kernel adaptive_classifier_tpu/ops/ffn_int8.py:202
// `attn_ffn_block_int8` (pallas_call at :245, body `_attn_ffn_kernel` :157):
//     h   = LayerNorm1(q(ctx) @ Wo * s_c * so + bo + x)        [M, D] f32
//     f   = gelu_tanh(q(h) @ W1 * s_h * s1 + b1)               [M, F] f32
//     out = LayerNorm2(q(f) @ W2 * s_f * s2 + b2 + h)          [M, D], ctx's type
// q() is the per-row symmetric int8 quantization with scale absmax / 127
// (floor 1e-8), every product int8 x int8 -> int32, every epilogue and both
// LayerNorms in f32.  GELU is the tanh form (ffn_int8.py:46), not the float
// path's erf.
//
// What bounds it on an H100: operations.  At the banking chunk (M = 8,192,
// D = 512, F = 2,048) it does 2*M*D*(D + 2F) = 38.7 GOP, 19.5 us at the
// 1,979 TOP/s int8 tensor-core peak.
//
// The trap: the GELU output's per-row scale needs the row's absolute
// maximum over all F = 2,048 columns before the second product can start.
// Design (a), one kernel: a block owns 16 rows.  It keeps the [16, F] f32
// GELU tile in shared memory (131 KB at F = 2,048, with a 4-float row pad),
// takes each row's maximum there, and quantizes the tile to int8 in place,
// so the [M, F] intermediate never reaches device memory, as in the Pallas
// kernel.  (Design (b), two kernels, would write and read it back: 2*M*F
// bytes, 33.6 MB at this M, twice the bytes of the whole function.)  The
// first LayerNorm's rows h live beside it as a [16, D] f32 tile; every
// product runs on mma.sync.m16n8k32 (int8_tile.cuh gemm_rows) with the 8
// warps side by side over 64-column tiles, and the last product's epilogue
// adds the residual in place before one warp per row normalizes.  The
// 16-row tile is what the f32 GELU tile leaves room for (206 KB of shared
// memory in all at the zoo's widths, so one block per SM): every block
// reads all three weight matrices from L2, M/16 times in all, and that L2
// traffic, with no wgmma or TMA yet, keeps the kernel well above its
// operation bound.  Ragged M is masked in the kernel: no padding to a tile
// multiple.
//
// Where the f32 GELU tile does not fit a block (bert-base: D = 768,
// F = 3,072 needs 293 KB), the kernel runs the first FFN product twice
// instead (TWO_PASS): the first pass keeps only each row's |GELU| maximum,
// the second recomputes the same values, bit for bit, and quantizes them
// straight into a [16, F] int8 tile (49 KB at F = 3,072; 145 KB in all).
// The result is the one-pass kernel's exactly; the cost is the first
// product's operations and weight reads once more.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace ac_int8;

constexpr int ROWS = 16;

struct Layout {
  int ldh, lda;               // f32 row stride of h, byte stride of xq
  int ldf, ldfq;              // f32 row stride of f (one pass), byte stride of q(f)
  size_t h, xq, xs, f, fs, bs, total;
};

// One pass: f32 f, quantized in place (ldfq = 4 * ldf).  Two passes: only
// the int8 q(f), row stride F + 16 bytes.
__host__ __device__ inline Layout layout(int D, int F, bool two_pass) {
  Layout l;
  l.ldh = D + 4;
  l.lda = D + 16;
  l.ldf = F + 4;
  l.ldfq = two_pass ? F + 16 : 4 * l.ldf;
  l.h = 0;
  l.xq = l.h + (size_t)ROWS * l.ldh * sizeof(float);
  l.xs = l.xq + (size_t)ROWS * l.lda;
  l.f = l.xs + ROWS * sizeof(float);
  l.fs = l.f + (size_t)ROWS * l.ldfq;
  l.bs = l.fs + ROWS * sizeof(float);
  l.total = l.bs + (size_t)TN * (MAX_TKS + 16);
  return l;
}

// B8 on ctx = in0, x = in1.  TWO_PASS: the first FFN product twice, no f32
// GELU tile (see the top).
template <typename T, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
           const int8_t* __restrict__ wo, const float* __restrict__ so,
           const float* __restrict__ bo, const float* __restrict__ g1,
           const float* __restrict__ be1,
           const int8_t* __restrict__ w1, const float* __restrict__ s1,
           const float* __restrict__ b1, const int8_t* __restrict__ w2,
           const float* __restrict__ s2, const float* __restrict__ b2,
           const float* __restrict__ g2, const float* __restrict__ be2, float eps,
           T* __restrict__ out, int M, int D, int F) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(D, F, TWO_PASS);
  float* hs = reinterpret_cast<float*>(smem + l.h);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + l.xq);
  float* xs = reinterpret_cast<float*>(smem + l.xs);
  float* fv = reinterpret_cast<float*>(smem + l.f);
  int8_t* fq = reinterpret_cast<int8_t*>(smem + l.f);   // fv quantized in place
  float* fsc = reinterpret_cast<float*>(smem + l.fs);
  int8_t* bs = reinterpret_cast<int8_t*>(smem + l.bs);
  const int m0 = blockIdx.x * ROWS;

  // h = LN1(q(ctx) @ Wo * s_c * so + bo + x)
  quant_rows_global<false>(in0, M, D, m0, ROWS, xq, l.lda, xs);
  gemm_rows<1, 1, 8>(xq, l.lda, wo, D, D, bs,
      [&](int n0, int row0, int col0, int (&acc)[1][1][4]) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + acc_row(i), c = n0 + col0 + acc_col(i);
          const float xv = m0 + r < M ? to_f32(in1[(size_t)(m0 + r) * D + c]) : 0.f;
          hs[r * l.ldh + c] = __fadd_rn(dequant(acc[0][0][i], xs[r], so[c], bo[c]), xv);
        }
      });
  __syncthreads();
  layer_norm_rows<false, T>(hs, l.ldh, D, ROWS, g1, be1, eps, nullptr, m0, M);
  __syncthreads();

  // f = gelu_tanh(q(h) @ W1 * s_h * s1 + b1), then q(f) in shared memory
  quant_rows_smem<false>(hs, l.ldh, D, ROWS, xq, l.lda, xs);
  if (TWO_PASS) {
    // pass 1: each row's max |f|, as the bits of a non-negative float (whose
    // order is the unsigned order); pass 2: f again, quantized at once
    unsigned* famax = reinterpret_cast<unsigned*>(fsc);
    if (threadIdx.x < ROWS) famax[threadIdx.x] = 0u;
    gemm_rows<1, 1, 8>(xq, l.lda, w1, D, F, bs,       // begins with a barrier
        [&](int n0, int row0, int col0, int (&acc)[1][1][4]) {
          float m[2] = {0.f, 0.f};
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + acc_row(i), c = n0 + col0 + acc_col(i);
            m[i >> 1] = fmaxf(m[i >> 1], fabsf(gelu_tanh(
                dequant(acc[0][0][i], xs[r], s1[c], b1[c]))));
          }
          atomicMax(famax + row0 + acc_row(0), __float_as_uint(m[0]));
          atomicMax(famax + row0 + acc_row(2), __float_as_uint(m[1]));
        });
    __syncthreads();
    if (threadIdx.x < ROWS) fsc[threadIdx.x] = row_scale<false>(__uint_as_float(famax[threadIdx.x]));
    gemm_rows<1, 1, 8>(xq, l.lda, w1, D, F, bs,       // begins with a barrier
        [&](int n0, int row0, int col0, int (&acc)[1][1][4]) {
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + acc_row(i), c = n0 + col0 + acc_col(i);
            fq[r * l.ldfq + c] = (int8_t)quant(
                gelu_tanh(dequant(acc[0][0][i], xs[r], s1[c], b1[c])), fsc[r]);
          }
        });
  } else {
    gemm_rows<1, 1, 8>(xq, l.lda, w1, D, F, bs,
        [&](int n0, int row0, int col0, int (&acc)[1][1][4]) {
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + acc_row(i), c = n0 + col0 + acc_col(i);
            fv[r * l.ldf + c] = gelu_tanh(dequant(acc[0][0][i], xs[r], s1[c], b1[c]));
          }
        });
    __syncthreads();
    quant_rows_smem<false>(fv, l.ldf, F, ROWS, fq, l.ldfq, fsc);
  }

  // out = LN2(q(f) @ W2 * s_f * s2 + b2 + h)
  gemm_rows<1, 1, 8>(fq, l.ldfq, w2, F, D, bs,
      [&](int n0, int row0, int col0, int (&acc)[1][1][4]) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + acc_row(i), c = n0 + col0 + acc_col(i);
          float* hp = hs + r * l.ldh + c;
          *hp = __fadd_rn(dequant(acc[0][0][i], fsc[r], s2[c], b2[c]), *hp);
        }
      });
  __syncthreads();
  layer_norm_rows<true>(hs, l.ldh, D, ROWS, g2, be2, eps, out, m0, M);
}

template <typename T, bool TWO_PASS>
cudaError_t launch_pass(const void* in0, const void* in1, const int8_t* wo,
                        const float* so, const float* bo, const float* g1,
                        const float* be1, const int8_t* w1, const float* s1,
                        const float* b1, const int8_t* w2, const float* s2,
                        const float* b2, const float* g2, const float* be2, float eps,
                        void* out, int M, int D, int F, cudaStream_t stream) {
  const size_t smem = layout(D, F, TWO_PASS).total;
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<T, TWO_PASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + ROWS - 1) / ROWS;
  ffn_kernel<T, TWO_PASS><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(in0), static_cast<const T*>(in1), wo, so, bo, g1, be1,
      w1, s1, b1, w2, s2, b2, g2, be2, eps, static_cast<T*>(out), M, D, F);
  return cudaGetLastError();
}

// One pass where its f32 GELU tile fits a block of the current device, else
// two passes.
template <typename T>
cudaError_t launch(const void* in0, const void* in1, const int8_t* wo, const float* so,
                   const float* bo, const float* g1, const float* be1,
                   const int8_t* w1, const float* s1, const float* b1,
                   const int8_t* w2, const float* s2, const float* b2,
                   const float* g2, const float* be2, float eps, void* out,
                   int M, int D, int F, cudaStream_t stream) {
  int dev = 0, have = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&have, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (layout(D, F, false).total <= (size_t)have)
    return launch_pass<T, false>(in0, in1, wo, so, bo, g1, be1, w1, s1, b1, w2,
                                         s2, b2, g2, be2, eps, out, M, D, F, stream);
  return launch_pass<T, true>(in0, in1, wo, so, bo, g1, be1, w1, s1, b1, w2,
                                      s2, b2, g2, be2, eps, out, M, D, F, stream);
}

int dispatch(const void* in0, const void* in1, const void* wo, const void* so,
             const void* bo, const void* g1, const void* be1, const void* w1,
             const void* s1, const void* b1, const void* w2, const void* s2,
             const void* b2, const void* g2, const void* be2, float eps, void* out,
             int M, int D, int F, int dtype, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 128 != 0 || F % 128 != 0)
    return (int)cudaErrorInvalidValue;
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(in0, in1, i8(wo), f32(so), f32(bo), f32(g1),
                                        f32(be1), i8(w1), f32(s1), f32(b1), i8(w2),
                                        f32(s2), f32(b2), f32(g2), f32(be2), eps, out,
                                        M, D, F, st);
    case 1:
      return (int)launch<__nv_bfloat16>(
          in0, in1, i8(wo), f32(so), f32(bo), f32(g1), f32(be1), i8(w1), f32(s1),
          f32(b1), i8(w2), f32(s2), f32(b2), f32(g2), f32(be2), eps, out, M, D, F, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory a block needs at widths D, F, in one pass (two_pass = 0)
// or two (a launch takes one pass where it fits the card's 227 KB, else
// two, and fails past that).
extern "C" long long ac_ffn_int8_smem_bytes(int D, int F, int two_pass) {
  return (long long)layout(D, F, two_pass != 0).total;
}

// B8.  ctx, x, out [M, D] of dtype; wo [D, D] int8 with so, bo [D]; g1, be1
// [D] (LayerNorm after attention); w1 [D, F], w2 [F, D] int8 with s1, b1
// [F] and s2, b2 [D]; g2, be2 [D] (LayerNorm after the FFN); all contiguous
// on the current device; D % 128 == 0, F % 128 == 0.  Returns the launch's
// cudaError_t.
extern "C" int ac_attn_ffn_block_int8(const void* ctx, const void* x, const void* wo,
                                      const void* so, const void* bo, const void* g1,
                                      const void* be1, const void* w1, const void* s1,
                                      const void* b1, const void* w2, const void* s2,
                                      const void* b2, const void* g2, const void* be2,
                                      float eps, void* out, int M, int D, int F,
                                      int dtype, void* stream) {
  return dispatch(ctx, x, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2,
                        eps, out, M, D, F, dtype, stream);
}
