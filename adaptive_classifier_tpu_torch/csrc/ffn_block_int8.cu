// Kernels B3 and B8: the int8 FFN block, and the whole post-attention body
// of an encoder layer (an O-projection stage in front of the same body), as
// one kernel on K-contiguous weights.
//
// B3 replaces the TPU kernel adaptive_classifier_tpu/ops/ffn_int8.py:95
// `ffn_block_int8` (pallas_call at :124, body `_ffn_kernel` :56):
//     f   = gelu_tanh(q(h) @ W1 * s_h * s1 + b1)               [M, F] f32
//     out = LayerNorm(q(f) @ W2 * s_f * s2 + b2 + h)           [M, D], h's type
// B8 replaces ops/ffn_int8.py:202 `attn_ffn_block_int8` (pallas_call at
// :245, body `_attn_ffn_kernel` :157): the same body on
//     h   = LayerNorm1(q(ctx) @ Wo * s_c * so + bo + x)        [M, D] f32
// with out in ctx's type.  q() is the per-row symmetric int8 quantization
// with scale absmax / 127 (floor 1e-8) over the row's whole width, every
// product int8 x int8 -> int32, every epilogue step rounded on its own
// (int8_tile.cuh), the LayerNorms' statistics in f32.  GELU is the tanh
// form (ffn_int8.py:46).
//
// What bounds them on an H100: operations.  At the banking chunk (M =
// 8,192, D = 512, F = 2,048) B3 does 4*M*D*F = 34.4 GOP, 17.4 us at the
// 1,979 TOP/s int8 tensor-core peak, against ~18.9 MB of bytes (5.6 us);
// B8 2*M*D*(D + 2F) = 38.7 GOP, 19.5 us.
//
// The trap is q(f): its row scale needs the row's |GELU| maximum over all F
// columns before the second product can start, and the [M, F] intermediate
// must not reach device memory.  Design, per block of R rows (64 at D 512,
// else 32; 16 warps):
// - q(h) [R, D] int8 in shared memory (rows past M are zeros), overlaid by
//   the second product's ring once the first is done;
// - pass 1: the first product, chunk by chunk of F columns, keeps only each
//   row's |GELU| maximum; pass 2 computes the same values again, bit for
//   bit, and quantizes them straight into q(f) [R, F] int8 in shared memory
//   (132 KB at R 64, F 2,048): no f32 tile of f, 1.5x the first product's
//   operations;
// - the second product covers all D columns at once, so the pre-LayerNorm
//   rows stay in the block's registers (at R 64, D 512: 64 a thread); the
//   epilogue adds the residual h, re-read from device memory, and
//   normalizes with row statistics reduced across the warps through shared
//   memory.
// B8 (OPROJ) runs a stage 0 in front: q(ctx) goes into the q(h) tile, its
// product with Wo runs in the second product's geometry (all D columns at
// once, the pre-LayerNorm rows in registers), and the epilogue adds bo and
// x, normalizes, reduces each row's |h| maximum across the column warps the
// same way and quantizes h over q(ctx).  Its ring and row partials sit
// where q(f) will be.  h in f32, which LN2 needs, does not fit beside q(f)
// (128 KB at R 64, D 512): each thread writes its h values into an f32
// [M, D] scratch the wrapper allocates and reads the same values back to
// quantize them (so they need no registers across the |h| reduction) and
// in LN2's epilogue (the two products share one geometry, so no other
// thread or block reads them; 3*M*D*4 bytes, mostly L2).
// Weights are read as [N, K] copies (K contiguous, made once per weight by
// the wrapper), in [NC, KS] slices through a three-slot cp.async ring
// (int8_tile.cuh ring_gemm), each warp 2 x 4 (first product) or 2 x D/(8 WN)
// (second, and B8's stage 0) m16n8k32 tiles, both operands by ldmatrix.
// Each block reads W1 twice and W2 once from L2 (B8: and Wo once): 48 KB of
// weights a row at R 64 (96 KB at R 32), 52 KB with Wo.
// Ragged M is masked in the kernel: no padding to a tile multiple.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace ac_int8;

constexpr int NW = 16;                  // warps a block
constexpr int NTHREADS = 32 * NW;
constexpr int RING = 3;                 // weight slices: two in flight, one read
constexpr int MAX_D = 1024;             // the second product's columns in registers

// warps side by side over the columns, for R rows a block
template <int R>
constexpr int WN = NW * 32 / R;

// The first product, a chunk of 256 (R 64) or 512 (R 32) of F's columns at a
// time; the second (and B8's stage 0), all D columns at once (NT2 = D /
// (8 WN) n8 tiles a warp).
template <int R>
using Gemm1 = Ring<R / 32, WN<R>, 2, 4, R == 64 ? 64 : 32>;
template <int R, int NT2>
using Gemm2 = Ring<R / 32, WN<R>, 2, NT2, 32>;

struct Layout {
  int lda, ldf;                 // byte strides of q(h) and q(f)
  size_t fq, xs, fs, xq, ring0, red0, ring1, ring2, red, total;
};

// q(f) | s_h [R] | s_f [R] | then, while the first product runs, q(h) and
// its ring; while the second runs, its ring (over q(h), no longer read) and
// the row partial sums [R][WN].  B8's stage 0: its ring and row partials
// over q(f), not yet written (past the end where they do not fit there).
template <int R, bool OPROJ>
__host__ __device__ inline Layout layout(int D, int F) {
  Layout l;
  l.lda = D + 16;
  l.ldf = F + 16;
  l.fq = 0;
  l.xs = l.fq + (size_t)R * l.ldf;
  l.fs = l.xs + R * sizeof(float);
  l.xq = l.fs + R * sizeof(float);
  l.ring1 = l.xq + (size_t)R * l.lda;
  l.ring2 = l.xq;
  l.red = l.ring2 + RING * (size_t)D * 32;
  const size_t end1 = l.ring1 + RING * (size_t)Gemm1<R>::SLOT;
  const size_t end2 = l.red + (size_t)R * WN<R> * sizeof(float);
  l.total = end1 > end2 ? end1 : end2;
  const size_t need0 = RING * (size_t)D * 32 + (size_t)R * WN<R> * sizeof(float);
  l.ring0 = need0 <= l.xs ? l.fq : l.total;
  l.red0 = l.ring0 + RING * (size_t)D * 32;
  if (OPROJ && l.ring0 + need0 > l.total) l.total = l.ring0 + need0;
  return l;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// elements i, i + 1 of a float32 or bfloat16 array
__device__ __forceinline__ float2 load2(const void* p, bool bf16, size_t i) {
  if (bf16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ void store2(void* p, bool bf16, size_t i, float a, float b) {
  if (bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(a, b);
}

// The totals of the thread's four rows (row0 + 16m + acc_row(2 hf)) over
// the block's WN column warps: part(m, hf), the thread's own part of a row
// (a sum, or a maximum of values >= 0), then the quad's, then the warps' in
// order through red [R][WN].  Two barriers; red is free again on return.
template <int WN_, bool MAX, typename Part>
__device__ __forceinline__ void row_totals(float (&tot)[2][2], float* red, int row0,
                                           Part part) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) % WN_;
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float p = part(m, hf);
      const float v = MAX ? quad_max(p) : quad_sum(p);
      if ((lane & 3) == 0) red[(row0 + 16 * m + acc_row(2 * hf)) * WN_ + wn] = v;
    }
  __syncthreads();
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* rp = red + (row0 + 16 * m + acc_row(2 * hf)) * WN_;
      float t = 0.f;
      #pragma unroll
      for (int w = 0; w < WN_; ++w) t = MAX ? fmaxf(t, rp[w]) : t + rp[w];
      tot[m][hf] = t;
    }
  __syncthreads();                      // red is read before it is rewritten
}

// LayerNorm statistics of the thread's rows of y (a warp's 2 x NT tiles of
// the second product's geometry, all D columns across the WN warps): the
// row's sum, then its squared deviations, each over all D columns.
template <int WN_, int NT>
__device__ __forceinline__ void ln_stats(const float (&y)[2][NT][4], float* red, int row0,
                                         int D, float eps, float (&mean)[2][2],
                                         float (&inv)[2][2]) {
  row_totals<WN_, false>(mean, red, row0, [&](int m, int hf) {
    float p = 0.f;
    #pragma unroll
    for (int n = 0; n < NT; ++n)
      #pragma unroll
      for (int e = 0; e < 2; ++e) p += y[m][n][2 * hf + e];
    return p;
  });
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) mean[m][hf] = mean[m][hf] / (float)D;
  row_totals<WN_, false>(inv, red, row0, [&](int m, int hf) {
    float p = 0.f;
    #pragma unroll
    for (int n = 0; n < NT; ++n)
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = y[m][n][2 * hf + e] - mean[m][hf];
        p += d * d;
      }
    return p;
  });
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) inv[m][hf] = 1.0f / sqrtf(inv[m][hf] / (float)D + eps);
}

// B8's stage-0 arguments, in shared memory: the stage is not inlined (so
// its registers are allocated apart from the FFN passes'), and it loads each
// of these where it uses it instead of holding it in a register
struct StageArgs {
  const void* x;                // the residual of the O-projection, ctx's type
  const int8_t* wot;            // Wo, K contiguous
  const float *so, *bo, *g1, *be1;
  float* hs;                    // h, f32 [M, D]
  float eps;
  bool bf16;
};
__shared__ StageArgs stage_args;

// B8's stage 0 (see the top): h = LN1(q(ctx) @ Wo * s_c * so + bo + x)
// into hs, q(h) into xq and s_h into xs, over q(ctx) and its scales.
template <int R, int NT2>
__device__ __noinline__ void o_proj_stage(uint8_t* smem, int M, int D, int F) {
  const StageArgs& a = stage_args;
  using G2 = Gemm2<R, NT2>;
  const Layout l = layout<R, true>(D, F);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + l.xq);
  float* xs = reinterpret_cast<float*>(smem + l.xs);
  const int m0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31;
  float* red0 = reinterpret_cast<float*>(smem + l.red0);
  ring_gemm<G2, RING>(xq, l.lda, a.wot, D, D, reinterpret_cast<int8_t*>(smem + l.ring0),
      [&](int, int row0, int col0, int (&acc)[2][NT2][4]) {
        const int wn = (threadIdx.x >> 5) % G2::WN;
        float (&y)[2][NT2][4] = reinterpret_cast<float (&)[2][NT2][4]>(acc);
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            const bool live = m0 + r < M;
            #pragma unroll
            for (int n = 0; n < NT2; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float2 xv = live ? load2(a.x, a.bf16, (size_t)(m0 + r) * D + c)
                                     : make_float2(0.f, 0.f);
              const int a0 = acc[m][n][2 * hf], a1 = acc[m][n][2 * hf + 1];
              y[m][n][2 * hf] = __fadd_rn(dequant(a0, xs[r], a.so[c], a.bo[c]), xv.x);
              y[m][n][2 * hf + 1] =
                  __fadd_rn(dequant(a1, xs[r], a.so[c + 1], a.bo[c + 1]), xv.y);
            }
          }
        float mean[2][2], inv[2][2], amax[2][2];
        ln_stats<G2::WN>(y, red0, row0, D, a.eps, mean, inv);   // all have read xs, xq
        // h = LN1(y) into hs, and each row's |h| maximum (y dies here, so
        // the quantization below holds no more registers than LN2 does)
        row_totals<G2::WN, true>(amax, red0, row0, [&](int m, int hf) {
          const int r = row0 + 16 * m + acc_row(2 * hf);
          float mx = 0.f;
          #pragma unroll
          for (int n = 0; n < NT2; ++n) {
            const int c = col0 + 8 * n + acc_col(0);
            float h2[2];
            #pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = __fsub_rn(y[m][n][2 * hf + e], mean[m][hf]);
              h2[e] = __fadd_rn(__fmul_rn(__fmul_rn(d, inv[m][hf]), a.g1[c + e]), a.be1[c + e]);
              mx = fmaxf(mx, fabsf(h2[e]));
            }
            if (m0 + r < M)
              __stcg(reinterpret_cast<float2*>(a.hs + (size_t)(m0 + r) * D + c),
                     make_float2(h2[0], h2[1]));
          }
          return mx;
        });
        // q(h) over q(ctx), from the values this thread just wrote (rows
        // past M: zeros)
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            const float s = row_scale<false>(amax[m][hf]);
            if (wn == 0 && (lane & 3) == 0) xs[r] = s;
            const bool live = m0 + r < M;
            #pragma unroll
            for (int n = 0; n < NT2; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float2 hv = live ? __ldcg(reinterpret_cast<const float2*>(
                                           a.hs + (size_t)(m0 + r) * D + c))
                                     : make_float2(0.f, 0.f);
              *reinterpret_cast<uint16_t*>(xq + r * l.lda + c) =
                  (uint16_t)((quant(hv.x, s) & 0xff) | ((quant(hv.y, s) & 0xff) << 8));
            }
          }
      });
}

// B3 (OPROJ false): in = h.  B8 (OPROJ true): in = ctx, x the residual of
// the O-projection, wot/so/bo its weight and vectors, g1/be1 LayerNorm 1,
// hs the f32 [M, D] scratch for h.
template <int R, int NT2, bool OPROJ>
__global__ void __launch_bounds__(NTHREADS, 1)
ffn_block_kernel(const void* __restrict__ in, const void* __restrict__ x,
                 const int8_t* __restrict__ wot, const float* __restrict__ so,
                 const float* __restrict__ bo, const float* __restrict__ g1,
                 const float* __restrict__ be1, const int8_t* __restrict__ w1t,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const int8_t* __restrict__ w2t, const float* __restrict__ s2,
                 const float* __restrict__ b2, const float* __restrict__ g,
                 const float* __restrict__ beta, float eps, float* hs,
                 void* __restrict__ out, int M, int D, int F, bool bf16) {
  using G1 = Gemm1<R>;
  using G2 = Gemm2<R, NT2>;
  static_assert(G1::ROWS == R && G2::ROWS == R && G1::THREADS == NTHREADS
                && G2::THREADS == NTHREADS, "both products cover the block's rows");
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout<R, OPROJ>(D, F);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + l.xq);
  int8_t* fq = reinterpret_cast<int8_t*>(smem + l.fq);
  float* xs = reinterpret_cast<float*>(smem + l.xs);
  float* fs = reinterpret_cast<float*>(smem + l.fs);
  unsigned* famax = reinterpret_cast<unsigned*>(fs);    // pass 1, then s_f in place
  float* red = reinterpret_cast<float*>(smem + l.red);
  int8_t* ring1 = reinterpret_cast<int8_t*>(smem + l.ring1);
  int8_t* ring2 = reinterpret_cast<int8_t*>(smem + l.ring2);
  const int m0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31;

  if (bf16)
    quant_rows_global<false, __nv_bfloat16, NW>(static_cast<const __nv_bfloat16*>(in), M,
                                                D, m0, R, xq, l.lda, xs);
  else
    quant_rows_global<false, float, NW>(static_cast<const float*>(in), M, D, m0, R, xq,
                                        l.lda, xs);
  if (threadIdx.x < R) famax[threadIdx.x] = 0u;

  if constexpr (OPROJ) {
    if (threadIdx.x == 0) stage_args = {x, wot, so, bo, g1, be1, hs, eps, bf16};
    __syncthreads();
    o_proj_stage<R, NT2>(smem, M, D, F);
  }

  // f at (row r, column c) from the first product's sum
  auto gelu_at = [&](int acc, int r, int c) {
    return gelu_tanh(dequant(acc, xs[r], s1[c], b1[c]));
  };

  // pass 1: each row's max |f|, as the bits of a non-negative float (whose
  // order is the unsigned order)
  ring_gemm<G1, RING>(xq, l.lda, w1t, D, F, ring1,  // begins with a barrier
      [&](int n0, int row0, int col0, int (&acc)[2][G1::NT][4]) {
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            float mx = 0.f;
            #pragma unroll
            for (int n = 0; n < G1::NT; ++n)
              #pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n0 + col0 + 8 * n + acc_col(e);
                if (c < F) mx = fmaxf(mx, fabsf(gelu_at(acc[m][n][2 * hf + e], r, c)));
              }
            mx = quad_max(mx);
            if ((lane & 3) == 0) atomicMax(famax + r, __float_as_uint(mx));
          }
      });
  __syncthreads();
  if (threadIdx.x < R) fs[threadIdx.x] = row_scale<false>(__uint_as_float(famax[threadIdx.x]));

  // pass 2: f again, quantized straight into q(f), two columns a store
  ring_gemm<G1, RING>(xq, l.lda, w1t, D, F, ring1,  // begins with a barrier
      [&](int n0, int row0, int col0, int (&acc)[2][G1::NT][4]) {
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            #pragma unroll
            for (int n = 0; n < G1::NT; ++n) {
              const int c = n0 + col0 + 8 * n + acc_col(0);
              if (c >= F) continue;
              const int q0 = quant(gelu_at(acc[m][n][2 * hf], r, c), fs[r]);
              const int q1 = quant(gelu_at(acc[m][n][2 * hf + 1], r, c + 1), fs[r]);
              *reinterpret_cast<uint16_t*>(fq + r * l.ldf + c) =
                  (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
            }
          }
      });

  // h's values at i, i + 1: B3's input rows, or the f32 values this thread
  // wrote to hs in stage 0 (the same (row, column) pairs)
  auto residual = [&](size_t i) {
    if constexpr (OPROJ) return __ldcg(reinterpret_cast<const float2*>(hs + i));
    else return load2(in, bf16, i);
  };

  // out = LN(q(f) @ W2 * s_f * s2 + b2 + h): one chunk of all D columns
  ring_gemm<G2, RING>(fq, l.ldf, w2t, F, D, ring2,  // begins with a barrier
      [&](int, int row0, int col0, int (&acc)[2][NT2][4]) {
        // the pre-LayerNorm rows, in the accumulators' own registers (each
        // sum is read before its slot is rewritten; with a separate array
        // the epilogue spilled twice as much under the 128-register cap)
        float (&y)[2][NT2][4] = reinterpret_cast<float (&)[2][NT2][4]>(acc);
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            const bool live = m0 + r < M;
            #pragma unroll
            for (int n = 0; n < NT2; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float2 hv = live ? residual((size_t)(m0 + r) * D + c)
                                     : make_float2(0.f, 0.f);
              const int a0 = acc[m][n][2 * hf], a1 = acc[m][n][2 * hf + 1];
              y[m][n][2 * hf] = __fadd_rn(dequant(a0, fs[r], s2[c], b2[c]), hv.x);
              y[m][n][2 * hf + 1] = __fadd_rn(dequant(a1, fs[r], s2[c + 1], b2[c + 1]), hv.y);
            }
          }
        float mean[2][2], inv[2][2];
        ln_stats<G2::WN>(y, red, row0, D, eps, mean, inv);
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            if (m0 + r >= M) continue;
            #pragma unroll
            for (int n = 0; n < NT2; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float a = (y[m][n][2 * hf] - mean[m][hf]) * inv[m][hf] * g[c] + beta[c];
              const float b =
                  (y[m][n][2 * hf + 1] - mean[m][hf]) * inv[m][hf] * g[c + 1] + beta[c + 1];
              store2(out, bf16, (size_t)(m0 + r) * D + c, a, b);
            }
          }
      });
}

struct Args {
  const void *in, *x;
  const int8_t *wot, *w1t, *w2t;
  const float *so, *bo, *g1, *be1, *s1, *b1, *s2, *b2, *g, *beta;
  float eps;
  float* hs;
  void* out;
  int M, D, F;
  bool bf16, oproj;
  cudaStream_t stream;
  int* info;        // set: report the instantiation instead of launching
};

template <int R, int NT2, bool OPROJ>
cudaError_t launch_rows(const Args& a) {
  auto* kernel = ffn_block_kernel<R, NT2, OPROJ>;
  const size_t smem = layout<R, OPROJ>(a.D, a.F).total;
  if (a.info) {
    a.info[5] = R;
    return ac_common::kernel_info(kernel, smem, NTHREADS, a.info);
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.M + R - 1) / R, NTHREADS, smem, a.stream>>>(
      a.in, a.x, a.wot, a.so, a.bo, a.g1, a.be1, a.w1t, a.s1, a.b1, a.w2t, a.s2, a.b2, a.g,
      a.beta, a.eps, a.hs, a.out, a.M, a.D, a.F, a.bf16);
  return cudaGetLastError();
}

// the instantiation of NT2 n8 tiles a warp, NT2 = nt (a multiple of STEP)
template <int R, int NT2, int STEP, bool OPROJ>
cudaError_t launch_nt(const Args& a, int nt) {
  if constexpr (NT2 * 8 * WN<R> > MAX_D) {
    return cudaErrorInvalidValue;
  } else {
    if (nt == NT2) return launch_rows<R, NT2, OPROJ>(a);
    return launch_nt<R, NT2 + STEP, STEP, OPROJ>(a, nt);
  }
}

// 64 rows a block at D 512 where they fit the card's shared memory, else
// 32 rows with the D columns over WN<32> warps
template <bool OPROJ>
int run(const Args& a) {
  if (a.M <= 0 || a.D <= 0 || a.F <= 0 || a.D % 128 != 0 || a.F % 128 != 0 || a.D > MAX_D)
    return (int)cudaErrorInvalidValue;
  int dev = 0, have = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&have, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (a.D == 512 && layout<64, OPROJ>(a.D, a.F).total <= (size_t)have)
    return (int)launch_rows<64, 512 / (8 * WN<64>), OPROJ>(a);
  if (layout<32, OPROJ>(a.D, a.F).total > (size_t)have) return (int)cudaErrorInvalidValue;
  constexpr int STEP = 128 / (8 * WN<32>);       // D % 128 == 0
  return (int)launch_nt<32, STEP, STEP, OPROJ>(a, a.D / (8 * WN<32>));
}

int run(const Args& a) { return a.oproj ? run<true>(a) : run<false>(a); }

const float* f32(const void* p) { return static_cast<const float*>(p); }
const int8_t* i8(const void* p) { return static_cast<const int8_t*>(p); }

}  // namespace

// Shared memory a block of `rows` (32 or 64) of B3 (oproj = 0) or B8
// (oproj = 1) needs at widths D, F; a launch takes 64 rows at D 512 where
// they fit, else 32, and fails past that or past D 1,024.
extern "C" long long ac_ffn_block_int8_smem_bytes(int D, int F, int rows, int oproj) {
  if (oproj) return (long long)(rows == 64 ? layout<64, true>(D, F) : layout<32, true>(D, F)).total;
  return (long long)(rows == 64 ? layout<64, false>(D, F) : layout<32, false>(D, F)).total;
}

// B3.  dtype: 0 = float32, 1 = bfloat16 (of h and out).  h, out [M, D];
// w1t [F, D] and w2t [D, F] int8: W1 and W2 transposed (K contiguous); s1,
// b1 [F], s2, b2, g, beta [D] f32; all contiguous on the current device;
// D % 128 == 0, D <= 1,024, F % 128 == 0.  Returns the launch's cudaError_t.
extern "C" int ac_ffn_block_int8(const void* h, const void* w1t, const void* s1,
                                 const void* b1, const void* w2t, const void* s2,
                                 const void* b2, const void* g, const void* beta,
                                 float eps, void* out, int M, int D, int F, int dtype,
                                 void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return run({h, nullptr, nullptr, i8(w1t), i8(w2t), nullptr, nullptr, nullptr, nullptr,
              f32(s1), f32(b1), f32(s2), f32(b2), f32(g), f32(beta), eps, nullptr, out, M, D,
              F, dtype == 1, false, static_cast<cudaStream_t>(stream), nullptr});
}

// B8.  dtype as above, of ctx, x and out [M, D]; wot [D, D], w1t [F, D] and
// w2t [D, F] int8: Wo, W1 and W2 transposed (K contiguous); so, bo, g1, be1
// (LayerNorm after attention), s2, b2, g2, be2 (after the FFN) [D] and s1,
// b1 [F] f32; hs an f32 [M, D] scratch the kernel overwrites; all
// contiguous on the current device; D % 128 == 0, D <= 1,024, F % 128 ==
// 0.  Returns the launch's cudaError_t.
extern "C" int ac_attn_ffn_block_int8(const void* ctx, const void* x, const void* wot,
                                      const void* so, const void* bo, const void* g1,
                                      const void* be1, const void* w1t, const void* s1,
                                      const void* b1, const void* w2t, const void* s2,
                                      const void* b2, const void* g2, const void* be2,
                                      float eps, void* hs, void* out, int M, int D, int F,
                                      int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return run({ctx, x, i8(wot), i8(w1t), i8(w2t), f32(so), f32(bo), f32(g1), f32(be1),
              f32(s1), f32(b1), f32(s2), f32(b2), f32(g2), f32(be2), eps,
              static_cast<float*>(hs), out, M, D, F, dtype == 1, true,
              static_cast<cudaStream_t>(stream), nullptr});
}

// The kernel ac_ffn_block_int8 (oproj = 0) or ac_attn_ffn_block_int8
// (oproj = 1) would launch at widths D, F: info[6] = registers per thread,
// shared bytes per block, threads per block, blocks resident per SM, local
// (spill) bytes per thread, rows per block.  Launches nothing.
extern "C" int ac_ffn_block_int8_info(int D, int F, int oproj, int* info) {
  return run({nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0.f, nullptr,
              nullptr, 1, D, F, false, oproj != 0, nullptr, info});
}
