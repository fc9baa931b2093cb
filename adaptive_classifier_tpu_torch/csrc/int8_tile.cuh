// Building blocks of the int8 kernels (B2, B9 in matmul_int8.cu; B3 in
// ffn_block_int8.cu; B8 in int8_hopper.cuh, which takes the arithmetic
// below and multiplies with wgmma), so every kernel quantizes, multiplies
// and normalizes with the same arithmetic as the others and as their plain
// torch versions:
//
// - per-row symmetric int8 quantization: scale = max(absmax, 1e-8) times
//   1/127 (B2, B9: adaptive_classifier_tpu/ops/matmul_int8.py:40-45) or
//   divided by 127 (B3, B8: ops/ffn_int8.py:64,76,169); q = clip(rint(v /
//   scale), -127, 127), with rint's round-half-even and the IEEE division's
//   quotient (quant; B2, B3 and B8 take it from the scale's reciprocal,
//   quant_rcp, the same float), so the int8 operands agree bit for bit
//   with the plain versions;
// - an int8 x int8 -> int32 tile product on the tensor cores
//   (mma.sync.m16n8k32.s8.s8.s32; B8: wgmma), exact;
// - the f32 scale/bias epilogue (acc * row_scale) * col_scale + bias, each
//   step rounded on its own (no fused multiply-add), as the plain versions
//   compute it;
// - a row LayerNorm with f32 statistics, its sums reduced across the
//   column warps of a block (ln_stats).
//
// ring_gemm reads the weights K-contiguous: [N, K] copies made once per
// weight (ops/ffn_int8.py k_contiguous), so a slice is a block of whole
// 16-byte rows.  It copies [NC, KS] slices by 16-byte cp.async into a ring
// of RING slots, one barrier a slice, and reads both operands by ldmatrix:
// no register staging, no byte permutes.  A slice keeps no row pad: its
// 16-byte chunks are XOR-swizzled by row, so the eight rows an ldmatrix
// phase reads fall in eight distinct bank groups.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace ac_int8 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row scale from the row's absolute maximum.  MUL_INV: absmax * (1/127)
// (B2, B9); else absmax / 127 (B3, B8).
template <bool MUL_INV>
__device__ __forceinline__ float row_scale(float absmax) {
  const float a = fmaxf(absmax, 1e-8f);
  return MUL_INV ? __fmul_rn(a, 1.0f / 127.0f) : __fdiv_rn(a, 127.0f);
}

__device__ __forceinline__ int quant(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// v / d from rcp = __frcp_rn(d), the correctly rounded reciprocal, and one
// exact remainder: q = v rcp, r = v - d q (an FMA, exact), q + r rcp
// rounded once (Markstein's correction) is the same float as __fdiv_rn(v,
// d), without its slow path, for quotients of normal range; for a divisor
// reused across a row
__device__ __forceinline__ float div_rcp(float v, float d, float rcp) {
  const float q = __fmul_rn(v, rcp);
  return __fmaf_rn(__fmaf_rn(-d, q, v), rcp, q);
}

// quant(v, scale) with the quotient from div_rcp
__device__ __forceinline__ int quant_rcp(float v, float scale, float rcp) {
  return (int)fminf(fmaxf(rintf(div_rcp(v, scale, rcp)), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// (acc * row_scale) * col_scale + bias, each step rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float cs, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), b);
}

// 0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))), in the order
// of ffn_int8.py:46-53, each step rounded on its own
__device__ __forceinline__ float gelu_tanh(float x) {
  const float g0 = 0.7978845608028654f;   // float32(sqrt(2 / pi))
  const float g1 = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(g1, x), x), x);
  const float inner = __fmul_rn(g0, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// Quantize rows [m0, m0 + rows) of a [M, K] row-major global array (rows at
// or past M become zeros) into q (row stride ldq bytes), scales into sc.
// One warp per row, NW warps; K % 128 == 0.
template <bool MUL_INV, typename T, int NW = WARPS>
__device__ void quant_rows_global(const T* __restrict__ x, int M, int K, int m0,
                                  int rows, int8_t* q, int ldq, float* sc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NW) {
    const int gr = m0 + r;
    const T* row = x + (size_t)gr * K;
    float amax = 0.f;
    if (gr < M)
      for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_f32(row[c])));
    const float s = row_scale<MUL_INV>(warp_max(amax));
    for (int c = 4 * lane; c < K; c += 128) {
      uint32_t w = 0;
      if (gr < M)
        w = pack4(quant(to_f32(row[c]), s), quant(to_f32(row[c + 1]), s),
                  quant(to_f32(row[c + 2]), s), quant(to_f32(row[c + 3]), s));
      *reinterpret_cast<uint32_t*>(q + r * ldq + c) = w;
    }
    if (lane == 0) sc[r] = s;
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Coordinates of accumulator entry i of an m16n8 tile, relative to the
// tile's corner.
__device__ __forceinline__ int acc_row(int i) { return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int acc_col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }

// ---------------------------------------------------------------------------
// ring_gemm: K-contiguous weights through a cp.async ring (B2, B3, B9)
// ---------------------------------------------------------------------------

// Geometry of one ring_gemm: WM x WN warps, each MT m16 x NT n8 tiles, so a
// block's product covers ROWS rows and NC columns (a chunk) and steps over
// KS bytes of the contraction a slice.  A slice [NC][KS] is SLOT bytes.
template <int WM_, int WN_, int MT_, int NT_, int KS_>
struct Ring {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_, KS = KS_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int ROWS = 16 * MT * WM;
  static constexpr int NC = 8 * NT * WN;
  static constexpr int CPR = KS / 16;          // 16-byte chunks a staged row
  static constexpr int SLOT = NC * KS;
  static_assert(KS % 32 == 0 && KS <= 128, "slices are whole m16n8k32 steps");
};

// Byte offset of chunk c of row r of a swizzled slice: chunk c ^ (the row's
// group), so the eight rows an ldmatrix phase reads (any eight consecutive
// rows, one chunk column) fall in eight distinct 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  return r * CPR * 16 + 16 * (c ^ ((r * CPR / 8) % CPR));
}

// Rows n0 .. n0 + NC of wt [N][K], bytes k0 .. k0 + KS of each, into a
// ring slot; rows at or past N become zeros.  The caller commits.
template <class G>
__device__ __forceinline__ void stage_slice(int8_t* slot, const int8_t* __restrict__ wt,
                                            int K, int N, int n0, int k0) {
  for (int i = threadIdx.x; i < G::NC * G::CPR; i += G::THREADS) {
    const int r = i / G::CPR, c = i % G::CPR, n = n0 + r;
    ac_common::cp_async16(slot + swz<G::CPR>(r, c),
                          wt + (size_t)(n < N ? n : 0) * K + k0 + 16 * c, n < N ? 16 : 0);
  }
}

// C = A x W over all N columns, a chunk of NC columns at a time: A int8
// [G::ROWS][lda] in shared memory (K contiguous; lda % 128 == 16, so its
// ldmatrix rows are conflict-free), wt the weight's K-contiguous copy [N][K]
// in device memory.  Slices [NC][KS] go through `ring` (RING * G::SLOT
// bytes), RING - 1 of them in flight while one is multiplied; one barrier a
// slice.  After the last slice of a chunk each warp calls epi(n0, row0,
// col0, acc): acc[m][n][i] is the int32 sum at row row0 + 16m + acc_row(i),
// column n0 + col0 + 8n + acc_col(i), columns at or past N summed over zero
// weights.  Begins with a barrier, so a caller that has just written A or
// finished with the ring need not; K % KS == 0.
template <class G, int RING, typename Epi>
__device__ void ring_gemm(const int8_t* a, int lda, const int8_t* __restrict__ wt, int K,
                          int N, int8_t* ring, Epi epi) {
  static_assert(RING >= 2 && RING <= 3, "cp_async_wait_pending takes 0 or 1");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp / G::WN) * G::MT * 16;
  const int col0 = (warp % G::WN) * G::NT * 8;
  const int kst = K / G::KS;
  const int steps = (N + G::NC - 1) / G::NC * kst;
  auto stage = [&](int s) {
    if (s < steps)
      stage_slice<G>(ring + (s % RING) * G::SLOT, wt, K, N, s / kst * G::NC,
                     s % kst * G::KS);
    ac_common::cp_async_commit();
  };
  __syncthreads();
  #pragma unroll
  for (int s = 0; s < RING - 1; ++s) stage(s);

  // lane's rows of the ldmatrix phases: A rows (lane & 7) + 8 ((lane >> 3) & 1)
  // at chunk lane >> 4; B rows (lane & 7) + 8 (lane >> 4) at chunk (lane >> 3) & 1
  const int8_t* a_lane = a + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda
                         + 16 * (lane >> 4);
  const int b_row = col0 + (lane & 7) + 8 * (lane >> 4), b_chunk = (lane >> 3) & 1;
  int acc[G::MT][G::NT][4];
  for (int s = 0; s < steps; ++s) {
    ac_common::cp_async_wait_pending(RING - 2);  // slice s has landed
    __syncthreads();                              // for all; slot s - 1 is free
    stage(s + RING - 1);
    const int ks = s % kst;
    if (ks == 0) {
      #pragma unroll
      for (int m = 0; m < G::MT; ++m)
        #pragma unroll
        for (int n = 0; n < G::NT; ++n)
          #pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
    }
    const int8_t* bs = ring + (s % RING) * G::SLOT;
    #pragma unroll
    for (int kk = 0; kk < G::CPR; kk += 2) {
      uint32_t fa[G::MT][4], fb[G::NT][2];
      #pragma unroll
      for (int m = 0; m < G::MT; ++m)
        ac_common::ldsm_x4(fa[m], a_lane + 16 * m * lda + ks * G::KS + 16 * kk);
      #pragma unroll
      for (int np = 0; np < G::NT / 2; ++np) {
        uint32_t r[4];
        ac_common::ldsm_x4(r, bs + swz<G::CPR>(b_row + 16 * np, kk + b_chunk));
        fb[2 * np][0] = r[0];
        fb[2 * np][1] = r[1];
        fb[2 * np + 1][0] = r[2];
        fb[2 * np + 1][1] = r[3];
      }
      if (G::NT % 2) {                          // the last n8 tile alone
        uint32_t r[2];
        ac_common::ldsm_x2(r, bs + swz<G::CPR>(col0 + 8 * (G::NT - 1) + (lane & 7),
                                               kk + b_chunk));
        fb[G::NT - 1][0] = r[0];
        fb[G::NT - 1][1] = r[1];
      }
      #pragma unroll
      for (int m = 0; m < G::MT; ++m)
        #pragma unroll
        for (int n = 0; n < G::NT; ++n) mma_s8(acc[m][n], fa[m], fb[n]);
    }
    if (ks == kst - 1) epi(s / kst * G::NC, row0, col0, acc);
  }
}

// ---------------------------------------------------------------------------
// epilogues (B3, B9; B8 takes the pair loads and stores): pairs of
// elements, and row statistics reduced across the column warps of a block
// ---------------------------------------------------------------------------

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

// The totals of the thread's 2 MT rows (row0 + 16m + acc_row(2 hf)) over
// the block's WN column warps: part(m, hf), the thread's own part of a row
// (a sum, or a maximum of values >= 0), then the quad's, then the warps' in
// order through red [rows][WN].  Two barriers; red is free again on return.
template <int WN_, bool MAX, int MT, typename Part>
__device__ __forceinline__ void row_totals(float (&tot)[MT][2], float* red, int row0,
                                           Part part) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) % WN_;
  #pragma unroll
  for (int m = 0; m < MT; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float p = part(m, hf);
      const float v = MAX ? quad_max(p) : quad_sum(p);
      if ((lane & 3) == 0) red[(row0 + 16 * m + acc_row(2 * hf)) * WN_ + wn] = v;
    }
  __syncthreads();
  #pragma unroll
  for (int m = 0; m < MT; ++m)
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

// LayerNorm statistics of the thread's rows of y (a warp's MT x NT tiles
// of a ring_gemm chunk that covers all D columns across the WN warps): the
// row's sum, then its squared deviations, each over all D columns.
template <int WN_, int MT, int NT>
__device__ __forceinline__ void ln_stats(const float (&y)[MT][NT][4], float* red, int row0,
                                         int D, float eps, float (&mean)[MT][2],
                                         float (&inv)[MT][2]) {
  row_totals<WN_, false>(mean, red, row0, [&](int m, int hf) {
    float p = 0.f;
    #pragma unroll
    for (int n = 0; n < NT; ++n)
      #pragma unroll
      for (int e = 0; e < 2; ++e) p += y[m][n][2 * hf + e];
    return p;
  });
  #pragma unroll
  for (int m = 0; m < MT; ++m)
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
  for (int m = 0; m < MT; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) inv[m][hf] = 1.0f / sqrtf(inv[m][hf] / (float)D + eps);
}

}  // namespace ac_int8
