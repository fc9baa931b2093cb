// The bf16 tensor-core tile loop of the attention kernels' short rows (S
// <= 64: one_tile_rows, for B1 in attention_qkv.cu and B6, B7 in
// flash_attention.cu), and the softmax helpers that attention_hopper.cuh
// (every longer row) shares.  Each warp owns 16 query rows, and a block of
// NW warps multiplies its 16 * NW query rows by one staged TK-key tile.
//
// - Products: mma.sync.m16n8k16 bf16 x bf16 -> f32 for Q K^T and for P V.
//   A bf16 product is exact in f32, so the only differences from a plain
//   f32 product of the same bf16 values are the order of the sums.
// - Fragments: a warp's Q rows are loaded with ldmatrix; K comes from
//   shared memory by ldmatrix, V by ldmatrix.trans.  The scores stay in the
//   f32 accumulator layout (rows g = lane / 4 and g + 8, columns 2 (lane %
//   4) + {0, 1} of each 8-key block), so a row's max and sum take two quad
//   shuffles, and the accumulators of two neighbouring 8-key blocks are,
//   rounded to bf16, the A operand of the P V product: p never goes
//   through shared memory.
// - exp(s - m) is taken as 2^(s' - m') on scores s' = s log2(e): log2(e) is
//   folded into the scale and the bias, so a score costs one ex2 and no
//   range reduction.  s' - m' is formed before the ex2, so a row whose keys
//   are all masked (every s' the same -1.4e9) gets p = 1 exactly.
// - Staging: tiles are kept in shared memory as bf16, rows padded to DHP +
//   8 elements (16 bytes), so the eight 16-byte rows an ldmatrix phase
//   reads fall in eight distinct bank groups.  ALIGNED tiles (16-byte
//   aligned rows, Dh % 8 == 0) are copied with 16-byte cp.async.cg;
//   otherwise element by element.  Rows past S are zeros; columns Dh..DHP
//   are zeroed, so Dh is zero-padded to DHP (32, 64 or 128) and every
//   product runs over whole DHP columns with no run-time bound inside its
//   unrolled loops.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ac_attn {

using bf16 = __nv_bfloat16;

constexpr float MASK_BIAS = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// additive bias of key s: 0 valid, -1e9 masked, -inf past S (no key there)
__device__ __forceinline__ float key_bias(const int* __restrict__ mrow, int s, int S) {
  return s < S ? (mrow[s] > 0 ? 0.f : MASK_BIAS) : -INFINITY;
}

// Geometry of one instantiation: DHP the padded head width (a multiple of
// 16), NW warps of 16 query rows, TK keys per staged tile.
template <int DHP_, int NW_, int TK_>
struct Tile {
  static constexpr int DHP = DHP_;
  static constexpr int NW = NW_;
  static constexpr int TK = TK_;
  static constexpr int THREADS = 32 * NW;
  static constexpr int TQ = 16 * NW;
  static constexpr int LDS = DHP + 8;          // shared row stride, elements
  static constexpr int NKT = TK / 8;           // 8-key score blocks per tile
  static constexpr int NDT = DHP / 8;          // 8-column output blocks
  static constexpr int Q_ELEMS = TQ * LDS;
  static constexpr int KV_ELEMS = TK * LDS;
  static constexpr int SMEM_ROWS = TQ + 2 * TK;  // bf16 rows: Q, K, V
  static_assert(DHP % 16 == 0 && TK % 16 == 0, "mma steps are 16 deep");
  static_assert(THREADS % (DHP / 8) == 0, "a thread stages one 16-byte column");
  // Q | K | V | TK key biases (f32)
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * size_t(SMEM_ROWS) * LDS + sizeof(float) * size_t(TK);
  }
};

// Blocks per SM a kernel's register budget is set for: 512 threads at
// Dh <= 64 (128 registers a thread), 256 at Dh 128.
template <class Tl>
constexpr int kMinBlocks = (Tl::DHP <= 64 ? 512 : 256) / Tl::THREADS;

// Pointers into a block's dynamic shared memory, laid out as smem_bytes counts.
template <class Tl>
struct Smem {
  bf16* q;        // [TQ][LDS]
  bf16* k;        // [TK][LDS]
  bf16* v;        // [TK][LDS]
  float* b;       // [TK]
  __device__ explicit Smem(unsigned char* raw)
      : q(reinterpret_cast<bf16*>(raw)), k(q + Tl::Q_ELEMS), v(k + Tl::KV_ELEMS),
        b(reinterpret_cast<float*>(v + Tl::KV_ELEMS)) {}
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

using ac_common::cp_async16;
using ac_common::cp_async_commit;
using ac_common::cp_async_wait_all;
using ac_common::ldsm_x4;
using ac_common::smem_addr;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a b over one 16 x 8 x 16 step, f32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: 2 ulp; -inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max / sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// Zero columns [Dh, DHP) of n rows (stride LDS); cp.async never writes
// them, so once is enough.
template <class Tl>
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int n, int Dh) {
  const int w = Tl::DHP - Dh;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < n * w; i += Tl::THREADS)
    dst[(i / w) * Tl::LDS + Dh + i % w] = __float2bfloat16(0.f);
}

// Rows [r0, r0 + n) of one head's [S, Dh] slice (row stride ss elements)
// into dst [n][LDS]; rows past S become zeros.  ALIGNED: base and ss give
// 16-byte aligned rows and Dh % 8 == 0, copied by cp.async (the caller
// commits); else element by element.
template <class Tl, bool ALIGNED>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ base,
                                           long long ss, int r0, int n, int S, int Dh) {
  if constexpr (ALIGNED) {
    // thread t copies 16-byte column t % CPR of rows t / CPR + k RSTEP
    constexpr int CPR = Tl::DHP / 8;
    constexpr int RSTEP = Tl::THREADS / CPR;
    const int c = threadIdx.x % CPR;
    if (8 * c >= Dh) return;
    base += 8 * c;
    dst += 8 * c;
    #pragma unroll 4
    for (int r = threadIdx.x / CPR; r < n; r += RSTEP) {
      const int s = r0 + r;
      cp_async16(dst + r * Tl::LDS, s < S ? base + (long long)s * ss : base, s < S ? 16 : 0);
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bf16 zero = __float2bfloat16(0.f);
    for (int r = warp; r < n; r += Tl::NW) {
      const int s = r0 + r;
      const bf16* src = base + (long long)s * ss;
      for (int d = lane; d < Dh; d += 32) dst[r * Tl::LDS + d] = s < S ? src[d] : zero;
    }
  }
}

// key biases of tile [k0, k0 + TK) into bs[TK], times log2(e)
template <class Tl>
__device__ __forceinline__ void stage_bias(float* bs, const int* __restrict__ mrow,
                                           int k0, int S) {
  for (int i = threadIdx.x; i < Tl::TK; i += Tl::THREADS)
    bs[i] = key_bias(mrow, k0 + i, S) * LOG2E;
}

// ---------------------------------------------------------------------------
// products and softmax
// ---------------------------------------------------------------------------

// A fragments of the warp's 16 query rows (rows 16 warp.. of Qs), one per
// 16-column step.
template <class Tl>
__device__ __forceinline__ void load_q(const bf16* Qs, uint32_t qf[Tl::DHP / 16][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* p = Qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * Tl::LDS
                  + 8 * (lane >> 4);
  #pragma unroll
  for (int ks = 0; ks < Tl::DHP / 16; ++ks) ldsm_x4(qf[ks], p + 16 * ks);
}

// Scores of the warp's rows against the staged K tile, in log2 units:
// sc[n] is the 16 x 8 block of keys 8n..8n+7, raw product times scale2
// plus the key's bias2 (bs).
template <class Tl>
__device__ __forceinline__ void tile_scores(const uint32_t qf[Tl::DHP / 16][4],
                                            const bf16* Ks, const float* bs, float scale2,
                                            float sc[Tl::NKT][4]) {
  const int lane = threadIdx.x & 31;
  #pragma unroll
  for (int n = 0; n < Tl::NKT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
  const bf16* p = Ks + ((lane & 7) + 8 * (lane >> 4)) * Tl::LDS + 8 * ((lane >> 3) & 1);
  #pragma unroll
  for (int ks = 0; ks < Tl::DHP / 16; ++ks) {
    #pragma unroll
    for (int np = 0; np < Tl::NKT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, p + 16 * np * Tl::LDS + 16 * ks);
      mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
      mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
    }
  }
  const int t = lane & 3;
  #pragma unroll
  for (int n = 0; n < Tl::NKT; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t);
    sc[n][0] = sc[n][0] * scale2 + bb.x;
    sc[n][1] = sc[n][1] * scale2 + bb.y;
    sc[n][2] = sc[n][2] * scale2 + bb.x;
    sc[n][3] = sc[n][3] * scale2 + bb.y;
  }
}

// o += bf16(p) V over the staged V tile
template <class Tl>
__device__ __forceinline__ void tile_pv(const float p[Tl::NKT][4], const bf16* Vs,
                                        float o[Tl::NDT][4]) {
  const int lane = threadIdx.x & 31;
  const bf16* v = Vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * Tl::LDS + 8 * (lane >> 4);
  #pragma unroll
  for (int kk = 0; kk < Tl::TK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    #pragma unroll
    for (int dp = 0; dp < Tl::DHP / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, v + 16 * kk * Tl::LDS + 16 * dp);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The warp's output rows (o in the accumulator layout) to out [B, S, H, Dh]
// at (b, ., h): through the warp's own rows of the Q tile (no longer read),
// then as 16-byte rows (ALIGNED) or element by element.
template <class Tl, bool ALIGNED>
__device__ __forceinline__ void store_rows(bf16* Qs, const float o[Tl::NDT][4],
                                           bf16* __restrict__ out, int b, int q0, int S,
                                           int H, int h, int Dh) {
  constexpr int WR = 16;                       // rows of a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* rows = Qs + WR * warp * Tl::LDS;
  #pragma unroll
  for (int n = 0; n < Tl::NDT; ++n) {
    bf16* r0 = rows + g * Tl::LDS + 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(r0) = pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(r0 + 8 * Tl::LDS) = pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  const long long D = (long long)H * Dh;
  const int s0 = q0 + WR * warp;
  if constexpr (ALIGNED) {
    constexpr int CPR = Tl::DHP / 8;
    const int live = Dh / 8;
    for (int i = lane; i < WR * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      if (c >= live || s0 + r >= S) continue;
      *reinterpret_cast<uint4*>(out + ((long long)b * S + s0 + r) * D + (long long)h * Dh
                                + 8 * c) =
          *reinterpret_cast<const uint4*>(rows + r * Tl::LDS + 8 * c);
    }
  } else {
    for (int r = 0; r < WR; ++r) {
      if (s0 + r >= S) break;
      bf16* orow = out + ((long long)b * S + s0 + r) * D + (long long)h * Dh;
      for (int d = lane; d < Dh; d += 32) orow[d] = rows[r * Tl::LDS + d];
    }
  }
}

// ---------------------------------------------------------------------------
// the row softmax over one staged tile (B1, B6 and B7 at S <= TK)
// ---------------------------------------------------------------------------

// softmax(s) v for the block's query tile of a row of at most TK keys: Q,
// K, V and the key biases staged at once, every score of a warp's rows in
// registers.  B1's and B7's order: p = exp(s - m) / max(l, 1e-30) rounded
// to bf16 before the PV product.  FLASH_ORDER (B6's recurrence over its one
// tile): p = exp(s - m) rounded to bf16, l summed from the unrounded p, and
// the PV product times 1 / max(l, 1e-30).  q, k, v at their head's offset
// of batch row b, rows ss elements apart; out [B, S, H, Dh].
template <class Tl, bool ALIGNED, bool FLASH_ORDER = false>
__device__ __forceinline__ void one_tile_rows(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const int* __restrict__ mrow,
                                              bf16* __restrict__ out, int b, int h, int S,
                                              int H, int Dh, long long ss, float scale2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<Tl> sm(smem_raw);
  const int q0 = blockIdx.x * Tl::TQ;
  zero_pad_cols<Tl>(sm.q, Tl::SMEM_ROWS, Dh);
  stage_rows<Tl, ALIGNED>(sm.q, q, ss, q0, Tl::TQ, S, Dh);
  stage_rows<Tl, ALIGNED>(sm.k, k, ss, 0, Tl::TK, S, Dh);
  stage_rows<Tl, ALIGNED>(sm.v, v, ss, 0, Tl::TK, S, Dh);
  stage_bias<Tl>(sm.b, mrow, 0, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[Tl::DHP / 16][4];
  float sc[Tl::NKT][4];
  load_q<Tl>(sm.q, qf);
  tile_scores<Tl>(qf, sm.k, sm.b, scale2, sc);

  // p = 2^(s - m) (/ max(l, 1e-30) unless FLASH_ORDER; rounded to bf16 in
  // tile_pv); the thread's rows g (r = 0) and g + 8 (r = 1)
  float inv_l[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
    #pragma unroll
    for (int n = 0; n < Tl::NKT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    mx = quad_max(mx);
    float sum = 0.f;
    #pragma unroll
    for (int n = 0; n < Tl::NKT; ++n) {
      sc[n][2 * r] = exp2_approx(sc[n][2 * r] - mx);
      sc[n][2 * r + 1] = exp2_approx(sc[n][2 * r + 1] - mx);
      sum += sc[n][2 * r] + sc[n][2 * r + 1];
    }
    inv_l[r] = 1.f / fmaxf(quad_sum(sum), 1e-30f);
    if (!FLASH_ORDER) {
      #pragma unroll
      for (int n = 0; n < Tl::NKT; ++n) {
        sc[n][2 * r] *= inv_l[r];
        sc[n][2 * r + 1] *= inv_l[r];
      }
    }
  }

  float o[Tl::NDT][4];
  #pragma unroll
  for (int n = 0; n < Tl::NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  tile_pv<Tl>(sc, sm.v, o);
  if (FLASH_ORDER) {
    #pragma unroll
    for (int n = 0; n < Tl::NDT; ++n)
      #pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= inv_l[e >> 1];
  }
  store_rows<Tl, ALIGNED>(sm.q, o, out, b, q0, S, H, h, Dh);
}

}  // namespace ac_attn
