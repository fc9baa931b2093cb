// Building blocks of the int8 kernels (B2, B9 in matmul_int8.cu; B3, B8 in
// ffn_int8.cu), so every kernel quantizes, multiplies and normalizes with
// the same arithmetic as the others and as their plain torch versions:
//
// - per-row symmetric int8 quantization: scale = max(absmax, 1e-8) times
//   1/127 (B2, B9: adaptive_classifier_tpu/ops/matmul_int8.py:40-45) or
//   divided by 127 (B3, B8: ops/ffn_int8.py:64,76,169); q = clip(rint(v /
//   scale), -127, 127), with rint's round-half-even and an IEEE division,
//   so the int8 operands agree bit for bit with the plain versions;
// - an int8 x int8 -> int32 tile product on the tensor cores
//   (mma.sync.m16n8k32.s8.s8.s32), exact;
// - the f32 scale/bias epilogue (acc * row_scale) * col_scale + bias, each
//   step rounded on its own (no fused multiply-add), as the plain versions
//   compute it;
// - a row LayerNorm with f32 statistics.
//
// The weights arrive as the JAX package stores them, [K, N] row-major
// (contraction rows, output columns).  The mma's B operand wants K
// contiguous for each output column, so the block stages a [tks, 64] slice
// of the weights transposed into shared memory as [64][tks + 16]: each
// thread loads 4x4 byte blocks (four 4-byte words from four K rows), turns
// them with byte permutes, and stores four words of four K values each.
// The 16-byte row pad makes the fragment reads conflict-free, and rotating
// which of its four words a lane stores first makes the staging stores
// conflict-free too.  The next slice is loaded into registers while the
// current one is multiplied (gemm_rows: B2, B8, B9).
//
// B3 reads its weights K-contiguous instead: [N, K] copies made once when
// the int8 weights reach the device (ops/ffn_int8.py k_contiguous), so a
// slice is a block of whole 16-byte rows.  ring_gemm copies [NC, KS] slices
// by 16-byte cp.async into a ring of RING slots, one barrier a slice, and
// reads both operands by ldmatrix: no register staging, no byte permutes.
// A slice keeps no row pad: its 16-byte chunks are XOR-swizzled by row, so
// the eight rows an ldmatrix phase reads fall in eight distinct bank groups.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace ac_int8 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TN = 64;          // output columns per staged weight slice
constexpr int MAX_TKS = 512;    // contraction rows per staged weight slice
constexpr int MAX_PRE = MAX_TKS / 64;  // 4x4 byte blocks per thread per slice

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// Quantize rows of an f32 array in shared memory (row stride ldv floats)
// into q (row stride ldq bytes).  One warp per row; K % 128 == 0.  With
// q aliasing v (ldq == 4 * ldv, same base) the row is quantized in place:
// the warp reads 128 values, then writes their 128 bytes over values it has
// already read (bytes [128j, 128j + 128) hold values of step j / 4 <= j).
template <bool MUL_INV>
__device__ void quant_rows_smem(const float* v, int ldv, int K, int rows,
                                int8_t* q, int ldq, float* sc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += WARPS) {
    const float* row = v + r * ldv;
    float amax = 0.f;
    for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(row[c]));
    const float s = row_scale<MUL_INV>(warp_max(amax));
    __syncwarp();
    for (int c = 4 * lane; c < K; c += 128) {
      const float4 f = *reinterpret_cast<const float4*>(row + c);
      const uint32_t w = pack4(quant(f.x, s), quant(f.y, s), quant(f.z, s), quant(f.w, s));
      __syncwarp();
      *reinterpret_cast<uint32_t*>(q + r * ldq + c) = w;
      __syncwarp();
    }
    if (lane == 0) sc[r] = s;
  }
}

// In-place LayerNorm of rows of an f32 shared-memory array: mean and
// variance in f32 over D columns, (v - mean) * rsqrt(var + eps) * g + beta.
// One warp per row.  OUT: also write the row to out (row stride D) in T,
// for rows m0 + r < M.
template <bool OUT, typename T>
__device__ void layer_norm_rows(float* v, int ldv, int D, int rows,
                                const float* __restrict__ g,
                                const float* __restrict__ beta, float eps,
                                T* __restrict__ out, int m0, int M) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += WARPS) {
    float* row = v + r * ldv;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += row[c];
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mean;
      sq += d * d;
    }
    const float var = warp_sum(sq) / (float)D;
    const float inv = 1.0f / sqrtf(var + eps);
    const bool live = m0 + r < M;
    for (int c = lane; c < D; c += 32) {
      const float y = (row[c] - mean) * inv * g[c] + beta[c];
      row[c] = y;
      if (OUT && live) out[(size_t)(m0 + r) * D + c] = from_f32<T>(y);
    }
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the m16n8k32 product: rows r0..r0+15, columns k..k+31 of
// a row-major int8 array (row stride lda bytes) in shared memory.
__device__ __forceinline__ void load_a(const int8_t* a, int lda, int r0, int k,
                                       uint32_t f[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p0 = a + (r0 + g) * lda + k + 4 * t;
  const int8_t* p1 = p0 + 8 * lda;
  f[0] = *reinterpret_cast<const uint32_t*>(p0);
  f[1] = *reinterpret_cast<const uint32_t*>(p1);
  f[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  f[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

// B fragment: output columns n0..n0+7, contraction k..k+31 of the staged
// slice bs [TN][ldb] (K contiguous for each column).
__device__ __forceinline__ void load_b(const int8_t* bs, int ldb, int n0, int k,
                                       uint32_t f[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p = bs + (n0 + g) * ldb + k + 4 * t;
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// Slice (k0..k0+tks, n0..n0+TN) of w [K, N] into registers: 4x4 byte
// blocks, block (kb, nb) = rows k0+4kb.., columns n0+4nb..  A warp's 32
// lanes take 8 column blocks x 4 row blocks, so each K row is read as 32
// contiguous bytes.  tks % 64 == 0, tks <= MAX_TKS.
__device__ __forceinline__ void fetch_w(const int8_t* __restrict__ w, int N, int k0,
                                        int n0, int tks, uint32_t pre[MAX_PRE][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = tks / 64;       // per warp; 8 warps x groups x 32 blocks
  #pragma unroll
  for (int j = 0; j < MAX_PRE; ++j) {
    if (j < groups) {
      const int gid = warp + WARPS * j;
      const int nb = (gid & 1) * 8 + (lane & 7);
      const int kb = (gid >> 1) * 4 + (lane >> 3);
      const int8_t* p = w + (size_t)(k0 + 4 * kb) * N + n0 + 4 * nb;
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        pre[j][i] = __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)i * N));
    }
  }
}

// The registers of fetch_w, transposed into bs [TN][tks + 16].
__device__ __forceinline__ void stash_w(int8_t* bs, int tks, const uint32_t pre[MAX_PRE][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldb = tks + 16;
  const int groups = tks / 64;
  const int rot = (lane & 7) >> 1;
  #pragma unroll
  for (int j = 0; j < MAX_PRE; ++j) {
    if (j < groups) {
      const int gid = warp + WARPS * j;
      const int nb = (gid & 1) * 8 + (lane & 7);
      const int kb = (gid >> 1) * 4 + (lane >> 3);
      const uint32_t r0 = pre[j][0], r1 = pre[j][1], r2 = pre[j][2], r3 = pre[j][3];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
      // c[i] = the four K values of column 4nb + i
      const uint32_t c[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
      #pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = (s + rot) & 3;
        const uint32_t v = i == 0 ? c[0] : i == 1 ? c[1] : i == 2 ? c[2] : c[3];
        *reinterpret_cast<uint32_t*>(bs + (4 * nb + i) * ldb + 4 * kb) = v;
      }
    }
  }
}

// Contraction depth of a staged slice: the largest of 512, 384, 256, 128
// that divides K (K % 128 == 0).
__host__ __device__ __forceinline__ int slice_depth(int K) {
  for (int t = MAX_TKS; t > 128; t -= 128)
    if (K % t == 0) return t;
  return 128;
}

// C = A[rows of this block] x W over all N, in TN-column tiles.  The block's
// 8 warps form a WARPS_M x WARPS_N grid; warp (wm, wn) owns rows
// wm*MT*16.. (MT m16 tiles) and columns wn*NT*8.. (NT n8 tiles) of each
// tile.  After the last slice of a column tile the warp calls
// epi(n0, row0, col0, acc), where acc[m][n][i] is the int32 sum at row
// row0 + 16m + g + 8*(i >= 2), column n0 + col0 + 8n + 2t + (i & 1).
// a: int8 [rows][lda] in shared memory; bs: staging, TN * (MAX_TKS + 16)
// bytes.  K % 128 == 0, N % TN == 0.  Begins with a barrier, so a caller
// that has just written a need not.
template <int MT, int NT, int WARPS_N, typename Epi>
__device__ void gemm_rows(const int8_t* a, int lda, const int8_t* __restrict__ w,
                          int K, int N, int8_t* bs, Epi epi) {
  static_assert(WARPS_N * NT * 8 == TN, "warps must tile the column slice");
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp / WARPS_N) * MT * 16;
  const int col0 = (warp % WARPS_N) * NT * 8;
  const int tks = slice_depth(K);
  const int ldb = tks + 16;
  const int kst = K / tks;
  const int total = kst * (N / TN);
  uint32_t pre[MAX_PRE][4];
  int acc[MT][NT][4];
  fetch_w(w, N, 0, 0, tks, pre);
  for (int s = 0; s < total; ++s) {
    const int n0 = (s / kst) * TN, k0 = (s % kst) * tks;
    if (k0 == 0) {
      #pragma unroll
      for (int m = 0; m < MT; ++m)
        #pragma unroll
        for (int n = 0; n < NT; ++n)
          #pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
    }
    __syncthreads();                 // the previous slice is consumed
    stash_w(bs, tks, pre);
    __syncthreads();
    if (s + 1 < total) {
      const int s1 = s + 1;
      fetch_w(w, N, (s1 % kst) * tks, (s1 / kst) * TN, tks, pre);
    }
    for (int kk = 0; kk < tks; kk += 32) {
      uint32_t fa[MT][4], fb[NT][2];
      #pragma unroll
      for (int m = 0; m < MT; ++m) load_a(a, lda, row0 + 16 * m, k0 + kk, fa[m]);
      #pragma unroll
      for (int n = 0; n < NT; ++n) load_b(bs, ldb, col0 + 8 * n, kk, fb[n]);
      #pragma unroll
      for (int m = 0; m < MT; ++m)
        #pragma unroll
        for (int n = 0; n < NT; ++n) mma_s8(acc[m][n], fa[m], fb[n]);
    }
    if (k0 + tks == K) epi(n0, row0, col0, acc);
  }
}

// Coordinates of accumulator entry i of an m16n8 tile, relative to the
// tile's corner.
__device__ __forceinline__ int acc_row(int i) { return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int acc_col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }

// ---------------------------------------------------------------------------
// ring_gemm: K-contiguous weights through a cp.async ring (B3)
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

}  // namespace ac_int8
