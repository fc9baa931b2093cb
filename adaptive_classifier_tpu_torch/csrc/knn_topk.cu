// Kernel B5: exact streaming top-k of prototype similarities, never writing
// the [B, C] similarity matrix to device memory.
//
// Replaces the TPU kernel adaptive_classifier_tpu/ops/knn_topk.py:120
// `_topk_sims_pallas` (pallas_call at :136, body `_make_kernel` :66).
//
// For q [B, D], p [C, D], valid [C] bool and bias [C] f32, selects per query
// the k <= 128 largest of
//     v[c] = valid[c] ? exp(-max(|q|^2 + |p_c|^2 - 2 q.p_c, 0)) + bias[c] : -1e9
// ordered by value, descending, equal values by the lower prototype index
// (the order jax.lax.top_k gives), and writes vals [B, k] f32 and
// idx [B, k] int32.  Requires k <= C.  The softmax over the k, the masking
// past the number of valid prototypes and the bias-free raw similarities are
// the caller's (ops/knn_topk.py), as in the Pallas wrapper.
//
// What bounds it on an H100: operations.  It does 2*B*C*D FLOP against
// 4*(B*D + C*D + 2*C) + 8*B*k bytes; at the main path's B = 256, C = 16384,
// D = 512, k = 5 that is 4.3 GFLOP (64 us at the 67 TFLOP/s f32 peak outside
// the tensor cores) against 34 MB (10 us at 3.35 TB/s).  Its tensor-core
// product below issues three TF32 products for each: 12.9 GFLOP, 26 us at
// the 495 TFLOP/s dense TF32 peak.
//
// Design.  The Pallas kernel walks the prototype tiles on a sequential grid
// axis and carries the running top-k in VMEM from one step to the next.  A
// GPU's blocks run in no order, so the walk is split in two passes:
//  1. topk_partial_kernel: a block per (64-query tile, contiguous range of
//     128-prototype tiles), 8 warps of 32 queries x 32 prototypes.
//     - The dot products run on the tensor cores in three TF32 products
//       (mma.sync m16n8k8): each f32 operand x is split into hi, x with its
//       low 13 bits cleared (what the tensor cores read of an f32 register),
//       and lo = tf32(x - hi), and hi.lo + lo.hi + hi.hi accumulate in f32
//       (the scheme of CUTLASS's OpMultiplyAddFastF32).  The dropped lo.lo
//       term and the rounding of lo leave an error of ~2^-20 |q||p| a sum:
//       f32's level, where one TF32 product would move exp(-d^2) by ~1e-3.
//     - A slice's products sum in a fresh f32 accumulator, added to the
//       running dot product by one IEEE add: the tensor cores add with
//       truncation, and 3 D / 8 such adds into one running sum near |q||p|
//       drift by ~1e-5 (measured against the plain version at D 512).
//     - Query and prototype rows reach shared memory in [rows, 32] f32
//       slices by 16-byte cp.async through a two-slot ring.  Once a slice
//       has landed, the block splits it once: lo into a tile of its own
//       (hi is the slice itself, read as TF32), each row's squares summed
//       on the way (the norms).  The warps then read both by ldmatrix (a
//       32-bit element is two 16-bit halves), so the product loop holds no
//       conversion and no norm: splitting in each warp's registers repeated
//       the work four times for the query rows and twice for the
//       prototypes, and ran slower (PERF.md).
//     - Selection (select_tile, once a tile).  Each query row keeps, in
//       each column warp, a sorted list of the k best it has seen there,
//       and that list's k-th value thr (-inf while not full).  Every
//       thread scores its 32 candidates in registers and keeps only those
//       above their list's thr: an equal value came from an earlier tile,
//       so its lower index wins the tie.  The survivors' values are parked
//       in a [64, 128] tile (over the lo tile, free by then) and their
//       columns in a bit mask that the quad of lanes that scored a row ORs
//       together.  Lane L of each warp owns row wm * 32 + L of that warp's
//       list: it takes the mask from the quad by a shuffle and inserts the
//       survivors in ascending prototype order, in registers (k <= 8:
//       compare-and-swap down the list, no memory in the chain), so the
//       whole warp selects and no block barrier waits on it.  After the
//       first tile of a range almost nothing survives.  Past k 8 a row
//       keeps one list in shared memory, and the column warps insert into
//       it in turns.  At the end the four lists of a row are merged into
//       one, so each block writes its range's k winners (fewer if the
//       range is shorter, padded with -inf, INT_MAX).
//  2. topk_merge_kernel: a warp per query merges the ranges' sorted lists by
//     (value desc, index asc): k rounds, each taking the best list head
//     across the warp, the heads held in registers.  The ranges partition
//     [0, C), so the union of their winners holds the global top-k, and
//     the index order settles ties exactly as the lower-index rule.
// Only the [S, B, k] candidates of pass 1 and the [B, k] result reach device
// memory.  The split count S is chosen by the caller so that the pass-1 grid
// fills the card (ac_topk_sims_info reports the blocks an SM holds).
// What holds it back (PERF.md): the product loop alone runs in about half
// the kernel's time; keeping the running dot products live beside the
// slice's sums (64 registers of the 128 that two blocks an SM allow) nearly
// doubles it, and the selection adds a fifth.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "knn_tile.cuh"

namespace {

using ac_knn::sim_from_dot;

constexpr int KMAX = 128;
constexpr int MAX_SPLITS = 256;
constexpr int MERGE_WARPS = 4;
constexpr float INVALID = -1e9f;

constexpr int BM = 64;              // query rows a block
constexpr int BN = 128;             // prototypes a tile
constexpr int WN = 4;               // warps side by side over a tile's prototypes
constexpr int NWARPS = 8;           // 2 x 4 warps of 32 x 32
constexpr int NTHREADS = 32 * NWARPS;
constexpr int MT = 2, NT = 4;       // m16 x n8 tiles a warp
constexpr int KS = 32;              // contraction columns (f32) a slice
constexpr int CPR = KS / 4;         // 16-byte chunks a staged row
constexpr int LDS = KS + 4;         // staged row stride in floats: ldmatrix rows
                                    // 4 banks apart, conflict-free
constexpr int RING = 2;             // slots: RING - 1 in flight, one read
constexpr int SLOT = (BM + BN) * LDS;  // floats a slot: query rows, then prototypes
constexpr int CHUNKS = (BM + BN) * CPR / NTHREADS;   // chunks a thread splits
constexpr int PARK_LD = BN + 4;     // parked values' row stride
constexpr int KREG = 8;             // up to this k, lists in registers, one a column warp

static_assert(2 * 32 * MT / 2 == BM && WN * 8 * NT == BN, "the warps tile the block");
static_assert((BM + BN) * CPR % NTHREADS == 0 && NTHREADS % CPR == 0,
              "a thread splits whole chunks of the same rows every slice");

// sorted lists a query row keeps in a block
__host__ __device__ inline int lists_per_row(int k) { return k <= KREG ? WN : 1; }

// (va, ia) ranks before (vb, ib): larger value, then lower index
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// An f32 register read as a TF32 operand keeps its top 19 bits: hi(x) = x
// with the low 13 bits cleared.  tf32_rest(x) = x - hi(x), exact in f32,
// rounded to the nearest TF32 value: the lo operand of the split.
__device__ __forceinline__ float tf32_rest(float x) {
  const float rest = x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(rest));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory: the ring (hi halves once split); the lo halves, whose
// space the parked survivors take during select_tile; the squared norms of
// the tile's rows (queries, then prototypes); and per list s = list * BM +
// row its k-th value thr, entry count, and entries lv/li [list][k][BM].
struct Smem {
  size_t ring, lo, norm, thr, cnt, lv, li, total;
};

__host__ __device__ inline Smem layout(int k) {
  const size_t lists = (size_t)lists_per_row(k) * BM;
  const size_t lo = sizeof(float) * (SLOT > BM * PARK_LD ? SLOT : BM * PARK_LD);
  Smem s;
  s.ring = 0;
  s.lo = s.ring + sizeof(float) * RING * SLOT;
  s.norm = s.lo + lo;
  s.thr = s.norm + sizeof(float) * (BM + BN);
  s.cnt = s.thr + sizeof(float) * lists;
  s.lv = s.cnt + sizeof(int) * lists;
  s.li = s.lv + sizeof(float) * (size_t)k * lists;
  s.total = s.li + sizeof(int) * (size_t)k * lists;
  return s;
}

// Rows row0.. of q and col0.. of p, columns k0 .. k0 + KS, into a ring slot;
// rows past B or C and columns past D become zeros.  D % 4 == 0.
__device__ __forceinline__ void stage_slice(float* slot, const float* __restrict__ q,
                                            const float* __restrict__ p, int B, int C,
                                            int D, int row0, int col0, int k0) {
  for (int i = threadIdx.x; i < (BM + BN) * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR, k = k0 + 4 * c;
    const bool is_q = r < BM;
    const int g = is_q ? row0 + r : col0 + r - BM;
    const bool in = (is_q ? g < B : g < C) && k < D;
    const float* src = (is_q ? q : p) + (in ? (size_t)g * D + k : 0);
    ac_common::cp_async16(slot + r * LDS + 4 * c, src, in ? 16 : 0);
  }
}

// A tile's selection (see the top).  Thread (warp (wm, wn), lane 4g + t)
// scores rows wm*32 + 16m + 8hf + g at columns col0 + wn*32 + 8n + 2t + e;
// lane L owns row wm*32 + L of list wn (k <= KREG) or of the row's one list.
__device__ __forceinline__ void select_tile(const float (&acc)[MT][NT][4],
                                         const unsigned char* __restrict__ valid,
                                         const float* __restrict__ bias, int B, int C, int k,
                                         int row0, int col0, unsigned char* smem) {
  const Smem L = layout(k);
  float* park = reinterpret_cast<float*>(smem + L.lo);     // [BM][PARK_LD]
  const float* norm = reinterpret_cast<const float*>(smem + L.norm);
  float* thr = reinterpret_cast<float*>(smem + L.thr);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* lv = reinterpret_cast<float*>(smem + L.lv);
  int* li = reinterpret_cast<int*>(smem + L.li);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const bool in_regs = k <= KREG;
  const int list = in_regs ? wn : 0;

  float cnorm[NT][2], cbias[NT][2];
  bool cvalid[NT][2], cin[NT][2];
  #pragma unroll
  for (int n = 0; n < NT; ++n)
    #pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = wn * 32 + 8 * n + 2 * t + e, c = col0 + cl;
      cnorm[n][e] = norm[BM + cl];
      cin[n][e] = c < C;
      cvalid[n][e] = cin[n][e] && valid[c];
      cbias[n][e] = cvalid[n][e] ? bias[c] : 0.f;
    }
  uint32_t mine = 0;          // survivor columns of the row this lane owns
  #pragma unroll
  for (int m = 0; m < MT; ++m)
    #pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 32 + 16 * m + 8 * hf + g;
      const float th = thr[list * BM + r], qn = norm[r];
      const bool live = row0 + r < B;
      uint32_t bits = 0;
      #pragma unroll
      for (int n = 0; n < NT; ++n)
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = cvalid[n][e]
              ? sim_from_dot(qn, cnorm[n][e], acc[m][n][2 * hf + e]) + cbias[n][e]
              : INVALID;
          if (live && cin[n][e] && v > th) {
            const int cl = 8 * n + 2 * t + e;
            park[r * PARK_LD + wn * 32 + cl] = v;
            bits |= 1u << cl;
          }
        }
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
      // lane 16m + 8hf + g' owns the row that quad g' scored here
      const uint32_t got = __shfl_sync(0xffffffffu, bits, 4 * (lane & 7));
      if ((lane >> 4) == m && ((lane >> 3) & 1) == hf) mine = got;
    }
  __syncwarp();

  const int r = wm * 32 + lane, s = list * BM + r;
  float* v_at = lv + (size_t)list * k * BM + r;     // entry j at v_at[j * BM]
  int* i_at = li + (size_t)list * k * BM + r;
  const float* prow = park + r * PARK_LD + wn * 32;
  if (in_regs) {
    if (mine == 0) return;
    float v[KREG];
    int ix[KREG];
    #pragma unroll
    for (int j = 0; j < KREG; ++j) {
      v[j] = j < k ? v_at[j * BM] : -INFINITY;
      ix[j] = j < k ? i_at[j * BM] : INT_MAX;
    }
    uint32_t bits = mine;
    while (bits) {
      const int cl = __ffs(bits) - 1;
      bits &= bits - 1;
      // carry the candidate down the list, swapping with every entry it
      // ranks before; what falls off slot k - 1 leaves the list
      float cv = prow[cl];
      int ci = col0 + wn * 32 + cl;
      #pragma unroll
      for (int j = 0; j < KREG; ++j)
        if (j < k && before(cv, ci, v[j], ix[j])) {
          const float tv = v[j];
          const int ti = ix[j];
          v[j] = cv;
          ix[j] = ci;
          cv = tv;
          ci = ti;
        }
    }
    #pragma unroll
    for (int j = 0; j < KREG; ++j)
      if (j < k) {
        v_at[j * BM] = v[j];
        i_at[j * BM] = ix[j];
      }
    thr[s] = v[k - 1];
    return;
  }
  // one list a row in shared memory; the column warps insert in turns
  for (int w = 0; w < WN; ++w) {
    if (wn == w && row0 + r < B) {
      int count = cnt[s];
      uint32_t bits = mine;
      while (bits) {
        const int cl = __ffs(bits) - 1;
        bits &= bits - 1;
        const float v = prow[cl];
        if (count == k && !(v > v_at[(k - 1) * BM])) continue;
        int pos = count < k ? count : k - 1;
        while (pos > 0 && v_at[(pos - 1) * BM] < v) {
          v_at[pos * BM] = v_at[(pos - 1) * BM];
          i_at[pos * BM] = i_at[(pos - 1) * BM];
          --pos;
        }
        v_at[pos * BM] = v;
        i_at[pos * BM] = col0 + wn * 32 + cl;
        if (count < k) ++count;
      }
      cnt[s] = count;
      if (count == k) thr[s] = v_at[(k - 1) * BM];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ bias, int B, int C, int D, int k,
                    int tiles_per_split, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem L = layout(k);
  float* ring = reinterpret_cast<float*>(smem_raw + L.ring);
  float* lo = reinterpret_cast<float*>(smem_raw + L.lo);
  float* norm = reinterpret_cast<float*>(smem_raw + L.norm);
  float* thr = reinterpret_cast<float*>(smem_raw + L.thr);
  int* cnt = reinterpret_cast<int*>(smem_raw + L.cnt);
  float* lv = reinterpret_cast<float*>(smem_raw + L.lv);
  int* li = reinterpret_cast<int*>(smem_raw + L.li);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.x * BM;
  const int n_tiles = (C + BN - 1) / BN;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int kst = (D + KS - 1) / KS;
  const int steps = (tile_end - tile_begin) * kst;
  const int lists = lists_per_row(k);
  for (int i = tid; i < lists * BM; i += NTHREADS) {
    thr[i] = -INFINITY;
    cnt[i] = 0;
    for (int j = 0; j < k; ++j) {   // empty entries rank after every candidate
      lv[(size_t)(i / BM * k + j) * BM + i % BM] = -INFINITY;
      li[(size_t)(i / BM * k + j) * BM + i % BM] = INT_MAX;
    }
  }

  auto stage = [&](int s) {
    if (s < steps)
      stage_slice(ring + (s % RING) * SLOT, q, p, B, C, D, row0,
                  (tile_begin + s / kst) * BN, s % kst * KS);
    ac_common::cp_async_commit();
  };
  #pragma unroll
  for (int s = 0; s < RING - 1; ++s) stage(s);

  // ldmatrix lanes: query rows (lane & 7) + 8 ((lane >> 3) & 1) at column
  // 4 (lane >> 4); prototype rows (lane & 7) + 8 (lane >> 4) at column
  // 4 ((lane >> 3) & 1)
  const int a_off = (wm * 32 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 4 * (lane >> 4);
  const int b_off = (BM + wn * 32 + (lane & 7) + 8 * (lane >> 4)) * LDS
                    + 4 * ((lane >> 3) & 1);
  float acc[MT][NT][4];       // the dot products: the slices' sums, IEEE adds
  float sq[CHUNKS];           // squares of the rows of this thread's chunks
  for (int s = 0; s < steps; ++s) {
    ac_common::cp_async_wait_pending(RING - 2);   // slice s has landed
    __syncthreads();                               // for all; slot s - 1 is free
    stage(s + RING - 1);
    float* hi = ring + (s % RING) * SLOT;
    if (s % kst == 0) {
      #pragma unroll
      for (int m = 0; m < MT; ++m)
        #pragma unroll
        for (int n = 0; n < NT; ++n)
          #pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
      #pragma unroll
      for (int j = 0; j < CHUNKS; ++j) sq[j] = 0.f;
    }
    // split the slice: the f32 values stay as they landed, lo apart; chunk
    // tid + j * NTHREADS is row (tid + j * NTHREADS) / CPR in every slice
    #pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int i = tid + j * NTHREADS, at = i / CPR * LDS + 4 * (i % CPR);
      const float4 x = *reinterpret_cast<const float4*>(hi + at);
      sq[j] = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, sq[j]))));
      *reinterpret_cast<float4*>(lo + at) =
          make_float4(tf32_rest(x.x), tf32_rest(x.y), tf32_rest(x.z), tf32_rest(x.w));
    }
    const bool last = s % kst == kst - 1;
    if (last) {
      // the rows' squares: the CPR chunks of a row sit in CPR consecutive
      // lanes of one warp
      #pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        float v = sq[j];
        #pragma unroll
        for (int o = 1; o < CPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (tid % CPR == 0) norm[(tid + j * NTHREADS) / CPR] = v;
      }
    }
    __syncthreads();                               // the slice is split
    // the slice's products, summed apart from the running dot products (see
    // the top: the tensor cores' adds truncate)
    float part[MT][NT][4];
    #pragma unroll
    for (int m = 0; m < MT; ++m)
      #pragma unroll
      for (int n = 0; n < NT; ++n)
        #pragma unroll
        for (int i = 0; i < 4; ++i) part[m][n][i] = 0.f;
    #pragma unroll
    for (int k8 = 0; k8 < KS; k8 += 8) {
      uint32_t bh[NT][2], bl[NT][2];
      #pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t h[4], l[4];
        ac_common::ldsm_x4(h, hi + b_off + 16 * np * LDS + k8);
        ac_common::ldsm_x4(l, lo + b_off + 16 * np * LDS + k8);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          bh[2 * np + (i >> 1)][i & 1] = h[i];
          bl[2 * np + (i >> 1)][i & 1] = l[i];
        }
      }
      #pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ah[4], al[4];
        ac_common::ldsm_x4(ah, hi + a_off + 16 * m * LDS + k8);
        ac_common::ldsm_x4(al, lo + a_off + 16 * m * LDS + k8);
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_tf32(part[m][n], al, bh[n]);
          mma_tf32(part[m][n], ah, bl[n]);
          mma_tf32(part[m][n], ah, bh[n]);
        }
      }
    }
    #pragma unroll
    for (int m = 0; m < MT; ++m)
      #pragma unroll
      for (int n = 0; n < NT; ++n)
        #pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = __fadd_rn(acc[m][n][i], part[m][n][i]);
    if (last) {
      __syncthreads();                             // lo is read: park may take it
      select_tile(acc, valid, bias, B, C, k, row0, (tile_begin + s / kst) * BN, smem_raw);
    }
  }
  __syncthreads();

  // the block's k best for each row: with lists in registers, lane L of the
  // first column warp merges its row's four sorted lists (the heads compared
  // by value, then index); with one list a row, that list
  const int r = wm * 32 + lane;
  if (wn == 0 && row0 + r < B) {
    const size_t base = ((size_t)blockIdx.y * B + row0 + r) * k;
    int head[WN] = {0, 0, 0, 0};
    for (int j = 0; j < k; ++j) {
      int best = -1;
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int w = 0; w < lists; ++w) {
        if (head[w] >= k) continue;
        const size_t at = (size_t)(w * k + head[w]) * BM + r;
        if (best < 0 || before(lv[at], li[at], bv, bi)) {
          best = w;
          bv = lv[at];
          bi = li[at];
        }
      }
      ++head[best];
      part_v[base + j] = bv;
      part_i[base + j] = bi;
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int S, int k, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  constexpr int PER_LANE = MAX_SPLITS / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * MERGE_WARPS + threadIdx.x / 32;
  if (b >= B) return;
  // the head of split lane + 32m: its next unread entry, value and index
  int head[PER_LANE];
  float hv[PER_LANE];
  int hi[PER_LANE];
  auto load = [&](int m) {
    const int s = lane + 32 * m;
    const bool in = s < S && head[m] < k;
    const size_t at = ((size_t)s * B + b) * k + head[m];
    hv[m] = in ? part_v[at] : -INFINITY;
    hi[m] = in ? part_i[at] : INT_MAX;
  };
  #pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    head[m] = 0;
    load(m);
  }

  for (int j = 0; j < k; ++j) {
    float bv = hv[0];
    int bi = hi[0], bm = 0;
    #pragma unroll
    for (int m = 1; m < PER_LANE; ++m)
      if (before(hv[m], hi[m], bv, bi)) { bv = hv[m]; bi = hi[m]; bm = m; }
    // warp-wide best by (value desc, index asc, lane asc)
    float wv = bv;
    int wi = bi, wl = lane;
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, o);
      if (before(ov, oi, wv, wi) || (ov == wv && oi == wi && ol < wl)) {
        wv = ov; wi = oi; wl = ol;
      }
    }
    if (lane == wl) {
      #pragma unroll
      for (int m = 0; m < PER_LANE; ++m)
        if (m == bm) {
          ++head[m];
          load(m);
        }
    }
    if (lane == 0) {
      out_v[(size_t)b * k + j] = wv;
      out_i[(size_t)b * k + j] = wi;
    }
  }
}

bool bad_args(int B, int C, int D, int k) {
  return B <= 0 || C <= 0 || D <= 0 || D % 4 != 0 || k <= 0 || k > KMAX || k > C ||
         (B + BM - 1) / BM > 65535;
}

}  // namespace

// Pass 1 then pass 2 on one stream.  q [B, D] f32, p [C, D] f32, valid [C]
// bool (one byte each), bias [C] f32, part_v / part_i [splits, B, k]
// scratch, out_v [B, k] f32, out_i [B, k] int32, all contiguous on the
// current device; D % 4 == 0 and q, p 16-byte aligned (rows are staged by
// 16-byte copies).  tiles_per_split * splits must cover ceil(C / 128)
// tiles, each split non-empty, splits <= 256.  Returns the first failing
// launch's cudaError_t.
extern "C" int ac_topk_sims(const float* q, const float* p,
                            const unsigned char* valid, const float* bias,
                            float* part_v, int* part_i, float* out_v, int* out_i,
                            int B, int C, int D, int k, int splits,
                            int tiles_per_split, void* stream) {
  const int n_tiles = (C + BN - 1) / BN;
  if (bad_args(B, C, D, k) || splits <= 0 || tiles_per_split <= 0 ||
      splits > MAX_SPLITS ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(p)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = layout(k).total;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_partial_kernel<<<dim3((B + BM - 1) / BM, splits), NTHREADS, smem, st>>>(
      q, p, valid, bias, B, C, D, k, tiles_per_split, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, st>>>(
      part_v, part_i, B, splits, k, out_v, out_i);
  return (int)cudaGetLastError();
}

// Pass 1's instantiation for k: info[9] = registers per thread, shared bytes
// per block, threads per block, blocks resident per SM, local (spill) bytes
// per thread, query rows a block, prototypes a tile, sorted lists a block
// keeps for each query, and the most splits pass 2 merges.  Launches
// nothing.
extern "C" int ac_topk_sims_info(int k, int* info) {
  if (k <= 0 || k > KMAX) return (int)cudaErrorInvalidValue;
  info[5] = BM;
  info[6] = BN;
  info[7] = lists_per_row(k);
  info[8] = MAX_SPLITS;
  return (int)ac_common::kernel_info(topk_partial_kernel, layout(k).total, NTHREADS, info);
}
