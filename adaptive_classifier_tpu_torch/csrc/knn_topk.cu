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
// the tensor cores) against 34 MB (10 us at 3.35 TB/s).
//
// Design.  The Pallas kernel walks the prototype tiles on a sequential grid
// axis and carries the running top-k in VMEM from one step to the next.  A
// GPU's blocks run in no order, so the walk is split in two passes:
//  1. topk_partial_kernel: a block per (64-query tile, contiguous range of
//     64-prototype tiles).  Each tile's dot products come from the same f32
//     tile product as kernel B4 (knn_tile.cuh); the epilogue turns them into
//     v in registers and parks the 64x64 values in shared memory.  Thread r
//     of the first 64 then folds row r's 64 candidates, in ascending
//     prototype order, into query r's sorted top-k list, which lives in
//     shared memory for the whole range (k-major, so the 64 threads touch 64
//     consecutive words).  A candidate enters when the list holds fewer than
//     k entries or when it beats the last one strictly: an equal value
//     arrived later and so has the higher index, which loses the tie.  Each
//     block writes its range's k winners (fewer if the range is shorter,
//     padded with -inf, INT_MAX).
//  2. topk_merge_kernel: a warp per query merges the ranges' sorted lists by
//     (value desc, index asc): k rounds, each taking the best list head
//     across the warp.  The ranges partition [0, C), so the union of their
//     winners holds the global top-k, and the index order settles ties
//     exactly as the lower-index rule.
// Only the [S, B, k] candidates of pass 1 and the [B, k] result reach device
// memory.  The split count S is chosen by the caller so that the pass-1 grid
// fills the card.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

#include "knn_tile.cuh"

namespace {

using namespace ac_knn;

constexpr int KMAX = 128;
constexpr int MAX_SPLITS = 256;
constexpr int MERGE_WARPS = 4;
constexpr float INVALID = -1e9f;
constexpr int SIMS_LD = TN + 1;   // padded row of the parked values

// (va, ia) ranks before (vb, ib): larger value, then lower index
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

size_t partial_smem_bytes(int k) {
  return sizeof(TileSmem) + sizeof(float) * TM * SIMS_LD +
         (sizeof(float) + sizeof(int)) * (size_t)k * TM;
}

__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ bias, int B, int C, int D, int k,
                    int tiles_per_split, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem_raw);
  float* sims = reinterpret_cast<float*>(smem_raw + sizeof(TileSmem));  // [TM][SIMS_LD]
  float* lv = sims + TM * SIMS_LD;                                      // [k][TM]
  int* li = reinterpret_cast<int*>(lv + (size_t)k * TM);                // [k][TM]

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int row0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int n_tiles = (C + TN - 1) / TN;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  int count = 0;   // entries in query t's list (threads t < TM)

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * TN;
    float acc[4][4];
    dot_tile(q, p, B, C, D, row0, col0, s, acc);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qn = s.qn[4 * ty + i];
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + 4 * tx + j;
        float v = -INFINITY;     // past C: never read below
        if (c < C)
          v = valid[c] ? sim_from_dot(qn, s.pn[4 * tx + j], acc[i][j]) + bias[c]
                       : INVALID;
        sims[(4 * ty + i) * SIMS_LD + 4 * tx + j] = v;
      }
    }
    __syncthreads();
    if (t < TM && row0 + t < B) {
      const int ncols = min(TN, C - col0);
      for (int c = 0; c < ncols; ++c) {
        const float v = sims[t * SIMS_LD + c];
        if (count == k && !(v > lv[(k - 1) * TM + t])) continue;
        int pos = count < k ? count : k - 1;
        while (pos > 0 && lv[(pos - 1) * TM + t] < v) {
          lv[pos * TM + t] = lv[(pos - 1) * TM + t];
          li[pos * TM + t] = li[(pos - 1) * TM + t];
          --pos;
        }
        lv[pos * TM + t] = v;
        li[pos * TM + t] = col0 + c;
        if (count < k) ++count;
      }
    }
    __syncthreads();
  }

  if (t < TM && row0 + t < B) {
    const size_t base = ((size_t)split * B + row0 + t) * k;
    for (int j = 0; j < k; ++j) {
      part_v[base + j] = j < count ? lv[j * TM + t] : -INFINITY;
      part_i[base + j] = j < count ? li[j * TM + t] : INT_MAX;
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
  int head[PER_LANE];   // next unread entry of split lane + 32m
  #pragma unroll
  for (int m = 0; m < PER_LANE; ++m) head[m] = 0;

  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX, bm = -1;
    #pragma unroll
    for (int m = 0; m < PER_LANE; ++m) {
      const int s = lane + 32 * m;
      if (s < S && head[m] < k) {
        const size_t at = ((size_t)s * B + b) * k + head[m];
        const float v = part_v[at];
        const int i = part_i[at];
        if (bm < 0 || before(v, i, bv, bi)) { bv = v; bi = i; bm = m; }
      }
    }
    // warp-wide best by (value desc, index asc, lane asc)
    float wv = bv;
    int wi = bi, wl = bm < 0 ? INT_MAX : lane;
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, o);
      if (ol != INT_MAX &&
          (wl == INT_MAX || before(ov, oi, wv, wi) ||
           (ov == wv && oi == wi && ol < wl))) {
        wv = ov; wi = oi; wl = ol;
      }
    }
    if (lane == wl) {
      #pragma unroll
      for (int m = 0; m < PER_LANE; ++m)
        if (m == bm) ++head[m];
    }
    if (lane == 0) {
      out_v[(size_t)b * k + j] = wv;
      out_i[(size_t)b * k + j] = wi;
    }
  }
}

}  // namespace

// Pass 1 then pass 2 on one stream.  q [B, D] f32, p [C, D] f32, valid [C]
// bool (one byte each), bias [C] f32, part_v / part_i [splits, B, k] scratch,
// out_v [B, k] f32, out_i [B, k] int32, all contiguous on the current device.
// tiles_per_split * splits must cover ceil(C / 64) tiles, each split
// non-empty.  Returns the first failing launch's cudaError_t.
extern "C" int ac_topk_sims(const float* q, const float* p,
                            const unsigned char* valid, const float* bias,
                            float* part_v, int* part_i, float* out_v, int* out_i,
                            int B, int C, int D, int k, int splits,
                            int tiles_per_split, void* stream) {
  const int n_tiles = (C + TN - 1) / TN;
  const int row_tiles = (B + TM - 1) / TM;
  if (B <= 0 || C <= 0 || D <= 0 || k <= 0 || k > KMAX || k > C ||
      splits <= 0 || splits > MAX_SPLITS || splits > 65535 || tiles_per_split <= 0 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_partial_kernel<<<dim3(row_tiles, splits), THREADS, smem, st>>>(
      q, p, valid, bias, B, C, D, k, tiles_per_split, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, st>>>(
      part_v, part_i, B, splits, k, out_v, out_i);
  return (int)cudaGetLastError();
}
