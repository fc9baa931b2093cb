// Flash (online-softmax) and one-shot (whole-row softmax) attention over
// per-head q, k, v given as strided [B, S, H, Dh] views.
//
// Replaces two TPU kernels of adaptive_classifier_tpu/ops/flash_attention.py:
// - B6 `flash_attention_padded` (:69, pallas_call at :82, `_flash_kernel`
//   :34): per key tile, running max m, p = exp(s - m) rounded to the input
//   type for the PV product, acc = acc * corr + p v in f32, l summed from the
//   unrounded p; at the end acc / max(l, 1e-30);
// - B7 `oneshot_attention_padded` (:136, pallas_call at :144,
//   `_oneshot_kernel` :106): the exact row softmax, p normalized by
//   max(l, 1e-30) and THEN rounded to the input type, then the PV product in
//   f32.  No final division.
// s = (q . k) / sqrt(Dh) + bias, bias an ADDITIVE -1e9 on keys whose mask is
// 0.  Keys past S do not exist (the TPU kernels' Dh -> 128 zero padding, their
// q pre-scale and their S padding to tile multiples are tiling artifacts of
// the TPU and have no counterpart here), so a fully masked row is the uniform
// average of V over its S keys.  Queries are not masked.
//
// Inputs: q, k and v share one set of strides (batch sb, row ss, head sh, in
// elements; the head's Dh values contiguous), so the encoder passes slices of
// its packed [B, S, 3D] QKV tensor with no copy.  Output [B, S, H*Dh].
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W; bf16, Dh 64;
// 4 B H S^2 Dh operations at 989 TFLOP/s against 4 B S H Dh elements and
// the mask moved once at 3.35 TB/s): memory at the zoo's chunks, 0.0100 ms
// of bytes against 0.0005 ms of products at [256, 32] x 8 heads, 0.0401
// against 0.0087 at [256, 128]; about balanced at bert-base [32, 512] x 12
// heads, 0.0301 ms of bytes against 0.0261 of products; products at [4,
// 2,048] x 12 (0.0521 ms against 0.0150 of bytes).  Past both, the exps:
// one ex2 a score, 16 a clock an SM (0.027 ms at bert-base).
//
// bf16, above 64 keys, both kernels run attention_hopper.cuh: TMA loads
// into a ring on mbarriers, a producer warpgroup, two consumer warpgroups
// on wgmma, persistent over work units of one (batch row, head).
// - B6 (its FLASH form): each warpgroup owns 64 of a 128-query tile and
//   walks the key tiles in order, the plain version's 64-key tiles: s = q
//   k^T scale + bias, m_new = max(m, rowmax s), corr = 2^(m - m_new), p =
//   2^(s - m_new) rounded to bf16 in registers as the A operand of P V, l =
//   l corr + the sum of the unrounded p, acc = acc corr + P V in f32, and
//   acc / max(l, 1e-30) at the end.  Q K^T of tile t is issued with P V of
//   tile t - 1 and awaited alone, so tile t's exps overlap that P V.  K and
//   V stay in the ring for all the query tiles of a (b, h) where they fit
//   (S <= 512 at Dh <= 64, 256 at Dh 128: at bert-base K and V are read
//   once per (b, h) for its 4 query tiles); longer rows stream them per
//   query tile.
// - B7 (ROWS, SPLIT, TWO_PASS forms): each row's exact max comes before it
//   normalizes, with Q K^T computed once up to S 512: the [64, S] scores
//   of a warpgroup's queries in registers to S 256, the keys split
//   between the two warpgroups, which exchange their rows' maxima and sums
//   through shared memory, to S 512; above, two passes (the running max
//   and rescaled sum, then the scores again with V).  p = exp(s - m) /
//   max(l, 1e-30) rounded to bf16 in registers is the A operand of P V.
// Rows TMA cannot take (Dh % 8 != 0, an odd base or stride: Dh 20 or 100)
// are staged element by element by the producer's loading warp into the
// same layout.  At S <= 64 both run one_tile_rows of attention_tile.cuh
// (one staged tile, mma.sync, each kernel's order of rounding): the wgmma
// kernel pads such rows to 128-query, 64-key tiles and measured 2.1-2.4x
// slower there.  Times (NVIDIA H100 80GB HBM3, 700 W): PERF.md §6.
//
// f32 keeps the first port's CUDA-core loop below: TF32 is off in this
// port, and a bf16 mma would not compute the f32 function.  B6 layout: one
// block of 4 warps per (query tile of 4 * ROWS rows, head, batch row), 64-key
// tiles of K and V staged as f32; lane l scores keys l and l + 32 of a tile
// and accumulates output columns l, l + 32, ... of its rows.  B7 keeps its
// rows' whole [TQ, S] f32 score block in shared memory (TQ 64 up to S = 512,
// 32 up to 1,024, 16 up to 2,048); longer rows are refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attention_tile.cuh"
#include "attention_hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core loop (TF32 is off in this port, and a bf16 mma would
// not compute the f32 function)
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TK = 64;               // keys per staged K/V tile
constexpr int MAX_ONESHOT_S = 2048;

using ac_attn::key_bias;

// the loop is written for an element type T; only T = float is instantiated
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x rounded to T and back (the TPU kernels' p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

// Rows [r0, r0 + n) of one head's [S, Dh] slice (row stride ss) into shared
// memory with leading dimension ld, as f32; zero past S and past Dh.
template <typename T, int DHP>
__device__ __forceinline__ void stage(const T* __restrict__ base, long long ss, int r0,
                                     int n, int S, int Dh, float* dst, int ld) {
  for (int i = threadIdx.x; i < n * DHP; i += THREADS) {
    const int r = i / DHP, d = i % DHP;
    const int s = r0 + r;
    dst[r * ld + d] = (s < S && d < Dh) ? to_f32(base[(long long)s * ss + d]) : 0.f;
  }
}

// Raw dot products of a warp's ROWS query rows (qw, leading dimension DHP)
// with keys lane and lane + 32 of the staged tile (leading dimension DHP + 1,
// so the 32 lanes reading 32 key rows hit 32 banks).
template <int DHP, int ROWS>
__device__ __forceinline__ void tile_dots(const float* qw, const float* Ks, int Dh,
                                          int lane, float (&sc)[ROWS][2]) {
  constexpr int KLD = DHP + 1;
  #pragma unroll
  for (int r = 0; r < ROWS; ++r) sc[r][0] = sc[r][1] = 0.f;
  const float* k_lo = Ks + lane * KLD;
  const float* k_hi = Ks + (lane + 32) * KLD;
  #pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    const float a = k_lo[d], c = k_hi[d];
    #pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float q = qw[r * DHP + d];
      sc[r][0] = fmaf(q, a, sc[r][0]);
      sc[r][1] = fmaf(q, c, sc[r][1]);
    }
  }
}

// o[r][c] += sum_j P[r][j] * V[j][lane + 32c] over the staged tile's TK keys
template <int DHP, int ROWS>
__device__ __forceinline__ void tile_pv(const float* pw, int pld, const float* Vs,
                                        int lane, float (&o)[ROWS][DHP / 32]) {
  constexpr int NC = DHP / 32;
  #pragma unroll 4
  for (int j = 0; j < TK; ++j) {
    float v[NC];
    #pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = Vs[j * DHP + lane + 32 * c];
    #pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p = pw[r * pld + j];
      #pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] = fmaf(p, v[c], o[r][c]);
    }
  }
}

template <typename T, int DHP, int ROWS>
__device__ __forceinline__ void write_rows(T* __restrict__ out, int b, int q0, int S,
                                           int H, int h, int Dh, int warp, int lane,
                                           float (&o)[ROWS][DHP / 32]) {
  constexpr int NC = DHP / 32;
  const long long D = (long long)H * Dh;
  #pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = q0 + warp * ROWS + r;
    if (s >= S) continue;
    T* orow = out + ((long long)b * S + s) * D + (long long)h * Dh;
    #pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) orow[d] = from_f32<T>(o[r][c]);
    }
  }
}

// B6, f32: online softmax over 64-key tiles

template <int DHP, int ROWS>
constexpr size_t flash_smem_bytes() {
  // Q [TQ][DHP], K [TK][DHP+1], V [TK][DHP], P [TQ][TK], key bias [TK]
  return sizeof(float) * (size_t(WARPS * ROWS) * DHP + size_t(TK) * (DHP + 1)
                          + size_t(TK) * DHP + size_t(WARPS * ROWS) * TK + TK);
}

template <typename T, int DHP, int ROWS>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ mask, T* __restrict__ out, int S, int H, int Dh,
             long long sb, long long ss, long long sh, float scale) {
  constexpr int TQ = WARPS * ROWS;
  constexpr int NC = DHP / 32;
  constexpr int KLD = DHP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TQ * DHP;
  float* Vs = Ks + TK * KLD;
  float* Ps = Vs + TK * DHP;
  float* Bs = Ps + TQ * TK;

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long off = (long long)b * sb + (long long)h * sh;
  const int* mrow = mask + (long long)b * S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  stage<T, DHP>(q + off, ss, q0, TQ, S, Dh, Qs, DHP);

  float m[ROWS], l[ROWS], o[ROWS][NC];
  #pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    #pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += TK) {
    __syncthreads();                 // the previous tile is consumed
    stage<T, DHP>(k + off, ss, k0, TK, S, Dh, Ks, KLD);
    stage<T, DHP>(v + off, ss, k0, TK, S, Dh, Vs, DHP);
    if (tid < TK) Bs[tid] = key_bias(mrow, k0 + tid, S);
    __syncthreads();

    float sc[ROWS][2];
    tile_dots<DHP, ROWS>(Qs + warp * ROWS * DHP, Ks, Dh, lane, sc);
    const float b_lo = Bs[lane], b_hi = Bs[lane + 32];
    float* pw = Ps + warp * ROWS * TK;
    #pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s_lo = sc[r][0] * scale + b_lo;
      const float s_hi = sc[r][1] * scale + b_hi;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s_lo, s_hi)));
      const float corr = expf(m[r] - m_new);         // 0 on the first tile
      const float p_lo = expf(s_lo - m_new);
      const float p_hi = expf(s_hi - m_new);
      l[r] = l[r] * corr + warp_sum(p_lo + p_hi);
      m[r] = m_new;
      #pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= corr;
      pw[r * TK + lane] = round_to<T>(p_lo);
      pw[r * TK + lane + 32] = round_to<T>(p_hi);
    }
    __syncwarp();
    tile_pv<DHP, ROWS>(pw, TK, Vs, lane, o);
  }

  #pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float lm = fmaxf(l[r], 1e-30f);
    #pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = o[r][c] / lm;
  }
  write_rows<T, DHP, ROWS>(out, b, q0, S, H, h, Dh, warp, lane, o);
}

// B7, f32: exact row softmax over the block's whole [TQ, S] score block

template <int DHP, int ROWS>
size_t oneshot_smem_bytes(int SP) {
  // Q [TQ][DHP], K or V tile [TK][DHP+1], key bias [TK], scores [TQ][SP]
  return sizeof(float) * (size_t(WARPS * ROWS) * DHP + size_t(TK) * (DHP + 1) + TK
                          + size_t(WARPS * ROWS) * SP);
}

template <typename T, int DHP, int ROWS>
__global__ void __launch_bounds__(THREADS)
oneshot_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ mask, T* __restrict__ out, int S, int SP, int H,
               int Dh, long long sb, long long ss, long long sh, float scale) {
  constexpr int TQ = WARPS * ROWS;
  constexpr int NC = DHP / 32;
  constexpr int KLD = DHP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + TQ * DHP;
  float* Bs = KVs + TK * KLD;
  float* Ps = Bs + TK;

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long off = (long long)b * sb + (long long)h * sh;
  const int* mrow = mask + (long long)b * S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* pw = Ps + (size_t)warp * ROWS * SP;

  stage<T, DHP>(q + off, ss, q0, TQ, S, Dh, Qs, DHP);

  // pass 1: scores, tile by tile
  for (int k0 = 0; k0 < S; k0 += TK) {
    __syncthreads();
    stage<T, DHP>(k + off, ss, k0, TK, S, Dh, KVs, KLD);
    if (tid < TK) Bs[tid] = key_bias(mrow, k0 + tid, S);
    __syncthreads();
    float sc[ROWS][2];
    tile_dots<DHP, ROWS>(Qs + warp * ROWS * DHP, KVs, Dh, lane, sc);
    const float b_lo = Bs[lane], b_hi = Bs[lane + 32];
    #pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      pw[(size_t)r * SP + k0 + lane] = sc[r][0] * scale + b_lo;
      pw[(size_t)r * SP + k0 + lane + 32] = sc[r][1] * scale + b_hi;
    }
  }
  __syncwarp();

  // pass 2: each warp's rows: exact max and sum, p / max(l, 1e-30) rounded
  // to T; the columns from S to SP become 0
  for (int r = 0; r < ROWS; ++r) {
    float* row = pw + (size_t)r * SP;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float lm = fmaxf(warp_sum(sum), 1e-30f);
    for (int j = lane; j < SP; j += 32) row[j] = j < S ? round_to<T>(row[j] / lm) : 0.f;
  }
  __syncwarp();

  // pass 3: P V over V tiles
  float o[ROWS][NC];
  #pragma unroll
  for (int r = 0; r < ROWS; ++r)
    #pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  for (int k0 = 0; k0 < S; k0 += TK) {
    __syncthreads();
    stage<T, DHP>(v + off, ss, k0, TK, S, Dh, KVs, DHP);
    __syncthreads();
    tile_pv<DHP, ROWS>(pw + k0, SP, KVs, lane, o);
  }
  write_rows<T, DHP, ROWS>(out, b, q0, S, H, h, Dh, warp, lane, o);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int* mask;
  void* out;
  int B, S, H, Dh;
  long long sb, ss, sh;
  cudaStream_t stream;
  int* info;        // set: report the instantiation instead of launching
};

using ac_common::kernel_info;

// info[5..7] of the loops of this file: no warpgroups, no wgmma form, no TMA
template <typename Kernel>
cudaError_t loop_info(Kernel* kernel, size_t smem, int threads, int* info) {
  info[5] = info[6] = info[7] = 0;
  return kernel_info(kernel, smem, threads, info);
}

template <typename T, int DHP, int ROWS>
cudaError_t launch_flash(const Args& a) {
  const size_t smem = flash_smem_bytes<DHP, ROWS>();
  if (a.info) return loop_info(flash_kernel<T, DHP, ROWS>, smem, THREADS, a.info);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DHP, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int TQ = WARPS * ROWS;
  const dim3 grid((a.S + TQ - 1) / TQ, a.H, a.B);
  flash_kernel<T, DHP, ROWS><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.mask, static_cast<T*>(a.out), a.S, a.H, a.Dh, a.sb, a.ss, a.sh,
      1.0f / sqrtf((float)a.Dh));
  return cudaGetLastError();
}

template <typename T, int DHP, int ROWS>
cudaError_t launch_oneshot(const Args& a) {
  const int SP = (a.S + TK - 1) / TK * TK;
  const size_t smem = oneshot_smem_bytes<DHP, ROWS>(SP);
  if (a.info) return loop_info(oneshot_kernel<T, DHP, ROWS>, smem, THREADS, a.info);
  cudaError_t err = cudaFuncSetAttribute(
      oneshot_kernel<T, DHP, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int TQ = WARPS * ROWS;
  const dim3 grid((a.S + TQ - 1) / TQ, a.H, a.B);
  oneshot_kernel<T, DHP, ROWS><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.mask, static_cast<T*>(a.out), a.S, SP, a.H, a.Dh, a.sb, a.ss, a.sh,
      1.0f / sqrtf((float)a.Dh));
  return cudaGetLastError();
}

// query rows per warp: 8 (a 32-row tile) for short rows, else 16; the
// one-shot kernel halves it as S doubles past 512 to keep its score block
template <typename T, int DHP>
cudaError_t dispatch_rows(const Args& a, bool oneshot) {
  if (!oneshot) {
    return a.S <= 32 ? launch_flash<T, DHP, 8>(a) : launch_flash<T, DHP, 16>(a);
  }
  if (a.S <= 32) return launch_oneshot<T, DHP, 8>(a);
  if (a.S <= 512) return launch_oneshot<T, DHP, 16>(a);
  if (a.S <= 1024) return launch_oneshot<T, DHP, 8>(a);
  return launch_oneshot<T, DHP, 4>(a);
}

template <typename T>
cudaError_t dispatch_dh(const Args& a, bool oneshot) {
  if (a.Dh <= 32) return dispatch_rows<T, 32>(a, oneshot);
  if (a.Dh <= 64) return dispatch_rows<T, 64>(a, oneshot);
  return dispatch_rows<T, 128>(a, oneshot);
}

int run(const Args& a, int dtype, bool oneshot) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Dh <= 0 || a.Dh > 128 || a.H > 65535
      || a.B > 65535 || (oneshot && a.S > MAX_ONESHOT_S))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)dispatch_dh<float>(a, oneshot);
    case 1:
      return (int)ac_wg::launch({a.q, a.k, a.v, a.mask, a.out, a.B, a.S, a.H, a.Dh, a.sb,
                                 a.ss, a.sh, a.stream, a.info}, !oneshot);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v and out).  q, k, v: [B, S, H,
// Dh] with strides (sb, ss, sh, 1) in elements, shared by the three; mask
// [B, S] int32 and out [B, S, H*Dh] contiguous; all on the current device.
// Dh <= 128.  Returns the launch's cudaError_t.
extern "C" int ac_flash_attention(const void* q, const void* k, const void* v,
                                  const int* mask, void* out, int B, int S, int H,
                                  int Dh, long long sb, long long ss, long long sh,
                                  int dtype, void* stream) {
  const Args a{q, k, v, mask, out, B, S, H, Dh, sb, ss, sh,
               static_cast<cudaStream_t>(stream), nullptr};
  return run(a, dtype, false);
}

// As ac_flash_attention; S <= 2048.
extern "C" int ac_oneshot_attention(const void* q, const void* k, const void* v,
                                    const int* mask, void* out, int B, int S, int H,
                                    int Dh, long long sb, long long ss, long long sh,
                                    int dtype, void* stream) {
  const Args a{q, k, v, mask, out, B, S, H, Dh, sb, ss, sh,
               static_cast<cudaStream_t>(stream), nullptr};
  return run(a, dtype, true);
}

// The kernel ac_flash_attention (oneshot 0) or ac_oneshot_attention (1)
// would launch on these arguments (the output taken as 16-byte aligned):
// info[8] = registers per thread, shared bytes per block, threads per block,
// blocks resident per SM, local (spill) bytes per thread, consumer
// warpgroups (0: no wgmma), the wgmma form (0 none, 1 ROWS, 2 SPLIT, 3
// TWO_PASS; attention_hopper.cuh), TMA-fed (1) or not (0).  Launches
// nothing.
extern "C" int ac_flash_attention_info(const void* q, const void* k, const void* v, int B,
                                       int S, int H, int Dh, long long sb, long long ss,
                                       long long sh, int dtype, int oneshot, int* info) {
  const Args a{q, k, v, nullptr, nullptr, B, S, H, Dh, sb, ss, sh, nullptr, info};
  return run(a, dtype, oneshot != 0);
}
