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
// What bounds them on an H100: memory at the serving shapes (S <= 128), the
// products from S ~ 256 on: 2 * 2 * B * H * S^2 * Dh operations against
// 4 * B * S * H * Dh elements moved.  The design keeps the scores and the
// probabilities in shared memory and registers, never in device memory, and
// reads each K/V element once per (batch, head, query tile).  Like B1
// (attention_qkv.cu) this first version multiplies on the CUDA cores in f32
// (no wgmma, no TMA), which leaves it compute-bound well above the bound.
//
// B6 layout: one block of 4 warps per (query tile of 4 * ROWS rows, head,
// batch row); the Q tile sits in shared memory and 64-key tiles of K and V
// stream through it (the TPU kernel keeps a head's whole K/V resident in
// VMEM, which at S = 2,048 in bf16 is 256 KB each, more than a block's 227 KB).
// Warp w owns ROWS query rows; lane l scores keys l and l + 32 of a tile and
// accumulates output columns l, l + 32, ... of its rows.
//
// B7 layout: the same blocks, but each keeps its rows' whole [TQ, S] f32
// score block in shared memory (the TPU kernel keeps a head's whole [S, S]
// block, 1 MB at S = 512, which no block can hold): pass 1 writes the scores
// tile by tile, pass 2 takes each row's exact max, sum and normalized,
// rounded probabilities, pass 3 streams V tiles for the PV product.  The
// query tile shrinks as S grows so the score block stays at <= 128 KB
// (TQ 64 up to S = 512, 32 up to 1,024, 16 up to 2,048); longer rows are
// refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TK = 64;               // keys per staged K/V tile
constexpr float MASK_BIAS = -1e9f;
constexpr int MAX_ONESHOT_S = 2048;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// additive bias of key s: 0 valid, -1e9 masked, -inf past S (no key there)
__device__ __forceinline__ float key_bias(const int* __restrict__ mrow, int s, int S) {
  return s < S ? (mrow[s] > 0 ? 0.f : MASK_BIAS) : -INFINITY;
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

// ---------------------------------------------------------------------------
// B6: online softmax over 64-key tiles
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// B7: exact row softmax over the block's whole [TQ, S] score block
// ---------------------------------------------------------------------------

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
};

template <typename T, int DHP, int ROWS>
cudaError_t launch_flash(const Args& a) {
  const size_t smem = flash_smem_bytes<DHP, ROWS>();
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
    case 1: return (int)dispatch_dh<__nv_bfloat16>(a, oneshot);
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
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, false);
}

// As ac_flash_attention; S <= 2048.
extern "C" int ac_oneshot_attention(const void* q, const void* k, const void* v,
                                    const int* mask, void* out, int B, int S, int H,
                                    int Dh, long long sb, long long ss, long long sh,
                                    int dtype, void* stream) {
  const Args a{q, k, v, mask, out, B, S, H, Dh, sb, ss, sh,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, true);
}
