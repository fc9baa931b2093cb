// All-heads attention straight off the packed QKV projection output.
//
// Replaces the TPU kernel adaptive_classifier_tpu/ops/attention_qkv.py:216
// `attention_from_qkv` (pallas_call at :259; its `_kernel` pair variant :47,
// `_kernel_phased` :110 and `_kernel_perhead` :191 compute one function, and
// their head-pair lane packing is a device for a TPU's 128 lanes that has no
// counterpart here).
//
// Computes, for every batch row b and head h,
//     out[b, :, h*Dh:(h+1)*Dh] = softmax(q k^T / sqrt(Dh) + bias) v
// with q, k, v read straight from the packed [B, S, 3D] rows at column
// offsets h*Dh, D + h*Dh and 2D + h*Dh (no head-split copy) and the output
// written at column h*Dh of [B, S, D].  bias is an ADDITIVE -1e9 on keys whose
// mask is 0; masked keys are not skipped, so a fully masked row gives the same
// uniform average over all S keys that the plain version gives.  Queries are
// not masked.  Scores, softmax statistics and both products accumulate in
// f32; P is rounded to the input type before the PV product, as the plain
// version does (`probs.astype(v.dtype)`).
//
// What bounds it on an H100: memory.  The function reads B*S*3D inputs and
// writes B*S*D outputs: at the main path's B=256, S=64, D=512 in bf16 that is
// 67 MB, 20 us at 3.35 TB/s, against 4*B*H*S^2*Dh = 2.1 GFLOP, 2 us at the
// bf16 tensor-core peak.
//
// The design reads each element of qkv from device memory once per
// (batch, head, query tile): with S <= 64 there is one query tile, so the
// kernel meets the byte bound's traffic and keeps the [S, S] scores, the
// probabilities and the running softmax state in shared memory and
// registers, never in device memory.  This first version multiplies on the
// CUDA cores in f32 (no wgmma, no TMA), which leaves it compute-bound well
// above the byte bound; tensor cores and asynchronous tile loads are the
// next step.
//
// Layout: one block of 128 threads (4 warps) per (64-query tile, head,
// batch row).  The Q tile sits in shared memory; the kernel walks 64-key
// tiles of K and V with an online softmax.  Warp w owns query rows
// 16w..16w+15; lane l scores keys l and l+32 of the tile and accumulates
// output columns l, l+32, ... of its 16 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TILE = 64;             // queries per block, keys per step
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = TILE / WARPS;   // query rows per warp
constexpr float MASK_BIAS = -1e9f;

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

// Shared memory, in floats: Q [TILE][DHP], K [TILE][DHP+1] (padded so the
// 32 lanes reading 32 different key rows hit 32 banks), V [TILE][DHP],
// P [TILE][TILE], key bias [TILE].
template <int DHP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(TILE) * DHP + size_t(TILE) * (DHP + 1)
                          + size_t(TILE) * DHP + size_t(TILE) * TILE + TILE);
}

// DHP: head width rounded up to a multiple of 32 (32, 64 or 128); columns
// from Dh to DHP are zero in shared memory and never written out.
template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
attention_qkv_kernel(const T* __restrict__ qkv, const int* __restrict__ mask,
                     T* __restrict__ out, int S, int H, int Dh, float scale) {
  constexpr int NC = DHP / 32;       // output columns per lane
  constexpr int KLD = DHP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * DHP;
  float* Vs = Ks + TILE * KLD;
  float* Ps = Vs + TILE * DHP;
  float* Bs = Ps + TILE * TILE;

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * Dh;
  const long long row_stride = 3LL * D;
  const T* base = qkv + (long long)b * S * row_stride;
  const int* mrow = mask + (long long)b * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < TILE * DHP; i += THREADS) {
    const int r = i / DHP, d = i % DHP;
    const int s = q0 + r;
    Qs[i] = (s < S && d < Dh) ? to_f32(base[s * row_stride + h * Dh + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], o[ROWS][NC];
  #pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    #pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += TILE) {
    __syncthreads();                 // previous tile fully consumed
    for (int i = tid; i < TILE * DHP; i += THREADS) {
      const int r = i / DHP, d = i % DHP;
      const int s = k0 + r;
      const bool in = s < S && d < Dh;
      const T* row = base + s * row_stride + h * Dh + d;
      Ks[r * KLD + d] = in ? to_f32(row[D]) : 0.f;
      Vs[i] = in ? to_f32(row[2 * D]) : 0.f;
    }
    if (tid < TILE) {
      const int s = k0 + tid;
      // keys past S do not exist: -inf drops them from the softmax, while
      // padded keys inside S keep the finite additive bias
      Bs[tid] = s < S ? (mrow[s] > 0 ? 0.f : MASK_BIAS) : -INFINITY;
    }
    __syncthreads();

    // scores for keys (lane, lane + 32) of this tile, rows of this warp
    float sc[ROWS][2];
    #pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r][0] = sc[r][1] = 0.f;
    const float* k_lo = Ks + lane * KLD;
    const float* k_hi = Ks + (lane + 32) * KLD;
    const float* qw = Qs + warp * ROWS * DHP;
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

    const float b_lo = Bs[lane], b_hi = Bs[lane + 32];
    float* pw = Ps + warp * ROWS * TILE;
    #pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s_lo = sc[r][0] * scale + b_lo;
      const float s_hi = sc[r][1] * scale + b_hi;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s_lo, s_hi)));
      const float alpha = expf(m[r] - m_new);        // 0 on the first tile
      const float p_lo = expf(s_lo - m_new);
      const float p_hi = expf(s_hi - m_new);
      l[r] = l[r] * alpha + warp_sum(p_lo + p_hi);
      m[r] = m_new;
      #pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= alpha;
      pw[r * TILE + lane] = to_f32(from_f32<T>(p_lo));
      pw[r * TILE + lane + 32] = to_f32(from_f32<T>(p_hi));
    }
    __syncwarp();

    #pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float v[NC];
      #pragma unroll
      for (int c = 0; c < NC; ++c) v[c] = Vs[j * DHP + lane + 32 * c];
      #pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = pw[r * TILE + j];
        #pragma unroll
        for (int c = 0; c < NC; ++c) o[r][c] = fmaf(p, v[c], o[r][c]);
      }
    }
  }

  T* obase = out + (long long)b * S * D + h * Dh;
  #pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = q0 + warp * ROWS + r;
    if (s >= S) continue;
    const float inv = 1.f / l[r];
    #pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) obase[(long long)s * D + d] = from_f32<T>(o[r][c] * inv);
    }
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* qkv, const int* mask, void* out, int B, int S,
                   int H, int Dh, cudaStream_t stream) {
  const size_t smem = smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_qkv_kernel<T, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  attention_qkv_kernel<T, DHP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), S, H, Dh,
      1.0f / sqrtf((float)Dh));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* qkv, const int* mask, void* out, int B,
                      int S, int H, int Dh, cudaStream_t stream) {
  if (Dh <= 32) return launch<T, 32>(qkv, mask, out, B, S, H, Dh, stream);
  if (Dh <= 64) return launch<T, 64>(qkv, mask, out, B, S, H, Dh, stream);
  return launch<T, 128>(qkv, mask, out, B, S, H, Dh, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qkv [B, S, 3*H*Dh], mask [B, S] int32,
// out [B, S, H*Dh], all contiguous on the current device.  The caller checks
// the envelope (Dh <= 128, Dh % 8 == 0, S % 8 == 0); returns the launch's
// cudaError_t.
extern "C" int ac_attention_qkv(const void* qkv, const int* mask, void* out,
                                int B, int S, int H, int Dh, int dtype,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0 || Dh > 128 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dh<float>(qkv, mask, out, B, S, H, Dh, st);
    case 1: return (int)launch_dh<__nv_bfloat16>(qkv, mask, out, B, S, H, Dh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ac_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
