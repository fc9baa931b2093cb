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
// not masked.  In the TPU kernel's order of rounding (`_softmax_rows(s)
// .astype(v.dtype)`, attention_qkv.py:40-44): each row's exact max m and sum
// l come first, p = exp(s - m) / max(l, 1e-30) is rounded to the input type,
// then multiplied by v with f32 sums.  That is B7's function
// (flash_attention.cu) on the packed strides.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; the time to
// move the inputs and output once at 3.35 TB/s against the products at the
// 989 TFLOP/s bf16 peak): memory at the zoo's chunks.  At [256, 32] x 8
// heads (Dh 64, bf16) the inputs and output are 33.6 MB, 0.0100 ms against
// 0.0005 ms of products; at [256, 128] 0.0401 against 0.0087 ms; about
// balanced at bert-base's [32, 512] x 12 heads (0.0301 ms of bytes, 0.0261
// of products).
//
// bf16 (the card's path), above 64 keys: attention_hopper.cuh, B7's kernel
// on the packed strides (q, k, v at column offsets 0, D and 2D of each
// [B, S, 3D] row): TMA loads into a ring on mbarriers, a producer
// warpgroup, two consumer warpgroups on wgmma, the exact row softmax on the
// score accumulators with Q K^T computed once up to S 512 (ROWS form to
// S 256: at S 128 one query tile per (batch row, head), so K and V are read
// once for it; SPLIT form to 512: the keys split between the two
// warpgroups), two passes above.  Its tensor maps see qkv as [B, S, H, Dh]
// at each of the three offsets, so a box clips at its own batch row's S and
// never reads row b + 1.  Rows TMA cannot take (a base off 16 bytes) are
// staged element by element by the producer.  At S <= 64 (banking's
// chunks) one_tile_rows of attention_tile.cuh keeps the row
// instead: mma.sync bf16 with f32 sums, Q, K and V staged at once by
// 16-byte cp.async, a warp's [16, S] scores in registers, the softmax on
// the accumulator fragments (the wgmma form measured 0.0271 against 0.0113
// ms at [256, 32] x 8 heads on the H100 above: PERF.md §6).
//
// f32: the first port's CUDA-core loop below (TF32 is off in this port, and
// a bf16 mma would not compute the f32 function): one block of 128 threads
// (4 warps) per (64-query tile, head, batch row), an online softmax over
// 64-key tiles of K and V staged as f32, p rounded to the input type (a no-op
// in f32) and divided by l at the end.  Warp w owns query rows
// 16w..16w+15; lane l scores keys l and l+32 of the tile and accumulates
// output columns l, l+32, ... of its 16 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attention_tile.cuh"
#include "attention_hopper.cuh"

namespace {

constexpr int TILE = 64;             // queries per block, keys per step
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = TILE / WARPS;   // query rows per warp

// the loop is written for an element type T; only T = float is instantiated
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
      Bs[tid] = ac_attn::key_bias(mrow, s, S);
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

struct Args {
  const void* qkv;
  const int* mask;
  void* out;
  int B, S, H, Dh;
  cudaStream_t stream;
  int* info;        // set: report the instantiation instead of launching
};

template <int DHP>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = smem_bytes<DHP>();
  auto* kernel = attention_qkv_kernel<float, DHP>;
  if (a.info) {
    a.info[5] = a.info[6] = a.info[7] = 0;
    return ac_common::kernel_info(kernel, smem, THREADS, a.info);
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + TILE - 1) / TILE, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(static_cast<const float*>(a.qkv), a.mask,
                                            static_cast<float*>(a.out), a.S, a.H, a.Dh,
                                            1.0f / sqrtf((float)a.Dh));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

using ac_attn::bf16;

// B7's kernel on the packed strides (attention_hopper.cuh)
cudaError_t launch_bf16(const Args& a) {
  const long long D = (long long)a.H * a.Dh;
  const bf16* q = static_cast<const bf16*>(a.qkv);
  return ac_wg::launch({q, q + D, q + 2 * D, a.mask, a.out, a.B, a.S, a.H, a.Dh,
                        (long long)a.S * 3 * D, 3 * D, a.Dh, a.stream, a.info});
}

int run(const Args& a, int dtype) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Dh <= 0 || a.Dh > 128 || a.H > 65535
      || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      if (a.Dh <= 32) return (int)launch_f32<32>(a);
      if (a.Dh <= 64) return (int)launch_f32<64>(a);
      return (int)launch_f32<128>(a);
    case 1:
      return (int)launch_bf16(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qkv [B, S, 3*H*Dh], mask [B, S] int32,
// out [B, S, H*Dh], all contiguous on the current device.  The caller checks
// the envelope (Dh <= 128, Dh % 8 == 0, S % 8 == 0); returns the launch's
// cudaError_t.
extern "C" int ac_attention_qkv(const void* qkv, const int* mask, void* out,
                                int B, int S, int H, int Dh, int dtype,
                                void* stream) {
  return run({qkv, mask, out, B, S, H, Dh, static_cast<cudaStream_t>(stream), nullptr},
             dtype);
}

// The kernel ac_attention_qkv would launch on these arguments (the output
// taken as 16-byte aligned): info[8] = registers per thread, shared bytes
// per block, threads per block, blocks resident per SM, local (spill) bytes
// per thread, consumer warpgroups (0: no wgmma), the wgmma form (0 none, 1
// ROWS, 2 SPLIT, 3 TWO_PASS; attention_hopper.cuh), TMA-fed (1) or staged
// element by element / by cp.async (0).  Launches nothing.
extern "C" int ac_attention_qkv_info(const void* qkv, int B, int S, int H, int Dh,
                                     int dtype, int* info) {
  return run({qkv, nullptr, nullptr, B, S, H, Dh, nullptr, info}, dtype);
}

extern "C" const char* ac_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
