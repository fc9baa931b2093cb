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
// What bounds it on an H100: memory at the zoo's chunks.  At [256, 32] x 8
// heads (Dh 64, bf16) the inputs and output are 33.6 MB, 0.0100 ms at
// 3.35 TB/s, against 0.0005 ms of products at the bf16 tensor-core peak; at
// [256, 128] 0.0401 against 0.0087 ms; about balanced at bert-base's
// [32, 512] x 12 heads (0.0301 ms of bytes, 0.0261 of products).
//
// bf16 (the card's path): the tensor-core tile loop of attention_tile.cuh
// (mma.sync bf16 with f32 sums, softmax on the accumulator fragments, p in
// registers, K/V staged by 16-byte cp.async), so each element of qkv is read
// once per (batch row, head, query tile) and no score reaches shared or
// device memory.  Two forms of one function:
// - one pass, S <= ONE_PASS_MAX_S: every K/V tile of the row is staged at
//   once (one or two ring slots), a warp keeps all its [16, S] scores in
//   registers (S/8 x 4 f32 a thread, 64 at S = 128), takes each row's max
//   and sum, scales by the reciprocal, rounds and multiplies by V.  K is
//   read and multiplied once.  32-key tiles and 2-warp blocks at S <= 32.
// - two passes above that (B7's body, attention_tile.cuh two_pass_rows):
//   the max and a rescaled sum from K, then the scores again with V.
// Rows that are not 16-byte aligned (an odd base pointer) are staged
// element by element by the same kernels.
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
  if (a.info) return ac_common::kernel_info(kernel, smem, THREADS, a.info);
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
// bf16: the tensor-core tile loop of attention_tile.cuh
// ---------------------------------------------------------------------------

using ac_attn::bf16;
using ac_attn::kMinBlocks;

// longest row the one-pass form takes: a warp's [16, S] f32 scores in
// registers, every K/V tile of the row in the ring's two slots at once (it
// measured 13% faster than the two passes at S 32 and 128 on an H100)
constexpr int ONE_PASS_MAX_S = 128;

// One pass over NT staged tiles (NT <= the ring's slots).
template <class Tl, int NT, bool ALIGNED>
__global__ void __launch_bounds__(Tl::THREADS, kMinBlocks<Tl>)
qkv_one_pass_kernel(const bf16* __restrict__ qkv, const int* __restrict__ mask,
                    bf16* __restrict__ out, int S, int H, int Dh, float scale2) {
  static_assert(NT <= Tl::STAGES, "every tile of the row has a ring slot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ac_attn::Smem<Tl> sm(smem_raw);
  const int q0 = blockIdx.x * Tl::TQ, h = blockIdx.y, b = blockIdx.z;
  const long long D = (long long)H * Dh, ss = 3 * D;
  const bf16* q = qkv + (long long)b * S * ss + (long long)h * Dh;
  const int* mrow = mask + (long long)b * S;

  // Q with tile 0 as the first committed group, then one group a tile
  ac_attn::zero_pad_cols<Tl>(sm.q, Tl::SMEM_ROWS, Dh);
  ac_attn::stage_rows<Tl, ALIGNED>(sm.q, q, ss, q0, Tl::TQ, S, Dh);
  #pragma unroll
  for (int t = 0; t < NT; ++t) {
    ac_attn::stage_rows<Tl, ALIGNED>(sm.k(t), q + D, ss, t * Tl::TK, Tl::TK, S, Dh);
    ac_attn::stage_rows<Tl, ALIGNED>(sm.v(t), q + 2 * D, ss, t * Tl::TK, Tl::TK, S, Dh);
    ac_attn::stage_bias<Tl>(sm.b(t), mrow, t * Tl::TK, S);
    ac_attn::cp_async_commit();
  }

  // every score of the warp's rows, tile t as soon as it has landed
  uint32_t qf[Tl::DHP / 16][4];
  float sc[NT][Tl::NKT][4];
  #pragma unroll
  for (int t = 0; t < NT; ++t) {
    ac_attn::cp_async_wait_pending(NT - 1 - t);
    __syncthreads();
    if (t == 0) ac_attn::load_q<Tl>(sm.q, qf);
    ac_attn::tile_scores<Tl>(qf, sm.k(t), sm.b(t), scale2, sc[t]);
  }

  // the exact row softmax: p = 2^(s - m) / max(l, 1e-30) (rounded to bf16
  // in tile_pv); the thread's rows g (r = 0) and g + 8 (r = 1)
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
    #pragma unroll
    for (int t = 0; t < NT; ++t)
      #pragma unroll
      for (int n = 0; n < Tl::NKT; ++n)
        mx = fmaxf(mx, fmaxf(sc[t][n][2 * r], sc[t][n][2 * r + 1]));
    mx = ac_attn::quad_max(mx);
    float sum = 0.f;
    #pragma unroll
    for (int t = 0; t < NT; ++t)
      #pragma unroll
      for (int n = 0; n < Tl::NKT; ++n) {
        sc[t][n][2 * r] = ac_attn::exp2_approx(sc[t][n][2 * r] - mx);
        sc[t][n][2 * r + 1] = ac_attn::exp2_approx(sc[t][n][2 * r + 1] - mx);
        sum += sc[t][n][2 * r] + sc[t][n][2 * r + 1];
      }
    const float inv_l = 1.f / fmaxf(ac_attn::quad_sum(sum), 1e-30f);
    #pragma unroll
    for (int t = 0; t < NT; ++t)
      #pragma unroll
      for (int n = 0; n < Tl::NKT; ++n) {
        sc[t][n][2 * r] *= inv_l;
        sc[t][n][2 * r + 1] *= inv_l;
      }
  }

  float o[Tl::NDT][4];
  #pragma unroll
  for (int n = 0; n < Tl::NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  #pragma unroll
  for (int t = 0; t < NT; ++t) ac_attn::tile_pv<Tl>(sc[t], sm.v(t), o);
  ac_attn::store_rows<Tl, ALIGNED>(sm.q, o, out, b, q0, S, H, h, Dh);
}

// Two passes (B7's body) on the packed strides.
template <class Tl, bool ALIGNED>
__global__ void __launch_bounds__(Tl::THREADS, kMinBlocks<Tl>)
qkv_two_pass_kernel(const bf16* __restrict__ qkv, const int* __restrict__ mask,
                    bf16* __restrict__ out, int S, int H, int Dh, float scale2) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long D = (long long)H * Dh, ss = 3 * D;
  const bf16* q = qkv + (long long)b * S * ss + (long long)h * Dh;
  ac_attn::two_pass_rows<Tl, ALIGNED>(q, q + D, q + 2 * D, mask + (long long)b * S, out, b,
                                      h, S, H, Dh, ss, scale2);
}

template <class Tl, typename Kernel>
cudaError_t launch_tc(Kernel* kernel, const Args& a) {
  const size_t smem = Tl::smem_bytes();
  if (a.info) return ac_common::kernel_info(kernel, smem, Tl::THREADS, a.info);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + Tl::TQ - 1) / Tl::TQ, a.H, a.B);
  kernel<<<grid, Tl::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.qkv), a.mask, static_cast<bf16*>(a.out), a.S, a.H, a.Dh,
      ac_attn::LOG2E / sqrtf((float)a.Dh));
  return cudaGetLastError();
}

// 2 warps and one 32-key tile at S <= 32 (no half of a tile is padding);
// else 4 warps and 64-key tiles, one pass over one or two of them up to
// ONE_PASS_MAX_S, two passes above
template <int DHP, bool ALIGNED>
cudaError_t launch_bf16(const Args& a) {
  using Short = ac_attn::Tile<DHP, 2, 32>;
  using Long = ac_attn::Tile<DHP, 4, 64>;
  if (a.S <= 32) return launch_tc<Short>(qkv_one_pass_kernel<Short, 1, ALIGNED>, a);
  if (a.S <= 64) return launch_tc<Long>(qkv_one_pass_kernel<Long, 1, ALIGNED>, a);
  if (a.S <= ONE_PASS_MAX_S) return launch_tc<Long>(qkv_one_pass_kernel<Long, 2, ALIGNED>, a);
  return launch_tc<Long>(qkv_two_pass_kernel<Long, ALIGNED>, a);
}

// bf16 rows start on 16 bytes when qkv's and out's bases do (the strides,
// multiples of Dh, hold whole 16-byte chunks inside the envelope)
template <int DHP>
cudaError_t launch_bf16_rows(const Args& a) {
  auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (a.Dh % 8 == 0 && al(a.qkv) && (a.info || al(a.out))) return launch_bf16<DHP, true>(a);
  return launch_bf16<DHP, false>(a);
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
      if (a.Dh <= 32) return (int)launch_bf16_rows<32>(a);
      if (a.Dh <= 64) return (int)launch_bf16_rows<64>(a);
      return (int)launch_bf16_rows<128>(a);
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
// taken as 16-byte aligned): info[5] = registers per thread, shared bytes
// per block, threads per block, blocks resident per SM, local (spill) bytes
// per thread.  Launches nothing.
extern "C" int ac_attention_qkv_info(const void* qkv, int B, int S, int H, int Dh,
                                     int dtype, int* info) {
  return run({qkv, nullptr, nullptr, B, S, H, Dh, nullptr, info}, dtype);
}

extern "C" const char* ac_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
