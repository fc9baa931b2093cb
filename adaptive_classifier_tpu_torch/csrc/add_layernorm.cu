// Fused residual add + LayerNorm: out = LN(x + resid) * scale + bias.
//
// Replaces the TPU kernel adaptive_classifier_tpu/ops/layernorm.py:52
// `add_layer_norm_pallas` (pallas_call at :63, `_add_ln_kernel` :42): the sum
// in f32, mean and the two-pass variance mean((s - mean)^2) in f32, then
// (s - mean) * 1/sqrt(var + eps), scale and bias in f32, written in x's type.
// The reciprocal square root is the IEEE one (1.0f / sqrtf), not the
// approximate rsqrtf, so f32 agrees with the plain version to ~1e-6.  Unlike
// the TPU kernel it takes any number of rows (no R % tile).
//
// What bounds it on an H100: memory.  It reads x and resid and writes out,
// 3 * R * D elements, and the two f32 vectors once: at the zoo's banking
// chunk (R = 8,192, D = 512, bf16) that is 25 MB, 7.5 us at 3.35 TB/s,
// against ~8 * R * D = 34 M f32 operations.
//
// The design reads each element once and writes it once: one warp per row,
// the row held in registers as 16-byte vectors (D = 512 in bf16 is 2 vectors,
// 16 values, a lane), both statistics reduced with warp shuffles; nothing
// but the output returns to device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_VPL = 8;           // 16-byte vectors per lane

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a 16-byte vector of T as f32 values, and back
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    #pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS)
add_ln_kernel(const T* __restrict__ x, const T* __restrict__ resid,
              const float* __restrict__ scale, const float* __restrict__ bias,
              float eps, T* __restrict__ out, int R, int D) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const int nvec = D / N;
  const T* xr = x + row * D;
  const T* rr = resid + row * D;

  float s[VPL][N];
  float sum = 0.f;
  #pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (lane + 32 * i) * N;
    if (lane + 32 * i < nvec) {
      float a[N], b[N];
      Vec<T>::load(xr + c, a);
      Vec<T>::load(rr + c, b);
      #pragma unroll
      for (int j = 0; j < N; ++j) {
        s[i][j] = a[j] + b[j];
        sum += s[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
  #pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nvec) {
      #pragma unroll
      for (int j = 0; j < N; ++j) {
        const float d = s[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float var = warp_sum(sq) / (float)D;
  const float inv = 1.0f / sqrtf(var + eps);

  T* orow = out + row * D;
  #pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (lane + 32 * i) * N;
    if (lane + 32 * i < nvec) {
      float y[N];
      #pragma unroll
      for (int j = 0; j < N; ++j)
        y[j] = (s[i][j] - mean) * inv * __ldg(scale + c + j) + __ldg(bias + c + j);
      Vec<T>::store(orow + c, y);
    }
  }
}

template <typename T, int VPL>
cudaError_t launch(const void* x, const void* r, const float* scale, const float* bias,
                   float eps, void* out, int R, int D, cudaStream_t stream) {
  const int blocks = (R + WARPS - 1) / WARPS;
  add_ln_kernel<T, VPL><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, bias, eps,
      static_cast<T*>(out), R, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* r, const float* scale, const float* bias,
                     float eps, void* out, int R, int D, cudaStream_t stream) {
  const int per_lane = (D / Vec<T>::N + 31) / 32;
  if (per_lane <= 1) return launch<T, 1>(x, r, scale, bias, eps, out, R, D, stream);
  if (per_lane <= 2) return launch<T, 2>(x, r, scale, bias, eps, out, R, D, stream);
  if (per_lane <= 4) return launch<T, 4>(x, r, scale, bias, eps, out, R, D, stream);
  return launch<T, MAX_VPL>(x, r, scale, bias, eps, out, R, D, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, resid and out).  x, resid, out
// [R, D] and scale, bias [D] float32, all contiguous, 16-byte aligned, on the
// current device; D a multiple of the values in 16 bytes (4 f32, 8 bf16) and
// at most 32 * 8 such vectors.  Returns the launch's cudaError_t.
extern "C" int ac_add_layer_norm(const void* x, const void* resid, const void* scale,
                                 const void* bias, float eps, void* out, int R, int D,
                                 int dtype, void* stream) {
  const int n = dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N;
  if (R <= 0 || D <= 0 || D % n || D / n > 32 * MAX_VPL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return (int)dispatch<float>(x, resid, g, b, eps, out, R, D, st);
    case 1: return (int)dispatch<__nv_bfloat16>(x, resid, g, b, eps, out, R, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
