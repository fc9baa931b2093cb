// Kernels B2 and B9: the int8 projections of the encoder layer.
//
// B2 replaces the TPU kernel adaptive_classifier_tpu/ops/matmul_int8.py:80
// `quant_matmul_int8` (pallas_call at :94, body `_matmul_kernel` :48):
//     out[M, N] = (q(x) @ w_q) * x_scale * w_scale + b        (in x's type)
// with q(x) the per-row symmetric int8 quantization of x (scale = absmax *
// (1/127), floor 1e-8), w_q [K, N] int8 with per-output-channel scales,
// and an int32 accumulator.  It is the fused QKV projection of the int8
// forward (models/encoder_int8.py:165): K = D, N = 3D (1,536 for the zoo's
// encoder, 2,304 for bert-base).
//
// B9 replaces ops/matmul_int8.py:115 `proj_residual_ln_int8` (pallas_call
// at :135, body `_proj_ln_kernel` :59):
//     out[M, D] = LayerNorm(q(x) @ w_q * x_scale * w_scale + b + res)
// with f32 statistics, in x's type.  No path of either package calls it
// (the JAX package's only caller is its test); it is held against its
// plain version.
//
// What bounds them on an H100: bytes.  B2 reads M*K*2 + K*N + 8N bytes and
// writes M*N*2: at the banking chunk (M 8,192, K 512, N 1,536) 34.4 MB,
// 10.3 us at 3.35 TB/s, against 2*M*K*N = 12.9 GOP, 6.5 us at the 1,979
// TOP/s int8 tensor-core peak; at the hallucination chunk (M 32,768)
// 40.3 us; at bert-base (M 4,096, K 768, N 2,304) 8.0 us.  B9 at the
// banking M: 6*M*D + D*D bytes, 25.4 MB, 7.6 us, against 4.3 GOP, 2.2 us.
//
// B2's design, on Hopper's asynchronous path (int8_hopper.cuh): a block is
// a producer warp and two consumer warpgroups (288 threads), and owns a
// unit of 64 rows by a group of 64-column chunks.
// - q(x) [64, K] is quantized once per unit by the consumer threads
//   straight into the A operand's swizzled layout (32 KB at K 512, 48 KB at
//   768; int8_hopper.cuh quant_rows, as B3 and B8 quantize their rows), a
//   proxy fence before the first wgmma reads it, while the producer's
//   first weight boxes are already in flight.
// - The weight's K-contiguous copy [N, K] (ops/ffn_int8.py k_contiguous;
//   its tensor map made once a weight and kept on it) comes by 2-D TMA in
//   boxes of 64 columns x 128 bytes of K into a ring of 4-8 slots (as
//   many as leave two blocks an SM, and even: slot i holds only boxes of
//   warpgroup i % 2, which waits on every phase of it); warpgroup g takes
//   chunks 2p + g, each a product of K / 32 s8 wgmmas m64n64k32.
// - The epilogue dequantizes in the plain version's order (acc * x_scale *
//   w_scale + b, each step rounded) into a warpgroup's staging tile in the
//   128-byte swizzle (conflict-free), and one thread writes it by a TMA
//   store: whole 128-byte lines, rows past M clipped by the tensor map.
//   The store runs while the next chunk's products do.
// - The column group: the fewest groups (so the fewest re-reads of x from
//   L2 and re-quantizations) that give at least two units an SM, so both
//   co-resident blocks of every SM have work: floor(2 * SMs / row tiles),
//   at most N / 64.  On 132 SMs: 2 groups of 768 columns at the banking
//   chunk (256 units), 1 at the hallucination chunk (512 units, ~2 waves),
//   4 of 576 at bert-base (256 units).
// The int8 operands and the int32 sums are exactly the plain version's and
// the epilogue rounds each step as it does: every output equals the plain
// version's bit for bit.
//
// B9's design.  The LayerNorm needs whole rows, so a block owns rows by all
// D columns: 32 rows at D <= 512 (16 above, where 32 rows' accumulators
// would not fit the registers of two blocks an SM), 8 warps side by side
// over the columns (D / 64 each), so M = 8,192 launches 256 blocks, two an
// SM.  The product is ring_gemm (int8_tile.cuh: mma.sync m16n8k32 with
// both operands by ldmatrix) on the weight's K-contiguous copy, in [D, 64]
// slices through a two-slot cp.async ring.  Its epilogue: the dequantized
// rows plus bias and residual stay in the accumulators' registers,
// ln_stats reduces each row's sum and squared deviations across the 8
// column warps through shared memory, and each thread writes its
// normalized values straight to out.  No f32 tile of the rows and no
// scratch: 82 KB of shared memory at D 512 (q(x) 17 KB, the ring 64 KB).
// Every block reads the whole weight from L2 (256 KB at D 512).
// Ragged M is masked in the kernels: no padding to a tile multiple.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

#include "int8_hopper.cuh"
#include "int8_tile.cuh"

namespace {

using namespace ac_int8;

// B9: all D columns a block over 8 warps (NT = D / 64 n8 tiles each), MT
// m16 tiles of rows: 32 rows (MT 2) up to D B9_WIDE_MAX_D, else 16
template <int MT, int NT>
using B9Gemm = Ring<1, 8, MT, NT, 64>;
constexpr int B9_RING = 2;
constexpr int B9_WIDE_MAX_D = 512;
constexpr int B9_MAX_D = 1024;


namespace b2 {

using namespace ac_hopper;
using ac_i8h::a_offset;
using ac_i8h::warps_bar_sync;
using ac_i8h::fence_acc;
using ac_i8h::wgmma_m64n64k32_s8;

constexpr int ROWS = 64;                   // rows a unit (wgmma M)
constexpr int KB = 128;                    // bytes of K a box (one swizzle atom)
constexpr int BN = 64;                     // output columns a chunk
constexpr int NCW = 2;                     // consumer warpgroups
constexpr int CT = 128 * NCW;              // consumer threads
constexpr int THREADS = CT + 32;           // + the producer warp
constexpr int XBAR = 1;                    // named barrier of the consumers; 2 + g: warpgroup g's
constexpr int BOX = BN * KB;               // a weight box: 64 columns x 128 bytes of K
static_assert(BN == ac_i8h::BOX_ROWS && ROWS == ac_i8h::BOX_ROWS,
              "the weight map's boxes (ac_i8h::bytes_map) are what the kernel waits for");
constexpr int SLAB = ROWS * KB;            // a slab of q(x)
constexpr int MIN_STAGES = 2 * NCW;        // two boxes held by each warpgroup
constexpr int MAX_STAGES = 8;
constexpr int TWO_A_SM = 113 * 1024;       // a block's share when two share an SM

// bytes of a warpgroup's staging tile: 64 rows x 64 columns of T, in boxes
// of 128-byte rows
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return ROWS * BN * (int)sizeof(T);
}

// Shared memory from the first 1024-byte boundary: q(x) [K / 128 slabs][64]
// [128], the weight ring, the warpgroups' staging tiles, q(x)'s row scales
// [64], the barriers full[MAX_STAGES], empty[MAX_STAGES].
struct Layout {
  int abuf, ring, stg, cs, bar, total;
  __host__ __device__ Layout(int K, int stages, int stg_bytes) {
    abuf = 0;
    ring = abuf + ROWS * K;
    stg = ring + stages * BOX;
    cs = stg + NCW * stg_bytes;
    bar = cs + ROWS * 4;
    total = bar + 8 * 2 * MAX_STAGES + 1024;   // + alignment slack
  }
};

struct Params {
  const void* x;                           // [M, K], x's type
  const float *ws, *bias;                  // [N]
  int M, K, N;
  int groups, cpg;                         // column groups, 64-column chunks a group
  int stages;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
quant_matmul_kernel(const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap mout,
                    const Params p) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const Layout l(p.K, p.stages, stage_bytes<T>());
  uint64_t* full = reinterpret_cast<uint64_t*>(base + l.bar);
  uint64_t* empty = full + MAX_STAGES;
  float* cs = reinterpret_cast<float*>(base + l.cs);
  auto slot = [&](int s) { return base + l.ring + s * BOX; };
  const int m0 = (blockIdx.x / p.groups) * ROWS;
  const int ch0 = (blockIdx.x % p.groups) * p.cpg;
  const int ch1 = min(p.N / BN, ch0 + p.cpg);
  const int pairs = (ch1 - ch0 + NCW - 1) / NCW;
  if (threadIdx.x == 0) {
    for (int i = 0; i < MAX_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);             // the consuming warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CT) {                 // the producer warp: one thread loads
    if (threadIdx.x == CT) {
      uint32_t s = 0, ph = 0;
      for (int pr = 0; pr < pairs; ++pr)
        for (int k0 = 0; k0 < p.K; k0 += KB)
          for (int g = 0; g < NCW; ++g) {
            const int ch = ch0 + NCW * pr + g;
            wait_phase(&empty[s], ph ^ 1);
            if (ch < ch1) {
              mbar_arrive_expect_tx(&full[s], BOX);
              tma_load_2d(slot(s), &mw, &full[s], k0, ch * BN);
            } else {
              mbar_arrive(&full[s]);
            }
            if (++s == (uint32_t)p.stages) s = 0, ph ^= 1;
          }
    }
    return;
  }

  const int g = threadIdx.x / 128, tw = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int q = lane & 3, r0 = 16 * (tw >> 5) + (lane >> 2);
  // q(x), once for the unit (rows past M are zeros)
  ac_i8h::quant_rows<CT, true>(static_cast<const T*>(p.x), p.M, p.K, m0, threadIdx.x,
                               base + l.abuf, cs);
  fence_proxy_async();                       // q(x)'s writes before the wgmmas read them
  warps_bar_sync(XBAR, CT);
  float xs[2];
  #pragma unroll
  for (int h = 0; h < 2; ++h) xs[h] = cs[r0 + 8 * h];

  unsigned char* stg = base + l.stg + g * stage_bytes<T>();
  uint32_t ws = g, wph = 0;                  // warpgroup g's boxes: every NCW-th
  auto next = [&]() {
    ws += NCW;
    if (ws >= (uint32_t)p.stages) ws -= p.stages, wph ^= 1;
  };
  auto release = [&](uint32_t s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  for (int pr = 0; pr < pairs; ++pr) {
    const int ch = ch0 + NCW * pr + g;
    if (ch >= ch1) {                         // no such chunk: consume its boxes
      for (int k0 = 0; k0 < p.K; k0 += KB) {
        wait_phase(&full[ws], wph);
        release(ws);
        next();
      }
      continue;
    }
    // acc = q(x) . (the chunk's W columns)^T over K; one box's products stay
    // in flight while the next box is awaited
    int acc[32];
    uint32_t prev = 0;
    for (int ks = 0; ks < p.K / KB; ++ks) {
      const uint32_t s = ws;
      wait_phase(&full[s], wph);
      const uint64_t da = sw128_desc(base + l.abuf + ks * SLAB), db = sw128_desc(slot(s));
      wgmma_fence();
      #pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)
        wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      next();
      if (ks > 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(prev);

    // the staging tile is free once the last store from it has read it
    if (tw == 0) bulk_wait_read();
    warps_bar_sync(2 + g, 128);
    const int n0 = ch * BN;
    #pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 wsc = *reinterpret_cast<const float2*>(p.ws + n0 + c);
      const float2 b = *reinterpret_cast<const float2*>(p.bias + n0 + c);
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float v0 = dequant(acc[4 * j + 2 * h], xs[h], wsc.x, b.x);
        const float v1 = dequant(acc[4 * j + 2 * h + 1], xs[h], wsc.y, b.y);
        if constexpr (BF16) {
          // row r's 128 bytes, 16-byte chunk j at j ^ (r % 8)
          *reinterpret_cast<__nv_bfloat162*>(stg + r * 128 + ((j ^ (r & 7)) << 4) + 4 * q) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          // two boxes of 32 columns; in box j / 4, chunk 2 (j % 4) + q / 2
          const int chunk = 2 * (j & 3) + (q >> 1);
          *reinterpret_cast<float2*>(stg + (j >> 2) * (ROWS * KB) + r * 128
                                     + ((chunk ^ (r & 7)) << 4) + 8 * (q & 1)) =
              make_float2(v0, v1);
        }
      }
    }
    fence_proxy_async();                     // the tile's writes before the TMA reads it
    warps_bar_sync(2 + g, 128);
    if (tw == 0) {
      tma_store_2d(&mout, stg, n0, m0);
      if constexpr (!BF16) tma_store_2d(&mout, stg + ROWS * KB, n0 + 32, m0);
      bulk_commit();
    }
  }
  if (tw == 0) bulk_wait();                  // every store done before the block leaves
}

// a 2-D map over out [M, N] of T, boxes of 64 rows x 128 bytes, 128-byte
// swizzle (the staging tiles' layout)
template <typename T>
cudaError_t out_map(CUtensorMap* map, void* out, int M, int N) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(KB / sizeof(T)), (cuuint32_t)ROWS};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          2, out, dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What launches of the kernel take of a device: its SMs and the shared
// memory a block may take, the kernel's cap on dynamic shared memory raised
// to that once (launches differ only in K's share).
struct Plan {
  int sms = 0, optin = 0;
};

// info set: report the instantiation (ac_common::kernel_info; then rows and
// columns a unit, blocks in the grid) instead of launching.  wmap: a host
// copy of the tensor map over the weight's K-contiguous copy [N, K]
// (ac_int8_weight_map).
template <typename T>
cudaError_t launch(const void* x, const void* wmap, const float* ws, const float* b, void* out,
                   int M, int K, int N, cudaStream_t stream, int* info) {
  auto* kernel = quant_matmul_kernel<T>;
  static PerDevice<Plan> plans;
  Plan pl;
  cudaError_t err = plans.get(&pl, [&](int device, Plan* out) {
    cudaError_t e = cudaDeviceGetAttribute(&out->sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&out->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out->optin);
    return e;
  });
  if (err != cudaSuccess) return err;
  const int sms = pl.sms;
  const int fixed = Layout(K, 0, stage_bytes<T>()).total;
  // a multiple of NCW slots: slot i then always holds a box of warpgroup
  // i % NCW, which waits on every phase of it; a slot shared between
  // warpgroups let one run two phases ahead and pass the parity test of the
  // earlier phase (a box read before it landed, seen at 5 slots)
  const int stages = max(MIN_STAGES, min(MAX_STAGES, (TWO_A_SM - fixed) / BOX)) / NCW * NCW;
  const int smem = Layout(K, stages, stage_bytes<T>()).total;
  if (smem > pl.optin) return cudaErrorInvalidValue;
  const int tiles = (M + ROWS - 1) / ROWS, nch = N / BN;
  int groups = max(1, min(nch, 2 * sms / tiles));
  const int cpg = (nch + groups - 1) / groups;
  groups = (nch + cpg - 1) / cpg;
  const long long blocks = (long long)tiles * groups;
  if (info) {
    info[5] = ROWS;
    info[6] = cpg * BN;
    info[7] = (int)blocks;
    return ac_common::kernel_info(kernel, smem, THREADS, info);
  }
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  if (!aligned(x) || !aligned(out)) return cudaErrorInvalidValue;
  CUtensorMap mw, mout;
  memcpy(&mw, wmap, sizeof mw);
  err = out_map<T>(&mout, out, M, N);
  if (err != cudaSuccess) return err;
  const Params p = {x, ws, b, M, K, N, groups, cpg, stages};
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(mw, mout, p);
  return cudaGetLastError();
}

}  // namespace b2

// B9.  Block b: rows b * G::ROWS.., all D columns; wt [D][D] is w_q's
// K-contiguous copy.
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(THREADS, 2)
proj_residual_ln_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ ws, const float* __restrict__ bias,
                        const T* __restrict__ res, const float* __restrict__ g,
                        const float* __restrict__ beta, float eps,
                        T* __restrict__ out, int M, int D) {
  using G = B9Gemm<MT, NT>;
  static_assert(G::THREADS == THREADS, "quant_rows_global takes WARPS warps");
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lda = D + 16;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + (size_t)G::ROWS * lda);
  float* red = xs + G::ROWS;                                 // [ROWS][WN]
  int8_t* ring = reinterpret_cast<int8_t*>(red + G::ROWS * G::WN);
  const int m0 = blockIdx.x * G::ROWS;

  quant_rows_global<true>(x, M, D, m0, G::ROWS, xq, lda, xs);
  ring_gemm<G, B9_RING>(xq, lda, wt, D, D, ring,
      [&](int, int row0, int col0, int (&acc)[MT][NT][4]) {
        // q(x) @ W * s_x * s_w + b + res, in the accumulators' own
        // registers (each sum is read before its slot is rewritten)
        float (&y)[MT][NT][4] = reinterpret_cast<float (&)[MT][NT][4]>(acc);
        #pragma unroll
        for (int m = 0; m < MT; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            const bool live = m0 + r < M;
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float2 rv = live ? load2(res, BF16, (size_t)(m0 + r) * D + c)
                                     : make_float2(0.f, 0.f);
              const int a0 = acc[m][n][2 * hf], a1 = acc[m][n][2 * hf + 1];
              y[m][n][2 * hf] = __fadd_rn(dequant(a0, xs[r], ws[c], bias[c]), rv.x);
              y[m][n][2 * hf + 1] = __fadd_rn(dequant(a1, xs[r], ws[c + 1], bias[c + 1]), rv.y);
            }
          }
        float mean[MT][2], inv[MT][2];
        ln_stats<G::WN>(y, red, row0, D, eps, mean, inv);
        #pragma unroll
        for (int m = 0; m < MT; ++m)
          #pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + 16 * m + acc_row(2 * hf);
            if (m0 + r >= M) continue;
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int c = col0 + 8 * n + acc_col(0);
              const float a = (y[m][n][2 * hf] - mean[m][hf]) * inv[m][hf] * g[c] + beta[c];
              const float b =
                  (y[m][n][2 * hf + 1] - mean[m][hf]) * inv[m][hf] * g[c + 1] + beta[c + 1];
              store2(out, BF16, (size_t)(m0 + r) * D + c, a, b);
            }
          }
      });
}

size_t proj_ln_smem(int rows, int D) {
  return (size_t)rows * (D + 16) + (size_t)rows * (1 + WARPS) * sizeof(float) +
         B9_RING * (size_t)D * 64;
}
// the card's opt-in shared memory a block may hold
cudaError_t smem_limit(size_t* have) {
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *have = (size_t)v;
  return err;
}
struct ProjLnArgs {
  const void *x, *res;
  const int8_t* wt;
  const float *ws, *b, *g, *beta;
  float eps;
  void* out;
  int M, D;
  cudaStream_t stream;
  int* info;        // set: report the instantiation instead of launching
};

template <typename T, int NT>
cudaError_t launch_proj_ln(const ProjLnArgs& a) {
  constexpr int MT = NT * 64 <= B9_WIDE_MAX_D ? 2 : 1;
  using G = B9Gemm<MT, NT>;
  auto* kernel = proj_residual_ln_kernel<T, MT, NT>;
  const size_t smem = proj_ln_smem(G::ROWS, a.D);
  size_t have = 0;
  cudaError_t err = smem_limit(&have);
  if (err != cudaSuccess) return err;
  if (smem > have) return cudaErrorInvalidValue;
  const int blocks = (a.M + G::ROWS - 1) / G::ROWS;
  if (a.info) {
    a.info[5] = G::ROWS;
    a.info[6] = blocks;
    return ac_common::kernel_info(kernel, smem, G::THREADS, a.info);
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, G::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.wt, a.ws, a.b, static_cast<const T*>(a.res), a.g,
      a.beta, a.eps, static_cast<T*>(a.out), a.M, a.D);
  return cudaGetLastError();
}

// the instantiation for D = 64 NT (NT even: D % 128 == 0)
template <typename T, int NT = 2>
cudaError_t launch_proj_ln_width(const ProjLnArgs& a) {
  if constexpr (NT * 64 > B9_MAX_D) {
    return cudaErrorInvalidValue;
  } else {
    if (a.D == NT * 64) return launch_proj_ln<T, NT>(a);
    return launch_proj_ln_width<T, NT + 2>(a);
  }
}

int proj_ln(const ProjLnArgs& a, int dtype) {
  if (a.M <= 0 || a.D <= 0 || a.D % 128 != 0 || a.D > B9_MAX_D)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_proj_ln_width<float>(a);
    case 1: return (int)launch_proj_ln_width<__nv_bfloat16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % 128 != 0 || N % 64 != 0;
}

int quant_matmul(const void* x, const void* wmap, const void* ws, const void* b, void* out,
                 int M, int K, int N, int dtype, void* stream, int* info) {
  if (bad_shape(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(ws);
  const float* bb = static_cast<const float*>(b);
  switch (dtype) {
    case 0: return (int)b2::launch<float>(x, wmap, s, bb, out, M, K, N, st, info);
    case 1: return (int)b2::launch<__nv_bfloat16>(x, wmap, s, bb, out, M, K, N, st, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The tensor map over an int8 weight's K-contiguous copy w [rows, cols]
// (16-byte aligned, on the current device) that B2 and B3 read: boxes of
// 64 rows x 128 bytes (ac_i8h::bytes_map), 128-byte swizzle, zeros
// outside; written to out (128 bytes of host memory) for the caller to keep
// beside the weight.  Returns a cudaError_t.
extern "C" int ac_int8_weight_map(const void* w, long long rows, int cols, void* out) {
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0 || cols % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = ac_hopper::bind_device(&device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  err = ac_i8h::bytes_map(&map, w, rows, cols);
  if (err == cudaSuccess) memcpy(out, &map, sizeof map);
  return (int)err;
}

// B2.  dtype: 0 = float32, 1 = bfloat16 (of x and out).  x [M, K], out
// [M, N], both 16-byte aligned; wmap the host copy of the tensor map over
// w_q's K-contiguous copy [N, K] (ac_int8_weight_map); ws
// and b [N] f32; all on the current device; K % 128 == 0, N % 64 == 0.
// Returns the launch's cudaError_t.
extern "C" int ac_quant_matmul_int8(const void* x, const void* wmap, const void* ws,
                                    const void* b, void* out, int M, int K, int N,
                                    int dtype, void* stream) {
  return quant_matmul(x, wmap, ws, b, out, M, K, N, dtype, stream, nullptr);
}

// The kernel ac_quant_matmul_int8 would launch for [M, K] rows of dtype and
// N columns: info[8] = registers per thread, shared bytes per block,
// threads per block, blocks resident per SM, local (spill) bytes per
// thread, rows and columns a unit, blocks in the grid.  Launches nothing.
extern "C" int ac_quant_matmul_int8_info(int M, int K, int N, int dtype, int* info) {
  return quant_matmul(nullptr, nullptr, nullptr, nullptr, nullptr, M, K, N, dtype, nullptr,
                      info);
}

// B9.  dtype as above, of x, res and out.  x, res, out [M, D]; wt [D, D]
// int8 (w_q transposed: K contiguous); ws, b, g, beta [D] f32; all
// contiguous on the current device; D % 128 == 0, D <= 1,024.  Returns the
// launch's cudaError_t.
extern "C" int ac_proj_residual_ln_int8(const void* x, const void* wt, const void* ws,
                                        const void* b, const void* res, const void* g,
                                        const void* beta, float eps, void* out, int M,
                                        int D, int dtype, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return proj_ln({x, res, static_cast<const int8_t*>(wt), f(ws), f(b), f(g), f(beta), eps,
                  out, M, D, static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

// The kernel ac_proj_residual_ln_int8 would launch for [M, D] rows of
// dtype: info[7] = registers per thread, shared bytes per block, threads per
// block, blocks resident per SM, local (spill) bytes per thread, rows a
// block, blocks in the grid.  Launches nothing.
extern "C" int ac_proj_residual_ln_int8_info(int M, int D, int dtype, int* info) {
  return proj_ln({nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0.f,
                  nullptr, M, D, nullptr, info}, dtype);
}
