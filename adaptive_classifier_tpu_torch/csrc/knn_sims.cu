// Kernel B4: masked exp(-d^2) similarities of queries to class prototypes.
//
// Replaces the TPU kernel adaptive_classifier_tpu/ops/knn.py:78
// `masked_sims_pallas` (pallas_call at :97, body `_knn_kernel` :62).
//
// Computes out[b, c] = valid[c] ? exp(-max(|q_b|^2 + |p_c|^2 - 2 q_b.p_c, 0)) : 0
// for q [B, D], p [C, D] f32 and valid [C] bool, out [B, C] f32, all
// row-major and contiguous; D % 4 == 0 and q, p 16-byte aligned (the
// wrapper pads the rows with zero columns).
//
// What bounds it on an H100: operations.  2*B*C*D FLOP against
// 4*(B*D + C*D + B*C) + C bytes; at phase 8's chunk (B 256, C 16384, D 512)
// that is 4.3 GFLOP, 64 us at the 67 TFLOP/s f32 rate outside the tensor
// cores, against 50 MB, 15 us at 3.35 TB/s.  One TF32 product would move
// exp(-d^2) by ~1e-3, so the product runs on the tensor cores in three TF32
// products a pair (hi.lo + lo.hi + hi.hi, the split of hopper.cuh): 12.9
// GFLOP, 26 us at the 495 TFLOP/s dense TF32 peak.
//
// Design (pass 1, sims_kernel): a block of three warpgroups per 128 x 128
// output tile and a range of the contraction, one block an SM.
//  - Producer (warpgroup 2, setmaxnreg 40): one thread walks the range in
//    slices of 32 columns and loads each slice's [128, 32] query rows and
//    [128, 32] prototype rows by TMA (128 bytes a row: one swizzle atom)
//    into a ring of four slots on mbarriers (full: the bytes landed; empty:
//    the eight consumer warps are done with it).  Rows past B or C and
//    columns past D arrive as zeros.
//  - Consumers (warpgroups 0 and 1), each an m64 x n128 tile.  Once a slice
//    lands, their 256 threads split it, a row each: the slice itself is the
//    hi operand, lo = tf32(x - hi) goes to one of two lo buffers at the same
//    offsets, and the row's squares are summed on the way (the norms).  A
//    barrier of the 256, then each warpgroup issues its 12 wgmma
//    m64n128k8 (lo.hi, hi.lo, hi.hi for 4 steps of 8 columns) into a fresh
//    accumulator, scale-d 0 on the first, and splits the next slice while
//    they run.  After wgmma.wait_group the fresh sum is added to the running
//    dot products by IEEE adds: the tensor cores add with truncation, and
//    one running accumulator near |q||p| drifts ~1e-5 over D 512 (PERF.md,
//    B5).  Operands come from shared memory, so the fresh (64) and running
//    (64) accumulators are the consumers' only large register cost.
//  - Epilogue: straight from the accumulators, 8-byte stores (32
//    contiguous bytes a row from each quad of lanes).  With one split each
//    value leaves as valid ? exp(-max(d^2, 0)) : 0.
// Split contraction: where the output tiles alone would leave most of the
// 132 SMs idle (phase 7's chunk: 16 tiles; the production width D 33,280 at
// 256 x 1,024: 16), the wrapper splits the slices over S blocks a tile.
// Pass 1 then writes its raw dot products [S, B, C] and the partial norms
// of its rows, and pass 2 (combine_kernel) sums them in split order, clamps,
// takes exp and masks: no atomics, the same result on every run.
// What holds it back (PERF.md): ptxas allocates the consumers' registers
// within the kernel's 168 at launch, whatever setmaxnreg grants, so a
// second fresh accumulator (to issue slice i + 1 before adding slice i)
// spills and serialises every wgmma (warning C7518), and ran 1.8x slower;
// the split, the adds and the epilogue do not overlap the products.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "knn_tile.cuh"

namespace {

using namespace ac_hopper;
using ac_knn::sim_from_dot;

constexpr int BM = 128;                   // query rows a tile (two m64 warpgroups)
constexpr int BN = 128;                   // prototypes a tile (wgmma n128)
constexpr int KS = 32;                    // contraction columns a slice (128 bytes)
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int CT = 128 * CONSUMERS;       // consumer threads
constexpr int THREADS = CT + 128;         // + the producer warpgroup
constexpr int HI_STAGES = 4;              // ring slots the TMA loads fill
constexpr int LO_BUFS = 2;                // lo buffers: one read by wgmma, one written
constexpr int TILE_A = BM * KS * 4;       // bytes of a slice's query rows
constexpr int SLICE = TILE_A + BN * KS * 4;   // bytes of a landed slice
constexpr int MIN_SLICES = 2;             // fewest slices a split takes
constexpr int MAX_SPLITS = 64;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_BAR = 1;           // named barrier of the consumer threads

constexpr int OFF_LO = HI_STAGES * SLICE;
constexpr int OFF_NORM = OFF_LO + LO_BUFS * SLICE;
constexpr int OFF_BAR = OFF_NORM + 4 * (BM + BN);
constexpr int SMEM = OFF_BAR + 8 * 2 * HI_STAGES + 1024;   // + alignment slack

static_assert(BM + BN == CT, "each consumer thread splits one row of a slice");
static_assert(TILE_A % 1024 == 0 && SLICE % 1024 == 0 && (64 * KS * 4) % 1024 == 0,
              "every wgmma tile starts on a 1024-byte boundary");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CT <= 65536, "register budget");

// Split landed slice `h` into lo buffer `l` (the same offsets: the split is
// elementwise): consumer thread ct takes row ct of the slice (query rows
// 0..127, then prototypes), its eight 16-byte chunks in the order
// j ^ (ct % 8), so that the eight threads of a quarter warp read eight
// different chunk positions of the 128-byte swizzle (no bank conflicts),
// and adds the row's squares to sq.  The fence orders the lo writes before
// wgmma reads them.
__device__ __forceinline__ void split_slice(const unsigned char* h, unsigned char* l, int ct,
                                            float& sq) {
  const float4* x4 = reinterpret_cast<const float4*>(h) + 8 * ct;
  float4* l4 = reinterpret_cast<float4*>(l) + 8 * ct;
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j ^ (ct % 8);
    const float4 x = x4[c];
    sq = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, sq))));
    l4[c] = make_float4(tf32_rest(x.x), tf32_rest(x.y), tf32_rest(x.z), tf32_rest(x.w));
  }
  fence_proxy_async();
}

// a slice's 12 products for warpgroup wg's 64 query rows into the fresh sum p
__device__ __forceinline__ void issue_slice(const unsigned char* h, const unsigned char* l,
                                            int wg, float (&p)[64]) {
  const uint64_t ah = sw128_desc(h + wg * 64 * KS * 4), bh = sw128_desc(h + TILE_A);
  const uint64_t al = sw128_desc(l + wg * 64 * KS * 4), bl = sw128_desc(l + TILE_A);
  wgmma_fence();
  #pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    // a step of 8 columns is 32 bytes: 2 in the descriptor's units
    wgmma_m64n128k8_tf32(p, al + 2 * kk, bh + 2 * kk, kk > 0);
    wgmma_m64n128k8_tf32(p, ah + 2 * kk, bl + 2 * kk, 1);
    wgmma_m64n128k8_tf32(p, ah + 2 * kk, bh + 2 * kk, 1);
  }
  wgmma_commit();
}

// Dynamic shared memory from its first 1024-byte boundary (the 128-byte
// swizzle's): the ring of HI_STAGES slices, the lo buffers, the rows'
// norms, then the barriers: full[HI_STAGES] (a slot's bytes landed) and
// empty[HI_STAGES] (the consumer warps are done with it).
__device__ __forceinline__ unsigned char* aligned(unsigned char* raw) {
  return raw + (1024 - smem_addr(raw) % 1024) % 1024;
}

__device__ __forceinline__ uint64_t* barriers(unsigned char* raw) {
  return reinterpret_cast<uint64_t*>(aligned(raw) + OFF_BAR);
}

__global__ void __launch_bounds__(THREADS, 1)
sims_kernel(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_p,
            const unsigned char* __restrict__ valid, float* __restrict__ dst,
            float* __restrict__ qn_part, float* __restrict__ pn_part,
            int B, int C, int slices, int per, int splits) {
  extern __shared__ unsigned char smem_raw[];
  if (threadIdx.x == 0) {
    uint64_t* full = barriers(smem_raw);
    for (int i = 0; i < HI_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&full[HI_STAGES + i], CT / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // everything else is computed after setmaxnreg: ptxas spills what lives
  // across it

  if (threadIdx.x >= CT) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CT) {
      unsigned char* hi = aligned(smem_raw);
      uint64_t* full = barriers(smem_raw);
      uint64_t* empty = full + HI_STAGES;
      const int s0 = blockIdx.z * per, n = min(slices, s0 + per) - s0;
      for (int i = 0; i < n; ++i) {
        const int st = i % HI_STAGES;
        wait_phase(&empty[st], ((i / HI_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], SLICE);
        const int k0 = (s0 + i) * KS;
        tma_load_2d(hi + st * SLICE, &map_q, &full[st], k0, blockIdx.y * BM);
        tma_load_2d(hi + st * SLICE + TILE_A, &map_p, &full[st], k0, blockIdx.x * BN);
      }
    }
  } else {
    // ---- consumers: the split, the products, the running sums, the output ----
    setmaxnreg_inc<CONSUMER_REGS>();
    unsigned char* hi = aligned(smem_raw);
    unsigned char* lo = hi + OFF_LO;
    uint64_t* full = barriers(smem_raw);
    uint64_t* empty = full + HI_STAGES;
    float* norm = reinterpret_cast<float*>(hi + OFF_NORM);   // query rows, then prototypes
    const int ct = threadIdx.x, wg = ct / 128, lane = ct % 32;
    const int split = blockIdx.z, s0 = split * per, n = min(slices, s0 + per) - s0;
    float acc[64], part[64], sq = 0.f;
    #pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = part[r] = 0.f;

    wait_phase(&full[0], 0);
    split_slice(hi, lo, ct, sq);
    named_bar_sync(CONSUMER_BAR, CT);
    for (int i = 0; i < n; ++i) {
      const int st = i % HI_STAGES;
      issue_slice(hi + st * SLICE, lo + i % LO_BUFS * SLICE, wg, part);
      // while slice i's products run, split slice i + 1 into the other lo buffer
      if (i + 1 < n) {
        wait_phase(&full[(i + 1) % HI_STAGES], ((i + 1) / HI_STAGES) & 1);
        split_slice(hi + (i + 1) % HI_STAGES * SLICE, lo + (i + 1) % LO_BUFS * SLICE, ct, sq);
      }
      wgmma_wait<0>();
      fence_operands(part);
      // the fresh sum into the running sums by IEEE adds (see the top)
      #pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (i + 1 < n) named_bar_sync(CONSUMER_BAR, CT);   // slice i + 1 is split
    }

    norm[ct] = sq;
    named_bar_sync(CONSUMER_BAR, CT);

    // straight from the accumulators: rows rl and rl + 8 of the tile,
    // columns cl and cl + 1 for each of the 16 n8 blocks (8-byte stores
    // where C is even: 32 contiguous bytes a row from each quad of lanes)
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const int rl = 64 * wg + 16 * ((ct % 128) / 32) + lane / 4;
    float* out = dst + (size_t)split * B * C;
    const bool pairs = C % 2 == 0;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + rl + 8 * h;
      if (r >= B) continue;
      const float qn = norm[rl + 8 * h];
      float* row = out + (size_t)r * C;
      #pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cl = 8 * j + 2 * (lane % 4), c = col0 + cl;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (splits == 1) {
          v0 = c < C && valid[c] ? sim_from_dot(qn, norm[BM + cl], v0) : 0.f;
          v1 = c + 1 < C && valid[c + 1] ? sim_from_dot(qn, norm[BM + cl + 1], v1) : 0.f;
        }
        if (pairs && c + 1 < C) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          if (c < C) row[c] = v0;
          if (c + 1 < C) row[c + 1] = v1;
        }
      }
    }
    if (splits > 1 && ct < BM) {
      if (blockIdx.x == 0 && row0 + ct < B) qn_part[(size_t)split * B + row0 + ct] = norm[ct];
      if (blockIdx.y == 0 && col0 + ct < C)
        pn_part[(size_t)split * C + col0 + ct] = norm[BM + ct];
    }
  }
}

// pass 2: out = valid ? exp(-max(sum qn + sum pn - 2 sum dot, 0)) : 0, the
// splits' partial sums added in split order
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part, const float* __restrict__ qn_part,
               const float* __restrict__ pn_part, const unsigned char* __restrict__ valid,
               float* __restrict__ out, int B, int C, int splits) {
  const int c = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (c >= C) return;
  float dot = 0.f, qn = 0.f, pn = 0.f;
  for (int s = 0; s < splits; ++s) {
    dot += part[((size_t)s * B + b) * C + c];
    qn += qn_part[(size_t)s * B + b];
    pn += pn_part[(size_t)s * C + c];
  }
  out[(size_t)b * C + c] = valid[c] ? sim_from_dot(qn, pn, dot) : 0.f;
}

int slices_of(int D) { return (D + KS - 1) / KS; }

}  // namespace

// q [B, D] f32, p [C, D] f32, valid [C] bool (one byte each), out [B, C]
// f32, all contiguous on the current device, D % 4 == 0, q and p 16-byte
// aligned.  The contraction's ceil(D / 32) slices go to `splits` blocks of
// `per` slices each (every split non-empty); with splits > 1, `scratch`
// holds splits * (B * C + B + C) floats: the [splits, B, C] dot products,
// then the [splits, B] and [splits, C] partial norms.  Launches pass 1 and,
// with splits > 1, pass 2 on `stream`; returns the first failing step's
// cudaError_t.
extern "C" int ac_masked_sims(const float* q, const float* p, const unsigned char* valid,
                              float* out, float* scratch, int B, int C, int D, int splits,
                              int per, void* stream) {
  const int slices = D > 0 ? slices_of(D) : 0;
  if (B <= 0 || C <= 0 || D <= 0 || D % 4 != 0 || (B + BM - 1) / BM > 65535 ||
      splits < 1 || splits > MAX_SPLITS || per < 1 ||
      (long long)splits * per < slices || (long long)(splits - 1) * per >= slices ||
      (splits > 1 && (scratch == nullptr || B > 65535)) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(p)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // setmaxnreg hands the producer's registers to the consumers: the block
  // must have been given the whole budget at launch, or the consumers'
  // request would wait forever
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, sims_kernel);
    if (err != cudaSuccess) return (int)err;
    regs = at.numRegs;
  }
  if (regs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * CT)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_p;
  cudaError_t err = f32_rows_map(&map_q, q, B, D, BM);
  if (err != cudaSuccess) return (int)err;
  err = f32_rows_map(&map_p, p, C, D, BN);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sims_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? scratch : out;
  float* qn_part = part + (size_t)splits * B * C;
  float* pn_part = qn_part + (size_t)splits * B;
  const dim3 grid((C + BN - 1) / BN, (B + BM - 1) / BM, splits);
  sims_kernel<<<grid, THREADS, SMEM, st>>>(map_q, map_p, valid, part, qn_part, pn_part,
                                           B, C, slices, per, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_kernel<<<dim3((C + 255) / 256, B), 256, 0, st>>>(part, qn_part, pn_part, valid,
                                                          out, B, C, splits);
  return (int)cudaGetLastError();
}

// Pass 1's instantiation: info[10] = registers per thread, shared bytes per
// block, threads per block, blocks resident per SM, local (spill) bytes per
// thread, query rows a tile, prototypes a tile, contraction columns a
// slice, fewest slices a split takes, most splits.  Launches nothing.
extern "C" int ac_masked_sims_info(int* info) {
  info[5] = BM;
  info[6] = BN;
  info[7] = KS;
  info[8] = MIN_SLICES;
  info[9] = MAX_SPLITS;
  return (int)ac_common::kernel_info(sims_kernel, SMEM, THREADS, info);
}
