// Hopper's int8 path: kernel B8 (ffn_block_int8.cu's ac_attn_ffn_block_int8,
// replacing adaptive_classifier_tpu/ops/ffn_int8.py:202) below, and the
// pieces kernels B2 (matmul_int8.cu, replacing ops/matmul_int8.py:80) and
// B3 (ffn_block_int8.cu, replacing ops/ffn_int8.py:95) share with it: s8
// warpgroup MMAs (wgmma m64n{32,64}k32 s8 x s8 -> s32, both operands
// K-major in shared memory in the 128-byte swizzle), the A operand's
// swizzled layout (a_offset), the per-row quantization of a tile's rows
// into it (quant_rows), and the 2-D TMA map over an int8 array in boxes of
// 64 rows x 128 bytes (bytes_map: the weights' K-contiguous copies, B3's
// and B8's q(f)).  What bounds each kernel and the choices of B2 and B3
// are noted in their sources.
//
// B8's function, per row (ops/ffn_int8.py attn_ffn_block_int8_ref):
//     h   = LN1(q(ctx) @ Wo * s_c * so + bo + x)                 f32
//     f   = gelu_tanh(q(h) @ W1 * s_h * s1 + b1)                 f32
//     out = LN2(q(f) @ W2 * s_f * s2 + b2 + h)                   ctx's type
// q() the per-row int8 quantization, scale max(absmax, 1e-8) / 127 and q =
// clip(rint(v / scale), -127, 127), the quotient the IEEE division's
// (int8_tile.cuh quant_rcp, in B2, B3 and B8 alike); every epilogue
// step rounded on its own (no contraction), tanh GELU, f32 LayerNorm
// statistics (int8_tile.cuh's helpers, which the plain version repeats).
// Bound on an H100: operations, 2*M*D*(D + 2F) at 1,979 TOP/s: 19.5 us at
// the banking chunk (M 8,192, D 512, F 2,048), 78.1 at the hallucination
// chunk (M 32,768), 22.0 at bert-base (M 4,096, D 768, F 3,072).
//
// B8's design, per tile of 64 rows (one wgmma M), a persistent block an SM
// over the tiles, a producer warp and four consumer warpgroups (640
// threads: ptxas gives each 96 registers):
// - Columns split between the four consumer warpgroups: each product runs
//   in chunks of 64 output columns, warpgroup g taking chunks 4p + g, so a
//   chunk is 32 s32 accumulators a thread and the epilogues (the LayerNorm
//   passes, the GELU, the quantizations) run on 16 warps, four a
//   scheduler, which hide each other's latencies.  Row sums and maxima
//   over a whole width are the quad's, then the four warpgroups' in order
//   through shared memory (one named barrier an exchange).
// - The weights' K-contiguous [N, K] copies (ops/ffn_int8.py k_contiguous)
//   are read by 2-D TMA in boxes of 64 rows x 128 bytes of K, 128-byte
//   swizzle, into a ring of STAGES slots; slot i belongs to warpgroup i % 4
//   and holds one box of its chunk, so the warpgroups drift apart and one's
//   epilogue overlaps the others' products.
// - The A operands q(ctx) and q(h) [64, D] are quantized by the consumer
//   threads straight into shared memory in the exact layout the descriptor
//   names (K slabs of 128 bytes, 8-row atoms of 1024 bytes, 16-byte chunk c
//   of row r at c ^ (r % 8)), then a proxy fence and a barrier before the
//   first wgmma reads them.
// - q(f) is never whole in shared memory: the W1 product's epilogue keeps
//   each row's |GELU| maximum over F and stores every f32 GELU value to a
//   device scratch (the product and the GELU run once); a second pass reads
//   the same values back, quantizes them and stores q(f) to the scratch;
//   the W2 product reads q(f) back by TMA (a proxy fence for global memory
//   orders the stores before the loads) into a ring over the A operand's
//   space, which q(h) no longer needs, each box read by all four
//   warpgroups.  So the W2 product's [64, D] sums are needed one chunk at a
//   time and the layout fits bert-large's D 1,024 / F 4,096 as well as the
//   zoo's.
// - LayerNorm rows: each product's pre-LayerNorm values go to an f32 device
//   scratch, read back by the same thread for the variance and the
//   normalisation (h stays there as LN2's residual), so no row is held in
//   registers across a whole width.  Every epilogue pass loads all of a
//   chunk's values before it stores any, so its loads are in flight
//   together.
// The scratch (hs) has a slot for each block of the persistent grid,
// reused tile after tile: f32 [64, D] rows (y, h), f32 [64, F] GELU values,
// int8 [64, F] q(f), each array's slots after one another:
// scratch_bytes().  B3 runs its function without these f32 round trips on a
// kernel of its own (ffn_block_int8.cu).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "int8_tile.cuh"

namespace ac_i8h {

using namespace ac_hopper;
using ac_int8::dequant;
using ac_int8::gelu_tanh;
using ac_int8::load2;
using ac_int8::quad_max;
using ac_int8::quad_sum;
using ac_int8::quant_rcp;
using ac_int8::row_scale;
using ac_int8::store2;
using ac_int8::warp_max;

constexpr int ROWS = 64;                   // rows a tile (wgmma M)
constexpr int BN = 64;                     // output columns a warpgroup's chunk
constexpr int KB = 128;                    // bytes of K a box (one swizzle atom)
// rows of every box bytes_map's tensor maps deliver: a weight box's output
// columns (B2's, B3's and B8's chunks of 64), a q(f) box's rows
constexpr int BOX_ROWS = 64;
static_assert(BOX_ROWS == BN && BOX_ROWS == ROWS, "a box is a chunk's columns, a tile's rows");
constexpr int NC = 4;                      // consumer warpgroups
constexpr int CT = 128 * NC;               // consumer threads
constexpr int THREADS = CT + 128;          // + the producer warpgroup
// registers a thread: ptxas allocates every thread within 65,536 / 640 (96)
// at launch; setmaxnreg moves the producer warpgroup's spare ones to the
// consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 112;
constexpr int XBAR = 1;                    // named barrier of the consumer threads
constexpr int STAGES = 16;                 // weight slots, four a warpgroup
constexpr int BOX = BOX_ROWS * KB;         // bytes of a box: 64 rows x 128 bytes
constexpr int MAX_D = 1024;
constexpr int MAX_A = MAX_D / KB;          // q(f) slots (the A operand's slabs)

// The A operand's space at width D: D columns, and at least 256, so that
// q(f)'s ring over it has at least two slots.  A consumer releases a q(f)
// box only once the next one has landed (one box's products stay in
// flight while the next is awaited), so a ring of one slot (D 128) would
// never refill.  The host passes it as Params::da, so the kernel's layout
// arithmetic is a plain division (a select on D in the kernel made B8
// ~10% slower on an H100).
inline int a_width(int D) {
  return D > 2 * KB ? D : 2 * KB;
}

// Shared memory from the first 1024-byte boundary, at A width da
// (a_width(D)): the A operand [da / 128 slabs][64 rows][128 bytes] (in the
// W2 product a ring of da / 128 q(f) boxes), the weight ring, q(ctx)'s row
// scales [64], the exchange [2 buffers][NC][64], the barriers
// full[STAGES], empty[STAGES], afull[MAX_A], aempty[MAX_A] and q(f)'s
// ready barrier.
struct Layout {
  int abuf, ring, cs, red, bar, total;
  __host__ __device__ explicit Layout(int da) {
    abuf = 0;
    ring = abuf + ROWS * da;
    cs = ring + STAGES * BOX;
    red = cs + ROWS * 4;
    bar = red + 2 * NC * ROWS * 4;
    total = bar + 8 * (2 * STAGES + 2 * MAX_A + 1) + 1024;   // + alignment slack
  }
};
static_assert(BOX % 1024 == 0, "boxes start on 1024 bytes");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CT <= 96 * THREADS,
              "within the registers the block is given at launch");

struct Params {
  const void *in, *x;                      // ctx and x [M, D], ctx's type
  const float *so, *bo, *g1, *be1;         // O-projection, LayerNorm 1 [D]
  const float *s1, *b1;                    // [F]
  const float *s2, *b2, *g2, *be2;         // [D]
  float eps;
  float* hs;                               // f32 rows [grid * 64, D], a slot a block
  float* fv;                               // GELU values [grid * 64, F]
  int8_t* qf;                              // q(f) [grid * 64, F]
  void* out;
  int M, D, F, tiles;
  int da;                                  // the A operand's space: a_width(D)
  int bf16;
};

// blocks of a launch over M rows on a card of `sms` SMs: one an SM, persistent
inline int grid_for(int M, int sms) {
  const int tiles = (M + ROWS - 1) / ROWS;
  return tiles < sms ? tiles : sms;
}

// device scratch bytes of a launch over M rows on the current device
// (0 where the device cannot be read)
inline size_t scratch_bytes(int M, int D, int F) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return (size_t)grid_for(M, sms) * ROWS * ((size_t)D * 4 + (size_t)F * 5);
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

// d[32] (+)= A[64 x 32] . B[64 x 32]^T: s8 operands from shared memory,
// both K-major (descriptors a and b), s32 accumulators; scale_d 0
// overwrites d.  Thread t of the warpgroup holds, for j = 0..7, rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4j] (row, col), d[4j+1] (row, col+1), d[4j+2] (row+8, col),
// d[4j+3] (row+8, col+1).
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// d[16] (+)= A[64 x 32] . B[32 x 32]^T, as wgmma_m64n64k32_s8 over 32
// output columns (j = 0..3)
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// Tie the accumulators to this point (after their wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// order this thread's stores to device memory before later async-proxy
// (TMA) reads of them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// named barrier `id` over `count` threads, reached by a warp that may have
// diverged just before (a thread that waited on its bulk stores, a lane
// that wrote a shared value): bar.sync counts whole warps, so a diverged
// warp could be counted twice and release the barrier early
__device__ __forceinline__ void warps_bar_sync(int id, int count) {
  __syncwarp();
  named_bar_sync(id, count);
}

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

struct Smem {
  unsigned char* base;
  Layout l;
  int na;                                  // q(f) slots: da / 128
  __device__ Smem(unsigned char* raw, int da)
      : base(raw + (1024 - smem_addr(raw) % 1024) % 1024), l(da), na(da / KB) {}
  __device__ unsigned char* abuf() const { return base + l.abuf; }
  __device__ unsigned char* slot(int s) const { return base + l.ring + s * BOX; }
  __device__ float* cs() const { return reinterpret_cast<float*>(base + l.cs); }
  __device__ float* red(int k) const {
    return reinterpret_cast<float*>(base + l.red) + (k & 1) * NC * ROWS;
  }
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(base + l.bar); }
  __device__ uint64_t* empty() const { return full() + STAGES; }
  __device__ uint64_t* afull() const { return full() + 2 * STAGES; }
  __device__ uint64_t* aempty() const { return afull() + MAX_A; }
  __device__ uint64_t* qf_ready() const { return aempty() + MAX_A; }
};

// byte offset of element (r, c) of the A operand [64, D]: K slab c / 128,
// row r's 128 bytes, 16-byte chunk (c % 128) / 16 swizzled by r % 8
__device__ __forceinline__ int a_offset(int r, int c) {
  const int cc = c & 127;
  return (c >> 7) * BOX + r * KB + (((cc >> 4) ^ (r & 7)) << 4) + (cc & 15);
}

// Quantize rows [row0, row0 + 64) of src [M, W] (W % 128 == 0; rows past M
// as zeros) into the A operand at abuf (a_offset's layout) and their scales
// into cs: the quantization of a tile's rows that B2, B3 and B8 share.  Of
// the NT threads calling it, thread t (warp t / 32) takes rows t / 32,
// t / 32 + NT / 32, ...; lane l loads 16 bytes of a row at a time, columns
// E k + V l (V = 16 / sizeof(T), E = 32 V), every load of 1,024 columns in
// flight together for the row's absolute maximum, then the same again from
// L1 to be quantized.  MUL: the scale absmax * (1/127) (B2's plain
// version), else absmax / 127 (B3's and B8's).
template <int NT, bool MUL, typename T>
__device__ __forceinline__ void quant_rows(const T* src, int M, int W, int row0, int t,
                                           unsigned char* abuf, float* cs) {
  constexpr int V = 16 / sizeof(T), E = 32 * V, STEP = 1024, LOADS = STEP / E;
  const int lane = t & 31;
  auto load = [&](int gr, int c, float (&v)[V]) {
    const uint4 u = gr < M && c < W
        ? *reinterpret_cast<const uint4*>(src + (size_t)gr * W + c) : make_uint4(0, 0, 0, 0);
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(words[i]);
      } else {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  };
  for (int r = t >> 5; r < ROWS; r += NT / 32) {
    const int gr = row0 + r;
    float amax = 0.f;
    for (int c0 = 0; c0 < W; c0 += STEP) {
      #pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        float v[V];
        load(gr, c0 + E * k + V * lane, v);
        #pragma unroll
        for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
      }
    }
    const float s = row_scale<MUL>(warp_max(amax)), rs = __frcp_rn(s);
    for (int c0 = 0; c0 < W; c0 += STEP) {
      #pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int c = c0 + E * k + V * lane;
        if (c >= W) continue;
        float v[V];
        load(gr, c, v);                        // again, from L1
        #pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<uint32_t*>(abuf + a_offset(r, c + i)) =
              ac_int8::pack4(quant_rcp(v[i], s, rs), quant_rcp(v[i + 1], s, rs),
                             quant_rcp(v[i + 2], s, rs), quant_rcp(v[i + 3], s, rs));
      }
    }
    if (lane == 0) cs[r] = s;
  }
}

// groups of NC chunks of 64 columns over N, warpgroup g taking chunk
// NC p + g of group p (a chunk past N is not loaded and its columns are not
// stored)
__host__ __device__ __forceinline__ int groups(int N) {
  return (N + NC * BN - 1) / (NC * BN);
}

// ---------------------------------------------------------------------------
// producer: one thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ void produce(const CUtensorMap* mwo, const CUtensorMap* mw1,
                                        const CUtensorMap* mw2, const CUtensorMap* mqf,
                                        const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw, p.da);
  uint32_t i = 0, ai = 0;                  // weight boxes and q(f) boxes so far
  int n = 0;                               // tiles so far
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++n) {
    (void)tile;
    // a product's boxes in the consumers' order: chunk groups, K slabs (with
    // the slab's q(f) box first in the W2 product), the warpgroups' chunks
    auto product = [&](const CUtensorMap* map, int N, int K, bool with_qf) {
      for (int pr = 0; pr < groups(N); ++pr)
        for (int k0 = 0; k0 < K; k0 += KB) {
          if (with_qf) {
            const int s = ai % sm.na;
            wait_phase(&sm.aempty()[s], ((ai / sm.na) & 1) ^ 1);
            mbar_arrive_expect_tx(&sm.afull()[s], BOX);
            tma_load_2d(sm.abuf() + s * BOX, mqf, &sm.afull()[s], k0, blockIdx.x * ROWS);
            ++ai;
          }
          for (int g = 0; g < NC; ++g, ++i) {
            const int s = i % STAGES, n0 = (NC * pr + g) * BN;
            wait_phase(&sm.empty()[s], ((i / STAGES) & 1) ^ 1);
            if (n0 >= N) {                 // no such chunk: nothing to load
              mbar_arrive(&sm.full()[s]);
              continue;
            }
            mbar_arrive_expect_tx(&sm.full()[s], BOX);
            tma_load_2d(sm.slot(s), map, &sm.full()[s], k0, n0);
          }
        }
    };
    product(mwo, p.D, p.D, false);
    product(mw1, p.F, p.D, false);         // f and the rows' |GELU| maxima
    wait_phase(sm.qf_ready(), n & 1);      // the tile's q(f) is stored, q(h) read
    product(mw2, p.D, p.F, true);
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

struct Consumer {
  const Params& p;
  const Smem& sm;
  int g, lane, r0;                         // warpgroup, lane, the thread's first row
  uint32_t j = 0, aj = 0;                  // weight and q(f) boxes consumed so far
  int x = 0;                               // exchanges so far (alternating buffers)

  __device__ Consumer(const Params& p_, const Smem& sm_)
      : p(p_), sm(sm_), g(threadIdx.x / 128), lane(threadIdx.x & 31),
        r0(16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2)) {}

  __device__ __forceinline__ void arrive(uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }

  // acc = A . B^T over K bytes, box by box: A the A operand's slabs, or
  // (QF) the ring of q(f) boxes.  One box's products stay in flight while
  // the next box is awaited.
  template <bool QF>
  __device__ __forceinline__ void product(int (&acc)[32], int K) {
    // box ks's products, committed; scale_d 0 on the first
    auto issue = [&](int ks) {
      const uint32_t i = NC * j + g, s = i % STAGES;
      wait_phase(&sm.full()[s], (i / STAGES) & 1);
      const unsigned char* a = sm.abuf() + ks * BOX;
      if (QF) {
        const uint32_t as = aj % sm.na;
        wait_phase(&sm.afull()[as], (aj / sm.na) & 1);
        a = sm.abuf() + as * BOX;
      }
      const uint64_t da = sw128_desc(a), db = sw128_desc(sm.slot(s));
      wgmma_fence();
      #pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)
        wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      ++j;
      if (QF) ++aj;
      return s;
    };
    auto release = [&](uint32_t s) {
      arrive(&sm.empty()[s]);
      if (QF) arrive(&sm.aempty()[(aj - 2) % sm.na]);
    };
    uint32_t prev = issue(0);
    for (int ks = 1; ks < K / KB; ++ks) {
      const uint32_t s = issue(ks);
      wgmma_wait<1>();                     // box prev's products are done
      release(prev);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    arrive(&sm.empty()[prev]);
    if (QF) arrive(&sm.aempty()[(aj - 1) % sm.na]);
  }

  // a chunk past N: its boxes are consumed without a product
  template <bool QF>
  __device__ __forceinline__ void skip(int K) {
    for (int ks = 0; ks < K / KB; ++ks, ++j) {
      const uint32_t i = NC * j + g, s = i % STAGES;
      wait_phase(&sm.full()[s], (i / STAGES) & 1);
      arrive(&sm.empty()[s]);
      if (QF) {
        const uint32_t as = aj % sm.na;
        wait_phase(&sm.afull()[as], (aj / sm.na) & 1);
        arrive(&sm.aempty()[as]);
        ++aj;
      }
    }
  }

  // a product over N output columns and K bytes, chunk by chunk, each
  // chunk's accumulators handed to epi(n0, acc)
  template <bool QF, typename Epi>
  __device__ __forceinline__ void run(int N, int K, Epi epi) {
    for (int pr = 0; pr < groups(N); ++pr) {
      const int n0 = (NC * pr + g) * BN;
      if (n0 >= N) {
        skip<QF>(K);
        continue;
      }
      int acc[32];
      product<QF>(acc, K);
      epi(n0, acc);
    }
  }

  // f(n0) for each of this warpgroup's chunks of N that exist
  template <typename Fn>
  __device__ __forceinline__ void chunks(int N, Fn fn) {
    for (int pr = 0; pr < groups(N); ++pr) {
      const int n0 = (NC * pr + g) * BN;
      if (n0 < N) fn(n0);
    }
  }

  // fn(h, r, c, e) over the thread's elements of a chunk at n0: row r0 + 8h,
  // columns c and c + 1, accumulators e and e + 1
  template <typename Fn>
  __device__ __forceinline__ void each(int n0, Fn fn) {
    #pragma unroll
    for (int h = 0; h < 2; ++h)
      #pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
        fn(h, r0 + 8 * h, n0 + 8 * jj + 2 * (lane & 3), 4 * jj + 2 * h);
  }

  // ld(h, r, c) for the element pairs of the chunk first, then
  // fn(h, r, c, e, v) on each, so the loads are in flight together before
  // any store: all 16 (WHOLE, where no accumulators are live), else a row's
  // 8 at a time
  template <bool WHOLE = false, typename Ld, typename Fn>
  __device__ __forceinline__ void gather(int n0, Ld ld, Fn fn) {
    constexpr int ROWS_AT_ONCE = WHOLE ? 2 : 1;
    #pragma unroll
    for (int h0 = 0; h0 < 2; h0 += ROWS_AT_ONCE) {
      float2 v[ROWS_AT_ONCE][BN / 8];
      #pragma unroll
      for (int i = 0; i < ROWS_AT_ONCE; ++i)
        #pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
          v[i][jj] = ld(h0 + i, r0 + 8 * (h0 + i), n0 + 8 * jj + 2 * (lane & 3));
      #pragma unroll
      for (int i = 0; i < ROWS_AT_ONCE; ++i)
        #pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
          fn(h0 + i, r0 + 8 * (h0 + i), n0 + 8 * jj + 2 * (lane & 3), 4 * jj + 2 * (h0 + i),
             v[i][jj]);
    }
  }

  // the rows' totals of v (the thread's parts of rows r0, r0 + 8): the
  // quad's, then the warpgroups' in order through one exchange buffer
  template <bool MAX>
  __device__ __forceinline__ void exchange(float (&v)[2]) {
    float* red = sm.red(x++);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float q = MAX ? quad_max(v[h]) : quad_sum(v[h]);
      if ((lane & 3) == 0) red[g * ROWS + r0 + 8 * h] = q;
    }
    named_bar_sync(XBAR, CT);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = red[r0 + 8 * h];
      #pragma unroll
      for (int w = 1; w < NC; ++w)
        t = MAX ? fmaxf(t, red[w * ROWS + r0 + 8 * h]) : t + red[w * ROWS + r0 + 8 * h];
      v[h] = t;
    }
  }

  // the A operand's writes before the wgmmas that read them
  __device__ __forceinline__ void publish_a() {
    fence_proxy_async();
    named_bar_sync(XBAR, CT);
  }

  // an f32 pair of the tile's rows in hs
  __device__ __forceinline__ float2* at(float* hrow, int r, int c) const {
    return reinterpret_cast<float2*>(hrow + (size_t)r * p.D + c);
  }

  // mean and 1 / sqrt(var + eps) of the f32 rows of hs this thread wrote
  // (every column of its chunks of D): the rows' sums, then the sums of
  // squared deviations from the mean
  __device__ __forceinline__ void ln_stats(float* hrow, float (&mean)[2], float (&inv)[2]) {
    auto ld = [&](int, int r, int c) { return __ldcg(at(hrow, r, c)); };
    float v[2] = {0.f, 0.f};
    chunks(p.D, [&](int n0) {
      gather<true>(n0, ld, [&](int h, int, int, int, float2 y) {
        v[h] = __fadd_rn(v[h], __fadd_rn(y.x, y.y));
      });
    });
    exchange<false>(v);
    #pragma unroll
    for (int h = 0; h < 2; ++h) mean[h] = __fdiv_rn(v[h], (float)p.D);
    v[0] = v[1] = 0.f;
    chunks(p.D, [&](int n0) {
      gather<true>(n0, ld, [&](int h, int, int, int, float2 y) {
        const float d0 = __fsub_rn(y.x, mean[h]), d1 = __fsub_rn(y.y, mean[h]);
        v[h] = __fadd_rn(v[h], __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
      });
    });
    exchange<false>(v);
    #pragma unroll
    for (int h = 0; h < 2; ++h)
      inv[h] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(v[h], (float)p.D), p.eps)));
  }
};

// LayerNorm of y with the row's statistics, each step rounded on its own
__device__ __forceinline__ float ln(float y, float mean, float inv, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, mean), inv), g), b);
}

__device__ __forceinline__ void consume(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw, p.da);
  Consumer cn(p, sm);
  const int D = p.D, F = p.F;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    // the block's scratch slot
    float* hrow = p.hs + (size_t)blockIdx.x * ROWS * D;     // y, then h, then y2
    float* frow = p.fv + (size_t)blockIdx.x * ROWS * F;     // the GELU values
    int8_t* qrow = p.qf + (size_t)blockIdx.x * ROWS * F;    // q(f)
    // h at (r, c), c + 1: LN1's rows in hs
    auto h_at = [&](int, int r, int c) { return __ldcg(cn.at(hrow, r, c)); };
    float hsc[2], hrc[2];                              // q(h)'s row scales, reciprocals

    if (p.bf16)
      quant_rows<CT, false>(static_cast<const __nv_bfloat16*>(p.in), p.M, D, row0, threadIdx.x,
                            sm.abuf(), sm.cs());
    else
      quant_rows<CT, false>(static_cast<const float*>(p.in), p.M, D, row0, threadIdx.x,
                            sm.abuf(), sm.cs());
    cn.publish_a();
    {
      // y = q(ctx) @ Wo * s_c * so + bo + x into hs
      cn.run<false>(D, D, [&](int n0, int (&acc)[32]) {
        cn.gather(n0, [&](int, int r, int c) {
          return row0 + r < p.M ? load2(p.x, p.bf16, (size_t)(row0 + r) * D + c)
                                : make_float2(0.f, 0.f);
        }, [&](int, int r, int c, int e, float2 xv) {
          const float cs = sm.cs()[r];
          const float y0 = __fadd_rn(dequant(acc[e], cs, p.so[c], p.bo[c]), xv.x);
          const float y1 = __fadd_rn(dequant(acc[e + 1], cs, p.so[c + 1], p.bo[c + 1]), xv.y);
          __stcg(cn.at(hrow, r, c), make_float2(y0, y1));
        });
      });
      // h = LN1(y) over y in hs, and the rows' |h| maxima
      float mean[2], inv[2];
      cn.ln_stats(hrow, mean, inv);
      float mx[2] = {0.f, 0.f};
      cn.chunks(D, [&](int n0) {
        cn.gather<true>(n0, h_at, [&](int h, int r, int c, int, float2 y) {
          const float h0 = ln(y.x, mean[h], inv[h], p.g1[c], p.be1[c]);
          const float h1 = ln(y.y, mean[h], inv[h], p.g1[c + 1], p.be1[c + 1]);
          mx[h] = fmaxf(mx[h], fmaxf(fabsf(h0), fabsf(h1)));
          __stcg(cn.at(hrow, r, c), make_float2(h0, h1));
        });
      });
      cn.exchange<true>(mx);
      #pragma unroll
      for (int h = 0; h < 2; ++h) hsc[h] = row_scale<false>(mx[h]), hrc[h] = __frcp_rn(hsc[h]);
      // q(h) over q(ctx) (whose products are done: every thread has passed
      // the exchanges since)
      unsigned char* abuf = sm.abuf();
      cn.chunks(D, [&](int n0) {
        cn.gather<true>(n0, h_at, [&](int h, int r, int c, int, float2 hv) {
          *reinterpret_cast<uint16_t*>(abuf + a_offset(r, c)) =
              (uint16_t)((quant_rcp(hv.x, hsc[h], hrc[h]) & 0xff) |
                         ((quant_rcp(hv.y, hsc[h], hrc[h]) & 0xff) << 8));
        });
      });
      cn.publish_a();
    }

    // f at accumulator a of row r0 + 8h, column c
    auto gelu_at = [&](int a, int h, int c) {
      return gelu_tanh(dequant(a, hsc[h], p.s1[c], p.b1[c]));
    };
    // f into the scratch, and each row's max |f|
    float fsc[2] = {0.f, 0.f};
    cn.run<false>(F, D, [&](int n0, int (&acc)[32]) {
      float2 f[2][BN / 8];
      cn.each(n0, [&](int h, int, int c, int e) {
        f[h][e >> 2] = make_float2(gelu_at(acc[e], h, c), gelu_at(acc[e + 1], h, c + 1));
        fsc[h] = fmaxf(fsc[h], fmaxf(fabsf(f[h][e >> 2].x), fabsf(f[h][e >> 2].y)));
      });
      cn.each(n0, [&](int h, int r, int c, int e) {
        __stcg(reinterpret_cast<float2*>(frow + (size_t)r * F + c), f[h][e >> 2]);
      });
    });
    cn.exchange<true>(fsc);
    float frc[2];
    #pragma unroll
    for (int h = 0; h < 2; ++h) fsc[h] = row_scale<false>(fsc[h]), frc[h] = __frcp_rn(fsc[h]);
    // the same values read back by the threads that wrote them, quantized,
    // and stored to the slot's q(f) rows
    cn.chunks(F, [&](int n0) {
      cn.gather<true>(n0, [&](int, int r, int c) {
        return __ldcg(reinterpret_cast<const float2*>(frow + (size_t)r * F + c));
      }, [&](int h, int r, int c, int, float2 v) {
        *reinterpret_cast<uint16_t*>(qrow + (size_t)r * F + c) =
            (uint16_t)((quant_rcp(v.x, fsc[h], frc[h]) & 0xff) |
                       ((quant_rcp(v.y, fsc[h], frc[h]) & 0xff) << 8));
      });
    });
    // q(f) stored before the producer's TMA reads it, and q(h)'s products
    // done before q(f) boxes land over it
    fence_proxy_async_global();
    named_bar_sync(XBAR, CT);
    if (threadIdx.x == 0) mbar_arrive(sm.qf_ready());

    // y = q(f) @ W2 * s_f * s2 + b2 + h into hs, then LN2
    cn.run<true>(D, F, [&](int n0, int (&acc)[32]) {
      cn.gather(n0, h_at, [&](int h, int r, int c, int e, float2 hv) {
        const float y0 = __fadd_rn(dequant(acc[e], fsc[h], p.s2[c], p.b2[c]), hv.x);
        const float y1 = __fadd_rn(dequant(acc[e + 1], fsc[h], p.s2[c + 1], p.b2[c + 1]), hv.y);
        __stcg(cn.at(hrow, r, c), make_float2(y0, y1));
      });
    });
    float mean[2], inv[2];
    cn.ln_stats(hrow, mean, inv);
    cn.chunks(D, [&](int n0) {
      cn.gather<true>(n0, [&](int, int r, int c) { return __ldcg(cn.at(hrow, r, c)); },
                [&](int h, int r, int c, int, float2 y) {
        if (row0 + r >= p.M) return;
        store2(p.out, p.bf16, (size_t)(row0 + r) * D + c,
               ln(y.x, mean[h], inv[h], p.g2[c], p.be2[c]),
               ln(y.y, mean[h], inv[h], p.g2[c + 1], p.be2[c + 1]));
      });
    });
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ffn_wg_kernel(const __grid_constant__ CUtensorMap mwo, const __grid_constant__ CUtensorMap mw1,
              const __grid_constant__ CUtensorMap mw2, const __grid_constant__ CUtensorMap mqf,
              const Params p) {
  extern __shared__ unsigned char smem_raw[];
  if (threadIdx.x == 0) {
    const Smem sm(smem_raw, p.da);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sm.full()[i], 1);
      mbar_init(&sm.empty()[i], 4);        // the owning warpgroup's warps
    }
    for (int i = 0; i < MAX_A; ++i) {
      mbar_init(&sm.afull()[i], 1);
      mbar_init(&sm.aempty()[i], CT / 32); // every consumer warp
    }
    mbar_init(sm.qf_ready(), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= CT) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CT) produce(&mwo, &mw1, &mw2, &mqf, p);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume(p);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *in, *x;
  const int8_t *wot, *w1t, *w2t;           // K-contiguous [N, K] copies
  const float *so, *bo, *g1, *be1, *s1, *b1, *s2, *b2, *g2, *be2;
  float eps;
  void* hs;                                // scratch_bytes(M, D, F)
  void* out;
  int M, D, F;
  bool bf16;
  cudaStream_t stream;
  int* info;                               // set: report the instantiation
};

// a 2-D map over an int8 [rows, cols] row-major array, boxes of BOX_ROWS
// rows x 128 bytes (BOX bytes, what each box's expect_tx waits for),
// 128-byte swizzle, zeros outside
inline cudaError_t bytes_map(CUtensorMap* map, const void* ptr, long long rows, int cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {KB, BOX_ROWS};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// info[9]: registers, shared bytes, threads, blocks per SM, spill bytes (as
// ac_common::kernel_info), rows a tile, consumer warpgroups, blocks a tile
// (1: no cluster), blocks of the launch over M rows.  The caller checks the
// envelope: D % 128 == 0, F % 128 == 0, D <= MAX_D; every array starts on
// 16 bytes.
inline cudaError_t launch(const Args& a) {
  auto* kernel = ffn_wg_kernel;
  const int smem = Layout(a_width(a.D)).total;
  if (a.info) {
    cudaError_t err = ac_common::kernel_info(kernel, smem, THREADS, a.info);
    int device = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    a.info[5] = ROWS;
    a.info[6] = NC;
    a.info[7] = 1;
    a.info[8] = grid_for(a.M, sms);
    return err;
  }
  // vector loads of the rows and TMA boxes of the weights and the scratch
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  if (!aligned(a.in) || !aligned(a.out) || !aligned(a.hs) || !aligned(a.w1t) || !aligned(a.w2t)
      || !aligned(a.x) || !aligned(a.wot))
    return cudaErrorInvalidValue;
  // once a device: its SMs; the kernel's cap on dynamic shared memory
  // raised to what a block may take there (launches differ in D's share);
  // and the registers the block is given at launch checked, which
  // setmaxnreg hands from the producer to the consumers
  static PerDevice<int> plans;
  int sms = 0;
  cudaError_t err = plans.get(&sms, [&](int device, int* out) {
    cudaFuncAttributes at;
    int optin = 0;
    cudaError_t e = cudaFuncGetAttributes(&at, kernel);
    if (e == cudaSuccess && at.numRegs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * CT)
      e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return e;
  });
  if (err != cudaSuccess) return err;
  Params p;
  p.in = a.in, p.x = a.x;
  p.so = a.so, p.bo = a.bo, p.g1 = a.g1, p.be1 = a.be1;
  p.s1 = a.s1, p.b1 = a.b1, p.s2 = a.s2, p.b2 = a.b2, p.g2 = a.g2, p.be2 = a.be2;
  p.eps = a.eps;
  p.M = a.M, p.D = a.D, p.F = a.F;
  p.tiles = (a.M + ROWS - 1) / ROWS;
  p.da = a_width(a.D);
  const int grid = grid_for(a.M, sms);
  p.hs = static_cast<float*>(a.hs);
  p.fv = p.hs + (size_t)grid * ROWS * a.D;
  p.qf = reinterpret_cast<int8_t*>(p.fv + (size_t)grid * ROWS * a.F);
  p.out = a.out;
  p.bf16 = a.bf16;
  CUtensorMap maps[4] = {};
  err = bytes_map(&maps[0], a.wot, a.D, a.D);
  if (err == cudaSuccess) err = bytes_map(&maps[1], a.w1t, a.F, a.D);
  if (err == cudaSuccess) err = bytes_map(&maps[2], a.w2t, a.D, a.F);
  if (err == cudaSuccess) err = bytes_map(&maps[3], p.qf, (long long)grid * ROWS, a.F);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, a.stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace ac_i8h
