// The bf16 attention of kernels B1 (attention_qkv.cu), B6 and B7
// (flash_attention.cu) on Hopper's asynchronous path: TMA loads on
// mbarriers, warpgroup products (wgmma) and, for B1 and B7, the exact row
// softmax, with Q K^T computed once per (batch row, head, query tile) up to
// S 512; for B6 the online recurrence (the FLASH form, below).
//
// Function (B1, B7): out[b, s, h] = softmax(q k^T / sqrt(Dh) + bias) v
// per head, bias an ADDITIVE -1e9 on keys whose mask is 0, in the TPU
// kernels' order of rounding: each row's exact max m and sum l first, then
// p = exp(s - m) / max(l, 1e-30) rounded to bf16, then P V with f32 sums.
// B6 computes the same function in its TPU kernel's order: per 64-key tile
// the running max, p = exp(s - m) rounded to bf16 for P V, the rescaled f32
// sums, and the division at the end.
// Keys past S do not exist: a tile pads them in, and their scores become
// -inf by their index (p = 0), so a fully masked row is the uniform average
// of V over exactly S keys.  Queries are not masked.  q, k and v are
// [B, S, H, Dh] with strides (sb, ss, sh, 1) in elements (B1 passes its
// packed [B, S, 3D] rows: q, k, v at column offsets 0, D, 2D); out is
// [B, S, H * Dh] contiguous.
//
// Block: a producer warpgroup and two consumer warpgroups (384 threads, one
// block an SM), persistent over work units: one or more query tiles of a
// (batch row, head).
//  - Producer (setmaxnreg 40; one warp of it loads, the others exit): for
//    each query tile it loads the Q tile into one of two Q buffers, and the
//    unit's K and V tiles (64 keys each) into a ring of slots (16 at
//    Dh <= 64, 8 at Dh 128), each slot guarded by a full and an empty
//    mbarrier, so the next tiles land while this one's softmax and P V
//    run.  Where a unit's K and V fit in the ring (RESIDENT: every one-pass
//    form at Dh 64) they are loaded once for all its query tiles; the units
//    are as long as leaves every SM one or more (bert-base: all 8 query
//    tiles of a (b, h)).  Loads go by TMA through rank-4 tensor maps over
//    [B, S, H, Dh] (dims Dh, H, S, B; boxes of 64 columns, one head, 64 or
//    128 rows, one batch row; 128-byte swizzle): a box clips at its own
//    batch row's S and at Dh and fills with zeros, so no load reads another
//    batch row or head, and Dh is zero-padded to DHP (64 or 128) for free.
//    Rows that TMA cannot take (an odd base, a stride or Dh that is no
//    multiple of 16 bytes) are staged by the same warp element by element
//    into the same swizzled layout.  With each K tile the warp also writes
//    the tile's 64 key biases (times log2 e) beside its slot.
//  - Consumers (setmaxnreg 232; ptxas allocates them within the block's
//    168 registers all the same): Q K^T as wgmma m64n64k16 per key tile, Q
//    and K both K-major from the swizzled shared tiles (a 16-column step is
//    32 bytes inside a 128-byte atom, two atoms at Dh 128).  The scores stay
//    in the accumulators' registers; the softmax runs on them (a row lies
//    in the four lanes of a quad); p, normalized and rounded to bf16, is
//    re-read from the same registers as the A fragments of P V (wgmma
//    m64nDHPk16, A from registers), and V, whose head columns are
//    contiguous, is the MN-major B operand (the transpose bit).  Outputs go
//    straight from the accumulators to device memory.
//
// B1's and B7's three forms, by the row length S (the key tiles NT =
// ceil(S / 64); rows of at most 64 keys run one_tile_rows of
// attention_tile.cuh instead):
//  - ROWS, NT <= 4 (S <= 256): each consumer warpgroup owns 64 of the
//    query tile's 128 queries and every key: its [64, S] scores live in
//    registers (S / 2 a thread, 128 at S 256).  At S 128 a query tile is a
//    whole (batch row, head): K and V are read once for it.
//  - SPLIT, NT <= 8 (S <= 512): both warpgroups own the query tile's 64
//    queries and split its keys in halves of up to 4 tiles.  Each takes
//    its half's row max, they exchange maxima through shared memory, then
//    the halves' sums (added in the same order by both: l = l0 + l1), and
//    each multiplies its own normalized p by its own V tiles; warpgroup 1
//    hands its partial P V to warpgroup 0, which adds it (o = o0 + o1) and
//    stores.  K is read and multiplied once.
//  - TWO_PASS, S > 512 (B7 to 2,048; B1 only when a caller forces it): each
//    warpgroup owns 64 of 128 queries; pass 1 streams K for the running max
//    and the rescaled sum, pass 2 streams K and V, recomputes the scores and
//    forms p = 2^(s - m) / max(l, 1e-30).  l then may differ from the plain
//    version's sum in its last bits.
// B6's FLASH form (any S above 64): each warpgroup owns 64 of a 128-query
//   tile and walks the key tiles in order with the online recurrence, one
//   tile's [64, 64] scores in registers; Q K^T of tile t is issued with P V
//   of tile t - 1 and awaited alone, so tile t's exps overlap that P V.  K
//   and V (interleaved in the ring) stay for all of a (b, h)'s query tiles
//   where 2 NT tiles fit the ring (Params::resident), else stream per
//   query tile.
// What bounds them (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the two
// warpgroups of the SPLIT form meet at their exchanges, so their products
// and their exps (the 16 a clock an SM of ex2) run one after the other;
// with more than 168 registers a thread the products of one tile could
// overlap the softmax of another, but 9 or more warps a block cap a thread
// there (3 warps on one of the 4 schedulers' 16,384 registers).  The FLASH
// form holds one tile's scores (32 registers) and needs no exchange; its
// exps are the wall at bert-base (16 ex2 a clock an SM; 0.027 ms of them
// against 0.0261 ms of products and 0.0301 of bytes).  Issuing the two
// warpgroups' products in strict turns (FlashAttention-3's ping-pong) measured
// slower (0.104 -> 0.140 ms at bert-base; PERF.md §6).
// exp(s - m) is taken as 2^(s' - m') on scores s' = s log2(e) (log2 e
// folded into the scale and the biases), so a row whose keys are all
// masked (every s' the same -1.4e9) gets p = 1 exactly.  No atomics and a
// fixed order of sums: two launches give the same bits.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace ac_wg {

using bf16 = __nv_bfloat16;
using ac_attn::exp2_approx;
using ac_attn::LOG2E;
using ac_attn::MASK_BIAS;
using ac_attn::pack_bf16;
using ac_attn::quad_max;
using ac_attn::quad_sum;
using namespace ac_hopper;

enum Form { ROWS = 1, SPLIT = 2, TWO_PASS = 3, FLASH = 4 };

constexpr int TK = 64;                     // keys a tile
constexpr int NC = 2;                      // consumer warpgroups
constexpr int CT = 128 * NC;               // consumer threads
constexpr int THREADS = CT + 128;          // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int XBAR = 1;                    // named barrier of the consumer threads
constexpr int FULL_ARRIVALS = 33;          // the loading warp + lane 0's expect_tx
constexpr int Q_READERS = CT / 32;         // warps that read a Q buffer
constexpr int ROWS_MAX_NT = 4;             // longest ROWS form: S 256
constexpr int SPLIT_MAX_NT = 8;            // longest one-pass row: S 512

// Geometry of one instantiation: DHP the padded head width (64 or 128),
// FORM, NTW key tiles a warpgroup holds in registers (ROWS and SPLIT; 1
// for TWO_PASS and FLASH, which hold one).
template <int DHP_, int FORM_, int NTW_>
struct Geo {
  static constexpr int DHP = DHP_, FORM = FORM_, NTW = NTW_;
  static constexpr int QROWS = FORM == SPLIT ? 64 : 128;   // queries a query tile
  static constexpr int TILE = TK * DHP * 2;                // bytes of a K or V tile
  static constexpr int QTILE = QROWS * DHP * 2;
  static constexpr int STAGES = DHP == 64 ? 16 : 8;
  static constexpr int NACC = DHP / 2;                     // P V accumulators a thread
  static constexpr int TILE_READERS = FORM == SPLIT ? 4 : 8;   // warps that read a tile
  // K and V tiles of a query tile (one pass), and whether they stay in the
  // ring for all the query tiles of a work unit (FLASH: by the row length,
  // Params::resident)
  static constexpr int KV_TILES = 2 * (FORM == SPLIT ? 2 * NTW : NTW);
  static constexpr bool RESIDENT = (FORM == ROWS || FORM == SPLIT) && KV_TILES <= STAGES;
  // from the first 1024-byte boundary: Q buffers, ring, key biases, the
  // SPLIT form's exchange (partial P V, row maxima, row sums), barriers
  static constexpr int OFF_RING = 2 * QTILE;
  static constexpr int OFF_BIAS = OFF_RING + STAGES * TILE;
  static constexpr int OFF_X = OFF_BIAS + STAGES * TK * 4;
  static constexpr int X_FLOATS = FORM == SPLIT ? 128 * NACC + 2 * NC * 128 * 2 : 0;
  static constexpr int OFF_BAR = OFF_X + 4 * X_FLOATS;
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 2 * STAGES) + 1024;   // + alignment slack
  static_assert(DHP == 64 || DHP == 128, "one or two 128-byte swizzle atoms a row");
  static_assert(QTILE % 1024 == 0 && TILE % 1024 == 0, "tiles start on 1024 bytes");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CT <= 65536, "register budget");
};

struct Params {
  const bf16 *q, *k, *v;       // element staging reads these
  const int* mask;
  bf16* out;
  int B, S, H, Dh;
  long long sb, ss, sh;
  float scale2;                // log2(e) / sqrt(Dh)
  int nq, nt;                  // query tiles a (b, h), key tiles
  int qpu, nqu, units;         // query tiles a work unit, units a (b, h), units
  int tma;                     // rows go by TMA (else element by element)
  int pairs;                   // outputs stored two at a time (Dh even)
  int resident;                // K and V stay in the ring for a unit's query tiles
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// one arrival of the warp (its lane 0, after every lane's reads)
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Tie the A fragments of P V to this point (after its wait_group): wgmma
// reads them asynchronously, so they must stay live until it is done.
template <int NT>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[NT][4][4]) {
  #pragma unroll
  for (int t = 0; t < NT; ++t)
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      #pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[t][kk][j]) :: "memory");
}

// Descriptor of an MN-major operand in the 128-byte swizzle: rows of 64
// bf16 along N (one atom), K running down the rows.  Stride byte offset
// 1024 (the next 8 rows of K), leading byte offset `atom_bytes` (the next
// 64 columns of N: the tile's second atom at Dh 128).  A step of 16 rows
// of K is 2048 bytes: 128 in the descriptor's units.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* tile, uint32_t atom_bytes) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3ffffu) >> 4) | ((uint64_t)(atom_bytes >> 4) << 16) | (64ull << 32)
         | (1ull << 62);
}

// d[32] (+)= A[64 x 16] . B[64 x 16]^T: bf16 operands from shared memory,
// both K-major (descriptors a and b), f32 accumulators; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// d[32] (+)= A[64 x 16] . B[16 x 64]: A bf16 from registers (a[4], the
// m16n8k16 A fragment of each warp's 16 rows), B bf16 from shared memory,
// MN-major (the transpose bit), f32 accumulators; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// d[64] (+)= A[64 x 16] . B[16 x 128]: A bf16 from registers (a[4], the
// m16n8k16 A fragment of each warp's 16 rows), B bf16 from shared memory,
// MN-major (the transpose bit), f32 accumulators; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}


// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

template <class G>
struct Smem {
  unsigned char* base;         // the first 1024-byte boundary
  __device__ explicit Smem(unsigned char* raw)
      : base(raw + (1024 - smem_addr(raw) % 1024) % 1024) {}
  // a tile of R rows is DHP / 64 sub-tiles of R x 128 bytes (columns 64a..)
  __device__ unsigned char* q(int buf) const { return base + buf * G::QTILE; }
  __device__ unsigned char* tile(int slot) const {
    return base + G::OFF_RING + slot * G::TILE;
  }
  __device__ float* bias(int slot) const {
    return reinterpret_cast<float*>(base + G::OFF_BIAS) + slot * TK;
  }
  __device__ float* x() const { return reinterpret_cast<float*>(base + G::OFF_X); }
  __device__ uint64_t* qfull() const {
    return reinterpret_cast<uint64_t*>(base + G::OFF_BAR);
  }
  __device__ uint64_t* qempty() const { return qfull() + 2; }
  __device__ uint64_t* full() const { return qfull() + 4; }
  __device__ uint64_t* empty() const { return full() + G::STAGES; }
};

// A work unit: query tiles qt0 .. qt0 + nqt - 1 of head h of batch row b
// (units of one (b, h) consecutive, then heads, then batch rows)
struct Unit {
  int b, h, qt0, nqt;
  __device__ Unit(int u, const Params& p)
      : b(u / p.nqu / p.H), h(u / p.nqu % p.H), qt0(u % p.nqu * p.qpu),
        nqt(min(p.qpu, p.nq - u % p.nqu * p.qpu)) {}
};

// ---------------------------------------------------------------------------
// producer
// ---------------------------------------------------------------------------

// Rows [r0, r0 + rows) of head h of batch row b into a tile at dst, with
// one arrival of lane 0 on bar: by TMA (lane 0; the bytes expected with
// the arrival), or element by element by the 32 lanes into the same
// swizzled layout (zeros past S and past Dh), then the proxy fence that
// orders these writes before wgmma reads them.
template <int DHP>
__device__ __forceinline__ void fill(unsigned char* dst, int rows, uint64_t* bar,
                                     const CUtensorMap* map, const bf16* src, int r0,
                                     const Unit& it, const Params& p) {
  const int lane = threadIdx.x & 31;
  if (p.tma) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, rows * DHP * 2);
      #pragma unroll
      for (int a = 0; a < DHP / 64; ++a)
        tma_load_4d(dst + a * rows * 128, map, bar, 64 * a, it.h, r0, it.b);
    }
    return;
  }
  src += (long long)it.b * p.sb + (long long)it.h * p.sh;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = lane; i < rows * DHP; i += 32) {
    const int r = i / DHP, c = i % DHP, s = r0 + r, a = c / 64, cc = c % 64;
    const bf16 x = s < p.S && c < p.Dh ? src[(long long)s * p.ss + c] : zero;
    *reinterpret_cast<bf16*>(dst + a * rows * 128 + r * 128
                             + ((((cc >> 3) ^ (r & 7)) << 4) | ((cc & 7) << 1))) = x;
  }
  fence_proxy_async();
  if (lane == 0) mbar_arrive(bar);
}

template <class G>
__device__ __forceinline__ void produce(const CUtensorMap* mq, const CUtensorMap* mk,
                                        const CUtensorMap* mv, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  const int lane = threadIdx.x & 31;
  uint32_t pos = 0;            // tiles loaded so far: slot pos % STAGES
  int n = 0;                   // query tiles so far: Q buffer n % 2
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit it(u, p);
    const int* mrow = p.mask + (long long)it.b * p.S;
    // tile t of K (with its key biases) or of V into the next slot
    auto tile = [&](const CUtensorMap* map, const bf16* src, int t, bool keys) {
      const int s = pos % G::STAGES;
      wait_phase(&sm.empty()[s], ((pos / G::STAGES) & 1) ^ 1);
      fill<G::DHP>(sm.tile(s), TK, &sm.full()[s], map, src, t * TK, it, p);
      if (keys) {
        for (int i = lane; i < TK; i += 32) {
          const int key = t * TK + i;
          sm.bias(s)[i] = key < p.S && mrow[key] <= 0 ? MASK_BIAS * LOG2E : 0.f;
        }
      }
      mbar_arrive(&sm.full()[s]);
      ++pos;
    };
    for (int j = 0; j < it.nqt; ++j, ++n) {
      const int qb = n & 1;
      wait_phase(&sm.qempty()[qb], ((n >> 1) & 1) ^ 1);
      const int q0 = (it.qt0 + j) * G::QROWS;
      fill<G::DHP>(sm.q(qb), G::QROWS, &sm.qfull()[qb], mq, p.q, q0, it, p);
      mbar_arrive(&sm.qfull()[qb]);
      if constexpr (G::FORM == TWO_PASS) {
        for (int t = 0; t < p.nt; ++t) tile(mk, p.k, t, true);
        for (int t = 0; t < p.nt; ++t) {
          tile(mk, p.k, t, true);
          tile(mv, p.v, t, false);
        }
      } else if constexpr (G::FORM == FLASH) {
        if (!p.resident || j == 0) {
          for (int t = 0; t < p.nt; ++t) {
            tile(mk, p.k, t, true);
            tile(mv, p.v, t, false);
          }
        }
      } else if (!G::RESIDENT || j == 0) {
        for (int t = 0; t < G::KV_TILES / 2; ++t) tile(mk, p.k, t, true);
        for (int t = 0; t < G::KV_TILES / 2; ++t) tile(mv, p.v, t, false);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// sc = Q K^T for the warpgroup's 64 query rows (row0 of a Q tile of qrows
// rows) and the 64 keys of a K tile, raw f32 sums (committed by the caller)
template <class G>
__device__ __forceinline__ void qk(float (&sc)[32], const unsigned char* q, int qrows,
                                   int row0, const unsigned char* k) {
  #pragma unroll
  for (int ks = 0; ks < G::DHP / 16; ++ks) {
    const int a = ks / 4, c = ks % 4;   // atom, and 16-column step (32 bytes) in it
    wgmma_m64n64k16_ss(sc, sw128_desc(q + (a * qrows + row0) * 128) + 2 * c,
                       sw128_desc(k + a * TK * 128) + 2 * c, ks > 0);
  }
}

// Scores in log2 units: s' = raw * scale2 + bias2 for keys k0 + col < S,
// -inf past S (by the key's index).  Thread t holds columns 8j + 2(t % 4)
// (+ 1) of each 8-key block j.
__device__ __forceinline__ void scale_bias(float (&sc)[32], const float* bias, float scale2,
                                           int k0, int S) {
  const int t = threadIdx.x & 3;
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias + c);
    const bool in0 = k0 + c < S, in1 = k0 + c + 1 < S;
    sc[4 * j] = in0 ? sc[4 * j] * scale2 + bb.x : -INFINITY;
    sc[4 * j + 1] = in1 ? sc[4 * j + 1] * scale2 + bb.y : -INFINITY;
    sc[4 * j + 2] = in0 ? sc[4 * j + 2] * scale2 + bb.x : -INFINITY;
    sc[4 * j + 3] = in1 ? sc[4 * j + 3] * scale2 + bb.y : -INFINITY;
  }
}

// the thread's max of row r (0: elements 0, 1 of each block; 1: 2, 3)
template <int NT>
__device__ __forceinline__ float row_max(const float (&sc)[NT][32], int r) {
  float mx = -INFINITY;
  #pragma unroll
  for (int t = 0; t < NT; ++t)
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[t][4 * j + 2 * r], sc[t][4 * j + 2 * r + 1]));
  return mx;
}

// sc = 2^(sc - m) for row r; returns the thread's sum of them
template <int NT>
__device__ __forceinline__ float row_exp(float (&sc)[NT][32], int r, float m) {
  float sum = 0.f;
  #pragma unroll
  for (int t = 0; t < NT; ++t)
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[t][4 * j + 2 * r] = exp2_approx(sc[t][4 * j + 2 * r] - m);
      sc[t][4 * j + 2 * r + 1] = exp2_approx(sc[t][4 * j + 2 * r + 1] - m);
      sum += sc[t][4 * j + 2 * r] + sc[t][4 * j + 2 * r + 1];
    }
  return sum;
}

// p (f32, the accumulator layout of a 64-key tile), rounded to bf16, as the
// A fragments of the four 16-key steps of P V: step kk is 8-key blocks 2kk
// and 2kk + 1, which is the m16n8k16 A fragment of the warp's 16 rows
template <int NT>
__device__ __forceinline__ void pack_p(const float (&sc)[NT][32], float inv0, float inv1,
                                       uint32_t (&a)[NT][4][4]) {
  #pragma unroll
  for (int t = 0; t < NT; ++t)
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* s = sc[t] + 8 * kk;
      a[t][kk][0] = pack_bf16(s[0] * inv0, s[1] * inv0);
      a[t][kk][1] = pack_bf16(s[2] * inv1, s[3] * inv1);
      a[t][kk][2] = pack_bf16(s[4] * inv0, s[5] * inv0);
      a[t][kk][3] = pack_bf16(s[6] * inv1, s[7] * inv1);
    }
}

// o (+)= P V over one V tile (committed by the caller); first: overwrite o
template <class G>
__device__ __forceinline__ void pv(float (&o)[G::NACC], const uint32_t (&a)[4][4],
                                   const unsigned char* v, bool first) {
  const uint64_t d = sw128_mn_desc(v, TK * 128);
  #pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (G::DHP == 64)
      wgmma_m64n64k16_rs(o, a[kk], d + 128 * kk, !(first && kk == 0));
    else
      wgmma_m64n128k16_rs(o, a[kk], d + 128 * kk, !(first && kk == 0));
  }
}

// The warpgroup's 64 output rows from q0, straight from the accumulators:
// rows 16 warp + g (+ 8), columns 8j + 2(t % 4) (+ 1)
template <class G>
__device__ __forceinline__ void store(const float (&o)[G::NACC], const Unit& it, int q0,
                                      const Params& p) {
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const long long D = (long long)p.H * p.Dh;
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 16 * warp + lane / 4 + 8 * r;
    if (s >= p.S) continue;
    bf16* row = p.out + ((long long)it.b * p.S + s) * D + (long long)it.h * p.Dh;
    #pragma unroll
    for (int j = 0; j < G::DHP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float v0 = o[4 * j + 2 * r], v1 = o[4 * j + 2 * r + 1];
      if (p.pairs) {
        if (c < p.Dh) *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(v0, v1);
      } else {
        if (c < p.Dh) row[c] = __float2bfloat16(v0);
        if (c + 1 < p.Dh) row[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ROWS and SPLIT, one query tile: Q K^T for the warpgroup's NT key tiles
// (ring positions kpos + first + t), scaled and biased; the Q buffer
// released, and the K slots too unless they stay for the unit's next tile
template <class G, int NT>
__device__ __forceinline__ void tile_scores(const Smem<G>& sm, float (&sc)[NT][32],
                                            int qb, int row0, uint32_t kpos, int first,
                                            bool release, const Params& p) {
  wgmma_fence();
  #pragma unroll
  for (int t = 0; t < NT; ++t) {
    const uint32_t at = kpos + first + t;
    wait_phase(&sm.full()[at % G::STAGES], (at / G::STAGES) & 1);
    qk<G>(sc[t], sm.q(qb), G::QROWS, row0, sm.tile(at % G::STAGES));
  }
  wgmma_commit();
  wgmma_wait<0>();
  #pragma unroll
  for (int t = 0; t < NT; ++t) fence_operands(sc[t]);
  warp_arrive(&sm.qempty()[qb]);
  #pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int s = (kpos + first + t) % G::STAGES;
    scale_bias(sc[t], sm.bias(s), p.scale2, (first + t) * TK, p.S);
    if (release) warp_arrive(&sm.empty()[s]);
  }
}

// ROWS and SPLIT, one query tile: o = P V over the warpgroup's NT V tiles
// (ring positions vpos + first + t), the slots released as tile_scores
template <class G, int NT>
__device__ __forceinline__ void tile_pv(const Smem<G>& sm, uint32_t (&a)[NT][4][4],
                                        float (&o)[G::NACC], uint32_t vpos, int first,
                                        bool release) {
  #pragma unroll
  for (int i = 0; i < G::NACC; ++i) o[i] = 0.f;
  wgmma_fence();
  #pragma unroll
  for (int t = 0; t < NT; ++t) {
    const uint32_t at = vpos + first + t;
    wait_phase(&sm.full()[at % G::STAGES], (at / G::STAGES) & 1);
    pv<G>(o, a[t], sm.tile(at % G::STAGES), t == 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  fence_fragments(a);
  if (release) {
    #pragma unroll
    for (int t = 0; t < NT; ++t) warp_arrive(&sm.empty()[(vpos + first + t) % G::STAGES]);
  }
}

// ROWS: the warpgroup's 64 of each 128-query tile against every key
template <class G>
__device__ __forceinline__ void consume_rows(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  constexpr int NT = G::NTW;
  const int wg = threadIdx.x / 128;
  uint32_t pos = 0;
  int n = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit it(u, p);
    for (int j = 0; j < it.nqt; ++j, ++n) {
      const int qb = n & 1;
      const bool release = !G::RESIDENT || j + 1 == it.nqt;
      wait_phase(&sm.qfull()[qb], (n >> 1) & 1);
      float sc[NT][32];
      tile_scores<G, NT>(sm, sc, qb, 64 * wg, pos, 0, release, p);

      // the exact row softmax: p = 2^(s - m) / max(l, 1e-30)
      float inv[2];
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = quad_max(row_max(sc, r));
        inv[r] = 1.f / fmaxf(quad_sum(row_exp(sc, r, m)), 1e-30f);
      }
      uint32_t a[NT][4][4];
      pack_p(sc, inv[0], inv[1], a);
      float o[G::NACC];
      tile_pv<G, NT>(sm, a, o, pos + NT, 0, release);
      if (!G::RESIDENT) pos += 2 * NT;
      store<G>(o, it, (it.qt0 + j) * G::QROWS + 64 * wg, p);
    }
    if (G::RESIDENT) pos += 2 * NT;
  }
}

// SPLIT: both warpgroups on each 64-query tile, warpgroup wg on key tiles
// wg NTW .. wg NTW + NTW - 1
template <class G>
__device__ __forceinline__ void consume_split(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  constexpr int NT = G::NTW;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  float* xo = sm.x();                        // [NACC][128] warpgroup 1's partial P V
  float2* xm = reinterpret_cast<float2*>(xo + 128 * G::NACC);   // [NC][128] row maxima
  float2* xl = xm + NC * 128;                // [NC][128] row sums
  uint32_t pos = 0;
  int n = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit it(u, p);
    for (int j = 0; j < it.nqt; ++j, ++n) {
      const int qb = n & 1;
      const bool release = !G::RESIDENT || j + 1 == it.nqt;
      wait_phase(&sm.qfull()[qb], (n >> 1) & 1);
      float sc[NT][32];
      tile_scores<G, NT>(sm, sc, qb, 0, pos, wg * NT, release, p);

      // the exact row softmax over both halves: the maxima, then the sums,
      // exchanged by the threads that hold the same rows in either warpgroup
      const float2 mx = make_float2(quad_max(row_max(sc, 0)), quad_max(row_max(sc, 1)));
      xm[wg * 128 + tw] = mx;
      named_bar_sync(XBAR, CT);
      const float2 mx1 = xm[(1 - wg) * 128 + tw];
      const float2 su = make_float2(quad_sum(row_exp(sc, 0, fmaxf(mx.x, mx1.x))),
                                    quad_sum(row_exp(sc, 1, fmaxf(mx.y, mx1.y))));
      xl[wg * 128 + tw] = su;
      named_bar_sync(XBAR, CT);
      const float2 l0 = xl[tw], l1 = xl[128 + tw];
      uint32_t a[NT][4][4];
      pack_p(sc, 1.f / fmaxf(l0.x + l1.x, 1e-30f), 1.f / fmaxf(l0.y + l1.y, 1e-30f), a);
      float o[G::NACC];
      tile_pv<G, NT>(sm, a, o, pos + 2 * NT, wg * NT, release);
      if (!G::RESIDENT) pos += 4 * NT;

      // o = o0 + o1 in warpgroup 0, which stores
      if (wg == 1) {
        #pragma unroll
        for (int i = 0; i < G::NACC; ++i) xo[i * 128 + tw] = o[i];
      }
      named_bar_sync(XBAR, CT);
      if (wg == 0) {
        #pragma unroll
        for (int i = 0; i < G::NACC; ++i) o[i] += xo[i * 128 + tw];
        store<G>(o, it, (it.qt0 + j) * G::QROWS, p);
      }
    }
    if (G::RESIDENT) pos += 4 * NT;
  }
}

// TWO_PASS: the warpgroup's 64 of each 128-query tile; pass 1 the running
// max and rescaled sum over K, pass 2 the scores again with V
template <class G>
__device__ __forceinline__ void consume_two_pass(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  const int wg = threadIdx.x / 128;
  uint32_t pos = 0;
  int n = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit it(u, p);
    for (int j = 0; j < it.nqt; ++j, ++n) {
      const int qb = n & 1;
      wait_phase(&sm.qfull()[qb], (n >> 1) & 1);
      // scores of K tile t into sc[0], scaled and biased, the slot released
      float sc[1][32];
      auto scores = [&](int t) {
        const int s = pos % G::STAGES;
        wait_phase(&sm.full()[s], (pos / G::STAGES) & 1);
        wgmma_fence();
        qk<G>(sc[0], sm.q(qb), G::QROWS, 64 * wg, sm.tile(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sc[0]);
        scale_bias(sc[0], sm.bias(s), p.scale2, t * TK, p.S);
        warp_arrive(&sm.empty()[s]);
        ++pos;
      };
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int t = 0; t < p.nt; ++t) {
        scores(t);
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(row_max(sc, r)));
          const float corr = exp2_approx(m[r] - mn);   // 0 on the first tile
          m[r] = mn;
          l[r] = l[r] * corr + quad_sum(row_exp(sc, r, mn));
        }
      }
      const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
      float o[G::NACC];
      #pragma unroll
      for (int i = 0; i < G::NACC; ++i) o[i] = 0.f;
      for (int t = 0; t < p.nt; ++t) {
        scores(t);
        #pragma unroll
        for (int e = 0; e < 32; ++e) sc[0][e] = exp2_approx(sc[0][e] - m[(e >> 1) & 1]);
        uint32_t a[1][4][4];
        pack_p(sc, inv0, inv1, a);
        const int s = pos % G::STAGES;
        wait_phase(&sm.full()[s], (pos / G::STAGES) & 1);
        wgmma_fence();
        pv<G>(o, a[0], sm.tile(s), t == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
        fence_fragments(a);
        warp_arrive(&sm.empty()[s]);
        ++pos;
      }
      warp_arrive(&sm.qempty()[qb]);
      store<G>(o, it, (it.qt0 + j) * G::QROWS + 64 * wg, p);
    }
  }
}

// FLASH (B6): the warpgroup's 64 of each 128-query tile, the online
// recurrence over the key tiles in order (K and V of tile t at ring
// positions pos + 2t and pos + 2t + 1).  Q K^T of tile t is issued with
// P V of tile t - 1 and awaited alone, so tile t's exps run while the
// tensor cores still multiply P V; the other warpgroup's work fills the
// rest.
template <class G>
__device__ __forceinline__ void consume_flash(const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<G> sm(smem_raw);
  const int wg = threadIdx.x / 128;
  uint32_t pos = 0;
  int n = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit it(u, p);
    for (int j = 0; j < it.nqt; ++j, ++n) {
      const int qb = n & 1;
      const bool release = !p.resident || j + 1 == it.nqt;
      wait_phase(&sm.qfull()[qb], (n >> 1) & 1);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      float o[G::NACC];
      uint32_t a[1][4][4];
      float sc[1][32];
      // Q K^T of tile t into sc, and o (+)= P V of tile t (issued, not
      // committed)
      auto issue_qk = [&](int t) {
        const uint32_t at = pos + 2 * t;
        wait_phase(&sm.full()[at % G::STAGES], (at / G::STAGES) & 1);
        qk<G>(sc[0], sm.q(qb), G::QROWS, 64 * wg, sm.tile(at % G::STAGES));
      };
      auto issue_pv = [&](int t) {
        const uint32_t at = pos + 2 * t + 1;
        wait_phase(&sm.full()[at % G::STAGES], (at / G::STAGES) & 1);
        pv<G>(o, a[0], sm.tile(at % G::STAGES), t == 0);
      };
      // tile t's scores into p = 2^(s - m), with the new running max m, the
      // correction corr = 2^(m_old - m) and l = l corr + the sum of p
      auto softmax = [&](int t) {
        fence_operands(sc[0]);
        const uint32_t at = pos + 2 * t;
        scale_bias(sc[0], sm.bias(at % G::STAGES), p.scale2, t * TK, p.S);
        if (release) warp_arrive(&sm.empty()[at % G::STAGES]);
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(row_max(sc, r)));
          corr[r] = exp2_approx(m[r] - mn);       // 0 on the first tile
          m[r] = mn;
          l[r] = l[r] * corr[r] + quad_sum(row_exp(sc, r, mn));
        }
      };
      // P V of tile t done: o and the fragments free, the V slot released
      auto retire_pv = [&](int t) {
        fence_operands(o);
        fence_fragments(a);
        if (release) warp_arrive(&sm.empty()[(pos + 2 * t + 1) % G::STAGES]);
      };

      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      wgmma_wait<0>();
      softmax(0);
      pack_p(sc, 1.f, 1.f, a);                    // p rounded to bf16
      for (int t = 1; t < p.nt; ++t) {
        wgmma_fence();
        issue_qk(t);
        wgmma_commit();
        issue_pv(t - 1);
        wgmma_commit();
        wgmma_wait<1>();                          // Q K^T of tile t
        softmax(t);
        wgmma_wait<0>();                          // P V of tile t - 1
        retire_pv(t - 1);
        #pragma unroll
        for (int i = 0; i < G::NACC; ++i) o[i] *= corr[(i >> 1) & 1];
        pack_p(sc, 1.f, 1.f, a);
      }
      warp_arrive(&sm.qempty()[qb]);
      wgmma_fence();
      issue_pv(p.nt - 1);
      wgmma_commit();
      wgmma_wait<0>();
      retire_pv(p.nt - 1);

      // acc / max(l, 1e-30), as the row's reciprocal times acc
      const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
      #pragma unroll
      for (int i = 0; i < G::NACC; ++i) o[i] *= inv[(i >> 1) & 1];
      if (!p.resident) pos += 2 * p.nt;
      store<G>(o, it, (it.qt0 + j) * G::QROWS + 64 * wg, p);
    }
    if (p.resident) pos += 2 * p.nt;
  }
}

template <class G>
__global__ void __launch_bounds__(THREADS, 1)
attention_wg_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  if (threadIdx.x == 0) {
    const Smem<G> sm(smem_raw);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.qfull()[i], FULL_ARRIVALS);
      mbar_init(&sm.qempty()[i], Q_READERS);
    }
    for (int i = 0; i < G::STAGES; ++i) {
      mbar_init(&sm.full()[i], FULL_ARRIVALS);
      mbar_init(&sm.empty()[i], G::TILE_READERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // everything else is computed after setmaxnreg: ptxas spills what lives
  // across it
  if (threadIdx.x >= CT) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < CT + 32) produce<G>(&mq, &mk, &mv, p);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    if constexpr (G::FORM == ROWS) consume_rows<G>(p);
    else if constexpr (G::FORM == SPLIT) consume_split<G>(p);
    else if constexpr (G::FORM == TWO_PASS) consume_two_pass<G>(p);
    else consume_flash<G>(p);
  }
}

// ---------------------------------------------------------------------------
// host side
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

// TMA takes the rows: 16-byte aligned bases, strides and head width
inline bool tma_rows(const Args& a) {
  auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return a.Dh % 8 == 0 && a.sb % 8 == 0 && a.ss % 8 == 0 && a.sh % 8 == 0 && al(a.q)
         && al(a.k) && al(a.v);
}

// rank-4 map over one of q, k, v as [B, S, H, Dh] (dims innermost first: Dh,
// H, S, B), boxes of 64 columns x 1 head x box_rows rows x 1 batch row,
// 128-byte swizzle, zeros outside
inline cudaError_t heads_map(CUtensorMap* map, const void* base, const Args& a,
                             int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)a.Dh, (cuuint64_t)a.H, (cuuint64_t)a.S,
                              (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.sh * 2, (cuuint64_t)a.ss * 2,
                                 (cuuint64_t)a.sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                          dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// info[8]: registers, shared bytes, threads, blocks per SM, spill bytes (as
// ac_common::kernel_info), consumer warpgroups, form, TMA-fed
template <class G>
cudaError_t launch_geo(const Args& a, bool tma) {
  auto* kernel = attention_wg_kernel<G>;
  if (a.info) {
    const cudaError_t err = ac_common::kernel_info(kernel, G::SMEM, THREADS, a.info);
    a.info[5] = NC;
    a.info[6] = G::FORM;
    a.info[7] = tma;
    return err;
  }
  // setmaxnreg hands the producer's registers to the consumers: the block
  // must have been given the whole budget at launch, or the consumers'
  // request would wait forever
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes at;
    const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
    if (err != cudaSuccess) return err;
    regs = at.numRegs;
  }
  if (regs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * CT)
    return cudaErrorInvalidConfiguration;
  int device = 0, sms = 0;
  cudaError_t err = bind_device(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3] = {};
  if (tma) {
    err = heads_map(&maps[0], a.q, a, G::QROWS);
    if (err == cudaSuccess) err = heads_map(&maps[1], a.k, a, TK);
    if (err == cudaSuccess) err = heads_map(&maps[2], a.v, a, TK);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  Params p;
  p.q = static_cast<const bf16*>(a.q);
  p.k = static_cast<const bf16*>(a.k);
  p.v = static_cast<const bf16*>(a.v);
  p.mask = a.mask;
  p.out = static_cast<bf16*>(a.out);
  p.B = a.B, p.S = a.S, p.H = a.H, p.Dh = a.Dh;
  p.sb = a.sb, p.ss = a.ss, p.sh = a.sh;
  p.scale2 = LOG2E / sqrtf((float)a.Dh);
  p.nq = (a.S + G::QROWS - 1) / G::QROWS;
  p.nt = (a.S + TK - 1) / TK;
  // Units of one query tile, or, where K and V stay in the ring, of as many
  // of a (b, h)'s query tiles as leave every SM a unit or more
  p.resident = G::FORM == FLASH ? 2 * p.nt <= G::STAGES : G::RESIDENT;
  const long long tiles = (long long)a.B * a.H * p.nq;
  const long long per = p.resident ? (tiles + sms - 1) / sms : 1;
  p.qpu = (int)(per < p.nq ? per : p.nq);
  p.nqu = (p.nq + p.qpu - 1) / p.qpu;
  const long long units = (long long)a.B * a.H * p.nqu;
  if (units > 0x7fffffff) return cudaErrorInvalidValue;
  p.units = (int)units;
  p.tma = tma;
  p.pairs = a.Dh % 2 == 0 && (reinterpret_cast<uintptr_t>(a.out) & 3) == 0;
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, THREADS, G::SMEM, a.stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// the form by row length: ROWS up to 4 key tiles (S 256; rows of at most
// SHORT_MAX_S keys run the tile loop, below), SPLIT up to 8 (S 512),
// TWO_PASS above; B6 (flash) takes FLASH at every length
template <int DHP>
cudaError_t launch_dhp(const Args& a, bool tma, bool flash) {
  const int nt = (a.S + TK - 1) / TK;
  if (flash) return launch_geo<Geo<DHP, FLASH, 1>>(a, tma);
  if (nt <= 2) return launch_geo<Geo<DHP, ROWS, 2>>(a, tma);
  if (nt <= ROWS_MAX_NT) return launch_geo<Geo<DHP, ROWS, ROWS_MAX_NT>>(a, tma);
  if (nt <= SPLIT_MAX_NT) return launch_geo<Geo<DHP, SPLIT, SPLIT_MAX_NT / 2>>(a, tma);
  return launch_geo<Geo<DHP, TWO_PASS, 1>>(a, tma);
}

// ---------------------------------------------------------------------------
// rows of at most SHORT_MAX_S keys: one staged tile on the mma.sync tile
// loop (attention_tile.cuh).  The wgmma kernel pads such rows to 128-query,
// 64-key tiles and measured 2.4x slower at [256, 32] x 8 heads on an H100
// (PERF.md §6).
// ---------------------------------------------------------------------------

constexpr int SHORT_MAX_S = 64;

template <class Tl, bool ALIGNED, bool FLASH_ORDER>
__global__ void __launch_bounds__(Tl::THREADS, ac_attn::kMinBlocks<Tl>)
one_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ mask,
                bf16* __restrict__ out, int S, int H, int Dh, long long sb, long long ss,
                long long sh, float scale2) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long off = (long long)b * sb + (long long)h * sh;
  ac_attn::one_tile_rows<Tl, ALIGNED, FLASH_ORDER>(
      q + off, k + off, v + off, mask + (long long)b * S, out, b, h, S, H, Dh, ss, scale2);
}

// info[5..7] of the tile loop: no warpgroups, no wgmma form, no TMA
template <class Tl, bool ALIGNED, bool FLASH_ORDER>
cudaError_t launch_one_tile(const Args& a) {
  auto* kernel = one_tile_kernel<Tl, ALIGNED, FLASH_ORDER>;
  const size_t smem = Tl::smem_bytes();
  if (a.info) {
    a.info[5] = a.info[6] = a.info[7] = 0;
    return ac_common::kernel_info(kernel, smem, Tl::THREADS, a.info);
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + Tl::TQ - 1) / Tl::TQ, a.H, a.B);
  kernel<<<grid, Tl::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.mask, static_cast<bf16*>(a.out), a.S, a.H, a.Dh,
      a.sb, a.ss, a.sh, LOG2E / sqrtf((float)a.Dh));
  return cudaGetLastError();
}

// 2 warps and one 32-key tile at S <= 32 (no half of a tile is padding),
// else 4 warps and one 64-key tile
template <int DHP, bool ALIGNED, bool FLASH_ORDER>
cudaError_t launch_short(const Args& a) {
  if (a.S <= 32) return launch_one_tile<ac_attn::Tile<DHP, 2, 32>, ALIGNED, FLASH_ORDER>(a);
  return launch_one_tile<ac_attn::Tile<DHP, 4, 64>, ALIGNED, FLASH_ORDER>(a);
}

template <bool ALIGNED, bool FLASH_ORDER>
cudaError_t launch_short_dh(const Args& a) {
  if (a.Dh <= 32) return launch_short<32, ALIGNED, FLASH_ORDER>(a);
  if (a.Dh <= 64) return launch_short<64, ALIGNED, FLASH_ORDER>(a);
  return launch_short<128, ALIGNED, FLASH_ORDER>(a);
}

// bf16 attention on q, k, v [B, S, H, Dh] (Dh <= 128; the caller checks
// the envelope), out [B, S, H * Dh]; with a.info, the instantiation.  flash:
// B6's order of rounding (the online recurrence: p = 2^(s - m) rounded,
// the division at the end), else B1's and B7's (p normalized, then
// rounded).  Rows of at most SHORT_MAX_S keys run the tile loop (16-byte
// copies where TMA could take the rows and out starts on 16 bytes, else
// element by element), longer rows the wgmma kernel.
inline cudaError_t launch(const Args& a, bool flash = false) {
  const bool tma = tma_rows(a);
  if (a.S <= SHORT_MAX_S) {
    const bool fast = tma && (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
    if (flash) return fast ? launch_short_dh<true, true>(a) : launch_short_dh<false, true>(a);
    return fast ? launch_short_dh<true, false>(a) : launch_short_dh<false, false>(a);
  }
  return a.Dh <= 64 ? launch_dhp<64>(a, tma, flash) : launch_dhp<128>(a, tma, flash);
}

}  // namespace ac_wg
