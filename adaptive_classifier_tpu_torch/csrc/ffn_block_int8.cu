// Kernels B3 and B8: the int8 FFN block, and the whole post-attention body
// of an encoder layer (an O-projection stage in front of the same body).
//
// B3 replaces the TPU kernel adaptive_classifier_tpu/ops/ffn_int8.py:95
// `ffn_block_int8` (pallas_call at :124, body `_ffn_kernel` :56):
//     f   = gelu_tanh(q(h) @ W1 * s_h * s1 + b1)               [M, F] f32
//     out = LayerNorm(q(f) @ W2 * s_f * s2 + b2 + h)           [M, D], h's type
// B8 replaces ops/ffn_int8.py:202 `attn_ffn_block_int8` (pallas_call at
// :245, body `_attn_ffn_kernel` :157): the same body on
//     h   = LayerNorm1(q(ctx) @ Wo * s_c * so + bo + x)        [M, D] f32
// with out in ctx's type.  q() is the per-row symmetric int8 quantization
// with scale absmax / 127 (floor 1e-8) over the row's whole width, every
// product int8 x int8 -> int32, every epilogue step rounded on its own
// (int8_tile.cuh), the LayerNorms' statistics in f32.  GELU is the tanh
// form (ffn_int8.py:46).
//
// What bounds them on an H100: operations.  B3 does 4*M*D*F: at the
// banking chunk (M 8,192, D 512, F 2,048) 34.4 GOP, 17.4 us at the 1,979
// TOP/s int8 tensor-core peak, against ~18.9 MB of bytes (5.6 us); at the
// hallucination chunk (M 32,768) 69.4 us; at bert-base (M 4,096, D 768,
// F 3,072) 19.5 us.  B8 2*M*D*(D + 2F): 19.5 / 78.1 / 22.0 us.
//
// B8 runs int8_hopper.cuh (its design is noted there).  B3 runs the kernel
// below, on the same machinery: s8 wgmma from shared memory in the
// 128-byte swizzle, 2-D TMA boxes of 64 rows x 128 bytes of the weights'
// K-contiguous copies (ops/ffn_int8.py k_contiguous; their tensor maps made
// once a weight and kept beside it), a persistent grid, one block an SM of
// a producer warpgroup (one thread loads the weights, one q(f) and the next
// tile's rows of h into the L2) and four consumer warpgroups: 640 threads,
// so ptxas gives each 96 registers.  Per tile of 64 rows:
// - q(h) [64, D] is quantized by the consumer threads straight into the
//   A operand's swizzled layout (16-byte chunk c of row r at c ^ (r % 8);
//   int8_hopper.cuh quant_rows, as B2 and B8 quantize their rows), a proxy
//   fence before the first wgmma reads it;
// - pass 1, the W1 product in chunks of 64 columns (m64n64k32, warpgroup g
//   taking chunks 4p + g), keeps each row's |GELU| maximum: the quad's,
//   then the warpgroups' in order through shared memory.  Nothing stored;
// - pass 2 runs the same products again: the int32 sums are exact and the
//   epilogue the same instructions, so the f32 GELU values are the same
//   bit for bit; each is quantized at once and only q(f) is stored, int8,
//   to a device scratch of 64 x F bytes a tile in flight (8.7 MB at the
//   zoo's chunks on 132 SMs, 12.6 MB at bert-base's, inside the 50 MB L2).
//   No f32 value leaves the SM;
// - the W2 product reads q(f) back by TMA (a proxy fence for global memory
//   orders the stores before the loads) into a ring over q(h)'s space; its
//   weight boxes need no q(f), so they land while pass 2 runs.  Its sums
//   stay in the accumulators' registers through LayerNorm 2 (32 a thread at
//   the zoo's width, 48 at bert-base's): the residual h is re-read from the
//   L2, the row statistics go through shared memory in a fixed order, and
//   each thread writes its normalized values.
// Every quantization divides by a row scale reused across the row: the
// quotient comes from the scale's correctly rounded reciprocal and one
// exact FMA remainder (int8_tile.cuh quant_rcp: Markstein's correction,
// the same float as the IEEE division, 5-7% of B3's time on an H100).
// Every wgmma of a thread accumulates into one array: ptxas gives each
// array a wgmma writes registers of its own for the whole kernel, so the
// passes' and the W2 product's separate arrays spilled.
// Why q(f) is not kept in shared memory: at 96 registers a thread the
// products run on 64-column chunks from a ring of 64 x 128-byte boxes, at
// least 16 slots (four a warpgroup, each holding two K steps), 128 KB
// beside q(h) [64, D]; q(f) [64, 2,048] (128 KB) does not fit beside them
// at the zoo's width, nor bert-base's [64, 3,072] (192 KB) at all.  An int8
// scratch in the L2 costs one store of q(f) a tile and a TMA read of it by
// each block that shares the tile.
// The choice from D 512 (the zoo's width, bert-base's): a cluster of two
// blocks a tile.  The W2 product's [64, D] sums do not fit the registers
// of one block (64 a thread at D 512, 96 at 768, beside everything else),
// so each block of the pair owns half of D's columns for the W2 product
// and LayerNorm 2, and half of F's chunks for the two W1 passes.  The pair
// exchanges each row's |GELU| maximum and its LayerNorm sums through
// distributed shared memory (own + peer: the same f32 total in either
// block), and reads both halves of q(f) from the scratch after a
// cluster-scope release of the peer's stores.  The pair also doubles the
// blocks at bert-base's M 4,096: 64 tiles alone would leave half of the
// 132 SMs idle.  Below D 512 one block takes a tile.
// The W2 columns of a block go to its warpgroups in 32-column units
// (m64n64k32 a pair, m64n32k32 an odd one); D 640 and 896 leave the last
// warpgroup fewer.  Ragged M is masked in the kernel: rows past M are
// quantized as zeros and not stored; h is read only below M.
// Each width of the envelope is an instantiation of its own (Cfg<D>): its
// layout, ring sizes and column shares are known when it is compiled.
// Kept at run time, they were live across the tile loop and spilled (on
// an H100, 96 -> 48 bytes a thread at D 512, 264 -> 192 at 768, and ~10%
// of B3's time).  What still spills at 96 registers: the tile loop's state,
// reloaded once a tile, and from D 768 the W2 epilogue's loads beside its
// 64 sums a thread.  The launch plan (the clusters that fit) is made once
// a device (hopper.cuh PerDevice).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "int8_hopper.cuh"
#include "int8_tile.cuh"

namespace {

using namespace ac_hopper;
using ac_i8h::a_offset;
using ac_i8h::warps_bar_sync;
using ac_i8h::fence_acc;
using ac_i8h::fence_proxy_async_global;
using ac_i8h::ln;
using ac_i8h::wgmma_m64n32k32_s8;
using ac_i8h::wgmma_m64n64k32_s8;
using ac_int8::dequant;
using ac_int8::gelu_tanh;
using ac_int8::load2;
using ac_int8::quad_max;
using ac_int8::quad_sum;
using ac_int8::quant_rcp;
using ac_int8::row_scale;
using ac_int8::store2;

namespace b3 {

constexpr int ROWS = 64;                   // rows a tile (wgmma M)
constexpr int KB = 128;                    // bytes of K a box (one swizzle atom)
constexpr int NC = 4;                      // consumer warpgroups
constexpr int CT = 128 * NC;               // consumer threads
constexpr int THREADS = CT + 128;          // + the producer warpgroup (one thread loads)
constexpr int XBAR = 1;                    // named barrier of the consumer threads
constexpr int BN = 64;                     // rows of a weight box: W1 columns a chunk, W2 columns
constexpr int BOX = BN * KB;               // a weight box, a slab of q(h), a box of q(f)
static_assert(BN == ac_i8h::BOX_ROWS && ROWS == ac_i8h::BOX_ROWS,
              "the tensor maps' boxes (ac_i8h::bytes_map) are what the kernel waits for");
constexpr int MAX_U = 4;                   // W2 units of 32 columns a warpgroup
constexpr int MIN_STAGES = 2 * NC * ((MAX_U + 1) / 2);   // two K steps' boxes a warpgroup
constexpr int MAX_STAGES = 24;
constexpr int MAX_D = 1024;
constexpr int MAX_A = MAX_D / KB;

// Shared memory from the first 1024-byte boundary, at A width da
// (a_width(D)) and `stages` weight slots: q(h) [da / 128 slabs][64][128]
// (in the W2 product a ring of da / 128 q(f) boxes), the weight ring, q(h)'s
// row scales [64], the block's exchange [2][NC][64], the cluster's [2][64],
// and the barriers full[MAX_STAGES], empty[MAX_STAGES], afull[MAX_A],
// aempty[MAX_A], qf_ready and cluster[2].
struct Layout {
  int abuf, ring, cs, red, cx, bar, total;
  __host__ __device__ constexpr Layout(int da, int stages)
      : abuf(0), ring(ROWS * da), cs(ring + stages * BOX), red(cs + ROWS * 4),
        cx(red + 2 * NC * ROWS * 4), bar(cx + 2 * ROWS * 4),
        total(bar + 8 * (2 * MAX_STAGES + 2 * MAX_A + 3) + 1024) {}   // + alignment slack
};

// shared memory a block may take on an H100 (227 KB); the launch checks the
// device
constexpr int SMEM_OPTIN = 232448;

// The instantiation for width D, all of it known when it is compiled: a
// pair of blocks a tile from D 512, else one; U units of
// 32 W2 columns to a warpgroup (EVEN: to each; D 640 and 896 leave the last
// fewer); the A operand's width DA (at least 256, so q(f)'s ring over it
// has NA >= 2 slots); the weight ring's slots, a multiple of NC.
template <int D>
struct Cfg {
  static constexpr int CL = D >= 512 ? 2 : 1;
  static constexpr int U = (D / CL / 32 + NC - 1) / NC;
  static constexpr int UP = (U + 1) / 2;
  static constexpr bool EVEN = (D / CL) % (32 * NC) == 0;
  static constexpr int DA = D > 2 * KB ? D : 2 * KB;
  static constexpr int NA = DA / KB;
  static constexpr int FIT = (SMEM_OPTIN - Layout(DA, 0).total) / BOX;
  static constexpr int STAGES = (FIT < MAX_STAGES ? FIT : MAX_STAGES) / NC * NC;
  // the layout's offsets as scalars (device code may read a constexpr
  // scalar, not a constexpr object of class type)
  static constexpr int RING = Layout(DA, STAGES).ring, CS = Layout(DA, STAGES).cs,
                       RED = Layout(DA, STAGES).red, CX = Layout(DA, STAGES).cx,
                       BAR = Layout(DA, STAGES).bar, TOTAL = Layout(DA, STAGES).total;
  static_assert(D % KB == 0 && D <= MAX_D, "D % 128 == 0, D <= 1,024");
  static_assert(STAGES >= MIN_STAGES, "two K steps' boxes for every warpgroup");
};

struct Params {
  const void* h;                           // [M, D], h's type
  const float *s1, *b1;                    // [F]
  const float *s2, *b2, *g, *beta;         // [D]
  float eps;
  int8_t* qf;                              // q(f) [slots * 64, F], a slot a cluster
  void* out;                               // [M, D], h's type
  int M, F, tiles;
  int bf16;
};

template <int D>
struct Smem {
  using C = Cfg<D>;
  unsigned char* base;
  __device__ explicit Smem(unsigned char* raw)
      : base(raw + (1024 - smem_addr(raw) % 1024) % 1024) {}
  __device__ unsigned char* abuf() const { return base; }            // q(h) from the start
  __device__ unsigned char* slot(int s) const { return base + C::RING + s * BOX; }
  __device__ float* cs() const { return reinterpret_cast<float*>(base + C::CS); }
  __device__ float* red(int k) const {
    return reinterpret_cast<float*>(base + C::RED) + (k & 1) * NC * ROWS;
  }
  __device__ float* cx(int k) const { return reinterpret_cast<float*>(base + C::CX) + k * ROWS; }
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(base + C::BAR); }
  __device__ uint64_t* empty() const { return full() + MAX_STAGES; }
  __device__ uint64_t* afull() const { return full() + 2 * MAX_STAGES; }
  __device__ uint64_t* aempty() const { return afull() + MAX_A; }
  __device__ uint64_t* qf_ready() const { return aempty() + MAX_A; }
  __device__ uint64_t* cbar() const { return qf_ready() + 1; }
};

// What a block of a cluster of CL computes: its W1 chunks [ch0, ch1) of 64
// columns, in groups of NC; its W2 columns [dbase, dbase + D / CL) in
// units of 32, U to a warpgroup (at D 640 and 896 the last warpgroups
// fewer); its q(f) slot and its tiles.
template <int D>
struct Share {
  static constexpr int CL = Cfg<D>::CL, U = Cfg<D>::U;
  int rank, ch0, ch1, groups1, dbase, slot, first, step;
  __device__ explicit Share(const Params& p) {
    rank = CL == 2 ? (int)cluster_rank() : 0;
    const int nch = p.F / BN, half = (nch + CL - 1) / CL;
    ch0 = rank * half;
    ch1 = min(nch, ch0 + half);
    groups1 = (half + NC - 1) / NC;
    dbase = rank * (D / CL);
    slot = blockIdx.x / CL;
    first = blockIdx.x / CL;
    step = gridDim.x / CL;
  }
  // units of warpgroup g
  __device__ __forceinline__ static constexpr int count(int g) {
    return D / CL / 32 - g * U < U ? D / CL / 32 - g * U : U;
  }
};

// threadIdx.x, hidden from the compiler's loop-invariant code motion and
// common subexpressions: what a phase derives from it is computed in that
// phase, not kept live across the tile loop (which spilled registers)
__device__ __forceinline__ int tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}
// thread t of a warpgroup holds rows row_of(t) and row_of(t) + 8 of a
// wgmma accumulator, columns 8 j + 2 (t % 4) (+ 1)
__device__ __forceinline__ int row_of(int t) { return 16 * ((t & 127) >> 5) + ((t & 31) >> 2); }

// the slot and phase of box i of a ring of n slots
__device__ __forceinline__ uint32_t ring_slot(uint32_t i, uint32_t n) { return i % n; }
__device__ __forceinline__ uint32_t ring_phase(uint32_t i, uint32_t n) { return (i / n) & 1; }

// ---------------------------------------------------------------------------
// producers: one thread loads the weights, one of another warp q(f)
// ---------------------------------------------------------------------------

// Every weight box in the consumers' order: a tile's two W1 passes, then
// its W2 boxes, which need no q(f) and so land while pass 2 runs.  Box i
// goes to slot i % stages and belongs to warpgroup i % NC (W1: chunk NC p +
// g; W2: the b-th box of warpgroup g at NC b + g of its K step), and the
// slots are a multiple of NC, so a slot's phases all belong to one
// warpgroup, which waits on each in turn: a slot shared between
// warpgroups would let one run two phases ahead of its last use and pass
// the parity test of the earlier phase.
template <int D>
__device__ __forceinline__ void produce_weights(const CUtensorMap* mw1, const CUtensorMap* mw2,
                                                const Params& p) {
  constexpr int U = Cfg<D>::U, UP = Cfg<D>::UP;   // W2 boxes a warpgroup a K step: UP
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const Share<D> sh(p);
  uint32_t ws = 0, wph = 0;                    // the ring's cursor
  // the next weight box: TMA into its slot, or (no such chunk) a bare arrival
  auto put = [&](const CUtensorMap* map, int x, int y, bool live) {
    wait_phase(&sm.empty()[ws], wph ^ 1);
    if (live) {
      mbar_arrive_expect_tx(&sm.full()[ws], BOX);
      tma_load_2d(sm.slot(ws), map, &sm.full()[ws], x, y);
    } else {
      mbar_arrive(&sm.full()[ws]);
    }
    if (++ws == (uint32_t)Cfg<D>::STAGES) ws = 0, wph ^= 1;
  };
  for (int tile = sh.first; tile < p.tiles; tile += sh.step) {
    for (int pass = 0; pass < 2; ++pass)
      for (int pr = 0; pr < sh.groups1; ++pr)
        for (int k0 = 0; k0 < D; k0 += KB)
          for (int g = 0; g < NC; ++g) {
            const int ch = sh.ch0 + NC * pr + g;
            put(mw1, k0, ch * BN, ch < sh.ch1);
          }
    for (int k0 = 0; k0 < p.F; k0 += KB)
      for (int b = 0; b < UP; ++b)
        for (int g = 0; g < NC; ++g)
          put(mw2, k0, sh.dbase + g * U * 32 + b * BN, 2 * b < sh.count(g));
  }
}

// rows [row0, row0 + 64) of h (those below M) into the L2 ahead of their
// quantization, which would otherwise wait on device memory row by row
template <int D>
__device__ __forceinline__ void prefetch_rows(const Params& p, int row0) {
  if (row0 >= p.M) return;
  const int rows = min(ROWS, p.M - row0);
  const size_t row_bytes = (size_t)D * (p.bf16 ? 2 : 4);
  bulk_prefetch_l2(static_cast<const char*>(p.h) + row0 * row_bytes,
                   (uint32_t)(rows * row_bytes));
}

// A tile's q(f) boxes, into the ring over q(h)'s space, once every block of
// the cluster has stored its q(f) columns and read its last q(h); and the
// next tile's rows of h into the L2 as each tile starts
template <int D>
__device__ __forceinline__ void produce_qf(const CUtensorMap* mqf, const Params& p) {
  constexpr int CL = Cfg<D>::CL;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const Share<D> sh(p);
  uint32_t as = 0, aph = 0;                    // the ring's cursor
  int n = 0;                                   // tiles so far
  for (int tile = sh.first; tile < p.tiles; tile += sh.step, ++n) {
    prefetch_rows<D>(p, (tile + sh.step) * ROWS);
    if (CL == 1) wait_phase(sm.qf_ready(), n & 1);
    else wait_phase_cluster(sm.qf_ready(), n & 1);
    for (int k0 = 0; k0 < p.F; k0 += KB) {
      wait_phase(&sm.aempty()[as], aph ^ 1);
      mbar_arrive_expect_tx(&sm.afull()[as], BOX);
      tma_load_2d(sm.abuf() + as * BOX, mqf, &sm.afull()[as], k0, sh.slot * ROWS);
      if (++as == (uint32_t)Cfg<D>::NA) as = 0, aph ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

template <int D>
struct Consumer {
  static constexpr int CL = Cfg<D>::CL, U = Cfg<D>::U;
  static constexpr bool EVEN = Cfg<D>::EVEN;
  static constexpr int UP = Cfg<D>::UP;    // unit pairs: W2 boxes, accumulator arrays of 32
  static constexpr int JG = 2;             // column pairs a group of the W2 epilogue's loads
  const Params& p;
  const Smem<D>& sm;
  const Share<D>& sh;
  int g, cnt;                              // warpgroup, its W2 units
  uint32_t wi, ai = 0;                     // the warpgroup's next weight box, q(f) box
  int x = 0, cxn = 0;                      // block and cluster exchanges so far

  __device__ Consumer(const Params& p_, const Smem<D>& sm_, const Share<D>& sh_)
      : p(p_), sm(sm_), sh(sh_), g(threadIdx.x / 128),
        cnt(EVEN ? U : sh_.count(threadIdx.x / 128)), wi(threadIdx.x / 128) {}

  __device__ __forceinline__ void arrive(uint64_t* bar) {
    __syncwarp();
    if ((tid() & 31) == 0) mbar_arrive(bar);
  }
  __device__ __forceinline__ uint32_t wait_w(uint32_t i) {
    const uint32_t s = ring_slot(i, Cfg<D>::STAGES);
    wait_phase(&sm.full()[s], ring_phase(i, Cfg<D>::STAGES));
    return s;
  }
  __device__ __forceinline__ uint32_t wait_a(uint32_t i) {
    const uint32_t s = ring_slot(i, Cfg<D>::NA);
    wait_phase(&sm.afull()[s], ring_phase(i, Cfg<D>::NA));
    return s;
  }

  // acc = q(h) . (W1 chunk)^T over D, box by box; one box's products stay
  // in flight while the next box is awaited.  The warpgroup's W1 boxes are
  // every NC-th of the ring's sequence.
  __device__ __forceinline__ void product1(int (&acc)[32]) {
    uint32_t prev = 0;
    for (int ks = 0; ks < D / KB; ++ks, wi += NC) {
      const uint32_t s = wait_w(wi);
      const uint64_t da = sw128_desc(sm.abuf() + ks * BOX), db = sw128_desc(sm.slot(s));
      wgmma_fence();
      #pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)
        wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();                   // box prev's products are done
        arrive(&sm.empty()[prev]);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    arrive(&sm.empty()[prev]);
  }

  // a chunk past the block's range: its boxes are consumed without a product
  __device__ __forceinline__ void skip1() {
    for (int ks = 0; ks < D / KB; ++ks, wi += NC) arrive(&sm.empty()[wait_w(wi)]);
  }

  // acc = q(f) . (the warpgroup's W2 columns)^T over F: a K step's UP boxes
  // of 64 rows (every NC-th of the step's NC UP), unit pair u in box u
  // (m64n64k32), an odd last unit in the first 32 rows of its box
  // (m64n32k32)
  __device__ __forceinline__ void product2(int (&acc)[UP][32]) {
    uint32_t prev[UP], aprev = 0;
    for (int ks = 0; ks < p.F / KB; ++ks, wi += NC * UP, ++ai) {
      uint32_t s[UP];
      #pragma unroll
      for (int b = 0; b < UP; ++b) s[b] = wait_w(wi + NC * b);
      const uint32_t a = wait_a(ai);
      const uint64_t da = sw128_desc(sm.abuf() + a * BOX);
      wgmma_fence();
      #pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk) {
        const int sd = ks > 0 || kk > 0;
        #pragma unroll
        for (int u = 0; u < UP; ++u) {
          const uint64_t db = sw128_desc(sm.slot(s[u])) + 2 * kk;
          if (2 * u + 1 < U && (EVEN || 2 * u + 2 <= cnt))
            wgmma_m64n64k32_s8(acc[u], da + 2 * kk, db, sd);
          else if (EVEN || 2 * u + 1 <= cnt)
            wgmma_m64n32k32_s8(reinterpret_cast<int (&)[16]>(acc[u]), da + 2 * kk, db, sd);
        }
      }
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        #pragma unroll
        for (int b = 0; b < UP; ++b) arrive(&sm.empty()[prev[b]]);
        arrive(&sm.aempty()[aprev]);
      }
      #pragma unroll
      for (int b = 0; b < UP; ++b) prev[b] = s[b];
      aprev = a;
    }
    wgmma_wait<0>();
    #pragma unroll
    for (int u = 0; u < UP; ++u) fence_acc(acc[u]);
    #pragma unroll
    for (int b = 0; b < UP; ++b) arrive(&sm.empty()[prev[b]]);
    arrive(&sm.aempty()[aprev]);
  }

  // the rows' totals of v (the thread's parts of rows r0, r0 + 8): the
  // quad's, then the warpgroups' in order through one exchange buffer, then
  // (a pair) the peer block's through distributed shared memory
  template <bool MAX>
  __device__ __forceinline__ void exchange(float (&v)[2]) {
    const int t = tid(), lane = t & 31, r0 = row_of(t);
    float* red = sm.red(x++);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float q = MAX ? quad_max(v[h]) : quad_sum(v[h]);
      if ((lane & 3) == 0) red[g * ROWS + r0 + 8 * h] = q;
    }
    warps_bar_sync(XBAR, CT);
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = red[r0 + 8 * h];
      #pragma unroll
      for (int w = 1; w < NC; ++w)
        t = MAX ? fmaxf(t, red[w * ROWS + r0 + 8 * h]) : __fadd_rn(t, red[w * ROWS + r0 + 8 * h]);
      v[h] = t;
    }
    if constexpr (CL == 2) {
      // buffer k & 1: the peer writes exchange k + 2 into it only after this
      // block's exchange k + 1, past the barrier above that every thread
      // reaches after reading exchange k
      const int k = cxn & 1;
      const uint32_t parity = (cxn >> 1) & 1, peer = sh.rank ^ 1;
      ++cxn;
      if (g == 0) {
        if ((lane & 3) == 0) {
          #pragma unroll
          for (int h = 0; h < 2; ++h) st_peer(peer_addr(sm.cx(k) + r0 + 8 * h, peer), v[h]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive_peer(peer_addr(&sm.cbar()[k], peer));
      }
      wait_phase_cluster(&sm.cbar()[k], parity);
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float o = sm.cx(k)[r0 + 8 * h];
        v[h] = MAX ? fmaxf(v[h], o) : __fadd_rn(v[h], o);   // the same in both blocks
      }
    }
  }

  // the f32 GELU values at accumulators a0, a1 of a row with q(h) scale
  // hs, columns c, c + 1
  __device__ __forceinline__ float2 gelu2(int a0, int a1, float hs, int c) const {
    const float2 s1 = *reinterpret_cast<const float2*>(p.s1 + c);
    const float2 b1 = *reinterpret_cast<const float2*>(p.b1 + c);
    return make_float2(gelu_tanh(dequant(a0, hs, s1.x, b1.x)),
                       gelu_tanh(dequant(a1, hs, s1.y, b1.y)));
  }

  __device__ __forceinline__ void run() {
    const int F = p.F;
    // one accumulator array for every product: ptxas keeps each array that
    // a wgmma writes in registers of its own for the whole kernel, so
    // separate arrays for the passes and the W2 product spilled
    int acc[UP][32];
    for (int tile = sh.first; tile < p.tiles; tile += sh.step) {
      const int row0 = tile * ROWS;
      if (p.bf16)
        ac_i8h::quant_rows<CT, false>(static_cast<const __nv_bfloat16*>(p.h), p.M, D, row0, tid(),
                                      sm.abuf(), sm.cs());
      else
        ac_i8h::quant_rows<CT, false>(static_cast<const float*>(p.h), p.M, D, row0, tid(),
                                      sm.abuf(), sm.cs());
      fence_proxy_async();                 // q(h)'s writes before the wgmmas read them
      warps_bar_sync(XBAR, CT);
      float hsc[2];
      #pragma unroll
      for (int h = 0; h < 2; ++h) hsc[h] = sm.cs()[row_of(tid()) + 8 * h];

      // pass 1: each row's max |f| over F
      float fsc[2] = {0.f, 0.f};
      for (int pr = 0; pr < sh.groups1; ++pr) {
        const int ch = sh.ch0 + NC * pr + g;
        if (ch >= sh.ch1) {
          skip1();
          continue;
        }
        product1(acc[0]);
        const int cb = ch * BN + 2 * (tid() & 3);
        #pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 f = gelu2(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1], hsc[h],
                                   cb + 8 * j);
            fsc[h] = fmaxf(fsc[h], fmaxf(fabsf(f.x), fabsf(f.y)));
          }
      }
      exchange<true>(fsc);
      float frc[2];
      #pragma unroll
      for (int h = 0; h < 2; ++h) fsc[h] = row_scale<false>(fsc[h]), frc[h] = __frcp_rn(fsc[h]);

      // pass 2: the same values, quantized straight into the slot's q(f)
      for (int pr = 0; pr < sh.groups1; ++pr) {
        const int ch = sh.ch0 + NC * pr + g;
        if (ch >= sh.ch1) {
          skip1();
          continue;
        }
        product1(acc[0]);
        const int t = tid(), cb = ch * BN + 2 * (t & 3);
        int8_t* qrow = p.qf + ((size_t)sh.slot * ROWS + row_of(t)) * F;
        #pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = cb + 8 * j;
            const float2 f = gelu2(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1], hsc[h], c);
            *reinterpret_cast<uint16_t*>(qrow + (size_t)(8 * h) * F + c) =
                (uint16_t)((quant_rcp(f.x, fsc[h], frc[h]) & 0xff) |
                           ((quant_rcp(f.y, fsc[h], frc[h]) & 0xff) << 8));
          }
      }
      // q(f) stored before any TMA of the cluster reads it, and q(h)'s
      // products done before q(f) boxes land over it
      fence_proxy_async_global();
      warps_bar_sync(XBAR, CT);
      if (tid() == 0) {
        mbar_arrive(sm.qf_ready());
        if constexpr (CL == 2) mbar_arrive_peer(peer_addr(sm.qf_ready(), sh.rank ^ 1));
      }

      // y = q(f) @ W2 * s_f * s2 + b2 + h over the warpgroup's columns, kept
      // in registers through LayerNorm 2.  Element (u, j) of the thread's:
      // unit 2 u + j / 4, column c0 + 64 u + 8 j + 2 q.
      int t = tid();
      int c0 = sh.dbase + g * U * 32 + 2 * (t & 3), rr = row0 + row_of(t);
      auto live = [&](int u, int j) {
        const int unit = 2 * u + (j >> 2);
        return unit < U && (EVEN || unit < cnt);
      };
      // y replaces each sum in its accumulator register (as its bits)
      auto y = [&](int u, int e) { return __int_as_float(acc[u][e]); };
      float v[2] = {0.f, 0.f};
      {
        product2(acc);
        // JG column pairs' loads (2 rows each) are issued together; the
        // compiler barrier keeps the next group's behind them, so the loads
        // in flight fit the registers beside y
        #pragma unroll
        for (int u = 0; u < UP; ++u)
          #pragma unroll
          for (int j0 = 0; j0 < 8; j0 += JG) {
            if (!live(u, j0)) continue;
            float2 s2[JG], b2[JG], hv[JG][2];
            #pragma unroll
            for (int j = 0; j < JG; ++j) {
              const int c = c0 + 64 * u + 8 * (j0 + j);
              s2[j] = *reinterpret_cast<const float2*>(p.s2 + c);
              b2[j] = *reinterpret_cast<const float2*>(p.b2 + c);
              #pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = rr + 8 * h;
                hv[j][h] = r < p.M ? load2(p.h, p.bf16, (size_t)r * D + c)
                                   : make_float2(0.f, 0.f);
              }
            }
            #pragma unroll
            for (int j = 0; j < JG; ++j)
              #pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int e = 4 * (j0 + j) + 2 * h;
                const float y0 = __fadd_rn(dequant(acc[u][e], fsc[h], s2[j].x, b2[j].x),
                                           hv[j][h].x);
                const float y1 = __fadd_rn(dequant(acc[u][e + 1], fsc[h], s2[j].y, b2[j].y),
                                           hv[j][h].y);
                acc[u][e] = __float_as_int(y0);
                acc[u][e + 1] = __float_as_int(y1);
                v[h] = __fadd_rn(v[h], __fadd_rn(y0, y1));
              }
            asm volatile("" ::: "memory");
          }
      }
      // LayerNorm 2 over all D columns: the rows' sums, then their squared
      // deviations from the mean
      exchange<false>(v);
      t = tid();
      c0 = sh.dbase + g * U * 32 + 2 * (t & 3);
      rr = row0 + row_of(t);
      const float fD = (float)D, rD = __frcp_rn(fD);
      float mean[2], inv[2];
      #pragma unroll
      for (int h = 0; h < 2; ++h) mean[h] = ac_int8::div_rcp(v[h], fD, rD), v[h] = 0.f;
      #pragma unroll
      for (int u = 0; u < UP; ++u)
        #pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!live(u, j)) continue;
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d0 = __fsub_rn(y(u, 4 * j + 2 * h), mean[h]);
            const float d1 = __fsub_rn(y(u, 4 * j + 2 * h + 1), mean[h]);
            v[h] = __fadd_rn(v[h], __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
          }
        }
      exchange<false>(v);
      #pragma unroll
      for (int h = 0; h < 2; ++h)
        inv[h] = __frcp_rn(__fsqrt_rn(__fadd_rn(ac_int8::div_rcp(v[h], fD, rD), p.eps)));
      #pragma unroll
      for (int u = 0; u < UP; ++u)
        #pragma unroll
        for (int j0 = 0; j0 < 8; j0 += JG) {
          if (!live(u, j0)) continue;
          float2 gg[JG], bb[JG];
          #pragma unroll
          for (int j = 0; j < JG; ++j) {
            const int c = c0 + 64 * u + 8 * (j0 + j);
            gg[j] = *reinterpret_cast<const float2*>(p.g + c);
            bb[j] = *reinterpret_cast<const float2*>(p.beta + c);
          }
          #pragma unroll
          for (int j = 0; j < JG; ++j) {
            const int c = c0 + 64 * u + 8 * (j0 + j);
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rr + 8 * h, e = 4 * (j0 + j) + 2 * h;
              if (r >= p.M) continue;
              store2(p.out, p.bf16, (size_t)r * D + c,
                     ln(y(u, e), mean[h], inv[h], gg[j].x, bb[j].x),
                     ln(y(u, e + 1), mean[h], inv[h], gg[j].y, bb[j].y));
            }
          }
          asm volatile("" ::: "memory");
        }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ffn_kernel(const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
           const __grid_constant__ CUtensorMap mqf, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int CL = Cfg<D>::CL;
  if (threadIdx.x == 0) {
    const Smem<D> sm(smem_raw);
    for (int i = 0; i < MAX_STAGES; ++i) {
      mbar_init(&sm.full()[i], 1);
      mbar_init(&sm.empty()[i], 4);        // the consuming warpgroup's warps
    }
    for (int i = 0; i < MAX_A; ++i) {
      mbar_init(&sm.afull()[i], 1);
      mbar_init(&sm.aempty()[i], CT / 32); // every consumer warp
    }
    mbar_init(sm.qf_ready(), CL);          // a thread of each block of the cluster
    for (int i = 0; i < 2; ++i) mbar_init(&sm.cbar()[i], 4);   // the peer's warpgroup 0
    mbar_fence_init();
  }
  // the barriers initialised before any block of the cluster arrives on them
  if constexpr (CL == 2) cluster_sync();
  else __syncthreads();
  if (threadIdx.x >= CT) {
    if (threadIdx.x == CT) produce_weights<D>(&mw1, &mw2, p);
    else if (threadIdx.x == CT + 32) produce_qf<D>(&mqf, p);
  } else {
    const Smem<D> sm(smem_raw);
    const Share<D> sh(p);
    Consumer<D> cn(p, sm, sh);
    cn.run();
  }
  // no block leaves while its peer may still write to its shared memory
  if constexpr (CL == 2) cluster_sync();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void* h;
  const void *w1map, *w2map;               // host copies of the weights' tensor maps
  const float *s1, *b1, *s2, *b2, *g, *beta;
  float eps;
  void* qf;                                // scratch_bytes(M, D, F) bytes
  void* out;
  int M, D, F;
  bool bf16;
  cudaStream_t stream;
  int* info;                               // set: report the instantiation
  long long* scratch;                      // set: report the scratch bytes
};

// The clusters of instantiation D that fit a device at once (blocks, for
// one block a tile), after checking its shared memory fits.
template <int D>
cudaError_t make_plan(int device, int* clusters) {
  constexpr int CL = Cfg<D>::CL, SMEM = Cfg<D>::TOTAL;
  auto* kernel = ffn_kernel<D>;
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (SMEM > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  if (CL == 1) {
    *clusters = sms;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(sms / CL * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return *clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <int D>
cudaError_t launch(const Args& a) {
  constexpr int CL = Cfg<D>::CL, SMEM = Cfg<D>::TOTAL;
  auto* kernel = ffn_kernel<D>;
  static PerDevice<int> plans;
  int fit = 0;
  cudaError_t err = plans.get(&fit, make_plan<D>);
  if (err != cudaSuccess) return err;
  const int tiles = (a.M + ROWS - 1) / ROWS;
  const int clusters = min(tiles, fit);
  if (a.scratch) {
    *a.scratch = (long long)clusters * ROWS * a.F;
    return cudaSuccess;
  }
  if (a.info) {
    err = ac_common::kernel_info(kernel, SMEM, THREADS, a.info);
    a.info[5] = ROWS;
    a.info[6] = NC;
    a.info[7] = CL;
    a.info[8] = clusters * CL;
    return err;
  }
  auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  if (!aligned(a.h) || !aligned(a.out) || !aligned(a.qf)) return cudaErrorInvalidValue;
  Params p;
  p.h = a.h;
  p.s1 = a.s1, p.b1 = a.b1, p.s2 = a.s2, p.b2 = a.b2, p.g = a.g, p.beta = a.beta;
  p.eps = a.eps;
  p.qf = static_cast<int8_t*>(a.qf);
  p.out = a.out;
  p.M = a.M, p.F = a.F;
  p.tiles = tiles;
  p.bf16 = a.bf16;
  CUtensorMap mw1, mw2, mqf;
  memcpy(&mw1, a.w1map, sizeof mw1);
  memcpy(&mw2, a.w2map, sizeof mw2);
  err = ac_i8h::bytes_map(&mqf, a.qf, (long long)clusters * ROWS, a.F);
  if (err != cudaSuccess) return err;
  if (CL == 1) {
    kernel<<<clusters, THREADS, SMEM, a.stream>>>(mw1, mw2, mqf, p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mw1, mw2, mqf, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the instantiation for width D (the envelope's eight)
cudaError_t dispatch(const Args& a) {
  switch (a.D) {
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    case 384: return launch<384>(a);
    case 512: return launch<512>(a);
    case 640: return launch<640>(a);
    case 768: return launch<768>(a);
    case 896: return launch<896>(a);
    case 1024: return launch<1024>(a);
    default: return cudaErrorInvalidValue;
  }
}

long long smem_bytes(int D) {
  switch (D) {
    case 128: return Cfg<128>::TOTAL;
    case 256: return Cfg<256>::TOTAL;
    case 384: return Cfg<384>::TOTAL;
    case 512: return Cfg<512>::TOTAL;
    case 640: return Cfg<640>::TOTAL;
    case 768: return Cfg<768>::TOTAL;
    case 896: return Cfg<896>::TOTAL;
    case 1024: return Cfg<1024>::TOTAL;
    default: return -1;
  }
}

}  // namespace b3

bool envelope(int M, int D, int F) {
  return M > 0 && D > 0 && F > 0 && D % 128 == 0 && F % 128 == 0 && D <= b3::MAX_D;
}

const float* f32(const void* p) { return static_cast<const float*>(p); }
const int8_t* i8(const void* p) { return static_cast<const int8_t*>(p); }

int run_b3(const b3::Args& a) {
  if (!envelope(a.M, a.D, a.F)) return (int)cudaErrorInvalidValue;
  return (int)b3::dispatch(a);
}

int run_b8(const ac_i8h::Args& a) {
  if (!envelope(a.M, a.D, a.F)) return (int)cudaErrorInvalidValue;
  return (int)ac_i8h::launch(a);
}

}  // namespace

// Shared memory a block of B3 (oproj = 0) or of B8 (oproj = 1) takes at
// width D, whatever F; -1 for a width B3 does not take.
extern "C" long long ac_ffn_block_int8_smem_bytes(int D, int oproj) {
  if (oproj) return (long long)ac_i8h::Layout(ac_i8h::a_width(D)).total;
  return b3::smem_bytes(D);
}

// Bytes of the device scratch that ac_attn_ffn_block_int8 takes for M
// rows at widths D, F on the current device: a slot of 64 rows for each
// block of its grid (one an SM, at most one a 64-row tile), each slot f32
// [64, D] and [64, F] and int8 [64, F]; 0 where the device cannot be read.
extern "C" long long ac_attn_ffn_block_int8_scratch_bytes(int M, int D, int F) {
  return (long long)ac_i8h::scratch_bytes(M, D, F);
}

// Bytes of the int8 q(f) scratch that ac_ffn_block_int8 takes for M rows at
// widths D, F on the current device (64 x F bytes for each tile in flight:
// a block's, or a pair's); -1 outside the envelope or where the device
// cannot be read.
extern "C" long long ac_ffn_block_int8_scratch_bytes(int M, int D, int F) {
  long long n = -1;
  b3::Args a = {};
  a.M = M, a.D = D, a.F = F;
  a.scratch = &n;
  return run_b3(a) == 0 ? n : -1;
}

// B3.  dtype: 0 = float32, 1 = bfloat16 (of h and out).  h, out [M, D];
// w1map and w2map host copies (128 bytes each) of the tensor maps of W1's
// and W2's K-contiguous copies ([F, D] and [D, F] int8) made by
// ac_int8_weight_map; s1, b1 [F], s2, b2, g, beta [D] f32; qf a device
// scratch of ac_ffn_block_int8_scratch_bytes(M, D, F) bytes the kernel
// overwrites; all on the current device, h, out and qf 16-byte aligned;
// D % 128 == 0, D <= 1,024, F % 128 == 0.  Returns the launch's
// cudaError_t.
extern "C" int ac_ffn_block_int8(const void* h, const void* w1map, const void* s1,
                                 const void* b1, const void* w2map, const void* s2,
                                 const void* b2, const void* g, const void* beta,
                                 float eps, void* qf, void* out, int M, int D, int F, int dtype,
                                 void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return run_b3({h, w1map, w2map, f32(s1), f32(b1), f32(s2), f32(b2), f32(g), f32(beta), eps,
                 qf, out, M, D, F, dtype == 1, static_cast<cudaStream_t>(stream), nullptr,
                 nullptr});
}

// B8.  dtype as above, of ctx, x and out [M, D]; wot [D, D], w1t [F, D] and
// w2t [D, F] int8: Wo, W1 and W2 transposed (K contiguous), each 16-byte
// aligned; so, bo, g1, be1 (LayerNorm after attention), s2, b2, g2, be2
// (after the FFN) [D] and s1, b1 [F] f32; hs a device scratch of
// ac_attn_ffn_block_int8_scratch_bytes(M, D, F) bytes (16-byte aligned) the
// kernel overwrites; all contiguous on the current device; D % 128 == 0,
// D <= 1,024, F % 128 == 0.  Returns the launch's cudaError_t.
extern "C" int ac_attn_ffn_block_int8(const void* ctx, const void* x, const void* wot,
                                      const void* so, const void* bo, const void* g1,
                                      const void* be1, const void* w1t, const void* s1,
                                      const void* b1, const void* w2t, const void* s2,
                                      const void* b2, const void* g2, const void* be2,
                                      float eps, void* hs, void* out, int M, int D, int F,
                                      int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return run_b8({ctx, x, i8(wot), i8(w1t), i8(w2t), f32(so), f32(bo), f32(g1), f32(be1),
                 f32(s1), f32(b1), f32(s2), f32(b2), f32(g2), f32(be2), eps, hs, out, M, D, F,
                 dtype == 1, static_cast<cudaStream_t>(stream), nullptr});
}

// The kernel ac_ffn_block_int8 (oproj = 0) or ac_attn_ffn_block_int8
// (oproj = 1) would launch for M rows at widths D, F: info[9] = registers
// per thread, shared bytes per block, threads per block, blocks resident
// per SM, local (spill) bytes per thread, rows a tile, consumer
// warpgroups, blocks a tile (a cluster), blocks of the launch.  Launches
// nothing.
extern "C" int ac_ffn_block_int8_info(int M, int D, int F, int oproj, int* info) {
  if (oproj) {
    ac_i8h::Args a = {};
    a.M = M, a.D = D, a.F = F;
    a.info = info;
    return run_b8(a);
  }
  b3::Args a = {};
  a.M = M, a.D = D, a.F = F;
  a.info = info;
  return run_b3(a);
}
