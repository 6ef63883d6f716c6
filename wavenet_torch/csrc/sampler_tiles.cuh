// The tiles decode kernel: whole-network autoregressive WaveNet decode, one
// launch per generation, for batches of b121 and up at the paper/gc widths,
// for NVIDIA Hopper (sm_90a): a thread-block cluster holds the layer chain's
// weights in shared memory, and each CTA runs its products as register-tiled
// outer products over tens of rows at once. sampler_tiles.cu is its float32
// mode (and the route's device queries), sampler_tiles_bf16.cu its bf16-weight
// mode, sampler_tiles_ring16.cu and sampler_tiles_bf16_ring16.cu the two at a
// bf16 ring (the template parameter ST, the JAX kernels' state_dtype: each
// past row widened exactly as it is read, each layer's float32 input
// rounded to nearest even as it goes to the ring, four values an 8-byte
// store; sampler_step.cuh's ring_load, ring_store4), each its own library.
// The ring stays in device memory, so both ring types take one plan.
//
// Replaces the JAX package's large-batch decode kernels, which stream the
// weights from HBM with the ring in HBM rows or quad-packed:
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed
// (both at weight_dtype float32 and bfloat16) and computes exactly what
// sampler_decode.cu computes for mu-law inputs (see its header for the step,
// the forced prefix, the logits window, resume from ring, causal register
// and t0, and the Philox4x32-10 noise keyed on (class block, row, absolute
// step), whose code and uniform-to-Gumbel map it takes from
// sampler_step.cuh). decode_reference is its plain version.
//
// One compiled shape: R = D = 32, S = 512, Q = 256, mu-law input (causal
// register width KC = Q), filter width 2, no LC, 8 <= L <= 32, clusters of
// CS = 8 CTAs; float32 or bf16 weights (WT). Anything else is refused at
// launch with cudaErrorInvalidValue; sampler_decode covers it.
//
// What bounds it. A row-step is 2.08 MFLOP; b512 is 1.06 GFLOP, 15.9 us at
// the FP32 peak (67 TFLOP/s), so at these batches the step is bound by FP32
// operations on paper, by 4.3 MB of weights in practice: sampler_decode
// runs 8 rows a block and every block streams every weight from L2 on every
// step (270-540 MB of L2 reads a b512 step), behind a chain of ~60 dependent
// products. sampler_cluster keeps the chain's weights in a cluster's shared
// memory but spends ~11 KB of it a row and reloads a row's activation for
// every FMA, so it tops out near 13 rows a cluster and ~0.009 ms a row.
// The design here:
//
// * Layout. One cluster of 8 CTAs serves RB rows (RB = ceil(B / 15) on an
//   H100, which keeps 15 clusters of 8 resident: 35 rows at b512). CTA k
//   owns the layers [layer_begin[k], layer_begin[k+1]) of layer_split(L, 8)
//   and copies their filter/gate [2R, 2D] and dense [D, R] weights into its
//   shared memory once per launch (4 layers, 82 KB), as floats. The rows run
//   padded to RBP = 8 * RT, RT = max(2, ceil(RB / 8)) rows a thread (the
//   template parameter, 2..5). RB <= 35, the rows a cluster of b512 on an
//   H100 and the largest timed beside sampler_decode (B <= 525 on an H100).
// * Register tiles, no K split. Each thread owns a tile of rows x output
//   columns and walks K in order, so each weight and activation it loads
//   from shared memory feeds several FMAs and there is no shuffle tree on
//   the chain:
//     filter/gate  [RBP x 2R] @ [2R x 2D]: one filter and its gate column,
//                  RT rows (2 RT outputs); the activation tanh(f) *
//                  sigmoid(g) is formed in the thread that owns both;
//     dense        [RBP x D] @ [D x R]: one column, RT rows;
//     skip         [RBP x 4D] @ [4D x S]: 8 columns, 2 RT rows (the
//                  partial [RB, S] lives in registers, 16 RT floats a
//                  thread); skip_w comes from L2 through a ring of 4 tiles
//                  of 8 KB in X (free until the partial), by cp.async;
//     post1/post2  the CTA's S/8 and Q/8 columns, [RBP x S] @ [S x 64] and
//                  @ [S x 32]: two columns or one, RT rows; the weights
//                  come from L2 through a ring of 4 tiles of 4 KB in shared
//                  memory, filled by cp.async (one 16-byte copy a thread a
//                  tile), 3 tiles ahead of the product, the first issued
//                  before the cluster waits for the skip partials. With
//                  one batch of loads in flight a thread, each of the 32 +
//                  16 batches (float32) waited for a round trip to L2 (~53k
//                  of a b512 step's ~280k SM clocks, at every batch size).
//   Activation rows are padded (row strides = 4 mod 32 floats), so the 8
//   rows a warp reads at once fall in distinct banks.
// * Hand-off: after its layers CTA k stores the residual [RBP, R] into CTA
//   k+1's shared memory with 16-byte st.async that complete on an mbarrier
//   there. The ring rows of a CTA's layers are read at the start of the step
//   (their addresses do not depend on the data), before the CTA waits, and
//   the GC/bias adds of its rows are prefetched into registers then too;
//   each layer's input replaces its ring row in `past` once the fg product
//   has read it, and goes to the ring after the hand-off, off the chain.
// * Skip and head, through one [RBP, S] buffer X a CTA, aliased across
//   cluster barriers: (1) each CTA writes its skip partial to X; barrier;
//   (2) CTA k adds the 8 partials of its S/8 columns in rank order through
//   distributed shared memory, + skip_b, relu; barrier; (3) it stores that
//   slice of h1 into every CTA's X (all-gather); barrier; (4) post1 on its
//   S/8 columns; barrier; (5) all-gather of h2 into X; barrier; (6) post2 on
//   its Q/8 classes, their Gumbel noise and each row's best class, sent to
//   CTA 0; barrier; CTA 0 takes the best of the 8 (ties to the lowest
//   class), emits the code and starts the next step.
// * Inside a launch the mu-law causal register is kept as the previous
//   code (its product with causal_w is that code's row); the register the
//   launch starts from is multiplied in full once, and the one-hot of the
//   last input is written back to `causal` in its contract layout at the
//   end, for resume.
//
// bf16 mode (WT = __nv_bfloat16; the JAX kernels at weight_dtype=bfloat16):
// the six matmul weights are bf16 and every product multiplies float32
// values, sums included, as in the float32 mode. The layer weights are
// widened to float as they are copied into shared memory (exact), so the
// carve-up, RB and the layer split are the float32 mode's. The streamed
// weights stay bf16 through their cp.async tiles and are widened in
// registers where the product reads them; a tile keeps its bytes and holds
// twice the K-rows (skip 8, post1 32, post2 64), so a step waits half the
// L2 round trips of the float32 mode (16 + 8 tile batches) and each lane
// loads half the weight bytes from shared memory. causal_w rows are read
// as bf16 and widened. Each product's activation operand is rounded to bf16
// (to nearest even, sampler_step.cuh's opnd) at the JAX kernels' points:
// the causal window and the head's inputs h1 and h2 always (h1 where it is
// formed, h2 where it is staged), the layer chain's inputs where
// DecodeArgsT::round_chain is set (the host clears it on the prefill route
// at B = 1). The ring, the causal register, the residual and every sum stay
// float32, so the chain's operands are rounded into copies or where they
// are only operands: a ring row as it is loaded into `past` (its slot is
// overwritten with the layer's unrounded input after the fg product, and
// that goes to the ring); the residual `cur` into a rounded shadow `curr`
// (it is state: handed on and summed unrounded), written wherever `cur` is
// (its arrival by the hand-off, CTA 0's causal step, each dense epilogue)
// and read by the fg product; a layer's activation where it is stored into
// `outs`, which only dense and skip read. `curr` lives in X, which nothing
// touches during a CTA's chain (the skip ring and the head's all-gathers
// come after it, behind its own barriers), so the carve-up is unchanged.
// Rounding `cur` at every fg load instead cost the gc b512 step 16% (fg
// +54%, by the probe of tools/tiles_variants.py on an H100).
//
// What bounds it now (the probe of tools/tiles_variants.py on an H100): a
// gc b512 step is ~267k SM clocks, ~7.5x an SM's share of the FP32 work
// at its peak (9.1 MFLOP, ~35k clocks). The chain
// takes ~55% (each CTA waits for the one before it: CTA k's 4 layers run
// while 7 SMs of the cluster have nothing of the chain to do), the
// second-to-last CTA's skip product ~18%, the head ~17%, barriers and
// all-gathers ~10%; and every product is bound by the bytes each lane
// loads from shared memory (a broadcast costs as much as any load), which
// the ~10 outputs a thread can hold cap. Row sub-tiles pipelined along
// the chain are the next step (ROADMAP).
//
// Carve-up of one CTA's dynamic shared memory (floats unless said; mirrored
// by tile_smem_bytes in kernels/sampler.py, held against
// sampler_tiles_smem_bytes of both libraries by the GPU tests):
//   16 bytes      mbarrier of the hand-off
//   wfg  [4][2R][D][2]   filter/gate weights, (filter, gate) pairs
//   wd   [4][R][D+4]     dense weights, K inner
//   dadd [4][R]          dense bias
//   X    [RBP][516]      skip partial, h1, h2 (launch start: the causal
//                        register [RBP][KC]; bf16, during the chain: curr
//                        [RBP][36], cur rounded)
//   past [RBP][132]      ring rows of the CTA's layers (head: h2 slice)
//   outs [RBP][132]      the layers' activations   } head: the ring of
//   cur  [RBP][36]       the residual              } tiles, [4][1024]
//                        (the larger of the two)
//   lg   [RBP][32]       this CTA's logits
//   cand [8][RBP] float + [8][RBP] int   candidates (CTA 0)
//   xin, xprev [RBP] int; meta [8] int
// 145,584 bytes at RBP = 16, 223,088 at RBP = 40 (RB 33-35).
//
// Sums have a fixed order that depends on neither RB nor B: each chain
// product adds its K terms in order; the skip partial adds a CTA's layers
// and their K terms in order, and the CTAs' partials in rank order; the
// head adds K in order. So same-seed runs, a row at b128 against the same
// row at b512, and resumed segments against one run are bitwise equal, in
// either mode. The values differ from sampler_decode's and sampler_cluster's
// in the last bits (other orders). Plain FP32 FMAs, no tensor cores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_ptx.cuh"
#include "sampler_step.cuh"

namespace cg = cooperative_groups;

namespace {

// The compiled shape.
constexpr int kR = 32, kD = 32, kS = 512, kQ = 256, kKC = 256, kCS = 8;
constexpr int kNL = 4;                  // most layers a CTA owns
constexpr int kMaxRows = 35;            // the rows of b512 on an H100
constexpr int kFg = 2 * kR * 2 * kD;    // floats of one layer's fg weights
constexpr int kDS = kD + 4;             // dense weights: [R][kDS], K inner
constexpr int kDense = kR * kDS;
constexpr int kXS = kS + 4;             // row strides, = 4 mod 32
constexpr int kPS = kNL * kR + 4;
constexpr int kCurS = kR + 4;
constexpr int kSl = kS / kCS, kQl = kQ / kCS;   // a CTA's head columns
// Weights streamed from L2 through rings of tiles in shared memory: the
// head's post1/post2 tiles of 4 KB, kStages of them (4 timed a little
// faster than 8 on an H100), and skip_w's tiles of 8 KB (kSkipRows K-rows
// of float32 weights), kSkipRing of them. A tile of bf16 weights holds
// twice the K-rows in the same bytes (Tile<WT>).
constexpr int kStages = 4;
constexpr int kTile = 1024;             // floats of a head tile
constexpr int kSkipRows = 4, kSkipTile = kSkipRows * kS, kSkipRing = 4;
static_assert(kSkipRing * kSkipTile <= 16 * kXS,
              "the skip ring fits X at the fewest rows (16)");

// The streamed tiles' geometry for WT weights: kW weights in a float's
// bytes, kPer in a 16-byte copy, and the K-rows of a skip, post1 and post2
// tile.
template <typename WT>
struct Tile {
  static constexpr int kW = (int)(sizeof(float) / sizeof(WT));
  static constexpr int kPer = 4 * kW;
  static constexpr int kSkipK = kSkipRows * kW;
  static constexpr int kPost1K = kTile / kSl * kW;
  static constexpr int kPost2K = kTile / kQl * kW;
};

// Phase probe (built by tiles_variants.py with -DSAMPLER_TILES_PROBE):
// thread 0 of each CTA of the first cluster adds the SM clocks of each
// phase of every step to g_phase_cycles[rank][phase]. Without the macro,
// PHASE compiles to nothing.
enum Phase {
  kWait, kFgProduct, kFgSync, kDenseProduct, kDenseSync,
  kSkipProduct, kBarrier1, kSkipSum, kGatherH1, kPost1, kGatherH2, kPost2,
  kGumbel, kPick, kPhases
};
#ifdef SAMPLER_TILES_PROBE
__device__ unsigned long long g_phase_cycles[kCS][kPhases];
#define PHASE(k)                                                   \
  do {                                                             \
    if (tid == 0 && blockIdx.x < kCS) {                            \
      const long long now = clock64();                             \
      g_phase_cycles[rank][k] += (unsigned long long)(now - tprev); \
      tprev = now;                                                 \
    }                                                              \
  } while (0)

// The probe's clocks, [kCS][kPhases]: read (and zero) them.
int read_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                       sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[kCS][kPhases] = {};
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#else
#define PHASE(k) ((void)0)
#endif

template <typename WT>
struct TileArgs {
  DecodeArgsT<WT> a;
  int rb;                         // rows a cluster
  int layer_begin[kCS + 1];
};

// Rows a thread: the template parameter for rb rows a cluster.
inline int rows_per_thread(int rb) { return rb <= 16 ? 2 : (rb + 7) / 8; }

// Floats of outs and cur, which the head's tiles reuse.
__host__ __device__ constexpr int stage_floats(int rbp) {
  return rbp * (kPS + kCurS) > kStages * kTile ? rbp * (kPS + kCurS)
                                                : kStages * kTile;
}

size_t tiles_smem_bytes(int rb) {
  const int rbp = 8 * rows_per_thread(rb);
  const size_t per_cta = kNL * ((size_t)kFg + kDense + kR) + 2 * kNL;
  const size_t per_row = kXS + kPS + kQl + 2 * kCS + 2;
  return 16 + 4 * (per_cta + rbp * per_row + stage_floats(rbp));
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A weight as the float a product multiplies.
__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

// The two bf16 weights of a 32-bit word, widened (the first in the low half).
__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Eight consecutive weights in shared memory (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = lo_bf16(v.x), w[1] = hi_bf16(v.x), w[2] = lo_bf16(v.y);
  w[3] = hi_bf16(v.y), w[4] = lo_bf16(v.z), w[5] = hi_bf16(v.z);
  w[6] = lo_bf16(v.w), w[7] = hi_bf16(v.w);
}

// Two consecutive weights in shared memory (aligned to their pair).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(lo_bf16(v), hi_bf16(v));
}

// Four activations as a product's operands (opnd<WT> of each).
template <typename WT>
__device__ __forceinline__ float4 opnd4(const float4& v, bool rnd) {
  return make_float4(opnd<WT>(v.x, rnd), opnd<WT>(v.y, rnd),
                     opnd<WT>(v.z, rnd), opnd<WT>(v.w, rnd));
}

// 16 bytes from global to shared memory, asynchronously (cp.async groups).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Tile s of n into its slot of a ring of kRing tiles of kFloats floats,
// as one cp.async group (empty past the last tile).
template <int kRing, int kFloats, typename Copy>
__device__ __forceinline__ void issue_tile(int s, int n, float* ring,
                                           Copy copy) {
  if (s < n) copy(s, ring + (s % kRing) * kFloats);
  cp_async_commit();
}

// 16 bytes at `addr` in another CTA's shared memory; they complete on the
// mbarrier at `remote_bar` in that CTA.
__device__ __forceinline__ void st_async_v4(uint32_t addr, const float4& v,
                                            uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(remote_bar)
      : "memory");
}

template <int RT, typename WT, typename ST = float>
__global__ void __launch_bounds__(kThreads, 1)
sampler_tiles_kernel(const TileArgs<WT> ta) {
  constexpr int RBP = 8 * RT;
  constexpr bool kBf16 = !std::is_same<WT, float>::value;
  using T = Tile<WT>;
  cg::cluster_group cluster = cg::this_cluster();
  const DecodeArgsT<WT>& a = ta.a;
  // bf16 weights: whether the layer chain's inputs are rounded (the causal
  // window and the head's inputs always are).
  const bool rc = a.round_chain != 0;
  const int rank = (int)cluster.block_rank();
  const int l0 = ta.layer_begin[rank];
  const int nl = ta.layer_begin[rank + 1] - l0;
  const int L = a.L, B = a.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x / kCS) * ta.rb;
  const int nrows = min(ta.rb, B - row0);       // rows of this cluster
  const int* forced = static_cast<const int*>(a.forced);
  // The chain's tiles: rows rgl + 8 i (i < RT); filter/gate column d (and
  // its gate), dense column d.
  const int rgl = lane >> 2;
  const int d = 4 * warp + (lane & 3);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* wfg = reinterpret_cast<float*>(smem_raw + 16);   // [kNL][kFg]
  float* wd = wfg + kNL * kFg;                             // [kNL][kDense]
  float* dadd = wd + kNL * kDense;                         // [kNL][kR]
  float* X = dadd + kNL * kR;                              // [RBP][kXS]
  float* past = X + RBP * kXS;                             // [RBP][kPS]
  float* outs = past + RBP * kPS;                          // [RBP][kPS]
  float* cur = outs + RBP * kPS;                           // [RBP][kCurS]
  float* stg = outs;                 // the head's tiles: [kStages][kTile]
  float* curr = X;                   // bf16, the chain: [RBP][kCurS]
  float* lg = outs + stage_floats(RBP);                    // [RBP][kQl]
  float* cand_v = lg + RBP * kQl;                          // [kCS][RBP]
  int* cand_i = reinterpret_cast<int*>(cand_v + kCS * RBP);  // [kCS][RBP]
  int* xin = cand_i + kCS * RBP;          // [RBP] input of the step
  int* xprev = xin + RBP;                 // [RBP] input of the step before
  int* meta = xprev + RBP;                // [kNL] ring offsets, [kNL] dilations

  // Once per launch: this CTA's weights as floats, filter and gate columns
  // paired.
  for (int i = tid; i < nl * kFg; i += kThreads) {
    const int j = i / kFg, e = i % kFg;
    const int k = e / (2 * kD), dd = (e / 2) % kD, h = e % 2;
    wfg[i] = widen(
        a.layer_w[((size_t)(l0 + j) * 2 * kR + k) * 2 * kD + h * kD + dd]);
  }
  for (int i = tid; i < nl * kR * kD; i += kThreads) {
    const int j = i / (kR * kD), n = (i / kD) % kR, k = i % kD;
    wd[j * kDense + n * kDS + k] =
        widen(a.dense_w[((size_t)(l0 + j) * kD + k) * kR + n]);
  }
  for (int i = tid; i < nl * kR; i += kThreads)
    dadd[i] = a.dense_add[(size_t)l0 * kR + i];
  if (tid < nl) {
    meta[tid] = a.ring_meta[l0 + tid];
    meta[kNL + tid] = a.ring_meta[L + l0 + tid];
  }
  if (rank == 0) {
    // The register the launch starts from, in X's space for now.
    for (int i = tid; i < RBP * kKC; i += kThreads) {
      const int r = i / kKC;
      X[i] = r < nrows ? a.causal[(size_t)(row0 + r) * kKC + i % kKC] : 0.f;
    }
    if (tid < RBP)
      xin[tid] = tid < nrows ? forced[(size_t)(row0 + tid) * a.n_forced] : 0;
  }
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (rank == 0) {
    // Its causal product, K in order (step 0 adds the input's row to it).
    for (int i = tid; i < RBP * kR; i += kThreads) {
      const int r = i / kR, n = i % kR;
      float s = 0.f;
      for (int k = 0; k < kKC; ++k)
        s = fmaf(opnd<WT>(X[r * kKC + k]), ldw(a.causal_w + (size_t)k * kR + n),
                 s);
      cur[r * kCurS + n] = s;
    }
  }
  cluster.sync();   // every mbarrier initialised before any remote arrive

  const int log_from = a.n_total - a.n_log;
  for (int t = 0; t < a.n_total; ++t) {
    const long long step = a.t0 + t;
#ifdef SAMPLER_TILES_PROBE
    long long tprev = clock64();
#endif

    // The past rows of this CTA's layers (as the fg product's operands)
    // and its rows' fg adds, before waiting for the chain; every load is
    // issued before the first store (CTA 0 waits for none of them).
    {
      float pv[kNL * RT];
#pragma unroll
      for (int u = 0; u < kNL * RT; ++u) {
        const int i = tid + u * kThreads;
        const int j = i / (RBP * kR), r = (i / kR) % RBP, q = i % kR;
        pv[u] = 0.f;
        if (j < nl && r < nrows) {
          const int pos = meta[j] + (int)(step % (long long)meta[kNL + j]);
          pv[u] =
              ring_load<ST>(a.ring, ((size_t)pos * B + row0 + r) * kR + q);
        }
      }
#pragma unroll
      for (int u = 0; u < kNL * RT; ++u) {
        const int i = tid + u * kThreads;
        const int j = i / (RBP * kR), r = (i / kR) % RBP, q = i % kR;
        if (j < nl) past[r * kPS + j * kR + q] = opnd<WT>(pv[u], rc);
      }
    }
    float addv[kNL][RT][2];
#pragma unroll
    for (int j = 0; j < kNL; ++j)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rgl + 8 * i;
        const bool ok = j < nl && r < nrows;
        const float* p =
            a.layer_add + ((size_t)(l0 + j) * B + row0 + r) * 2 * kD + d;
        addv[j][i][0] = ok ? __ldg(p) : 0.f;
        addv[j][i][1] = ok ? __ldg(p + kD) : 0.f;
      }
    if (rank == 0) {
      // current = causal product + the input's row; the product of a
      // one-hot register is its code's row (step 0: computed above).
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        const int r = (tid + u * kThreads) / kR, n = tid % kR;
        const float base =
            t == 0 ? cur[r * kCurS + n]
                   : ldw(a.causal_w + (size_t)xprev[r] * kR + n);
        const float v =
            base + ldw(a.causal_w + (size_t)(kKC + xin[r]) * kR + n);
        cur[r * kCurS + n] = v;
        if constexpr (kBf16) curr[r * kCurS + n] = opnd<WT>(v, rc);
      }
      __syncthreads();
      if (tid < RBP) xprev[tid] = xin[tid];
    } else {
      if (tid == 0) mbar_expect_tx(bar, (uint32_t)(RBP * kR * 4));
      mbar_wait(bar, (uint32_t)(t & 1));
      if constexpr (kBf16) {
        for (int i = tid; i < RBP * kR; i += kThreads) {
          const int off = (i / kR) * kCurS + i % kR;
          curr[off] = opnd<WT>(cur[off], rc);
        }
      }
    }
    __syncthreads();
    PHASE(kWait);   // ring rows, adds, the wait for the residual

    // This CTA's layers.
#pragma unroll
    for (int j = 0; j < kNL; ++j) {
      if (j >= nl) break;
      {
        // fg = [past | current] @ layer_w[l] + layer_add[l, row]; then
        // out = tanh(f) * (0.5 + 0.5 * tanh(g)). past holds operands, and
        // so does curr, current's rounded shadow (bf16).
        float af[RT], ag[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) af[i] = ag[i] = 0.f;
        const float* W = wfg + j * kFg + 2 * d;
#pragma unroll
        for (int k4 = 0; k4 < 2 * kR / 4; ++k4) {
          const bool half = k4 < kR / 4;
          const float* src = half ? past + j * kR + 4 * k4
                                  : (kBf16 ? curr : cur) + 4 * k4 - kR;
          const int stride = half ? kPS : kCurS;
          float4 x[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) x[i] = ld4(src + (rgl + 8 * i) * stride);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 w =
                *reinterpret_cast<const float2*>(W + (4 * k4 + u) * 2 * kD);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              af[i] = fmaf(comp(x[i], u), w.x, af[i]);
              ag[i] = fmaf(comp(x[i], u), w.y, ag[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float f = af[i] + addv[j][i][0];
          const float g = ag[i] + addv[j][i][1];
          outs[(rgl + 8 * i) * kPS + j * kD + d] =
              opnd<WT>(tanhf(f) * (0.5f + 0.5f * tanhf(g)), rc);
        }
      }
      PHASE(kFgProduct);
      __syncthreads();
      PHASE(kFgSync);
      {
        // current += out @ dense_w[l] + dense_add[l]
        float acc[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i] = 0.f;
        const float* W = wd + j * kDense + d * kDS;
#pragma unroll
        for (int k4 = 0; k4 < kD / 4; ++k4) {
          float4 x[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            x[i] = ld4(outs + (rgl + 8 * i) * kPS + j * kD + 4 * k4);
          const float4 w = ld4(W + 4 * k4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int i = 0; i < RT; ++i)
              acc[i] = fmaf(comp(x[i], u), comp(w, u), acc[i]);
          }
        }
        // The layer's input (this step's ring row, unrounded) goes to its
        // past slot, which the fg product has read.
        const float b = dadd[j * kR + d];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float* c = cur + (rgl + 8 * i) * kCurS + d;
          past[(rgl + 8 * i) * kPS + j * kR + d] = *c;
          *c = (*c + acc[i]) + b;
          if constexpr (kBf16)
            curr[(rgl + 8 * i) * kCurS + d] = opnd<WT>(*c, rc);
        }
      }
      PHASE(kDenseProduct);
      __syncthreads();
      PHASE(kDenseSync);
    }

    // Hand the residual to the next CTA of the chain.
    if (rank + 1 < kCS) {
      const uint32_t dst = cluster_addr(cur, (uint32_t)(rank + 1));
      const uint32_t rbar = cluster_addr(bar, (uint32_t)(rank + 1));
      for (int i = tid; i < RBP * kR / 4; i += kThreads) {
        const int off = (i / (kR / 4)) * kCurS + 4 * (i % (kR / 4));
        st_async_v4(dst + 4 * off, ld4(cur + off), rbar);
      }
    }
    // Then this step's ring rows of the CTA's layers: their inputs.
    for (int i = tid; i < nl * nrows * kR / 4; i += kThreads) {
      const int j = i / (nrows * kR / 4), r = (i / (kR / 4)) % nrows;
      const int q = 4 * (i % (kR / 4));
      const int pos = meta[j] + (int)(step % (long long)meta[kNL + j]);
      ring_store4<ST>(a.ring, ((size_t)pos * B + row0 + r) * kR + q,
                      ld4(past + r * kPS + j * kR + q));
    }

    {
      // Skip partial of this CTA's layers: columns 8 cg .. 8 cg + 7 of rows
      // rq + 4 i, over the CTA's K-rows (its layers' D rows) in order;
      // skip_w through a ring of tiles in X, which is free until the
      // partial.
      constexpr int kRows = 2 * RT;
      const int rq = lane & 3, cg = 8 * warp + (lane >> 2);
      const int ns = nl * kD / T::kSkipK;
      const WT* Wsk = a.skip_w + (size_t)l0 * kD * kS;
      const auto skip_tile = [&](int s, float* dst) {
#pragma unroll
        for (int h = 0; h < kSkipTile / (4 * kThreads); ++h) {
          const int e = 4 * (tid + h * kThreads);   // floats into the tile
          cp_async16(dst + e,
                     Wsk + (size_t)s * T::kSkipK * kS + (size_t)e * T::kW);
        }
      };
      float acc[kRows][8];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
#pragma unroll
      for (int s = 0; s < kSkipRing - 1; ++s)
        issue_tile<kSkipRing, kSkipTile>(s, ns, X, skip_tile);
      for (int s = 0; s < ns; ++s) {
        cp_async_wait<kSkipRing - 2>();
        __syncthreads();
        issue_tile<kSkipRing, kSkipTile>(s + kSkipRing - 1, ns, X, skip_tile);
        const WT* w =
            reinterpret_cast<const WT*>(X + (s % kSkipRing) * kSkipTile) +
            8 * cg;
#pragma unroll
        for (int q = 0; q < T::kW; ++q) {
          float4 x[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            x[i] = ld4(outs + (rq + 4 * i) * kPS + T::kSkipK * s + 4 * q);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float wv[8];
            load8(w + (4 * q + u) * kS, wv);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float xv = comp(x[i], u);
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[i][c] = fmaf(xv, wv[c], acc[i][c]);
            }
          }
        }
      }
      __syncthreads();   // the ring is done with: X takes the partial
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float* p = X + (rq + 4 * i) * kXS + 8 * cg;
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    // post1's first tiles, over outs and cur (free until the next step),
    // in flight while the cluster waits for the last skip partial. A tile
    // is [kPost1K][kSl] (or [kPost2K][kQl]) weights of the CTA's columns,
    // kPer to a thread.
    const auto post1_tile = [&](int s, float* dst) {
      const int k = tid / (kSl / T::kPer), c = T::kPer * (tid % (kSl / T::kPer));
      cp_async16(reinterpret_cast<WT*>(dst) + k * kSl + c,
                 a.post1_w + (size_t)(T::kPost1K * s + k) * kS + rank * kSl +
                     c);
    };
    const auto post2_tile = [&](int s, float* dst) {
      const int k = tid / (kQl / T::kPer), c = T::kPer * (tid % (kQl / T::kPer));
      cp_async16(reinterpret_cast<WT*>(dst) + k * kQl + c,
                 a.post2_w + (size_t)(T::kPost2K * s + k) * kQ + rank * kQl +
                     c);
    };
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      issue_tile<kStages, kTile>(s, kS / T::kPost1K, stg, post1_tile);
    PHASE(kSkipProduct);   // hand-off, ring rows, skip partial
    cluster.sync();   // (1) every partial in its CTA's X
    PHASE(kBarrier1);

    // (2) h1 = relu(partials in rank order + skip_b) on this CTA's slice,
    // as post1's operand.
    constexpr int kH1 = (RBP * kSl / 4 + kThreads - 1) / kThreads;
    float4 h1v[kH1];
#pragma unroll
    for (int s = 0; s < kH1; ++s) {
      const int i = tid + s * kThreads;
      if (i < RBP * kSl / 4) {
        const int off = (i / (kSl / 4)) * kXS + rank * kSl + 4 * (i % (kSl / 4));
        float4 p[kCS];
#pragma unroll
        for (int q = 0; q < kCS; ++q) p[q] = ld4(cluster.map_shared_rank(X, q) + off);
        float4 v = p[0];
#pragma unroll
        for (int q = 1; q < kCS; ++q) {
          v.x += p[q].x;
          v.y += p[q].y;
          v.z += p[q].z;
          v.w += p[q].w;
        }
        const float4 b = ld4(a.skip_b + rank * kSl + 4 * (i % (kSl / 4)));
        h1v[s] = opnd4<WT>(
            make_float4(fmaxf(v.x + b.x, 0.f), fmaxf(v.y + b.y, 0.f),
                        fmaxf(v.z + b.z, 0.f), fmaxf(v.w + b.w, 0.f)),
            true);
      }
    }
    cluster.sync();   // every partial read
    PHASE(kSkipSum);
    // (3) all-gather of h1.
#pragma unroll
    for (int s = 0; s < kH1; ++s) {
      const int i = tid + s * kThreads;
      if (i < RBP * kSl / 4) {
        const int off = (i / (kSl / 4)) * kXS + rank * kSl + 4 * (i % (kSl / 4));
#pragma unroll
        for (int q = 0; q < kCS; ++q)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(X, q) + off) =
              h1v[s];
      }
    }
    cluster.sync();   // h1 whole in every CTA
    PHASE(kGatherH1);

    {
      // (4) h2 = relu(h1 @ post1 + b1) on columns rank * S/8 + 2 cp and
      // 2 cp + 1 of rows rgl + 8 i, weights through the ring of tiles;
      // staged in `past` as post2's operand.
      const int cp = 4 * warp + (lane & 3);
      float acc[RT][2];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = 0.f;
      // Tile s: K-rows kPost1K s.. of the CTA's columns.
      for (int s = 0; s < kS / T::kPost1K; ++s) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue_tile<kStages, kTile>(s + kStages - 1, kS / T::kPost1K, stg,
                                   post1_tile);
        const WT* w =
            reinterpret_cast<const WT*>(stg + (s % kStages) * kTile) + 2 * cp;
#pragma unroll
        for (int k4 = 0; k4 < T::kPost1K / 4; ++k4) {
          float4 x[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            x[i] = ld4(X + (rgl + 8 * i) * kXS + T::kPost1K * s + 4 * k4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 w2 = load2(w + (4 * k4 + u) * kSl);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              acc[i][0] = fmaf(comp(x[i], u), w2.x, acc[i][0]);
              acc[i][1] = fmaf(comp(x[i], u), w2.y, acc[i][1]);
            }
          }
        }
      }
      const float b0 = __ldg(a.post1_b + rank * kSl + 2 * cp);
      const float b1 = __ldg(a.post1_b + rank * kSl + 2 * cp + 1);
#pragma unroll
      for (int i = 0; i < RT; ++i)
        *reinterpret_cast<float2*>(past + (rgl + 8 * i) * kPS + 2 * cp) =
            make_float2(opnd<WT>(fmaxf(acc[i][0] + b0, 0.f)),
                        opnd<WT>(fmaxf(acc[i][1] + b1, 0.f)));
    }
    // post2's first tiles, once every thread is done with post1's.
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      issue_tile<kStages, kTile>(s, kS / T::kPost2K, stg, post2_tile);
    PHASE(kPost1);
    cluster.sync();   // every CTA done reading h1
    // (5) all-gather of h2.
    for (int i = tid; i < RBP * kSl / 4; i += kThreads) {
      const int r = i / (kSl / 4), c4 = 4 * (i % (kSl / 4));
      const float4 v = ld4(past + r * kPS + c4);
#pragma unroll
      for (int q = 0; q < kCS; ++q)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(X, q) + r * kXS +
                                   rank * kSl + c4) = v;
    }
    cluster.sync();   // h2 whole in every CTA
    PHASE(kGatherH2);

    {
      // (6) logits = h2 @ post2 + b2 on classes rank * Q/8 + 4 warp + cc
      // of rows rq + 8 i.
      const int cc = lane & 3, rq = lane >> 2;
      const int ql = 4 * warp + cc, q = rank * kQl + ql;
      float acc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = 0.f;
      // Tile s: K-rows kPost2K s.. of the CTA's classes.
      for (int s = 0; s < kS / T::kPost2K; ++s) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue_tile<kStages, kTile>(s + kStages - 1, kS / T::kPost2K, stg,
                                   post2_tile);
        const WT* w =
            reinterpret_cast<const WT*>(stg + (s % kStages) * kTile) + ql;
#pragma unroll
        for (int k4 = 0; k4 < T::kPost2K / 4; ++k4) {
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float4 x =
                ld4(X + (rq + 8 * i) * kXS + T::kPost2K * s + 4 * k4);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[i] = fmaf(comp(x, u), widen(w[(4 * k4 + u) * kQl]), acc[i]);
          }
        }
      }
      const float b = __ldg(a.post2_b + q);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rq + 8 * i;
        const float v = acc[i] + b;
        lg[r * kQl + ql] = v;
        if (a.n_log > 0 && t >= log_from && r < nrows)
          a.logits[((size_t)(row0 + r) * a.n_log + (t - log_from)) * kQ + q] =
              v;
      }
    }
    PHASE(kPost2);
    __syncthreads();
    // Gumbel-argmax over this CTA's classes: 8 lanes a row, one block of 4
    // classes a lane; the row's best goes to CTA 0.
    for (int base = 0; base < RBP * 8; base += kThreads) {
      if (base + 32 * warp >= RBP * 8) break;
      const int i = base + tid, r = i >> 3, b8 = i & 7;
      const int blk = rank * (kQl / 4) + b8, row = row0 + r;
      uint32_t c[4] = {(uint32_t)blk, (uint32_t)row, (uint32_t)step,
                       (uint32_t)((unsigned long long)step >> 32)};
      philox4x32_10(c, a.key0, a.key1);
      float bv = -INFINITY;
      int bi = kQ;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * blk + j;
        float u = __uint_as_float((c[j] >> 9) | 0x3F800000u) - 1.0f;
        u = fmaxf(u, 1e-20f);
        const float gmb = -logf(-logf(u));
        const float sc = __fadd_rn(
            __fmul_rn(lg[r * kQl + 4 * b8 + j], a.inv_temperature), gmb);
        if (better(sc, q, bv, bi)) {
          bv = sc;
          bi = q;
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (b8 == 0 && r < nrows) {
        cluster.map_shared_rank(cand_v, 0)[rank * RBP + r] = bv;
        cluster.map_shared_rank(cand_i, 0)[rank * RBP + r] = bi;
      }
    }
    PHASE(kGumbel);
    cluster.sync();   // every candidate in CTA 0

    if (rank == 0 && tid < nrows) {
      const int r = tid, row = row0 + r;
      float bv = cand_v[r];
      int bi = cand_i[r];
      for (int q = 1; q < kCS; ++q)
        if (better(cand_v[q * RBP + r], cand_i[q * RBP + r], bv, bi)) {
          bv = cand_v[q * RBP + r];
          bi = cand_i[q * RBP + r];
        }
      // Body t consumes input t and emits input t + 1: forced while
      // t + 1 < n_forced, then the sampled code.
      const int nx = t + 1 < a.n_forced
                         ? forced[(size_t)row * a.n_forced + t + 1]
                         : (bi < kQ ? bi : 0);
      a.codes[(size_t)row * a.n_total + t] = nx;
      xin[r] = nx;
    }
    __syncthreads();
    PHASE(kPick);
  }

  if (rank == 0) {
    // The register of the next step: the one-hot of the last input.
    for (int i = tid; i < nrows * kKC; i += kThreads) {
      const int r = i / kKC;
      a.causal[(size_t)(row0 + r) * kKC + i % kKC] =
          (i % kKC == xprev[r]) ? 1.f : 0.f;
    }
  }
  cluster.sync();   // no CTA leaves while another may touch its memory
}

// The launch of `clusters` clusters of 8 CTAs, `bytes` of shared memory
// each, with the kernel's attributes set for it.
template <int RT, typename WT, typename ST = float>
cudaError_t configure(size_t bytes, int clusters, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      sampler_tiles_kernel<RT, WT, ST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * kCS, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Calls f(std::integral_constant<int, rt>) for rt rows a thread, 2..5.
template <typename F>
cudaError_t with_rows(int rt, F f) {
  switch (rt) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return cudaErrorInvalidValue;
  }
}

// Clusters of 8 CTAs at rb rows a cluster that the current device keeps
// resident at once (tile_plan's residency), of the kernel at WT weights and
// a ring of type ST.
template <typename WT, typename ST = float>
int tiles_max_clusters(int rb, int* n) {
  *n = 0;
  if (rb < 1 || rb > kMaxRows) return (int)cudaErrorInvalidValue;
  const size_t bytes = tiles_smem_bytes(rb);
  return (int)with_rows(rows_per_thread(rb), [&](auto k) {
    constexpr int RT = decltype(k)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = configure<RT, WT, ST>(bytes, 1, nullptr, cfg, attr);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveClusters(
        n, sampler_tiles_kernel<RT, WT, ST>, &cfg);
  });
}

// The arguments of sampler_decode_f32 / _bf16 with WT weights and a ring
// of type ST, round_chain (bf16 only, as DecodeArgsT's), then the plan: cs
// (8) CTAs a cluster, rb rows a cluster, layer_begin[cs + 1] (host memory)
// the layer ranges.
template <typename WT, typename ST = float>
int tiles_run(const WT* causal_w, const WT* layer_w, const float* layer_add,
              const WT* dense_w, const float* dense_add, const WT* skip_w,
              const float* skip_b, const WT* post1_w, const float* post1_b,
              const WT* post2_w, const float* post2_b, const int* ring_meta,
              ST* ring, float* causal, const void* forced, int* codes,
              float* logits, float* next_amp, int B, int L, int R, int D,
              int S, int Q, int n_total, int n_forced, int n_log,
              int scalar_input, int causal_width, long long t0,
              unsigned long long seed, float inv_temperature, int round_chain,
              int cs, int rb, const int* layer_begin, void* stream) {
  TileArgs<WT> ta;
  DecodeArgsT<WT>& a = ta.a;
  a.causal_w = causal_w;
  a.layer_w = layer_w;
  a.layer_add = layer_add;
  a.dense_w = dense_w;
  a.dense_add = dense_add;
  a.skip_w = skip_w;
  a.skip_b = skip_b;
  a.post1_w = post1_w;
  a.post1_b = post1_b;
  a.post2_w = post2_w;
  a.post2_b = post2_b;
  a.ring_meta = ring_meta;
  a.ring = ring;
  a.causal = causal;
  a.forced = forced;
  a.codes = codes;
  a.logits = logits;
  a.next_amp = nullptr;
  a.B = B;
  a.L = L;
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.n_total = n_total;
  a.n_forced = n_forced;
  a.n_log = n_log;
  a.scalar = scalar_input;
  a.KC = causal_width;
  a.t0 = t0;
  a.key0 = (uint32_t)(seed & 0xffffffffull);
  a.key1 = (uint32_t)(seed >> 32);
  a.inv_temperature = inv_temperature;
  a.round_chain = round_chain;
  if (B < 1 || n_total < 1 || n_forced < 1 || n_log < 0 ||
      n_log > n_total || (n_log > 0 && !logits) || scalar_input ||
      next_amp || R != kR || D != kD || S != kS || Q != kQ ||
      causal_width != kKC || cs != kCS || L < kCS || L > kCS * kNL ||
      rb < 1 || rb > kMaxRows || layer_begin[0] != 0 || layer_begin[cs] != L)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kCS; ++k) {
    const int n = layer_begin[k + 1] - layer_begin[k];
    if (n < 1 || n > kNL) return (int)cudaErrorInvalidValue;
    ta.layer_begin[k] = layer_begin[k];
  }
  ta.layer_begin[kCS] = L;
  ta.rb = rb;
  int dev = 0, smem_max = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  const size_t bytes = tiles_smem_bytes(rb);
  if (bytes > (size_t)smem_max) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)with_rows(rows_per_thread(rb), [&](auto k) {
    constexpr int RT = decltype(k)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e =
        configure<RT, WT, ST>(bytes, (B + rb - 1) / rb, s, cfg, attr);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, sampler_tiles_kernel<RT, WT, ST>, ta);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

}  // namespace
