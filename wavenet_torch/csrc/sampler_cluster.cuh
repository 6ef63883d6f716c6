// sampler_cluster: whole-network autoregressive WaveNet decode, one launch
// per generation, with the weights of the layer chain resident in the
// shared memory of a thread-block cluster, for NVIDIA Hopper (sm_90a).
//
// The kernel, its launch and its C entry points' body, templated on the
// weights' type, on local conditioning and on the ring's type;
// sampler_cluster.cu builds the float32 mode (and the route's device
// queries), sampler_cluster_bf16.cu the bf16 mode, sampler_cluster_lc.cu the
// local-conditioning mode and sampler_cluster_lc_bf16.cu that mode at bf16
// weights, each its own library, so that the four build in parallel; the
// four *_ring16.cu build the same four modes at a bf16 ring (ST, the JAX
// kernel's state_dtype: each past row widened exactly as it is read, each
// layer's float32 input rounded to nearest even as it goes to the ring;
// sampler_step.cuh's ring_load, ring_store). The ring stays in device
// memory, so both ring types take one plan and one shared-memory carve-up.
//
// Replaces the JAX package's all-VMEM decode kernel, whose weights and
// ring stay on chip for the whole launch (its b1 production path):
//   wavenet_tpu/kernels/sampler.py:234   _sampler_kernel
// and computes exactly what sampler_decode.cu computes (see its header for
// the step, the forced prefix, the logits window, resume, next_amp and the
// Philox4x32-10 noise keyed on (class block, row, absolute step)), so a
// row's codes depend neither on the batch size nor on the grid, and
// decode_reference is the plain version of both kernels.
//
// What bounds it. A decode step at small B is a chain of ~60 dependent
// products (filter/gate, then dense, for each of L layers), then the skip
// sum and the head. sampler_decode streams every weight of that chain from
// L2 in one block, and each product waits for its weights before the next
// can start; the r3 probe of sampler_decode (b1_bisect.cu) finds the 30
// filter/gate products alone 43% of its step, on 11% of its bytes. Neither
// bytes nor FLOPs bound the step (0.21 ms against a 3e-5 ms bound at paper
// b1 on an H100); the latency of the chain does. This kernel shortens the
// chain to 0.03 ms a step. Its own probe (b1_bisect_cluster.cuh; PERF.md)
// finds the filter/gate products 12% of that step; on the last CTA's
// timeline the chain (the wait for the CTAs before it, then its own
// layers) is 56%, the head from the first cluster barrier on 39%, post1
// alone 18%:
//
// * One cluster of CS CTAs serves RB rows; CTA k owns the contiguous
//   layers [layer_begin[k], layer_begin[k+1]) and copies their filter/gate
//   weights [2R, 2D] and dense weights [D, R] into its shared memory once
//   per launch (paper: 20 KB a layer, 4 layers a CTA at CS = 8; wide
//   R = D = 64: 80 KB a layer, 2 layers a CTA at CS = 16), in the order in
//   which its lanes read them. Every chain product then reads shared
//   memory, not L2: each warp owns whole output columns, its lanes split K
//   and add their partial sums with shuffles, so a layer takes two block
//   barriers (sampler_decode: four, with L2 loads between them). The
//   per-row filter/gate adds (bias, GC) are staged once too.
// * Hand-off: after its last layer, CTA k stores the residual [RB, R] into
//   CTA k+1's shared memory with asynchronous stores (st.async) that
//   complete on an mbarrier there; CTA k+1 waits on it. CS - 1 hand-offs
//   a step, and no memory fence: the ring rows of a CTA's layers are read
//   at the start of the step, before the CTA waits (their addresses do not
//   depend on the data), and written after the hand-off.
// * The skip products leave the chain: after handing off, each CTA sums
//   its layers' skip products into a partial skip [RB, S] in its own
//   shared memory; skip_w stays in L2. Only the last CTA's sit on the
//   critical path, so the last CTA gets the fewest layers.
// * The head is split across the cluster: after a cluster barrier every
//   CTA adds the CS partial sums in rank order, adds skip_b and applies
//   relu; CTA k computes columns [k S/CS, (k+1) S/CS) of post1 and stores
//   them into every CTA's h2 (an all-gather through distributed shared
//   memory), then, after a second barrier, classes [k Q/CS, (k+1) Q/CS) of
//   the logits, their Gumbel noise and their best class; after a third,
//   CTA 0 takes the best of the CS candidates (ties to the lowest class),
//   emits the code and starts the next step. Each CTA reads its columns of
//   post1 and post2 in place (S / CS and Q / CS contiguous floats a row),
//   and the loads of the head and skip products are issued in batches, since at small B
//   they are bound by how fast one SM reads L2. CTA 0 computes the causal
//   product of the next step's register while the chain runs on in the
//   other CTAs, so a step starts with one row of causal_w.
//
// Sums have a fixed order: each chain product adds a lane's K terms in
// order and the lanes' sums in a fixed shuffle tree, the skip partials add
// the layers in order and the CTAs' partials in rank order, and the head's
// K splits depend on the column slice, which depends on CS alone. The
// host's plan (cluster_plan in kernels/sampler.py) takes CS from the config
// and the device only, so a row's result does not depend on RB or B:
// same-seed runs, b1 against row 0 of a larger batch, and resumed segments
// against one run are bitwise equal. The values differ from
// sampler_decode's in the last bits (another summation order). Plain FP32
// FMAs, no tensor cores.
//
// bf16 mode (the JAX kernels at weight_dtype=bfloat16): the layer weights
// are read as bf16 and widened to float when they are stored to shared
// memory (exact, so the shared-memory layout and the plan are those of the
// float32 mode); the streamed ones (causal_w, skip_w, post1_w, post2_w) are
// widened in registers. Each product's activation operand is rounded to
// bf16 at sampler_step.cuh's points: the causal window and the head's two
// inputs always, the layer chain's inputs where round_chain is set (the
// host clears it at B = 1, as the JAX prefill route's VPU chain). Rows of
// B >= 2 keep the same rule and the same sum orders, so they are as
// independent of B as in the float32 mode.
//
// Local-conditioning mode (kLc, float32 or bf16 weights; the JAX kernel's
// has_lc):
// each layer's filter/gate pre-activation gains lc_t @ lc_w[l] (lc_w
// [L, C_lc, 2D] pre-scaled as layer_w; lc_t is row t of the stream
// [n_total, B, C_lc]), added after layer_add, in the JAX kernel's order.
// The term depends on the stream alone, never on the chain's state, so it
// leaves the chain, as the skip products do, and lc_w stays in L2. Each CTA
// computes its layers' terms where it waits: CTA 0, which waits for nobody
// before its chain, those of step t + 1 after its own hand-off; at up to 4
// rows a cluster also CTA k < CS / 2, which then waits at least CS / 2
// CTAs' chains for the skip sums; every other CTA those of step t before
// it waits for the hand-off (at least one CTA's chain, CS / 2 at up to 4
// rows). Measured on an H100 at the paper widths, the split by halves
// shortens the b1 step, while at 8 rows the terms of CTAs 1 to 3 after
// their hand-off delay the skip sums. The terms of a
// row [NL][2D] and the step's feature row sit
// in shared memory (cluster_smem_bytes counts them), which leaves the plan
// of the paper/gc widths as it is (CS 8, up to 8 rows a cluster on an H100).
// At bf16 weights lc_w is read as bf16 and widened in registers, and the
// feature row is rounded to bf16 when it is staged, at every B (the JAX
// kernel casts it to lc_w's type before either branch): lc_terms in
// sampler_step.cuh. The shared memory and the plan are the float32 LC
// mode's.
//
// Clusters never wait on each other; nothing needs co-residency beyond the
// CTAs of one cluster, which the hardware schedules together. The plan
// keeps every cluster of a launch resident at once (the device's count of
// resident clusters), so that a launch runs in one wave.
//
// Ablations (kMask, sampler_step.cuh's bits; kFullStep in every production
// library, where each `if constexpr` below keeps the full step). The r3
// probe (b1_bisect_cluster.cuh) instantiates them at RB = 1 without LC;
// each computes its JAX mode's math (tools/r3_b1_bisect.py) and keeps every
// cluster barrier, mbarrier hand-off and block barrier of the full step
// unless said:
//   kNoRing    past = cur (the layer's input): no ring read before the
//              wait, no ring write after the hand-off
//   kNoFg      fg = [past | cur] (R == D): no filter/gate product or its
//              shuffles; past is then kept unrounded (bf16), as fg
//   kNoDense   cur += out[:, :R]: no dense product or its shuffles; out is
//              then kept unrounded (bf16) and rounded where the skip
//              product reads it
//   kNoTanh    out = f + g
//   kNoSkip    no skip partial (psum holds zeros, written once a launch);
//              the head adds them to skip_b, so it reads skip_b alone
//   kNoHead    no skip sum, post1 or post2, and no barrier B2: after B1
//              every CTA reads the last CTA's cur[0] (its chain is done,
//              and nothing writes it before B3) as the logit of each of
//              its classes
//   kNoSample  argmax of the logits, no Philox noise
//   kNoFeat    CTA 0 sets cur = x in every channel: no causal product (at
//              launch or after the hand-off) and no register update
//
// Phase clock (SAMPLER_CLUSTER_PROBE, defined by the probe's sources only):
// thread 0 of each CTA of the first cluster keeps, in registers, the SM
// clocks (clock64) of each phase of every step (ClusterPhase) and of the
// whole step loop, and adds them to g_phase_cycles[rank] when the launch
// ends. A CTA's phases add up to its steps, less the loop's own overhead.
// Without the macro CLUSTER_PHASE compiles to nothing.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_ptx.cuh"
#include "sampler_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kSkipCols = 2;    // skip columns a thread carries at once

// The phases of a step, in order (one CTA's timeline):
//   kPhRingWait      past rows; CTA 0: cur and the register, else the
//                    mbarrier wait for the hand-off
//   kPhFgProduct ... kPhDenseSync   each layer's products and block
//                    barriers, summed over the CTA's layers
//   kPhHandoff       st.async to the next CTA, the ring write, CTA 0's next
//                    causal product (and the LC terms)
//   kPhSkipPartial, kPhBarrier1, kPhSkipSum, kPhPost1Gather, kPhBarrier2,
//   kPhPost2Logits, kPhGumbelArgmax, kPhBarrier3Pick   the head
enum ClusterPhase {
  kPhRingWait, kPhFgProduct, kPhFgSync, kPhDenseProduct, kPhDenseSync,
  kPhHandoff, kPhSkipPartial, kPhBarrier1, kPhSkipSum, kPhPost1Gather,
  kPhBarrier2, kPhPost2Logits, kPhGumbelArgmax, kPhBarrier3Pick,
  kClusterPhases
};
#ifdef SAMPLER_CLUSTER_PROBE
// [rank][phase]; the last column is the step loop's whole.
__device__ unsigned long long g_phase_cycles[kMaxCluster][kClusterPhases + 1];
#define CLUSTER_PHASE(k)                          \
  do {                                            \
    if (probe_thread) {                           \
      const long long now_ = clock64();           \
      phase_cycles[k] += (unsigned long long)(now_ - phase_prev); \
      phase_prev = now_;                          \
    }                                             \
  } while (0)
#else
#define CLUSTER_PHASE(k) ((void)0)
#endif

template <typename WT>
struct ClusterArgs {
  DecodeArgsT<WT> a;
  int cs;                           // CTAs per cluster
  int nl;                           // most layers any CTA owns
  int layer_begin[kMaxCluster + 1];
};

// How the chain's products split over the block's 8 warps. Each warp owns
// whole output columns, and its 32 lanes split K into groups whose partial
// sums it adds with shuffles:
//   filter/gate: D/8 filter and the matching D/8 gate columns a warp
//   (fcols), 32 / fcols groups over K = 2R;
//   dense: R/8 columns a warp (dcols), 32 / dcols groups over K = D.
// The weights sit in shared memory in the order the lanes read them
// (warp, step, lane), so a warp's load is 32 consecutive floats.
struct ChainShape {
  int fcols, fg_groups, fg_it, fg_floats;
  int dcols, d_groups, d_it, d_floats;
};

__host__ __device__ inline ChainShape chain_shape(int R, int D) {
  ChainShape s;
  s.fcols = D / 4;
  s.fg_groups = 32 / s.fcols;
  s.fg_it = (2 * R + s.fg_groups - 1) / s.fg_groups;
  s.fg_floats = kWarps * s.fg_it * 32;
  s.dcols = R / 8;
  s.d_groups = 32 / s.dcols;
  s.d_it = (D + s.d_groups - 1) / s.d_groups;
  s.d_floats = kWarps * s.d_it * 32;
  return s;
}

// Dynamic shared memory of one CTA: the carve-up at the top of
// sampler_cluster_kernel (mirrored by cluster_smem_bytes in
// kernels/sampler.py).
// The layout does not depend on the weights' type: bf16 weights are widened
// to float when they are stored to shared memory. C_lc is 0 outside the LC
// mode.
template <typename WT>
size_t cluster_smem_bytes(const DecodeArgsT<WT>& a, int cs, int nl, int rb) {
  const ChainShape sh = chain_shape(a.R, a.D);
  const size_t R = a.R, D = a.D, S = a.S;
  const size_t per_cta =
      nl * ((size_t)sh.fg_floats + sh.d_floats + R) + 2 * nl + 2 * cs * rb;
  const size_t per_row = nl * (2 * D + 2 * R + D) + R + 3 * S + a.Q / cs +
                         a.KC + R + kThreads + 2 +
                         (a.C_lc ? nl * 2 * D + a.C_lc : 0);  // lcp, lcr
  return 16 + 4 * (per_cta + rb * per_row);
}

// Loads a thread keeps in flight in the head and skip products, whose
// weights come from L2: a loop that loads one weight per FMA waits for each
// load. Fewer at 8 rows a cluster, whose accumulators take the registers.
template <int RB>
constexpr int kBatchOf = RB <= 4 ? 32 : 16;

// A slice of the head: y[r][n] = sum_k x[r*K + k] * W[k*ld + n] + bias[n]
// for n < N, handed to epi(r, n, sum, bias[n]), W (widened to float) and
// bias in L2, x already as the product's operand (rounded by the caller
// for bf16 weights). As
// sampler_step.cuh's matvec: one thread per column over the whole K when
// N >= kThreads, else G = kThreads / N groups over every G-th k, added in
// group order; each thread loads kBatch weights before it multiplies. The
// caller synchronises after the call before reading what epi wrote.
template <int RB, typename WT, typename Epi>
__device__ __forceinline__ void head_matvec(const float* x, int K,
                                            const WT* __restrict__ W,
                                            int ld, int N,
                                            const float* __restrict__ bias,
                                            float* part, Epi epi) {
  const int tid = threadIdx.x;
  const bool split = N < kThreads;
  const int G = split ? kThreads / N : 1;
  for (int n0 = split ? tid % N : tid; n0 < N; n0 += kThreads) {
    const int g = split ? tid / N : 0;
    const float b = __ldg(bias + n0);
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    if (g < G) {
      constexpr int kBatch = kBatchOf<RB>;
      for (int k0 = g; k0 < K; k0 += kBatch * G) {
        float w[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u * G;
          w[u] = k < K ? ldw(W + (size_t)k * ld + n0) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u * G;
          if (k < K) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
              acc[r] = fmaf(x[r * K + k], w[u], acc[r]);
          }
        }
      }
    }
    if (!split) {
#pragma unroll
      for (int r = 0; r < RB; ++r) epi(r, n0, acc[r], b);
      continue;
    }
    if (g < G) {
#pragma unroll
      for (int r = 0; r < RB; ++r) part[(g * RB + r) * N + n0] = acc[r];
    }
    __syncthreads();
    if (tid < N) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float s = 0.f;
        for (int gg = 0; gg < G; ++gg) s += part[(gg * RB + r) * N + tid];
        epi(r, tid, s, b);
      }
    }
    break;
  }
}

// acc[r] += sum over it < n of x[r * xs + it * xstep] * W[it * 32]: a lane's
// share of a chain product, weights and activations in shared memory, x
// rounded as opnd<WT>(x, rnd). The loads of U steps are issued before their
// FMAs, so they overlap.
template <int RB, typename WT>
__device__ __forceinline__ void lane_dot(const float* W, const float* x,
                                         int xs, int xstep, int n,
                                         float (&acc)[RB], bool rnd) {
  constexpr int U = RB <= 2 ? 8 : 4;
  int it = 0;
  for (; it + U <= n; it += U) {
    float w[U], v[U][RB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = W[(it + u) * 32];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        v[u][r] = opnd<WT>(x[r * xs + (it + u) * xstep], rnd);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = fmaf(v[u][r], w[u], acc[r]);
  }
  for (; it < n; ++it) {
    const float w = W[it * 32];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      acc[r] = fmaf(opnd<WT>(x[r * xs + it * xstep], rnd), w, acc[r]);
  }
}

// Widths and cluster sizes compiled into the kernel: the paper/gc config
// at CS = 8 and the wide config at CS = 16 (what cluster_plan picks on an
// H100). With them known, the index arithmetic and loop bounds of every
// phase fold into constants; on these shapes that halves the step. 0: the
// widths are read from the arguments.
template <int K>
struct Fixed {
  static constexpr int R = 0, D = 0, S = 0, Q = 0, CS = 0;
};
template <>
struct Fixed<1> {
  static constexpr int R = 32, D = 32, S = 512, Q = 256, CS = 8;
};
template <>
struct Fixed<2> {
  static constexpr int R = 64, D = 64, S = 1024, Q = 256, CS = 16;
};

// A bf16 weight (or a float one) as the float that shared memory holds.
__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

template <int RB, int kFixed, typename WT, bool kLc = false,
          unsigned kMask = kFullStep, typename ST = float>
__global__ void __launch_bounds__(kThreads, 1)
sampler_cluster_kernel(const ClusterArgs<WT> ca) {
  constexpr bool kSkip = !(kMask & kNoSkip), kDense = !(kMask & kNoDense);
  constexpr bool kFg = !(kMask & kNoFg), kTanh = !(kMask & kNoTanh);
  constexpr bool kRing = !(kMask & kNoRing), kHead = !(kMask & kNoHead);
  constexpr bool kSample = !(kMask & kNoSample), kFeat = !(kMask & kNoFeat);
  static_assert(!kLc || kMask == kFullStep, "the LC mode has no ablations");
  cg::cluster_group cluster = cg::this_cluster();
  const DecodeArgsT<WT>& a = ca.a;
  // bf16 weights: whether the layer chain's inputs are rounded (the causal
  // window and the head's inputs always are). past, outs, h1 and h2 are
  // only ever product operands, so they are stored rounded; cur is
  // rounded where the filter/gate product reads it.
  const bool rc = a.round_chain != 0;
  using F = Fixed<kFixed>;
  const int CS = F::CS ? F::CS : ca.cs, NL = ca.nl;
  const int rank = (int)cluster.block_rank();
  const int l0 = ca.layer_begin[rank];
  const int nl = ca.layer_begin[rank + 1] - l0;
  const int R = F::R ? F::R : a.R, D = F::D ? F::D : a.D;
  const int S = F::S ? F::S : a.S, Q = F::Q ? F::Q : a.Q;
  const int L = a.L, B = a.B;
  const int KC = a.KC;
  const int Sl = S / CS, Ql = Q / CS;
  const int c0 = rank * Sl, q0 = rank * Ql;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x / CS) * RB;
  const float mu = (float)(Q - 1);
  const int* forced_i = static_cast<const int*>(a.forced);
  const float* forced_f = static_cast<const float*>(a.forced);
  const ChainShape sh = chain_shape(R, D);
  // This lane's filter/gate column and K group, and its dense column and K
  // group (see ChainShape).
  const int fcl = lane % sh.fcols, fg_g = lane / sh.fcols;
  const int fdim = warp * (sh.fcols / 2) + fcl % (sh.fcols / 2);
  const bool gate_lane = fcl >= sh.fcols / 2;
  const int dcl = lane % sh.dcols, d_g = lane / sh.dcols;
  const int dn = warp * sh.dcols + dcl;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // hand-off
  float* wfg = reinterpret_cast<float*>(smem_raw + 16);   // [NL][fg_floats]
  float* wd = wfg + (size_t)NL * sh.fg_floats;             // [NL][d_floats]
  float* dadd = wd + (size_t)NL * sh.d_floats;             // [NL][R]
  float* addb = dadd + NL * R;                             // [RB][NL][2D]
  float* past = addb + RB * NL * 2 * D;                    // [RB][NL][R]
  float* ins = past + RB * NL * R;                         // [RB][NL][R]
  float* cur = ins + RB * NL * R;                          // [RB][R]
  float* outs = cur + RB * R;                              // [RB][NL][D]
  float* psum = outs + RB * NL * D;                        // [RB][S]
  float* h1 = psum + RB * S;                               // [RB][S]
  float* h2 = h1 + RB * S;                                 // [RB][S]
  float* lg = h2 + RB * S;                                 // [RB][Ql]
  float* causal = lg + RB * Ql;                            // [RB][KC]
  float* sprev = causal + RB * KC;                         // [RB][R]
  float* part = sprev + RB * R;                            // [RB * kThreads]
  float* cand_v = part + RB * kThreads;                    // [CS][RB]
  int* cand_i = reinterpret_cast<int*>(cand_v + CS * RB);  // [CS][RB]
  int* meta = cand_i + CS * RB;     // [NL] ring offsets, [NL] dilations
  int* xin = meta + 2 * NL;         // [RB] current code (mu-law)
  float* xamp = reinterpret_cast<float*>(xin + RB);  // [RB] amplitude
  float* lcr = xamp + RB;                            // [RB][C_lc] (kLc)
  float* lcp = lcr + RB * a.C_lc;                    // [RB][NL][2D] (kLc)
  // Whether this CTA computes the next step's LC terms after its hand-off,
  // or this step's before it waits for the hand-off (see the header).
  const bool lc_after = rank == 0 || (RB <= 4 && 2 * rank < CS);

#ifdef SAMPLER_CLUSTER_PROBE
  const bool probe_thread = tid == 0 && (int)blockIdx.x < CS;
  unsigned long long phase_cycles[kClusterPhases] = {};
  long long phase_prev = 0;
#endif

  // Once per launch: this CTA's weights (in the lane order of the chain's
  // products), adds and ring rows.
  for (int i = tid; i < (kFg ? nl * sh.fg_floats : 0); i += kThreads) {
    const int j = i / sh.fg_floats, e = i % sh.fg_floats;
    const int w = e / (sh.fg_it * 32), it = (e / 32) % sh.fg_it, l = e % 32;
    const int cl = l % sh.fcols, k = l / sh.fcols + it * sh.fg_groups;
    const int half = sh.fcols / 2;
    const int col = cl < half ? w * half + cl : D + w * half + cl - half;
    wfg[i] = k < 2 * R
                 ? widen(a.layer_w[((size_t)(l0 + j) * 2 * R + k) * 2 * D +
                                   col])
                 : 0.f;
  }
  for (int i = tid; i < (kDense ? nl * sh.d_floats : 0); i += kThreads) {
    const int j = i / sh.d_floats, e = i % sh.d_floats;
    const int w = e / (sh.d_it * 32), it = (e / 32) % sh.d_it, l = e % 32;
    const int k = l / sh.dcols + it * sh.d_groups;
    const int col = w * sh.dcols + l % sh.dcols;
    wd[i] = k < D ? widen(a.dense_w[((size_t)(l0 + j) * D + k) * R + col])
                  : 0.f;
  }
  for (int i = tid; i < nl * R; i += kThreads)
    dadd[i] = a.dense_add[(size_t)l0 * R + i];
  for (int i = tid; i < RB * nl * 2 * D; i += kThreads) {
    const int r = i / (nl * 2 * D), j = (i / (2 * D)) % nl, n = i % (2 * D);
    const int row = row0 + r;
    addb[(r * NL + j) * 2 * D + n] =
        row < B ? a.layer_add[((size_t)(l0 + j) * B + row) * 2 * D + n] : 0.f;
  }
  for (int j = tid; j < nl; j += kThreads) {
    meta[j] = a.ring_meta[l0 + j];
    meta[NL + j] = a.ring_meta[L + l0 + j];
  }
  if (rank == 0) {
    for (int i = tid; i < RB * KC; i += kThreads) {
      const int row = row0 + i / KC;
      causal[i] = row < B ? a.causal[(size_t)row * KC + i % KC] : 0.f;
    }
    if (tid < RB) {
      const int row = row0 + tid;
      const size_t at = (size_t)row * a.n_forced;
      xin[tid] = (row < B && !a.scalar) ? forced_i[at] : 0;
      xamp[tid] = (row < B && a.scalar) ? forced_f[at] : 0.f;
    }
  }
  if constexpr (!kSkip) {
    for (int i = tid; i < RB * S; i += kThreads) psum[i] = 0.f;
  }
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (kFeat && rank == 0) {
    // The causal product of step 0's register (the input row is added when
    // the step starts).
    matvec<RB>(causal, KC, KC, a.causal_w, R, part,
               [&](int r, int n, float s) { sprev[r * R + n] = s; });
    __syncthreads();
  }
  // Step 0's LC terms in the CTAs that compute them after the hand-off.
  if constexpr (kLc) {
    if (lc_after) lc_terms<RB>(a, 0, row0, l0, nl, NL, D, lcr, lcp);
  }
  cluster.sync();   // every mbarrier initialised before any remote arrive

  const int log_from = a.n_total - a.n_log;
#ifdef SAMPLER_CLUSTER_PROBE
  const long long loop_start = clock64();
#endif
  for (int t = 0; t < a.n_total; ++t) {
    const long long step = a.t0 + t;
#ifdef SAMPLER_CLUSTER_PROBE
    if (probe_thread) phase_prev = clock64();
#endif

    // The past rows of this CTA's layers, before waiting for the chain
    // (kept unrounded where fg is [past | cur] itself).
    for (int i = tid; i < (kRing ? RB * nl * R : 0); i += kThreads) {
      const int r = i / (nl * R), j = (i / R) % nl, q = i % R;
      const int row = row0 + r;
      const int pos = meta[j] + (int)(step % (long long)meta[NL + j]);
      past[(r * NL + j) * R + q] = opnd<WT>(
          row < B ? ring_load<ST>(a.ring, ((size_t)pos * B + row) * R + q)
                  : 0.f,
          kFg && rc);
    }
    if (rank == 0) {
      // current = causal product + the input's row (mu-law: row KC + x of
      // the one-hot; scalar: x times row KC), as sampler_decode's epilogue.
      for (int i = tid; i < RB * R; i += kThreads) {
        const int r = i / R, n = i % R;
        if constexpr (kFeat) {
          cur[i] = a.scalar
                       ? fmaf(opnd<WT>(xamp[r]),
                              ldw(a.causal_w + (size_t)KC * R + n), sprev[i])
                       : sprev[i] +
                             ldw(a.causal_w + (size_t)(KC + xin[r]) * R + n);
        } else {
          cur[i] = (float)xin[r];
        }
      }
      // The register of step t + 1 (scalar: shifted through the free
      // partial-sum scratch).
      if constexpr (kFeat) {
        if (a.scalar) {
          for (int i = tid; i < RB * KC; i += kThreads) {
            const int r = i / KC, j = i % KC;
            part[i] = j + 1 < KC ? causal[i + 1] : xamp[r];
          }
        } else {
          for (int i = tid; i < RB * KC; i += kThreads)
            causal[i] = (i % KC == xin[i / KC]) ? 1.f : 0.f;
        }
      }
      // The codes emitted by the last step (written here, after the
      // step's first barrier, rather than before the hand-off's fence).
      if (t > 0 && tid < RB && row0 + tid < B)
        a.codes[(size_t)(row0 + tid) * a.n_total + t - 1] = xin[tid];
      __syncthreads();
      if (kFeat && a.scalar)
        for (int i = tid; i < RB * KC; i += kThreads) causal[i] = part[i];
    } else {
      // This step's LC terms, while the chain runs in the CTAs before.
      if constexpr (kLc) {
        if (!lc_after) lc_terms<RB>(a, t, row0, l0, nl, NL, D, lcr, lcp);
      }
      if (tid == 0) mbar_expect_tx(bar, (uint32_t)(RB * R * 4));
      mbar_wait(bar, (uint32_t)(t & 1));
    }
    __syncthreads();
    CLUSTER_PHASE(kPhRingWait);

    // This CTA's layers, weights from shared memory. Each warp computes
    // whole output columns: its lanes split K into groups and add their
    // partial sums with shuffles, so a layer takes two block barriers.
    for (int j = 0; j < nl; ++j) {
      if constexpr (kRing) {
        for (int i = tid; i < RB * R; i += kThreads)
          ins[((i / R) * NL + j) * R + i % R] = cur[i];
      }
      {
        // fg = [past | current] @ layer_w[l] + layer_add[l, row]
        float acc[RB], gv[RB];
        if constexpr (kFg) {
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] = 0.f;
          const float* W = wfg + (size_t)j * sh.fg_floats +
                           warp * sh.fg_it * 32 + lane;
          // k = fg_g + it * fg_groups: the past half, then the current half.
          const int G = sh.fg_groups;
          const int n_past = fg_g < R ? (R - fg_g + G - 1) / G : 0;
          const int n_all = fg_g < 2 * R ? (2 * R - fg_g + G - 1) / G : 0;
          if constexpr (kRing)
            lane_dot<RB, WT>(W, past + j * R + fg_g, NL * R, G, n_past, acc,
                             false);
          else   // past = cur
            lane_dot<RB, WT>(W, cur + fg_g, R, G, n_past, acc, rc);
          lane_dot<RB, WT>(W + n_past * 32, cur + fg_g - R + n_past * G, R,
                           G, n_all - n_past, acc, rc);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            for (int off = sh.fcols; off < 32; off <<= 1)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
            gv[r] = __shfl_down_sync(0xffffffffu, acc[r], sh.fcols / 2);
          }
        }
        if (!gate_lane) {
          const float* ad = addb + j * 2 * D;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r % sh.fg_groups == fg_g) {
              float f, g;
              if constexpr (kFg) {
                f = acc[r] + ad[r * NL * 2 * D + fdim];
                g = gv[r] + ad[r * NL * 2 * D + D + fdim];
              } else {   // R == D: fg = [past | cur]
                g = cur[r * R + fdim];
                f = kRing ? past[(r * NL + j) * R + fdim] : g;
              }
              if constexpr (kLc) {
                const float* lp = lcp + (r * NL + j) * 2 * D;
                f += lp[fdim];
                g += lp[D + fdim];
              }
              if constexpr (kTanh)
                outs[(r * NL + j) * D + fdim] =
                    opnd<WT>(tanhf(f) * (0.5f + 0.5f * tanhf(g)),
                             kDense && rc);
              else
                outs[(r * NL + j) * D + fdim] = opnd<WT>(f + g, kDense && rc);
            }
          }
        }
      }
      CLUSTER_PHASE(kPhFgProduct);
      __syncthreads();
      CLUSTER_PHASE(kPhFgSync);
      if constexpr (kDense) {
        // current += out @ dense_w[l] + dense_add[l]
        float acc[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] = 0.f;
        const float* W = wd + (size_t)j * sh.d_floats +
                         warp * sh.d_it * 32 + lane;
        const int G = sh.d_groups;
        const int n_d = d_g < D ? (D - d_g + G - 1) / G : 0;
        lane_dot<RB, WT>(W, outs + j * D + d_g, NL * D, G, n_d, acc, false);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          for (int off = sh.dcols; off < 32; off <<= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          if (r % sh.d_groups == d_g)
            cur[r * R + dn] = (cur[r * R + dn] + acc[r]) + dadd[j * R + dn];
        }
      } else {   // R <= D: current += out[:, :R]
        for (int i = tid; i < RB * R; i += kThreads)
          cur[i] += outs[((i / R) * NL + j) * D + i % R];
      }
      CLUSTER_PHASE(kPhDenseProduct);
      __syncthreads();
      CLUSTER_PHASE(kPhDenseSync);
    }

    // Hand the residual to the next CTA of the chain: asynchronous stores
    // into its shared memory that complete on its mbarrier (no fence).
    if (rank + 1 < CS) {
      const uint32_t dst = cluster_addr(cur, (uint32_t)(rank + 1));
      const uint32_t rbar = cluster_addr(bar, (uint32_t)(rank + 1));
      for (int i = tid; i < RB * R; i += kThreads)
        st_async(dst + 4 * i, cur[i], rbar);
    }
    // The ring rows of this CTA's layers: this step's inputs.
    for (int i = tid; i < (kRing ? RB * nl * R : 0); i += kThreads) {
      const int r = i / (nl * R), j = (i / R) % nl, q = i % R;
      const int row = row0 + r;
      const int pos = meta[j] + (int)(step % (long long)meta[NL + j]);
      if (row < B)
        ring_store<ST>(a.ring, ((size_t)pos * B + row) * R + q,
                       ins[(r * NL + j) * R + q]);
    }
    if (kFeat && rank == 0) {
      // The next step's causal product, off the chain.
      matvec<RB>(causal, KC, KC, a.causal_w, R, part,
                 [&](int r, int n, float s) { sprev[r * R + n] = s; });
    }
    // The next step's LC terms in the CTAs that compute them here.
    if constexpr (kLc) {
      if (lc_after && t + 1 < a.n_total)
        lc_terms<RB>(a, t + 1, row0, l0, nl, NL, D, lcr, lcp);
    }
    CLUSTER_PHASE(kPhHandoff);

    // Skip partial of this CTA's layers, in layer order; h1 starts as
    // skip_b (the head adds the partials to it). Without the skip product,
    // psum keeps its zeros.
    for (int n0 = 0; n0 < S; n0 += kSkipCols * kThreads) {
      float acc[kSkipCols][RB];
#pragma unroll
      for (int c = 0; c < kSkipCols; ++c)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[c][r] = 0.f;
      // This CTA's layers in order, kBatch terms of k loaded at once.
      constexpr int kBatch = 16;
      for (int j = 0; j < (kSkip ? nl : 0); ++j) {
        const WT* W = a.skip_w + (size_t)(l0 + j) * D * S + n0 + tid;
        const float* o = outs + j * D;
        for (int k0 = 0; k0 < D; k0 += kBatch) {
          float w[kBatch][kSkipCols];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
#pragma unroll
            for (int c = 0; c < kSkipCols; ++c)
              w[u][c] = (k0 + u < D && n0 + tid + c * kThreads < S)
                            ? ldw(W + (size_t)(k0 + u) * S + c * kThreads)
                            : 0.f;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (k0 + u < D) {
#pragma unroll
              for (int c = 0; c < kSkipCols; ++c)
#pragma unroll
                for (int r = 0; r < RB; ++r)
                  acc[c][r] = fmaf(kDense ? o[r * NL * D + k0 + u]
                                          : opnd<WT>(o[r * NL * D + k0 + u],
                                                     rc),
                                   w[u][c], acc[c][r]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kSkipCols; ++c) {
        const int n = n0 + tid + c * kThreads;
        if (n < S) {
          const float b = __ldg(a.skip_b + n);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if constexpr (kSkip) psum[r * S + n] = acc[c][r];
            h1[r * S + n] = b;
          }
        }
      }
    }
    CLUSTER_PHASE(kPhSkipPartial);
    cluster.sync();   // B1: every partial skip sum written
    CLUSTER_PHASE(kPhBarrier1);

    // h1 = relu(partials in rank order + skip_b), the whole S per row; two
    // elements a thread at once, every partial loaded before the adds.
    for (int i = tid; i < (kHead ? RB * S : 0); i += 2 * kThreads) {
      const int i2 = i + kThreads;
      float v[2][kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < CS) {
          const float* p = cluster.map_shared_rank(psum, q);
          v[0][q] = p[i];
          v[1][q] = i2 < RB * S ? p[i2] : 0.f;
        }
      }
      float s0 = v[0][0], s1 = v[1][0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q) {
        if (q < CS) {
          s0 += v[0][q];
          s1 += v[1][q];
        }
      }
      h1[i] = opnd<WT>(fmaxf(s0 + h1[i], 0.f));
      if (i2 < RB * S) h1[i2] = opnd<WT>(fmaxf(s1 + h1[i2], 0.f));
    }
    __syncthreads();
    CLUSTER_PHASE(kPhSkipSum);
    if constexpr (kHead) {
      // This CTA's columns of post1, stored into every CTA's h2.
      head_matvec<RB>(h1, S, a.post1_w + c0, S, Sl,
                      a.post1_b + c0, part,
                      [&](int r, int n, float s, float b) {
                        const float v = opnd<WT>(fmaxf(s + b, 0.f));
                        for (int q = 0; q < CS; ++q)
                          cluster.map_shared_rank(h2, q)[r * S + c0 + n] = v;
                      });
      CLUSTER_PHASE(kPhPost1Gather);
      cluster.sync();   // B2: h2 whole in every CTA
      CLUSTER_PHASE(kPhBarrier2);

      // This CTA's classes of the logits.
      head_matvec<RB>(h2, S, a.post2_w + q0, Q, Ql,
                      a.post2_b + q0, part,
                      [&](int r, int n, float s, float b) {
                        lg[r * Ql + n] = s + b;
                      });
    } else {
      // Every class's logit: the last CTA's cur[0] (final since B1).
      const float* last = cluster.map_shared_rank(cur, CS - 1);
      for (int i = tid; i < RB * Ql; i += kThreads) lg[i] = last[(i / Ql) * R];
    }
    __syncthreads();
    if (a.n_log > 0 && t >= log_from) {
      for (int i = tid; i < RB * Ql; i += kThreads) {
        const int row = row0 + i / Ql;
        if (row < B)
          a.logits[((size_t)row * a.n_log + (t - log_from)) * Q + q0 +
                   i % Ql] = lg[i];
      }
    }
    CLUSTER_PHASE(kPhPost2Logits);
    // Gumbel-argmax over this CTA's classes, one warp per row; the best
    // goes to CTA 0.
    if (warp < RB) {
      const int r = warp, row = row0 + r;
      float bv = -INFINITY;
      int bi = Q;
      for (int blk = q0 / 4 + lane; blk * 4 < q0 + Ql; blk += 32) {
        uint32_t c[4] = {(uint32_t)blk, (uint32_t)row, (uint32_t)step,
                         (uint32_t)((unsigned long long)step >> 32)};
        if constexpr (kSample) philox4x32_10(c, a.key0, a.key1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * blk + j;
          float sc = __fmul_rn(lg[r * Ql + q - q0], a.inv_temperature);
          if constexpr (kSample) {
            float u = __uint_as_float((c[j] >> 9) | 0x3F800000u) - 1.0f;
            u = fmaxf(u, 1e-20f);
            const float gmb = -logf(-logf(u));
            sc = __fadd_rn(sc, gmb);
          }
          if (better(sc, q, bv, bi)) {
            bv = sc;
            bi = q;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        cluster.map_shared_rank(cand_v, 0)[rank * RB + r] = bv;
        cluster.map_shared_rank(cand_i, 0)[rank * RB + r] = bi;
      }
    }
    CLUSTER_PHASE(kPhGumbelArgmax);
    cluster.sync();   // B3: every candidate in CTA 0

    if (rank == 0 && tid < RB) {
      const int r = tid, row = row0 + r;
      float bv = cand_v[r];
      int bi = cand_i[r];
      for (int q = 1; q < CS; ++q)
        if (better(cand_v[q * RB + r], cand_i[q * RB + r], bv, bi)) {
          bv = cand_v[q * RB + r];
          bi = cand_i[q * RB + r];
        }
      const int sampled = bi < Q ? bi : 0;
      int nx = sampled;
      float amp = a.scalar ? decode_amp(sampled, mu) : 0.f;
      // Body t consumes input t and emits input t + 1: forced while
      // t + 1 < n_forced, then the sampled code.
      if (row < B && t + 1 < a.n_forced) {
        const size_t at = (size_t)row * a.n_forced + t + 1;
        if (a.scalar) {
          amp = forced_f[at];
          nx = mu_law_encode(amp, mu);
        } else {
          nx = forced_i[at];
        }
      }
      xin[r] = nx;
      xamp[r] = amp;
    }
    __syncthreads();
    CLUSTER_PHASE(kPhBarrier3Pick);
  }
#ifdef SAMPLER_CLUSTER_PROBE
  if (probe_thread) {
#pragma unroll
    for (int k = 0; k < kClusterPhases; ++k)
      g_phase_cycles[rank][k] += phase_cycles[k];
    g_phase_cycles[rank][kClusterPhases] +=
        (unsigned long long)(clock64() - loop_start);
  }
#endif

  if (rank == 0) {
    for (int i = tid; i < RB * KC; i += kThreads) {
      const int row = row0 + i / KC;
      if (row < B) a.causal[(size_t)row * KC + i % KC] = causal[i];
    }
    if (tid < RB && row0 + tid < B) {
      a.codes[(size_t)(row0 + tid) * a.n_total + a.n_total - 1] = xin[tid];
      if (a.next_amp) a.next_amp[row0 + tid] = xamp[tid];
    }
  }
  cluster.sync();   // no CTA leaves while another may touch its memory
}

// The launch of `clusters` clusters of cs CTAs, `bytes` of shared memory
// each, with the kernel's attributes set for it.
template <int RB, int kFixed, typename WT, bool kLc = false,
          unsigned kMask = kFullStep, typename ST = float>
cudaError_t configure(int cs, size_t bytes, int clusters, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  auto kernel = sampler_cluster_kernel<RB, kFixed, WT, kLc, kMask, ST>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  if (cs > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int RB, int kFixed, typename WT, bool kLc,
          unsigned kMask = kFullStep, typename ST = float>
cudaError_t launch(const ClusterArgs<WT>& ca, size_t bytes,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<RB, kFixed, WT, kLc, kMask, ST>(
      ca.cs, bytes, (ca.a.B + RB - 1) / RB, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(
      &cfg, sampler_cluster_kernel<RB, kFixed, WT, kLc, kMask, ST>, ca);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of cs CTAs with `bytes` of shared memory each that the device
// keeps resident at once (counted for the kernel of runtime widths, which
// takes at least the registers of a width-compiled one).
template <int RB>
cudaError_t max_clusters(int cs, size_t bytes, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<RB, 0, float>(cs, bytes, 1, nullptr, cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      n, sampler_cluster_kernel<RB, 0, float>, &cfg);
}

// Calls f(std::integral_constant<int, rb>) for rb rows a cluster, 1..8.
template <typename F>
cudaError_t with_rows(int rb, F f) {
  switch (rb) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}


// The plan of a launch whose arguments ca.a are set: cs CTAs a cluster,
// rb rows a cluster, layer_begin[cs + 1] (host memory) the layer ranges.
// Checks the widths and the plan, fills ca's plan and sets *bytes to the
// shared memory a CTA takes. Returns 0 or a CUDA error code.
template <typename WT>
int cluster_prepare(ClusterArgs<WT>& ca, int cs, int rb,
                    const int* layer_begin, size_t* bytes) {
  const DecodeArgsT<WT>& a = ca.a;
  const int L = a.L, R = a.R, D = a.D;
  if (a.B < 1 || a.n_total < 1 || a.n_forced < 1 || a.KC < 1 ||
      (a.scalar && a.KC > kThreads) || cs < 1 || cs > kMaxCluster ||
      cs > L || a.S % cs != 0 || a.Q % (4 * cs) != 0 || D < 8 || D > 128 ||
      128 % D != 0 || R < 8 || R > 256 || 256 % R != 0 ||
      layer_begin[0] != 0 || layer_begin[cs] != L)
    return (int)cudaErrorInvalidValue;
  ca.cs = cs;
  ca.nl = 0;
  for (int k = 0; k <= kMaxCluster; ++k)
    ca.layer_begin[k] = k <= cs ? layer_begin[k] : L;
  for (int k = 0; k < cs; ++k) {
    const int n = layer_begin[k + 1] - layer_begin[k];
    if (n < 1) return (int)cudaErrorInvalidValue;
    if (n > ca.nl) ca.nl = n;
  }
  int dev = 0, smem_max = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  *bytes = cluster_smem_bytes(a, cs, ca.nl, rb);
  if (*bytes > (size_t)smem_max) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// The body of the C entry points: the arguments of sampler_decode_f32 with
// WT weights and a ring of type ST, round_chain (bf16 only, as
// DecodeArgsT's), then the plan: cs CTAs a cluster, rb rows a cluster,
// layer_begin[cs + 1] (host memory) the layer ranges; in the LC mode (kLc)
// last lc_w, the stream and C_lc.
template <typename WT, bool kLc = false, typename ST = float>
int cluster_run(const WT* causal_w, const WT* layer_w, const float* layer_add,
                const WT* dense_w, const float* dense_add, const WT* skip_w,
                const float* skip_b, const WT* post1_w, const float* post1_b,
                const WT* post2_w, const float* post2_b, const int* ring_meta,
                ST* ring, float* causal, const void* forced, int* codes,
                float* logits, float* next_amp, int B, int L, int R, int D,
                int S, int Q, int n_total, int n_forced, int n_log,
                int scalar_input, int causal_width, long long t0,
                unsigned long long seed, float inv_temperature,
                int round_chain, int cs, int rb, const int* layer_begin,
                void* stream, const WT* lc_w = nullptr,
                const float* lc = nullptr, int C_lc = 0) {
  ClusterArgs<WT> ca;
  DecodeArgsT<WT>& a = ca.a;
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
  a.next_amp = scalar_input ? next_amp : nullptr;
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
  if (kLc) {
    a.lc_w = lc_w;
    a.lc = lc;
    a.C_lc = C_lc;
  }
  if (kLc && (C_lc < 1 || !lc_w || !lc)) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int err = cluster_prepare(ca, cs, rb, layer_begin, &bytes);
  if (err != 0) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)with_rows(rb, [&](auto k) {
    constexpr int RB = decltype(k)::value;
    using F1 = Fixed<1>;
    using F2 = Fixed<2>;
    if (R == F1::R && D == F1::D && S == F1::S && Q == F1::Q && cs == F1::CS)
      return launch<RB, 1, WT, kLc, kFullStep, ST>(ca, bytes, s);
    // The LC mode compiles the paper/gc widths only; the wide config's
    // LC runs the kernel of runtime widths.
    if constexpr (!kLc) {
      if (R == F2::R && D == F2::D && S == F2::S && Q == F2::Q &&
          cs == F2::CS)
        return launch<RB, 2, WT, kLc, kFullStep, ST>(ca, bytes, s);
    }
    return launch<RB, 0, WT, kLc, kFullStep, ST>(ca, bytes, s);
  });
}

}  // namespace
