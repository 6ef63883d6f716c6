// b1_bisect_cluster: the b1 decode step of sampler_cluster with one part
// ablated, and its step split by phase, for NVIDIA Hopper (sm_90a). A probe
// of the cluster decode kernel (sampler_cluster.cuh), the kernel that b1
// generation runs, not a model. b1_bisect_cluster.cu builds its float32
// weights, b1_bisect_cluster_bf16.cu its bf16 weights, each its own library
// (20 instantiations each), so that the two build in parallel.
//
// Replaces the TPU (Pallas) probe kernel of the JAX package
//   tools/r3_b1_bisect.py:158   kernel (the b=1 sampler step, ablated)
// as b1_bisect.cu does for sampler_decode's step (kernel="decode" in
// tools/r3_b1_bisect.py, which this source serves as kernel="cluster").
//
// One launch runs n_total steps of one row from a zero ring and causal
// register, the first input the one forced code (Q // 2), the later ones
// the sampled codes: the JAX tool's loop. Each mode is sampler_cluster's
// kernel at RB = 1 with the mode's ablation mask (sampler_cluster.cuh says
// what each bit removes and which barriers and hand-offs it keeps), on the
// host's plan (cs CTAs a cluster, the layer ranges), the paper widths at
// CS = 8 compiled in (Fixed<1>, as the production kernel), any other
// widths at runtime. The chain's bf16 operands are rounded (round_chain =
// 1), as the JAX tool's bf16 step rounds every product's operand and as
// decode_sequential rounds them at every B, so at both weight types the
// full mode is the production launch of decode_sequential(...,
// kernel="cluster") and its codes equal that launch's. The random bits are
// the production Philox.
//
// The sources define SAMPLER_CLUSTER_PROBE: thread 0 of each CTA of the
// cluster adds the SM clocks of each phase of every step to
// g_phase_cycles[rank] (read and zeroed by b1_bisect_cluster_phase_cycles),
// in every mode; the production libraries build without it.
//
// What bounds it (paper b1 on an H100, PERF.md): the step is a chain of
// 60 dependent products whose weights sit in shared memory, spread over
// 8 CTAs with 7 hand-offs, then a head split over the cluster by three
// cluster barriers. Of the step's ~59.5k SM clocks (0.030 ms), the last
// CTA waits ~31.6k for the chain of the CTAs before it (~4.3k each for
// 4 layers and a hand-off), runs its own 2 layers in ~1.9k, and spends
// ~23k from the first cluster barrier on, ~10.7k of them in post1.

#pragma once

#ifndef SAMPLER_CLUSTER_PROBE
#error "define SAMPLER_CLUSTER_PROBE before including b1_bisect_cluster.cuh"
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampler_cluster.cuh"

namespace {

constexpr int kProbeUnsupported = 1000;

template <typename WT, int M = 0>
int probe_dispatch(int mode, bool fixed, const ClusterArgs<WT>& ca,
                   size_t bytes, cudaStream_t st) {
  if constexpr (M < kR3NumModes) {
    if (mode != M)
      return probe_dispatch<WT, M + 1>(mode, fixed, ca, bytes, st);
    return (int)(fixed
                     ? launch<1, 1, WT, false, kR3Modes[M]>(ca, bytes, st)
                     : launch<1, 0, WT, false, kR3Modes[M]>(ca, bytes,
                                                               st));
  } else {
    return kProbeUnsupported;
  }
}

// The body of b1_bisect_cluster_run at WT weights (its arguments there).
template <typename WT>
int probe_run(int mode, const void* const* w, const float* layer_add,
              const float* dense_add, const float* skip_b,
              const float* post1_b, const float* post2_b,
              const int* ring_meta, float* ring, float* causal,
              const int* forced, int* codes, float* logits, int L, int R,
              int D, int S, int Q, int n_total, unsigned long long seed,
              int cs, const int* layer_begin, cudaStream_t st) {
  if (R != D || n_total < 1 || mode < 0 || mode >= kR3NumModes)
    return (int)cudaErrorInvalidValue;
  ClusterArgs<WT> ca;
  DecodeArgsT<WT>& a = ca.a;
  a.causal_w = static_cast<const WT*>(w[0]);
  a.layer_w = static_cast<const WT*>(w[1]);
  a.layer_add = layer_add;
  a.dense_w = static_cast<const WT*>(w[2]);
  a.dense_add = dense_add;
  a.skip_w = static_cast<const WT*>(w[3]);
  a.skip_b = skip_b;
  a.post1_w = static_cast<const WT*>(w[4]);
  a.post1_b = post1_b;
  a.post2_w = static_cast<const WT*>(w[5]);
  a.post2_b = post2_b;
  a.ring_meta = ring_meta;
  a.ring = ring;
  a.causal = causal;
  a.forced = forced;
  a.codes = codes;
  a.logits = logits;
  a.next_amp = nullptr;
  a.B = 1;
  a.L = L;
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.n_total = n_total;
  a.n_forced = 1;
  a.n_log = logits ? n_total : 0;
  a.scalar = 0;
  a.KC = Q;
  a.t0 = 0;
  a.key0 = (uint32_t)(seed & 0xffffffffull);
  a.key1 = (uint32_t)(seed >> 32);
  a.inv_temperature = 1.f;
  // The JAX tool's bf16 step rounds every product's activation operand.
  a.round_chain = 1;
  size_t bytes = 0;
  const int err = cluster_prepare(ca, cs, 1, layer_begin, &bytes);
  if (err != 0) return err;
  using F1 = Fixed<1>;
  const bool fixed = R == F1::R && D == F1::D && S == F1::S && Q == F1::Q &&
                     cs == F1::CS;
  return probe_dispatch<WT>(mode, fixed, ca, bytes, st);
}

}  // namespace

// One launch of mode ``mode`` (0 full, 1 no_skip, 2 no_dense, 3 no_fg,
// 4 no_tanh, 5 no_ring, 6 no_head, 7 no_sample, 8 no_feat, 9 mm_only) of a
// mu-law model at B = 1, with b1_bisect_run's arguments (b1_bisect.cu),
// then the plan: cs CTAs a cluster, layer_begin[cs + 1] (host memory) the
// layer ranges. Each library takes its own weight type (bf16 0 in
// b1_bisect_cluster.cu, 1 in b1_bisect_cluster_bf16.cu) and returns 1000
// for the other or a mode not built; else 0 or a CUDA error code.
#define B1_BISECT_CLUSTER_RUN(WT, BF16)                                       \
  extern "C" int b1_bisect_cluster_run(                                       \
      int mode, int bf16, const void* causal_w, const void* layer_w,          \
      const float* layer_add, const void* dense_w, const float* dense_add,    \
      const void* skip_w, const float* skip_b, const void* post1_w,           \
      const float* post1_b, const void* post2_w, const float* post2_b,        \
      const int* ring_meta, float* ring, float* causal, const int* forced,    \
      int* codes, float* logits, int L, int R, int D, int S, int Q,           \
      int n_total, unsigned long long seed, int cs, const int* layer_begin,   \
      void* stream) {                                                         \
    if (bf16 != BF16) return kProbeUnsupported;                               \
    const void* w[6] = {causal_w, layer_w, dense_w, skip_w, post1_w,          \
                        post2_w};                                             \
    return probe_run<WT>(mode, w, layer_add, dense_add, skip_b, post1_b,      \
                         post2_b, ring_meta, ring, causal, forced, codes,     \
                         logits, L, R, D, S, Q, n_total, seed, cs,            \
                         layer_begin, reinterpret_cast<cudaStream_t>(stream)); \
  }

// The phase clocks, [kMaxCluster][kClusterPhases + 1] (the last column the
// step loop's whole), summed over the launches since the last reset: copy
// them to out and, if reset, zero them. b1_bisect_cluster_phases gives
// kClusterPhases, so that the host can check its names.
#define B1_BISECT_CLUSTER_CLOCK                                               \
  extern "C" int b1_bisect_cluster_phases() { return kClusterPhases; }        \
  extern "C" int b1_bisect_cluster_max_cluster() { return kMaxCluster; }      \
  extern "C" int b1_bisect_cluster_phase_cycles(unsigned long long* out,      \
                                                int reset) {                  \
    cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles,                 \
                                         sizeof(g_phase_cycles));             \
    if (e == cudaSuccess && reset) {                                          \
      static const unsigned long long zero[kMaxCluster]                       \
                                          [kClusterPhases + 1] = {};          \
      e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));             \
    }                                                                         \
    return (int)e;                                                            \
  }
