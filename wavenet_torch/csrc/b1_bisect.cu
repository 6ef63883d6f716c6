// b1_bisect: the b1 decode step with one part ablated, for NVIDIA Hopper
// (sm_90a). A probe of sampler_decode (sampler_step.cuh), not a model.
//
// Replaces the TPU (Pallas) probe kernel of the JAX package
//   tools/r3_b1_bisect.py:158   kernel (the b=1 sampler step, ablated)
//
// One launch runs n_total steps of one row from a zero ring and causal
// register, the first input the one forced code (Q // 2), the later ones
// the sampled codes: the JAX tool's loop. Each mode is its own
// instantiation of sampler_step.cuh's kernel (RB = 1) with the mode's
// ablation mask, at float32 or bf16 weights; the full mode at float32 is
// the production kernel, so its codes equal decode_sequential's. The
// random bits are the production Philox, keyed on the seed, the class
// block, the row and the step.
//   full       every part
//   no_skip    no skip product
//   no_dense   current += out[:, :R]
//   no_fg      fg = [past | current]
//   no_tanh    out = fg[:, :D] + fg[:, D:]
//   no_ring    past = current
//   no_head    logits = current[:, 0] in every class
//   no_sample  argmax of the logits, no noise
//   no_feat    current = x in every channel
//   mm_only    no_ring + no_tanh + no_skip + no_head: the fg and dense
//              products are what is left of the chain
//
// What bounds it. A step reads 4.3 MB of float32 weights at the paper
// config (2.1 MB at bf16) from L2 on one SM and does 2.1 MFLOP: the probe
// measures how the step's time splits between those bytes, its
// dependency chain of block barriers, and the rest. On an H100 (PERF.md)
// neither bytes nor barriers set sampler_decode's step: its 30 filter/gate
// products, each waiting for its weights from L2, are 43% of it. b1
// generation runs sampler_cluster instead, whose chain weights sit in
// shared memory; its own probe (b1_bisect_cluster.cuh) finds those
// products 12% of its 7x shorter step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampler_step.cuh"

namespace {

constexpr int kUnsupported = 1000;

template <unsigned kMask, typename WT>
int launch(const DecodeArgsT<WT>& a, cudaStream_t st) {
  const size_t bytes = smem_bytes(a, 1);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sampler_decode_kernel<1, kMask, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  sampler_decode_kernel<1, kMask, WT><<<1, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename WT, int M = 0>
int dispatch(int mode, const DecodeArgsT<WT>& a, cudaStream_t st) {
  if constexpr (M < kR3NumModes) {
    if (mode == M) return launch<kR3Modes[M], WT>(a, st);
    return dispatch<WT, M + 1>(mode, a, st);
  } else {
    return kUnsupported;
  }
}

template <typename WT>
int run(int mode, const void* const* w, const float* layer_add,
        const float* dense_add, const float* skip_b, const float* post1_b,
        const float* post2_b, const int* ring_meta, float* ring,
        float* causal, const int* forced, int* codes, float* logits, int L,
        int R, int D, int S, int Q, int n_total, unsigned long long seed,
        cudaStream_t st) {
  DecodeArgsT<WT> a;
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
  return dispatch<WT>(mode, a, st);
}

}  // namespace

// One launch of mode ``mode`` (0 full, 1 no_skip, 2 no_dense, 3 no_fg,
// 4 no_tanh, 5 no_ring, 6 no_head, 7 no_sample, 8 no_feat, 9 mm_only) of a
// mu-law model at B = 1. The weights causal_w [Q + Q, R], layer_w
// [L, 2R, 2D], dense_w [L, D, R], skip_w [L, D, S], post1_w [S, S],
// post2_w [S, Q] in float32 (bf16 = 0) or bf16 (bf16 = 1); the adds
// float32 (layer_add [L, 1, 2D], dense_add [L, R], skip_b [S], post1_b
// [S], post2_b [Q]); ring [sum_d, 1, R] and causal [1, Q] zeros, updated
// in place; forced [1, 1] the first code; codes [1, n_total] out; logits
// [1, n_total, Q] out, or null for none. Needs R == D. Returns 0, a CUDA
// error code, or 1000 for a mode not built.
extern "C" int b1_bisect_run(
    int mode, int bf16, const void* causal_w, const void* layer_w,
    const float* layer_add, const void* dense_w, const float* dense_add,
    const void* skip_w, const float* skip_b, const void* post1_w,
    const float* post1_b, const void* post2_w, const float* post2_b,
    const int* ring_meta, float* ring, float* causal, const int* forced,
    int* codes, float* logits, int L, int R, int D, int S, int Q,
    int n_total, unsigned long long seed, void* stream) {
  if (R != D || n_total < 1) return (int)cudaErrorInvalidValue;
  const void* w[6] = {causal_w, layer_w, dense_w, skip_w, post1_w, post2_w};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(mode, w, layer_add, dense_add, skip_b, post1_b,
                              post2_b, ring_meta, ring, causal, forced, codes,
                              logits, L, R, D, S, Q, n_total, seed, st);
  return run<float>(mode, w, layer_add, dense_add, skip_b, post1_b, post2_b,
                    ring_meta, ring, causal, forced, codes, logits, L, R, D,
                    S, Q, n_total, seed, st);
}
