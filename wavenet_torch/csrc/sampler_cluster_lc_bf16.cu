// sampler_cluster_lc_bf16: the local-conditioning mode of the cluster
// decode kernel at bf16 weights (sampler_cluster.cuh says what it computes
// and how the LC terms leave the layer chain), the LC row of the JAX
// package's all-VMEM decode kernel at weight_dtype=bfloat16:
//   wavenet_tpu/kernels/sampler.py:234   _sampler_kernel (has_lc,
//                                        sampler.py:332-364, bf16 weights)
// The seven matmul weights (lc_w among them) are bf16 and widened to
// float; the stream's row is rounded to bf16 at every B, the layer chain's
// inputs where round_chain is set. Its own library, so that it builds in
// parallel with the other modes. The plan (cs, rb, layer_begin) and the
// shared memory are the float32 LC mode's, since the weights are widened
// into the same layout (sampler_cluster_lc_bf16_smem_bytes).

#include "sampler_cluster.cuh"

// cluster_smem_bytes in this mode, so that the host's copy of the formula
// (kernels/sampler.py) can be held against this one.
extern "C" long long sampler_cluster_lc_bf16_smem_bytes(
    int R, int D, int S, int Q, int causal_width, int cs, int nl, int rb,
    int lc_channels) {
  DecodeArgsT<__nv_bfloat16> a{};
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.KC = causal_width;
  a.C_lc = lc_channels;
  return (long long)cluster_smem_bytes(a, cs, nl, rb);
}

// The arguments of sampler_cluster_bf16 up to round_chain, then lc_w
// [L, lc_channels, 2D] in bf16 (filter | gate pre-scaled by 0.5), the
// stream lc [n_total, B, lc_channels] float32 (row t conditions step t)
// and lc_channels, then the plan.
extern "C" int sampler_cluster_lc_bf16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, const __nv_bfloat16* lc_w, const float* lc,
    int lc_channels, int cs, int rb, const int* layer_begin, void* stream) {
  return cluster_run<__nv_bfloat16, true>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain, cs,
      rb, layer_begin, stream, lc_w, lc, lc_channels);
}
