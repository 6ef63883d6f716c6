// sampler_cluster_lc_ring16: the local-conditioning mode of the cluster
// decode kernel (sampler_cluster.cuh) at float32 weights with a bf16 ring,
// the LC row of the JAX package's all-VMEM decode kernel at
// state_dtype=bfloat16:
//   wavenet_tpu/kernels/sampler.py:234   _sampler_kernel (has_lc, ring
//                                        scratch at state_dtype)
// The LC terms as in sampler_cluster_lc.cu, the ring as in
// sampler_cluster_ring16.cu; the plan and the shared memory are the float32
// LC mode's (sampler_cluster_lc_smem_bytes). Its own library, built the
// first time a bf16 ring asks for it.

#include "sampler_cluster.cuh"

// The arguments of sampler_cluster_lc_f32, the ring bf16.
extern "C" int sampler_cluster_lc_f32_ring16(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    const float* lc_w, const float* lc, int lc_channels, int cs, int rb,
    const int* layer_begin, void* stream) {
  return cluster_run<float, true>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, 1, cs, rb,
      layer_begin, stream, lc_w, lc, lc_channels);
}
