// sampler_cluster_bf16: the bf16 mode of the cluster decode kernel
// (sampler_cluster.cuh), the JAX package's all-VMEM decode kernel at
// weight_dtype=bfloat16:
//   wavenet_tpu/kernels/sampler.py:234   _sampler_kernel (bf16 weights,
//                                        sampler.py:328-379)
// The six matmul weights are bf16; the layer weights are widened to float
// in shared memory, the streamed ones in registers, and each product's
// activation operand is rounded to bf16 where the JAX kernel rounds it.
// The plan (cs, rb, layer_begin) and the shared memory are the float32
// mode's, so the host reads them from sampler_cluster.cu.

#include "sampler_cluster.cuh"

// The arguments of sampler_decode_bf16 (round_chain: 1 rounds the layer
// chain's inputs to bf16, 0 keeps them float32, as at B = 1), then the
// plan of sampler_cluster_f32.
extern "C" int sampler_cluster_bf16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, int cs, int rb, const int* layer_begin, void* stream) {
  return cluster_run<__nv_bfloat16>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain, cs,
      rb, layer_begin, stream);
}
