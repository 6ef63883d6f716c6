// sampler_tiles_bf16_ring16: the tiles decode kernel (sampler_tiles.cuh) at
// bf16 weights with a bf16 ring, the JAX package's large-batch decode kernels
// at weight_dtype=state_dtype=bfloat16:
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed
// The weights as in sampler_tiles_bf16.cu, the ring as in
// sampler_tiles_ring16.cu; the plan and the shared memory are the float32
// mode's, and the queries below let the GPU tests hold this library's own
// against them. Its own library, built the first time a bf16 ring asks for
// it.

#include "sampler_tiles.cuh"

// This library's shared memory at rb rows a cluster (the float32 mode's).
extern "C" long long sampler_tiles_smem_bytes(int rb) {
  return (long long)tiles_smem_bytes(rb);
}

// Clusters of this mode's kernel that the current device keeps resident.
extern "C" int sampler_tiles_max_clusters(int rb, int* n) {
  return tiles_max_clusters<__nv_bfloat16, __nv_bfloat16>(rb, n);
}

// The arguments of sampler_tiles_bf16 (round_chain included), the ring bf16.
extern "C" int sampler_tiles_bf16_ring16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, int cs, int rb, const int* layer_begin, void* stream) {
  return tiles_run<__nv_bfloat16>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain, cs,
      rb, layer_begin, stream);
}
