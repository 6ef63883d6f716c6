// sampler_tiles_bf16: the bf16 mode of the tiles decode kernel
// (sampler_tiles.cuh), the JAX package's large-batch decode kernels at
// weight_dtype=bfloat16:
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed
// The six matmul weights are bf16; the layer weights are widened to float
// in shared memory, the streamed ones in registers, and each product's
// activation operand is rounded to bf16 where the JAX kernels round it.
// The plan (cs, rb, layer_begin) and the shared memory are the float32
// mode's, so the host takes them from sampler_tiles.cu; the queries below
// let the GPU tests hold this library's own against them.

#include "sampler_tiles.cuh"

#ifdef SAMPLER_TILES_PROBE
// The probe's clocks, [kCS][kPhases]: read (and zero) them.
extern "C" int sampler_tiles_phase_cycles(unsigned long long* out,
                                          int reset) {
  return read_phase_cycles(out, reset);
}
#endif

// This library's shared memory at rb rows a cluster (the float32 mode's).
extern "C" long long sampler_tiles_smem_bytes(int rb) {
  return (long long)tiles_smem_bytes(rb);
}

// Clusters of this mode's kernel that the current device keeps resident.
extern "C" int sampler_tiles_max_clusters(int rb, int* n) {
  return tiles_max_clusters<__nv_bfloat16>(rb, n);
}

// The arguments of sampler_decode_bf16 (round_chain: 1 rounds the layer
// chain's inputs to bf16, 0 keeps them float32, as at B = 1), then the
// plan of sampler_tiles_f32.
extern "C" int sampler_tiles_bf16(
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
  return tiles_run<__nv_bfloat16>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain, cs,
      rb, layer_begin, stream);
}
