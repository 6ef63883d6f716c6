// sampler_tiles_ring16: the tiles decode kernel (sampler_tiles.cuh) at
// float32 weights with a bf16 ring, the JAX package's large-batch decode
// kernels at state_dtype=bfloat16:
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream
//                                              (rows stored at the ring's
//                                              dtype, :1501)
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed (rows
//                                              packed at the state dtype)
// The ring is [sum_d, B, R] bf16: each past row is widened exactly as it is
// read into `past`, each layer's float32 input rounded to nearest even as it
// is stored (four values an 8-byte store). The plan (cs, rb, layer_begin)
// and the shared memory are the float32 mode's (sampler_tiles.cu); the
// queries below let the GPU tests hold this library's own against them. Its
// own library, built the first time a bf16 ring asks for it.

#include "sampler_tiles.cuh"

// This library's shared memory at rb rows a cluster (the float32 mode's).
extern "C" long long sampler_tiles_smem_bytes(int rb) {
  return (long long)tiles_smem_bytes(rb);
}

// Clusters of this mode's kernel that the current device keeps resident.
extern "C" int sampler_tiles_max_clusters(int rb, int* n) {
  return tiles_max_clusters<float, __nv_bfloat16>(rb, n);
}

// The arguments of sampler_tiles_f32, the ring bf16.
extern "C" int sampler_tiles_f32_ring16(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature, int cs,
    int rb, const int* layer_begin, void* stream) {
  return tiles_run<float>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, 1, cs, rb,
      layer_begin, stream);
}
