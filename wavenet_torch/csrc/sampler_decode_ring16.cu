// sampler_decode_ring16: the bf16-ring modes of sampler_decode (the JAX
// package's decode kernels at state_dtype=bfloat16), at float32 and bf16
// weights, with and without local conditioning:
//   wavenet_tpu/kernels/sampler.py:234         _sampler_kernel (ring in VMEM
//                                              at state_dtype, :338-340)
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream
//                                              (rows stored at the ring's
//                                              dtype, :1501)
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed (rows
//                                              packed at the state dtype)
// The ring is [sum_d, B, R] bf16: each layer reads its past row widened
// exactly to float32 and stores its float32 input rounded to nearest even
// (sampler_step.cuh: ring_load, ring_store); everything else, and every
// argument, is as in the float32-ring entries of sampler_decode.cu. Its own
// library, built the first time a bf16 ring asks for it, so that the
// float32-ring library builds as before.

#include <cuda_bf16.h>

#include "sampler_decode.cuh"

// The arguments of sampler_decode_f32, the ring bf16.
extern "C" int sampler_decode_f32_ring16(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    void* stream) {
  return run<float>(causal_w, layer_w, layer_add, dense_w, dense_add, skip_w,
                    skip_b, post1_w, post1_b, post2_w, post2_b, ring_meta,
                    ring, causal, forced, codes, logits, next_amp, B, L, R, D,
                    S, Q, n_total, n_forced, n_log, scalar_input,
                    causal_width, t0, seed, inv_temperature, 1, stream);
}

// The arguments of sampler_decode_bf16 (round_chain included), the ring
// bf16.
extern "C" int sampler_decode_bf16_ring16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, void* stream) {
  return run<__nv_bfloat16>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain,
      stream);
}

// The arguments of sampler_decode_lc_f32, the ring bf16.
extern "C" int sampler_decode_lc_f32_ring16(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    const float* lc_w, const float* lc, int lc_channels, void* stream) {
  return run<float, true>(causal_w, layer_w, layer_add, dense_w, dense_add,
                          skip_w, skip_b, post1_w, post1_b, post2_w, post2_b,
                          ring_meta, ring, causal, forced, codes, logits,
                          next_amp, B, L, R, D, S, Q, n_total, n_forced,
                          n_log, scalar_input, causal_width, t0, seed,
                          inv_temperature, 1, stream, lc_w, lc, lc_channels);
}

// The arguments of sampler_decode_lc_bf16, the ring bf16.
extern "C" int sampler_decode_lc_bf16_ring16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    __nv_bfloat16* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, const __nv_bfloat16* lc_w, const float* lc,
    int lc_channels, void* stream) {
  return run<__nv_bfloat16, true>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain,
      stream, lc_w, lc, lc_channels);
}
