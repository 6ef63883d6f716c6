// sampler_tiles: the float32 mode of the tiles decode kernel
// (sampler_tiles.cuh, which says what it computes and why), and the device
// queries of the host's route (kernels/sampler.py: tile_plan), which the
// bf16 mode (sampler_tiles_bf16.cu) shares, since its layout and plan are
// the float32 mode's.
//
// Replaces the JAX package's large-batch decode kernels:
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed

#include "sampler_tiles.cuh"

#ifdef SAMPLER_TILES_PROBE
// The probe's clocks, [kCS][kPhases]: read (and zero) them.
extern "C" int sampler_tiles_phase_cycles(unsigned long long* out,
                                          int reset) {
  return read_phase_cycles(out, reset);
}
#endif

// tiles_smem_bytes at rb rows a cluster, so that the host's copy of the
// formula (kernels/sampler.py) can be held against this one.
extern "C" long long sampler_tiles_smem_bytes(int rb) {
  return (long long)tiles_smem_bytes(rb);
}

// Clusters of 8 CTAs at rb rows a cluster that the current device keeps
// resident at once (tile_plan's residency).
extern "C" int sampler_tiles_max_clusters(int rb, int* n) {
  return tiles_max_clusters<float>(rb, n);
}

// The arguments of sampler_decode_f32, then the plan: cs (8) CTAs a
// cluster, rb rows a cluster, layer_begin[cs + 1] (host memory) the layer
// ranges.
extern "C" int sampler_tiles_f32(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
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
