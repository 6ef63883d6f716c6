// sampler_cluster: the float32 mode of the cluster decode kernel
// (sampler_cluster.cuh, which says what it computes and why), and the
// device queries of the host's route (kernels/sampler.py: cluster_plan),
// which the bf16 mode (sampler_cluster_bf16.cu) shares, since its layout
// and plan are the float32 mode's.
//
// Replaces the JAX package's all-VMEM decode kernel:
//   wavenet_tpu/kernels/sampler.py:234   _sampler_kernel

#include "sampler_cluster.cuh"

// The current device's opt-in shared memory per block, which the host's
// cluster_plan reads.
extern "C" int sampler_cluster_smem_optin(int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// cluster_smem_bytes for a config's widths, so that the host's copy of the
// formula (kernels/sampler.py) can be held against this one.
extern "C" long long sampler_cluster_smem_bytes(int R, int D, int S, int Q,
                                                int causal_width, int cs,
                                                int nl, int rb) {
  DecodeArgsT<float> a{};
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.KC = causal_width;
  return (long long)cluster_smem_bytes(a, cs, nl, rb);
}

// The arguments of sampler_decode_f32, then the plan: cs CTAs a cluster,
// rb rows a cluster, layer_begin[cs + 1] (host memory) the layer ranges.
extern "C" int sampler_cluster_f32(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature, int cs,
    int rb, const int* layer_begin, void* stream) {
  return cluster_run<float>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, 1, cs, rb,
      layer_begin, stream);
}

// Clusters of cs CTAs, rb rows and smem_bytes of shared memory a CTA, that
// the current device keeps resident at once (cluster_plan's residency).
extern "C" int sampler_cluster_max_clusters(int cs, int rb, int smem_bytes,
                                            int* n) {
  *n = 0;
  if (cs < 1 || cs > kMaxCluster) return (int)cudaErrorInvalidValue;
  return (int)with_rows(rb, [&](auto k) {
    return max_clusters<decltype(k)::value>(cs, (size_t)smem_bytes, n);
  });
}
