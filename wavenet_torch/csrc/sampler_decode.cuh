// The host side of sampler_decode (sampler_decode.cu says what it computes
// and why): rows a block, the launch and the body of the C entry points,
// templated on the weights' type, local conditioning and the ring's type.
// sampler_decode.cu builds the float32-ring entries, sampler_decode_ring16.cu
// the bf16-ring ones, each its own library.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sampler_step.cuh"

namespace {

// Rows sharing one block (and one read of the weights per step): as many
// as keep the grid at least one block per SM and the block's shared memory
// within what a block may opt in to on this device.
template <typename WT>
int rows_per_block(const DecodeArgsT<WT>& a) {
  int dev = 0, n_sm = 1, smem_max = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 1;
  for (int rb = 8; rb > 1; rb >>= 1)
    if (a.B >= rb * n_sm && smem_bytes(a, rb) <= (size_t)smem_max) return rb;
  return 1;
}

template <int RB, typename WT, bool kLc, typename ST>
cudaError_t launch(const DecodeArgsT<WT>& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a, RB);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sampler_decode_kernel<RB, kFullStep, WT, kLc, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.B + RB - 1) / RB;
  sampler_decode_kernel<RB, kFullStep, WT, kLc, ST>
      <<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The body of the C entry points, with WT weights and a ring of type ST;
// in the LC mode (kLc) also lc_w, the stream and C_lc.
template <typename WT, bool kLc = false, typename ST = float>
int run(const WT* causal_w, const WT* layer_w, const float* layer_add,
        const WT* dense_w, const float* dense_add, const WT* skip_w,
        const float* skip_b, const WT* post1_w, const float* post1_b,
        const WT* post2_w, const float* post2_b, const int* ring_meta,
        ST* ring, float* causal, const void* forced, int* codes,
        float* logits, float* next_amp, int B, int L, int R, int D, int S,
        int Q, int n_total, int n_forced, int n_log, int scalar_input,
        int causal_width, long long t0, unsigned long long seed,
        float inv_temperature, int round_chain, void* stream,
        const WT* lc_w = nullptr, const float* lc = nullptr, int C_lc = 0) {
  DecodeArgsT<WT> a;
  a.causal_w = causal_w;
  a.layer_w = layer_w;
  a.layer_add = layer_add;
  a.dense_w = dense_w;
  a.dense_add = dense_add;
  a.skip_w = skip_w;
  a.skip_b = skip_b;
  a.post1_w = post1_w;
  a.post1_b = post1_b;
  a.post2_w = post2_w;
  a.post2_b = post2_b;
  a.ring_meta = ring_meta;
  a.ring = ring;
  a.causal = causal;
  a.forced = forced;
  a.codes = codes;
  a.logits = logits;
  a.next_amp = scalar_input ? next_amp : nullptr;
  a.B = B;
  a.L = L;
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.n_total = n_total;
  a.n_forced = n_forced;
  a.n_log = n_log;
  a.scalar = scalar_input;
  a.KC = causal_width;
  a.t0 = t0;
  a.key0 = (uint32_t)(seed & 0xffffffffull);
  a.key1 = (uint32_t)(seed >> 32);
  a.inv_temperature = inv_temperature;
  a.round_chain = round_chain;
  if (kLc) {
    a.lc_w = lc_w;
    a.lc = lc;
    a.C_lc = C_lc;
  }
  // The scalar register shifts through the partial-sum scratch, which
  // holds kThreads floats per row.
  if (B < 1 || n_total < 1 || n_forced < 1 || causal_width < 1 ||
      (scalar_input && causal_width > kThreads) ||
      (kLc && (C_lc < 1 || !lc_w || !lc)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (rows_per_block(a)) {
    case 1: return (int)launch<1, WT, kLc, ST>(a, s);
    case 2: return (int)launch<2, WT, kLc, ST>(a, s);
    case 4: return (int)launch<4, WT, kLc, ST>(a, s);
    case 8: return (int)launch<8, WT, kLc, ST>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
