// matvec_probe: two forms of a dependent chain of small matrix-vector
// products, for NVIDIA Hopper (sm_90a). A probe of the product form that
// the b1 decode step (sampler_step.cuh) uses, not a model.
//
// Replaces the TPU (Pallas) probe kernel of the JAX package
//   tools/r4_matvec_probe.py:96   kernel (MXU matmuls against VPU
//                                 broadcast-reduce products)
//
// One launch runs n_steps steps of L chained products x <- x @ w[i] * 0.25
// (the *_tanh modes apply tanh after every even product first) on one row
// x of C floats, from x = 0.01, and writes the final x. Modes:
//   mxu       the decode step's form (sampler_step.cuh's matvec at N = C):
//             one block of 256 threads, K split over 256 / C groups, the
//             partial sums through shared memory and added in group order,
//             a block barrier inside the product and one after it
//   vpu       one warp holds the chain and alternates two layouts, as the
//             TPU tool alternates row and column vectors: an even product
//             takes x replicated in every lane and leaves y distributed
//             (lane owns outputs lane + 32e, a K-long FMA chain each,
//             reading w); an odd product takes x distributed (lane owns
//             inputs lane + 32e) and leaves y replicated, by a butterfly of
//             shuffles over the partial products (reading the transposed
//             weights wt, so that neighbouring lanes read neighbouring
//             addresses). No transposes, no shared memory, no block
//             barrier: only shuffles within the warp.
//   mxu_tanh, vpu_tanh   the same with the tanh
// L must be even (the vpu form takes products in pairs, as the TPU tool).
//
// What bounds it. Each product is C*C FMAs on weights that stay in L2 and
// L1 (60 x 64 x 64 x 4 B = 0.98 MB in all): far below any rate bound; the
// chain's latency per product is the quantity measured. On an H100 a
// product takes ~1.6 us in the mxu form and ~2.5 us in the vpu form: each
// waits for its weights from L2 (PERF.md). With the weights resident in a
// cluster's shared memory (matvec_probe_cluster.cu) they take ~0.21 and
// ~0.67 us.

#include <cuda_runtime.h>
#include <math.h>

#include "sampler_step.cuh"

namespace {

constexpr int kUnsupported = 1000;

template <int C, bool kTanh>
__global__ void __launch_bounds__(kThreads) mxu_chain_kernel(
    const float* __restrict__ w, float* __restrict__ out, int L,
    int n_steps) {
  __shared__ float s_x[C];
  __shared__ float s_part[kThreads];
  const int tid = threadIdx.x;
  if (tid < C) s_x[tid] = 0.01f;
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    for (int i = 0; i < L; ++i) {
      // The epilogue may overwrite x: every read of it precedes the
      // barrier inside matvec.
      const bool th = kTanh && (i % 2 == 0);
      matvec<1>(s_x, C, C, w + (size_t)i * C * C, C, s_part,
                [&](int, int n, float s) {
                  s_x[n] = (th ? tanhf(s) : s) * 0.25f;
                });
      __syncthreads();
    }
  }
  if (tid < C) out[tid] = s_x[tid];
}

template <int C, bool kTanh>
__global__ void __launch_bounds__(32) vpu_chain_kernel(
    const float* __restrict__ w, const float* __restrict__ wt,
    float* __restrict__ out, int L, int n_steps) {
  static_assert(C % 32 == 0, "a lane holds C / 32 elements");
  constexpr int E = C / 32;
  const int lane = threadIdx.x;
  float xr[C];   // x, replicated in every lane
#pragma unroll
  for (int k = 0; k < C; ++k) xr[k] = 0.01f;
  for (int t = 0; t < n_steps; ++t) {
    for (int i = 0; i < L; i += 2) {
      // Even product: replicated -> distributed (lane owns lane + 32e).
      const float* w0 = w + (size_t)i * C * C;
      float yd[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k)
          acc = fmaf(xr[k], __ldg(w0 + k * C + lane + 32 * e), acc);
        yd[e] = (kTanh ? tanhf(acc) : acc) * 0.25f;
      }
      // Odd product: distributed -> replicated.
      const float* w1 = wt + (size_t)(i + 1) * C * C;
      float ps[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc = fmaf(yd[e], __ldg(w1 + j * C + lane + 32 * e), acc);
        ps[j] = acc;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < C; ++j)
          ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], off);
#pragma unroll
      for (int j = 0; j < C; ++j) xr[j] = ps[j] * 0.25f;
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j % 32 == lane) out[j] = xr[j];
}

template <int C>
int run(int mode, const float* w, const float* wt, float* out, int L,
        int n_steps, cudaStream_t st) {
  switch (mode) {
    case 0:
      mxu_chain_kernel<C, false><<<1, kThreads, 0, st>>>(w, out, L, n_steps);
      break;
    case 1:
      vpu_chain_kernel<C, false><<<1, 32, 0, st>>>(w, wt, out, L, n_steps);
      break;
    case 2:
      mxu_chain_kernel<C, true><<<1, kThreads, 0, st>>>(w, out, L, n_steps);
      break;
    case 3:
      vpu_chain_kernel<C, true><<<1, 32, 0, st>>>(w, wt, out, L, n_steps);
      break;
    default:
      return kUnsupported;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of mode ``mode`` (0 mxu, 1 vpu, 2 mxu_tanh, 3 vpu_tanh):
// w [L, C, C] and wt [L, C, C] (wt[i] = w[i] transposed) float32, out [C].
// C in {32, 64}, L even. Returns 0, a CUDA error code, or 1000.
extern "C" int matvec_probe_run(int mode, const float* w, const float* wt,
                                float* out, int C, int L, int n_steps,
                                void* stream) {
  if (L < 2 || L % 2 || n_steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C == 64) return run<64>(mode, w, wt, out, L, n_steps, st);
  if (C == 32) return run<32>(mode, w, wt, out, L, n_steps, st);
  return kUnsupported;
}
