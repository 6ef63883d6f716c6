// matvec_probe_cluster: a dependent chain of small matrix-vector products
// in the form of the cluster decode kernel's layer chain
// (sampler_cluster.cuh), for NVIDIA Hopper (sm_90a): weights resident in
// the shared memory of a thread-block cluster, the chain handed from CTA to
// CTA. A probe of that form, not a model.
//
// Replaces the TPU (Pallas) probe kernel of the JAX package
//   tools/r4_matvec_probe.py:96   kernel (MXU matmuls against VPU
//                                 broadcast-reduce products)
// as matvec_probe.cu does with weights in L2 (kernel="decode" in
// tools/r4_matvec_probe.py, which this source serves as kernel="cluster").
//
// It computes matvec_probe.cu's function: n_steps steps of L chained
// products x <- x @ w[i] * 0.25 (the *_tanh modes apply tanh after every
// even product first) on one row x of C floats, from x = 0.01, then writes
// x. The L products are split in pairs over a cluster of CS CTAs, as
// layer_split splits layers (the host's pair_begin[CS + 1]): CTA k owns
// products [2 pair_begin[k], 2 pair_begin[k + 1]) and copies their weights
// into its shared memory once a launch, in its lanes' read order (C = 64,
// L = 60, CS = 8: 4 pairs, 128 KB a CTA, 2 on the last). CTA k hands x to
// CTA k + 1 by asynchronous stores (st.async) that complete on that CTA's
// mbarrier (cluster_ptx.cuh); the last CTA hands it back to CTA 0 for the
// next step: CS hand-offs a step (none at CS = 1). Modes, the TPU tool's
// question "can the chain avoid the block barrier?" asked of resident
// weights:
//   mxu       the cluster kernel's chain form: 8 warps each own C / 8
//             output columns, the lanes split K into 32 / (C / 8) groups,
//             the partial sums meet in a shuffle tree, x is double-buffered
//             in shared memory, one block barrier a product
//   vpu       one warp a CTA holds the chain, x in registers (replicated
//             across the lanes, then distributed, as matvec_probe.cu's vpu
//             form): shuffles only, no block barrier, x through shared
//             memory only at a hand-off
//   mxu_tanh, vpu_tanh   the same with the tanh
// L must be even.
//
// What bounds it. C * C FMAs a product on weights in shared memory: far
// below any rate bound (60 x 64 x 64 x 4 B = 0.98 MB in all, read once a
// launch). The chain's latency per product and per hand-off is the
// quantity measured (PERF.md): on an H100 at C = 64 a product takes ~210
// ns in the mxu form and a hand-off ~110 ns; the vpu form's product takes
// ~670 ns (64-long FMA chains and 5 x 64 shuffles a pair) and its
// hand-off ~1.9 us.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChainThreads = 256;
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kMaxChainCluster = 16;
constexpr int kUnsupported = 1000;

struct ChainPlan {
  int cs;
  int pair_begin[kMaxChainCluster + 1];
};

// Dynamic shared memory of a CTA that owns np pairs: the mbarrier, x twice,
// 2 np weight matrices (cluster_smem_bytes in tools/r4_matvec_probe.py).
__host__ __device__ inline size_t chain_smem_bytes(int C, int np) {
  return 16 + 4 * ((size_t)2 * C + (size_t)2 * np * C * C);
}

template <int C, bool kTanh>
__global__ void __launch_bounds__(kChainThreads, 1)
mxu_cluster_kernel(const float* __restrict__ w, float* __restrict__ out,
                   int n_steps, const ChainPlan p) {
  constexpr int kCols = C / kChainWarps;   // output columns a warp
  constexpr int kGroups = 32 / kCols;      // K groups a column
  constexpr int kIt = C / kGroups;         // K terms a lane
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = p.cs;
  const int rank = (int)cluster.block_rank();
  const int i0 = 2 * p.pair_begin[rank];
  const int nprod = 2 * p.pair_begin[rank + 1] - i0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = warp * kCols + lane % kCols, g = lane / kCols;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* x = reinterpret_cast<float*>(smem_raw + 16);   // [2][C]
  float* W = x + 2 * C;                                 // [nprod][C * C]
  // Once a launch: this CTA's weights in the order its lanes read them
  // (product, warp, K step, lane), so a warp's load is 32 consecutive floats.
  for (int idx = tid; idx < nprod * C * C; idx += kChainThreads) {
    const int j = idx / (C * C), e = idx % (C * C);
    const int wp = e / (kIt * 32), it = (e / 32) % kIt, l = e % 32;
    const int c = wp * kCols + l % kCols, k = l / kCols + it * kGroups;
    W[idx] = w[((size_t)(i0 + j) * C + k) * C + c];
  }
  if (tid < C) x[tid] = 0.01f;   // CTA 0's start (the others receive it)
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  cluster.sync();   // every mbarrier initialised before any remote arrive

  int waits = 0;
  for (int t = 0; t < n_steps; ++t) {
    if (CS > 1 && (rank > 0 || t > 0)) {
      if (tid == 0) mbar_expect_tx(bar, (uint32_t)(C * 4));
      mbar_wait(bar, (uint32_t)(waits & 1));
      ++waits;
    }
    for (int j = 0; j < nprod; ++j) {
      // Reads x[j % 2], writes x[(j + 1) % 2]: one barrier a product.
      const float* xs = x + (j & 1) * C;
      const float* Wj = W + (size_t)j * C * C + warp * kIt * 32 + lane;
      float acc = 0.f;
#pragma unroll
      for (int it = 0; it < kIt; ++it)
        acc = fmaf(xs[g + it * kGroups], Wj[it * 32], acc);
#pragma unroll
      for (int off = kCols; off < 32; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) {
        if (kTanh && j % 2 == 0) acc = tanhf(acc);
        x[((j + 1) & 1) * C + col] = acc * 0.25f;
      }
      __syncthreads();
    }
    // nprod is even: the CTA's result is in x[0], where the next CTA's
    // hand-off lands too.
    if (CS > 1 && (rank + 1 < CS || t + 1 < n_steps)) {
      const uint32_t dst = (uint32_t)((rank + 1) % CS);
      const uint32_t rx = cluster_addr(x, dst), rbar = cluster_addr(bar, dst);
      if (tid < C) st_async(rx + 4 * tid, x[tid], rbar);
    }
  }
  if (rank == CS - 1 && tid < C) out[tid] = x[tid];
  cluster.sync();   // no CTA leaves while another may store into it
}

template <int C, bool kTanh>
__global__ void __launch_bounds__(32, 1)
vpu_cluster_kernel(const float* __restrict__ w, const float* __restrict__ wt,
                   float* __restrict__ out, int n_steps, const ChainPlan p) {
  static_assert(C % 32 == 0, "a lane holds C / 32 elements");
  constexpr int E = C / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = p.cs;
  const int rank = (int)cluster.block_rank();
  const int i0 = 2 * p.pair_begin[rank];
  const int np = p.pair_begin[rank + 1] - p.pair_begin[rank];
  const int lane = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* x = reinterpret_cast<float*>(smem_raw + 16);   // [C] hand-off
  float* W = x + 2 * C;                                 // [2 np][C * C]
  // Once a launch: even products as w, odd ones as wt (each row-major, so
  // lanes read neighbouring addresses).
  for (int idx = lane; idx < 2 * np * C * C; idx += 32) {
    const int j = idx / (C * C);
    W[idx] = (j % 2 ? wt : w)[(size_t)(i0 + j) * C * C + idx % (C * C)];
  }
  if (lane == 0) mbar_init(bar, 1);
  __syncwarp();
  cluster.sync();

  float xr[C];   // x, replicated in every lane
#pragma unroll
  for (int k = 0; k < C; ++k) xr[k] = 0.01f;
  int waits = 0;
  for (int t = 0; t < n_steps; ++t) {
    if (CS > 1 && (rank > 0 || t > 0)) {
      if (lane == 0) mbar_expect_tx(bar, (uint32_t)(C * 4));
      mbar_wait(bar, (uint32_t)(waits & 1));
      ++waits;
#pragma unroll
      for (int k = 0; k < C; ++k) xr[k] = x[k];
    }
    for (int q = 0; q < np; ++q) {
      // Even product: replicated -> distributed (lane owns lane + 32e).
      const float* w0 = W + (size_t)(2 * q) * C * C;
      float yd[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k)
          acc = fmaf(xr[k], w0[k * C + lane + 32 * e], acc);
        yd[e] = (kTanh ? tanhf(acc) : acc) * 0.25f;
      }
      // Odd product: distributed -> replicated.
      const float* w1 = W + (size_t)(2 * q + 1) * C * C;
      float ps[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc = fmaf(yd[e], w1[j * C + lane + 32 * e], acc);
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
    if (CS > 1 && (rank + 1 < CS || t + 1 < n_steps)) {
      const uint32_t dst = (uint32_t)((rank + 1) % CS);
      const uint32_t rx = cluster_addr(x, dst), rbar = cluster_addr(bar, dst);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j % 32 == lane) st_async(rx + 4 * j, xr[j], rbar);
    }
  }
  if (rank == CS - 1) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (j % 32 == lane) out[j] = xr[j];
  }
  cluster.sync();
}

template <typename K, typename... Args>
int launch_chain(K kernel, int threads, const ChainPlan& p, size_t bytes,
                 cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && p.cs > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args..., p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int C>
int run(int mode, const float* w, const float* wt, float* out, int n_steps,
        const ChainPlan& p, size_t bytes, cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch_chain(mxu_cluster_kernel<C, false>, kChainThreads, p,
                          bytes, st, w, out, n_steps);
    case 1:
      return launch_chain(vpu_cluster_kernel<C, false>, 32, p, bytes, st, w,
                          wt, out, n_steps);
    case 2:
      return launch_chain(mxu_cluster_kernel<C, true>, kChainThreads, p,
                          bytes, st, w, out, n_steps);
    case 3:
      return launch_chain(vpu_cluster_kernel<C, true>, 32, p, bytes, st, w,
                          wt, out, n_steps);
    default:
      return kUnsupported;
  }
}

}  // namespace

// One launch of mode ``mode`` (0 mxu, 1 vpu, 2 mxu_tanh, 3 vpu_tanh):
// w [L, C, C] and wt [L, C, C] (wt[i] = w[i] transposed) float32, out [C];
// C in {32, 64}, L even; cs CTAs a cluster, pair_begin[cs + 1] (host
// memory) their pair ranges, from 0 to L / 2. Returns 0, a CUDA error code
// (cudaErrorInvalidConfiguration where a CTA's weights exceed the device's
// opt-in shared memory), or 1000 for a width or mode not built.
extern "C" int matvec_probe_cluster_run(int mode, const float* w,
                                        const float* wt, float* out, int C,
                                        int L, int n_steps, int cs,
                                        const int* pair_begin,
                                        void* stream) {
  if (L < 2 || L % 2 || n_steps < 0 || cs < 1 || cs > kMaxChainCluster ||
      pair_begin[0] != 0 || pair_begin[cs] != L / 2)
    return (int)cudaErrorInvalidValue;
  if (C != 32 && C != 64) return kUnsupported;
  ChainPlan p = {};
  p.cs = cs;
  int np_max = 0;
  for (int k = 0; k <= kMaxChainCluster; ++k)
    p.pair_begin[k] = k <= cs ? pair_begin[k] : L / 2;
  for (int k = 0; k < cs; ++k) {
    const int n = pair_begin[k + 1] - pair_begin[k];
    if (n < 1) return (int)cudaErrorInvalidValue;
    if (n > np_max) np_max = n;
  }
  int dev = 0, smem_max = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return (int)cudaErrorInvalidDevice;
  const size_t bytes = chain_smem_bytes(C, np_max);
  if (bytes > (size_t)smem_max) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C == 64) return run<64>(mode, w, wt, out, n_steps, p, bytes, st);
  return run<32>(mode, w, wt, out, n_steps, p, bytes, st);
}

// The current device's opt-in shared memory per block, which the host's
// split (tools/r4_matvec_probe.py: cluster_split) reads.
extern "C" int matvec_probe_cluster_smem_optin(int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}
