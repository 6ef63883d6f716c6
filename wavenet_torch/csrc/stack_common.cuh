// Device and host helpers shared by the dilated-stack kernels
// (fused_stack.cu, fused_stack_mma.cu, fused_stack_carry.cu,
// dilated_layer.cu) and their probes: the forward layer's part mask,
// thread maps of register tiles over a time tile, the gate's sigmoid, the
// fixed-order reduction of per-block weight-gradient partial sums, and
// the backward's chunked grid. Each .cu is its own library, so the
// header's definitions sit in an anonymous namespace.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Parts of a forward layer (tools/r2_fwd_bisect.py's toggles), the part
// masks of fused_stack_fwd.cuh and fused_stack_mma_fwd.cuh.
enum : unsigned {
  kFwdCat = 1,      // refresh the current half of the tap tile from x
  kFwdShift = 2,    // load the past tap x(t - d) (else it reads zeros)
  kFwdRecords = 4,  // write the fg and z records
  kFwdRolled = 8,   // with kFwdShift: one load of the tile and its d-row
                    // halo, not a second row stream
  kFwdTpuResidual = 16,  // x' = (x + z @ wd) + bd, the TPU kernel's order
                         // (kernel 5's bf16 mode), not x + (z @ wd + bd)
};
constexpr unsigned kFwdFull = kFwdCat | kFwdShift | kFwdRecords;

// Thread map of a [TM, N] output tile computed by NT threads: NG column
// groups (columns interleaved with stride NG) times RG row groups (rows
// interleaved with stride RG); each thread owns RM rows x CN columns.
template <int TM, int NT, int N>
struct TileMapT {
  static constexpr int NG = N < 16 ? N : 16;
  static constexpr int CN = N / NG;
  static constexpr int RG = NT / NG;
  static constexpr int RM = TM / RG;
  static_assert(N % NG == 0 && NT % NG == 0 && TM % RG == 0, "tile map");
};

// Thread map of a [K, N] weight-gradient block computed by NT threads:
// thread tid owns column tid % N of rows tid / N + q * (NT / N), q < Q.
template <int NT, int K, int N>
struct GradMapT {
  static_assert(NT % N == 0, "grad map");
  static constexpr int P = NT / N;
  static constexpr int Q = (K + P - 1) / P;
};

__device__ __forceinline__ float sigmoidf(float g) {
  return 1.f / (1.f + expf(-g));
}

// Adds per-block partial sums in block order (no atomics, so repeated
// calls are bitwise equal). Per layer l of a grid (outputs / NT, L), over
// ncta = B * nchunk blocks (b-major):
//   part_w   [L][ncta][4RD]      -> dw_fg [L][2R][2D]
//   part_a   [L][ncta][DR + R]   -> dwd [L][D][R], dbd [L][R]
//   part_add [L][ncta][2D]       -> dadd [L][B][2D] (sum over b's chunks)
template <int NT>
__global__ void __launch_bounds__(NT) reduce_partials_kernel(
    const float* __restrict__ part_w, const float* __restrict__ part_a,
    const float* __restrict__ part_add, float* __restrict__ dw_fg,
    float* __restrict__ dwd, float* __restrict__ dbd,
    float* __restrict__ dadd, int B, int nchunk, int R, int D) {
  const int l = blockIdx.y;
  int e = blockIdx.x * NT + threadIdx.x;
  const int ncta = B * nchunk;
  const int nw = 4 * R * D, na = D * R + R, nadd = B * 2 * D;
  if (e < nw) {
    const float* p = part_w + (size_t)l * ncta * nw + e;
    float s = 0.f;
    for (int k = 0; k < ncta; ++k) s += p[(size_t)k * nw];
    dw_fg[(size_t)l * nw + e] = s;
    return;
  }
  e -= nw;
  if (e < na) {
    const float* p = part_a + (size_t)l * ncta * na + e;
    float s = 0.f;
    for (int k = 0; k < ncta; ++k) s += p[(size_t)k * na];
    if (e < D * R) dwd[(size_t)l * D * R + e] = s;
    else dbd[(size_t)l * R + e - D * R] = s;
    return;
  }
  e -= na;
  if (e < nadd) {
    const int bb = e / (2 * D), j = e % (2 * D);
    const float* p = part_add + ((size_t)l * ncta + (size_t)bb * nchunk) * (2 * D) + j;
    float s = 0.f;
    for (int k = 0; k < nchunk; ++k) s += p[(size_t)k * 2 * D];
    dadd[(size_t)l * nadd + e] = s;
  }
}

template <int NT>
cudaError_t launch_reduce_partials(const float* part_w, const float* part_a,
                                   const float* part_add, float* dw_fg,
                                   float* dwd, float* dbd, float* dadd, int B,
                                   int nchunk, int L, int R, int D,
                                   cudaStream_t st) {
  const int per_layer = 4 * R * D + D * R + R + B * 2 * D;
  reduce_partials_kernel<NT><<<dim3((per_layer + NT - 1) / NT, L), NT, 0, st>>>(
      part_w, part_a, part_add, dw_fg, dwd, dbd, dadd, B, nchunk, R, D);
  return cudaGetLastError();
}

struct Tiling {
  int tiles_per_chunk, nchunk;
};

// A backward grid of (chunks, B) blocks that all run in the first wave
// (at most per_sm blocks per SM): each block walks a fixed chunk of
// consecutive tiles of tm rows of one batch row.
inline Tiling chunk_tiling(int B, int T, int tm, int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ntiles = (T + tm - 1) / tm;
  int target = per_sm * sms / B;
  if (target < 1) target = 1;
  const int tpc = (ntiles + target - 1) / target;
  return {tpc, (ntiles + tpc - 1) / tpc};
}

}  // namespace
