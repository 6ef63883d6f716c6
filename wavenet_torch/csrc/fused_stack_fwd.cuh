// The forward layer kernel of the fused stack (fused_stack.cu), shared with
// its probe (fwd_bisect.cu). One launch computes one layer l with dilation
// d over all rows (b, t); grid (tiles of TM rows of T, B):
//   fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   x' = x + (z @ wd[l] + bd[l])
// and writes the records fg [B, T, L*2D] and z [B, T, L*D].
//
// Template parameters:
//   OpT    the operand type of the weights and of the shared cat and z
//          tiles: float, or __nv_bfloat16 (converted on load; products and
//          sums in float32, the residual in float32);
//   RecT   the type of the fg and z records;
//   kMask  the parts of the layer that run (stack_common.cuh's kFwd*;
//          kFwdFull: all of them), and with kFwdTpuResidual the TPU
//          kernel's order of the residual add. The probe's variants drop
//          parts; an ablated operand is a zero that the kernel writes to
//          shared memory, so nothing is folded away;
//   WT     the type of the weights in device memory (default OpT), rounded
//          to OpT as they load.
// fused_stack.cu instantiates <R, D, float, float, kFwdFull> and, in its
// bf16 mode, <R, D, __nv_bfloat16, __nv_bfloat16, kFwdFull |
// kFwdTpuResidual, float>.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "stack_common.cuh"

namespace {

constexpr int kFwdTM = 64;    // rows (time steps of one batch row) per tile
constexpr int kFwdNT = 256;   // threads per block

__device__ __forceinline__ float op_to_f(float v) { return v; }
__device__ __forceinline__ float op_to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T op_from_f(float v);
template <>
__device__ __forceinline__ float op_from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 op_from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// A value of type From as a To (to nearest even where To is narrower).
template <typename To, typename From>
__device__ __forceinline__ To op_cast(From v) {
  if constexpr (std::is_same_v<To, From>) return v;
  else return op_from_f<To>(op_to_f(v));
}

// Shared memory of one block: weights, the cat tile (or the rolled tile
// with its halo), the z tile, and at bf16 a float32 copy of the residual.
template <int R, int D, typename OpT, unsigned kMask>
constexpr int fwd_layer_smem_bytes() {
  constexpr int TM = kFwdTM;
  constexpr bool kRolled = (kMask & kFwdRolled) != 0;
  constexpr bool kSepRes = sizeof(OpT) != sizeof(float);
  constexpr int cat = kRolled ? 2 * TM * (R + 1) : TM * (2 * R + 1);
  return (int)sizeof(OpT) * (4 * R * D + D * R + cat + TM * (D + 1)) +
         (kSepRes ? (int)sizeof(float) * TM * R : 0);
}

template <int R, int D, typename OpT, typename RecT, unsigned kMask,
          typename WT = OpT>
__global__ void __launch_bounds__(kFwdNT) fwd_layer_kernel(
    const float* __restrict__ x_in, float* __restrict__ x_out,
    RecT* __restrict__ fg_out, RecT* __restrict__ z_out,
    const WT* __restrict__ w_fg, const WT* __restrict__ wd,
    const float* __restrict__ add, const float* __restrict__ bd,
    int T, int d, int l, int L) {
  constexpr int TM = kFwdTM, NT = kFwdNT;
  constexpr bool kCat = (kMask & kFwdCat) != 0;
  constexpr bool kShift = (kMask & kFwdShift) != 0;
  constexpr bool kRecords = (kMask & kFwdRecords) != 0;
  constexpr bool kRolled = kShift && (kMask & kFwdRolled) != 0;
  constexpr bool kSepRes = sizeof(OpT) != sizeof(float);
  constexpr bool kTpuRes = (kMask & kFwdTpuResidual) != 0;
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int CS = K1 + 1;   // padded row strides (no bank conflicts)
  constexpr int ZS = D + 1;
  constexpr int XS = R + 1;    // row stride of the rolled tile
  extern __shared__ float smem[];
  float* s_res = smem;                                  // [TM][R] (bf16 only)
  OpT* s_w = reinterpret_cast<OpT*>(smem + (kSepRes ? TM * R : 0));  // [K1][N1]
  OpT* s_wd = s_w + K1 * N1;       // [D][R]    wd[l]
  OpT* s_cat = s_wd + D * R;       // [TM][CS]  [x(t-d) | x(t)], or rolled:
                                   // [TM + e][XS] x(t0-d+i) then x(t0+i)
  OpT* s_z = s_cat + (kRolled ? 2 * TM * XS : TM * CS);  // [TM][ZS]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const size_t base = (size_t)b * T;
  // The rolled tile: past of row r at row r, current at row r + e.
  const int e = d < TM ? d : TM;

  for (int i = tid; i < K1 * N1; i += NT) s_w[i] = op_cast<OpT>(w_fg[i]);
  for (int i = tid; i < D * R; i += NT) s_wd[i] = op_cast<OpT>(wd[i]);
  if (kRolled) {
    for (int i = tid; i < (TM + e) * R; i += NT) {
      const int r = i / R, c = i % R;
      const int t = r < e ? t0 - d + r : t0 + r - e;
      float v = 0.f;
      if (t >= 0 && t < T) v = x_in[(base + t) * R + c];
      s_cat[r * XS + c] = op_from_f<OpT>(v);
      if (kSepRes && r >= e) s_res[(r - e) * R + c] = v;
    }
  } else {
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      float cur = 0.f, past = 0.f;
      if (kCat && t < T) {
        cur = x_in[(base + t) * R + c];
        if (kShift && t >= d) past = x_in[(base + t - d) * R + c];
      }
      s_cat[r * CS + c] = op_from_f<OpT>(past);
      s_cat[r * CS + R + c] = op_from_f<OpT>(cur);
      if (kSepRes) s_res[r * R + c] = cur;
    }
  }
  __syncthreads();

  // fg = [past | cur] @ w_fg + add[b]: each thread owns filter column j
  // and its gate column D + j, for RM rows.
  using M1 = TileMapT<TM, NT, D>;
  {
    const int cg = tid % M1::NG, rg = tid / M1::NG;
    float af[M1::RM][M1::CN], ag[M1::RM][M1::CN];
#pragma unroll
    for (int i = 0; i < M1::RM; ++i)
#pragma unroll
      for (int c = 0; c < M1::CN; ++c) af[i][c] = ag[i][c] = 0.f;
    if (kRolled) {
      // The same FMA order as below: the past rows of K, then the current.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll 4
        for (int k = 0; k < R; ++k) {
          float a[M1::RM];
#pragma unroll
          for (int i = 0; i < M1::RM; ++i)
            a[i] = op_to_f(s_cat[(rg + i * M1::RG + h * e) * XS + k]);
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) {
            const float wf = op_to_f(s_w[(h * R + k) * N1 + cg + c * M1::NG]);
            const float wg =
                op_to_f(s_w[(h * R + k) * N1 + D + cg + c * M1::NG]);
#pragma unroll
            for (int i = 0; i < M1::RM; ++i) {
              af[i][c] = fmaf(a[i], wf, af[i][c]);
              ag[i][c] = fmaf(a[i], wg, ag[i][c]);
            }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < K1; ++k) {
        float a[M1::RM];
#pragma unroll
        for (int i = 0; i < M1::RM; ++i)
          a[i] = op_to_f(s_cat[(rg + i * M1::RG) * CS + k]);
#pragma unroll
        for (int c = 0; c < M1::CN; ++c) {
          const float wf = op_to_f(s_w[k * N1 + cg + c * M1::NG]);
          const float wg = op_to_f(s_w[k * N1 + D + cg + c * M1::NG]);
#pragma unroll
          for (int i = 0; i < M1::RM; ++i) {
            af[i][c] = fmaf(a[i], wf, af[i][c]);
            ag[i][c] = fmaf(a[i], wg, ag[i][c]);
          }
        }
      }
    }
    const float* add_b = add + (size_t)b * N1;
#pragma unroll
    for (int i = 0; i < M1::RM; ++i) {
      const int r = rg + i * M1::RG, t = t0 + r;
#pragma unroll
      for (int c = 0; c < M1::CN; ++c) {
        const int j = cg + c * M1::NG;
        const float f = af[i][c] + add_b[j];
        const float g = ag[i][c] + add_b[D + j];
        const float zz = tanhf(f) * sigmoidf(g);
        s_z[r * ZS + j] = op_from_f<OpT>(zz);
        if (kRecords && t < T) {
          const size_t row = base + t;
          fg_out[row * (size_t)(L * N1) + l * N1 + j] = op_from_f<RecT>(f);
          fg_out[row * (size_t)(L * N1) + l * N1 + D + j] = op_from_f<RecT>(g);
          z_out[row * (size_t)(L * D) + l * D + j] = op_from_f<RecT>(zz);
        }
      }
    }
  }
  __syncthreads();

  // x' = x + (z @ wd + bd), or with kTpuRes (x + z @ wd) + bd
  using M2 = TileMapT<TM, NT, R>;
  {
    const int cg = tid % M2::NG, rg = tid / M2::NG;
    float acc[M2::RM][M2::CN];
#pragma unroll
    for (int i = 0; i < M2::RM; ++i)
#pragma unroll
      for (int c = 0; c < M2::CN; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      float a[M2::RM];
#pragma unroll
      for (int i = 0; i < M2::RM; ++i)
        a[i] = op_to_f(s_z[(rg + i * M2::RG) * ZS + k]);
#pragma unroll
      for (int c = 0; c < M2::CN; ++c) {
        const float w = op_to_f(s_wd[k * R + cg + c * M2::NG]);
#pragma unroll
        for (int i = 0; i < M2::RM; ++i) acc[i][c] = fmaf(a[i], w, acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < M2::RM; ++i) {
      const int r = rg + i * M2::RG, t = t0 + r;
      if (t >= T) continue;
#pragma unroll
      for (int c = 0; c < M2::CN; ++c) {
        const int col = cg + c * M2::NG;
        // The residual: the cat tile's current half, its float32 copy at
        // bf16, or (the cat tile never refreshed) x itself.
        float res;
        if (!kCat) res = x_in[(base + t) * R + col];
        else if (kSepRes) res = s_res[r * R + col];
        else if (kRolled) res = op_to_f(s_cat[(r + e) * XS + col]);
        else res = op_to_f(s_cat[r * CS + R + col]);
        x_out[(base + t) * R + col] = kTpuRes ? (res + acc[i][c]) + bd[col]
                                              : res + (acc[i][c] + bd[col]);
      }
    }
  }
}

}  // namespace
