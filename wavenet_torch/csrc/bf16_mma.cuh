// Tensor-core primitives of the stack kernels' bf16 modes
// (fused_stack_mma.cu, fused_stack_carry.cu, dilated_layer.cu), as inline
// PTX for sm_90a, with the fragment loaders of their float32 shared-memory
// tiles and weights.
//
// The bf16 mode is the Hopper counterpart of the JAX package's mxu_dot on
// bf16 operands (wavenet_tpu/kernels/mxu.py: Precision.DEFAULT, one native
// pass): each product is one mma.sync m16n8k16 pass on bf16 operands with
// float32 accumulation. Operands are rounded to bf16 to nearest even, as
// ``astype(jnp.bfloat16)`` rounds; the product of two bf16 values is exact
// in float32, so only the order of the float32 sums differs from XLA's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// Two floats as one register of bf16 operands: ``lo`` in the low half (the
// element of the smaller row or column index), both rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D = A B + D for one warp: A m16 x k16 (row), B k16 x n8 (col), bf16
// operands, float32 D. Register layout (g = lane / 4, q = lane % 4):
//   a[0] = A[g][2q, 2q+1]      a[1] = A[g+8][2q, 2q+1]
//   a[2] = A[g][2q+8, 2q+9]    a[3] = A[g+8][2q+8, 2q+9]
//   b0   = B[2q, 2q+1][g]      b1   = B[2q+8, 2q+9][g]
//   c    = {C[g][2q], C[g][2q+1], C[g+8][2q], C[g+8][2q+1]}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// Lanes' fragments of a [K][N] B: ceil(K / 16) k-steps x N / 8 n-tiles x
// 32 lanes.
__host__ __device__ constexpr int bf16_frags(int K, int N) {
  return (K + 15) / 16 * (N / 8) * 32;
}

// B = at(k, n) [K][N] as fragments, by the NT threads of a block: for
// k-step ks (16) and n-tile nt, lane l holds {b0, b1} = the bf16 pairs
// {B[k, k+1][n], B[k+8, k+9][n]}, k = 16ks + 2 (l%4), n = 8nt + l/4,
// rounded to nearest even; rows k >= K (K = 8: half a k-step) are zeros.
template <int NT, int K, int N, typename F>
__device__ __forceinline__ void pack_bf16_frags(uint2* dst, F at) {
  constexpr int NTN = N / 8;
  for (int i = threadIdx.x; i < bf16_frags(K, N); i += NT) {
    const int lane = i & 31, nt = (i >> 5) % NTN, ks = (i >> 5) / NTN;
    const int k = ks * 16 + 2 * (lane & 3), n = nt * 8 + (lane >> 2);
    uint32_t b1 = 0u;
    if constexpr (K % 16 == 0) b1 = pack_bf16(at(k + 8, n), at(k + 9, n));
    dst[i] = make_uint2(pack_bf16(at(k, n), at(k + 1, n)), b1);
  }
}

// A bf16 A fragment (m16 x k16): register i of a lane as bf16_mma.cuh
// lays it out.
struct Bf16Frag {
  uint32_t v[4];
};

// The bf16 A fragment of 16 rows of float tiles of row stride S: its
// columns 0..7 from lo's, 8..15 from hi's (each pointing at the first
// row's first column); without hi (kHi false: K = 8) columns 8..15 are
// zeros.
template <int S, bool kHi = true>
__device__ __forceinline__ void afrag16(const float* lo, const float* hi,
                                        int lane, Bf16Frag& a) {
  const int g = lane >> 2, q = lane & 3;
  const float2 v0 = *reinterpret_cast<const float2*>(lo + g * S + 2 * q);
  const float2 v1 = *reinterpret_cast<const float2*>(lo + (g + 8) * S + 2 * q);
  a.v[0] = pack_bf16(v0.x, v0.y);
  a.v[1] = pack_bf16(v1.x, v1.y);
  if constexpr (kHi) {
    const float2 v2 = *reinterpret_cast<const float2*>(hi + g * S + 2 * q);
    const float2 v3 =
        *reinterpret_cast<const float2*>(hi + (g + 8) * S + 2 * q);
    a.v[2] = pack_bf16(v2.x, v2.y);
    a.v[3] = pack_bf16(v3.x, v3.y);
  } else {
    a.v[2] = a.v[3] = 0u;
  }
}

// The bf16 A fragment of the transpose, A[m][k] = s[k][m] (rows m0.. of A,
// columns k0..): the pairs along k are two rows of s; rows m >= M of A are
// not there (M = 8 < 16 at width 8: zeros).
template <int S, int M>
__device__ __forceinline__ void afrag16_t(const float* s, int m0, int k0,
                                          int lane, Bf16Frag& a) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (k0 + 2 * q) * S + m0 + g;
  a.v[0] = pack_bf16(p[0], p[S]);
  a.v[2] = pack_bf16(p[8 * S], p[9 * S]);
  if constexpr (M >= 16) {
    a.v[1] = pack_bf16(p[8], p[S + 8]);
    a.v[3] = pack_bf16(p[8 * S + 8], p[9 * S + 8]);
  } else {
    a.v[1] = a.v[3] = 0u;
  }
}

// The bf16 B fragment of a row-major float tile, B[k][n] = s[k][n].
template <int S>
__device__ __forceinline__ void bfrag16(const float* s, int k0, int n0,
                                        int lane, uint2& b) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (k0 + 2 * q) * S + n0 + g;
  b.x = pack_bf16(p[0], p[S]);
  b.y = pack_bf16(p[8 * S], p[9 * S]);
}

// One bf16 pass for NJ n-tiles that share A.
template <int NJ>
__device__ __forceinline__ void mma_bf16_n(float (&c)[NJ][4],
                                           const Bf16Frag& a,
                                           const uint2 (&b)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(c[j], a.v, b[j].x, b[j].y);
}

// acc += A B over one k-step of 16 rows, as mma3_step_rn: a zeroed
// accumulator, then a float32 add (round to nearest).
template <int NJ>
__device__ __forceinline__ void mma_bf16_step_rn(float (&acc)[NJ][4],
                                                 const Bf16Frag& a,
                                                 const uint2 (&b)[NJ]) {
  float c[NJ][4];
  zero(c);
  mma_bf16_n(c, a, b);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += c[j][i];
}

}  // namespace
