// Tensor-core and copy primitives of the 3xTF32 kernels (fused_stack_mma.cu,
// fused_stack_carry.cu, dilated_layer.cu), as inline PTX for sm_90a, the
// fragment loaders of their float32 shared-memory tiles and accumulators,
// and the row-contracting step of their weight gradients.
//
// 3xTF32 is the Hopper counterpart of the JAX package's mxu_dot at
// Precision.HIGHEST (wavenet_tpu/kernels/mxu.py): each float32 operand is
// split into hi = tf32_rna(a) and lo = tf32_rna(a - hi), and a product is
// lo.hi + hi.lo + hi.hi on the tensor cores with float32 accumulation
// (the lo.lo term, ~2^-22 of the product, is dropped). hi + lo keeps ~21
// of float32's 24 significant bits, where one TF32 pass keeps 11.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Round to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero; the low 13 bits of the result are zero. Two integer operations on
// the bits give cvt.rna.tf32.f32's result for every finite x and for +-inf
// (a carry out of the mantissa steps the exponent, as rounding does),
// without the compares and selects that the compiler emits for that
// instruction. A NaN whose mantissa is all ones in its top ten bits wraps
// round to -0 or +0; tf32_split keeps such a NaN in lo.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi). A NaN x keeps its NaN in lo: x - hi is
// then the device's NaN 0x7fffffff (its float32 arithmetic makes no
// other), which the signed min holds below the carry's wrap (0x7fffefff
// rounds to the TF32 NaN 0x7fffe000), so every product that takes x is
// NaN, as the float32 product is. The min leaves every other word as it
// is: a positive finite or infinite word is below 0x7fffefff, a negative
// one below 0. One min, where a compare and a select on both roundings
// cost kernel 5's f32 backward 16% on an H100 (PERF.md).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  const int d = __float_as_int(x - __uint_as_float(hi));
  lo = (static_cast<uint32_t>(min(d, 0x7fffefff)) + 0x1000u) & 0xffffe000u;
}

// D = A B + D for one warp: A m16 x k8 (row), B k8 x n8 (col), float32 D.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three passes, small terms first (lo.hi, hi.lo, then hi.hi), for NJ
// n-tiles that share A (b[j] = {hi0, hi1, lo0, lo1}), pass-major: the NJ
// accumulators' chains interleave instead of three dependent products in
// a row.
template <int NJ>
__device__ __forceinline__ void mma3_tf32_n(float (&c)[NJ][4],
                                            const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4],
                                            const uint4 (&b)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(c[j], al, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(c[j], ah, b[j].z, b[j].w);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(c[j], ah, b[j].x, b[j].y);
}

// An A fragment (m16 x k8) split into its TF32 parts.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};

// A fragment of rows m0.. and columns k0.. of a row-major tile of row
// stride S.
template <int S>
__device__ __forceinline__ void afrag(const float* s, int m0, int k0, int lane,
                                      Tf32Frag& a) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (m0 + g) * S + k0 + q;
  tf32_split(p[0], a.hi[0], a.lo[0]);
  tf32_split(p[8 * S], a.hi[1], a.lo[1]);
  tf32_split(p[4], a.hi[2], a.lo[2]);
  tf32_split(p[8 * S + 4], a.hi[3], a.lo[3]);
}

// A fragment of the transpose: A[m][k] = s[k][m] (rows m0.., k0..).
template <int S>
__device__ __forceinline__ void afrag_t(const float* s, int m0, int k0,
                                        int lane, Tf32Frag& a) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (k0 + q) * S + m0 + g;
  tf32_split(p[0], a.hi[0], a.lo[0]);
  tf32_split(p[8], a.hi[1], a.lo[1]);
  tf32_split(p[4 * S], a.hi[2], a.lo[2]);
  tf32_split(p[4 * S + 8], a.hi[3], a.lo[3]);
}

// B fragment of a row-major activation tile: B[k][n] = s[k][n], split
// {hi(b0), hi(b1), lo(b0), lo(b1)}.
template <int S>
__device__ __forceinline__ void bfrag(const float* s, int k0, int n0,
                                      int lane, uint4& b) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (k0 + q) * S + n0 + g;
  tf32_split(p[0], b.x, b.z);
  tf32_split(p[4 * S], b.y, b.w);
}

// A fragment of the transpose of a tile whose rows m >= M are not there
// (M = 8 < 16 at width 8: their elements are zero).
template <int S, int M>
__device__ __forceinline__ void afrag_tm(const float* s, int m0, int k0,
                                         int lane, Tf32Frag& a) {
  if constexpr (M >= 16) {
    afrag_t<S>(s, m0, k0, lane, a);
  } else {
    const int g = lane >> 2, q = lane & 3;
    const float* p = s + (k0 + q) * S + m0 + g;
    tf32_split(p[0], a.hi[0], a.lo[0]);
    tf32_split(p[4 * S], a.hi[2], a.lo[2]);
    a.hi[1] = a.lo[1] = a.hi[3] = a.lo[3] = 0u;
  }
}

// The A fragment of a warp's 16 x 8 accumulator tile c (rows g, g + 8;
// columns 2q, 2q + 1 a lane), split: its columns q and q + 4 live in lanes
// 4g + q/2 and 4g + q/2 + 2.
__device__ __forceinline__ void acc_afrag(const float (&c)[4], int lane,
                                          Tf32Frag& a) {
  const int src = (lane & ~3) | ((lane & 3) >> 1);
  const bool odd = lane & 1;
  float u[4], v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u[i] = __shfl_sync(0xffffffffu, c[i], src);
    v[i] = __shfl_sync(0xffffffffu, c[i], src + 2);
  }
  tf32_split(odd ? u[1] : u[0], a.hi[0], a.lo[0]);
  tf32_split(odd ? u[3] : u[2], a.hi[1], a.lo[1]);
  tf32_split(odd ? v[1] : v[0], a.hi[2], a.lo[2]);
  tf32_split(odd ? v[3] : v[2], a.hi[3], a.lo[3]);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// acc += A B over one k-step of 8 rows: the tensor core sums the step in
// a zeroed accumulator, and acc takes it by a float32 add (round to
// nearest). A weight gradient sums every step of every row; the tensor
// core's own float32 accumulation of so many terms strays several times
// as far from float64 as a plain float32 sum.
template <int NJ>
__device__ __forceinline__ void mma3_step_rn(float (&acc)[NJ][4],
                                             const Tf32Frag& a,
                                             const uint4 (&b)[NJ]) {
  float c[NJ][4];
  zero(c);
  mma3_tf32_n(c, a.hi, a.lo, b);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += c[j][i];
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace
