// Tensor-core and copy primitives of the stack's 3xTF32 kernels
// (fused_stack_mma.cu, fused_stack_carry.cu), as inline PTX for sm_90a,
// and the fragment loaders of their float32 shared-memory tiles.
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
// zero; the low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
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
