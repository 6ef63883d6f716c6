// Tensor-core and copy primitives of the stack's 3xTF32 kernels
// (fused_stack_mma.cu), as inline PTX for sm_90a.
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
