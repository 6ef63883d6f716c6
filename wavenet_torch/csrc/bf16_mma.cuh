// Tensor-core primitives of the stack kernel's bf16 mode
// (fused_stack_mma.cu), as inline PTX for sm_90a.
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

}  // namespace
