// fwd_bisect: probes of the fused stack's forward (fused_stack.cu), for
// NVIDIA Hopper (sm_90a). Timing variants that drop parts of the work, at
// float32 or with bf16 operands.
//
// Replaces the TPU (Pallas) probe kernels of the JAX package
//   tools/r2_fwd_bisect.py:178   _kernel (the v3 forward with overhead
//                                sources toggled)
//   tools/r2_fwd_bisect2.py:108  _kernel (the forward's core math)
//
// fwd_bisect_run: the per-layer forward of fused_stack_fwd.cuh, one launch
// per layer as in kernel 5, each variant its own instantiation of the
// layer kernel's part mask (the TPU tool's toggles, mapped):
//   full          every part; at float32 this is kernel 5's forward
//   noshift       no gather of x(t - d): the past half of the cat tile
//                 holds zeros written at run time
//   nodma         no fg / z record writes (the TPU's record packing and DMA)
//   bare          both of those
//   mxu           the two products and the activation only: the cat tile
//                 is zeros and never refreshed from x; the residual x(t)
//                 is read in the epilogue
//   rolled        the past tap from one load of the tile and its d-row
//                 halo (TM + min(d, TM) rows) instead of two row reads per
//                 element: the Hopper counterpart of the TPU's one roll of
//                 the whole tile plus boundary fixes
//   rolled_nodma  rolled without the record writes
//
// fwd_bisect2_run: tools/r2_fwd_bisect2.py's variants. None of them reads
// another row (the TPU tool leaves the cat tile, and the fat tile's past
// lanes, unwritten), so one launch runs all L layers of a block of rows
// with everything in shared memory: the float32 residual, the cat tile
// (zeros, as the TPU's unwritten scratch reads in interpret mode), the z
// tile and each layer's weights in turn.
//   base       fg = cat @ w_fg (K = 2R), tanh * sigmoid, cur += z @ wd
//   mm_only    the two products, z = f * g
//   act_only   cur += tanh(cur) * sigmoid(cur), no products
//   one_tanh   as base with z = tanh(f) * (0.5 + 0.5 tanh(g))
//   fat        one K = 2R + 2D product a layer on the tile
//              [0 | cur | 0 | z_prev] with [L, 2R+2D, 2D+R] weights,
//              emitting fg and the next residual (through the weights'
//              identity block); the tile holds the residual in the operand
//              type, as the TPU's does
//   fat_1t     fat with z = tanh(f) * (0.5 + 0.5 tanh(g))
// A block starts from a zero fat tile; the TPU tool's scratch carried the
// previous grid step's last z into the next tile's first layer.
// Tile map: the TPU tool's tile of 1024 (2048) time steps of all B rows
// is a block of 64 (128) rows here; each block loads every layer's weights
// once, so the larger block halves the weight traffic per row.
//
// What bounds them. At the gc config and b8 x 19,071 positions, kernel 5's
// forward does 4.7e10 float32 operations (0.70 ms at 67 TFLOP/s); the
// variants do that or less. Every product is plain FMA on the CUDA cores
// (no tensor cores): at bf16 the operands are rounded to bf16 and
// multiplied in float32, so bf16 halves the bytes and the shared memory
// but not the operations. The probes measure where kernel 5's forward
// spends its time above that bound; on an H100 (PERF.md): the record
// writes ~21% of it, the tap gather ~9%, the products on the FP32 cores
// fed from shared memory ~2.2 ms of 3.1, which bf16 operands on the same
// cores do not shorten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "fused_stack_fwd.cuh"
#include "stack_common.cuh"

namespace {

constexpr int NT = kFwdNT;
constexpr int kUnsupported = 1000;

// ---------------------------------------------------------------------------
// r2_fwd_bisect: the per-layer forward with parts toggled
// ---------------------------------------------------------------------------

constexpr unsigned kLayerVariants[] = {
    kFwdFull,                                   // full
    kFwdCat | kFwdRecords,                      // noshift
    kFwdCat | kFwdShift,                        // nodma
    kFwdCat,                                    // bare
    0u,                                         // mxu
    kFwdFull | kFwdRolled,                      // rolled
    kFwdCat | kFwdShift | kFwdRolled,           // rolled_nodma
};
constexpr int kNumLayerVariants = 7;

template <int R, int D, typename OpT, unsigned kMask>
int layers_impl(const float* x, const OpT* w_fg, const OpT* wd,
                const float* add, const float* bd, const int* dil, float* y,
                OpT* fg, OpT* z, float* xbuf, int B, int T, int L,
                cudaStream_t st) {
  constexpr int smem = fwd_layer_smem_bytes<R, D, OpT, kMask>();
  cudaError_t e = cudaFuncSetAttribute(
      fwd_layer_kernel<R, D, OpT, OpT, kMask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kFwdTM - 1) / kFwdTM, B);
  const size_t btr = (size_t)B * T * R;
  for (int l = 0; l < L; ++l) {
    const float* in = l == 0 ? x : xbuf + (size_t)((l - 1) & 1) * btr;
    float* out = l == L - 1 ? y : xbuf + (size_t)(l & 1) * btr;
    fwd_layer_kernel<R, D, OpT, OpT, kMask><<<grid, NT, smem, st>>>(
        in, out, fg, z, w_fg + (size_t)l * 4 * R * D, wd + (size_t)l * D * R,
        add + (size_t)l * B * 2 * D, bd + (size_t)l * R, T, dil[l], l, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int R, int D, typename OpT, int V = 0>
int layers_dispatch(int variant, const float* x, const void* w_fg,
                    const void* wd, const float* add, const float* bd,
                    const int* dil, float* y, void* fg, void* z, float* xbuf,
                    int B, int T, int L, cudaStream_t st) {
  if constexpr (V < kNumLayerVariants) {
    if (variant == V)
      return layers_impl<R, D, OpT, kLayerVariants[V]>(
          x, static_cast<const OpT*>(w_fg), static_cast<const OpT*>(wd), add,
          bd, dil, y, static_cast<OpT*>(fg), static_cast<OpT*>(z), xbuf, B, T,
          L, st);
    return layers_dispatch<R, D, OpT, V + 1>(variant, x, w_fg, wd, add, bd,
                                             dil, y, fg, z, xbuf, B, T, L, st);
  } else {
    return kUnsupported;
  }
}

// ---------------------------------------------------------------------------
// r2_fwd_bisect2: the forward's core math, all layers of a block of rows
// ---------------------------------------------------------------------------

enum : int { kBase, kMmOnly, kActOnly, kOneTanh, kFat, kFat1t, kNumStack };

template <int V>
__device__ __forceinline__ float gate(float f, float g) {
  if constexpr (V == kMmOnly) return f * g;
  else if constexpr (V == kOneTanh || V == kFat1t)
    return tanhf(f) * (0.5f + 0.5f * tanhf(g));
  else return tanhf(f) * sigmoidf(g);
}

template <int R, int D, typename OpT, int TM, int V>
constexpr int stack_smem_bytes() {
  constexpr int KF = 2 * R + 2 * D, NF = 2 * D + R;
  if constexpr (V == kFat || V == kFat1t)
    return (int)sizeof(OpT) * (TM * (KF + 1) + KF * NF);
  else if constexpr (V == kActOnly)
    return (int)sizeof(float) * TM * R;
  else
    return (int)sizeof(float) * TM * R +
           (int)sizeof(OpT) * (TM * (2 * R + 1) + TM * (D + 1) +
                               4 * R * D + D * R);
}

// One block: TM of the M = B*T rows (x, y [M, R]), all L layers.
template <int R, int D, typename OpT, int TM, int V>
__global__ void __launch_bounds__(NT) stack_variant_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const OpT* __restrict__ w_fg, const OpT* __restrict__ wd,
    const OpT* __restrict__ wfat, int M, int L) {
  static_assert(R == D, "the variants add a D-wide z to the R-wide residual");
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int KF = 2 * R + 2 * D, NF = 2 * D + R;
  constexpr int CS = K1 + 1, ZS = D + 1, FS = KF + 1;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;

  if constexpr (V == kActOnly) {
    float* s_cur = smem;   // [TM][R]
    for (int i = tid; i < TM * R; i += NT) {
      const int m = m0 + i / R;
      s_cur[i] = m < M ? x[(size_t)m * R + i % R] : 0.f;
    }
    for (int l = 0; l < L; ++l) {
      __syncthreads();
      for (int i = tid; i < TM * R; i += NT) {
        const float v = s_cur[i];
        s_cur[i] = v + tanhf(v) * sigmoidf(v);
      }
    }
    __syncthreads();
    for (int i = tid; i < TM * R; i += NT) {
      const int m = m0 + i / R;
      if (m < M) y[(size_t)m * R + i % R] = s_cur[i];
    }
  } else if constexpr (V == kFat || V == kFat1t) {
    OpT* s_fat = reinterpret_cast<OpT*>(smem);   // [TM][FS] [0|cur|0|z]
    OpT* s_wf = s_fat + TM * FS;                 // [KF][NF] wfat[l]
    for (int i = tid; i < TM * KF; i += NT) {
      const int r = i / KF, k = i % KF, m = m0 + r;
      float v = 0.f;
      if (k >= R && k < 2 * R && m < M) v = x[(size_t)m * R + k - R];
      s_fat[r * FS + k] = op_from_f<OpT>(v);
    }
    using MF = TileMapT<TM, NT, D>;
    const int cg = tid % MF::NG, rg = tid / MF::NG;
    for (int l = 0; l < L; ++l) {
      __syncthreads();   // the previous layer's tile writes are done
      const OpT* w = wfat + (size_t)l * KF * NF;
      for (int i = tid; i < KF * NF; i += NT) s_wf[i] = w[i];
      __syncthreads();
      // out = fat @ wfat[l]: each thread owns filter column j, gate column
      // D + j and residual column 2D + j (R == D), for RM rows.
      float af[MF::RM][MF::CN], ag[MF::RM][MF::CN], an[MF::RM][MF::CN];
#pragma unroll
      for (int i = 0; i < MF::RM; ++i)
#pragma unroll
        for (int c = 0; c < MF::CN; ++c) af[i][c] = ag[i][c] = an[i][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < KF; ++k) {
        float a[MF::RM];
#pragma unroll
        for (int i = 0; i < MF::RM; ++i)
          a[i] = op_to_f(s_fat[(rg + i * MF::RG) * FS + k]);
#pragma unroll
        for (int c = 0; c < MF::CN; ++c) {
          const int j = cg + c * MF::NG;
          const float wf = op_to_f(s_wf[k * NF + j]);
          const float wg = op_to_f(s_wf[k * NF + D + j]);
          const float wn = op_to_f(s_wf[k * NF + 2 * D + j]);
#pragma unroll
          for (int i = 0; i < MF::RM; ++i) {
            af[i][c] = fmaf(a[i], wf, af[i][c]);
            ag[i][c] = fmaf(a[i], wg, ag[i][c]);
            an[i][c] = fmaf(a[i], wn, an[i][c]);
          }
        }
      }
      __syncthreads();   // every read of the tile is done
#pragma unroll
      for (int i = 0; i < MF::RM; ++i) {
        const int r = rg + i * MF::RG;
#pragma unroll
        for (int c = 0; c < MF::CN; ++c) {
          const int j = cg + c * MF::NG;
          s_fat[r * FS + R + j] = op_from_f<OpT>(an[i][c]);
          s_fat[r * FS + 2 * R + D + j] =
              op_from_f<OpT>(gate<V>(af[i][c], ag[i][c]));
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, m = m0 + r;
      if (m < M) y[(size_t)m * R + i % R] = op_to_f(s_fat[r * FS + R + i % R]);
    }
  } else {
    float* s_cur = smem;                                 // [TM][R]
    OpT* s_cat = reinterpret_cast<OpT*>(s_cur + TM * R); // [TM][CS] zeros
    OpT* s_z = s_cat + TM * CS;                          // [TM][ZS]
    OpT* s_w = s_z + TM * ZS;                            // [K1][N1]
    OpT* s_wd = s_w + K1 * N1;                           // [D][R]
    for (int i = tid; i < TM * R; i += NT) {
      const int m = m0 + i / R;
      s_cur[i] = m < M ? x[(size_t)m * R + i % R] : 0.f;
    }
    for (int i = tid; i < TM * CS; i += NT) s_cat[i] = op_from_f<OpT>(0.f);
    using M1 = TileMapT<TM, NT, D>;
    using M2 = TileMapT<TM, NT, R>;
    for (int l = 0; l < L; ++l) {
      __syncthreads();   // the previous layer's reads of the weights are done
      const OpT* w1 = w_fg + (size_t)l * K1 * N1;
      const OpT* w2 = wd + (size_t)l * D * R;
      for (int i = tid; i < K1 * N1; i += NT) s_w[i] = w1[i];
      for (int i = tid; i < D * R; i += NT) s_wd[i] = w2[i];
      __syncthreads();
      {
        const int cg = tid % M1::NG, rg = tid / M1::NG;
        float af[M1::RM][M1::CN], ag[M1::RM][M1::CN];
#pragma unroll
        for (int i = 0; i < M1::RM; ++i)
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) af[i][c] = ag[i][c] = 0.f;
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
#pragma unroll
        for (int i = 0; i < M1::RM; ++i)
#pragma unroll
          for (int c = 0; c < M1::CN; ++c)
            s_z[(rg + i * M1::RG) * ZS + cg + c * M1::NG] =
                op_from_f<OpT>(gate<V>(af[i][c], ag[i][c]));
      }
      __syncthreads();
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
            for (int i = 0; i < M2::RM; ++i)
              acc[i][c] = fmaf(a[i], w, acc[i][c]);
          }
        }
        // Each (row, column) of the residual belongs to one thread.
#pragma unroll
        for (int i = 0; i < M2::RM; ++i)
#pragma unroll
          for (int c = 0; c < M2::CN; ++c)
            s_cur[(rg + i * M2::RG) * R + cg + c * M2::NG] += acc[i][c];
      }
    }
    __syncthreads();
    for (int i = tid; i < TM * R; i += NT) {
      const int m = m0 + i / R;
      if (m < M) y[(size_t)m * R + i % R] = s_cur[i];
    }
  }
}

template <int R, int D, typename OpT, int TM, int V>
int stack_impl(const float* x, float* y, const void* w_fg, const void* wd,
               const void* wfat, int M, int L, cudaStream_t st) {
  constexpr int smem = stack_smem_bytes<R, D, OpT, TM, V>();
  cudaError_t e = cudaFuncSetAttribute(
      stack_variant_kernel<R, D, OpT, TM, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stack_variant_kernel<R, D, OpT, TM, V><<<(M + TM - 1) / TM, NT, smem, st>>>(
      x, y, static_cast<const OpT*>(w_fg), static_cast<const OpT*>(wd),
      static_cast<const OpT*>(wfat), M, L);
  return (int)cudaGetLastError();
}

template <int R, int D, typename OpT, int TM, int V = 0>
int stack_dispatch(int variant, const float* x, float* y, const void* w_fg,
                   const void* wd, const void* wfat, int M, int L,
                   cudaStream_t st) {
  if constexpr (V < kNumStack) {
    if (variant == V)
      return stack_impl<R, D, OpT, TM, V>(x, y, w_fg, wd, wfat, M, L, st);
    return stack_dispatch<R, D, OpT, TM, V + 1>(variant, x, y, w_fg, wd, wfat,
                                                M, L, st);
  } else {
    return kUnsupported;
  }
}

}  // namespace

extern "C" {

// Widths the probes are built for: R == D in {16, 32} (the paper's 32).
int fwd_bisect_supports_width(int R, int D) {
  return R == D && (R == 16 || R == 32);
}

// One call of r2_fwd_bisect's variant ``variant`` (0 full, 1 noshift,
// 2 nodma, 3 bare, 4 mxu, 5 rolled, 6 rolled_nodma): L launches. x [B,T,R]
// float32; w_fg [L,2R,2D], wd [L,D,R] in float32 (bf16 = 0) or bf16
// (bf16 = 1); add [L,B,2D], bd [L,R] float32; dil: L dilations (host
// memory); y [B,T,R] float32; fg [B,T,L*2D], z [B,T,L*D] in the operand
// type (unused by the variants without records); xbuf 2*B*T*R floats.
// Returns 0, a CUDA error code, or 1000 for a width or variant not built.
int fwd_bisect_run(int variant, int bf16, const float* x, const void* w_fg,
                   const void* wd, const float* add, const float* bd,
                   const int* dil, float* y, void* fg, void* z, float* xbuf,
                   int B, int T, int L, int R, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FWD_BISECT_CASE(W, OpT)                                            \
  if (R == W && D == W)                                                    \
    return layers_dispatch<W, W, OpT>(variant, x, w_fg, wd, add, bd, dil, \
                                      y, fg, z, xbuf, B, T, L, st);
  if (bf16) {
    FWD_BISECT_CASE(32, __nv_bfloat16)
    FWD_BISECT_CASE(16, __nv_bfloat16)
  } else {
    FWD_BISECT_CASE(32, float)
    FWD_BISECT_CASE(16, float)
  }
#undef FWD_BISECT_CASE
  return kUnsupported;
}

// One launch of r2_fwd_bisect2's variant ``variant`` (0 base, 1 mm_only,
// 2 act_only, 3 one_tanh, 4 fat, 5 fat_1t) at 64 (rows128 = 0) or 128
// rows per block. x, y [M, R] float32 (M = B*T rows); w_fg [L,2R,2D],
// wd [L,D,R], wfat [L,2R+2D,2D+R] in float32 or bf16. R == D == 32 only.
int fwd_bisect2_run(int variant, int rows128, int bf16, const float* x,
                    const void* w_fg, const void* wd, const void* wfat,
                    float* y, int M, int L, int R, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R != 32 || D != 32) return kUnsupported;
  if (bf16)
    return rows128 ? stack_dispatch<32, 32, __nv_bfloat16, 128>(
                         variant, x, y, w_fg, wd, wfat, M, L, st)
                   : stack_dispatch<32, 32, __nv_bfloat16, 64>(
                         variant, x, y, w_fg, wd, wfat, M, L, st);
  return rows128 ? stack_dispatch<32, 32, float, 128>(variant, x, y, w_fg, wd,
                                                      wfat, M, L, st)
                 : stack_dispatch<32, 32, float, 64>(variant, x, y, w_fg, wd,
                                                     wfat, M, L, st);
}

}  // extern "C"
