// fused_stack_carry: the whole dilated stack of a training step in one
// launch forward and one backward, one block per batch row walking that
// row's time tiles in order, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of the JAX package's retired stack
// generations:
//   wavenet_tpu/experiments/fused_stack.py:69    _fwd_kernel  (v1)
//   wavenet_tpu/experiments/fused_stack.py:170   _bwd_kernel  (v1)
//   wavenet_tpu/experiments/fused_stack2.py:85   _fwd_kernel  (v2)
//   wavenet_tpu/experiments/fused_stack2.py:200  _bwd_kernel  (v2)
// The two generations compute one map; they differ in TPU layout (v2
// packs v1's two K=R tap matmuls into one K=2R matmul, which is the same
// FP32 arithmetic here, and emits z from the kernel). So one source serves
// both: the forward writes z only when it is given a z buffer (v2), and
// the backward is shared. Per layer l with dilation d, over all rows:
//
//   fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   x' = x + (z @ wd[l] + bd[l])
//
// Design. The TPU grid runs time tiles in order, so its kernels carry each
// layer's dilated-tap tail from one tile to the next instead of reading a
// halo. Here a loop inside the block takes the place of that sequential
// grid axis: one block per batch row walks the row's tiles of TM steps in
// order (the backward in reverse). Each tile runs all L layers with its
// residual [TM, R] in shared memory, so the residual never goes to device
// memory between layers. Each layer's tap tail lives in a per-row ring in
// device memory (L2-resident): slot p mod d holds layer l's input at
// position p for the last d positions, so a tile may be shorter than d,
// and a zero ring at t = 0 is exactly causal padding. The rings take
// sum(dilations) * R * 4 bytes a row (393 KB at the gc config, more than a
// block's shared memory). The backward rebuilds each layer's input by
// subtraction from y, as the TPU kernels do. Its ring holds da rows
// [sum_d, 2D]: x_l(p - d), the past-tap partner of da(p), lies in an
// earlier tile, which the reverse walk reaches later; that tile reads
// da(p) from the ring and forms there both the past-tap term of dx and the
// past-tap weight gradient (the TPU kernels keep the first in a second
// carry, of tap-gradient rows). Weight, bias and add gradients are per-row
// partial sums in device memory, added over the rows in a fixed order by a
// last launch: no float atomics, so repeated calls are bitwise equal.
//
// What bounds it. The work is kernel 5's (fused_stack.cu): at the gc
// config and b8 x 19,070 rows, 4.7e10 FP32 operations forward and 1.0e11
// backward, bound by the CUDA cores' FP32 rate. But only B blocks run,
// one per batch row (8 of 132 SMs at b8), so this design is bound by one
// SM's FP32 rate and by the latency of its five barriers per layer and
// tile. The fix is a wavefront across time tiles (block (b, j) starts
// layer l once (b, j - 1) has published that layer's tail), queued in
// ROADMAP.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "stack_common.cuh"

namespace {

constexpr int TM = 128;          // time steps per tile
constexpr int NT = 512;          // threads per block
constexpr int kMaxLayers = 256;

template <int N>
using TileMap = TileMapT<TM, NT, N>;
template <int K, int N>
using GradMap = GradMapT<NT, K, N>;

// Each layer's dilation and the offset of its slots in a row's ring.
struct Layers {
  int d[kMaxLayers];
  int o[kMaxLayers];
};

// ---------------------------------------------------------------------------
// Forward: grid (B); block b walks row b's tiles in time order.
// ---------------------------------------------------------------------------

template <int R, int D>
__global__ void __launch_bounds__(NT) carry_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w_fg,
    const float* __restrict__ wd, const float* __restrict__ add,
    const float* __restrict__ bd, const __grid_constant__ Layers lay,
    float* __restrict__ y,
    float* __restrict__ fg_out, float* __restrict__ z_out,
    float* __restrict__ rings, int B, int T, int L, int sum_d) {
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int CS = K1 + 1, ZS = D + 1;   // padded row strides
  extern __shared__ float smem[];
  float* s_w = smem;               // [K1][N1]  w_fg[l]
  float* s_wd = s_w + K1 * N1;     // [D][R]    wd[l]
  float* s_cat = s_wd + D * R;     // [TM][CS]  [x_l(t-d) | x_l(t)]
  float* s_z = s_cat + TM * CS;    // [TM][ZS]

  const int tid = threadIdx.x, b = blockIdx.x;
  const size_t base = (size_t)b * T;
  const size_t fg_stride = (size_t)L * N1, z_stride = (size_t)L * D;
  float* ring = rings + (size_t)b * sum_d * R;

  for (int t0 = 0; t0 < T; t0 += TM) {
    __syncthreads();   // the previous tile's reads of s_cat are done
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      s_cat[r * CS + R + c] = t < T ? x[(base + t) * R + c] : 0.f;
    }
    for (int l = 0; l < L; ++l) {
      const int d = lay.d[l];
      float* ring_l = ring + (size_t)lay.o[l] * R;
      __syncthreads();   // layer l-1's residual update is done
      for (int i = tid; i < K1 * N1; i += NT)
        s_w[i] = w_fg[(size_t)l * K1 * N1 + i];
      for (int i = tid; i < D * R; i += NT) s_wd[i] = wd[(size_t)l * D * R + i];
      // Past tap x_l(t - d): a row of this tile, else ring slot t mod d.
      for (int i = tid; i < TM * R; i += NT) {
        const int r = i / R, c = i % R;
        s_cat[r * CS + c] = r >= d ? s_cat[(r - d) * CS + R + c]
                                   : ring_l[(size_t)((t0 + r) % d) * R + c];
      }
      __syncthreads();
      // The ring keeps the tile's last d rows of x_l for the next tiles.
      {
        const int n = d < TM ? d : TM;
        for (int i = tid; i < n * R; i += NT) {
          const int r = TM - n + i / R, c = i % R;
          ring_l[(size_t)((t0 + r) % d) * R + c] = s_cat[r * CS + R + c];
        }
      }

      // fg = [past | cur] @ w_fg + add[l, b]: each thread owns filter
      // column j and its gate column D + j, for RM rows.
      using M1 = TileMap<D>;
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
          for (int i = 0; i < M1::RM; ++i) a[i] = s_cat[(rg + i * M1::RG) * CS + k];
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) {
            const float wf = s_w[k * N1 + cg + c * M1::NG];
            const float wg = s_w[k * N1 + D + cg + c * M1::NG];
#pragma unroll
            for (int i = 0; i < M1::RM; ++i) {
              af[i][c] = fmaf(a[i], wf, af[i][c]);
              ag[i][c] = fmaf(a[i], wg, ag[i][c]);
            }
          }
        }
        const float* add_b = add + ((size_t)l * B + b) * N1;
#pragma unroll
        for (int i = 0; i < M1::RM; ++i) {
          const int r = rg + i * M1::RG, t = t0 + r;
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) {
            const int j = cg + c * M1::NG;
            const float f = af[i][c] + add_b[j];
            const float g = ag[i][c] + add_b[D + j];
            const float zz = tanhf(f) * sigmoidf(g);
            s_z[r * ZS + j] = zz;
            if (t < T) {
              const size_t row = base + t;
              fg_out[row * fg_stride + l * N1 + j] = f;
              fg_out[row * fg_stride + l * N1 + D + j] = g;
              if (z_out) z_out[row * z_stride + l * D + j] = zz;
            }
          }
        }
      }
      __syncthreads();

      // x_{l+1} = x_l + (z @ wd + bd), in place in the current half.
      using M2 = TileMap<R>;
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
          for (int i = 0; i < M2::RM; ++i) a[i] = s_z[(rg + i * M2::RG) * ZS + k];
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) {
            const float w = s_wd[k * R + cg + c * M2::NG];
#pragma unroll
            for (int i = 0; i < M2::RM; ++i) acc[i][c] = fmaf(a[i], w, acc[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < M2::RM; ++i) {
          const int r = rg + i * M2::RG;
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) {
            const int col = cg + c * M2::NG;
            float* cur = s_cat + r * CS + R + col;
            *cur = *cur + (acc[i][c] + bd[(size_t)l * R + col]);
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      if (t < T) y[(base + t) * R + c] = s_cat[r * CS + R + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: grid (B); block b walks row b's tiles in reverse time order and
// each tile's layers in reverse. Writes dx and per-(layer, row) partial
// sums of dw_fg, dwd, dbd and dadd.
// ---------------------------------------------------------------------------

template <int R, int D>
__global__ void __launch_bounds__(NT) carry_bwd_kernel(
    const float* __restrict__ y, const float* __restrict__ dy,
    const float* __restrict__ fg, const float* __restrict__ dz,
    const float* __restrict__ w_fg, const float* __restrict__ wd,
    const float* __restrict__ bd, const __grid_constant__ Layers lay,
    float* __restrict__ dx,
    float* __restrict__ part_w, float* __restrict__ part_a,
    float* __restrict__ part_add, float* __restrict__ rings, int B, int T,
    int L, int sum_d) {
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int WS = N1 + 1, VS = R + 1, DS = D + 1, AS = N1 + 1;
  extern __shared__ float smem[];
  float* s_w = smem;               // [K1][WS]  w_fg[l]
  float* s_wd = s_w + K1 * WS;     // [D][VS]   wd[l]
  float* s_x = s_wd + D * VS;      // [TM][VS]  x_{l+1}, then x_l
  float* s_dc = s_x + TM * VS;     // [TM][VS]  dx_{l+1}, then dx_l
  float* s_t = s_dc + TM * VS;     // [TM][DS]  tanh(f)
  float* s_s = s_t + TM * DS;      // [TM][DS]  sigmoid(g)
  float* s_z = s_s + TM * DS;      // [TM][DS]  z
  float* s_da = s_z + TM * DS;     // [TM][AS]  da(t)
  float* s_dan = s_da + TM * AS;   // [TM][AS]  da(t + d)

  const int tid = threadIdx.x, b = blockIdx.x;
  const size_t base = (size_t)b * T;
  const size_t fg_stride = (size_t)L * N1, z_stride = (size_t)L * D;
  float* ring = rings + (size_t)b * sum_d * N1;
  const int ntiles = (T + TM - 1) / TM;
  using GV = GradMap<D, R>;    // dwd [D][R]
  using GW = GradMap<R, N1>;   // each half of dw_fg [R][2D]

  for (int jt = ntiles - 1; jt >= 0; --jt) {
    const int t0 = jt * TM;
    const bool first = jt == ntiles - 1;   // the walk's first tile
    __syncthreads();   // the previous tile's reads of s_dc are done
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      s_x[r * VS + c] = t < T ? y[(base + t) * R + c] : 0.f;
      s_dc[r * VS + c] = t < T ? dy[(base + t) * R + c] : 0.f;
    }
    for (int l = L - 1; l >= 0; --l) {
      const int d = lay.d[l];
      float* ring_l = ring + (size_t)lay.o[l] * N1;
      const size_t slot = (size_t)l * B + b;   // partial sums of (l, b)
      __syncthreads();   // layer l+1 is done with shared memory
      for (int i = tid; i < K1 * N1; i += NT)
        s_w[(i / N1) * WS + i % N1] = w_fg[(size_t)l * K1 * N1 + i];
      for (int i = tid; i < D * R; i += NT)
        s_wd[(i / R) * VS + i % R] = wd[(size_t)l * D * R + i];
      for (int i = tid; i < TM * D; i += NT) {
        const int r = i / D, j = i % D, t = t0 + r;
        float f = 0.f, g = 0.f;
        if (t < T) {
          const float* fr = fg + (base + t) * fg_stride + l * N1;
          f = fr[j];
          g = fr[D + j];
        }
        const float th = tanhf(f), sg = sigmoidf(g);
        s_t[r * DS + j] = th;
        s_s[r * DS + j] = sg;
        s_z[r * DS + j] = th * sg;   // 0 on rows past T (f = 0)
      }
      __syncthreads();

      // dz_tot = dz + dx_{l+1} @ wd^T; da = dz_tot * (d z / d fg).
      using M1 = TileMap<D>;
      {
        const int cg = tid % M1::NG, rg = tid / M1::NG;
        float acc[M1::RM][M1::CN];
#pragma unroll
        for (int i = 0; i < M1::RM; ++i)
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) acc[i][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < R; ++k) {
          float a[M1::RM];
#pragma unroll
          for (int i = 0; i < M1::RM; ++i) a[i] = s_dc[(rg + i * M1::RG) * VS + k];
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) {
            const float w = s_wd[(cg + c * M1::NG) * VS + k];
#pragma unroll
            for (int i = 0; i < M1::RM; ++i) acc[i][c] = fmaf(a[i], w, acc[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < M1::RM; ++i) {
          const int r = rg + i * M1::RG, t = t0 + r;
#pragma unroll
          for (int c = 0; c < M1::CN; ++c) {
            const int j = cg + c * M1::NG;
            const float dzt =
                (t < T ? dz[(base + t) * z_stride + l * D + j] : 0.f) + acc[i][c];
            const float th = s_t[r * DS + j], sg = s_s[r * DS + j];
            s_da[r * AS + j] = dzt * sg * (1.f - th * th);
            s_da[r * AS + D + j] = dzt * th * sg * (1.f - sg);
          }
        }
      }

      // x_l = x_{l+1} - z @ wd - bd, in place.
      using M2 = TileMap<R>;
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
          for (int i = 0; i < M2::RM; ++i) a[i] = s_z[(rg + i * M2::RG) * DS + k];
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) {
            const float w = s_wd[k * VS + cg + c * M2::NG];
#pragma unroll
            for (int i = 0; i < M2::RM; ++i) acc[i][c] = fmaf(a[i], w, acc[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < M2::RM; ++i) {
          const int r = rg + i * M2::RG;
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) {
            const int col = cg + c * M2::NG;
            float* xc = s_x + r * VS + col;
            *xc = (*xc - acc[i][c]) - bd[(size_t)l * R + col];
          }
        }
      }

      // Partial dwd and dbd over this tile's rows (they read dx_{l+1}).
      {
        const int j = tid % R;
        float* pa = part_a + slot * (D * R + R);
#pragma unroll
        for (int q = 0; q < GV::Q; ++q) {
          const int i = tid / R + q * GV::P;
          if (i < D) {
            float s = 0.f;
            for (int r = 0; r < TM; ++r) s = fmaf(s_z[r * DS + i], s_dc[r * VS + j], s);
            pa[i * R + j] = first ? s : pa[i * R + j] + s;
          }
        }
        if (tid < R) {
          float s = 0.f;
          for (int r = 0; r < TM; ++r) s += s_dc[r * VS + tid];
          pa[D * R + tid] = first ? s : pa[D * R + tid] + s;
        }
      }
      __syncthreads();

      // Partial dadd; da(t + d) from this tile or from ring slot t mod d.
      if (tid < N1) {
        float* pd = part_add + slot * N1;
        float s = 0.f;
        for (int r = 0; r < TM; ++r) s += s_da[r * AS + tid];
        pd[tid] = first ? s : pd[tid] + s;
      }
      for (int i = tid; i < TM * N1; i += NT) {
        const int r = i / N1, n = i % N1;
        s_dan[r * AS + n] = r + d < TM ? s_da[(r + d) * AS + n]
                                       : ring_l[(size_t)((t0 + r) % d) * N1 + n];
      }
      __syncthreads();
      // The ring keeps da of the tile's first d rows for the earlier tiles.
      {
        const int n = d < TM ? d : TM;
        for (int i = tid; i < n * N1; i += NT) {
          const int r = i / N1, c = i % N1;
          ring_l[(size_t)((t0 + r) % d) * N1 + c] = s_da[r * AS + c];
        }
      }

      // dx_l = dx_{l+1} + da(t) @ w_fg[R:]^T + da(t + d) @ w_fg[:R]^T,
      // in place.
      {
        const int cg = tid % M2::NG, rg = tid / M2::NG;
        float ac[M2::RM][M2::CN], ap[M2::RM][M2::CN];
#pragma unroll
        for (int i = 0; i < M2::RM; ++i)
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) ac[i][c] = ap[i][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N1; ++k) {
          float a[M2::RM], an[M2::RM];
#pragma unroll
          for (int i = 0; i < M2::RM; ++i) {
            a[i] = s_da[(rg + i * M2::RG) * AS + k];
            an[i] = s_dan[(rg + i * M2::RG) * AS + k];
          }
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) {
            const int col = cg + c * M2::NG;
            const float wc = s_w[(R + col) * WS + k];
            const float wp = s_w[col * WS + k];
#pragma unroll
            for (int i = 0; i < M2::RM; ++i) {
              ac[i][c] = fmaf(a[i], wc, ac[i][c]);
              ap[i][c] = fmaf(an[i], wp, ap[i][c]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < M2::RM; ++i) {
          const int r = rg + i * M2::RG;
#pragma unroll
          for (int c = 0; c < M2::CN; ++c) {
            float* dc = s_dc + r * VS + cg + c * M2::NG;
            *dc = (*dc + ac[i][c]) + ap[i][c];
          }
        }
      }

      // Partial dw_fg: row k pairs x_l(t) with da(t + d) (the past tap),
      // row R + k pairs x_l(t) with da(t) (the current tap).
      {
        const int n = tid % N1;
        float pp[GW::Q], pc[GW::Q];
#pragma unroll
        for (int q = 0; q < GW::Q; ++q) pp[q] = pc[q] = 0.f;
        for (int r = 0; r < TM; ++r) {
          const float gp = s_dan[r * AS + n], gc = s_da[r * AS + n];
#pragma unroll
          for (int q = 0; q < GW::Q; ++q) {
            const int k = tid / N1 + q * GW::P;
            if (k < R) {
              const float a = s_x[r * VS + k];
              pp[q] = fmaf(a, gp, pp[q]);
              pc[q] = fmaf(a, gc, pc[q]);
            }
          }
        }
        float* pw = part_w + slot * (K1 * N1);
#pragma unroll
        for (int q = 0; q < GW::Q; ++q) {
          const int k = tid / N1 + q * GW::P;
          if (k < R) {
            float* p0 = pw + k * N1 + n;
            float* p1 = pw + (R + k) * N1 + n;
            *p0 = first ? pp[q] : *p0 + pp[q];
            *p1 = first ? pc[q] : *p1 + pc[q];
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      if (t < T) dx[(base + t) * R + c] = s_dc[r * VS + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

Layers make_layers(const int* dil, int L, int* sum_d) {
  Layers lay;
  int o = 0;
  for (int l = 0; l < L; ++l) {
    lay.d[l] = dil[l];
    lay.o[l] = o;
    o += dil[l];
  }
  *sum_d = o;
  return lay;
}

template <int R, int D>
int forward_impl(const float* x, const float* w_fg, const float* wd,
                 const float* add, const float* bd, const int* dil, float* y,
                 float* fg, float* z, float* scratch, int B, int T, int L,
                 cudaStream_t st) {
  int sum_d = 0;
  const Layers lay = make_layers(dil, L, &sum_d);
  const int smem = (int)sizeof(float) *
                   (4 * R * D + D * R + TM * (2 * R + 1) + TM * (D + 1));
  cudaError_t e = cudaFuncSetAttribute(
      carry_fwd_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(scratch, 0, sizeof(float) * (size_t)B * sum_d * R, st);
  if (e != cudaSuccess) return (int)e;
  carry_fwd_kernel<R, D><<<B, NT, smem, st>>>(x, w_fg, wd, add, bd, lay, y, fg,
                                              z, scratch, B, T, L, sum_d);
  return (int)cudaGetLastError();
}

template <int R, int D>
int backward_impl(const float* y, const float* dy, const float* fg,
                  const float* dz, const float* w_fg, const float* wd,
                  const float* bd, const int* dil, float* dx, float* dw_fg,
                  float* dwd, float* dadd, float* dbd, float* scratch, int B,
                  int T, int L, cudaStream_t st) {
  int sum_d = 0;
  const Layers lay = make_layers(dil, L, &sum_d);
  float* rings = scratch;                                   // [B, sum_d, 2D]
  float* pw = rings + (size_t)B * sum_d * 2 * D;            // [L, B, 2R, 2D]
  float* pa = pw + (size_t)L * B * 4 * R * D;               // [L, B, DR + R]
  float* padd = pa + (size_t)L * B * (D * R + R);           // [L, B, 2D]
  const int smem = (int)sizeof(float) *
                   (2 * R * (2 * D + 1) + D * (R + 1) + 2 * TM * (R + 1) +
                    3 * TM * (D + 1) + 2 * TM * (2 * D + 1));
  cudaError_t e = cudaFuncSetAttribute(
      carry_bwd_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(rings, 0, sizeof(float) * (size_t)B * sum_d * 2 * D, st);
  if (e != cudaSuccess) return (int)e;
  carry_bwd_kernel<R, D><<<B, NT, smem, st>>>(y, dy, fg, dz, w_fg, wd, bd, lay,
                                              dx, pw, pa, padd, rings, B, T, L,
                                              sum_d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // One partial sum per (layer, row): B blocks of one chunk each.
  return (int)launch_reduce_partials<NT>(pw, pa, padd, dw_fg, dwd, dbd, dadd,
                                         B, 1, L, R, D, st);
}

constexpr int kUnsupported = 1000;

}  // namespace

extern "C" {

// Shapes the kernels are built for: R == D in {8, 16, 32}, 1..256 layers.
int fused_stack_carry_supports(int R, int D, int L) {
  return R == D && (R == 8 || R == 16 || R == 32) && L >= 1 &&
         L <= kMaxLayers;
}

// Floats of scratch device memory a forward (backward = 0) or backward
// (backward = 1) call needs; sum_d is the sum of the dilations.
long long fused_stack_carry_scratch_floats(int backward, int B, int L, int R,
                                           int D, int sum_d) {
  if (!backward) return (long long)B * sum_d * R;
  return (long long)B * sum_d * 2 * D +
         (long long)L * B * (4LL * R * D + D * R + R + 2 * D);
}

// Forward (one launch). x [B,T,R]; w_fg [L,2R,2D]; wd [L,D,R]; add
// [L,B,2D]; bd [L,R]; dil: L dilations (host memory); outputs y [B,T,R],
// fg [B,T,L*2D] and, when z is not null, z [B,T,L*D]; scratch as sized by
// fused_stack_carry_scratch_floats. Returns 0 or a CUDA error code.
int fused_stack_carry_fwd_f32(const float* x, const float* w_fg,
                              const float* wd, const float* add,
                              const float* bd, const int* dil, float* y,
                              float* fg, float* z, float* scratch, int B,
                              int T, int L, int R, int D, void* stream) {
  if (!fused_stack_carry_supports(R, D, L)) return kUnsupported;
  cudaStream_t st = (cudaStream_t)stream;
  if (R == 32)
    return forward_impl<32, 32>(x, w_fg, wd, add, bd, dil, y, fg, z, scratch, B, T, L, st);
  if (R == 16)
    return forward_impl<16, 16>(x, w_fg, wd, add, bd, dil, y, fg, z, scratch, B, T, L, st);
  return forward_impl<8, 8>(x, w_fg, wd, add, bd, dil, y, fg, z, scratch, B, T, L, st);
}

// Backward (the kernel, then the fixed-order reduction). y, dy [B,T,R];
// fg [B,T,L*2D]; dz [B,T,L*D]; weights as in the forward; outputs dx
// [B,T,R], dw_fg [L,2R,2D], dwd [L,D,R], dadd [L,B,2D], dbd [L,R].
// Returns 0 or a CUDA error code.
int fused_stack_carry_bwd_f32(const float* y, const float* dy,
                              const float* fg, const float* dz,
                              const float* w_fg, const float* wd,
                              const float* bd, const int* dil, float* dx,
                              float* dw_fg, float* dwd, float* dadd,
                              float* dbd, float* scratch, int B, int T, int L,
                              int R, int D, void* stream) {
  if (!fused_stack_carry_supports(R, D, L)) return kUnsupported;
  cudaStream_t st = (cudaStream_t)stream;
  if (R == 32)
    return backward_impl<32, 32>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg,
                                 dwd, dadd, dbd, scratch, B, T, L, st);
  if (R == 16)
    return backward_impl<16, 16>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg,
                                 dwd, dadd, dbd, scratch, B, T, L, st);
  return backward_impl<8, 8>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd,
                             dadd, dbd, scratch, B, T, L, st);
}

}  // extern "C"
