// fused_stack: the whole dilated stack of a WaveNet training step, forward
// and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel pair of the JAX package
//   wavenet_tpu/kernels/fused_stack3.py:105  _fwd_kernel
//   wavenet_tpu/kernels/fused_stack3.py:276  _bwd_kernel
// tied together there by the custom VJP ``fused_stack3``.
//
// For each layer l with dilation d, over all rows (b, t):
//   fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   x' = x + (z @ wd[l] + bd[l])
// The forward emits y (the last layer's output), the preactivations
// fg [B, T, L*2D] and the gate outputs z [B, T, L*D] (no lane padding: the
// TPU kernel's 128-lane records are a TPU layout). The backward is the
// map's VJP from (y, dy, fg, dz), recompute-free like the TPU kernel: each
// layer's input is rebuilt by subtraction, x_l = x_{l+1} - z_l @ wd_l -
// bd_l, and z_l from the saved fg_l.
//
// The forward layer kernel lives in fused_stack_fwd.cuh, which its probe
// (fwd_bisect.cu, the port of tools/r2_fwd_bisect.py) shares; this file
// instantiates it with every part on, in each mode.
//
// Two modes. float32 (fused_stack_{fwd,bwd}_f32) and bf16
// (fused_stack_{fwd,bwd}_bf16), the counterpart of the same TPU kernels at
// kernel_dtype = bfloat16: each product operand is rounded to bf16 (to
// nearest even) where the TPU kernel rounds it, as it is staged into
// shared memory, and multiplied by FP32 FMA (the product of two bf16
// values is exact in float32) into float32 sums in the float32 mode's
// order. The forward rounds the weights, the tap matrix [x(t-d) | x(t)]
// and z before z @ wd, adds the residual in the TPU kernel's order (x + z
// @ wd) + bd, and stores fg and z as bf16 records. The backward reads fg
// and dz as bf16 records and rounds the weights, dx_{l+1} (for dwd and for
// dx_{l+1} @ wd^T), z (for dwd and the rebuild x_l = x_{l+1} - z @ wd -
// bd), the rebuilt tap matrix and da (for dw_fg and dx_l); dbd and dadd
// sum the unrounded float32 values. The same grid, scratch and reduction
// in both modes, so repeats are bitwise equal in both.
//
// Design. Layer l+1's past tap reads rows of layer l's output that other
// blocks write, so every layer is its own launch (ping-pong residual
// buffers in device memory): L launches forward, 2L + 1 backward. A block
// owns 64 consecutive time steps of one batch row, so a tap at t - d never
// reaches into another batch row. The backward splits each layer in two
// launches: (A) the gate gradient da, the rebuilt input x_l and the
// partial sums of dwd, dbd and dadd; (B) dx_l, whose past-tap term
// da(t + d) @ w_fg[l, :R]^T is a gather from the finished da of (A), and
// the partial sums of dw_fg. Weight gradients reduce over B*T rows: each
// block of (A) and (B) walks a fixed chunk of tiles and writes its own
// partial sums; one last launch adds the partials in a fixed order. No
// float atomics, so two calls on the same inputs give bitwise-equal
// gradients.
//
// What bounds it. At the gc config (L=30, R=D=32) and b8 x 19,070 rows the
// forward does 4.7e10 FP32 operations and moves ~1.8 GB, the backward
// 1.0e11 and ~1.8 GB: both are bound by FP32 operations on the CUDA cores
// (67 TFLOP/s), not by bytes. This first version is simple FP32 FMA
// register tiling from shared memory (no tensor cores: f32 parity mode
// allows no TF32); wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "fused_stack_fwd.cuh"
#include "stack_common.cuh"

namespace {

constexpr int TM = kFwdTM;   // rows (time steps of one batch row) per tile
constexpr int NT = kFwdNT;   // threads per block

template <int N>
using TileMap = TileMapT<TM, NT, N>;
template <int K, int N>
using GradMap = GradMapT<NT, K, N>;

// The mode's record type (fg, z, dz) and its rounding of a product
// operand: to bf16 and back (to nearest even) in the bf16 mode, nothing in
// the float32 mode.
template <bool BF>
using Rec = std::conditional_t<BF, __nv_bfloat16, float>;

template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16(v));
  else return v;
}

// ---------------------------------------------------------------------------
// Backward (A): da, the rebuilt layer input, partial dwd / dbd / dadd.
// grid (chunks of tiles, B); each block walks tiles_per_chunk tiles.
// ---------------------------------------------------------------------------

template <int R, int D, bool BF>
__global__ void __launch_bounds__(NT) bwd_da_kernel(
    const float* __restrict__ x_next, const float* __restrict__ dx_next,
    const Rec<BF>* __restrict__ fg, const Rec<BF>* __restrict__ dz,
    const float* __restrict__ wd, const float* __restrict__ bd,
    float* __restrict__ x_cur, float* __restrict__ da_out,
    float* __restrict__ part_a, float* __restrict__ part_add,
    int T, int l, int L, int tiles_per_chunk, int nchunk) {
  constexpr int N1 = 2 * D;
  constexpr int WS = R + 1, RS = R + 1, DS = D + 1, AS = N1 + 1;
  extern __shared__ float smem[];
  float* s_wd = smem;              // [D][WS]   wd[l]
  float* s_dc = s_wd + D * WS;     // [TM][RS]  dx_{l+1}
  float* s_t = s_dc + TM * RS;     // [TM][DS]  tanh(f)
  float* s_s = s_t + TM * DS;      // [TM][DS]  sigmoid(g)
  float* s_z = s_s + TM * DS;      // [TM][DS]  z
  float* s_da = s_z + TM * DS;     // [TM][AS]  da
  // The products' dx_{l+1}: rounded, [TM][RS] (bf16), or s_dc itself.
  float* s_dcp = BF ? s_da + TM * AS : s_dc;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * T;
  const size_t fg_stride = (size_t)L * N1, z_stride = (size_t)L * D;

  for (int i = tid; i < D * R; i += NT)
    s_wd[(i / R) * WS + i % R] = rnd<BF>(wd[i]);

  using GW = GradMap<D, R>;
  float p_wd[GW::Q];
#pragma unroll
  for (int q = 0; q < GW::Q; ++q) p_wd[q] = 0.f;
  float p_bd = 0.f, p_add = 0.f;

  for (int tile = 0; tile < tiles_per_chunk; ++tile) {
    const int t0 = (chunk * tiles_per_chunk + tile) * TM;
    if (t0 >= T) break;
    __syncthreads();   // the previous tile's shared reads are done
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      const float v = t < T ? dx_next[(base + t) * R + c] : 0.f;
      s_dc[r * RS + c] = v;
      if constexpr (BF) s_dcp[r * RS + c] = rnd<BF>(v);
    }
    for (int i = tid; i < TM * D; i += NT) {
      const int r = i / D, j = i % D, t = t0 + r;
      float f = 0.f, g = 0.f;
      if (t < T) {
        const Rec<BF>* fr = fg + (base + t) * fg_stride + l * N1;
        f = op_to_f(fr[j]);
        g = op_to_f(fr[D + j]);
      }
      const float th = tanhf(f), sg = sigmoidf(g);
      s_t[r * DS + j] = th;
      s_s[r * DS + j] = sg;
      s_z[r * DS + j] = rnd<BF>(th * sg);   // 0 on rows past T (f = 0)
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
        for (int i = 0; i < M1::RM; ++i) a[i] = s_dcp[(rg + i * M1::RG) * RS + k];
#pragma unroll
        for (int c = 0; c < M1::CN; ++c) {
          const float w = s_wd[(cg + c * M1::NG) * WS + k];
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
              (t < T ? op_to_f(dz[(base + t) * z_stride + l * D + j]) : 0.f) +
              acc[i][c];
          const float th = s_t[r * DS + j], sg = s_s[r * DS + j];
          const float daf = dzt * sg * (1.f - th * th);
          const float dag = dzt * th * sg * (1.f - sg);
          s_da[r * AS + j] = daf;
          s_da[r * AS + D + j] = dag;
          if (t < T) {   // (B) multiplies da only: rounded here
            da_out[(base + t) * N1 + j] = rnd<BF>(daf);
            da_out[(base + t) * N1 + D + j] = rnd<BF>(dag);
          }
        }
      }
    }

    // x_l = x_{l+1} - z @ wd - bd
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
          const float w = s_wd[k * WS + cg + c * M2::NG];
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
          const size_t o = (base + t) * R + col;
          x_cur[o] = (x_next[o] - acc[i][c]) - bd[col];
        }
      }
    }
    __syncthreads();

    // Partial sums over this tile's rows, in a fixed order.
    {
      const int j = tid % R;
#pragma unroll
      for (int q = 0; q < GW::Q; ++q) {
        const int i = tid / R + q * GW::P;
        if (i < D) {
          float s = p_wd[q];
          for (int r = 0; r < TM; ++r) s = fmaf(s_z[r * DS + i], s_dcp[r * RS + j], s);
          p_wd[q] = s;
        }
      }
      if (tid < R)
        for (int r = 0; r < TM; ++r) p_bd += s_dc[r * RS + tid];
      if (tid < N1)
        for (int r = 0; r < TM; ++r) p_add += s_da[r * AS + tid];
    }
  }

  const size_t cta = (size_t)b * nchunk + chunk;
  float* pa = part_a + cta * (D * R + R);
  {
    const int j = tid % R;
#pragma unroll
    for (int q = 0; q < GW::Q; ++q) {
      const int i = tid / R + q * GW::P;
      if (i < D) pa[i * R + j] = p_wd[q];
    }
  }
  if (tid < R) pa[D * R + tid] = p_bd;
  if (tid < N1) part_add[cta * N1 + tid] = p_add;
}

// ---------------------------------------------------------------------------
// Backward (B): dx_l and partial dw_fg. Same grid as (A).
// ---------------------------------------------------------------------------

template <int R, int D, bool BF>
__global__ void __launch_bounds__(NT) bwd_dx_kernel(
    const float* __restrict__ x_cur, const float* __restrict__ dx_next,
    const float* __restrict__ da, const float* __restrict__ w_fg,
    float* __restrict__ dx_cur, float* __restrict__ part_w,
    int T, int d, int tiles_per_chunk, int nchunk) {
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int WS = N1 + 1, AS = N1 + 1, CS = K1 + 1;
  extern __shared__ float smem[];
  float* s_w = smem;               // [K1][WS]  w_fg[l]
  float* s_da = s_w + K1 * WS;     // [TM][AS]  da(t)
  float* s_dan = s_da + TM * AS;   // [TM][AS]  da(t + d)
  float* s_cat = s_dan + TM * AS;  // [TM][CS]  [x_l(t-d) | x_l(t)]

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * T;

  for (int i = tid; i < K1 * N1; i += NT)
    s_w[(i / N1) * WS + i % N1] = rnd<BF>(w_fg[i]);

  // dw_fg partial sums: a 16 x 16 thread grid, each thread an MI x MJ
  // register tile (rows and columns interleaved by 16).
  constexpr int MI = K1 / 16, MJ = N1 / 16;
  static_assert(K1 % 16 == 0 && N1 % 16 == 0 && NT == 256, "dw tile");
  const int ti = tid / 16, tj = tid % 16;
  float p_w[MI][MJ];
#pragma unroll
  for (int u = 0; u < MI; ++u)
#pragma unroll
    for (int v = 0; v < MJ; ++v) p_w[u][v] = 0.f;

  for (int tile = 0; tile < tiles_per_chunk; ++tile) {
    const int t0 = (chunk * tiles_per_chunk + tile) * TM;
    if (t0 >= T) break;
    __syncthreads();
    for (int i = tid; i < TM * N1; i += NT) {
      const int r = i / N1, j = i % N1, t = t0 + r;
      s_da[r * AS + j] = t < T ? da[(base + t) * N1 + j] : 0.f;
      s_dan[r * AS + j] = t + d < T ? da[(base + t + d) * N1 + j] : 0.f;
    }
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      float cur = 0.f, past = 0.f;
      if (t < T) {
        cur = x_cur[(base + t) * R + c];
        if (t >= d) past = x_cur[(base + t - d) * R + c];
      }
      s_cat[r * CS + c] = rnd<BF>(past);
      s_cat[r * CS + R + c] = rnd<BF>(cur);
    }
    __syncthreads();

    // dx_l = dx_{l+1} + da(t) @ w_fg[R:]^T + da(t + d) @ w_fg[:R]^T
    using M = TileMap<R>;
    {
      const int cg = tid % M::NG, rg = tid / M::NG;
      float ac[M::RM][M::CN], ap[M::RM][M::CN];
#pragma unroll
      for (int i = 0; i < M::RM; ++i)
#pragma unroll
        for (int c = 0; c < M::CN; ++c) ac[i][c] = ap[i][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N1; ++k) {
        float a[M::RM], an[M::RM];
#pragma unroll
        for (int i = 0; i < M::RM; ++i) {
          a[i] = s_da[(rg + i * M::RG) * AS + k];
          an[i] = s_dan[(rg + i * M::RG) * AS + k];
        }
#pragma unroll
        for (int c = 0; c < M::CN; ++c) {
          const int col = cg + c * M::NG;
          const float wc = s_w[(R + col) * WS + k];
          const float wp = s_w[col * WS + k];
#pragma unroll
          for (int i = 0; i < M::RM; ++i) {
            ac[i][c] = fmaf(a[i], wc, ac[i][c]);
            ap[i][c] = fmaf(an[i], wp, ap[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < M::RM; ++i) {
        const int r = rg + i * M::RG, t = t0 + r;
        if (t >= T) continue;
#pragma unroll
        for (int c = 0; c < M::CN; ++c) {
          const size_t o = (base + t) * R + cg + c * M::NG;
          dx_cur[o] = (dx_next[o] + ac[i][c]) + ap[i][c];
        }
      }
    }

    // dw_fg += [x_l(t-d) | x_l(t)]^T @ da(t)
    for (int r = 0; r < TM; ++r) {
      float a[MI], g[MJ];
#pragma unroll
      for (int u = 0; u < MI; ++u) a[u] = s_cat[r * CS + ti + 16 * u];
#pragma unroll
      for (int v = 0; v < MJ; ++v) g[v] = s_da[r * AS + tj + 16 * v];
#pragma unroll
      for (int u = 0; u < MI; ++u)
#pragma unroll
        for (int v = 0; v < MJ; ++v) p_w[u][v] = fmaf(a[u], g[v], p_w[u][v]);
    }
  }

  float* pw = part_w + ((size_t)b * nchunk + chunk) * (K1 * N1);
#pragma unroll
  for (int u = 0; u < MI; ++u)
#pragma unroll
    for (int v = 0; v < MJ; ++v) pw[(ti + 16 * u) * N1 + tj + 16 * v] = p_w[u][v];
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The backward's grid: at most three blocks per SM (launch (B)'s shared
// memory fits three), so every block runs in the first wave.
Tiling backward_tiling(int B, int T) { return chunk_tiling(B, T, TM, 3); }

// The forward: fwd_layer_kernel with float32 operands and records, or
// (bf16) bf16 ones from the float32 weights with the TPU kernel's residual
// order.
template <int R, int D, bool BF>
int forward_impl(const float* x, const float* w_fg, const float* wd,
                 const float* add, const float* bd, const int* dil, float* y,
                 Rec<BF>* fg, Rec<BF>* z, float* xbuf, int B, int T, int L,
                 cudaStream_t st) {
  using Op = Rec<BF>;
  constexpr unsigned kMask = BF ? (kFwdFull | kFwdTpuResidual) : kFwdFull;
  constexpr int smem = fwd_layer_smem_bytes<R, D, Op, kMask>();
  cudaError_t e = cudaFuncSetAttribute(
      fwd_layer_kernel<R, D, Op, Op, kMask, float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + TM - 1) / TM, B);
  const size_t btr = (size_t)B * T * R;
  for (int l = 0; l < L; ++l) {
    const float* in = l == 0 ? x : xbuf + (size_t)((l - 1) & 1) * btr;
    float* out = l == L - 1 ? y : xbuf + (size_t)(l & 1) * btr;
    fwd_layer_kernel<R, D, Op, Op, kMask, float><<<grid, NT, smem, st>>>(
        in, out, fg, z, w_fg + (size_t)l * 4 * R * D, wd + (size_t)l * D * R,
        add + (size_t)l * B * 2 * D, bd + (size_t)l * R, T, dil[l], l, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int R, int D, bool BF>
int backward_impl(const float* y, const float* dy, const Rec<BF>* fg,
                  const Rec<BF>* dz, const float* w_fg, const float* wd,
                  const float* bd, const int* dil, float* dx, float* dw_fg,
                  float* dwd, float* dadd, float* dbd, float* scratch, int B,
                  int T, int L, cudaStream_t st) {
  const Tiling tl = backward_tiling(B, T);
  const size_t ncta = (size_t)B * tl.nchunk;
  const size_t btr = (size_t)B * T * R;
  float* xb = scratch;                          // 2 x [B, T, R]
  float* dxb = xb + 2 * btr;                    // 2 x [B, T, R]
  float* da = dxb + 2 * btr;                    // [B, T, 2D]
  float* pw = da + (size_t)B * T * 2 * D;       // [L, ncta, 2R, 2D]
  float* pa = pw + (size_t)L * ncta * 4 * R * D;  // [L, ncta, D*R + R]
  float* padd = pa + (size_t)L * ncta * (D * R + R);  // [L, ncta, 2D]

  const int smem_a = (int)sizeof(float) *
                     (D * (R + 1) + (BF ? 2 : 1) * TM * (R + 1) +
                      3 * TM * (D + 1) + TM * (2 * D + 1));
  const int smem_b = (int)sizeof(float) *
                     (2 * R * (2 * D + 1) + 2 * TM * (2 * D + 1) + TM * (2 * R + 1));
  cudaError_t e = cudaFuncSetAttribute(
      bwd_da_kernel<R, D, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      bwd_dx_kernel<R, D, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_b);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid(tl.nchunk, B);
  for (int l = L - 1; l >= 0; --l) {
    const float* x_next = l == L - 1 ? y : xb + (size_t)((l + 1) & 1) * btr;
    float* x_cur = xb + (size_t)(l & 1) * btr;
    const float* dx_next = l == L - 1 ? dy : dxb + (size_t)((l + 1) & 1) * btr;
    float* dx_cur = l == 0 ? dx : dxb + (size_t)(l & 1) * btr;
    bwd_da_kernel<R, D, BF><<<grid, NT, smem_a, st>>>(
        x_next, dx_next, fg, dz, wd + (size_t)l * D * R, bd + (size_t)l * R,
        x_cur, da, pa + (size_t)l * ncta * (D * R + R),
        padd + (size_t)l * ncta * 2 * D, T, l, L, tl.tiles_per_chunk,
        tl.nchunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bwd_dx_kernel<R, D, BF><<<grid, NT, smem_b, st>>>(
        x_cur, dx_next, da, w_fg + (size_t)l * 4 * R * D, dx_cur,
        pw + (size_t)l * ncta * 4 * R * D, T, dil[l], tl.tiles_per_chunk,
        tl.nchunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_reduce_partials<NT>(pw, pa, padd, dw_fg, dwd, dbd, dadd,
                                         B, tl.nchunk, L, R, D, st);
}

constexpr int kUnsupportedWidth = 1000;

}  // namespace

extern "C" {

// Widths the kernels are built for: R == D in {8, 16, 32}.
int fused_stack_supports_width(int R, int D) {
  return R == D && (R == 8 || R == 16 || R == 32);
}

// Floats of scratch device memory the backward needs.
long long fused_stack_bwd_scratch_floats(int B, int T, int L, int R, int D) {
  const Tiling tl = backward_tiling(B, T);
  const long long bt = (long long)B * T, ncta = (long long)B * tl.nchunk;
  return 4 * bt * R + bt * 2 * D +
         (long long)L * ncta * (4LL * R * D + D * R + R + 2 * D);
}

// Forward launches (L of them). x [B,T,R]; w_fg [L,2R,2D]; wd [L,D,R];
// add [L,B,2D]; bd [L,R]; dil: L dilations (host memory); outputs y
// [B,T,R], fg [B,T,L*2D], z [B,T,L*D]; xbuf: 2*B*T*R floats of scratch.
// Returns 0 or a CUDA error code.
int fused_stack_fwd_f32(const float* x, const float* w_fg, const float* wd,
                        const float* add, const float* bd, const int* dil,
                        float* y, float* fg, float* z, float* xbuf, int B,
                        int T, int L, int R, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!fused_stack_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &forward_impl<32, 32, false>
          : R == 16 ? &forward_impl<16, 16, false> : &forward_impl<8, 8, false>;
  return f(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T, L, st);
}

// The bf16 mode: the arguments of fused_stack_fwd_f32, with fg and z bf16
// records (float32 weights, rounded in the kernel).
int fused_stack_fwd_bf16(const float* x, const float* w_fg, const float* wd,
                         const float* add, const float* bd, const int* dil,
                         float* y, __nv_bfloat16* fg, __nv_bfloat16* z,
                         float* xbuf, int B, int T, int L, int R, int D,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!fused_stack_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &forward_impl<32, 32, true>
          : R == 16 ? &forward_impl<16, 16, true> : &forward_impl<8, 8, true>;
  return f(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T, L, st);
}

// Backward launches (2L + 1 of them). y, dy [B,T,R]; fg [B,T,L*2D];
// dz [B,T,L*D]; weights as in the forward; outputs dx [B,T,R], dw_fg
// [L,2R,2D], dwd [L,D,R], dadd [L,B,2D], dbd [L,R]; scratch as sized by
// fused_stack_bwd_scratch_floats (either mode). Returns 0 or a CUDA error
// code.
int fused_stack_bwd_f32(const float* y, const float* dy, const float* fg,
                        const float* dz, const float* w_fg, const float* wd,
                        const float* bd, const int* dil, float* dx,
                        float* dw_fg, float* dwd, float* dadd, float* dbd,
                        float* scratch, int B, int T, int L, int R, int D,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!fused_stack_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &backward_impl<32, 32, false>
          : R == 16 ? &backward_impl<16, 16, false>
                    : &backward_impl<8, 8, false>;
  return f(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd, dadd, dbd,
           scratch, B, T, L, st);
}

// The bf16 mode: the arguments of fused_stack_bwd_f32, with fg and dz bf16
// records; every output float32.
int fused_stack_bwd_bf16(const float* y, const float* dy,
                         const __nv_bfloat16* fg, const __nv_bfloat16* dz,
                         const float* w_fg, const float* wd, const float* bd,
                         const int* dil, float* dx, float* dw_fg, float* dwd,
                         float* dadd, float* dbd, float* scratch, int B,
                         int T, int L, int R, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!fused_stack_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &backward_impl<32, 32, true>
          : R == 16 ? &backward_impl<16, 16, true>
                    : &backward_impl<8, 8, true>;
  return f(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd, dadd, dbd,
           scratch, B, T, L, st);
}

}  // extern "C"
