// dilated_layer: one gated dilated layer of a training step, forward and a
// flash-style backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel pair of the JAX package
//   wavenet_tpu/experiments/dilated_layer.py:68  _fwd_kernel
//   wavenet_tpu/experiments/dilated_layer.py:82  _bwd_kernel
// tied together there by the custom VJP ``fused_dilated_layer``. Over all
// rows (b, t), with dilation d:
//
//   fg = x(t-d) @ w[0] + x(t) @ w[1] + add[b]       (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   y  = x + (z @ wd + bd)
//
// The forward emits y [B,T,R] and z [B,T,D]. The backward saves nothing
// but the inputs: it recomputes fg and z in the kernel from x, as the TPU
// kernel does, and emits dx_local = dy + da @ w[1]^T and dpast = da @
// w[0]^T (the caller adds dpast(t + d) to dx(t)) with the weight
// gradients dw [2,R,2D], dwd [D,R], dadd [B,2D] and dbd [1,R].
//
// Design. A block owns TM consecutive time steps of one batch row (grid
// (tiles, B) forward, (chunks, B) backward), so the past tap x(t - d) is
// read straight from device memory: the TPU wrapper materialises a shifted
// copy of x only because a BlockSpec cannot express a halo. Each backward
// block walks a fixed chunk of tiles and keeps its weight-gradient partial
// sums in registers; one last launch adds the blocks' partials in a fixed
// order, so repeated calls are bitwise equal.
//
// What bounds it. At the gc widths (R=D=32) and b8 x 19,070 rows a layer's
// forward is 1.6e9 FP32 operations against 59 MB moved, the backward
// (with the fg recompute) 4.4e9 against 98 MB: both bound by FP32
// operations on the CUDA cores (67 TFLOP/s), not by bytes. Plain FP32
// register tiling from shared memory, as fused_stack.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "stack_common.cuh"

namespace {

constexpr int TM = 64;    // time steps of one batch row per tile
constexpr int NT = 256;   // threads per block

template <int N>
using TileMap = TileMapT<TM, NT, N>;
template <int K, int N>
using GradMap = GradMapT<NT, K, N>;

// ---------------------------------------------------------------------------
// Forward: grid (tiles of T, B).
// ---------------------------------------------------------------------------

template <int R, int D>
__global__ void __launch_bounds__(NT) layer_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ add,
    const float* __restrict__ bd, float* __restrict__ y,
    float* __restrict__ z_out, int T, int d) {
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int CS = K1 + 1, ZS = D + 1;   // padded row strides
  extern __shared__ float smem[];
  float* s_w = smem;               // [K1][N1]  [w[0]; w[1]]
  float* s_wd = s_w + K1 * N1;     // [D][R]
  float* s_cat = s_wd + D * R;     // [TM][CS]  [x(t-d) | x(t)]
  float* s_z = s_cat + TM * CS;    // [TM][ZS]

  const int tid = threadIdx.x, b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const size_t base = (size_t)b * T;

  for (int i = tid; i < K1 * N1; i += NT) s_w[i] = w[i];
  for (int i = tid; i < D * R; i += NT) s_wd[i] = wd[i];
  for (int i = tid; i < TM * R; i += NT) {
    const int r = i / R, c = i % R, t = t0 + r;
    float cur = 0.f, past = 0.f;
    if (t < T) {
      cur = x[(base + t) * R + c];
      if (t >= d) past = x[(base + t - d) * R + c];
    }
    s_cat[r * CS + c] = past;
    s_cat[r * CS + R + c] = cur;
  }
  __syncthreads();

  // fg = [past | cur] @ [w[0]; w[1]] + add[b]; each thread owns filter
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
    const float* add_b = add + (size_t)b * N1;
#pragma unroll
    for (int i = 0; i < M1::RM; ++i) {
      const int r = rg + i * M1::RG, t = t0 + r;
#pragma unroll
      for (int c = 0; c < M1::CN; ++c) {
        const int j = cg + c * M1::NG;
        const float zz = tanhf(af[i][c] + add_b[j]) * sigmoidf(ag[i][c] + add_b[D + j]);
        s_z[r * ZS + j] = zz;
        if (t < T) z_out[(base + t) * D + j] = zz;
      }
    }
  }
  __syncthreads();

  // y = x + (z @ wd + bd)
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
        const float wv = s_wd[k * R + cg + c * M2::NG];
#pragma unroll
        for (int i = 0; i < M2::RM; ++i) acc[i][c] = fmaf(a[i], wv, acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < M2::RM; ++i) {
      const int r = rg + i * M2::RG, t = t0 + r;
      if (t >= T) continue;
#pragma unroll
      for (int c = 0; c < M2::CN; ++c) {
        const int col = cg + c * M2::NG;
        y[(base + t) * R + col] = s_cat[r * CS + R + col] + (acc[i][c] + bd[col]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: grid (chunks of tiles, B); each block walks tiles_per_chunk
// tiles and writes its own partial sums.
// ---------------------------------------------------------------------------

template <int R, int D>
__global__ void __launch_bounds__(NT) layer_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ add,
    const float* __restrict__ dy, const float* __restrict__ dz,
    float* __restrict__ dx_local, float* __restrict__ dpast,
    float* __restrict__ part_w, float* __restrict__ part_a,
    float* __restrict__ part_add, int T, int d, int tiles_per_chunk,
    int nchunk) {
  constexpr int K1 = 2 * R, N1 = 2 * D;
  constexpr int WS = N1 + 1, VS = R + 1, CS = K1 + 1, DS = D + 1, AS = N1 + 1;
  extern __shared__ float smem[];
  float* s_w = smem;               // [K1][WS]  [w[0]; w[1]]
  float* s_wd = s_w + K1 * WS;     // [D][VS]
  float* s_cat = s_wd + D * VS;    // [TM][CS]  [x(t-d) | x(t)]
  float* s_dy = s_cat + TM * CS;   // [TM][VS]
  float* s_t = s_dy + TM * VS;     // [TM][DS]  tanh(f)
  float* s_s = s_t + TM * DS;      // [TM][DS]  sigmoid(g)
  float* s_z = s_s + TM * DS;      // [TM][DS]  z
  float* s_da = s_z + TM * DS;     // [TM][AS]  da

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * T;

  for (int i = tid; i < K1 * N1; i += NT) s_w[(i / N1) * WS + i % N1] = w[i];
  for (int i = tid; i < D * R; i += NT) s_wd[(i / R) * VS + i % R] = wd[i];

  // dw partial sums: a 16 x 16 thread grid, each thread an MI x MJ
  // register tile (rows and columns interleaved by 16).
  constexpr int MI = K1 / 16, MJ = N1 / 16;
  static_assert(K1 % 16 == 0 && N1 % 16 == 0 && NT == 256, "dw tile");
  const int ti = tid / 16, tj = tid % 16;
  float p_w[MI][MJ];
#pragma unroll
  for (int u = 0; u < MI; ++u)
#pragma unroll
    for (int v = 0; v < MJ; ++v) p_w[u][v] = 0.f;
  using GV = GradMap<D, R>;
  float p_wd[GV::Q];
#pragma unroll
  for (int q = 0; q < GV::Q; ++q) p_wd[q] = 0.f;
  float p_bd = 0.f, p_add = 0.f;

  for (int tile = 0; tile < tiles_per_chunk; ++tile) {
    const int t0 = (chunk * tiles_per_chunk + tile) * TM;
    if (t0 >= T) break;
    __syncthreads();   // the previous tile's shared reads are done
    for (int i = tid; i < TM * R; i += NT) {
      const int r = i / R, c = i % R, t = t0 + r;
      float cur = 0.f, past = 0.f, g = 0.f;
      if (t < T) {
        cur = x[(base + t) * R + c];
        g = dy[(base + t) * R + c];
        if (t >= d) past = x[(base + t - d) * R + c];
      }
      s_cat[r * CS + c] = past;
      s_cat[r * CS + R + c] = cur;
      s_dy[r * VS + c] = g;
    }
    __syncthreads();

    // Recompute fg = [past | cur] @ w + add[b], then tanh, sigmoid, z.
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
          const float wf = s_w[k * WS + cg + c * M1::NG];
          const float wg = s_w[k * WS + D + cg + c * M1::NG];
#pragma unroll
          for (int i = 0; i < M1::RM; ++i) {
            af[i][c] = fmaf(a[i], wf, af[i][c]);
            ag[i][c] = fmaf(a[i], wg, ag[i][c]);
          }
        }
      }
      const float* add_b = add + (size_t)b * N1;
#pragma unroll
      for (int i = 0; i < M1::RM; ++i) {
        const int r = rg + i * M1::RG;
#pragma unroll
        for (int c = 0; c < M1::CN; ++c) {
          const int j = cg + c * M1::NG;
          const float th = tanhf(af[i][c] + add_b[j]);
          const float sg = sigmoidf(ag[i][c] + add_b[D + j]);
          s_t[r * DS + j] = th;
          s_s[r * DS + j] = sg;
          s_z[r * DS + j] = th * sg;
        }
      }
    }
    __syncthreads();

    // dz_tot = dz + dy @ wd^T; da = dz_tot * (d z / d fg). Rows past T
    // have dy = dz = 0, so da = 0 there.
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
        for (int i = 0; i < M1::RM; ++i) a[i] = s_dy[(rg + i * M1::RG) * VS + k];
#pragma unroll
        for (int c = 0; c < M1::CN; ++c) {
          const float wv = s_wd[(cg + c * M1::NG) * VS + k];
#pragma unroll
          for (int i = 0; i < M1::RM; ++i) acc[i][c] = fmaf(a[i], wv, acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < M1::RM; ++i) {
        const int r = rg + i * M1::RG, t = t0 + r;
#pragma unroll
        for (int c = 0; c < M1::CN; ++c) {
          const int j = cg + c * M1::NG;
          const float dzt = (t < T ? dz[(base + t) * D + j] : 0.f) + acc[i][c];
          const float th = s_t[r * DS + j], sg = s_s[r * DS + j];
          s_da[r * AS + j] = dzt * sg * (1.f - th * th);
          s_da[r * AS + D + j] = dzt * th * sg * (1.f - sg);
        }
      }
    }
    __syncthreads();

    // dx_local = dy + da @ w[1]^T; dpast = da @ w[0]^T.
    using M2 = TileMap<R>;
    {
      const int cg = tid % M2::NG, rg = tid / M2::NG;
      float ac[M2::RM][M2::CN], ap[M2::RM][M2::CN];
#pragma unroll
      for (int i = 0; i < M2::RM; ++i)
#pragma unroll
        for (int c = 0; c < M2::CN; ++c) ac[i][c] = ap[i][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N1; ++k) {
        float a[M2::RM];
#pragma unroll
        for (int i = 0; i < M2::RM; ++i) a[i] = s_da[(rg + i * M2::RG) * AS + k];
#pragma unroll
        for (int c = 0; c < M2::CN; ++c) {
          const int col = cg + c * M2::NG;
          const float wc = s_w[(R + col) * WS + k];
          const float wp = s_w[col * WS + k];
#pragma unroll
          for (int i = 0; i < M2::RM; ++i) {
            ac[i][c] = fmaf(a[i], wc, ac[i][c]);
            ap[i][c] = fmaf(a[i], wp, ap[i][c]);
          }
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
          dx_local[o] = s_dy[r * VS + col] + ac[i][c];
          dpast[o] = ap[i][c];
        }
      }
    }

    // Partial sums over this tile's rows, in a fixed order:
    // dw += [x(t-d) | x(t)]^T @ da, dwd += z^T @ dy, dbd += dy, dadd += da.
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
    {
      const int j = tid % R;
#pragma unroll
      for (int q = 0; q < GV::Q; ++q) {
        const int i = tid / R + q * GV::P;
        if (i < D) {
          float s = p_wd[q];
          for (int r = 0; r < TM; ++r) s = fmaf(s_z[r * DS + i], s_dy[r * VS + j], s);
          p_wd[q] = s;
        }
      }
      if (tid < R)
        for (int r = 0; r < TM; ++r) p_bd += s_dy[r * VS + tid];
      if (tid < N1)
        for (int r = 0; r < TM; ++r) p_add += s_da[r * AS + tid];
    }
  }

  // Partial-sum layout of reduce_partials_kernel with one layer.
  const size_t cta = (size_t)b * nchunk + chunk;
  float* pw = part_w + cta * (K1 * N1);
#pragma unroll
  for (int u = 0; u < MI; ++u)
#pragma unroll
    for (int v = 0; v < MJ; ++v) pw[(ti + 16 * u) * N1 + tj + 16 * v] = p_w[u][v];
  float* pa = part_a + cta * (D * R + R);
  {
    const int j = tid % R;
#pragma unroll
    for (int q = 0; q < GV::Q; ++q) {
      const int i = tid / R + q * GV::P;
      if (i < D) pa[i * R + j] = p_wd[q];
    }
  }
  if (tid < R) pa[D * R + tid] = p_bd;
  if (tid < N1) part_add[cta * N1 + tid] = p_add;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The backward's shared memory (~88 KB at R = D = 32) fits two blocks per
// SM; the grid keeps every block in the first wave.
Tiling backward_tiling(int B, int T) { return chunk_tiling(B, T, TM, 2); }

template <int R, int D>
int forward_impl(const float* x, const float* w, const float* wd,
                 const float* add, const float* bd, float* y, float* z, int B,
                 int T, int d, cudaStream_t st) {
  const int smem =
      (int)sizeof(float) * (4 * R * D + D * R + TM * (2 * R + 1) + TM * (D + 1));
  cudaError_t e = cudaFuncSetAttribute(
      layer_fwd_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  layer_fwd_kernel<R, D><<<dim3((T + TM - 1) / TM, B), NT, smem, st>>>(
      x, w, wd, add, bd, y, z, T, d);
  return (int)cudaGetLastError();
}

template <int R, int D>
int backward_impl(const float* x, const float* w, const float* wd,
                  const float* add, const float* dy, const float* dz,
                  float* dx_local, float* dpast, float* dw, float* dwd,
                  float* dadd, float* dbd, float* scratch, int B, int T,
                  int d, cudaStream_t st) {
  const Tiling tl = backward_tiling(B, T);
  const size_t ncta = (size_t)B * tl.nchunk;
  float* pw = scratch;                              // [ncta, 2R, 2D]
  float* pa = pw + ncta * 4 * R * D;                // [ncta, D*R + R]
  float* padd = pa + ncta * (D * R + R);            // [ncta, 2D]
  const int smem = (int)sizeof(float) *
                   (2 * R * (2 * D + 1) + D * (R + 1) + TM * (2 * R + 1) +
                    TM * (R + 1) + 3 * TM * (D + 1) + TM * (2 * D + 1));
  cudaError_t e = cudaFuncSetAttribute(
      layer_bwd_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  layer_bwd_kernel<R, D><<<dim3(tl.nchunk, B), NT, smem, st>>>(
      x, w, wd, add, dy, dz, dx_local, dpast, pw, pa, padd, T, d,
      tl.tiles_per_chunk, tl.nchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce_partials<NT>(pw, pa, padd, dw, dwd, dbd, dadd, B,
                                         tl.nchunk, 1, R, D, st);
}

constexpr int kUnsupportedWidth = 1000;

}  // namespace

extern "C" {

// Widths the kernels are built for: R == D in {8, 16, 32}.
int dilated_layer_supports_width(int R, int D) {
  return R == D && (R == 8 || R == 16 || R == 32);
}

// Floats of scratch device memory the backward needs.
long long dilated_layer_bwd_scratch_floats(int B, int T, int R, int D) {
  const Tiling tl = backward_tiling(B, T);
  return (long long)B * tl.nchunk * (4LL * R * D + D * R + R + 2 * D);
}

// Forward (one launch). x [B,T,R]; w [2,R,2D]; wd [D,R]; add [B,2D]; bd
// [1,R]; outputs y [B,T,R], z [B,T,D]. Returns 0 or a CUDA error code.
int dilated_layer_fwd_f32(const float* x, const float* w, const float* wd,
                          const float* add, const float* bd, float* y,
                          float* z, int B, int T, int R, int D, int dilation,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dilated_layer_supports_width(R, D)) return kUnsupportedWidth;
  if (R == 32) return forward_impl<32, 32>(x, w, wd, add, bd, y, z, B, T, dilation, st);
  if (R == 16) return forward_impl<16, 16>(x, w, wd, add, bd, y, z, B, T, dilation, st);
  return forward_impl<8, 8>(x, w, wd, add, bd, y, z, B, T, dilation, st);
}

// Backward (the kernel, then the fixed-order reduction). Inputs as the
// forward's (no bd) plus dy [B,T,R] and dz [B,T,D]; outputs dx_local,
// dpast [B,T,R], dw [2,R,2D], dwd [D,R], dadd [B,2D], dbd [1,R]; scratch
// as sized by dilated_layer_bwd_scratch_floats. Returns 0 or a CUDA error
// code.
int dilated_layer_bwd_f32(const float* x, const float* w, const float* wd,
                          const float* add, const float* dy, const float* dz,
                          float* dx_local, float* dpast, float* dw,
                          float* dwd, float* dadd, float* dbd, float* scratch,
                          int B, int T, int R, int D, int dilation,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dilated_layer_supports_width(R, D)) return kUnsupportedWidth;
  if (R == 32)
    return backward_impl<32, 32>(x, w, wd, add, dy, dz, dx_local, dpast, dw,
                                 dwd, dadd, dbd, scratch, B, T, dilation, st);
  if (R == 16)
    return backward_impl<16, 16>(x, w, wd, add, dy, dz, dx_local, dpast, dw,
                                 dwd, dadd, dbd, scratch, B, T, dilation, st);
  return backward_impl<8, 8>(x, w, wd, add, dy, dz, dx_local, dpast, dw, dwd,
                             dadd, dbd, scratch, B, T, dilation, st);
}

}  // extern "C"
