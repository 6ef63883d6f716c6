// fused_stack_mma: the whole dilated stack of a training step, forward and
// backward, on Hopper's tensor cores (filter_width 2), for the widths
// R = D = 32 (the paper and gc configs) and R = D = 64 (wide), the width a
// template parameter, in two modes of one source, the precision a template
// parameter too:
// - f32 (float32 parity, 3xTF32; records float32): fused_stack_mma_*_f32;
// - bf16 (bf16 operands, float32 accumulation and residual; fg and z
//   records bf16): fused_stack_mma_*_bf16.
// The C entry points dispatch on (r, d); any other width returns
// kUnsupportedWidth.
//
// Replaces, beside the FP32-core kernels of fused_stack.cu (which keep
// widths 8 and 16, float32 only), the TPU (Pallas) kernel pair of the JAX
// package
//   wavenet_tpu/kernels/fused_stack3.py:105  _fwd_kernel
//   wavenet_tpu/kernels/fused_stack3.py:276  _bwd_kernel
// in both of its compute dtypes. It computes what fused_stack.cu computes:
// per layer l with dilation d,
//   fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   x' = x + (z @ wd[l] + bd[l])                    (bf16: (x + z @ wd) + bd)
// emitting y, fg [B, T, L*2D] and z [B, T, L*D]; the backward rebuilds each
// layer's input by subtraction and sums the weight gradients from per-block
// partials in a fixed order (no float atomics: repeated calls are bitwise
// equal). Launches as in fused_stack.cu: L forward, 2L + 1 backward.
//
// bf16 mode, as the TPU kernel at kernel_dtype = bfloat16: the weights,
// the tap matrix [x(t-d) | x(t)], z (the forward's and the one the
// backward recomputes from the bf16 fg record), dx_{l+1} and da are
// rounded to bf16 (to nearest even) before their products; x, y, fg's
// float32 sum, the gate, dx and every gradient stay float32; dz is read in
// bf16. The backward's rebuild x_l = x_{l+1} - bf16(z) @ bf16(wd) - bd
// reads z recomputed from the fg record, as the TPU kernel does.
//
// What bounds it. At gc b8 x 19,071 rows the forward does 4.7e10 FLOPs
// and moves ~1.8 GB in f32 (~1.0 GB in bf16: 2-byte records), the backward
// 1.0e11 and ~1.8 GB (~1.1 GB); at wide b8 x 19,100 rows (R = D = 64) four
// times the products and twice the bytes: forward 1.9e11 FLOPs and 3.6 GB
// (1.8 GB in bf16), backward 4.1e11 and 3.6 GB (1.9 GB). On the FP32 cores
// (67 TFLOP/s) both were bound by operations, and fused_stack.cu's
// products by shared-memory loads (4-12 loads per 16 FMAs). The TPU kernel
// multiplies through mxu_dot: at float32, Precision.HIGHEST, a multi-pass
// bf16 product exact to float32, whose counterpart here is 3xTF32
// (tf32_mma.cuh): 495 / 3 = 165 TFLOP/s, which leaves the gc forward bound
// by bytes (0.54 ms) and its backward by operations (0.63 ms), and both
// wide directions by operations (1.14 and 2.50 ms); at bf16 one native
// pass, here one bf16 mma.sync (bf16_mma.cuh, 989 TFLOP/s), which leaves
// every one bound by bytes (wide: 0.55 and 0.56 ms). A launch per layer
// also moves each layer's x in and out (and, backward, da and the rebuilt
// x between (A) and (B)) through L2 and HBM, ~100-150 MB a launch at gc b8
// in f32: that traffic, not the products, is what this design waits on at
// R = D = 32 (PERF.md §6).
//
// Design. The forward kernel, with the layout and fragment loaders that
// the backward shares, sits in fused_stack_mma_fwd.cuh (the r2 probe,
// fwd_bisect_mma.cu, instantiates it with parts masked).
// - f32: every product runs as mma.sync m16n8k8 TF32 in three passes
//   (lo.hi, hi.lo, hi.hi), float32 accumulation. The weights are split once
//   per block into hi/lo and stored in fragment order (one 16-byte load a
//   lane per 8x8 fragment); activations are split as their fragments load.
//   The passes run pass-major over a warp's n-tiles (and over two k-steps
//   where a warp owns one tile), so that consecutive mma.sync never wait
//   on each other's accumulator.
// - bf16: every product runs as one mma.sync m16n8k16 bf16 pass. The
//   weights are rounded once per block and stored in fragment order (one
//   8-byte load a lane per 16x8 fragment); activations (float32 tiles, or
//   the bf16 fg and da tiles) are rounded and paired along k as their
//   fragments load, by hand for the tiles read transposed.
// - Width 64 (Cfg below decides each from the shared-memory budget, 227 KB
//   a block): every tile and product is twice as wide and the products'
//   operands four times as many, so one block an SM. In f32 the split
//   weights do not fit (the forward's w_fg alone is 128 KB as hi/lo): the
//   weights are kept as float pairs in fragment order (8 bytes a lane) and
//   split as each fragment loads, and (B), whose two stages of float32 da
//   and x tiles are 200 KB, holds one stage (the next tile loads after the
//   current one's products). Each warp owns four times the accumulators of
//   width 32 in the weight-gradient products (dw_fg: two m-tiles by eight
//   n-tiles, 64 floats a thread).
// - Persistent blocks: each block walks a fixed chunk of 64-row tiles of
//   one batch row (chunk_tiling, as many blocks an SM as the forward's and
//   (A)'s shared memory allows, at most 2), so a layer's weights are read
//   ~240 times a layer at width 32, not once per tile (2,384 times at gc
//   b8).
// - cp.async double-buffers the next tile's rows (the current rows, the
//   past tap x(t-d), the future gradient tap da(t+d), the fg slice),
//   zero-filling rows outside [0, T), while the current tile multiplies.
// - Shared row strides are 4 (mod 32) words (16 bytes of padding a row),
//   so row-major fragment loads are free of bank conflicts; the
//   weight-gradient products, which read a tile transposed, take 2-way
//   conflicts on their A operand in f32.
// - Eight warps a block; warp w owns rows 16 (w / 2) of the tile and half
//   of each product's columns (the filter and gate columns a thread holds
//   pair up, so the gate is computed in registers).
//
// Registers a thread (ptxas -v for sm_90a, chip_smoke.py's build lines), no
// spills in any instantiation: forward / (A) / (B) at width 32 f32 112 /
// 95 / 133, bf16 69 / 114 / 83; at width 64 f32 136 / 168 / 218, bf16
// 120 / 129 / 152.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fused_stack_mma_fwd.cuh"

namespace {

// bf16: the pairs along k are two rows of the tile, packed by hand.
template <int S, typename T>
__device__ __forceinline__ void afrag_t(const T* s, int m0, int k0, int lane,
                                        Bf16::A& a) {
  const int g = lane >> 2, q = lane & 3;
  const T* p = s + (k0 + 2 * q) * S + m0 + g;
  a.v[0] = pack_bf16(tof(p[0]), tof(p[S]));
  a.v[1] = pack_bf16(tof(p[8]), tof(p[S + 8]));
  a.v[2] = pack_bf16(tof(p[8 * S]), tof(p[9 * S]));
  a.v[3] = pack_bf16(tof(p[8 * S + 8]), tof(p[9 * S + 8]));
}

// Two k-steps into two accumulators (two independent chains); f32 runs
// their passes interleaved.
__device__ __forceinline__ void mma_2k(float (&c)[2][4], const Tf32x3::A& a0,
                                       const uint4& b0, const Tf32x3::A& a1,
                                       const uint4& b1) {
  mma_tf32(c[0], a0.lo, b0.x, b0.y);
  mma_tf32(c[1], a1.lo, b1.x, b1.y);
  mma_tf32(c[0], a0.hi, b0.z, b0.w);
  mma_tf32(c[1], a1.hi, b1.z, b1.w);
  mma_tf32(c[0], a0.hi, b0.x, b0.y);
  mma_tf32(c[1], a1.hi, b1.x, b1.y);
}

__device__ __forceinline__ void mma_2k(float (&c)[2][4], const Bf16::A& a0,
                                       const uint2& b0, const Bf16::A& a1,
                                       const uint2& b1) {
  mma_bf16(c[0], a0.v, b0.x, b0.y);
  mma_bf16(c[1], a1.v, b1.x, b1.y);
}

// ---------------------------------------------------------------------------
// Backward (A): da, the rebuilt layer input, partial dwd / dbd / dadd.
// grid (chunks, B); each block walks tiles_per_chunk tiles.
// ---------------------------------------------------------------------------

template <class P, int R>
__global__ void __launch_bounds__(NT, (Cfg<P, R>::kPerSm)) bwd_da_mma_kernel(
    const float* __restrict__ x_next, const float* __restrict__ dx_next,
    const typename P::Rec* __restrict__ fg,
    const typename P::Rec* __restrict__ dz, const float* __restrict__ wd,
    const float* __restrict__ bd, float* __restrict__ x_cur,
    typename P::Rec* __restrict__ da_out, float* __restrict__ part_a,
    float* __restrict__ part_add, int T, int l, int L, int tiles_per_chunk,
    int nchunk) {
  using C = Cfg<P, R>;
  using W = typename P::W;
  using WS = typename C::WS;
  using Rec = typename P::Rec;
  constexpr int D = R, N1 = C::N1, SR = C::SR, S2D = C::S2D, SRec = C::SRec;
  constexpr int NQ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WS* s_wdf = reinterpret_cast<WS*>(smem_raw);               // B = wd [D][R]
  WS* s_wdt = reinterpret_cast<WS*>(smem_raw + C::kWdr);     // B = wd^T [R][D]
  unsigned char* s_st = smem_raw + 2 * C::kWdr;              // 2 stages
  float* s_z = reinterpret_cast<float*>(s_st + 2 * C::kAStage);  // [TM][SR]
  float* s_da = s_z + TM * SR;                               // [TM][S2D]
  // (tanh f, sigmoid g) [TM][S2D]: in bf16 a tile of its own, in f32 the
  // stage's fg slice, converted in place.
  float* s_tsb = s_da + TM * S2D;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = w >> 1, h = w & 1;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * T;
  const size_t fg_ld = (size_t)L * N1, z_ld = (size_t)L * D;
  const int tile0 = chunk * tiles_per_chunk;
  const int ntiles = min(tiles_per_chunk, (T + TM - 1) / TM - tile0);

  auto stage_dc = [&](int i) {
    return reinterpret_cast<float*>(s_st + (i & 1) * C::kAStage);
  };
  auto stage_fg = [&](int i) {
    return reinterpret_cast<Rec*>(s_st + (i & 1) * C::kAStage + C::kTR);
  };
  auto issue = [&](int i) {
    const int t0 = (tile0 + i) * TM;
    load_rows<R, SR>(stage_dc(i), dx_next, base, R, 0, t0, 0, T);
    load_rows<N1, SRec>(stage_fg(i), fg, base, fg_ld, l * N1, t0, 0, T);
  };
  issue(0);
  cp_async_commit();
  stage_weights<D, R>(s_wdf, [&](int k, int n) { return wd[k * R + n]; });
  stage_weights<R, D>(s_wdt, [&](int k, int n) { return wd[n * R + k]; });

  // dwd [D][R] partial: m-tile mw, n-tiles nw0 .. nw0 + NJW - 1 (at width
  // 32 one n-tile, summed in two chains of even and odd k-steps).
  constexpr int WPM = NW / (D / 16);   // warps an m-tile
  constexpr int NJW = (R / 8) / WPM;   // n-tiles a warp
  const int mw = w / WPM, nw0 = (w % WPM) * NJW;
  float p_wd[NJW == 1 ? 2 : NJW][4];
#pragma unroll
  for (int j = 0; j < (NJW == 1 ? 2 : NJW); ++j) zero(p_wd[j]);
  float p_bd = 0.f, p_add = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* s_dc = stage_dc(i);                          // [TM][SR]
    const Rec* s_fg = stage_fg(i);                            // [TM][SRec]
    float* s_ts = P::kBf16 ? s_tsb : reinterpret_cast<float*>(stage_fg(i));
    const int t0 = (tile0 + i) * TM;

    // fg -> (tanh f, sigmoid g), and z = tanh(f) * sigmoid(g) (0 on rows
    // past T, where fg is 0).
    for (int e = tid; e < TM * D; e += NT) {
      const int r = e / D, c = e % D;
      const float th = tanhf(tof(s_fg[r * SRec + c]));
      const float sg = sigmoidf(tof(s_fg[r * SRec + D + c]));
      s_ts[r * S2D + c] = th;
      s_ts[r * S2D + D + c] = sg;
      s_z[r * SR + c] = th * sg;
    }
    __syncthreads();

    // dz_tot = dz + dx_{l+1} @ wd^T; da = dz_tot * (d z / d fg).
    {
      float acc[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) zero(acc[j]);
#pragma unroll
      for (int ks = 0; ks < R / P::KS; ++ks) {
        typename P::A a;
        afrag<SR>(s_dc, 16 * mt, ks * P::KS, lane, a);
        W bw[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
          bw[j] = wfrag<D / 8>(s_wdt, ks, NQ * h + j, lane);
        mma_n(acc, a, bw);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = (D / 2) * h + 8 * j + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * mt + g + 8 * half, t = t0 + r;
          float2 dzv = make_float2(0.f, 0.f);
          if (t < T) dzv = load2(dz + (base + t) * z_ld + l * D + col);
          float daf[2], dag[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float dzt = (c ? dzv.y : dzv.x) + acc[j][2 * half + c];
            const float th = s_ts[r * S2D + col + c];
            const float sg = s_ts[r * S2D + D + col + c];
            daf[c] = dzt * sg * (1.f - th * th);
            dag[c] = dzt * th * sg * (1.f - sg);
          }
          *reinterpret_cast<float2*>(s_da + r * S2D + col) =
              make_float2(daf[0], daf[1]);
          *reinterpret_cast<float2*>(s_da + r * S2D + D + col) =
              make_float2(dag[0], dag[1]);
          if (t < T) {
            Rec* o = da_out + (base + t) * N1 + col;
            store2(o, daf[0], daf[1]);
            store2(o + D, dag[0], dag[1]);
          }
        }
      }
    }
    __syncthreads();   // the z and da tiles are whole

    // x_l = x_{l+1} - z @ wd - bd
    {
      float acc[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) zero(acc[j]);
#pragma unroll
      for (int ks = 0; ks < D / P::KS; ++ks) {
        typename P::A a;
        afrag<SR>(s_z, 16 * mt, ks * P::KS, lane, a);
        W bw[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
          bw[j] = wfrag<R / 8>(s_wdf, ks, NQ * h + j, lane);
        mma_n(acc, a, bw);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = (R / 2) * h + 8 * j + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + 16 * mt + g + 8 * half;
          if (t >= T) continue;
          const size_t o = (base + t) * R + col;
          const float2 xn = *reinterpret_cast<const float2*>(x_next + o);
          *reinterpret_cast<float2*>(x_cur + o) =
              make_float2((xn.x - acc[j][2 * half]) - bd[col],
                          (xn.y - acc[j][2 * half + 1]) - bd[col + 1]);
        }
      }
    }

    // dwd += z^T @ dx_{l+1} over this tile's rows.
    if constexpr (NJW == 1) {
#pragma unroll
      for (int ks = 0; ks < TM / P::KS; ks += 2) {
        typename P::A a0, a1;
        afrag_t<SR>(s_z, 16 * mw, ks * P::KS, lane, a0);
        afrag_t<SR>(s_z, 16 * mw, ks * P::KS + P::KS, lane, a1);
        W b0, b1;
        bfrag<SR>(s_dc, ks * P::KS, 8 * nw0, lane, b0);
        bfrag<SR>(s_dc, ks * P::KS + P::KS, 8 * nw0, lane, b1);
        mma_2k(p_wd, a0, b0, a1, b1);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < TM / P::KS; ++ks) {
        typename P::A a;
        afrag_t<SR>(s_z, 16 * mw, ks * P::KS, lane, a);
        W bz[NJW];
#pragma unroll
        for (int j = 0; j < NJW; ++j)
          bfrag<SR>(s_dc, ks * P::KS, 8 * (nw0 + j), lane, bz[j]);
        mma_n(p_wd, a, bz);
      }
    }
    // dbd and dadd: column sums in row order.
    if (tid < R)
      for (int r = 0; r < TM; ++r) p_bd += s_dc[r * SR + tid];
    else if (tid >= 64 && tid < 64 + N1)
      for (int r = 0; r < TM; ++r) p_add += s_da[r * S2D + tid - 64];
    __syncthreads();   // the stage, z and da tiles are free again
  }

  const size_t cta = (size_t)b * nchunk + chunk;
  float* pa = part_a + cta * (D * R + R);
#pragma unroll
  for (int j = 0; j < NJW; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * mw + g + 8 * half, col = 8 * (nw0 + j) + 2 * q;
      float v0 = p_wd[j][2 * half], v1 = p_wd[j][2 * half + 1];
      if constexpr (NJW == 1) {   // the odd k-steps' chain
        v0 += p_wd[1][2 * half];
        v1 += p_wd[1][2 * half + 1];
      }
      pa[row * R + col] = v0;
      pa[row * R + col + 1] = v1;
    }
  }
  if (tid < R) pa[D * R + tid] = p_bd;
  else if (tid >= 64 && tid < 64 + N1) part_add[cta * N1 + tid - 64] = p_add;
}

// ---------------------------------------------------------------------------
// Backward (B): dx_l and partial dw_fg. Same grid as (A).
// ---------------------------------------------------------------------------

template <class P, int R>
__global__ void __launch_bounds__(NT, 1) bwd_dx_mma_kernel(
    const float* __restrict__ x_cur, const float* __restrict__ dx_next,
    const typename P::Rec* __restrict__ da, const float* __restrict__ w_fg,
    float* __restrict__ dx_cur, float* __restrict__ part_w, int T, int d,
    int tiles_per_chunk, int nchunk) {
  using C = Cfg<P, R>;
  using W = typename P::W;
  using WS = typename C::WS;
  using Rec = typename P::Rec;
  constexpr int K1 = C::K1, N1 = C::N1, SR = C::SR, SRec = C::SRec;
  constexpr int NQ = R / 16, NS = C::kBStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WS* s_wc = reinterpret_cast<WS*>(smem_raw);            // B = w_fg[R:]^T [N1][R]
  WS* s_wp = reinterpret_cast<WS*>(smem_raw + C::kWb);   // B = w_fg[:R]^T [N1][R]
  unsigned char* s_st = smem_raw + 2 * C::kWb;           // NS stages

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = w >> 1, h = w & 1;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const size_t base = (size_t)b * T;
  const int tile0 = chunk * tiles_per_chunk;
  const int ntiles = min(tiles_per_chunk, (T + TM - 1) / TM - tile0);

  // Stage parts: da(t), da(t + d) [TM][SRec]; x_l(t - d), x_l(t) [TM][SR].
  auto stage_da = [&](int i, int k) {
    return reinterpret_cast<Rec*>(s_st + (i % NS) * C::kBStage + k * C::kTRec);
  };
  auto stage_x = [&](int i, int k) {
    return reinterpret_cast<float*>(s_st + (i % NS) * C::kBStage +
                                    2 * C::kTRec + k * C::kTR);
  };
  auto issue = [&](int i) {
    const int t0 = (tile0 + i) * TM;
    load_rows<N1, SRec>(stage_da(i, 0), da, base, N1, 0, t0, 0, T);
    load_rows<N1, SRec>(stage_da(i, 1), da, base, N1, 0, t0, d, T);
    load_rows<R, SR>(stage_x(i, 0), x_cur, base, R, 0, t0, -d, T);
    load_rows<R, SR>(stage_x(i, 1), x_cur, base, R, 0, t0, 0, T);
  };
  issue(0);
  cp_async_commit();
  stage_weights<N1, R>(s_wc, [&](int k, int n) { return w_fg[(R + n) * N1 + k]; });
  stage_weights<N1, R>(s_wp, [&](int k, int n) { return w_fg[n * N1 + k]; });

  // dw_fg [K1][N1] partial: m-tiles MPW (w / 2) .. + MPW - 1 (cat columns
  // 16 of them each), n-tiles NJ (w % 2) .. + NJ - 1.
  constexpr int MPW = K1 / 16 / (NW / 2), NJ = N1 / 8 / 2;
  float p_w[MPW][NJ][4];
#pragma unroll
  for (int m = 0; m < MPW; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) zero(p_w[m][j]);

  for (int i = 0; i < ntiles; ++i) {
    // Two stages: tile i + 1 loads under tile i's products. One: it loads
    // after them (below), and this commit closes its group.
    if (NS == 2 && i + 1 < ntiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const Rec* s_da = stage_da(i, 0);       // da(t)
    const Rec* s_dan = stage_da(i, 1);      // da(t + d)
    const float* s_past = stage_x(i, 0);    // x_l(t - d)
    const float* s_cur = stage_x(i, 1);     // x_l(t)
    const int t0 = (tile0 + i) * TM;

    // dx_l = dx_{l+1} + da(t) @ w_fg[R:]^T + da(t + d) @ w_fg[:R]^T
    {
      float ac[NQ][4], ap[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        zero(ac[j]);
        zero(ap[j]);
      }
#pragma unroll
      for (int ks = 0; ks < N1 / P::KS; ++ks) {
        typename P::A a, n;
        afrag<SRec>(s_da, 16 * mt, ks * P::KS, lane, a);
        afrag<SRec>(s_dan, 16 * mt, ks * P::KS, lane, n);
        W bc[NQ], bp[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          bc[j] = wfrag<R / 8>(s_wc, ks, NQ * h + j, lane);
          bp[j] = wfrag<R / 8>(s_wp, ks, NQ * h + j, lane);
        }
        mma_n(ac, a, bc);
        mma_n(ap, n, bp);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = (R / 2) * h + 8 * j + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + 16 * mt + g + 8 * half;
          if (t >= T) continue;
          const size_t o = (base + t) * R + col;
          const float2 dn = *reinterpret_cast<const float2*>(dx_next + o);
          *reinterpret_cast<float2*>(dx_cur + o) = make_float2(
              (dn.x + ac[j][2 * half]) + ap[j][2 * half],
              (dn.y + ac[j][2 * half + 1]) + ap[j][2 * half + 1]);
        }
      }
    }

    // dw_fg += [x_l(t-d) | x_l(t)]^T @ da(t) over this tile's rows.
#pragma unroll
    for (int ks = 0; ks < TM / P::KS; ++ks) {
      W bd[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bfrag<SRec>(s_da, ks * P::KS, 8 * (NJ * h + j), lane, bd[j]);
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
        const int m16 = 16 * (MPW * mt + m);   // cat column of the m-tile
        typename P::A a;
        afrag_t<SR>(m16 < R ? s_past : s_cur, m16 % R, ks * P::KS, lane, a);
        mma_n(p_w[m], a, bd);
      }
    }
    __syncthreads();   // stage i % NS is free again
    if (NS == 1 && i + 1 < ntiles) issue(i + 1);
  }

  float* pw = part_w + ((size_t)b * nchunk + chunk) * (K1 * N1);
#pragma unroll
  for (int m = 0; m < MPW; ++m) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * (NJ * h + j) + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * (MPW * mt + m) + g + 8 * half;
        pw[row * N1 + col] = p_w[m][j][2 * half];
        pw[row * N1 + col + 1] = p_w[m][j][2 * half + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <class P, int R>
int backward_impl(const float* y, const float* dy,
                  const typename P::Rec* fg, const typename P::Rec* dz,
                  const float* w_fg, const float* wd, const float* bd,
                  const int* dil, float* dx, float* dw_fg, float* dwd,
                  float* dadd, float* dbd, float* scratch, int B, int T,
                  int L, cudaStream_t st) {
  using Rec = typename P::Rec;
  using C = Cfg<P, R>;
  constexpr int D = R, K1 = C::K1, N1 = C::N1;
  const Tiling tl = mma_tiling<R>(B, T);
  const size_t ncta = (size_t)B * tl.nchunk;
  const size_t btr = (size_t)B * T * R;
  float* xb = scratch;                               // 2 x [B, T, R]
  float* dxb = xb + 2 * btr;                         // 2 x [B, T, R]
  Rec* dab = reinterpret_cast<Rec*>(dxb + 2 * btr);  // [B, T, 2D] (the
                                                     //   floats of f32)
  float* pw = dxb + 2 * btr + (size_t)B * T * N1;    // [L, ncta, 2R, 2D]
  float* pa = pw + (size_t)L * ncta * K1 * N1;       // [L, ncta, D*R + R]
  float* padd = pa + (size_t)L * ncta * (D * R + R); // [L, ncta, 2D]

  cudaError_t e = cudaFuncSetAttribute(
      bwd_da_mma_kernel<P, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kA);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      bwd_dx_mma_kernel<P, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kB);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid(tl.nchunk, B);
  for (int l = L - 1; l >= 0; --l) {
    const float* x_next = l == L - 1 ? y : xb + (size_t)((l + 1) & 1) * btr;
    float* x_cur = xb + (size_t)(l & 1) * btr;
    const float* dx_next = l == L - 1 ? dy : dxb + (size_t)((l + 1) & 1) * btr;
    float* dx_cur = l == 0 ? dx : dxb + (size_t)(l & 1) * btr;
    bwd_da_mma_kernel<P, R><<<grid, NT, C::kA, st>>>(x_next, dx_next, fg, dz, wd + (size_t)l * D * R, bd + (size_t)l * R, x_cur, dab, pa + (size_t)l * ncta * (D * R + R), padd + (size_t)l * ncta * N1, T, l, L, tl.tiles_per_chunk, tl.nchunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bwd_dx_mma_kernel<P, R><<<grid, NT, C::kB, st>>>(x_cur, dx_next, dab, w_fg + (size_t)l * K1 * N1, dx_cur, pw + (size_t)l * ncta * K1 * N1, T, dil[l], tl.tiles_per_chunk, tl.nchunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_reduce_partials<NT>(pw, pa, padd, dw_fg, dwd, dbd, dadd,
                                         B, tl.nchunk, L, R, D, st);
}

template <int R>
long long scratch_floats(int B, int T, int L) {
  constexpr int D = R, K1 = 2 * R, N1 = 2 * D;
  const Tiling tl = mma_tiling<R>(B, T);
  const long long bt = (long long)B * T, ncta = (long long)B * tl.nchunk;
  return 4 * bt * R + bt * N1 +
         (long long)L * ncta * (K1 * N1 + D * R + R + N1);
}

constexpr int kUnsupportedWidth = 1000;

// The built widths (R == D).
bool built(int r, int d) { return r == d && (r == 32 || r == 64); }

}  // namespace

extern "C" {

// Floats of scratch device memory the backward needs (either mode); -1 at
// a width not built.
long long fused_stack_mma_bwd_scratch_floats(int B, int T, int L, int r,
                                             int d) {
  if (!built(r, d)) return -1;
  return r == 32 ? scratch_floats<32>(B, T, L) : scratch_floats<64>(B, T, L);
}

// Forward launches (L of them); the arguments of fused_stack_fwd_f32
// (fused_stack.cu). Returns 0 or a CUDA error code.
int fused_stack_mma_fwd_f32(const float* x, const float* w_fg, const float* wd,
                            const float* add, const float* bd, const int* dil,
                            float* y, float* fg, float* z, float* xbuf, int B,
                            int T, int L, int r, int d, void* stream) {
  if (!built(r, d)) return kUnsupportedWidth;
  auto* f = r == 32 ? &forward_impl<Tf32x3, 32> : &forward_impl<Tf32x3, 64>;
  return f(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T, L,
           (cudaStream_t)stream);
}

// Backward launches (2L + 1 of them); the arguments of fused_stack_bwd_f32
// (fused_stack.cu), scratch sized by fused_stack_mma_bwd_scratch_floats.
// Returns 0 or a CUDA error code.
int fused_stack_mma_bwd_f32(const float* y, const float* dy, const float* fg,
                            const float* dz, const float* w_fg,
                            const float* wd, const float* bd, const int* dil,
                            float* dx, float* dw_fg, float* dwd, float* dadd,
                            float* dbd, float* scratch, int B, int T, int L,
                            int r, int d, void* stream) {
  if (!built(r, d)) return kUnsupportedWidth;
  auto* f = r == 32 ? &backward_impl<Tf32x3, 32> : &backward_impl<Tf32x3, 64>;
  return f(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd, dadd, dbd,
           scratch, B, T, L, (cudaStream_t)stream);
}

// The bf16 mode: the arguments of fused_stack_mma_fwd_f32, with fg and z
// bf16 [B, T, L*2D] and [B, T, L*D] (float32 weights, rounded in the
// kernel).
int fused_stack_mma_fwd_bf16(const float* x, const float* w_fg,
                             const float* wd, const float* add,
                             const float* bd, const int* dil, float* y,
                             __nv_bfloat16* fg, __nv_bfloat16* z, float* xbuf,
                             int B, int T, int L, int r, int d, void* stream) {
  if (!built(r, d)) return kUnsupportedWidth;
  auto* f = r == 32 ? &forward_impl<Bf16, 32> : &forward_impl<Bf16, 64>;
  return f(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T, L,
           (cudaStream_t)stream);
}

// The bf16 mode: the arguments of fused_stack_mma_bwd_f32, with fg and dz
// bf16; every output float32.
int fused_stack_mma_bwd_bf16(const float* y, const float* dy,
                             const __nv_bfloat16* fg, const __nv_bfloat16* dz,
                             const float* w_fg, const float* wd,
                             const float* bd, const int* dil, float* dx,
                             float* dw_fg, float* dwd, float* dadd, float* dbd,
                             float* scratch, int B, int T, int L, int r,
                             int d, void* stream) {
  if (!built(r, d)) return kUnsupportedWidth;
  auto* f = r == 32 ? &backward_impl<Bf16, 32> : &backward_impl<Bf16, 64>;
  return f(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd, dadd, dbd,
           scratch, B, T, L, (cudaStream_t)stream);
}

}  // extern "C"
