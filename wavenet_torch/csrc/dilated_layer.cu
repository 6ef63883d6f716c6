// dilated_layer: one gated dilated layer of a training step, forward and a
// flash-style backward, on the tensor cores of NVIDIA Hopper (sm_90a).
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
// Design.
// - A grid (nchunk, B) from chunk_tiling (stack_common.cuh), sized by the
//   blocks of the kernel that the card keeps resident (the library's
//   dilated_layer_nchunk; experiments/dilated_layer.py:layer_tiling is its
//   Python mirror): block c of row b walks that row's chunk c of
//   consecutive time tiles of TM = 128 steps, in order. The past tap x(t -
//   d) is read straight from device memory, zeros for t < d: the TPU
//   wrapper materialises a shifted copy of x only because a BlockSpec
//   cannot express a halo.
// - Weights once a block. cp.async brings w | wd raw (20 KB at R = D =
//   32); the block splits them once into TF32 {hi, lo} pairs, planes of
//   row stride + 4 from which a B fragment of the matrix or of its
//   transpose loads without bank conflicts, and keeps them for every tile
//   of its chunk.
// - The tensor cores. Every product runs as 3xTF32 mma.sync m16n8k8
//   (tf32_mma.cuh), float32 accumulation: eight warps a block, warp w owns
//   the tile's rows 16w..16w + 15 and every column, so filter column j and
//   gate column D + j meet in a lane and the gate runs in registers.
// - Forward: each warp streams its own 16 rows of x(t) and x(t - d) by
//   cp.async into one of two buffers while it computes on the other, so
//   no block barrier follows the weight split. z goes back as the A
//   fragments of z @ wd by warp shuffles; y and z are staged over the
//   warp's rows of the tile and leave as 16-byte row stores.
// - Backward: the next tile's x(t), x(t - d) and dy are in flight while
//   the current one computes. Each warp recomputes fg, then tanh, sigmoid
//   and z; dz_tot = dz + dy @ wd^T (dz read at the lane's accumulator
//   positions); da; then [dx_local - dy | dpast] = da @ [w[1]^T | w[0]^T],
//   one product of N = 2R. After a barrier the weight gradients contract
//   the tile's rows, split among the warps: dw = [x(t - d) | x(t)]^T @ da,
//   dwd = z^T @ dy, each k-step's product added to a float32 register sum
//   (mma3_step_rn). dbd and dadd are column sums that each lane keeps for
//   its rows. Two barriers a tile.
// - The partial sums stay in registers across the block's chunk and are
//   written once a block in reduce_partials_kernel's layout; its launch
//   adds them in a fixed order. No float atomics: repeated calls on one
//   card are bitwise equal, and y, z, dx_local and dpast do not depend on
//   the grid.
// - The precision is a template parameter (Cfg<P, W>): Tf32x3, the float32
//   mode, or Bf16, the counterpart of the TPU kernels at compute_dtype =
//   bfloat16 (dilated_layer_{fwd,bwd}_bf16). There every product is one
//   bf16 mma.sync m16n8k16 pass (bf16_mma.cuh) with float32 accumulation,
//   its operands rounded to bf16 to nearest even as their fragments are
//   packed: the weights once a block (in fragment order, one 8-byte load a
//   lane), x (the residual too: y = (bf16(x) + z @ wd) + bd, the TPU
//   kernel's order, since its wrapper rounds x itself), z, dy and da. dy
//   and dz are rounded on load, as the TPU wrapper rounds them: dx_local =
//   bf16(dy) + da @ w[1]^T and dbd sums bf16(dy). dadd sums the float32 da;
//   y, z and every gradient stay float32. At width 8, a product over 8
//   channels is half a k-step, its upper half zeros. z enters z @ wd from
//   the registers without shuffles: the accumulator of n-tiles 2k and 2k +
//   1 is the A fragment of k-step k.
//
// What bounds it. At the gc widths (R = D = 32) and b8 x 19,070 rows a
// layer's forward is 1.6e9 operations against 58.6 MB moved, the backward
// (with the fg recompute) 4.4e9 against 97.6 MB (utils/flops.py
// dilated_layer_cost). At 3xTF32 (495 / 3 = 165 TFLOP/s) both are bound
// by bytes: 0.0175 / 0.0291 ms at 3.35 TB/s (the backward's operations
// alone 0.0265 ms). Beyond the bytes it pays the past tap's second read of
// x (an L2 hit at a stack's dilations), the hi/lo split of every A
// fragment, three mma.sync passes a product, the weight split of each
// block and, in the backward, one block an SM (203 KB of shared memory).
//
// Registers a thread (ptxas -v for sm_90a): forward / backward at width
// 32 120 / 205, 16 93 / 121, 8 66 / 83; in the bf16 mode 101 / 163, 66 /
// 94, 51 / 90; no spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "stack_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int TM = 128;   // time steps a tile
constexpr int NW = 8;     // warps a block; warp w owns rows 16w..16w+15
constexpr int NT = 32 * NW;

// The products' precision: three TF32 passes (the float32 mode), or one
// bf16 pass (the bf16 mode).
struct Tf32x3 {};
struct Bf16 {};

// The layout at precision P and width W = R = D: row strides in floats
// (the tap tile x(t - d) | x(t), dy, da and z; A-fragment loads of a row
// stride = 4 mod 32, transposed ones of 8 mod 32, free of bank conflicts
// where a tile is read one way), the weight planes of uint2 {hi, lo}, and
// the bytes of shared memory of each direction.
template <typename P, int W>
struct Cfg;

template <int W>
struct Cfg<Tf32x3, W> {
  static constexpr int R = W, D = W, K1 = 2 * W, N1 = 2 * W;
  static constexpr int SC = K1 + 4, SY = R + 4, SA = N1 + 8, SZ = D + 8;
  static constexpr int SWF = N1 + 4, SWD = R + 4;
  static constexpr int kRaw = K1 * N1 + D * R;     // floats of w | wd
  static constexpr int kPlanes = 8 * (K1 * SWF + D * SWD);
  static constexpr int kFwdBuf = TM * SC;          // floats a buffer
  static constexpr int kBwdBuf = TM * (SC + SY);
  static constexpr int kFwdSmem = kPlanes + 4 * 2 * kFwdBuf;
  static constexpr int kBwdSmem =
      kPlanes + 4 * (2 * kBwdBuf + TM * SA + TM * SZ);
  static_assert(W % 8 == 0 && W <= 32, "widths 8, 16, 32");
  static_assert(kRaw <= kFwdBuf && kRaw <= kBwdBuf, "raw weights");
  static_assert(NW * (N1 + R) <= TM * SA, "column sums");
  static_assert(kFwdSmem <= 232448 && kBwdSmem <= 232448, "shared memory");
};

// The bf16 mode: the same tiles; the weights as bf16 fragments in fragment
// order (uint2 a lane, bf16_mma.cuh): the forward's w [K1][N1] and wd
// [D][R], the backward's w, wd^T [R][D] and [w[1]^T | w[0]^T] [N1][2R].
template <int W>
struct Cfg<Bf16, W> {
  static constexpr int R = W, D = W, K1 = 2 * W, N1 = 2 * W;
  static constexpr int SC = K1 + 4, SY = R + 4, SA = N1 + 8, SZ = D + 8;
  static constexpr int kRaw = K1 * N1 + D * R;
  static constexpr int kFragW = bf16_frags(K1, N1), kFragD = bf16_frags(D, R);
  static constexpr int kFragDt = bf16_frags(R, D), kFragWt = bf16_frags(N1, 2 * R);
  static constexpr int kFwdBuf = TM * SC;
  static constexpr int kBwdBuf = TM * (SC + SY);
  static constexpr int kFwdSmem = 8 * (kFragW + kFragD) + 4 * 2 * kFwdBuf;
  static constexpr int kBwdSmem = 8 * (kFragW + kFragDt + kFragWt) +
                                  4 * (2 * kBwdBuf + TM * SA + TM * SZ);
  static_assert(W % 8 == 0 && W <= 32, "widths 8, 16, 32");
  static_assert(kRaw <= kFwdBuf && kRaw <= kBwdBuf, "raw weights");
  static_assert(NW * (N1 + R) <= TM * SA, "column sums");
  static_assert(kFwdSmem <= 232448 && kBwdSmem <= 232448, "shared memory");
};

template <typename P>
constexpr bool kIsBf16 = std::is_same_v<P, Bf16>;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// w | wd raw into raw, by cp.async (every thread).
template <class C>
__device__ __forceinline__ void load_raw(float* raw, const float* w,
                                         const float* wd) {
  constexpr int C1 = C::K1 * C::N1 / 4, C2 = C::D * C::R / 4;
  for (int i = threadIdx.x; i < C1 + C2; i += NT)
    cp_async16(raw + 4 * i, i < C1 ? w + 4 * i : wd + 4 * (i - C1), true);
}

// The raw weights as {hi, lo} planes: w [K1][SWF], wd [D][SWD].
template <class C>
__device__ __forceinline__ void split_planes(uint2* pw, uint2* pd,
                                             const float* raw) {
  for (int i = threadIdx.x; i < C::kRaw; i += NT) {
    uint32_t h, l;
    tf32_split(raw[i], h, l);
    if (i < C::K1 * C::N1) {
      pw[(i / C::N1) * C::SWF + i % C::N1] = make_uint2(h, l);
    } else {
      const int e = i - C::K1 * C::N1;
      pd[(e / C::R) * C::SWD + e % C::R] = make_uint2(h, l);
    }
  }
}

// The B fragment of B = M (k-step k0, n-tile n0) from M's plane of row
// stride S: {hi(b0), hi(b1), lo(b0), lo(b1)}.
template <int S>
__device__ __forceinline__ uint4 bplane(const uint2* m, int k0, int n0,
                                        int lane) {
  const int g = lane >> 2, q = lane & 3;
  const uint2 u = m[(k0 + q) * S + n0 + g], v = m[(k0 + q + 4) * S + n0 + g];
  return make_uint4(u.x, v.x, u.y, v.y);
}

// The B fragment of B = M^T.
template <int S>
__device__ __forceinline__ uint4 bplane_t(const uint2* m, int k0, int n0,
                                          int lane) {
  const int g = lane >> 2, q = lane & 3;
  const uint2 u = m[(n0 + g) * S + k0 + q], v = m[(n0 + g) * S + k0 + q + 4];
  return make_uint4(u.x, v.x, u.y, v.y);
}

// A warp's 16 rows of a tile's taps by cp.async: x(t) into columns R..,
// x(t - d) into columns 0.. (zeros for t < d and past T).
template <class C>
__device__ __forceinline__ void load_taps(float* tile, const float* x,
                                          size_t base, int t0, int T, int d,
                                          int wp, int lane) {
  constexpr int CH = C::R / 4;
  for (int k = lane; k < 16 * 2 * CH; k += 32) {
    const int r = 16 * wp + k / (2 * CH), c = k % (2 * CH), t = t0 + r;
    const int ts = c < CH ? t - d : t;
    const bool ok = t < T && ts >= 0;
    const int cc = c < CH ? c : c - CH;
    cp_async16(tile + r * C::SC + 4 * c,
               ok ? x + (base + ts) * C::R + 4 * cc : x, ok);
  }
}

// A warp's 16 rows of a [B, T, R] array into a tile of row stride S by
// cp.async, zeros past T.
template <int R, int S>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          size_t base, int t0, int T, int wp,
                                          int lane) {
  constexpr int CH = R / 4;
  for (int k = lane; k < 16 * CH; k += 32) {
    const int r = 16 * wp + k / CH, c = k % CH, t = t0 + r;
    const bool ok = t < T;
    cp_async16(tile + r * S + 4 * c, ok ? src + (base + t) * R + 4 * c : src,
               ok);
  }
}

// fg = [x(t - d) | x(t)] @ w for the warp's rows of a tap tile (no add).
template <class C>
__device__ __forceinline__ void fg_product(float (&acc)[C::N1 / 8][4],
                                           const float* tap, const uint2* pw,
                                           int wp, int lane) {
  constexpr int NF = C::N1 / 8;
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < C::K1 / 8; ++ks) {
    Tf32Frag af;
    afrag<C::SC>(tap, 16 * wp, 8 * ks, lane, af);
    uint4 bw[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) bw[j] = bplane<C::SWF>(pw, 8 * ks, 8 * j, lane);
    mma3_tf32_n(acc, af.hi, af.lo, bw);
  }
}

// The same product in the bf16 mode, from w's fragments.
template <class C>
__device__ __forceinline__ void fg_product_bf16(float (&acc)[C::N1 / 8][4],
                                                const float* tap,
                                                const uint2* fw, int wp,
                                                int lane) {
  constexpr int NF = C::N1 / 8;
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < C::K1 / 16; ++ks) {
    const float* a0 = tap + 16 * wp * C::SC + 16 * ks;
    Bf16Frag af;
    afrag16<C::SC>(a0, a0 + 8, lane, af);
    uint2 bw[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) bw[j] = fw[(ks * NF + j) * 32 + lane];
    mma_bf16_n(acc, af, bw);
  }
}

// The A fragment of k-step ks (16) of a warp's accumulator tiles c (8
// columns each): tiles 2ks and 2ks + 1, the latter zeros where the product
// has only NQ = 1 tile (width 8).
template <int NQ>
__device__ __forceinline__ void acc_afrag16(const float (&c)[NQ][4], int ks,
                                            Bf16Frag& a) {
  a.v[0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
  a.v[1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
  if constexpr (NQ > 1) {
    a.v[2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a.v[3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  } else {
    a.v[2] = a.v[3] = 0u;
  }
}

// ---------------------------------------------------------------------------
// Forward: grid (nchunk, B); block c of row b walks tiles c * tpc, ... of
// row b; each warp its own rows of each tile.
// ---------------------------------------------------------------------------

template <typename P, int W>
__global__ void __launch_bounds__(NT, 2) layer_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ add,
    const float* __restrict__ bd, float* __restrict__ y,
    float* __restrict__ z, int T, int d, int tiles_per_chunk) {
  using C = Cfg<P, W>;
  constexpr bool kBF = kIsBf16<P>;
  constexpr int R = C::R, D = C::D, N1 = C::N1, SC = C::SC;
  constexpr int NF = N1 / 8, NQ = D / 8, NR = R / 8;
  static_assert(R == D, "y and z rows leave together");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // w and wd: f32 planes [K1][SWF] and [D][SWD]; bf16 fragments.
  uint2* s_pw = reinterpret_cast<uint2*>(smem_raw);
  uint2* s_pd;
  float* s_tap;                                       // 2 x [TM][SC]
  if constexpr (kBF) {
    s_pd = s_pw + C::kFragW;
    s_tap = reinterpret_cast<float*>(s_pd + C::kFragD);
  } else {
    s_pd = s_pw + C::K1 * C::SWF;
    s_tap = reinterpret_cast<float*>(s_pd + D * C::SWD);
  }

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, j0 = blockIdx.x * tiles_per_chunk;
  const size_t base = (size_t)b * T;
  const int ntiles = (T + TM - 1) / TM;
  const int n = ntiles - j0 < tiles_per_chunk ? ntiles - j0 : tiles_per_chunk;
  const float* add_b = add + (size_t)b * N1;

  // The raw weights go through the second buffer before its first tile.
  load_raw<C>(s_tap + C::kFwdBuf, w, wd);
  load_taps<C>(s_tap, x, base, j0 * TM, T, d, wp, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kBF) {
    const float* raw = s_tap + C::kFwdBuf;
    pack_bf16_frags<NT, C::K1, N1>(
        s_pw, [&](int k, int n) { return raw[k * N1 + n]; });
    pack_bf16_frags<NT, D, R>(
        s_pd, [&](int k, int n) { return raw[C::K1 * N1 + k * R + n]; });
  } else {
    split_planes<C>(s_pw, s_pd, s_tap + C::kFwdBuf);
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int t0 = (j0 + i) * TM;
    if (i + 1 < n)
      load_taps<C>(s_tap + ((i + 1) & 1) * C::kFwdBuf, x, base, t0 + TM, T, d,
                   wp, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();   // the warp's rows of this tile have landed
    float* tap = s_tap + (i & 1) * C::kFwdBuf;

    float acc[NF][4];
    if constexpr (kBF) fg_product_bf16<C>(acc, tap, s_pw, wp, lane);
    else fg_product<C>(acc, tap, s_pw, wp, lane);
    float zr[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = 8 * j + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = col + (e & 1);
        zr[j][e] = tanhf(acc[j][e] + add_b[cc]) *
                   sigmoidf(acc[NQ + j][e] + add_b[D + cc]);
      }
    }
    // z @ wd, z from the registers.
    float acc2[NR][4];
    zero(acc2);
    if constexpr (kBF) {
#pragma unroll
      for (int ks = 0; ks < (NQ + 1) / 2; ++ks) {
        Bf16Frag af;
        acc_afrag16(zr, ks, af);
        uint2 bw[NR];
#pragma unroll
        for (int j = 0; j < NR; ++j) bw[j] = s_pd[(ks * NR + j) * 32 + lane];
        mma_bf16_n(acc2, af, bw);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < NQ; ++ks) {
        Tf32Frag af;
        acc_afrag(zr[ks], lane, af);
        uint4 bw[NR];
#pragma unroll
        for (int j = 0; j < NR; ++j) bw[j] = bplane<C::SWD>(s_pd, 8 * ks, 8 * j, lane);
        mma3_tf32_n(acc2, af.hi, af.lo, bw);
      }
    }
    // y = x + (z @ wd + bd) (bf16: (bf16(x) + z @ wd) + bd) over x(t), z
    // over x(t - d): the warp's rows.
    __syncwarp();   // every lane's fragment reads of the rows are done
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int col = 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = tap + (16 * wp + g + 8 * h) * SC;
        float2* xp = reinterpret_cast<float2*>(row + R + col);
        const float2 v = *xp;
        if constexpr (kBF)
          *xp = make_float2((bf16_round(v.x) + acc2[j][2 * h]) + bd[col],
                            (bf16_round(v.y) + acc2[j][2 * h + 1]) + bd[col + 1]);
        else
          *xp = make_float2(v.x + (acc2[j][2 * h] + bd[col]),
                            v.y + (acc2[j][2 * h + 1] + bd[col + 1]));
        *reinterpret_cast<float2*>(row + col) =
            make_float2(zr[j][2 * h], zr[j][2 * h + 1]);
      }
    }
    __syncwarp();
    for (int k = lane; k < 16 * (R / 4); k += 32) {
      const int r = 16 * wp + k / (R / 4), c = k % (R / 4), t = t0 + r;
      if (t < T) {
        const float* row = tap + r * SC;
        *reinterpret_cast<float4*>(y + (base + t) * R + 4 * c) =
            *reinterpret_cast<const float4*>(row + R + 4 * c);
        *reinterpret_cast<float4*>(z + (base + t) * D + 4 * c) =
            *reinterpret_cast<const float4*>(row + 4 * c);
      }
    }
    __syncwarp();   // the rows are free for the tile after next
  }
}

// ---------------------------------------------------------------------------
// Backward: grid (nchunk, B); block c of row b walks tiles c * tpc, ... of
// row b and writes its partial sums of dw, dwd, dbd and dadd once.
// ---------------------------------------------------------------------------

template <typename P, int W>
__global__ void __launch_bounds__(NT, 1) layer_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ add,
    const float* __restrict__ dy, const float* __restrict__ dz,
    float* __restrict__ dx_local, float* __restrict__ dpast,
    float* __restrict__ part_w, float* __restrict__ part_a,
    float* __restrict__ part_add, int T, int d, int tiles_per_chunk,
    int nchunk) {
  using C = Cfg<P, W>;
  constexpr bool kBF = kIsBf16<P>;
  constexpr int R = C::R, D = C::D, K1 = C::K1, N1 = C::N1;
  constexpr int SC = C::SC, SY = C::SY, SA = C::SA, SZ = C::SZ;
  constexpr int NF = N1 / 8, NQ = D / 8, NR = R / 8;
  constexpr int KS = kBF ? 16 : 8;   // rows of a weight-gradient k-step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // f32: w [K1][SWF] and wd [D][SWD] planes; bf16: the fragments of w, of
  // wd^T (s_pd) and of [w[1]^T | w[0]^T] (s_pt).
  uint2* s_pw = reinterpret_cast<uint2*>(smem_raw);
  uint2 *s_pd, *s_pt;
  float* s_buf;
  if constexpr (kBF) {
    s_pd = s_pw + C::kFragW;
    s_pt = s_pd + C::kFragDt;
    s_buf = reinterpret_cast<float*>(s_pt + C::kFragWt);
  } else {
    s_pd = s_pw + K1 * C::SWF;
    s_pt = nullptr;
    s_buf = reinterpret_cast<float*>(s_pd + D * C::SWD);
  }
  // 2 x {taps [TM][SC], dy [TM][SY]}, then da [TM][SA] and z [TM][SZ].
  float* s_da = s_buf + 2 * C::kBwdBuf;
  float* s_z = s_da + TM * SA;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int chunk = blockIdx.x, b = blockIdx.y, j0 = chunk * tiles_per_chunk;
  const size_t base = (size_t)b * T;
  const int ntiles = (T + TM - 1) / TM;
  const int n = ntiles - j0 < tiles_per_chunk ? ntiles - j0 : tiles_per_chunk;
  const float* add_b = add + (size_t)b * N1;

  // The weight-gradient tiles of a warp. dw [K1][N1]: m-tile mw, n-tiles
  // nw0 .. nw0 + NJ - 1; warps < kFw. dwd [D][R]: m-tile mv (z channels,
  // masked to D at width 8), n-tile nv; warps < kVw.
  constexpr int NFN = N1 / 8, kFt = (K1 / 16) * NFN;
  constexpr int NJ = kFt >= NW ? kFt / NW : 1, kFw = kFt / NJ;
  constexpr int NVN = R / 8, kVw = ((D + 15) / 16) * NVN;
  static_assert(kFw <= NW && kVw <= NW && NFN % NJ == 0, "gradient tiles");
  const int mw = wp * NJ / NFN, nw0 = wp * NJ % NFN;
  const int mv = wp / NVN, nv = wp % NVN;
  float p_w[NJ][4], p_wd[1][4];
  zero(p_w);
  zero(p_wd);
  // Column sums of the lane's rows: dadd (da) and dbd (dy).
  float c_add[NF][2], c_bd[NR][2];
#pragma unroll
  for (int j = 0; j < NF; ++j) c_add[j][0] = c_add[j][1] = 0.f;
#pragma unroll
  for (int j = 0; j < NR; ++j) c_bd[j][0] = c_bd[j][1] = 0.f;

  // The raw weights go through the second buffer before its first tile.
  load_raw<C>(s_buf + C::kBwdBuf, w, wd);
  load_taps<C>(s_buf, x, base, j0 * TM, T, d, wp, lane);
  load_rows<R, SY>(s_buf + TM * SC, dy, base, j0 * TM, T, wp, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kBF) {
    const float* raw = s_buf + C::kBwdBuf;
    const float* rawd = raw + K1 * N1;   // wd [D][R]
    pack_bf16_frags<NT, K1, N1>(
        s_pw, [&](int k, int n) { return raw[k * N1 + n]; });
    pack_bf16_frags<NT, R, D>(
        s_pd, [&](int k, int n) { return rawd[n * R + k]; });
    // Output column n < R is w row R + n, n >= R w row n - R.
    pack_bf16_frags<NT, N1, 2 * R>(s_pt, [&](int k, int n) {
      return raw[(n < R ? R + n : n - R) * N1 + k];
    });
  } else {
    split_planes<C>(s_pw, s_pd, s_buf + C::kBwdBuf);
  }

  for (int i = 0; i < n; ++i) {
    const int t0 = (j0 + i) * TM;
    cp_async_wait<0>();
    __syncthreads();   // this tile has landed; the last one's reads are done
    if (i + 1 < n) {
      float* nxt = s_buf + ((i + 1) & 1) * C::kBwdBuf;
      load_taps<C>(nxt, x, base, t0 + TM, T, d, wp, lane);
      load_rows<R, SY>(nxt + TM * SC, dy, base, t0 + TM, T, wp, lane);
    }
    cp_async_commit();
    const float* tap = s_buf + (i & 1) * C::kBwdBuf;
    const float* dyt = tap + TM * SC;

    // dz at the lane's accumulator positions, loaded under the products.
    float2 dzv[NQ][2];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * wp + g + 8 * h;
        dzv[j][h] = t < T ? __ldg(reinterpret_cast<const float2*>(
                                dz + (base + t) * D + 8 * j + 2 * q))
                          : make_float2(0.f, 0.f);
        if constexpr (kBF)
          dzv[j][h] = make_float2(bf16_round(dzv[j][h].x),
                                  bf16_round(dzv[j][h].y));
      }
    float acc[NF][4];
    if constexpr (kBF) fg_product_bf16<C>(acc, tap, s_pw, wp, lane);
    else fg_product<C>(acc, tap, s_pw, wp, lane);
    // dy @ wd^T
    float acc2[NQ][4];
    zero(acc2);
    if constexpr (kBF) {
#pragma unroll
      for (int ks = 0; ks < (R + 15) / 16; ++ks) {
        const float* a0 = dyt + 16 * wp * SY + 16 * ks;
        Bf16Frag af;
        afrag16<SY, (R >= 16)>(a0, a0 + 8, lane, af);
        uint2 bw[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) bw[j] = s_pd[(ks * NQ + j) * 32 + lane];
        mma_bf16_n(acc2, af, bw);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < R / 8; ++ks) {
        Tf32Frag af;
        afrag<SY>(dyt, 16 * wp, 8 * ks, lane, af);
        uint4 bw[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) bw[j] = bplane_t<C::SWD>(s_pd, 8 * ks, 8 * j, lane);
        mma3_tf32_n(acc2, af.hi, af.lo, bw);
      }
    }
    // z, and da = dz_tot * (d z / d fg). Rows past T have dy = dz = 0, so
    // da = 0 there.
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wp + g + 8 * h;
        float zz[2], df[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float th = tanhf(acc[j][2 * h + e] + add_b[col + e]);
          const float sg = sigmoidf(acc[NQ + j][2 * h + e] + add_b[D + col + e]);
          const float dzt = (e ? dzv[j][h].y : dzv[j][h].x) + acc2[j][2 * h + e];
          zz[e] = th * sg;
          df[e] = dzt * sg * (1.f - th * th);
          dg[e] = dzt * th * sg * (1.f - sg);
          c_add[j][e] += df[e];
          c_add[NQ + j][e] += dg[e];
        }
        *reinterpret_cast<float2*>(s_z + r * SZ + col) = make_float2(zz[0], zz[1]);
        *reinterpret_cast<float2*>(s_da + r * SA + col) = make_float2(df[0], df[1]);
        *reinterpret_cast<float2*>(s_da + r * SA + D + col) =
            make_float2(dg[0], dg[1]);
      }
    }
    __syncwarp();
    // [dx_local - dy | dpast] = da @ [w[1]^T | w[0]^T]: output column n < R
    // is w row R + n, n >= R w row n - R.
    {
      float acc3[2 * NR][4];
      zero(acc3);
      if constexpr (kBF) {
#pragma unroll
        for (int ks = 0; ks < N1 / 16; ++ks) {
          const float* a0 = s_da + 16 * wp * SA + 16 * ks;
          Bf16Frag af;
          afrag16<SA>(a0, a0 + 8, lane, af);
          uint2 bw[2 * NR];
#pragma unroll
          for (int j = 0; j < 2 * NR; ++j)
            bw[j] = s_pt[(ks * 2 * NR + j) * 32 + lane];
          mma_bf16_n(acc3, af, bw);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < N1 / 8; ++ks) {
          Tf32Frag af;
          afrag<SA>(s_da, 16 * wp, 8 * ks, lane, af);
          uint4 bw[2 * NR];
#pragma unroll
          for (int j = 0; j < 2 * NR; ++j)
            bw[j] = bplane_t<C::SWF>(s_pw, 8 * ks, j < NR ? R + 8 * j : 8 * j - R,
                                     lane);
          mma3_tf32_n(acc3, af.hi, af.lo, bw);
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int col = 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wp + g + 8 * h, t = t0 + r;
          float2 v = *reinterpret_cast<const float2*>(dyt + r * SY + col);
          if constexpr (kBF) v = make_float2(bf16_round(v.x), bf16_round(v.y));
          c_bd[j][0] += v.x;
          c_bd[j][1] += v.y;
          if (t < T) {
            const size_t o = (base + t) * R + col;
            *reinterpret_cast<float2*>(dx_local + o) =
                make_float2(v.x + acc3[j][2 * h], v.y + acc3[j][2 * h + 1]);
            *reinterpret_cast<float2*>(dpast + o) =
                make_float2(acc3[NR + j][2 * h], acc3[NR + j][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();   // z and da of every row

    // dw += [x(t - d) | x(t)]^T @ da and dwd += z^T @ dy over the tile's
    // rows.
    if (wp < kFw) {
#pragma unroll 4
      for (int ks = 0; ks < TM / KS; ++ks) {
        if constexpr (kBF) {
          Bf16Frag af;
          afrag16_t<SC, K1>(tap, 16 * mw, 16 * ks, lane, af);
          uint2 bw[NJ];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            bfrag16<SA>(s_da, 16 * ks, 8 * (nw0 + jj), lane, bw[jj]);
          mma_bf16_step_rn(p_w, af, bw);
        } else {
          Tf32Frag af;
          afrag_t<SC>(tap, 16 * mw, 8 * ks, lane, af);
          uint4 bw[NJ];
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) bfrag<SA>(s_da, 8 * ks, 8 * (nw0 + jj), lane, bw[jj]);
          mma3_step_rn(p_w, af, bw);
        }
      }
    }
    if (wp < kVw) {
#pragma unroll 4
      for (int ks = 0; ks < TM / KS; ++ks) {
        if constexpr (kBF) {
          Bf16Frag af;
          afrag16_t<SZ, D>(s_z, 16 * mv, 16 * ks, lane, af);
          uint2 bw[1];
          bfrag16<SY>(dyt, 16 * ks, 8 * nv, lane, bw[0]);
          mma_bf16_step_rn(p_wd, af, bw);
        } else {
          Tf32Frag af;
          afrag_tm<SZ, D>(s_z, 16 * mv, 8 * ks, lane, af);
          uint4 bw[1];
          bfrag<SY>(dyt, 8 * ks, 8 * nv, lane, bw[0]);
          mma3_step_rn(p_wd, af, bw);
        }
      }
    }
  }

  // This block's partial sums, in reduce_partials_kernel's layout with one
  // layer. The column sums: the lanes' rows by a fixed tree over g, then
  // the warps in order.
  const size_t cta = (size_t)b * nchunk + chunk;
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c_add[j][e] += __shfl_xor_sync(0xffffffffu, c_add[j][e], s);
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c_bd[j][e] += __shfl_xor_sync(0xffffffffu, c_bd[j][e], s);
  }
  __syncthreads();   // the last tile's reads of da are done
  float* s_col = s_da;   // [NW][N1 + R]
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) s_col[wp * (N1 + R) + 8 * j + 2 * q + e] = c_add[j][e];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s_col[wp * (N1 + R) + N1 + 8 * j + 2 * q + e] = c_bd[j][e];
  }
  float* pa = part_a + cta * (D * R + R);
  if (wp < kFw) {
    float* pw = part_w + cta * (K1 * N1);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(pw + (16 * mw + g + 8 * h) * N1 +
                                   8 * (nw0 + jj) + 2 * q) =
            make_float2(p_w[jj][2 * h], p_w[jj][2 * h + 1]);
  }
  if (wp < kVw) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mv + g + 8 * h;
      if (row < D)
        *reinterpret_cast<float2*>(pa + row * R + 8 * nv + 2 * q) =
            make_float2(p_wd[0][2 * h], p_wd[0][2 * h + 1]);
    }
  }
  __syncthreads();
  if (tid < N1 + R) {
    float s = 0.f;
    for (int k = 0; k < NW; ++k) s += s_col[k * (N1 + R) + tid];
    if (tid < N1) part_add[cta * N1 + tid] = s;
    else pa[D * R + tid - N1] = s;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The kernel of a direction at width W = R = D, with its shared memory set.
template <typename P, int W>
cudaError_t prepare(int backward, const void** fn, int* smem) {
  if (backward) {
    *fn = (const void*)layer_bwd_kernel<P, W>;
    *smem = Cfg<P, W>::kBwdSmem;
  } else {
    *fn = (const void*)layer_fwd_kernel<P, W>;
    *smem = Cfg<P, W>::kFwdSmem;
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <typename P>
cudaError_t prepare_width(int backward, int R, const void** fn, int* smem) {
  if (R == 32) return prepare<P, 32>(backward, fn, smem);
  if (R == 16) return prepare<P, 16>(backward, fn, smem);
  return prepare<P, 8>(backward, fn, smem);
}

// Blocks of a direction's kernel that one SM keeps resident, found (and
// the kernel's shared memory set) once a device, mode, direction and
// width.
constexpr int kMaxDevices = 64;
int g_per_sm[kMaxDevices][2][2][3];   // 0: not found yet

cudaError_t blocks_per_sm(int backward, int R, int bf16, int* per) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* known = dev < kMaxDevices
                   ? &g_per_sm[dev][bf16 != 0][backward]
                              [R == 32 ? 2 : R == 16 ? 1 : 0]
                   : nullptr;
  if (known && *known > 0) {
    *per = *known;
    return cudaSuccess;
  }
  const void* fn;
  int smem;
  e = bf16 ? prepare_width<Bf16>(backward, R, &fn, &smem)
           : prepare_width<Tf32x3>(backward, R, &fn, &smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per, fn, NT, smem);
  if (e == cudaSuccess && *per < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess && known) *known = *per;
  return e;
}

// The grid of a direction: chunks of tiles a row, so that every block runs
// in the first wave (layer_tiling in experiments/dilated_layer.py).
cudaError_t layer_tiling(int backward, int B, int T, int R, int bf16,
                         Tiling* tl) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  int per = 0;
  const cudaError_t e = blocks_per_sm(backward, R, bf16, &per);
  if (e == cudaSuccess) *tl = chunk_tiling(B, T, TM, per);
  return e;
}

template <typename P, int W>
int forward_impl(const float* x, const float* w, const float* wd,
                 const float* add, const float* bd, float* y, float* z, int B,
                 int T, int d, cudaStream_t st) {
  Tiling tl;
  cudaError_t e = layer_tiling(0, B, T, W, kIsBf16<P>, &tl);
  if (e != cudaSuccess) return (int)e;
  layer_fwd_kernel<P, W>
      <<<dim3(tl.nchunk, B), NT, Cfg<P, W>::kFwdSmem, st>>>(
          x, w, wd, add, bd, y, z, T, d, tl.tiles_per_chunk);
  return (int)cudaGetLastError();
}

template <typename P, int W>
int backward_impl(const float* x, const float* w, const float* wd,
                  const float* add, const float* dy, const float* dz,
                  float* dx_local, float* dpast, float* dw, float* dwd,
                  float* dadd, float* dbd, float* scratch, int B, int T,
                  int d, cudaStream_t st) {
  constexpr int R = W, D = W;
  Tiling tl;
  cudaError_t e = layer_tiling(1, B, T, W, kIsBf16<P>, &tl);
  if (e != cudaSuccess) return (int)e;
  const size_t ncta = (size_t)B * tl.nchunk;
  float* pw = scratch;                              // [ncta, 2R, 2D]
  float* pa = pw + ncta * 4 * R * D;                // [ncta, D*R + R]
  float* padd = pa + ncta * (D * R + R);            // [ncta, 2D]
  layer_bwd_kernel<P, W>
      <<<dim3(tl.nchunk, B), NT, Cfg<P, W>::kBwdSmem, st>>>(
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

// Blocks of the forward (backward = 0) or backward (1) kernel at width
// R = D in the f32 (bf16 = 0) or bf16 (1) mode that the device keeps
// resident at once (blocks an SM x SMs); a negative CUDA error code on
// failure, -kUnsupportedWidth at a width not built.
int dilated_layer_resident_blocks(int backward, int R, int D, int bf16) {
  if (!dilated_layer_supports_width(R, D)) return -kUnsupportedWidth;
  int per = 0, dev = 0, sms = 0;
  cudaError_t e = blocks_per_sm(backward, R, bf16, &per);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? per * sms : -(int)e;
}

// The library's own grid: chunks a batch row (nchunk) of a direction's
// grid (nchunk, B) in a mode on this device; the rule of layer_tiling.
int dilated_layer_nchunk(int backward, int B, int T, int R, int D,
                         int bf16) {
  if (!dilated_layer_supports_width(R, D)) return -kUnsupportedWidth;
  Tiling tl;
  const cudaError_t e = layer_tiling(backward, B, T, R, bf16, &tl);
  return e == cudaSuccess ? tl.nchunk : -(int)e;
}

// Floats of scratch device memory the backward of a mode needs (negative
// on failure, as dilated_layer_nchunk).
long long dilated_layer_bwd_scratch_floats(int B, int T, int R, int D,
                                           int bf16) {
  const int nchunk = dilated_layer_nchunk(1, B, T, R, D, bf16);
  if (nchunk < 0) return nchunk;
  return (long long)B * nchunk * (4LL * R * D + D * R + R + 2 * D);
}

// Forward (one launch). x [B,T,R]; w [2,R,2D]; wd [D,R]; add [B,2D]; bd
// [1,R]; outputs y [B,T,R], z [B,T,D]; x, w and wd 16-byte aligned.
// Returns 0 or a CUDA error code.
int dilated_layer_fwd_f32(const float* x, const float* w, const float* wd,
                          const float* add, const float* bd, float* y,
                          float* z, int B, int T, int R, int D, int dilation,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dilated_layer_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &forward_impl<Tf32x3, 32>
          : R == 16 ? &forward_impl<Tf32x3, 16> : &forward_impl<Tf32x3, 8>;
  return f(x, w, wd, add, bd, y, z, B, T, dilation, st);
}

// The bf16 mode: the arguments of dilated_layer_fwd_f32 (every array
// float32; x, w and wd rounded to bf16 in the kernel).
int dilated_layer_fwd_bf16(const float* x, const float* w, const float* wd,
                           const float* add, const float* bd, float* y,
                           float* z, int B, int T, int R, int D, int dilation,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dilated_layer_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &forward_impl<Bf16, 32>
          : R == 16 ? &forward_impl<Bf16, 16> : &forward_impl<Bf16, 8>;
  return f(x, w, wd, add, bd, y, z, B, T, dilation, st);
}

// Backward (the kernel, then the fixed-order reduction). Inputs as the
// forward's (no bd) plus dy [B,T,R] (16-byte aligned) and dz [B,T,D];
// outputs dx_local, dpast [B,T,R], dw [2,R,2D], dwd [D,R], dadd [B,2D],
// dbd [1,R]; scratch as sized by dilated_layer_bwd_scratch_floats.
// Returns 0 or a CUDA error code.
int dilated_layer_bwd_f32(const float* x, const float* w, const float* wd,
                          const float* add, const float* dy, const float* dz,
                          float* dx_local, float* dpast, float* dw,
                          float* dwd, float* dadd, float* dbd, float* scratch,
                          int B, int T, int R, int D, int dilation,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dilated_layer_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &backward_impl<Tf32x3, 32>
          : R == 16 ? &backward_impl<Tf32x3, 16> : &backward_impl<Tf32x3, 8>;
  return f(x, w, wd, add, dy, dz, dx_local, dpast, dw, dwd, dadd, dbd,
           scratch, B, T, dilation, st);
}

// The bf16 mode: the arguments of dilated_layer_bwd_f32 (dy and dz float32,
// rounded to bf16 in the kernel; every output float32; scratch as sized
// for the bf16 mode).
int dilated_layer_bwd_bf16(const float* x, const float* w, const float* wd,
                           const float* add, const float* dy, const float* dz,
                           float* dx_local, float* dpast, float* dw,
                           float* dwd, float* dadd, float* dbd,
                           float* scratch, int B, int T, int R, int D,
                           int dilation, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!dilated_layer_supports_width(R, D)) return kUnsupportedWidth;
  auto* f = R == 32 ? &backward_impl<Bf16, 32>
          : R == 16 ? &backward_impl<Bf16, 16> : &backward_impl<Bf16, 8>;
  return f(x, w, wd, add, dy, dz, dx_local, dpast, dw, dwd, dadd, dbd,
           scratch, B, T, dilation, st);
}

}  // extern "C"
