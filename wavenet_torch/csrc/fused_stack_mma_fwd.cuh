// The forward of fused_stack_mma (one launch a layer on the tensor cores,
// 3xTF32 or bf16 mma.sync, at R = D = 32 and 64), with the layout, modes
// and fragment loaders that its backward shares. fused_stack_mma.cu runs
// it at the full part mask; the r2 probe's tensor-core mode
// (fwd_bisect_mma.cu) at the masks of tools/r2_fwd_bisect.py's variants.
// The design and what bounds it: fused_stack_mma.cu's head comment. Each
// .cu that includes this is its own library, so the definitions sit in an
// anonymous namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "stack_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int TM = 64;                 // rows (time steps of one batch row) a tile
constexpr int NW = 8;                  // warps a block
constexpr int NT = 32 * NW;
// Shared memory a block may opt in to, and an SM's (each resident block
// also takes 1 KB of the SM's), on the H100.
constexpr int kBlockSmem = 232448, kSmSmem = 233472, kBlockReserve = 1024;

// The two modes. KS: the k of one mma.sync; W: a lane's part of a weight
// fragment; WPER: weights a W holds; A: a lane's part of an A fragment;
// Rec: the element of the fg and z records and of the da scratch.
struct Tf32x3 {
  static constexpr bool kBf16 = false;
  static constexpr int KS = 8, WPER = 2;
  using W = uint4;                     // {hi(b0), hi(b1), lo(b0), lo(b1)}
  using A = Tf32Frag;                  // afrag, afrag_t, bfrag: tf32_mma.cuh
  using Rec = float;
};

struct Bf16 {
  static constexpr bool kBf16 = true;
  static constexpr int KS = 16, WPER = 4;
  using W = uint2;                     // {b0, b1}: bf16 pairs along k
  struct A { uint32_t v[4]; };
  using Rec = __nv_bfloat16;
};

// Row stride of a tile N elements wide of T: 16 bytes of padding a row.
template <int N, typename T>
constexpr int padded() { return N + 16 / (int)sizeof(T); }

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The layout of mode P at width R (= D): tile strides, the form of the
// weights in shared memory, each launch's shared memory in bytes
// (16-byte aligned parts), (B)'s stages and the forward's and (A)'s
// blocks an SM.
template <class P, int R_>
struct Cfg {
  static constexpr int R = R_, D = R_;
  static constexpr int K1 = 2 * R, N1 = 2 * D;  // the fg product: [TM, K1] @ [K1, N1]
  using Rec = typename P::Rec;
  static constexpr int SR = padded<R, float>();     // R-wide float tiles (x, z)
  static constexpr int S2D = padded<N1, float>();   // 2D-wide float tiles
  static constexpr int SRec = padded<N1, Rec>();    // fg / da record tiles
  static constexpr int kTR = (int)sizeof(float) * TM * SR;
  static constexpr int kT2D = (int)sizeof(float) * TM * S2D;
  static constexpr int kTRec = (int)sizeof(Rec) * TM * SRec;
  // Forward tiles: 2 stages of (x(t - d), x(t)); the z tile.
  static constexpr int kFwdTiles = 2 * (2 * kTR) + kTR;
  // Weights in the operands' form (f32: split hi/lo; bf16: rounded pairs)
  // where the forward's fit, else as float pairs (f32 only), split as
  // each fragment loads.
  static constexpr bool kSplit =
      (int)sizeof(typename P::W) * (K1 * N1 + D * R) / P::WPER + kFwdTiles <=
      kBlockSmem;
  static_assert(kSplit || !P::kBf16, "bf16 weights always fit");
  using WS = std::conditional_t<kSplit, typename P::W, float2>;
  static constexpr int kWfg = (int)sizeof(WS) * K1 * N1 / P::WPER;
  static constexpr int kWdr = (int)sizeof(WS) * D * R / P::WPER;
  static constexpr int kWb = (int)sizeof(WS) * N1 * R / P::WPER;
  // Forward: w_fg, wd and the tiles.
  static constexpr int kFwd = kWfg + kWdr + kFwdTiles;
  // (A): wd, wd^T; 2 stages of (dx_{l+1}, the fg slice); z; da; and in
  // bf16 the float32 (tanh f, sigmoid g) tile (f32 converts in place).
  static constexpr int kAStage = kTR + kTRec;
  static constexpr int kA =
      2 * kWdr + 2 * kAStage + kTR + kT2D + (P::kBf16 ? kT2D : 0);
  // (B): the two transposed halves of w_fg; stages of (da(t), da(t + d),
  // x(t - d), x(t)), two where they fit, else one.
  static constexpr int kBStage = 2 * kTRec + 2 * kTR;
  static constexpr int kBStages =
      2 * kWb + 2 * kBStage <= kBlockSmem ? 2 : 1;
  static constexpr int kB = 2 * kWb + kBStages * kBStage;
  // Blocks an SM of the forward and (A) (at most 2; (B) holds one).
  static constexpr int kPerSm =
      cmin(2, kSmSmem / (cmax(kFwd, kA) + kBlockReserve));
  static_assert(kFwd <= kBlockSmem && kA <= kBlockSmem &&
                kB <= kBlockSmem && kPerSm >= 1, "shared memory");
  static_assert(kWfg % 16 == 0 && kWdr % 16 == 0 && kWb % 16 == 0 &&
                kTR % 16 == 0 && kT2D % 16 == 0 && kTRec % 16 == 0,
                "16-byte aligned parts");
  static_assert(R % 16 == 0 && R <= 64 && 64 + N1 <= NT, "thread maps");
};

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two adjacent elements as float2, and a float2 stored as two elements.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Weights as B fragments in shared memory, in fragment order. ``at(k, n)``
// reads B from device memory; every load of a thread is issued before the
// first split or rounding.
// f32: for k-step ks (8) and n-tile nt, lane l holds {hi(b0), hi(b1),
// lo(b0), lo(b1)} of B[ks*8 + l%4 (+4)][nt*8 + l/4].
template <int K, int N, typename F>
__device__ __forceinline__ void stage_weights(uint4* dst, F at) {
  constexpr int NTN = N / 8, IT = K * N / 2 / NT;
  static_assert(K * N / 2 == IT * NT, "weight staging");
  float v[IT][2];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int lane = i & 31, nt = (i >> 5) % NTN, ks = (i >> 5) / NTN;
    const int k = ks * 8 + (lane & 3), n = nt * 8 + (lane >> 2);
    v[it][0] = at(k, n);
    v[it][1] = at(k + 4, n);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    uint32_t h0, l0, h1, l1;
    tf32_split(v[it][0], h0, l0);
    tf32_split(v[it][1], h1, l1);
    dst[it * NT + threadIdx.x] = make_uint4(h0, h1, l0, l1);
  }
}

// f32 where the split weights do not fit: the same fragment order, lane l
// holding the float pair {b0, b1}, split as the fragment loads (operand).
template <int K, int N, typename F>
__device__ __forceinline__ void stage_weights(float2* dst, F at) {
  constexpr int NTN = N / 8, IT = K * N / 2 / NT;
  static_assert(K * N / 2 == IT * NT, "weight staging");
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int lane = i & 31, nt = (i >> 5) % NTN, ks = (i >> 5) / NTN;
    const int k = ks * 8 + (lane & 3), n = nt * 8 + (lane >> 2);
    dst[i] = make_float2(at(k, n), at(k + 4, n));
  }
}

// bf16: for k-step ks (16) and n-tile nt, lane l holds {b0, b1} =
// {B[k, k+1][n], B[k+8, k+9][n]}, k = ks*16 + 2 (l%4), n = nt*8 + l/4.
template <int K, int N, typename F>
__device__ __forceinline__ void stage_weights(uint2* dst, F at) {
  constexpr int NTN = N / 8, IT = K * N / 4 / NT;
  static_assert(K * N / 4 == IT * NT, "weight staging");
  float v[IT][4];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int lane = i & 31, nt = (i >> 5) % NTN, ks = (i >> 5) / NTN;
    const int k = ks * 16 + 2 * (lane & 3), n = nt * 8 + (lane >> 2);
    v[it][0] = at(k, n);
    v[it][1] = at(k + 1, n);
    v[it][2] = at(k + 8, n);
    v[it][3] = at(k + 9, n);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it)
    dst[it * NT + threadIdx.x] = make_uint2(pack_bf16(v[it][0], v[it][1]),
                                            pack_bf16(v[it][2], v[it][3]));
}

// A stored weight fragment as the mma operand.
__device__ __forceinline__ uint4 operand(uint4 w) { return w; }
__device__ __forceinline__ uint2 operand(uint2 w) { return w; }
__device__ __forceinline__ uint4 operand(float2 w) {
  uint4 b;
  tf32_split(w.x, b.x, b.z);
  tf32_split(w.y, b.y, b.w);
  return b;
}

template <int NTN, typename WS>
__device__ __forceinline__ auto wfrag(const WS* w, int ks, int nt, int lane) {
  return operand(w[(ks * NTN + nt) * 32 + lane]);
}


// bf16 fragment loaders (the f32 ones are tf32_mma.cuh's): a fragment of
// rows m0.. and columns k0.. of a row-major tile.
template <int S, typename T>
__device__ __forceinline__ void afrag(const T* s, int m0, int k0, int lane,
                                      Bf16::A& a) {
  const int g = lane >> 2, q = lane & 3;
  const T* p = s + (m0 + g) * S + k0 + 2 * q;
  float2 v = load2(p);
  a.v[0] = pack_bf16(v.x, v.y);
  v = load2(p + 8 * S);
  a.v[1] = pack_bf16(v.x, v.y);
  v = load2(p + 8);
  a.v[2] = pack_bf16(v.x, v.y);
  v = load2(p + 8 * S + 8);
  a.v[3] = pack_bf16(v.x, v.y);
}

// bf16: a B fragment of a row-major tile (the pairs along k are two rows).
template <int S, typename T>
__device__ __forceinline__ void bfrag(const T* s, int k0, int n0, int lane,
                                      uint2& b) {
  const int g = lane >> 2, q = lane & 3;
  const T* p = s + (k0 + 2 * q) * S + n0 + g;
  b.x = pack_bf16(tof(p[0]), tof(p[S]));
  b.y = pack_bf16(tof(p[8 * S]), tof(p[9 * S]));
}

// NJ n-tiles that share one A fragment.
template <int NJ>
__device__ __forceinline__ void mma_n(float (&c)[NJ][4], const Tf32x3::A& a,
                                      const uint4 (&b)[NJ]) {
  mma3_tf32_n(c, a.hi, a.lo, b);
}

template <int NJ>
__device__ __forceinline__ void mma_n(float (&c)[NJ][4], const Bf16::A& a,
                                      const uint2 (&b)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(c[j], a.v, b[j].x, b[j].y);
}

__device__ __forceinline__ void zero(float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

// Rows [t0, t0 + rows) shifted by ``shift`` of a [B, T, W] row-major array
// of T elements (row stride ``ld`` elements, column offset ``col``) into a
// [rows][S] tile, zeros outside [0, T).
template <int W, int S, typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* src, size_t base,
                                          size_t ld, int col, int t0,
                                          int shift, int T, int rows = TM) {
  constexpr int PER = 16 / (int)sizeof(E);   // elements a 16-byte chunk
  constexpr int CH = W / PER;                 // chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH, t = t0 + r + shift;
    const bool ok = t >= 0 && t < T;
    cp_async16(dst + r * S + PER * c,
               ok ? src + (base + t) * ld + col + PER * c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// Forward: one layer. grid (chunks, B).
// ---------------------------------------------------------------------------

// kMask: the parts of the layer that run (stack_common.cuh's kFwd*).
// fused_stack_mma.cu runs kFwdFull; the r2 probe (fwd_bisect_mma.cu) the
// other masks, where an ablated tap is a zero that the kernel writes to
// shared memory once, so that the products still run on it. A stage holds
// a tile's rows x(t - d) and x(t): as two streams of TM rows, or
// (kFwdRolled, d < TM) as one stream of the TM + d rows from t0 - d, the
// past of row r at row r and its current at row r + d.
template <class P, int R, unsigned kMask = kFwdFull>
__global__ void __launch_bounds__(NT, (Cfg<P, R>::kPerSm)) fwd_mma_kernel(
    const float* __restrict__ x_in, float* __restrict__ x_out,
    typename P::Rec* __restrict__ fg_out, typename P::Rec* __restrict__ z_out,
    const float* __restrict__ w_fg, const float* __restrict__ wd,
    const float* __restrict__ add, const float* __restrict__ bd, int T,
    int d, int l, int L, int tiles_per_chunk) {
  using C = Cfg<P, R>;
  using W = typename P::W;
  using WS = typename C::WS;
  constexpr int D = R, K1 = C::K1, N1 = C::N1, SR = C::SR;
  constexpr int NQ = D / 16;   // n-tiles of a warp's column half (D or R wide)
  constexpr bool kCat = (kMask & kFwdCat) != 0;
  constexpr bool kShift = (kMask & kFwdShift) != 0;
  constexpr bool kRecords = (kMask & kFwdRecords) != 0;
  constexpr bool kRolled = (kMask & kFwdRolled) != 0;
  static_assert(kCat || !kShift, "the past tap comes with the tile's rows");
  static_assert(kShift || !kRolled, "rolled is a form of the past tap");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WS* s_wfg = reinterpret_cast<WS*>(smem_raw);               // B = w_fg [K1][N1]
  WS* s_wd = reinterpret_cast<WS*>(smem_raw + C::kWfg);      // B = wd [D][R]
  float* s_x = reinterpret_cast<float*>(smem_raw + C::kWfg + C::kWdr);
  constexpr int kStage = 2 * TM * SR;                        // x(t - d), x(t)
  float* s_z = s_x + 2 * kStage;                             // [TM][SR]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = w >> 1, h = w & 1;    // rows 16 mt..; column half h
  const int b = blockIdx.y;
  const size_t base = (size_t)b * T;
  const int tile0 = blockIdx.x * tiles_per_chunk;
  const int ntiles = min(tiles_per_chunk, (T + TM - 1) / TM - tile0);
  // The current rows' first row in a stage.
  const int e = kRolled && d < TM ? d : TM;

  auto issue = [&](int i) {
    float* st = s_x + (i & 1) * kStage;
    const int t0 = (tile0 + i) * TM;
    if (kRolled && d < TM) {
      load_rows<R, SR>(st, x_in, base, R, 0, t0, -d, T, TM + d);
    } else if (kCat) {
      if (kShift) load_rows<R, SR>(st, x_in, base, R, 0, t0, -d, T);
      load_rows<R, SR>(st + TM * SR, x_in, base, R, 0, t0, 0, T);
    }
  };
  if constexpr (!kShift) {
    // Zeros, once: the past rows of both stages, and without kFwdCat the
    // current rows too.
    for (int j = tid; j < (kCat ? TM * SR : kStage); j += NT) {
      s_x[j] = 0.f;
      s_x[kStage + j] = 0.f;
    }
  }
  issue(0);
  cp_async_commit();
  stage_weights<K1, N1>(s_wfg, [&](int k, int n) { return w_fg[k * N1 + n]; });
  stage_weights<D, R>(s_wd, [&](int k, int n) { return wd[k * R + n]; });
  const float* add_b = add + (size_t)b * N1;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile i (and the weights) visible to every warp
    const float* past = s_x + (i & 1) * kStage;
    const float* cur = past + e * SR;
    const int t0 = (tile0 + i) * TM;

    // fg = [past | cur] @ w_fg: this warp's filter n-tiles NQ h .. + NQ - 1
    // and their gate n-tiles D / 8 + NQ h ...
    float acc[2 * NQ][4];
#pragma unroll
    for (int j = 0; j < 2 * NQ; ++j) zero(acc[j]);
#pragma unroll
    for (int ks = 0; ks < K1 / P::KS; ++ks) {
      const int k = ks * P::KS;
      typename P::A a;
      afrag<SR>(k < R ? past : cur, 16 * mt, k % R, lane, a);
      W bw[2 * NQ];
#pragma unroll
      for (int j = 0; j < 2 * NQ; ++j)
        bw[j] = wfrag<N1 / 8>(s_wfg, ks, (j / NQ) * (D / 8) + NQ * h + j % NQ,
                              lane);
      mma_n(acc, a, bw);
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = (D / 2) * h + 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half, t = t0 + r;
        const float f0 = acc[j][2 * half] + add_b[col];
        const float f1 = acc[j][2 * half + 1] + add_b[col + 1];
        const float g0 = acc[j + NQ][2 * half] + add_b[D + col];
        const float g1 = acc[j + NQ][2 * half + 1] + add_b[D + col + 1];
        const float z0 = tanhf(f0) * sigmoidf(g0);
        const float z1 = tanhf(f1) * sigmoidf(g1);
        *reinterpret_cast<float2*>(s_z + r * SR + col) = make_float2(z0, z1);
        if (kRecords && t < T) {
          typename P::Rec* fr =
              fg_out + (base + t) * (size_t)(L * N1) + l * N1 + col;
          store2(fr, f0, f1);
          store2(fr + D, g0, g1);
          store2(z_out + (base + t) * (size_t)(L * D) + l * D + col, z0, z1);
        }
      }
    }
    __syncthreads();   // the z tile is whole

    // x' = x + (z @ wd + bd) (bf16: (x + z @ wd) + bd): n-tiles NQ h ...
    float acc2[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) zero(acc2[j]);
#pragma unroll
    for (int ks = 0; ks < D / P::KS; ++ks) {
      typename P::A a;
      afrag<SR>(s_z, 16 * mt, ks * P::KS, lane, a);
      W bw[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        bw[j] = wfrag<R / 8>(s_wd, ks, NQ * h + j, lane);
      mma_n(acc2, a, bw);
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = (R / 2) * h + 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half, t = t0 + r;
        if (t >= T) continue;
        float2 res;
        if constexpr (kCat)
          res = *reinterpret_cast<const float2*>(cur + r * SR + col);
        else   // the tile is zeros: the residual is x itself
          res = *reinterpret_cast<const float2*>(x_in + (base + t) * R + col);
        const float m0 = acc2[j][2 * half], m1 = acc2[j][2 * half + 1];
        float2 o;
        if constexpr (P::kBf16)
          o = make_float2((res.x + m0) + bd[col], (res.y + m1) + bd[col + 1]);
        else
          o = make_float2(res.x + (m0 + bd[col]), res.y + (m1 + bd[col + 1]));
        *reinterpret_cast<float2*>(x_out + (base + t) * R + col) = o;
      }
    }
    __syncthreads();   // stage i & 1 and the z tile are free again
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// One grid for every launch and both modes: chunks sized for the forward's
// and (A)'s blocks an SM ((B), one an SM, runs it in that many waves).
template <int R>
Tiling mma_tiling(int B, int T) {
  static_assert(Cfg<Tf32x3, R>::kPerSm == Cfg<Bf16, R>::kPerSm,
                "one grid for both modes");
  return chunk_tiling(B, T, TM, Cfg<Tf32x3, R>::kPerSm);
}

// L launches of the layer kernel at part mask kMask.
template <class P, int R, unsigned kMask = kFwdFull>
int forward_impl(const float* x, const float* w_fg, const float* wd,
                 const float* add, const float* bd, const int* dil, float* y,
                 typename P::Rec* fg, typename P::Rec* z, float* xbuf, int B,
                 int T, int L, cudaStream_t st) {
  using C = Cfg<P, R>;
  constexpr int smem = C::kFwd, D = R, K1 = C::K1, N1 = C::N1;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_mma_kernel<P, R, kMask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const Tiling tl = mma_tiling<R>(B, T);
  const dim3 grid(tl.nchunk, B);
  const size_t btr = (size_t)B * T * R;
  for (int l = 0; l < L; ++l) {
    const float* in = l == 0 ? x : xbuf + (size_t)((l - 1) & 1) * btr;
    float* out = l == L - 1 ? y : xbuf + (size_t)(l & 1) * btr;
    fwd_mma_kernel<P, R, kMask><<<grid, NT, smem, st>>>(in, out, fg, z, w_fg + (size_t)l * K1 * N1, wd + (size_t)l * D * R, add + (size_t)l * B * N1, bd + (size_t)l * R, T, dil[l], l, L, tl.tiles_per_chunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace
