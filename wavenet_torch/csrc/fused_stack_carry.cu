// fused_stack_carry: the whole dilated stack of a training step in one
// launch forward and one backward (plus a reduction), a wavefront across
// each batch row's time tiles on the tensor cores, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU (Pallas) kernels of the JAX package's retired stack
// generations:
//   wavenet_tpu/experiments/fused_stack.py:69    _fwd_kernel  (v1)
//   wavenet_tpu/experiments/fused_stack.py:170   _bwd_kernel  (v1)
//   wavenet_tpu/experiments/fused_stack2.py:85   _fwd_kernel  (v2)
//   wavenet_tpu/experiments/fused_stack2.py:200  _bwd_kernel  (v2)
// The two generations compute one map; they differ in TPU layout (v2
// packs v1's two K=R tap matmuls into one K=2R matmul, which is the same
// arithmetic here, and emits z from the kernel). So one source serves
// both: the forward writes z only when it is given a z buffer (v2), and
// the backward is shared. Per layer l with dilation d, over all rows:
//
//   fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   x' = x + (z @ wd[l] + bd[l])
//
// Design. The TPU grid runs time tiles in order, so its kernels carry each
// layer's dilated-tap tail from one tile to the next instead of reading a
// halo. Here that carry is a per-row ring in device memory (L2-resident)
// for each layer: slot p mod d holds the layer's input at position p for
// the last d positions, so a tile may be shorter than d, and a zero ring at
// t = 0 is exactly causal padding (sum(dilations) * R * 4 bytes a row, 393
// KB at the gc config). Each tile of TM = 128 steps runs all L layers with
// its residual in shared memory, so the residual never goes to device
// memory between layers. The backward rebuilds each layer's input by
// subtraction from y, as the TPU kernels do; its ring holds da rows
// [sum_d, 2D]: x_l(p - d), the past-tap partner of da(p), lies in an
// earlier tile, which the reverse walk reaches later; that tile reads
// da(p) from the ring and forms there both the past-tap term of dx and the
// past-tap weight gradient (the TPU kernels keep the first in a second
// carry, of tap-gradient rows).
// - A wavefront across time tiles. The grid is (nchunk, B): block c of
//   row b walks the row's tiles c, c + nchunk, ... in order (the backward
//   from the last tile, layers in reverse). Before a tile reads layer l's
//   ring it waits until row b's progress counter for layer l shows every
//   ring writer of the tiles before it (one thread spins on an acquire
//   load); each warp that writes ring rows publishes them (a fence, then
//   a release add). So tile j + 1 writes layer l's ring only after tile j
//   has read it, and each ring stays as the sequential walk leaves it. A
//   tile waits only on the tile before it, whose block is resident:
//   nchunk = max(1, resident blocks / B) (carry_plan), and a grid of
//   nchunk > 1 launches cooperatively, which refuses one that cannot be
//   resident at once (B alone filling the card: one block a row, no
//   waits, an ordinary launch).
// - The tensor cores. Every product runs as 3xTF32 mma.sync m16n8k8
//   (tf32_mma.cuh), float32 accumulation: eight warps a block, warp w owns
//   the tile's rows 16w..16w + 15 and every column, so the filter and gate
//   columns of a row meet in a lane and the gate runs in registers; the
//   forward takes z back as z @ wd's A fragments by warp shuffles. The
//   weight gradients contract the tile's rows, split among the warps; each
//   k-step's product is added to its sum in float32 (round to nearest).
// - Asynchronous copies. cp.async brings layer l + 1's raw w_fg | wd (20
//   KB at R = D = 32) while layer l computes, the ring rows and the tile's
//   rows; each layer splits its weights once into TF32 hi/lo fragment
//   order. Barriers: three a layer forward (two where d >= TM: the past
//   tap is then no other warp's rows), three backward (dx_l goes to a
//   second tile, so dx_{l+1} stays whole for the weight gradients).
// - Gradients of the weights, biases and add are partial sums per (layer,
//   row, chunk) in device memory, added in a fixed order by a last launch
//   (reduce_partials_kernel): no float atomics, so repeated calls on one
//   grid are bitwise equal. y, fg, z and dx do not depend on the grid.
//
// What bounds it. The work is kernel 5's (fused_stack_mma.cu): at the gc
// config and b8 x 19,070 rows, 4.7e10 FLOPs forward and 1.0e11 backward;
// the forward moves 1.2 GB without z (v1) and 1.8 GB with it (v2), the
// backward 1.8 GB. At 3xTF32 (495 / 3 = 165 TFLOP/s) the forward is bound
// by bytes (0.36 / 0.54 ms) and the backward by operations (0.62 ms).
// Unlike kernel 5 it keeps every layer's x (and in the backward da and the
// rebuilt x) out of device memory; what it pays instead is the ring
// round trips (L2) and waits, the per-(tile, layer) weight split, and, in
// the backward, one block an SM (213 KB of shared memory at R = D = 32) and
// the partial sums' read-modify-writes (~42 KB a tile and layer).
//
// Registers a thread (ptxas -v for sm_90a): forward / backward at width 32
// 128 / 250 (4 bytes spilled in the forward), 16 85 / 112, 8 62 / 167; in
// the bf16 mode 126 / 212, 67 / 122, 95 / 127, none spilled.
//
// The bf16 mode (fused_stack_carry_{fwd,bwd}_bf16), the counterpart of the
// same TPU kernels at kernel_dtype = bfloat16: every product is one bf16
// mma.sync m16n8k16 pass (bf16_mma.cuh) with float32 accumulation, its
// operands rounded to bf16 to nearest even as they load (the weights once a
// layer, as split_weights stores them; the tap rows, z, dx_{l+1}, da and
// the rebuilt layer input at each fragment); the residual, the rings (x
// forward, da backward), y, dx and every gradient stay float32, as the TPU
// kernels' carries do. The forward adds the residual in the TPU kernels'
// order, (x + z @ wd) + bd, and stores fg (and z) as bf16 records; the
// backward reads fg and dz as bf16. z enters z @ wd without shuffles: the
// gate's accumulators of n-tiles 2k and 2k + 1 are, packed in pairs, the A
// fragment of k-step k. At width 8 a product of K = 8 is half a k-step,
// its upper k zeros; the forward's fg product takes the past tap's 8
// columns and the current tap's 8 as one k-step. The mode's weight
// fragments take a quarter of the f32 mode's shared memory, so each mode
// has its own resident blocks and plan (on an H100 the same as the f32
// mode's: two forward blocks an SM, held by registers, one backward). y,
// fg, z and dx do not depend on the grid in either mode. At the bf16 peak
// (989 TFLOP/s) and 2-byte records every direction is bound by bytes: at
// gc b8 0.19 ms forward without z, 0.27 with it, 0.28 backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "stack_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int TM = 128;          // time steps a tile
constexpr int NW = 8;            // warps a block; warp w owns rows 16w..16w+15
constexpr int NT = 32 * NW;
constexpr int kMaxLayers = 256;

// Each layer's dilation and the offset of its slots in a row's ring.
struct Layers {
  int d[kMaxLayers];
  int o[kMaxLayers];
};

// The two modes. KS: the k of one mma.sync; WF: a lane's part of a weight
// fragment (f32: {hi(b0), hi(b1), lo(b0), lo(b1)} of a k-step of 8; bf16:
// {b0, b1}, bf16 pairs along k of a k-step of 16); Rec: the element of the
// fg, z and dz records.
template <bool BF>
struct Mode {
  static constexpr int KS = 8;
  using WF = uint4;
  using Rec = float;
};

template <>
struct Mode<true> {
  static constexpr int KS = 16;
  using WF = uint2;
  using Rec = __nv_bfloat16;
};

// Lanes' weight fragments of a [K][N] B in mode BF: k-steps (the last
// padded with zero rows where K < KS), n-tiles of 8, 32 lanes.
template <bool BF>
__host__ __device__ constexpr int frags(int K, int N) {
  return (K + Mode<BF>::KS - 1) / Mode<BF>::KS * (N / 8) * 32;
}

// A launch's arguments. prog [B][L]: ring writes of row b's layer l
// published so far, one a warp (zeroed by the launcher); nchunk blocks a
// row.
template <typename Rec>
struct FwdArgsT {
  const float *x, *w_fg, *wd, *add, *bd;
  float* y;
  Rec *fg, *z;
  float* rings;
  int* prog;
  int B, T, L, sum_d, nchunk;
  Layers lay;
};

template <typename Rec>
struct BwdArgsT {
  const float *y, *dy;
  const Rec *fg, *dz;
  const float *w_fg, *wd, *bd;
  float *dx, *part_w, *part_a, *part_add, *rings;
  int* prog;
  int B, T, L, sum_d, nchunk;
  Layers lay;
};

// The layout at width W = R = D in mode BF: activation tiles of row stride
// W + 4 and 2W + 4 floats (A-fragment loads free of bank conflicts); the
// weights of a layer raw as cp.async lands them ([w_fg | wd]) and as
// fragments in fragment order (f32: split into TF32 hi/lo, one 16-byte
// load a lane per 8x8 fragment; bf16: rounded, one 8-byte load a lane per
// 16x8 fragment).
template <int W, bool BF>
struct Geo {
  static constexpr int R = W, D = W, K1 = 2 * W, N1 = 2 * W;
  static constexpr int SX = W + 4, SA = N1 + 4;
  static constexpr int kRaw = K1 * N1 + D * R;
  static constexpr int kWF = (int)sizeof(typename Mode<BF>::WF);
  // Forward: w_fg and wd as fragments, the raw weights, the x tile
  // [2TM][SX] (rows TM - e.. hold the past tap from the ring, rows TM..
  // the tile's x).
  static constexpr int kFwd = kWF * (frags<BF>(K1, N1) + frags<BF>(D, R)) +
                              4 * kRaw + 4 * 2 * TM * SX;
  // Backward: wd^T, wd, w_fg[R:]^T and w_fg[:R]^T as fragments, the raw
  // weights, x, two dx and z tiles [TM][SX], the da tile [2TM][SA] (rows
  // TM.. hold da past the tile, from the ring).
  static constexpr int kBwd =
      kWF * (frags<BF>(R, D) + frags<BF>(D, R) + 2 * frags<BF>(N1, R)) +
      4 * kRaw + 4 * 4 * TM * SX + 4 * 2 * TM * SA;
  static_assert(W % 8 == 0 && W <= 32, "widths 8, 16, 32");
  static_assert(kFwd <= 232448 && kBwd <= 232448, "shared memory");
};

// A wait longer than this is a fault of the schedule (a block that waits
// on one that is not resident): trap, so that the launch fails instead of
// holding the card.
constexpr unsigned long long kSpinLimitNs = 10000000000ull;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: spin until *p >= want (acquire).
__device__ __noinline__ void wait_at_least(const int* p, int want) {
  if (ld_acquire(p) >= want) return;
  const unsigned long long t0 = globaltimer();
  while (ld_acquire(p) < want) {
    __nanosleep(32);
    if (globaltimer() - t0 > kSpinLimitNs) __trap();
  }
}

// Every lane of a warp, after its ring writes: once they are visible on
// the device, add one to *p (release).
__device__ __forceinline__ void publish_warp(int* p, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0)
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;" :: "l"(p)
                 : "memory");
}

// Layer l's raw weights [w_fg[l] | wd[l]] into raw, by cp.async.
template <int W>
__device__ __forceinline__ void prefetch_weights(float* raw, const float* w_fg,
                                              const float* wd, int l) {
  using G = Geo<W, false>;   // the raw weights are float32 in both modes
  constexpr int C1 = G::K1 * G::N1 / 4, C2 = G::D * G::R / 4;
  const float* f = w_fg + (size_t)l * G::K1 * G::N1;
  const float* v = wd + (size_t)l * G::D * G::R;
  for (int i = threadIdx.x; i < C1 + C2; i += NT)
    cp_async16(raw + 4 * i, i < C1 ? f + 4 * i : v + 4 * (i - C1), true);
}

// B = at(k, n) [K][N] as fragments: for k-step ks and n-tile nt, lane l
// holds {hi(b0), hi(b1), lo(b0), lo(b1)} of B[8ks + l%4 (+4)][8nt + l/4].
template <int K, int N, typename F>
__device__ __forceinline__ void split_weights(uint4* dst, F at) {
  constexpr int NTN = N / 8;
  for (int i = threadIdx.x; i < K * N / 2; i += NT) {
    const int lane = i & 31, nt = (i >> 5) % NTN, ks = (i >> 5) / NTN;
    const int k = ks * 8 + (lane & 3), n = nt * 8 + (lane >> 2);
    uint32_t h0, l0, h1, l1;
    tf32_split(at(k, n), h0, l0);
    tf32_split(at(k + 4, n), h1, l1);
    dst[i] = make_uint4(h0, h1, l0, l1);
  }
}

// bf16: for k-step ks (16) and n-tile nt, lane l holds {b0, b1} = the bf16
// pairs of B (bf16_mma.cuh's pack_bf16_frags).
template <int K, int N, typename F>
__device__ __forceinline__ void split_weights(uint2* dst, F at) {
  pack_bf16_frags<NT, K, N>(dst, at);
}

// Two adjacent record elements stored from floats, or read (read-only
// path) as a float2.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// Rows [t0, t0 + TM) of row b (base = b T) of a [B, T, W] array into a
// [TM][S] tile by cp.async, zeros past T.
template <int W, int S>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t base, int t0, int T) {
  constexpr int CH = W / 4;
  for (int i = threadIdx.x; i < TM * CH; i += NT) {
    const int r = i / CH, c = i % CH, t = t0 + r;
    const bool ok = t < T;
    cp_async16(dst + r * S + 4 * c, ok ? src + (base + t) * W + 4 * c : src,
               ok);
  }
}

// The sum of a tile's column (rows of stride S), in four chains.
template <int S>
__device__ __forceinline__ float colsum(const float* p) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int r = 0; r < TM; r += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] += p[(r + i) * S];
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// A partial sum of this block: stored on its first tile, added after.
__device__ __forceinline__ void accumulate2(float* p, float a, float b,
                                            bool first) {
  float2* q = reinterpret_cast<float2*>(p);
  if (first) {
    *q = make_float2(a, b);
  } else {
    const float2 o = *q;
    *q = make_float2(o.x + a, o.y + b);
  }
}

// ---------------------------------------------------------------------------
// Forward: grid (nchunk, B); block c of row b walks the row's tiles c,
// c + nchunk, ... in time order, all L layers a tile.
// ---------------------------------------------------------------------------

template <int W, bool BF>
__global__ void __launch_bounds__(NT, 2) carry_fwd_kernel(
    const __grid_constant__ FwdArgsT<typename Mode<BF>::Rec> args) {
  using G = Geo<W, BF>;
  using WF = typename Mode<BF>::WF;
  constexpr int R = W, D = W, K1 = G::K1, N1 = G::N1, SX = G::SX;
  constexpr int NF = N1 / 8, NQ = D / 8, NR = R / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WF* s_wf = reinterpret_cast<WF*>(smem_raw);                       // B = w_fg [K1][N1]
  WF* s_wd = s_wf + frags<BF>(K1, N1);                              // B = wd [D][R]
  float* s_raw = reinterpret_cast<float*>(s_wd + frags<BF>(D, R));  // next [w_fg | wd]
  float* s_x = s_raw + G::kRaw;                               // [2TM][SX]
  float* cur = s_x + TM * SX;                                 // the tile's x rows

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int B = args.B, T = args.T, L = args.L, nchunk = args.nchunk;
  const size_t base = (size_t)b * T;
  const size_t fg_ld = (size_t)L * N1, z_ld = (size_t)L * D;
  float* ring = args.rings + (size_t)b * args.sum_d * R;
  int* prog = args.prog + (size_t)b * L;
  const int ntiles = (T + TM - 1) / TM;
  if (chunk >= ntiles) return;

  prefetch_weights<W>(s_raw, args.w_fg, args.wd, 0);
  for (int jt = chunk; jt < ntiles; jt += nchunk) {
    const int t0 = jt * TM;
    load_tile<R, SX>(cur, args.x, base, t0, T);
    cp_async_commit();
    for (int l = 0; l < L; ++l) {
      const int d = args.lay.d[l], e = d < TM ? d : TM;
      float* ring_l = ring + (size_t)args.lay.o[l] * R;
      // Ring l holds x_l of the d positions before t0 once every ring
      // writer of tiles < jt has published.
      if (tid == 0 && nchunk > 1) wait_at_least(prog + l, jt * ((e + 15) / 16));
      cp_async_wait<0>();
      __syncthreads();   // x_l, layer l's raw weights; layer l-1 is done
      // The past tap x_l(t0 - d + i), i < e, from ring slot (t0 + i) mod d,
      // into row TM - e + i: row r's past tap is then row TM - e + r.
      for (int i = tid; i < e * (R / 4); i += NT) {
        const int r = i / (R / 4), c = i % (R / 4);
        cp_async16(s_x + (TM - e + r) * SX + 4 * c,
                   ring_l + (size_t)((t0 + r) % d) * R + 4 * c, true);
      }
      cp_async_commit();
      split_weights<K1, N1>(s_wf, [&](int k, int n) { return s_raw[k * N1 + n]; });
      split_weights<D, R>(s_wd, [&](int k, int n) {
        return s_raw[K1 * N1 + k * R + n];
      });
      cp_async_wait<0>();
      __syncthreads();   // the fragments and the past tap are whole
      if (l + 1 < L) prefetch_weights<W>(s_raw, args.w_fg, args.wd, l + 1);
      else if (jt + nchunk < ntiles) prefetch_weights<W>(s_raw, args.w_fg, args.wd, 0);
      cp_async_commit();
      // The ring keeps the tile's last e rows of x_l for the next tiles:
      // each warp writes its own and publishes.
      if (16 * w + 16 > TM - e) {
        const int r0 = 16 * w > TM - e ? 16 * w : TM - e;
        for (int i = lane; i < (16 * w + 16 - r0) * (R / 4); i += 32) {
          const int r = r0 + i / (R / 4), c = i % (R / 4);
          __stcg(reinterpret_cast<float4*>(ring_l + (size_t)((t0 + r) % d) * R) + c,
                 *reinterpret_cast<const float4*>(cur + r * SX + 4 * c));
        }
        publish_warp(prog + l, lane);
      }

      // fg = [past | cur] @ w_fg + add[l, b]: the warp's 16 rows, every
      // column; filter column j and gate column D + j meet in a lane.
      float acc[NF][4];
      zero(acc);
      if constexpr (BF) {
        // k-steps of 16 columns of [past | cur]; at width 8 one step holds
        // both taps' 8 columns.
        const float* past = s_x + (TM - e + 16 * w) * SX;
        const float* now = cur + 16 * w * SX;
#pragma unroll
        for (int ks = 0; ks < K1 / 16; ++ks) {
          Bf16Frag af;
          if constexpr (R == 8) afrag16<SX>(past, now, lane, af);
          else if (16 * ks < R)
            afrag16<SX>(past + 16 * ks, past + 16 * ks + 8, lane, af);
          else
            afrag16<SX>(now + 16 * ks - R, now + 16 * ks - R + 8, lane, af);
          uint2 bw[NF];
#pragma unroll
          for (int j = 0; j < NF; ++j) bw[j] = s_wf[(ks * NF + j) * 32 + lane];
          mma_bf16_n(acc, af, bw);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < K1 / 8; ++ks) {
          Tf32Frag af;
          if (ks < R / 8) afrag<SX>(s_x, TM - e + 16 * w, 8 * ks, lane, af);
          else afrag<SX>(cur, 16 * w, 8 * ks - R, lane, af);
          uint4 bw[NF];
#pragma unroll
          for (int j = 0; j < NF; ++j) bw[j] = s_wf[(ks * NF + j) * 32 + lane];
          mma3_tf32_n(acc, af.hi, af.lo, bw);
        }
      }
      const float* add_b = args.add + ((size_t)l * B + b) * N1;
      float zr[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + 16 * w + g + 8 * h;
          const float f0 = acc[j][2 * h] + add_b[col];
          const float f1 = acc[j][2 * h + 1] + add_b[col + 1];
          const float g0 = acc[NQ + j][2 * h] + add_b[D + col];
          const float g1 = acc[NQ + j][2 * h + 1] + add_b[D + col + 1];
          zr[j][2 * h] = tanhf(f0) * sigmoidf(g0);
          zr[j][2 * h + 1] = tanhf(f1) * sigmoidf(g1);
          if (t < T) {
            auto* fr = args.fg + (base + t) * fg_ld + (size_t)l * N1 + col;
            store2(fr, f0, f1);
            store2(fr + D, g0, g1);
            if (args.z)
              store2(args.z + (base + t) * z_ld + (size_t)l * D + col,
                     zr[j][2 * h], zr[j][2 * h + 1]);
          }
        }
      }
      // Below the dilation the past tap is another warp's x rows: they
      // must be read before any warp updates its rows.
      if (d < TM) __syncthreads();

      // x_{l+1} = x_l + (z @ wd + bd) (bf16: (x_l + z @ wd) + bd, the
      // TPU kernels' order), z from the registers, in place.
      float acc2[NR][4];
      zero(acc2);
      if constexpr (BF) {
        // The gate's accumulators of n-tiles 2ks, 2ks + 1 are k-step ks's
        // A fragment (at D = 8 one n-tile: the upper k zeros).
#pragma unroll
        for (int ks = 0; ks < (D + 15) / 16; ++ks) {
          Bf16Frag af;
          af.v[0] = pack_bf16(zr[2 * ks][0], zr[2 * ks][1]);
          af.v[1] = pack_bf16(zr[2 * ks][2], zr[2 * ks][3]);
          if constexpr (D == 8) {
            af.v[2] = af.v[3] = 0u;
          } else {
            af.v[2] = pack_bf16(zr[2 * ks + 1][0], zr[2 * ks + 1][1]);
            af.v[3] = pack_bf16(zr[2 * ks + 1][2], zr[2 * ks + 1][3]);
          }
          uint2 bw[NR];
#pragma unroll
          for (int j = 0; j < NR; ++j) bw[j] = s_wd[(ks * NR + j) * 32 + lane];
          mma_bf16_n(acc2, af, bw);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < NQ; ++ks) {
          Tf32Frag af;
          acc_afrag(zr[ks], lane, af);
          uint4 bw[NR];
#pragma unroll
          for (int j = 0; j < NR; ++j) bw[j] = s_wd[(ks * NR + j) * 32 + lane];
          mma3_tf32_n(acc2, af.hi, af.lo, bw);
        }
      }
      const float* bd = args.bd + (size_t)l * R;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int col = 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* xp = reinterpret_cast<float2*>(cur + (16 * w + g + 8 * h) * SX + col);
          const float2 v = *xp;
          if constexpr (BF)
            *xp = make_float2((v.x + acc2[j][2 * h]) + bd[col],
                              (v.y + acc2[j][2 * h + 1]) + bd[col + 1]);
          else
            *xp = make_float2(v.x + (acc2[j][2 * h] + bd[col]),
                              v.y + (acc2[j][2 * h + 1] + bd[col + 1]));
        }
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * (R / 4); i += 32) {
      const int r = 16 * w + i / (R / 4), c = i % (R / 4), t = t0 + r;
      if (t < T)
        *reinterpret_cast<float4*>(args.y + (base + t) * R + 4 * c) =
            *reinterpret_cast<const float4*>(cur + r * SX + 4 * c);
    }
    __syncthreads();   // the x rows are free for the next tile
  }
}

// ---------------------------------------------------------------------------
// Backward: grid (nchunk, B); block c of row b walks the row's tiles in
// reverse (the k-th from the end for k = c, c + nchunk, ...) and each
// tile's layers in reverse. Writes dx and per-(layer, row, chunk) partial
// sums of dw_fg, dwd, dbd and dadd.
// ---------------------------------------------------------------------------

template <int W, bool BF>
__global__ void __launch_bounds__(NT, 1) carry_bwd_kernel(
    const __grid_constant__ BwdArgsT<typename Mode<BF>::Rec> args) {
  using G = Geo<W, BF>;
  using WF = typename Mode<BF>::WF;
  constexpr int R = W, D = W, K1 = G::K1, N1 = G::N1, SX = G::SX, SA = G::SA;
  constexpr int NQ = D / 8, NR = R / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WF* s_wdt = reinterpret_cast<WF*>(smem_raw);   // B = wd^T [R][D]
  WF* s_wdb = s_wdt + frags<BF>(R, D);           // B = wd [D][R]
  WF* s_wct = s_wdb + frags<BF>(D, R);           // B = w_fg[R:]^T [N1][R]
  WF* s_wpt = s_wct + frags<BF>(N1, R);          // B = w_fg[:R]^T [N1][R]
  float* s_raw = reinterpret_cast<float*>(s_wpt + frags<BF>(N1, R));
  float* s_x = s_raw + G::kRaw;          // [TM][SX]  x_{l+1}, then x_l
  float* s_dc = s_x + TM * SX;           // 2 x [TM][SX]  dx_{l+1}, dx_l in turns
  float* s_z = s_dc + 2 * TM * SX;       // [TM][SX]  z
  float* s_da = s_z + TM * SX;           // [2TM][SA] da(t); rows TM.. from the ring

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int B = args.B, T = args.T, L = args.L, nchunk = args.nchunk;
  const size_t base = (size_t)b * T;
  const size_t fg_ld = (size_t)L * N1, z_ld = (size_t)L * D;
  float* ring = args.rings + (size_t)b * args.sum_d * N1;
  int* prog = args.prog + (size_t)b * L;
  const int ntiles = (T + TM - 1) / TM;

  if (chunk >= ntiles) {   // no tile: this block's partial sums are zero
    for (int l = 0; l < L; ++l) {
      const size_t slot = ((size_t)l * B + b) * nchunk + chunk;
      for (int i = tid; i < K1 * N1; i += NT) args.part_w[slot * (K1 * N1) + i] = 0.f;
      for (int i = tid; i < D * R + R; i += NT) args.part_a[slot * (D * R + R) + i] = 0.f;
      for (int i = tid; i < N1; i += NT) args.part_add[slot * N1 + i] = 0.f;
    }
    return;
  }

  // The weight-gradient tiles of a warp. dwd [D][R]: m-tile mv (z
  // channels, masked to D at width 8), n-tile nv; warps < kVw. dw_fg
  // [K1][N1], as halves (rows < R pair x_l(t) with da(t + d), the rest
  // with da(t)) of MH m-tiles each: half hw, m-tile mw, n-tiles nw0 ..
  // nw0 + NJ - 1; warps < kFw.
  constexpr int MV = (D + 15) / 16, NVN = R / 8, kVw = MV * NVN;
  constexpr int MH = (R + 15) / 16, NFN = N1 / 8, kFt = 2 * MH * NFN;
  constexpr int NJ = kFt >= NW ? kFt / NW : 1, kFw = kFt / NJ;
  static_assert(kVw <= NW && NFN % NJ == 0, "gradient tiles");
  const int mv = w / NVN, nv = w % NVN;
  const int ti = w * NJ;
  const int hw = ti / (MH * NFN), mw = (ti / NFN) % MH, nw0 = ti % NFN;

  prefetch_weights<W>(s_raw, args.w_fg, args.wd, L - 1);
  for (int k = chunk; k < ntiles; k += nchunk) {
    const int jt = ntiles - 1 - k, t0 = jt * TM;
    const bool first = k == chunk;   // this block's first tile
    load_tile<R, SX>(s_x, args.y, base, t0, T);
    load_tile<R, SX>(s_dc, args.dy, base, t0, T);
    cp_async_commit();
    int cb = 0;   // the dx tile that holds dx_{l+1}
    for (int l = L - 1; l >= 0; --l) {
      const int d = args.lay.d[l], e = d < TM ? d : TM;
      float* ring_l = ring + (size_t)args.lay.o[l] * N1;
      const size_t slot = ((size_t)l * B + b) * nchunk + chunk;
      // Ring l holds da of the d positions after this tile once every ring
      // writer of the walk's tiles < k has published.
      if (tid == 0 && nchunk > 1) wait_at_least(prog + l, k * ((e + 15) / 16));
      cp_async_wait<0>();
      __syncthreads();   // x_{l+1}, dx_{l+1}, raw weights; layer l+1 is done
      // da(t0 + d + TM - e + i), i < e, from ring slot (t0 + TM - e + i)
      // mod d, into row TM + i: row r's da(t + d) is then row r + e.
      for (int i = tid; i < e * (N1 / 4); i += NT) {
        const int r = i / (N1 / 4), c = i % (N1 / 4);
        cp_async16(s_da + (TM + r) * SA + 4 * c,
                   ring_l + (size_t)((t0 + TM - e + r) % d) * N1 + 4 * c, true);
      }
      cp_async_commit();
      const float* rw = s_raw + K1 * N1;   // wd [D][R]
      split_weights<R, D>(s_wdt, [&](int kk, int n) { return rw[n * R + kk]; });
      split_weights<D, R>(s_wdb, [&](int kk, int n) { return rw[kk * R + n]; });
      split_weights<N1, R>(s_wct, [&](int kk, int n) {
        return s_raw[(R + n) * N1 + kk];
      });
      split_weights<N1, R>(s_wpt, [&](int kk, int n) { return s_raw[n * N1 + kk]; });
      cp_async_wait<0>();
      __syncthreads();   // the fragments and the ring's rows are whole
      if (l > 0) prefetch_weights<W>(s_raw, args.w_fg, args.wd, l - 1);
      else if (k + nchunk < ntiles) prefetch_weights<W>(s_raw, args.w_fg, args.wd, L - 1);
      cp_async_commit();
      const float* dcn = s_dc + cb * TM * SX;    // dx_{l+1}
      float* dcl = s_dc + (cb ^ 1) * TM * SX;    // dx_l

      // dz_tot = dz + dx_{l+1} @ wd^T; da = dz_tot * (d z / d fg); z. The
      // warp's rows.
      {
        // The layer's fg and dz at the lane's accumulator positions, loaded
        // under the product (zeros past T).
        float2 f[NQ][2], gg[NQ][2], dzv[NQ][2];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + 16 * w + g + 8 * h, col = 8 * j + 2 * q;
            f[j][h] = gg[j][h] = dzv[j][h] = make_float2(0.f, 0.f);
            if (t < T) {
              const auto* fr = args.fg + (base + t) * fg_ld + (size_t)l * N1 + col;
              f[j][h] = ldg2(fr);
              gg[j][h] = ldg2(fr + D);
              dzv[j][h] = ldg2(args.dz + (base + t) * z_ld + (size_t)l * D + col);
            }
          }
        }
        float acc[NQ][4];
        zero(acc);
        if constexpr (BF) {
#pragma unroll
          for (int ks = 0; ks < (R + 15) / 16; ++ks) {
            Bf16Frag af;
            const float* p = dcn + 16 * w * SX + 16 * ks;
            afrag16<SX, R % 16 == 0>(p, p + 8, lane, af);
            uint2 bw[NQ];
#pragma unroll
            for (int j = 0; j < NQ; ++j) bw[j] = s_wdt[(ks * NQ + j) * 32 + lane];
            mma_bf16_n(acc, af, bw);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < R / 8; ++ks) {
            Tf32Frag af;
            afrag<SX>(dcn, 16 * w, 8 * ks, lane, af);
            uint4 bw[NQ];
#pragma unroll
            for (int j = 0; j < NQ; ++j) bw[j] = s_wdt[(ks * NQ + j) * 32 + lane];
            mma3_tf32_n(acc, af.hi, af.lo, bw);
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int col = 8 * j + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            const float th0 = tanhf(f[j][h].x), th1 = tanhf(f[j][h].y);
            const float sg0 = sigmoidf(gg[j][h].x), sg1 = sigmoidf(gg[j][h].y);
            const float dzt0 = dzv[j][h].x + acc[j][2 * h];
            const float dzt1 = dzv[j][h].y + acc[j][2 * h + 1];
            *reinterpret_cast<float2*>(s_z + r * SX + col) =
                make_float2(th0 * sg0, th1 * sg1);   // 0 past T (f = 0)
            *reinterpret_cast<float2*>(s_da + r * SA + col) = make_float2(
                dzt0 * sg0 * (1.f - th0 * th0), dzt1 * sg1 * (1.f - th1 * th1));
            *reinterpret_cast<float2*>(s_da + r * SA + D + col) = make_float2(
                dzt0 * th0 * sg0 * (1.f - sg0), dzt1 * th1 * sg1 * (1.f - sg1));
          }
        }
      }
      __syncwarp();
      // x_l = x_{l+1} - z @ wd - bd, the warp's rows, in place.
      {
        float acc[NR][4];
        zero(acc);
        if constexpr (BF) {
#pragma unroll
          for (int ks = 0; ks < (D + 15) / 16; ++ks) {
            Bf16Frag af;
            const float* p = s_z + 16 * w * SX + 16 * ks;
            afrag16<SX, D % 16 == 0>(p, p + 8, lane, af);
            uint2 bw[NR];
#pragma unroll
            for (int j = 0; j < NR; ++j) bw[j] = s_wdb[(ks * NR + j) * 32 + lane];
            mma_bf16_n(acc, af, bw);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < D / 8; ++ks) {
            Tf32Frag af;
            afrag<SX>(s_z, 16 * w, 8 * ks, lane, af);
            uint4 bw[NR];
#pragma unroll
            for (int j = 0; j < NR; ++j) bw[j] = s_wdb[(ks * NR + j) * 32 + lane];
            mma3_tf32_n(acc, af.hi, af.lo, bw);
          }
        }
        const float* bd = args.bd + (size_t)l * R;
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int col = 8 * j + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* xp = reinterpret_cast<float2*>(s_x + (16 * w + g + 8 * h) * SX + col);
            const float2 v = *xp;
            *xp = make_float2((v.x - acc[j][2 * h]) - bd[col],
                              (v.y - acc[j][2 * h + 1]) - bd[col + 1]);
          }
        }
      }
      __syncthreads();   // z, da and x_l of every row

      // The ring keeps da of the tile's first e rows for the earlier tiles:
      // each warp writes its own and publishes.
      if (16 * w < e) {
        const int n = (e < 16 * w + 16 ? e : 16 * w + 16) - 16 * w;
        for (int i = lane; i < n * (N1 / 4); i += 32) {
          const int r = 16 * w + i / (N1 / 4), c = i % (N1 / 4);
          __stcg(reinterpret_cast<float4*>(ring_l + (size_t)((t0 + r) % d) * N1) + c,
                 *reinterpret_cast<const float4*>(s_da + r * SA + 4 * c));
        }
        publish_warp(prog + l, lane);
      }

      // dx_l = dx_{l+1} + da(t) @ w_fg[R:]^T + da(t + d) @ w_fg[:R]^T, the
      // warp's rows, into the other dx tile.
      {
        float ac[NR][4], ap[NR][4];
        zero(ac);
        zero(ap);
        if constexpr (BF) {
#pragma unroll
          for (int ks = 0; ks < N1 / 16; ++ks) {
            Bf16Frag a1, a2;
            const float* p1 = s_da + 16 * w * SA + 16 * ks;
            const float* p2 = s_da + (16 * w + e) * SA + 16 * ks;
            afrag16<SA>(p1, p1 + 8, lane, a1);
            afrag16<SA>(p2, p2 + 8, lane, a2);
            uint2 bc[NR], bp[NR];
#pragma unroll
            for (int j = 0; j < NR; ++j) {
              bc[j] = s_wct[(ks * NR + j) * 32 + lane];
              bp[j] = s_wpt[(ks * NR + j) * 32 + lane];
            }
            mma_bf16_n(ac, a1, bc);
            mma_bf16_n(ap, a2, bp);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < N1 / 8; ++ks) {
            Tf32Frag a1, a2;
            afrag<SA>(s_da, 16 * w, 8 * ks, lane, a1);
            afrag<SA>(s_da, 16 * w + e, 8 * ks, lane, a2);
            uint4 bc[NR], bp[NR];
#pragma unroll
            for (int j = 0; j < NR; ++j) {
              bc[j] = s_wct[(ks * NR + j) * 32 + lane];
              bp[j] = s_wpt[(ks * NR + j) * 32 + lane];
            }
            mma3_tf32_n(ac, a1.hi, a1.lo, bc);
            mma3_tf32_n(ap, a2.hi, a2.lo, bp);
          }
        }
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int col = 8 * j + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            const float2 dn = *reinterpret_cast<const float2*>(dcn + r * SX + col);
            *reinterpret_cast<float2*>(dcl + r * SX + col) =
                make_float2((dn.x + ac[j][2 * h]) + ap[j][2 * h],
                            (dn.y + ac[j][2 * h + 1]) + ap[j][2 * h + 1]);
          }
        }
      }

      // Partial dwd += z^T @ dx_{l+1} over the tile's rows.
      if (w < kVw) {
        float p[1][4];
        zero(p);
        if constexpr (BF) {
#pragma unroll 4
          for (int ks = 0; ks < TM / 16; ++ks) {
            Bf16Frag af;
            uint2 bw[1];
            afrag16_t<SX, D>(s_z, 16 * mv, 16 * ks, lane, af);
            bfrag16<SX>(dcn, 16 * ks, 8 * nv, lane, bw[0]);
            mma_bf16_step_rn(p, af, bw);
          }
        } else {
#pragma unroll 4
          for (int ks = 0; ks < TM / 8; ++ks) {
            Tf32Frag af;
            uint4 bw[1];
            afrag_tm<SX, D>(s_z, 16 * mv, 8 * ks, lane, af);
            bfrag<SX>(dcn, 8 * ks, 8 * nv, lane, bw[0]);
            mma3_step_rn(p, af, bw);
          }
        }
        float* pa = args.part_a + slot * (D * R + R);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mv + g + 8 * h, col = 8 * nv + 2 * q;
          if (row < D)
            accumulate2(pa + row * R + col, p[0][2 * h], p[0][2 * h + 1],
                        first);
        }
      }
      // Partial dw_fg: rows k < R pair x_l(t) with da(t + d) (the past
      // tap), rows R + k pair x_l(t) with da(t) (the current tap).
      if (w < kFw) {
        float p[NJ][4];
        zero(p);
        const float* bsrc = hw == 0 ? s_da + e * SA : s_da;
        if constexpr (BF) {
#pragma unroll 4
          for (int ks = 0; ks < TM / 16; ++ks) {
            Bf16Frag af;
            afrag16_t<SX, R>(s_x, 16 * mw, 16 * ks, lane, af);
            uint2 bw[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              bfrag16<SA>(bsrc, 16 * ks, 8 * (nw0 + j), lane, bw[j]);
            mma_bf16_step_rn(p, af, bw);
          }
        } else {
#pragma unroll 4
          for (int ks = 0; ks < TM / 8; ++ks) {
            Tf32Frag af;
            afrag_tm<SX, R>(s_x, 16 * mw, 8 * ks, lane, af);
            uint4 bw[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) bfrag<SA>(bsrc, 8 * ks, 8 * (nw0 + j), lane, bw[j]);
            mma3_step_rn(p, af, bw);
          }
        }
        float* pw = args.part_w + slot * (K1 * N1);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 16 * mw + g + 8 * h, col = 8 * (nw0 + j) + 2 * q;
            if (m < R)
              accumulate2(pw + (hw * R + m) * N1 + col, p[j][2 * h],
                          p[j][2 * h + 1], first);
          }
        }
      }
      // Partial dbd (dx_{l+1}) and dadd (da): column sums, four chains of
      // rows r mod 4, added in a fixed order.
      if (tid < R) {
        float* pb = args.part_a + slot * (D * R + R) + D * R + tid;
        const float s = colsum<SX>(dcn + tid);
        *pb = first ? s : *pb + s;
      } else if (tid >= 64 && tid < 64 + N1) {
        float* pd = args.part_add + slot * N1 + tid - 64;
        const float s = colsum<SA>(s_da + tid - 64);
        *pd = first ? s : *pd + s;
      }
      cb ^= 1;
    }
    __syncwarp();
    const float* dc0 = s_dc + cb * TM * SX;   // dx_0
    for (int i = lane; i < 16 * (R / 4); i += 32) {
      const int r = 16 * w + i / (R / 4), c = i % (R / 4), t = t0 + r;
      if (t < T)
        *reinterpret_cast<float4*>(args.dx + (base + t) * R + 4 * c) =
            *reinterpret_cast<const float4*>(dc0 + r * SX + 4 * c);
    }
    __syncthreads();   // the tiles are free for the next tile's rows
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

// The kernel of a direction at width W = R = D in mode BF, with its shared
// memory set.
template <int W, bool BF>
cudaError_t prepare(int backward, const void** fn, int* smem) {
  if (backward) {
    *fn = (const void*)carry_bwd_kernel<W, BF>;
    *smem = Geo<W, BF>::kBwd;
  } else {
    *fn = (const void*)carry_fwd_kernel<W, BF>;
    *smem = Geo<W, BF>::kFwd;
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

template <bool BF>
cudaError_t prepare_width(int backward, int R, const void** fn, int* smem) {
  if (R == 32) return prepare<32, BF>(backward, fn, smem);
  if (R == 16) return prepare<16, BF>(backward, fn, smem);
  return prepare<8, BF>(backward, fn, smem);
}

// Blocks of a direction's kernel in a mode that the device keeps resident
// at once.
cudaError_t resident_blocks(int backward, int R, int bf16, int* n) {
  const void* fn;
  int smem, dev, sms, per;
  cudaError_t e = bf16 ? prepare_width<true>(backward, R, &fn, &smem)
                       : prepare_width<false>(backward, R, &fn, &smem);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, NT, smem);
  if (e != cudaSuccess) return e;
  *n = per * sms;
  return cudaSuccess;
}

// The plan (experiments/fused_stack.py:carry_plan): blocks a row.
int plan_nchunk(int B, int resident) {
  const int n = resident / B;
  return n < 1 ? 1 : n;
}

// Scratch: the progress counters (padded to 4 floats), then the rings,
// then (backward) the partial sums of each (layer, row, chunk).
size_t prog_floats(int B, int L) { return ((size_t)B * L + 3) / 4 * 4; }

// One launch: an ordinary grid where one block a row (nchunk = 1: no
// waits), else cooperative, which refuses a grid whose blocks cannot all
// be resident (a block waits on the block of the tile before its own).
template <typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& args, int smem,
                   cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.nchunk, args.B, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = args.nchunk > 1 ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int W, bool BF, typename Rec = typename Mode<BF>::Rec>
int forward_impl(const float* x, const float* w_fg, const float* wd,
                 const float* add, const float* bd, const int* dil, float* y,
                 Rec* fg, Rec* z, float* scratch, int B, int T, int L,
                 int nchunk, cudaStream_t st) {
  constexpr int R = W;
  FwdArgsT<Rec> a;
  a.lay = make_layers(dil, L, &a.sum_d);
  const void* fn;
  int smem;
  cudaError_t e = prepare<W, BF>(0, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  const size_t np = prog_floats(B, L);
  e = cudaMemsetAsync(scratch, 0,
                      sizeof(float) * (np + (size_t)B * a.sum_d * R), st);
  if (e != cudaSuccess) return (int)e;
  a.x = x; a.w_fg = w_fg; a.wd = wd; a.add = add; a.bd = bd;
  a.y = y; a.fg = fg; a.z = z;
  a.prog = reinterpret_cast<int*>(scratch);
  a.rings = scratch + np;
  a.B = B; a.T = T; a.L = L; a.nchunk = nchunk;
  return (int)launch(carry_fwd_kernel<W, BF>, a, smem, st);
}

template <int W, bool BF, typename Rec = typename Mode<BF>::Rec>
int backward_impl(const float* y, const float* dy, const Rec* fg,
                  const Rec* dz, const float* w_fg, const float* wd,
                  const float* bd, const int* dil, float* dx, float* dw_fg,
                  float* dwd, float* dadd, float* dbd, float* scratch, int B,
                  int T, int L, int nchunk, cudaStream_t st) {
  constexpr int R = W, D = W;
  BwdArgsT<Rec> a;
  a.lay = make_layers(dil, L, &a.sum_d);
  const void* fn;
  int smem;
  cudaError_t e = prepare<W, BF>(1, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  const size_t np = prog_floats(B, L), ncta = (size_t)B * nchunk;
  a.prog = reinterpret_cast<int*>(scratch);
  a.rings = scratch + np;                                  // [B, sum_d, 2D]
  a.part_w = a.rings + (size_t)B * a.sum_d * 2 * D;        // [L, ncta, 2R, 2D]
  a.part_a = a.part_w + (size_t)L * ncta * 4 * R * D;      // [L, ncta, DR + R]
  a.part_add = a.part_a + (size_t)L * ncta * (D * R + R);  // [L, ncta, 2D]
  e = cudaMemsetAsync(scratch, 0,
                      sizeof(float) * (np + (size_t)B * a.sum_d * 2 * D), st);
  if (e != cudaSuccess) return (int)e;
  a.y = y; a.dy = dy; a.fg = fg; a.dz = dz; a.w_fg = w_fg; a.wd = wd;
  a.bd = bd; a.dx = dx;
  a.B = B; a.T = T; a.L = L; a.nchunk = nchunk;
  e = launch(carry_bwd_kernel<W, BF>, a, smem, st);
  if (e != cudaSuccess) return (int)e;
  // One partial sum per (layer, row, chunk), added in a fixed order.
  return (int)launch_reduce_partials<NT>(a.part_w, a.part_a, a.part_add,
                                         dw_fg, dwd, dbd, dadd, B, nchunk, L,
                                         R, D, st);
}

constexpr int kUnsupported = 1000;

}  // namespace

extern "C" {

// Shapes the kernels are built for: R == D in {8, 16, 32}, 1..256 layers.
int fused_stack_carry_supports(int R, int D, int L) {
  return R == D && (R == 8 || R == 16 || R == 32) && L >= 1 &&
         L <= kMaxLayers;
}

// Blocks of the forward (backward = 0) or backward (1) kernel at width
// R = D in the f32 (bf16 = 0) or bf16 (1) mode that the device keeps
// resident at once (occupancy x SMs); a negative CUDA error code on
// failure, -kUnsupported at a width not built.
int fused_stack_carry_resident_blocks(int backward, int R, int D, int bf16) {
  if (!fused_stack_carry_supports(R, D, 1)) return -kUnsupported;
  int n = 0;
  const cudaError_t e = resident_blocks(backward, R, bf16, &n);
  return e == cudaSuccess ? n : -(int)e;
}

// The library's own plan: blocks a batch row (nchunk) of a direction's
// grid (nchunk, B) in a mode on this device; the rule of carry_plan.
int fused_stack_carry_nchunk(int backward, int B, int R, int D, int bf16) {
  const int n = fused_stack_carry_resident_blocks(backward, R, D, bf16);
  return n < 0 ? n : plan_nchunk(B, n);
}

// Floats of scratch device memory a forward (backward = 0) or backward
// (backward = 1) call of nchunk blocks a row needs; sum_d is the sum of
// the dilations.
long long fused_stack_carry_scratch_floats(int backward, int B, int L, int R,
                                           int D, int sum_d, int nchunk) {
  const long long np = (long long)prog_floats(B, L);
  if (!backward) return np + (long long)B * sum_d * R;
  return np + (long long)B * sum_d * 2 * D +
         (long long)L * B * nchunk * (4LL * R * D + D * R + R + 2 * D);
}

// Forward (one launch). x [B,T,R]; w_fg [L,2R,2D]; wd [L,D,R]; add
// [L,B,2D]; bd [L,R]; dil: L dilations (host memory); outputs y [B,T,R],
// fg [B,T,L*2D] and, when z is not null, z [B,T,L*D]; scratch as sized by
// fused_stack_carry_scratch_floats; grid (nchunk, B), cooperative where
// nchunk > 1. Returns 0 or a CUDA error code.
int fused_stack_carry_fwd_f32(const float* x, const float* w_fg,
                              const float* wd, const float* add,
                              const float* bd, const int* dil, float* y,
                              float* fg, float* z, float* scratch, int B,
                              int T, int L, int R, int D, int nchunk,
                              void* stream) {
  if (!fused_stack_carry_supports(R, D, L)) return kUnsupported;
  if (nchunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* f = R == 32 ? &forward_impl<32, false>
          : R == 16 ? &forward_impl<16, false> : &forward_impl<8, false>;
  return f(x, w_fg, wd, add, bd, dil, y, fg, z, scratch, B, T, L, nchunk, st);
}

// The bf16 mode: the arguments of fused_stack_carry_fwd_f32, with fg and z
// bf16 records [B,T,L*2D] and [B,T,L*D] (float32 weights, rounded in the
// kernel).
int fused_stack_carry_fwd_bf16(const float* x, const float* w_fg,
                               const float* wd, const float* add,
                               const float* bd, const int* dil, float* y,
                               __nv_bfloat16* fg, __nv_bfloat16* z,
                               float* scratch, int B, int T, int L, int R,
                               int D, int nchunk, void* stream) {
  if (!fused_stack_carry_supports(R, D, L)) return kUnsupported;
  if (nchunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* f = R == 32 ? &forward_impl<32, true>
          : R == 16 ? &forward_impl<16, true> : &forward_impl<8, true>;
  return f(x, w_fg, wd, add, bd, dil, y, fg, z, scratch, B, T, L, nchunk, st);
}

// Backward (the kernel, then the fixed-order reduction). y, dy [B,T,R];
// fg [B,T,L*2D]; dz [B,T,L*D]; weights as in the forward; outputs dx
// [B,T,R], dw_fg [L,2R,2D], dwd [L,D,R], dadd [L,B,2D], dbd [L,R]; grid
// as in the forward. Returns 0 or a CUDA error code.
int fused_stack_carry_bwd_f32(const float* y, const float* dy,
                              const float* fg, const float* dz,
                              const float* w_fg, const float* wd,
                              const float* bd, const int* dil, float* dx,
                              float* dw_fg, float* dwd, float* dadd,
                              float* dbd, float* scratch, int B, int T, int L,
                              int R, int D, int nchunk, void* stream) {
  if (!fused_stack_carry_supports(R, D, L)) return kUnsupported;
  if (nchunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* f = R == 32 ? &backward_impl<32, false>
          : R == 16 ? &backward_impl<16, false> : &backward_impl<8, false>;
  return f(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd, dadd, dbd,
           scratch, B, T, L, nchunk, st);
}

// The bf16 mode: the arguments of fused_stack_carry_bwd_f32, with fg and dz
// bf16 records; every output float32.
int fused_stack_carry_bwd_bf16(const float* y, const float* dy,
                               const __nv_bfloat16* fg,
                               const __nv_bfloat16* dz, const float* w_fg,
                               const float* wd, const float* bd,
                               const int* dil, float* dx, float* dw_fg,
                               float* dwd, float* dadd, float* dbd,
                               float* scratch, int B, int T, int L, int R,
                               int D, int nchunk, void* stream) {
  if (!fused_stack_carry_supports(R, D, L)) return kUnsupported;
  if (nchunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* f = R == 32 ? &backward_impl<32, true>
          : R == 16 ? &backward_impl<16, true> : &backward_impl<8, true>;
  return f(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd, dadd, dbd,
           scratch, B, T, L, nchunk, st);
}

}  // extern "C"
