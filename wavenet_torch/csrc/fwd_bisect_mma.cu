// fwd_bisect_mma: the r2 probes' tensor-core mode, for NVIDIA Hopper
// (sm_90a): timing variants of the forward that the stack route runs at
// R = D = 32 and 64 (fused_stack_mma), in its two modes: f32 (3xTF32
// mma.sync m16n8k8, tf32_mma.cuh) and bf16 (one bf16 mma.sync m16n8k16,
// bf16_mma.cuh, float32 accumulation).
//
// Replaces, beside the FP32-core probes of fwd_bisect.cu (which stay), the
// TPU (Pallas) probe kernels of the JAX package
//   tools/r2_fwd_bisect.py:178   _kernel (the v3 forward with overhead
//                                sources toggled)
//   tools/r2_fwd_bisect2.py:108  _kernel (the forward's core math)
//
// fwd_bisect_mma_run: fused_stack_mma's forward (fused_stack_mma_fwd.cuh,
// one launch a layer on mma_tiling's grid), each variant its own
// instantiation of the layer kernel's part mask (stack_common.cuh):
//   full          every part: fused_stack_mma's forward itself
//   noshift       no cp.async of x(t - d): the past rows of both stages
//                 hold zeros written once
//   nodma         no fg / z record stores
//   bare          both of those
//   mxu           the products and the gate only: no row loads from x (the
//                 stages are zeros), the residual read in the epilogue
//   rolled        the past tap from one cp.async of the tile and its
//                 min(d, TM)-row halo, in place of a second row stream
//   rolled_nodma  rolled without the record stores
// Where the mma design already does what a TPU variant proposes: the TPU
// tool's `rolled` replaces per-batch shift copies by one roll of the whole
// tile; here the past tap is already one 16-byte cp.async stream of whole
// rows, double-buffered under the products, so `rolled` only trades that
// second stream of TM rows for a halo of d rows (at d >= TM it is the two
// streams again, the same code as `full`). `nodma` drops the TPU's record
// packing and DMA; here the records are already stored from the registers
// that hold fg and z, with no packing. `full` and `rolled` emit y, fg and z
// bitwise fused_stack_mma's (the same products in the same order).
//
// fwd_bisect2_mma_run: tools/r2_fwd_bisect2.py's variants at R = D = 32
// (the JAX tool's paper config). None reads another row (the TPU tool's
// cat tile and the fat tile's past lanes are never written), so one launch
// runs all L layers of a block of BM rows (64 or 128: the TPU tiles 1024
// and 2048 of fwd_bisect.cu's map), with the float32 residual in shared
// memory:
//   base       fg = cat @ w_fg (K = 2R, the cat tile zeros), tanh * sigmoid,
//              cur += z @ wd
//   mm_only    both products, z = f * g
//   act_only   cur += tanh(cur) * sigmoid(cur), no products (as
//              fwd_bisect.cu's, timed beside the others)
//   one_tanh   base with z = tanh(f) * (0.5 + 0.5 tanh(g))
//   fat        one K = 2R + 2D product a layer, [0 | cur | 0 | z_prev] @
//              wfat [2R+2D, 2D+R], emitting fg and the next residual
//   fat_1t     fat with the one-tanh gate
// The fat tile holds the residual in the operand type, as the TPU tool's
// does: float32 in f32 (the residual comes back from its 3xTF32 product
// to ~2^-21 relative), bf16 in bf16. A block starts from a zero fat tile.
// Each layer's weights are prefetched by cp.async into the second of two
// buffers while the current layer multiplies. fat's weight is [128, 96] a
// layer, 48 KB in float32 and 96 KB split into hi/lo, so the weights stay
// raw (row-major, in the operand type) and each B fragment is split (f32)
// or paired (bf16) as it loads: two stages of raw fat weights (104 KB in
// f32) and a 128-row float32 fat tile (66 KB) fit in 227 KB at both tiles.
//
// What bounds them. At the paper config and b8 x 19,070 rows, full does
// 4.7e10 operations and moves ~1.8 GB in f32 (~0.9 GB in bf16): bound by
// bytes on the tensor cores (0.54 / 0.27 ms), as fused_stack_mma's forward
// (PERF.md §6, rows 5c/9c). The r2b variants keep x in shared memory for
// all 30 layers, so they move 2 x 19.5 MB of x and their weights: base
// is bound by operations (0.28 ms in 3xTF32), and every variant with
// products in bf16 by operations at 989 TFLOP/s (fat_1t: 0.114 ms). What the probes attribute:
// the records (full - nodma), the tap loads (full - noshift, rolled), the
// products and gate (mxu), against a stack with no per-layer round trip
// of x (r2b base).
//
// Registers a thread (ptxas -v for sm_90a), no spills: the r2 variants as
// fused_stack_mma's forward (f32 86-117 at width 32, 124-140 at 64; bf16
// 68-84 and 117-124); r2b at 64 / 128 rows f32 88-94 / 111-140, bf16
// 71-83 / 93-96, act_only 28.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "fused_stack_mma_fwd.cuh"

namespace {

constexpr int kUnsupported = 1000;

// ---------------------------------------------------------------------------
// r2_fwd_bisect: fused_stack_mma's forward with parts masked
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

template <class P, int R, int V = 0>
int layers_dispatch(int variant, const float* x, const float* w_fg,
                    const float* wd, const float* add, const float* bd,
                    const int* dil, float* y, void* fg, void* z, float* xbuf,
                    int B, int T, int L, cudaStream_t st) {
  if constexpr (V < kNumLayerVariants) {
    using Rec = typename P::Rec;
    if (variant == V)
      return forward_impl<P, R, kLayerVariants[V]>(
          x, w_fg, wd, add, bd, dil, y, static_cast<Rec*>(fg),
          static_cast<Rec*>(z), xbuf, B, T, L, st);
    return layers_dispatch<P, R, V + 1>(variant, x, w_fg, wd, add, bd, dil,
                                        y, fg, z, xbuf, B, T, L, st);
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

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The layout of mode P at BM rows a block (R = D = 32). Op: the element of
// the weights and of the operand tiles. A tiles (cat, z, fat) have rows
// padded by 16 bytes (conflict-free A fragments); raw weight rows by 8
// elements (conflict-free B fragments, 16-byte rows for cp.async); the
// float32 residual by 8 floats (conflict-free float2 epilogues).
template <class P, int BM, int V>
struct StackCfg {
  using Op = std::conditional_t<P::kBf16, __nv_bfloat16, float>;
  static constexpr int R = 32, D = 32, K1 = 2 * R, N1 = 2 * D;
  static constexpr int KF = 2 * R + 2 * D, NF = 2 * D + R;
  static constexpr bool kFatV = V == kFat || V == kFat1t;
  static constexpr int MT = BM / 16;        // m-tiles
  static constexpr int WPM = NW / MT;       // warps an m-tile
  static constexpr int NQ = D / 8 / WPM;    // n-tiles a warp, a part
  static constexpr int SC = padded<K1, Op>(), SZ = padded<D, Op>();
  static constexpr int SF = padded<KF, Op>();
  static constexpr int SW1 = N1 + 8, SW2 = R + 8, SWF = NF + 8;
  static constexpr int RS = R + 8;
  static constexpr int kOp = (int)sizeof(Op);
  // A weight stage (elements): w_fg and wd, or wfat.
  static constexpr int kWStage = kFatV ? KF * SWF : K1 * SW1 + D * SW2;
  static constexpr int kCur = 4 * BM * RS;
  static constexpr int kTiles = kFatV ? kOp * BM * SF
                                      : kCur + kOp * BM * (SC + SZ);
  static constexpr int kSmem = V == kActOnly ? 4 * BM * R
                                             : kTiles + 2 * kOp * kWStage;
  static_assert(MT * WPM == NW && NQ * WPM * 8 == D, "warp map");
  static_assert(kSmem <= kBlockSmem, "shared memory");
  static_assert(kCur % 16 == 0 && (kOp * BM * SC) % 16 == 0 &&
                (kOp * BM * SZ) % 16 == 0 && (kOp * BM * SF) % 16 == 0 &&
                (kOp * kWStage) % 16 == 0 && (kOp * K1 * SW1) % 16 == 0,
                "16-byte aligned parts");
};

// K rows of N elements of a row-major [K][N] array into rows of stride S,
// by cp.async.
template <int K, int N, int S, typename E>
__device__ __forceinline__ void copy_rows(E* dst, const E* src) {
  constexpr int PER = 16 / (int)sizeof(E), CH = N / PER;
  for (int i = threadIdx.x; i < K * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    cp_async16(dst + r * S + PER * c, src + (size_t)r * N + PER * c, true);
  }
}

// One block: BM of the M = B*T rows (x, y [M, R]), all L layers. Warp w
// owns rows 16 (w / WPM) .. of the block and, of each product part, the
// n-tiles NQ (w % WPM) ..; the filter and gate columns a thread holds pair
// up, so the gate runs in registers.
template <class P, int BM, int V>
__global__ void __launch_bounds__(NT, 1) stack_mma_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const typename StackCfg<P, BM, V>::Op* __restrict__ w_fg,
    const typename StackCfg<P, BM, V>::Op* __restrict__ wd,
    const typename StackCfg<P, BM, V>::Op* __restrict__ wfat, int M, int L) {
  using C = StackCfg<P, BM, V>;
  using Op = typename C::Op;
  using W = typename P::W;
  constexpr int R = C::R, D = C::D, K1 = C::K1, N1 = C::N1, KF = C::KF,
                NF = C::NF, NQ = C::NQ, RS = C::RS, SC = C::SC, SZ = C::SZ,
                SF = C::SF, SW1 = C::SW1, SW2 = C::SW2, SWF = C::SWF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = w / C::WPM, h = w % C::WPM;
  const int m0 = blockIdx.x * BM;

  if constexpr (V == kActOnly) {
    float* s_cur = reinterpret_cast<float*>(smem_raw);   // [BM][R]
    for (int i = tid; i < BM * R; i += NT) {
      const int m = m0 + i / R;
      s_cur[i] = m < M ? x[(size_t)m * R + i % R] : 0.f;
    }
    for (int l = 0; l < L; ++l) {
      __syncthreads();
      for (int i = tid; i < BM * R; i += NT) {
        const float v = s_cur[i];
        s_cur[i] = v + tanhf(v) * sigmoidf(v);
      }
    }
    __syncthreads();
    for (int i = tid; i < BM * R; i += NT) {
      const int m = m0 + i / R;
      if (m < M) y[(size_t)m * R + i % R] = s_cur[i];
    }
    return;
  } else {
    Op* s_wbuf = reinterpret_cast<Op*>(smem_raw + C::kTiles);  // 2 stages
    auto stage = [&](int l) {
      Op* dst = s_wbuf + (l & 1) * C::kWStage;
      if constexpr (C::kFatV) {
        copy_rows<KF, NF, SWF>(dst, wfat + (size_t)l * KF * NF);
      } else {
        copy_rows<K1, N1, SW1>(dst, w_fg + (size_t)l * K1 * N1);
        copy_rows<D, R, SW2>(dst + K1 * SW1, wd + (size_t)l * D * R);
      }
    };
    stage(0);
    cp_async_commit();

    if constexpr (C::kFatV) {
      Op* s_fat = reinterpret_cast<Op*>(smem_raw);   // [BM][SF] [0|cur|0|z]
      for (int i = tid; i < BM * KF; i += NT) {
        const int r = i / KF, k = i % KF, m = m0 + r;
        float v = 0.f;
        if (k >= R && k < 2 * R && m < M) v = x[(size_t)m * R + k - R];
        s_fat[r * SF + k] = from_f<Op>(v);
      }
      for (int l = 0; l < L; ++l) {
        cp_async_wait<0>();
        __syncthreads();   // weights l and the layer's tile visible
        if (l + 1 < L) stage(l + 1);
        cp_async_commit();
        const Op* s_w = s_wbuf + (l & 1) * C::kWStage;
        // out = fat @ wfat[l]: filter, gate and residual n-tiles.
        float acc[3 * NQ][4];
#pragma unroll
        for (int j = 0; j < 3 * NQ; ++j) zero(acc[j]);
#pragma unroll
        for (int ks = 0; ks < KF / P::KS; ++ks) {
          typename P::A a;
          afrag<SF>(s_fat, 16 * mt, ks * P::KS, lane, a);
          W bw[3 * NQ];
#pragma unroll
          for (int j = 0; j < 3 * NQ; ++j)
            bfrag<SWF>(s_w, ks * P::KS,
                       8 * ((j / NQ) * (D / 8) + NQ * h + j % NQ), lane,
                       bw[j]);
          mma_n(acc, a, bw);
        }
        __syncthreads();   // every read of the fat tile is done
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int col = 8 * (NQ * h + j) + 2 * q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * mt + g + 8 * half;
            store2(s_fat + r * SF + R + col, acc[2 * NQ + j][2 * half],
                   acc[2 * NQ + j][2 * half + 1]);
            store2(s_fat + r * SF + 2 * R + D + col,
                   gate<V>(acc[j][2 * half], acc[NQ + j][2 * half]),
                   gate<V>(acc[j][2 * half + 1], acc[NQ + j][2 * half + 1]));
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < BM * R; i += NT) {
        const int r = i / R, m = m0 + r;
        if (m < M) y[(size_t)m * R + i % R] = tof(s_fat[r * SF + R + i % R]);
      }
    } else {
      float* s_cur = reinterpret_cast<float*>(smem_raw);          // [BM][RS]
      Op* s_cat = reinterpret_cast<Op*>(smem_raw + C::kCur);     // [BM][SC]
      Op* s_z = s_cat + BM * SC;                                  // [BM][SZ]
      for (int i = tid; i < BM * R; i += NT) {
        const int r = i / R, m = m0 + r;
        s_cur[r * RS + i % R] = m < M ? x[(size_t)m * R + i % R] : 0.f;
      }
      for (int i = tid; i < BM * SC; i += NT) s_cat[i] = from_f<Op>(0.f);
      for (int l = 0; l < L; ++l) {
        cp_async_wait<0>();
        __syncthreads();   // weights l visible; the last layer's z reads done
        if (l + 1 < L) stage(l + 1);
        cp_async_commit();
        const Op* s_w1 = s_wbuf + (l & 1) * C::kWStage;
        const Op* s_w2 = s_w1 + K1 * SW1;
        {
          // fg = cat @ w_fg: filter n-tiles, then their gate n-tiles.
          float acc[2 * NQ][4];
#pragma unroll
          for (int j = 0; j < 2 * NQ; ++j) zero(acc[j]);
#pragma unroll
          for (int ks = 0; ks < K1 / P::KS; ++ks) {
            typename P::A a;
            afrag<SC>(s_cat, 16 * mt, ks * P::KS, lane, a);
            W bw[2 * NQ];
#pragma unroll
            for (int j = 0; j < 2 * NQ; ++j)
              bfrag<SW1>(s_w1, ks * P::KS,
                         8 * ((j / NQ) * (D / 8) + NQ * h + j % NQ), lane,
                         bw[j]);
            mma_n(acc, a, bw);
          }
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int col = 8 * (NQ * h + j) + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 16 * mt + g + 8 * half;
              store2(s_z + r * SZ + col,
                     gate<V>(acc[j][2 * half], acc[NQ + j][2 * half]),
                     gate<V>(acc[j][2 * half + 1],
                             acc[NQ + j][2 * half + 1]));
            }
          }
        }
        __syncthreads();   // the z tile is whole
        {
          // cur += z @ wd; each (row, column) of cur belongs to one thread.
          float acc[NQ][4];
#pragma unroll
          for (int j = 0; j < NQ; ++j) zero(acc[j]);
#pragma unroll
          for (int ks = 0; ks < D / P::KS; ++ks) {
            typename P::A a;
            afrag<SZ>(s_z, 16 * mt, ks * P::KS, lane, a);
            W bw[NQ];
#pragma unroll
            for (int j = 0; j < NQ; ++j)
              bfrag<SW2>(s_w2, ks * P::KS, 8 * (NQ * h + j), lane, bw[j]);
            mma_n(acc, a, bw);
          }
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int col = 8 * (NQ * h + j) + 2 * q;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* p = reinterpret_cast<float2*>(
                  s_cur + (16 * mt + g + 8 * half) * RS + col);
              float2 v = *p;
              v.x += acc[j][2 * half];
              v.y += acc[j][2 * half + 1];
              *p = v;
            }
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < BM * R; i += NT) {
        const int r = i / R, m = m0 + r;
        if (m < M) y[(size_t)m * R + i % R] = s_cur[r * RS + i % R];
      }
    }
  }
}

template <class P, int BM, int V>
int stack_impl(const float* x, float* y, const void* w_fg, const void* wd,
               const void* wfat, int M, int L, cudaStream_t st) {
  using C = StackCfg<P, BM, V>;
  using Op = typename C::Op;
  cudaError_t e = cudaFuncSetAttribute(
      stack_mma_kernel<P, BM, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return (int)e;
  stack_mma_kernel<P, BM, V><<<(M + BM - 1) / BM, NT, C::kSmem, st>>>(
      x, y, static_cast<const Op*>(w_fg), static_cast<const Op*>(wd),
      static_cast<const Op*>(wfat), M, L);
  return (int)cudaGetLastError();
}

template <class P, int BM, int V = 0>
int stack_dispatch(int variant, const float* x, float* y, const void* w_fg,
                   const void* wd, const void* wfat, int M, int L,
                   cudaStream_t st) {
  if constexpr (V < kNumStack) {
    if (variant == V)
      return stack_impl<P, BM, V>(x, y, w_fg, wd, wfat, M, L, st);
    return stack_dispatch<P, BM, V + 1>(variant, x, y, w_fg, wd, wfat, M, L,
                                        st);
  } else {
    return kUnsupported;
  }
}

}  // namespace

extern "C" {

// Widths the r2 probe's tensor-core mode is built for: fused_stack_mma's,
// R == D in {32, 64}.
int fwd_bisect_mma_supports_width(int R, int D) {
  return R == D && (R == 32 || R == 64);
}

// One call of r2_fwd_bisect's variant ``variant`` (0 full, 1 noshift,
// 2 nodma, 3 bare, 4 mxu, 5 rolled, 6 rolled_nodma) on fused_stack_mma's
// forward in its f32 (bf16 = 0) or bf16 mode: L launches. The arguments of
// fused_stack_mma_fwd_f32 (float32 weights, rounded in the kernel in bf16
// mode); fg [B,T,L*2D] and z [B,T,L*D] in the mode's record type, unused
// by the variants without records. Returns 0, a CUDA error code, or 1000
// for a width or variant not built.
int fwd_bisect_mma_run(int variant, int bf16, const float* x,
                       const float* w_fg, const float* wd, const float* add,
                       const float* bd, const int* dil, float* y, void* fg,
                       void* z, float* xbuf, int B, int T, int L, int R,
                       int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!fwd_bisect_mma_supports_width(R, D)) return kUnsupported;
  if (bf16)
    return R == 32 ? layers_dispatch<Bf16, 32>(variant, x, w_fg, wd, add,
                                               bd, dil, y, fg, z, xbuf, B, T,
                                               L, st)
                   : layers_dispatch<Bf16, 64>(variant, x, w_fg, wd, add,
                                               bd, dil, y, fg, z, xbuf, B, T,
                                               L, st);
  return R == 32 ? layers_dispatch<Tf32x3, 32>(variant, x, w_fg, wd, add, bd,
                                               dil, y, fg, z, xbuf, B, T, L,
                                               st)
                 : layers_dispatch<Tf32x3, 64>(variant, x, w_fg, wd, add, bd,
                                               dil, y, fg, z, xbuf, B, T, L,
                                               st);
}

// One launch of r2_fwd_bisect2's variant ``variant`` (0 base, 1 mm_only,
// 2 act_only, 3 one_tanh, 4 fat, 5 fat_1t) on the tensor cores at 64
// (rows128 = 0) or 128 rows a block. x, y [M, R] float32 (M = B*T rows);
// w_fg [L,2R,2D], wd [L,D,R], wfat [L,2R+2D,2D+R] in float32 (f32, 3xTF32)
// or bf16 (bf16 = 1). R == D == 32 only.
int fwd_bisect2_mma_run(int variant, int rows128, int bf16, const float* x,
                        const void* w_fg, const void* wd, const void* wfat,
                        float* y, int M, int L, int R, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R != 32 || D != 32) return kUnsupported;
  if (bf16)
    return rows128 ? stack_dispatch<Bf16, 128>(variant, x, y, w_fg, wd, wfat,
                                               M, L, st)
                   : stack_dispatch<Bf16, 64>(variant, x, y, w_fg, wd, wfat,
                                              M, L, st);
  return rows128 ? stack_dispatch<Tf32x3, 128>(variant, x, y, w_fg, wd, wfat,
                                               M, L, st)
                 : stack_dispatch<Tf32x3, 64>(variant, x, y, w_fg, wd, wfat,
                                              M, L, st);
}

}  // extern "C"
