// fused_stack_tiled: the whole dilated stack of a training step, forward
// and backward, on Hopper's tensor cores (filter_width 2), at every width
// the TPU kernel takes whose weights the route does not keep in shared
// memory: R = D = 128, 256 and any multiple of 128, R != D, and R = D in
// {1, 2, 4} (the widths are runtime arguments; the tiles are fixed and
// their ragged edges masked). Two modes of one source, the precision a
// template parameter:
// - f32 (float32 parity, 3xTF32; records float32): fused_stack_tiled_*_f32;
// - bf16 (bf16 operands, float32 accumulation and residual; fg and z
//   records bf16): fused_stack_tiled_*_bf16.
// The C entry points take any R >= 1 and the D of the TPU kernel's
// supports (1, 2, 4, ..., 64 or a multiple of 128) and return
// kUnsupportedWidth at any other width (fused_stack_tiled_supports_width).
//
// Replaces, at those widths, the TPU (Pallas) kernel pair of the JAX
// package
//   wavenet_tpu/kernels/fused_stack3.py:105  _fwd_kernel
//   wavenet_tpu/kernels/fused_stack3.py:276  _bwd_kernel
// in both of its compute dtypes, beside fused_stack_mma.cu (R = D = 32,
// 64) and fused_stack.cu (8, 16), whose weights stay resident in shared
// memory. The same products also serve, at every width R, D >= 1:
//   wavenet_tpu/experiments/fused_stack.py:69, :170 (the retired v1
//     stack: the fused_stack_tiled_v1_* entries, no z record) wherever
//     fused_stack_carry.cu is not built, and
//   wavenet_tpu/experiments/dilated_layer.py:68, :82 (one gated layer:
//     the fused_stack_tiled_layer_* entries, below) wherever
//     dilated_layer.cu is not built.
// It computes what they compute: per layer l with dilation d,
//   fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
//   z  = tanh(fg_f) * sigmoid(fg_g)
//   x' = x + (z @ wd[l] + bd[l])                    (bf16: (x + z @ wd) + bd)
// emitting y, fg [B, T, L*2D] and z [B, T, L*D]; the backward rebuilds each
// layer's input by subtraction, x = (x' - z @ wd) - bd, with z recomputed
// from the fg record, and sums the weight gradients over rows in a fixed
// order (per-block partial sums, then a pass that adds them in block
// order; no float atomics: repeated calls are bitwise equal). bf16 mode,
// as the TPU kernel at kernel_dtype = bfloat16: every product's operands
// (the weights, the tap matrix, z, dx_{l+1}, the rebuilt input, da) are
// rounded to bf16 to nearest even as their fragments load; the residual,
// fg's sum, the gate, da, dx and every gradient stay float32.
//
// What bounds it. At the sharded config (80 layers, R = D = 256) on
// b1 x 24,186 rows the forward does 1.27e12 FLOPs and the backward 2.79e12;
// they move 6.1 and 6.2 GB in f32 (3.1 and 3.3 GB in bf16). Both are bound
// by operations in both modes: at 3xTF32 (495 / 3 = 165 TFLOP/s) 7.7 and
// 16.9 ms, at bf16 (989 TFLOP/s) 1.3 and 2.8 ms (PERF.md §6). At these
// widths w_fg alone is 1 MB a layer in f32 (256 KB at 128), so the weights
// cannot stay resident as the narrower kernels keep them: every product is
// a tiled matrix product whose operands stream through shared memory in
// k-tiles, and each layer is a few such products of GEMM shape (M = B*T
// rows, K and N the widths). At a width that is not a multiple of the
// tile the padding is work that no bound counts (at R = D = 1 a tile
// computes one of its 4,096 outputs); no config of the repo has such a
// width, so the tiles stay those of the wide ones.
//
// Design: one tiled kernel template (tiled_kernel) and one operation
// struct per product, which says where an operand tile's rows come from
// (the gather of the tap matrix, the shifted gradient tap) and what the
// epilogue does. A block computes a 64 x 64 tile of the output with 4 warps
// (2 x 2, each 32 x 32: two m16 by four n8 mma.sync tiles), over k-tiles of
// 32 that cp.async brings into a 3-stage ring of shared memory, zero-filled
// where a row lies outside its batch row, its chunk or [0, T), and past
// the operand's edge. Every grid is a ceiling of its extent over the tile,
// so a width that is not a multiple of 64 (or of 32, the gate's pairs)
// leaves a ragged last tile: its rows, columns and k past an edge load as
// zeros, and its epilogue stores and column sums stop at the edge. A
// launch takes one of two edge modes (kEdge, from R and D): at R and D
// multiples of 64 only the rows of B*T and a contraction's chunk end cut
// a tile, so the other edges go unchecked and a cp.async copies 16 bytes
// (checking every edge slowed the sharded width's forward by 2-4% on an
// H100); at every other width (R = 48, R = 6, R = D = 1, ...) every edge
// is checked and a cp.async copies 4 bytes, so that no row start need be
// aligned (these widths are in no config of the repo, and this mode is
// right, not fast). Each epilogue stores a thread's
// two adjacent columns together (the second skipped at an odd edge):
// storing them apart slowed the sharded width's backward by 3-4% on an
// H100. Operands stay
// float32 in shared memory; the f32 mode splits each fragment into TF32
// hi/lo as it loads (tf32_mma.cuh) and runs three mma.sync m16n8k8
// passes, the bf16 mode rounds and pairs it (bf16_mma.cuh) for one
// mma.sync m16n8k16 pass. The tensor core sums one k-tile in a zeroed
// accumulator, which a float32 add takes into the block's sum (the row
// contractions sum ~24k rows; the tensor core's own accumulation strays
// further from float64 than a float32 sum). Shared rows are padded to 4
// (mod 32) or 8 (mod 32) words, so the fragment loads of f32 are free of
// bank conflicts.
// - Forward, two launches a layer. (F1) fg: the A tile is gathered as
//   [x(t-d) | x(t)] from the layer's input; a block owns 32 filter columns
//   and the 32 gate columns that pair with them, a warp 16 of each, so the
//   gate is the epilogue, which writes the fg and z records (and, in bf16,
//   z as float32 for (F2)); at D < 32, or D not a multiple of 32, the last
//   block masks both halves at the same filter column. (F2) x' = x + z @
//   wd + bd, reading z from the record (f32) or its float copy (bf16: the
//   rounded z that the TPU kernel multiplies); y is the running x, updated
//   in place.
// - Backward, seven launches a layer: (A) dz_tot = dz + dx_{l+1} @ wd^T,
//   epilogue da = dz_tot * dz/dfg and z from the fg record, both to scratch;
//   (X) x_l = (x_{l+1} - z @ wd) - bd in place; (W1) dwd = z^T @ dx_{l+1}
//   and dbd = sum dx_{l+1}, and (W2) dw_fg = [x(t-d) | x]^T @ da and dadd =
//   sum_t da, as per-block partials over chunks of one batch row's rows;
//   (DX) dx_l = dx_{l+1} + [da(t) | da(t+d)] @ [w_fg[R:]^T ; w_fg[:R]^T],
//   one product of depth 4D whose A tile gathers the shifted tap (no tmp
//   scratch), dx the running gradient, updated in place; (R1), (R2) add the
//   partials in block order into dwd, dbd and dw_fg, dadd.
// So a call launches 2L kernels forward and 7L backward; the wrapper
// counts one launch a call. Making it fast (wgmma, TMA, a persistent
// schedule, fewer launches) is later work (ROADMAP b2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "stack_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;   // output tile, k-tile
constexpr int NT = 128;                    // 4 warps: 2 (rows) x 2 (columns)
constexpr int NSTAGE = 3;
constexpr int SA = BK + 4;                 // row stride of a [64][BK] tile
constexpr int ST = BM + 8;                 // row stride of a [BK][64] tile
constexpr int kTileFloats = BM * SA;       // either tile form
static_assert(BM * SA == BK * ST, "both tile forms take one slot");
constexpr int kSmemBytes = NSTAGE * 2 * kTileFloats * (int)sizeof(float);
// Blocks a row contraction aims at across its chunks (two waves of 132).
constexpr int kContractBlocks = 264;

// The two modes. KS: the k of one mma.sync; A, Bf: a lane's fragments;
// Rec: the element of the fg and z records.
struct F32 {
  static constexpr bool kBf16 = false;
  static constexpr bool kLayer = false;
  static constexpr int KS = 8;
  using A = Tf32Frag;
  using Bf = uint4;                        // {hi(b0), hi(b1), lo(b0), lo(b1)}
  using Rec = float;
};

struct BF16 {
  static constexpr bool kBf16 = true;
  static constexpr bool kLayer = false;
  static constexpr int KS = 16;
  using A = Bf16Frag;
  using Bf = uint2;                        // {b0, b1}: bf16 pairs along k
  using Rec = __nv_bfloat16;
};

// TPU kernel 8, one gated layer (the layer entries below): the products of
// F32 or BF16, float32 fg and z (the forward writes z alone, the backward's
// recompute fg alone: a null record is not written), and in bf16 the
// layer's own rule, which rounds its inputs x, dy and dz to bf16 first.
struct F32Layer : F32 {
  static constexpr bool kLayer = true;
};
struct BF16Layer : BF16 {
  static constexpr bool kLayer = true;
  using Rec = float;
};

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A fragment of rows m0.. and columns k0.. of the A operand, from a
// row-major [64][SA] tile (kT false) or a k-major [BK][ST] tile, A[m][k] =
// s[k][m] (kT true).
template <bool kT>
__device__ __forceinline__ void load_a(const float* s, int m0, int k0,
                                       int lane, Tf32Frag& a) {
  if constexpr (kT) afrag_t<ST>(s, m0, k0, lane, a);
  else afrag<SA>(s, m0, k0, lane, a);
}

template <bool kT>
__device__ __forceinline__ void load_a(const float* s, int m0, int k0,
                                       int lane, Bf16Frag& a) {
  if constexpr (kT) {
    afrag16_t<ST, 16>(s, m0, k0, lane, a);
  } else {
    const float* p = s + m0 * SA + k0;
    afrag16<SA>(p, p + 8, lane, a);
  }
}

// A B fragment of rows k0.. and columns n0.. of the B operand, from a
// k-major [BK][ST] tile, B[k][n] = s[k][n] (kT false), or an n-major
// [64][SA] tile, B[k][n] = s[n][k] (kT true).
template <bool kT>
__device__ __forceinline__ void load_b(const float* s, int k0, int n0,
                                       int lane, uint4& b) {
  if constexpr (kT) {
    const int g = lane >> 2, q = lane & 3;
    const float* p = s + (n0 + g) * SA + k0 + q;
    tf32_split(p[0], b.x, b.z);
    tf32_split(p[4], b.y, b.w);
  } else {
    bfrag<ST>(s, k0, n0, lane, b);
  }
}

template <bool kT>
__device__ __forceinline__ void load_b(const float* s, int k0, int n0,
                                       int lane, uint2& b) {
  if constexpr (kT) {
    const int g = lane >> 2, q = lane & 3;
    const float* p = s + (n0 + g) * SA + k0 + 2 * q;
    b.x = pack_bf16(p[0], p[1]);
    b.y = pack_bf16(p[8], p[9]);
  } else {
    bfrag16<ST>(s, k0, n0, lane, b);
  }
}

__device__ __forceinline__ void mma_n(float (&c)[4][4], const Tf32Frag& a,
                                      const uint4 (&b)[4]) {
  mma3_tf32_n<4>(c, a.hi, a.lo, b);
}
__device__ __forceinline__ void mma_n(float (&c)[4][4], const Bf16Frag& a,
                                      const uint2 (&b)[4]) {
  mma_bf16_n<4>(c, a, b);
}

// 4 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

// 4 consecutive floats of a tile, 4 bytes a copy: at(e) the source of
// float e, or nullptr for a zero.
template <class F>
__device__ __forceinline__ void fill4(float* dst, F at) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* p = at(e);
    if (p) cp_async4(dst + e, p);
    else dst[e] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// The tiled product. Op says:
//   kAT / kBT: the tile forms of A and B (see load_a, load_b);
//   kPair: the block's 64 columns are 32 filter and the 32 gate columns
//     that pair with them (a warp holds 16 of each, so a thread holds both
//     halves of a gate);
//   kColSum: the blocks of the first row of the grid also sum B's columns
//     over their rows (the bias gradients), in row order;
//   M, N: the output's extent, rows and columns (with kPair, N is D, the
//     filter columns: GEMM column n is filter column pair_col(n) of the
//     filter or the gate half);
//   kChunk, k_range(kb, ke): the k extent of this block (a product's depth,
//     or with kChunk a row contraction's chunk of one batch row);
//   a_src(m, k): the address of A[m][k], or nullptr where the gather gives
//     a zero; called for m < M, k < ke only (the kernel zero-fills the
//     rest). Without kEdge it stands for A[m][k..k+3] (kAT false) or
//     A[m..m+3][k] (kAT true). b_src(k, n) likewise for B[k][n], n < N;
//   store(m, n, v0, v1, two) the outputs (m, n) and, if two, (m, n + 1) (n
//     even); with kPair store_pair(m, j, f0, f1, g0, g1, two), j the
//     filter column; col_sums(n, s) with kColSum.
// ---------------------------------------------------------------------------

// The filter column of GEMM column n of a kPair product.
__device__ __forceinline__ int pair_col(int n) {
  return n / BN * (BN / 2) + n % (BN / 2);
}

// kEdge (ragged(R, D)): a width is not a multiple of 64, so every edge is
// checked and copied 4 bytes at a time. Without it R and D are multiples
// of 64: every group of four floats that the tiles load is whole (inside
// or outside every edge and every gather's split) and starts on 16 bytes.
template <class P, class Op, bool kEdge>
__global__ void __launch_bounds__(NT) tiled_kernel(const Op op) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wm = w >> 1, wn = w & 1;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int kb, ke;
  op.k_range(kb, ke);
  const int nk = (ke - kb + BK - 1) / BK;
  const bool colsum = Op::kColSum && blockIdx.y == 0;

  auto tile_a = [&](int kt) { return smem + (kt % NSTAGE) * 2 * kTileFloats; };
  auto tile_b = [&](int kt) { return tile_a(kt) + kTileFloats; };
  // The edges a tile can cross: always the rows of B*T and a chunk's end;
  // the others only where a width is not a multiple of 64 (kEdge).
  auto m_in = [&](int m) { return (Op::kChunk && !kEdge) || m < op.M; };
  auto k_in = [&](int k) { return (!Op::kChunk && !kEdge) || k < ke; };
  auto n_in = [&](int n) {
    if constexpr (!kEdge) return true;
    else if constexpr (Op::kPair) return pair_col(n) < op.N;
    else return n < op.N;
  };
  auto a_at = [&](int m, int k) {
    return m_in(m) && k_in(k) ? op.a_src(m, k) : nullptr;
  };
  auto b_at = [&](int k, int n) {
    return k_in(k) && n_in(n) ? op.b_src(k, n) : nullptr;
  };
  // 4 floats of a tile: fill4's four copies, or without kEdge one 16-byte
  // copy of at(0).
  auto load4 = [](float* dst, auto at) {
    if constexpr (kEdge) {
      fill4(dst, at);
    } else {
      const float* p = at(0);
      if (p) cp_async16(dst, p, true);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto issue = [&](int kt) {
    const int k0 = kb + kt * BK;
    float* sa = tile_a(kt);
    float* sb = tile_b(kt);
    for (int c = tid; c < BM * BK / 4; c += NT) {
      if constexpr (Op::kAT) {
        const int kr = c >> 4, mq = (c & 15) * 4;
        load4(sa + kr * ST + mq,
              [&](int e) { return a_at(m0 + mq + e, k0 + kr); });
      } else {
        const int r = c >> 3, kq = (c & 7) * 4;
        load4(sa + r * SA + kq,
              [&](int e) { return a_at(m0 + r, k0 + kq + e); });
      }
      if constexpr (Op::kBT) {
        const int n = c >> 3, kq = (c & 7) * 4;
        load4(sb + n * SA + kq,
              [&](int e) { return b_at(k0 + kq + e, n0 + n); });
      } else {
        const int kr = c >> 4, nq = (c & 15) * 4;
        load4(sb + kr * ST + nq,
              [&](int e) { return b_at(k0 + kr, n0 + nq + e); });
      }
    }
  };

  // The warp's n8 tiles (block columns 8 * ntile(j)).
  auto ntile = [&](int j) {
    if constexpr (Op::kPair) return j < 2 ? 2 * wn + j : 4 + 2 * wn + j - 2;
    else return 4 * wn + j;
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) zero(acc[i]);
  float cs = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // tile kt is in; every warp is done with kt - 1
    if (kt + NSTAGE - 1 < nk) issue(kt + NSTAGE - 1);
    cp_async_commit();
    const float* sa = tile_a(kt);
    const float* sb = tile_b(kt);
    if (colsum && tid < BN)
      for (int r = 0; r < BK; ++r) cs += sb[r * ST + tid];
    float c[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) zero(c[i]);
#pragma unroll
    for (int ks = 0; ks < BK / P::KS; ++ks) {
      typename P::A a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a<Op::kAT>(sa, 32 * wm + 16 * i, ks * P::KS, lane, a[i]);
      typename P::Bf b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_b<Op::kBT>(sb, ks * P::KS, 8 * ntile(j), lane, b[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_n(c[i], a[i], b);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += c[i][j][e];
  }
  cp_async_wait<0>();

  if constexpr (Op::kColSum) {
    if (colsum && tid < BN && n_in(n0 + tid)) op.col_sums(n0 + tid, cs);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 32 * wm + 16 * i + g + 8 * half;
      if (!m_in(m)) continue;
      if constexpr (Op::kPair) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = blockIdx.x * (BN / 2) + 16 * wn + 8 * j + 2 * q;
          if (kEdge && col >= op.N) continue;
          op.store_pair(m, col, acc[i][j][2 * half], acc[i][j][2 * half + 1],
                        acc[i][j + 2][2 * half], acc[i][j + 2][2 * half + 1],
                        !kEdge || col + 1 < op.N);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * ntile(j) + 2 * q;
          if (!n_in(n)) continue;
          op.store(m, n, acc[i][j][2 * half], acc[i][j][2 * half + 1],
                   n_in(n + 1));
        }
      }
    }
  }
}

// Rows of a row-major [B*T] operand, as a GEMM's M.
struct RowsOp {
  static constexpr bool kChunk = false;
  int M, N, K;
  __device__ void k_range(int& kb, int& ke) const {
    kb = 0;
    ke = K;
  }
};

// (F1): fg = [x(t-d) | x(t)] @ w_fg + add, z = tanh(f) sigmoid(g). The
// GEMM's N order is the blocks' (filter 32, gate 32) pairs; N = D.
template <class P>
struct FwdGateOp : RowsOp {
  static constexpr bool kAT = false, kBT = false, kPair = true,
                        kColSum = false;
  using Rec = typename P::Rec;
  const float* x;        // [B*T, R], the layer's input
  const float* w;        // w_fg[l] [2R][2D]
  const float* add;      // add[l] [B][2D]
  Rec* fg;               // the layer's fg record columns, row stride fg_ld
  Rec* z;                // the layer's z record columns, row stride z_ld
  float* zf;             // bf16 stack: z rounded, as float [B*T, D]
  int T, R, D, d;
  size_t fg_ld, z_ld;
  __device__ const float* a_src(int m, int k) const {
    if (k >= R) return x + (size_t)m * R + (k - R);
    return m % T >= d ? x + (size_t)(m - d) * R + k : nullptr;
  }
  __device__ const float* b_src(int k, int n) const {
    const int col = pair_col(n);
    return w + (size_t)k * 2 * D + (n % BN < BN / 2 ? col : D + col);
  }
  __device__ void store_pair(int m, int j, float f0, float f1, float g0,
                             float g1, bool two) const {
    const float* ab = add + (size_t)(m / T) * 2 * D;
    const float fv[2] = {f0 + ab[j], two ? f1 + ab[j + 1] : 0.f};
    const float gv[2] = {g0 + ab[D + j], two ? g1 + ab[D + j + 1] : 0.f};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c && !two) break;
      const float zv = tanhf(fv[c]) * sigmoidf(gv[c]);
      if (!P::kLayer || fg) {
        put(fg + (size_t)m * fg_ld + j + c, fv[c]);
        put(fg + (size_t)m * fg_ld + D + j + c, gv[c]);
      }
      if (!P::kLayer || z) put(z + (size_t)m * z_ld + j + c, zv);
      if constexpr (P::kBf16 && !P::kLayer)
        zf[(size_t)m * D + j + c] = __bfloat162float(__float2bfloat16_rn(zv));
    }
  }
};

// (F2): x' = x + (z @ wd + bd) (f32) or (x + z @ wd) + bd (bf16, the TPU
// kernel's order); x' may be x. N = R.
template <class P>
struct FwdResOp : RowsOp {
  static constexpr bool kAT = false, kBT = false, kPair = false,
                        kColSum = false;
  const float* zs;       // z as float, row stride z_ld
  const float* wd;       // wd[l] [D][R]
  const float* bd;       // bd[l] [R]
  const float* xin;      // [B*T, R]
  float* xout;
  size_t z_ld;
  __device__ const float* a_src(int m, int k) const {
    return zs + (size_t)m * z_ld + k;
  }
  __device__ const float* b_src(int k, int n) const {
    return wd + (size_t)k * N + n;
  }
  __device__ void store(int m, int n, float v0, float v1, bool two) const {
    const size_t o = (size_t)m * N + n;
    const float v[2] = {v0, v1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c && !two) break;
      if constexpr (P::kBf16) xout[o + c] = (xin[o + c] + v[c]) + bd[n + c];
      else xout[o + c] = xin[o + c] + (v[c] + bd[n + c]);
    }
  }
};

// (A): dz_tot = dz + dx_{l+1} @ wd^T; da = dz_tot * d z / d fg, and z from
// the fg record, both float32 to scratch. N = D.
template <class P>
struct BwdGateOp : RowsOp {
  static constexpr bool kAT = false, kBT = true, kPair = false,
                        kColSum = false;
  using Rec = typename P::Rec;
  const float* dc;       // dx_{l+1} [B*T, R]
  const float* wd;       // wd[l] [D][R]: B[k][n] = wd[n][k]
  const Rec* fg;         // the layer's fg record columns, row stride fg_ld
  const Rec* dz;         // the layer's dz columns, row stride z_ld
  float* da;             // [B*T, 2D]
  float* zs;             // [B*T, D]
  int R, D;
  size_t fg_ld, z_ld;
  __device__ const float* a_src(int m, int k) const {
    return dc + (size_t)m * R + k;
  }
  __device__ const float* b_src(int k, int n) const {
    return wd + (size_t)n * R + k;
  }
  __device__ void store(int m, int n, float v0, float v1, bool two) const {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c && !two) break;
      const int j = n + c;
      const float dzt = tof(dz[(size_t)m * z_ld + j]) + v[c];
      const float th = tanhf(tof(fg[(size_t)m * fg_ld + j]));
      const float sg = sigmoidf(tof(fg[(size_t)m * fg_ld + D + j]));
      da[(size_t)m * 2 * D + j] = dzt * sg * (1.f - th * th);
      da[(size_t)m * 2 * D + D + j] = dzt * th * sg * (1.f - sg);
      zs[(size_t)m * D + j] = th * sg;
    }
  }
};

// (X): x_l = (x_{l+1} - z @ wd) - bd; x_l may be x_{l+1}. N = R.
struct BwdInputOp : RowsOp {
  static constexpr bool kAT = false, kBT = false, kPair = false,
                        kColSum = false;
  const float* zs;       // [B*T, D]
  const float* wd;       // wd[l] [D][R]
  const float* bd;       // bd[l] [R]
  const float* xin;
  float* xout;
  int D;
  __device__ const float* a_src(int m, int k) const {
    return zs + (size_t)m * D + k;
  }
  __device__ const float* b_src(int k, int n) const {
    return wd + (size_t)k * N + n;
  }
  __device__ void store(int m, int n, float v0, float v1, bool two) const {
    const size_t o = (size_t)m * N + n;
    xout[o] = (xin[o] - v0) - bd[n];
    if (two) xout[o + 1] = (xin[o + 1] - v1) - bd[n + 1];
  }
};

// (DX): dx_l = dx_{l+1} + [da(t) | da(t+d)] @ [w_fg[R:]^T ; w_fg[:R]^T]
// (da(t+d) = 0 past the batch row's end); dx_l may be dx_{l+1}. N = R.
struct BwdDxOp : RowsOp {
  static constexpr bool kAT = false, kBT = true, kPair = false,
                        kColSum = false;
  const float* da;       // [B*T, 2D]
  const float* w;        // w_fg[l] [2R][2D]
  const float* din;
  float* dout;
  int T, D, d;
  __device__ const float* a_src(int m, int k) const {
    if (k < 2 * D) return da + (size_t)m * 2 * D + k;
    return m % T + d < T ? da + (size_t)(m + d) * 2 * D + (k - 2 * D)
                         : nullptr;
  }
  __device__ const float* b_src(int k, int n) const {
    return k < 2 * D ? w + (size_t)(N + n) * 2 * D + k
                     : w + (size_t)n * 2 * D + (k - 2 * D);
  }
  __device__ void store(int m, int n, float v0, float v1, bool two) const {
    const size_t o = (size_t)m * N + n;
    dout[o] = din[o] + v0;
    if (two) dout[o + 1] = din[o + 1] + v1;
  }
};

// (layer) One tap of a layer's input gradient: dx_local = dy + da @ w[1]^T,
// or dpast = da @ w[0]^T (din null). N = R, K = 2D.
struct TapDxOp : RowsOp {
  static constexpr bool kAT = false, kBT = true, kPair = false,
                        kColSum = false;
  const float* da;       // [B*T, 2D]
  const float* w;        // w[tap] [R][2D]: B[k][n] = w[n][k]
  const float* din;      // [B*T, R] or null
  float* dout;
  int D;
  __device__ const float* a_src(int m, int k) const {
    return da + (size_t)m * 2 * D + k;
  }
  __device__ const float* b_src(int k, int n) const {
    return w + (size_t)n * 2 * D + k;
  }
  __device__ void store(int m, int n, float v0, float v1, bool two) const {
    const size_t o = (size_t)m * N + n;
    dout[o] = din ? din[o] + v0 : v0;
    if (two) dout[o + 1] = din ? din[o + 1] + v1 : v1;
  }
};

// A row contraction C[M][N] = sum over rows of U[row]^T V[row], over the
// chunk of one batch row's rows that blockIdx.z names (z = b * nchunk + c,
// rows [c * rpc, min(T, (c + 1) * rpc))): a partial [M][N] per z, and the
// column sums of V.
struct ContractOp {
  static constexpr bool kAT = true, kBT = false, kPair = false,
                        kColSum = true, kChunk = true;
  int M, N, T, nchunk, rpc;
  float* part;           // [B * nchunk][M][N]
  float* csum;           // [B * nchunk][N]
  __device__ size_t row0() const {
    return (size_t)(blockIdx.z / nchunk) * T;
  }
  __device__ void k_range(int& kb, int& ke) const {
    const int c = blockIdx.z % nchunk;
    kb = c * rpc;
    ke = min(T, kb + rpc);
  }
  __device__ void store(int m, int n, float v0, float v1, bool two) const {
    float* p = part + ((size_t)blockIdx.z * M + m) * N + n;
    p[0] = v0;
    if (two) p[1] = v1;
  }
  __device__ void col_sums(int n, float s) const {
    csum[(size_t)blockIdx.z * N + n] = s;
  }
};

// (W1): dwd = z^T @ dx_{l+1}, dbd = sum dx_{l+1}. M = D, N = R.
struct DwdOp : ContractOp {
  const float* zs;       // [B*T, D]
  const float* dc;       // [B*T, R]
  __device__ const float* a_src(int m, int t) const {
    return zs + (row0() + t) * M + m;
  }
  __device__ const float* b_src(int t, int n) const {
    return dc + (row0() + t) * N + n;
  }
};

// (W2): dw_fg = [x(t-d) | x(t)]^T @ da, dadd = sum_t da. M = 2R, N = 2D.
struct DwfgOp : ContractOp {
  const float* x;        // x_l [B*T, R]
  const float* da;       // [B*T, 2D]
  int R, d;
  __device__ const float* a_src(int m, int t) const {
    if (m >= R) return x + (row0() + t) * R + (m - R);
    return t >= d ? x + (row0() + t - d) * R + m : nullptr;
  }
  __device__ const float* b_src(int t, int n) const {
    return da + (row0() + t) * N + n;
  }
};

// (R1), (R2): out[e] = sum over z of part[z][e] (e < nw), then the column
// sums: cs_out[grp][n] = sum over the grp's nper blocks of csum[.][n].
__global__ void __launch_bounds__(256) reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ csum,
    float* __restrict__ out, float* __restrict__ cs_out, int nsplit, int nw,
    int N, int ngrp, int nper) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < nw) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * nw + e];
    out[e] = s;
    return;
  }
  const int f = e - nw;
  if (f >= ngrp * N) return;
  const int grp = f / N, n = f % N;
  const float* p = csum + (size_t)grp * nper * N + n;
  float s = 0.f;
  for (int k = 0; k < nper; ++k) s += p[(size_t)k * N];
  cs_out[f] = s;
}

// (layer, bf16) out = in rounded to bf16 (to nearest even), as float.
__global__ void __launch_bounds__(256) round_bf16_kernel(
    const float* __restrict__ in, float* __restrict__ out, size_t n) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (size_t)gridDim.x * 256)
    out[i] = __bfloat162float(__float2bfloat16_rn(in[i]));
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The edge mode of every launch of a call at R, D (tiled_kernel's kEdge).
bool ragged(int r, int d) { return r % 64 != 0 || d % 64 != 0; }

template <class P, class Op>
cudaError_t launch(dim3 grid, const Op& op, bool edge, cudaStream_t st) {
  auto* k = edge ? &tiled_kernel<P, Op, true> : &tiled_kernel<P, Op, false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  k<<<grid, NT, kSmemBytes, st>>>(op);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part, const float* csum, float* out,
                          float* cs_out, int nsplit, int nw, int N, int ngrp,
                          int nper, cudaStream_t st) {
  const int n = nw + ngrp * N;
  reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, csum, out, cs_out,
                                                   nsplit, nw, N, ngrp, nper);
  return cudaGetLastError();
}

// Tiles of t over an extent n (the last ragged).
int tiles(int n, int t) { return (n + t - 1) / t; }

// A row contraction's chunks of one batch row: as many as bring the grid
// (ntile output tiles a chunk, B batch rows) to kContractBlocks, each a
// whole number of k-tiles. Fixed by the shape alone.
struct Chunks {
  int nchunk, rpc;
};
Chunks contract_chunks(int B, int T, int ntile) {
  int want = (kContractBlocks + ntile * B - 1) / (ntile * B);
  if (want < 1) want = 1;
  int rpc = (T + want - 1) / want;
  rpc = (rpc + BK - 1) / BK * BK;
  return {(T + rpc - 1) / rpc, rpc};
}

constexpr int kUnsupportedWidth = 1000;

// The TPU kernel's widths: any R; D whose 128-lane records pack (D and 2D
// divide 128 or are multiples of it: D in 1, 2, 4, ..., 64 or a multiple
// of 128).
bool supported(int r, int d) {
  return r > 0 && d > 0 && (128 % d == 0 || d % 128 == 0);
}

// z_record false (v1): z is one layer's [B*T, D], which each layer
// overwrites, not the record.
template <class P>
int forward_impl(const float* x, const float* w_fg, const float* wd,
                 const float* add, const float* bd, const int* dil, float* y,
                 typename P::Rec* fg, typename P::Rec* z, float* xbuf, int B,
                 int T, int L, int R, int D, cudaStream_t st,
                 bool z_record = true) {
  const int M = B * T, rows = tiles(M, BM);
  const bool edge = ragged(R, D);
  const size_t fg_ld = (size_t)L * 2 * D, z_ld = z_record ? (size_t)L * D : D;
  for (int l = 0; l < L; ++l) {
    typename P::Rec* zl = z + (z_record ? (size_t)l * D : 0);
    const float* xin = l == 0 ? x : y;
    FwdGateOp<P> f1;
    f1.M = M;
    f1.N = D;
    f1.K = 2 * R;
    f1.x = xin;
    f1.w = w_fg + (size_t)l * 2 * R * 2 * D;
    f1.add = add + (size_t)l * B * 2 * D;
    f1.fg = fg + (size_t)l * 2 * D;
    f1.z = zl;
    f1.zf = xbuf;
    f1.T = T;
    f1.R = R;
    f1.D = D;
    f1.d = dil[l];
    f1.fg_ld = fg_ld;
    f1.z_ld = z_ld;
    cudaError_t e = launch<P>(dim3(tiles(D, BN / 2), rows), f1, edge, st);
    if (e != cudaSuccess) return (int)e;
    FwdResOp<P> f2;
    f2.M = M;
    f2.N = R;
    f2.K = D;
    if constexpr (P::kBf16) {
      f2.zs = xbuf;
      f2.z_ld = D;
    } else {
      f2.zs = zl;
      f2.z_ld = z_ld;
    }
    f2.wd = wd + (size_t)l * D * R;
    f2.bd = bd + (size_t)l * R;
    f2.xin = xin;
    f2.xout = y;
    e = launch<P>(dim3(tiles(R, BN), rows), f2, edge, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The scratch of the backward, in floats: x_l, z, da, and the partials of
// the two row contractions (weights, then column sums).
struct BwdScratch {
  Chunks c1, c2;         // (W1), (W2)
  size_t xs, zs, da, p1, s1, p2, s2, total;
};
BwdScratch bwd_scratch(int B, int T, int R, int D) {
  BwdScratch s;
  const size_t M = (size_t)B * T;
  s.c1 = contract_chunks(B, T, tiles(D, BM) * tiles(R, BN));
  s.c2 = contract_chunks(B, T, tiles(2 * R, BM) * tiles(2 * D, BN));
  const size_t n1 = (size_t)B * s.c1.nchunk, n2 = (size_t)B * s.c2.nchunk;
  s.xs = 0;
  s.zs = s.xs + M * R;
  s.da = s.zs + M * D;
  s.p1 = s.da + M * 2 * D;
  s.s1 = s.p1 + n1 * D * R;
  s.p2 = s.s1 + n1 * R;
  s.s2 = s.p2 + n2 * 4 * R * D;
  s.total = s.s2 + n2 * 2 * D;
  return s;
}

template <class P>
int backward_impl(const float* y, const float* dy,
                  const typename P::Rec* fg, const typename P::Rec* dz,
                  const float* w_fg, const float* wd, const float* bd,
                  const int* dil, float* dx, float* dw_fg, float* dwd,
                  float* dadd, float* dbd, float* scratch, int B, int T,
                  int L, int R, int D, cudaStream_t st) {
  const int M = B * T, rows = tiles(M, BM);
  const bool edge = ragged(R, D);
  const BwdScratch s = bwd_scratch(B, T, R, D);
  float* xs = scratch + s.xs;
  float* zs = scratch + s.zs;
  float* da = scratch + s.da;
  const size_t fg_ld = (size_t)L * 2 * D, z_ld = (size_t)L * D;
  const int n1 = B * s.c1.nchunk, n2 = B * s.c2.nchunk;
  for (int l = L - 1; l >= 0; --l) {
    const float* dc = l == L - 1 ? dy : dx;
    const float* x_next = l == L - 1 ? y : xs;
    const float* wdl = wd + (size_t)l * D * R;
    const float* wl = w_fg + (size_t)l * 2 * R * 2 * D;
    const int d = dil[l];

    BwdGateOp<P> a;
    a.M = M;
    a.N = D;
    a.K = R;
    a.dc = dc;
    a.wd = wdl;
    a.fg = fg + (size_t)l * 2 * D;
    a.dz = dz + (size_t)l * D;
    a.da = da;
    a.zs = zs;
    a.R = R;
    a.D = D;
    a.fg_ld = fg_ld;
    a.z_ld = z_ld;
    cudaError_t e = launch<P>(dim3(tiles(D, BN), rows), a, edge, st);
    if (e != cudaSuccess) return (int)e;

    BwdInputOp xo;
    xo.M = M;
    xo.N = R;
    xo.K = D;
    xo.zs = zs;
    xo.wd = wdl;
    xo.bd = bd + (size_t)l * R;
    xo.xin = x_next;
    xo.xout = xs;
    xo.D = D;
    e = launch<P>(dim3(tiles(R, BN), rows), xo, edge, st);
    if (e != cudaSuccess) return (int)e;

    DwdOp w1;
    w1.M = D;
    w1.N = R;
    w1.T = T;
    w1.nchunk = s.c1.nchunk;
    w1.rpc = s.c1.rpc;
    w1.part = scratch + s.p1;
    w1.csum = scratch + s.s1;
    w1.zs = zs;
    w1.dc = dc;
    e = launch<P>(dim3(tiles(R, BN), tiles(D, BM), n1), w1, edge, st);
    if (e != cudaSuccess) return (int)e;

    DwfgOp w2;
    w2.M = 2 * R;
    w2.N = 2 * D;
    w2.T = T;
    w2.nchunk = s.c2.nchunk;
    w2.rpc = s.c2.rpc;
    w2.part = scratch + s.p2;
    w2.csum = scratch + s.s2;
    w2.x = xs;
    w2.da = da;
    w2.R = R;
    w2.d = d;
    e = launch<P>(dim3(tiles(2 * D, BN), tiles(2 * R, BM), n2), w2, edge,
                  st);
    if (e != cudaSuccess) return (int)e;

    BwdDxOp x2;
    x2.M = M;
    x2.N = R;
    x2.K = 4 * D;
    x2.da = da;
    x2.w = wl;
    x2.din = dc;
    x2.dout = dx;
    x2.T = T;
    x2.D = D;
    x2.d = d;
    e = launch<P>(dim3(tiles(R, BN), rows), x2, edge, st);
    if (e != cudaSuccess) return (int)e;

    e = launch_reduce(scratch + s.p1, scratch + s.s1, dwd + (size_t)l * D * R,
                      dbd + (size_t)l * R, n1, D * R, R, 1, n1, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_reduce(scratch + s.p2, scratch + s.s2,
                      dw_fg + (size_t)l * 4 * R * D,
                      dadd + (size_t)l * B * 2 * D, n2, 4 * R * D, 2 * D, B,
                      s.c2.nchunk, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// TPU kernel 8: one gated layer (x [B, T, R], w [2, R, 2D] = [2R][2D] as
// w_fg, wd [D, R], add [B, 2D], bd [R], dilation d), from the products
// above. Forward: (F1) into z alone, (F2) y = x + z @ wd + bd. Backward,
// from the inputs: (F1) recomputes fg, (A) da and z, (W1), (W2) the weight
// gradients (dw [2R][2D], dadd [B][2D]), and two taps of the input
// gradient apart, dx_local = dy + da @ w[1]^T and dpast = da @ w[0]^T (the
// caller shift-adds dpast, as the TPU kernel's wrapper does). In bf16 (the
// layer's own rule, BF16Layer) x, dy and dz are first rounded to bf16 into
// scratch, so that the residual, dbd and dx_local see them rounded.
// ---------------------------------------------------------------------------

cudaError_t launch_round(const float* in, float* out, size_t n,
                         cudaStream_t st) {
  const size_t blocks = (n + 255) / 256;
  round_bf16_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      st>>>(in, out, n);
  return cudaGetLastError();
}

// The layer's scratch, in floats: the rounded inputs (bf16: x forward; x,
// dy, dz backward), then backward fg, da, z and the partials of the two
// row contractions.
struct LayerScratch {
  Chunks c1, c2;
  size_t xr, dyr, dzr, fg, da, zs, p1, s1, p2, s2, total;
};
LayerScratch layer_scratch(bool backward, bool bf16, int B, int T, int R,
                           int D) {
  LayerScratch s{};
  const size_t M = (size_t)B * T;
  s.xr = 0;
  s.dyr = s.xr + (bf16 ? M * R : 0);
  if (!backward) {
    s.total = s.dyr;
    return s;
  }
  s.c1 = contract_chunks(B, T, tiles(D, BM) * tiles(R, BN));
  s.c2 = contract_chunks(B, T, tiles(2 * R, BM) * tiles(2 * D, BN));
  const size_t n1 = (size_t)B * s.c1.nchunk, n2 = (size_t)B * s.c2.nchunk;
  s.dzr = s.dyr + (bf16 ? M * R : 0);
  s.fg = s.dzr + (bf16 ? M * D : 0);
  s.da = s.fg + M * 2 * D;
  s.zs = s.da + M * 2 * D;
  s.p1 = s.zs + M * D;
  s.s1 = s.p1 + n1 * D * R;
  s.p2 = s.s1 + n1 * R;
  s.s2 = s.p2 + n2 * 4 * R * D;
  s.total = s.s2 + n2 * 2 * D;
  return s;
}

// (F1) of the layer: fg (or null) and z (or null), float32.
template <class P>
cudaError_t layer_gate(const float* x, const float* w, const float* add,
                       float* fg, float* z, int B, int T, int R, int D, int d,
                       cudaStream_t st) {
  FwdGateOp<P> f1;
  f1.M = B * T;
  f1.N = D;
  f1.K = 2 * R;
  f1.x = x;
  f1.w = w;
  f1.add = add;
  f1.fg = fg;
  f1.z = z;
  f1.zf = nullptr;
  f1.T = T;
  f1.R = R;
  f1.D = D;
  f1.d = d;
  f1.fg_ld = (size_t)2 * D;
  f1.z_ld = D;
  return launch<P>(dim3(tiles(D, BN / 2), tiles(B * T, BM)), f1,
                   ragged(R, D), st);
}

template <class P>
int layer_forward_impl(const float* x, const float* w, const float* wd,
                       const float* add, const float* bd, float* y, float* z,
                       float* scratch, int B, int T, int R, int D, int d,
                       cudaStream_t st) {
  const LayerScratch s = layer_scratch(false, P::kBf16, B, T, R, D);
  const float* xin = x;
  if constexpr (P::kBf16) {
    cudaError_t e = launch_round(x, scratch + s.xr, (size_t)B * T * R, st);
    if (e != cudaSuccess) return (int)e;
    xin = scratch + s.xr;
  }
  cudaError_t e = layer_gate<P>(xin, w, add, nullptr, z, B, T, R, D, d, st);
  if (e != cudaSuccess) return (int)e;
  FwdResOp<P> f2;
  f2.M = B * T;
  f2.N = R;
  f2.K = D;
  f2.zs = z;
  f2.z_ld = D;
  f2.wd = wd;
  f2.bd = bd;
  f2.xin = xin;
  f2.xout = y;
  return (int)launch<P>(dim3(tiles(R, BN), tiles(B * T, BM)), f2,
                        ragged(R, D), st);
}

template <class P>
int layer_backward_impl(const float* x, const float* w, const float* wd,
                        const float* add, const float* dy, const float* dz,
                        float* dx_local, float* dpast, float* dw, float* dwd,
                        float* dadd, float* dbd, float* scratch, int B, int T,
                        int R, int D, int d, cudaStream_t st) {
  const int M = B * T, rows = tiles(M, BM);
  const bool edge = ragged(R, D);
  const LayerScratch s = layer_scratch(true, P::kBf16, B, T, R, D);
  const float *xin = x, *dyin = dy, *dzin = dz;
  cudaError_t e;
  if constexpr (P::kBf16) {
    if ((e = launch_round(x, scratch + s.xr, (size_t)M * R, st)) ||
        (e = launch_round(dy, scratch + s.dyr, (size_t)M * R, st)) ||
        (e = launch_round(dz, scratch + s.dzr, (size_t)M * D, st)))
      return (int)e;
    xin = scratch + s.xr;
    dyin = scratch + s.dyr;
    dzin = scratch + s.dzr;
  }
  float* fg = scratch + s.fg;
  float* da = scratch + s.da;
  float* zs = scratch + s.zs;
  e = layer_gate<P>(xin, w, add, fg, nullptr, B, T, R, D, d, st);
  if (e != cudaSuccess) return (int)e;

  BwdGateOp<P> a;
  a.M = M;
  a.N = D;
  a.K = R;
  a.dc = dyin;
  a.wd = wd;
  a.fg = fg;
  a.dz = dzin;
  a.da = da;
  a.zs = zs;
  a.R = R;
  a.D = D;
  a.fg_ld = (size_t)2 * D;
  a.z_ld = D;
  e = launch<P>(dim3(tiles(D, BN), rows), a, edge, st);
  if (e != cudaSuccess) return (int)e;

  const int n1 = B * s.c1.nchunk, n2 = B * s.c2.nchunk;
  DwdOp w1;
  w1.M = D;
  w1.N = R;
  w1.T = T;
  w1.nchunk = s.c1.nchunk;
  w1.rpc = s.c1.rpc;
  w1.part = scratch + s.p1;
  w1.csum = scratch + s.s1;
  w1.zs = zs;
  w1.dc = dyin;
  e = launch<P>(dim3(tiles(R, BN), tiles(D, BM), n1), w1, edge, st);
  if (e != cudaSuccess) return (int)e;

  DwfgOp w2;
  w2.M = 2 * R;
  w2.N = 2 * D;
  w2.T = T;
  w2.nchunk = s.c2.nchunk;
  w2.rpc = s.c2.rpc;
  w2.part = scratch + s.p2;
  w2.csum = scratch + s.s2;
  w2.x = xin;
  w2.da = da;
  w2.R = R;
  w2.d = d;
  e = launch<P>(dim3(tiles(2 * D, BN), tiles(2 * R, BM), n2), w2, edge, st);
  if (e != cudaSuccess) return (int)e;

  for (int tap = 1; tap >= 0; --tap) {
    TapDxOp t;
    t.M = M;
    t.N = R;
    t.K = 2 * D;
    t.da = da;
    t.w = w + (size_t)tap * R * 2 * D;
    t.din = tap ? dyin : nullptr;
    t.dout = tap ? dx_local : dpast;
    t.D = D;
    e = launch<P>(dim3(tiles(R, BN), rows), t, edge, st);
    if (e != cudaSuccess) return (int)e;
  }

  e = launch_reduce(scratch + s.p1, scratch + s.s1, dwd, dbd, n1, D * R, R,
                    1, n1, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(scratch + s.p2, scratch + s.s2, dw, dadd, n2,
                            4 * R * D, 2 * D, B, s.c2.nchunk, st);
}

// The retired v1 stack and the layer take every width >= 1: the v1 records
// (fg [B, T, L*2D], no z record) and the layer's outputs pack no lanes.
bool any_width(int r, int d) { return r > 0 && d > 0; }

}  // namespace

extern "C" {

// 1 where the kernels take R = r, D = d (the TPU kernel's widths: any
// R >= 1; D in 1, 2, 4, ..., 64 or a multiple of 128), else 0.
int fused_stack_tiled_supports_width(int r, int d) { return supported(r, d); }

// Floats of scratch device memory the backward needs (either mode); -1 at
// a width not taken.
long long fused_stack_tiled_bwd_scratch_floats(int B, int T, int L, int r,
                                               int d) {
  (void)L;
  if (!supported(r, d)) return -1;
  return (long long)bwd_scratch(B, T, r, d).total;
}

// Forward launches (2L of them); the arguments of fused_stack_fwd_f32
// (fused_stack.cu), but xbuf is the bf16 mode's scratch, [B, T, D] floats
// (the f32 mode writes none: xbuf may be null). Returns 0 or a CUDA error
// code.
int fused_stack_tiled_fwd_f32(const float* x, const float* w_fg,
                              const float* wd, const float* add,
                              const float* bd, const int* dil, float* y,
                              float* fg, float* z, float* xbuf, int B, int T,
                              int L, int r, int d, void* stream) {
  if (!supported(r, d)) return kUnsupportedWidth;
  return forward_impl<F32>(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T,
                           L, r, d, (cudaStream_t)stream);
}

// Backward launches (7L of them); the arguments of fused_stack_bwd_f32
// (fused_stack.cu), scratch sized by fused_stack_tiled_bwd_scratch_floats.
// Returns 0 or a CUDA error code.
int fused_stack_tiled_bwd_f32(const float* y, const float* dy,
                              const float* fg, const float* dz,
                              const float* w_fg, const float* wd,
                              const float* bd, const int* dil, float* dx,
                              float* dw_fg, float* dwd, float* dadd,
                              float* dbd, float* scratch, int B, int T, int L,
                              int r, int d, void* stream) {
  if (!supported(r, d)) return kUnsupportedWidth;
  return backward_impl<F32>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd,
                            dadd, dbd, scratch, B, T, L, r, d,
                            (cudaStream_t)stream);
}

// The bf16 mode: the arguments of fused_stack_tiled_fwd_f32, with fg and z
// bf16 [B, T, L*2D] and [B, T, L*D] (float32 weights, rounded in the
// kernel).
int fused_stack_tiled_fwd_bf16(const float* x, const float* w_fg,
                               const float* wd, const float* add,
                               const float* bd, const int* dil, float* y,
                               __nv_bfloat16* fg, __nv_bfloat16* z,
                               float* xbuf, int B, int T, int L, int r, int d,
                               void* stream) {
  if (!supported(r, d)) return kUnsupportedWidth;
  return forward_impl<BF16>(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T,
                            L, r, d, (cudaStream_t)stream);
}

// The bf16 mode: the arguments of fused_stack_tiled_bwd_f32, with fg and dz
// bf16; every output float32.
int fused_stack_tiled_bwd_bf16(const float* y, const float* dy,
                               const __nv_bfloat16* fg,
                               const __nv_bfloat16* dz, const float* w_fg,
                               const float* wd, const float* bd,
                               const int* dil, float* dx, float* dw_fg,
                               float* dwd, float* dadd, float* dbd,
                               float* scratch, int B, int T, int L, int r,
                               int d, void* stream) {
  if (!supported(r, d)) return kUnsupportedWidth;
  return backward_impl<BF16>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg,
                             dwd, dadd, dbd, scratch, B, T, L, r, d,
                             (cudaStream_t)stream);
}

// TPU kernel 7 (the retired v1 stack) at every width the route sends here
// (R, D >= 1; fused_stack_tiled_v1_supports_width): the arguments of
// fused_stack_tiled_fwd_f32, but z is one layer's [B, T, D] in the record
// dtype, which each layer overwrites (v1 emits no z record; its op computes
// z from fg). The products, and so y and fg, are kernel 5's.
int fused_stack_tiled_v1_supports_width(int r, int d) {
  return any_width(r, d);
}

int fused_stack_tiled_v1_fwd_f32(const float* x, const float* w_fg,
                                 const float* wd, const float* add,
                                 const float* bd, const int* dil, float* y,
                                 float* fg, float* z, float* xbuf, int B,
                                 int T, int L, int r, int d, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return forward_impl<F32>(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T,
                           L, r, d, (cudaStream_t)stream, false);
}

int fused_stack_tiled_v1_fwd_bf16(const float* x, const float* w_fg,
                                  const float* wd, const float* add,
                                  const float* bd, const int* dil, float* y,
                                  __nv_bfloat16* fg, __nv_bfloat16* z,
                                  float* xbuf, int B, int T, int L, int r,
                                  int d, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return forward_impl<BF16>(x, w_fg, wd, add, bd, dil, y, fg, z, xbuf, B, T,
                            L, r, d, (cudaStream_t)stream, false);
}

// v1's backward: kernel 5's (fused_stack_tiled_bwd_*) at every width.
long long fused_stack_tiled_v1_bwd_scratch_floats(int B, int T, int L, int r,
                                                  int d) {
  (void)L;
  if (!any_width(r, d)) return -1;
  return (long long)bwd_scratch(B, T, r, d).total;
}

int fused_stack_tiled_v1_bwd_f32(const float* y, const float* dy,
                                 const float* fg, const float* dz,
                                 const float* w_fg, const float* wd,
                                 const float* bd, const int* dil, float* dx,
                                 float* dw_fg, float* dwd, float* dadd,
                                 float* dbd, float* scratch, int B, int T,
                                 int L, int r, int d, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return backward_impl<F32>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg, dwd,
                            dadd, dbd, scratch, B, T, L, r, d,
                            (cudaStream_t)stream);
}

int fused_stack_tiled_v1_bwd_bf16(const float* y, const float* dy,
                                  const __nv_bfloat16* fg,
                                  const __nv_bfloat16* dz, const float* w_fg,
                                  const float* wd, const float* bd,
                                  const int* dil, float* dx, float* dw_fg,
                                  float* dwd, float* dadd, float* dbd,
                                  float* scratch, int B, int T, int L, int r,
                                  int d, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return backward_impl<BF16>(y, dy, fg, dz, w_fg, wd, bd, dil, dx, dw_fg,
                             dwd, dadd, dbd, scratch, B, T, L, r, d,
                             (cudaStream_t)stream);
}

// TPU kernel 8 (one gated layer) at every width R, D >= 1, both modes
// (bf16: the layer's rule, BF16Layer). Scratch floats of a direction
// (backward 0 or 1) in a mode (bf16 0 or 1); -1 at a width not taken.
long long fused_stack_tiled_layer_scratch_floats(int backward, int bf16,
                                                 int B, int T, int r, int d) {
  if (!any_width(r, d)) return -1;
  return (long long)layer_scratch(backward, bf16, B, T, r, d).total;
}

// Forward: x [B, T, R], w [2, R, 2D], wd [D, R], add [B, 2D], bd [R] ->
// y [B, T, R], z [B, T, D], all float32. Returns 0 or a CUDA error code.
int fused_stack_tiled_layer_fwd_f32(const float* x, const float* w,
                                    const float* wd, const float* add,
                                    const float* bd, float* y, float* z,
                                    float* scratch, int B, int T, int r,
                                    int d, int dilation, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return layer_forward_impl<F32Layer>(x, w, wd, add, bd, y, z, scratch, B, T,
                                      r, d, dilation, (cudaStream_t)stream);
}

int fused_stack_tiled_layer_fwd_bf16(const float* x, const float* w,
                                     const float* wd, const float* add,
                                     const float* bd, float* y, float* z,
                                     float* scratch, int B, int T, int r,
                                     int d, int dilation, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return layer_forward_impl<BF16Layer>(x, w, wd, add, bd, y, z, scratch, B,
                                       T, r, d, dilation,
                                       (cudaStream_t)stream);
}

// Backward from the inputs and (dy, dz) -> dx_local, dpast [B, T, R], dw
// [2, R, 2D], dwd [D, R], dadd [B, 2D], dbd [R], all float32, the weight
// gradients summed in a fixed order. Returns 0 or a CUDA error code.
int fused_stack_tiled_layer_bwd_f32(const float* x, const float* w,
                                    const float* wd, const float* add,
                                    const float* dy, const float* dz,
                                    float* dx_local, float* dpast, float* dw,
                                    float* dwd, float* dadd, float* dbd,
                                    float* scratch, int B, int T, int r,
                                    int d, int dilation, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return layer_backward_impl<F32Layer>(x, w, wd, add, dy, dz, dx_local, dpast,
                                       dw, dwd, dadd, dbd, scratch, B, T, r,
                                       d, dilation, (cudaStream_t)stream);
}

int fused_stack_tiled_layer_bwd_bf16(const float* x, const float* w,
                                     const float* wd, const float* add,
                                     const float* dy, const float* dz,
                                     float* dx_local, float* dpast, float* dw,
                                     float* dwd, float* dadd, float* dbd,
                                     float* scratch, int B, int T, int r,
                                     int d, int dilation, void* stream) {
  if (!any_width(r, d)) return kUnsupportedWidth;
  return layer_backward_impl<BF16Layer>(x, w, wd, add, dy, dz, dx_local,
                                        dpast, dw, dwd, dadd, dbd, scratch, B,
                                        T, r, d, dilation,
                                        (cudaStream_t)stream);
}

}  // extern "C"
