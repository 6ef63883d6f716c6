// The decode kernel of sampler_decode.cu, shared with its b1 probe
// (b1_bisect.cu): one persistent block per group of RB rows runs every step
// of the network (see sampler_decode.cu for what it computes and why it is
// laid out so).
//
// Template parameters:
//   RB     rows of the batch per block;
//   kMask  the parts of the step an ablation removes (tools/r3_b1_bisect.py's
//          modes; kFullStep: none). Each mode computes the JAX tool's math:
//            kNoSkip    no skip product (the head reads a zero skip sum)
//            kNoDense   current += out[:, :R], no dense product
//            kNoFg      fg = [past | current], no filter/gate product
//            kNoTanh    out = fg[:, :D] + fg[:, D:]
//            kNoRing    past = current, no ring read or write
//            kNoHead    logits = current[:, 0] in every class
//            kNoSample  argmax of the logits, no Gumbel noise
//            kNoFeat    current = x in every channel, no causal layer
//   WT     the weights' type: float, or __nv_bfloat16 (the weights are
//          widened to float and each product's activation operand is first
//          rounded to bf16, as the JAX kernels do: the causal window and the
//          head's two inputs always, the layer chain's three inputs (filter/
//          gate [past | current], dense, skip) where DecodeArgsT::round_chain
//          is set; products, sums and adds in float32).
//   kLc    local conditioning (the JAX kernels' has_lc): each layer's
//          filter/gate pre-activation gains lc_t @ lc_w[l], added after
//          layer_add; lc_t is row t of the stream [n_total, B, C_lc]. The
//          terms of all L layers are computed at the top of the step, off
//          the layer chain (lc_terms). With bf16 weights lc_w is bf16 and
//          lc_t is rounded to bf16 at every B, round_chain or not.
//   ST     the ring's type (the JAX kernels' state_dtype): float, or
//          __nv_bfloat16, whose past rows are widened exactly to float as
//          they are read and whose new rows are the layers' float32 inputs
//          rounded to nearest even as they are stored (ring_load,
//          ring_store below; sampler_cluster.cuh and sampler_tiles.cuh take
//          the same parameter). The step's own input enters [past | current]
//          unrounded; the causal register and every sum stay float32.
// sampler_decode.cu instantiates <RB, kFullStep, WT, kLc> at both weight
// types, with and without LC (ST float); sampler_decode_ring16.cu the same
// four at ST = __nv_bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum : unsigned {
  kNoSkip = 1,
  kNoDense = 2,
  kNoFg = 4,
  kNoTanh = 8,
  kNoRing = 16,
  kNoHead = 32,
  kNoSample = 64,
  kNoFeat = 128,
};
constexpr unsigned kFullStep = 0;
// The r3 probe's modes (tools/r3_b1_bisect.py's MODES, in order): full,
// no_skip, no_dense, no_fg, no_tanh, no_ring, no_head, no_sample, no_feat,
// mm_only. b1_bisect.cu instantiates them on this kernel,
// b1_bisect_cluster.cuh on sampler_cluster's.
[[maybe_unused]] constexpr unsigned kR3Modes[] = {
    kFullStep, kNoSkip, kNoDense, kNoFg, kNoTanh, kNoRing, kNoHead,
    kNoSample, kNoFeat, kNoRing | kNoTanh | kNoSkip | kNoHead,
};
[[maybe_unused]] constexpr int kR3NumModes = 10;

template <typename WT>
struct DecodeArgsT {
  const WT* causal_w;      // [KC + C_in, R]  rows: causal register | input
  const WT* layer_w;       // [L, 2R, 2D]
  const float* layer_add;  // [L, B, 2D]
  const WT* dense_w;       // [L, D, R]
  const float* dense_add;  // [L, R]
  const WT* skip_w;        // [L, D, S]
  const float* skip_b;     // [S]
  const WT* post1_w;       // [S, S]
  const float* post1_b;    // [S]
  const WT* post2_w;       // [S, Q]
  const float* post2_b;    // [Q]
  const int* ring_meta;    // [2L]: ring row offsets, then dilations
  void* ring;              // [sum_d, B, R] at the ring's type (float or
                           // bf16), updated in place
  float* causal;           // [B, KC], updated in place
  const void* forced;      // [B, n_forced] int32, or float32 when scalar
  int* codes;              // [B, n_total]
  float* logits;           // [B, n_log, Q] or null
  float* next_amp;         // [B] or null: the input after the last step (scalar)
  int B, L, R, D, S, Q, n_total, n_forced, n_log;
  int scalar;              // 1: scalar input (amplitudes), 0: mu-law codes
  int KC;                  // causal register width: Q, or ifw - 1 if scalar
  long long t0;
  uint32_t key0, key1;
  float inv_temperature;
  // bf16 weights: 1 rounds the layer chain's inputs to bf16, 0 keeps them
  // float32 (the JAX prefill route at B = 1, whose VPU chain multiplies
  // float32 activations by the widened weights). Float weights ignore it.
  int round_chain;
  // Local conditioning (the kernels' LC mode only): lc_w [L, C_lc, 2D]
  // (filter | gate pre-scaled by 0.5, as layer_w), lc [n_total, B, C_lc].
  const WT* lc_w = nullptr;
  const float* lc = nullptr;
  int C_lc = 0;
};

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Element i of a ring of type ST as float: exact (a bf16 row widens).
template <typename ST>
__device__ __forceinline__ float ring_load(const void* ring, size_t i) {
  if constexpr (sizeof(ST) == sizeof(float))
    return static_cast<const float*>(ring)[i];
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(ring)[i]);
}

// Stores v as element i of a ring of type ST: a bf16 ring rounds it to
// nearest even (the JAX kernels' current.astype(ring_ref.dtype)).
template <typename ST>
__device__ __forceinline__ void ring_store(void* ring, size_t i, float v) {
  if constexpr (sizeof(ST) == sizeof(float))
    static_cast<float*>(ring)[i] = v;
  else
    static_cast<__nv_bfloat16*>(ring)[i] = __float2bfloat16_rn(v);
}

// Stores elements i .. i + 3 (i a multiple of 4) of a ring of type ST in
// one access: a 16-byte store of float, an 8-byte store of 4 bf16 (each
// rounded to nearest even, the first in the lowest half).
template <typename ST>
__device__ __forceinline__ void ring_store4(void* ring, size_t i, float4 v) {
  if constexpr (sizeof(ST) == sizeof(float)) {
    *reinterpret_cast<float4*>(static_cast<float*>(ring) + i) = v;
  } else {
    const auto bits = [](float x) {
      return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
    };
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(ring) + i) =
        make_uint2(bits(v.x) | bits(v.y) << 16, bits(v.z) | bits(v.w) << 16);
  }
}

// An activation as the operand of a product with WT weights: rounded to
// bf16 (to nearest even) when the weights are bf16 and `rnd` holds.
template <typename WT>
__device__ __forceinline__ float opnd(float x, bool rnd = true) {
  if constexpr (sizeof(WT) == sizeof(float)) return x;
  else return rnd ? __bfloat162float(__float2bfloat16(x)) : x;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// y[r][n] = sum_k x[r*xs + k] * W[k*N + n] for the RB rows of the block,
// handed to epi(r, n, sum), x rounded as opnd<WT>(x, rnd). Wide outputs:
// one thread per column over the whole K. Narrow outputs: G = kThreads / N
// groups take every G-th k and the partial sums are added in group order.
// The caller synchronises after the call before reading what epi wrote.
template <int RB, typename WT, typename Epi>
__device__ __forceinline__ void matvec(const float* x, int xs, int K,
                                       const WT* __restrict__ W, int N,
                                       float* part, Epi epi,
                                       bool rnd = true) {
  const int tid = threadIdx.x;
  if (N >= kThreads) {
    for (int n = tid; n < N; n += kThreads) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll 16
      for (int k = 0; k < K; ++k) {
        const float w = ldw(W + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          acc[r] = fmaf(opnd<WT>(x[r * xs + k], rnd), w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) epi(r, n, acc[r]);
    }
    return;
  }
  const int G = kThreads / N;
  const int n = tid % N;
  const int g = tid / N;
  if (g < G) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int k = g; k < K; k += G) {
      const float w = ldw(W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc[r] = fmaf(opnd<WT>(x[r * xs + k], rnd), w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) part[(g * RB + r) * N + n] = acc[r];
  }
  __syncthreads();
  if (tid < N) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg) s += part[(gg * RB + r) * N + tid];
      epi(r, tid, s);
    }
  }
}

// The LC terms of layers [l0, l0 + nl) at step t of the launch:
// lcp[(r * NL + j) * 2D + n] = sum over k of lc[t, row0 + r, k] *
// lc_w[l0 + j, k, n], k in order. The step's feature rows are staged in
// lcr [RB][C_lc] first, as the product's operand: at bf16 weights rounded
// to bf16 at every B (the JAX kernels cast the row to lc_w's type before
// either of their branches, sampler.py:334 and :1483), at float32 as they
// are. One thread a column, all RB rows at once, kBatch
// weights loaded before their FMAs (lc_w streams from L2, so a column costs
// ceil(C_lc / kBatch) L2 round trips: 3 at C_lc = 80 and up to 4 rows;
// fewer weights at once above 4 rows, whose accumulators take the
// registers). The terms depend on the stream alone, never on the layer
// chain, so the callers compute them off it. The caller synchronises after
// the call before reading lcp.
template <int RB, typename WT>
__device__ __forceinline__ void lc_terms(const DecodeArgsT<WT>& a, int t,
                                         int row0, int l0, int nl, int NL,
                                         int D, float* lcr, float* lcp) {
  const int tid = threadIdx.x, C = a.C_lc, B = a.B, N2 = 2 * D;
  for (int i = tid; i < RB * C; i += kThreads) {
    const int row = row0 + i / C;
    lcr[i] = opnd<WT>(row < B ? a.lc[((size_t)t * B + row) * C + i % C]
                              : 0.f);
  }
  __syncthreads();
  constexpr int kBatch = RB <= 4 ? 32 : 16;
  for (int n = tid; n < nl * N2; n += kThreads) {
    const int j = n / N2, col = n % N2;
    const WT* W = a.lc_w + (size_t)(l0 + j) * C * N2 + col;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kBatch) {
      float w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        w[u] = k0 + u < C ? ldw(W + (size_t)(k0 + u) * N2) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < C) {
#pragma unroll
          for (int r = 0; r < RB; ++r)
            acc[r] = fmaf(lcr[r * C + k0 + u], w[u], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) lcp[(r * NL + j) * N2 + col] = acc[r];
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The JAX kernels' mu-law formulas, op by op (no contraction into FMAs);
// their constants are float32 roundings of double values, as there.
__device__ __forceinline__ float decode_amp(int code, float mu) {
  const float ln1p_mu = (float)log1p((double)mu);
  const float inv_mu = (float)(1.0 / (double)mu);
  const float sgn = __fsub_rn(__fmul_rn(2.f, __fdiv_rn((float)code, mu)), 1.f);
  const float mag = __fmul_rn(
      inv_mu, __fsub_rn(expf(__fmul_rn(fabsf(sgn), ln1p_mu)), 1.f));
  return sgn > 0.f ? mag : (sgn < 0.f ? -mag : 0.f);
}

__device__ __forceinline__ int mu_law_encode(float amp, float mu) {
  const float inv_ln1p_mu = (float)(1.0 / log1p((double)mu));
  const float safe = fminf(fabsf(amp), 1.f);
  const float mag = __fmul_rn(log1pf(__fmul_rn(mu, safe)), inv_ln1p_mu);
  const float sig = amp > 0.f ? mag : (amp < 0.f ? -mag : 0.f);
  return (int)__fadd_rn(__fmul_rn(__fdiv_rn(__fadd_rn(sig, 1.f), 2.f), mu),
                        0.5f);
}

template <int RB, unsigned kMask, typename WT, bool kLc = false,
          typename ST = float>
__global__ void __launch_bounds__(kThreads)
sampler_decode_kernel(const DecodeArgsT<WT> a) {
  constexpr bool kSkip = !(kMask & kNoSkip), kDense = !(kMask & kNoDense);
  constexpr bool kFg = !(kMask & kNoFg), kTanh = !(kMask & kNoTanh);
  constexpr bool kRing = !(kMask & kNoRing), kHead = !(kMask & kNoHead);
  constexpr bool kSample = !(kMask & kNoSample), kFeat = !(kMask & kNoFeat);
  extern __shared__ float smem[];
  const int R = a.R, D = a.D, S = a.S, Q = a.Q, L = a.L, B = a.B;
  const int KC = a.KC;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;
  const float mu = (float)(Q - 1);
  const int* forced_i = static_cast<const int*>(a.forced);
  const float* forced_f = static_cast<const float*>(a.forced);

  float* causal = smem;                  // [RB][KC]
  float* xcat = causal + RB * KC;        // [RB][2R]
  float* cur = xcat + RB * 2 * R;        // [RB][R]
  float* fg = cur + RB * R;              // [RB][2D]
  float* out = fg + RB * 2 * D;          // [RB][D]
  float* skip = out + RB * D;            // [RB][S]
  float* h1 = skip + RB * S;             // [RB][S]
  float* h2 = h1 + RB * S;               // [RB][S]
  float* lg = h2 + RB * S;               // [RB][Q]
  float* part = lg + RB * Q;             // [RB * kThreads]
  float* red_v = part + RB * kThreads;   // [kWarps]
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);  // [kWarps]
  int* meta = red_i + kWarps;            // [2L]
  int* xin = meta + 2 * L;               // [RB] current code (mu-law)
  float* xamp = reinterpret_cast<float*>(xin + RB);  // [RB] amplitude (scalar)
  float* lcr = xamp + RB;                // [RB][C_lc] (kLc)
  float* lcp = lcr + RB * a.C_lc;        // [RB][L][2D] (kLc)

  for (int i = tid; i < 2 * L; i += kThreads) meta[i] = a.ring_meta[i];
  for (int i = tid; i < RB * KC; i += kThreads) {
    const int row = row0 + i / KC;
    causal[i] = row < B ? a.causal[(size_t)row * KC + i % KC] : 0.f;
  }
  if (tid < RB) {
    const int row = row0 + tid;
    const size_t at = (size_t)row * a.n_forced;
    xin[tid] = (row < B && !a.scalar) ? forced_i[at] : 0;
    xamp[tid] = (row < B && a.scalar) ? forced_f[at] : 0.f;
  }
  __syncthreads();

  const int log_from = a.n_total - a.n_log;
  for (int t = 0; t < a.n_total; ++t) {
    const long long step = a.t0 + t;

    // The LC terms of every layer, before the chain needs them.
    if constexpr (kLc) lc_terms<RB>(a, t, row0, 0, L, L, D, lcr, lcp);

    if constexpr (kFeat) {
      // Causal layer: current = causal @ causal_w[:KC] + the input's row
      // (mu-law: row KC + x of the one-hot; scalar: x times row KC).
      matvec<RB>(causal, KC, KC, a.causal_w, R, part,
                 [&](int r, int n, float s) {
                   cur[r * R + n] =
                       a.scalar ? fmaf(opnd<WT>(xamp[r]),
                                       ldw(a.causal_w + (size_t)KC * R + n), s)
                                : s + ldw(a.causal_w +
                                          (size_t)(KC + xin[r]) * R + n);
                 });
      __syncthreads();
      if (a.scalar) {
        // Shift the amplitude register left by one and append x (through
        // the free partial-sum scratch: the shift reads what it overwrites).
        for (int i = tid; i < RB * KC; i += kThreads) {
          const int r = i / KC, j = i % KC;
          part[i] = j + 1 < KC ? causal[i + 1] : xamp[r];
        }
        __syncthreads();
        for (int i = tid; i < RB * KC; i += kThreads) causal[i] = part[i];
      } else {
        for (int i = tid; i < RB * KC; i += kThreads)
          causal[i] = (i % KC == xin[i / KC]) ? 1.f : 0.f;
      }
    } else {
      for (int i = tid; i < RB * R; i += kThreads) cur[i] = (float)xin[i / R];
      __syncthreads();
    }
    for (int i = tid; i < RB * S; i += kThreads) skip[i] = 0.f;

    for (int l = 0; l < L; ++l) {
      const int pos = meta[l] + (int)(step % (long long)meta[L + l]);
      for (int i = tid; i < RB * R; i += kThreads) {
        const int r = i / R, j = i % R, row = row0 + r;
        const float c = cur[i];
        float p = c;
        if constexpr (kRing) {
          p = 0.f;
          if (row < B) {
            const size_t idx = ((size_t)pos * B + row) * R + j;
            p = ring_load<ST>(a.ring, idx);
            ring_store<ST>(a.ring, idx, c);
          }
        }
        xcat[r * 2 * R + j] = p;
        xcat[r * 2 * R + R + j] = c;
      }
      __syncthreads();
      if constexpr (kFg) {
        const float* ladd = a.layer_add + (size_t)l * B * 2 * D;
        matvec<RB>(xcat, 2 * R, 2 * R, a.layer_w + (size_t)l * 4 * R * D,
                   2 * D, part, [&](int r, int n, float s) {
                     const int row = row0 + r;
                     float v =
                         s + (row < B ? ladd[(size_t)row * 2 * D + n] : 0.f);
                     if constexpr (kLc) v += lcp[(r * L + l) * 2 * D + n];
                     fg[r * 2 * D + n] = v;
                   }, a.round_chain);
      } else {
        // R == D: fg is the layer's input pair itself.
        for (int i = tid; i < RB * 2 * D; i += kThreads) fg[i] = xcat[i];
      }
      __syncthreads();
      for (int i = tid; i < RB * D; i += kThreads) {
        const int r = i / D, d = i % D;
        if constexpr (kTanh)
          out[i] = tanhf(fg[r * 2 * D + d]) *
                   (0.5f + 0.5f * tanhf(fg[r * 2 * D + D + d]));
        else
          out[i] = fg[r * 2 * D + d] + fg[r * 2 * D + D + d];
      }
      __syncthreads();
      if constexpr (kDense) {
        const float* dadd = a.dense_add + (size_t)l * R;
        matvec<RB>(out, D, D, a.dense_w + (size_t)l * D * R, R, part,
                   [&](int r, int n, float s) {
                     cur[r * R + n] = (cur[r * R + n] + s) + __ldg(dadd + n);
                   }, a.round_chain);
      } else {
        // D >= R: current += out[:, :R].
        for (int i = tid; i < RB * R; i += kThreads)
          cur[i] += out[(i / R) * D + i % R];
      }
      __syncthreads();
      if constexpr (kSkip) {
        matvec<RB>(out, D, D, a.skip_w + (size_t)l * D * S, S, part,
                   [&](int r, int n, float s) { skip[r * S + n] += s; },
                   a.round_chain);
        __syncthreads();
      }
    }

    if constexpr (kHead) {
      // Head: relu(skip + skip_b) @ post1 + b1, relu, @ post2 + b2.
      for (int i = tid; i < RB * S; i += kThreads)
        h1[i] = fmaxf(skip[i] + __ldg(a.skip_b + i % S), 0.f);
      __syncthreads();
      matvec<RB>(h1, S, S, a.post1_w, S, part, [&](int r, int n, float s) {
        h2[r * S + n] = fmaxf(s + __ldg(a.post1_b + n), 0.f);
      });
      __syncthreads();
      matvec<RB>(h2, S, S, a.post2_w, Q, part, [&](int r, int n, float s) {
        lg[r * Q + n] = s + __ldg(a.post2_b + n);
      });
    } else {
      for (int i = tid; i < RB * Q; i += kThreads) lg[i] = cur[(i / Q) * R];
    }
    __syncthreads();

    if (a.n_log > 0 && t >= log_from) {
      for (int i = tid; i < RB * Q; i += kThreads) {
        const int row = row0 + i / Q;
        if (row < B)
          a.logits[((size_t)row * a.n_log + (t - log_from)) * Q + i % Q] =
              lg[i];
      }
    }

    // Gumbel-argmax over logits / T, one row at a time.
    for (int r = 0; r < RB; ++r) {
      const int row = row0 + r;
      float bv = -INFINITY;
      int bi = Q;
      if constexpr (kSample) {
        for (int blk = tid; blk * 4 < Q; blk += kThreads) {
          uint32_t c[4] = {(uint32_t)blk, (uint32_t)row, (uint32_t)step,
                           (uint32_t)((unsigned long long)step >> 32)};
          philox4x32_10(c, a.key0, a.key1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = 4 * blk + j;
            if (q < Q) {
              float u = __uint_as_float((c[j] >> 9) | 0x3F800000u) - 1.0f;
              u = fmaxf(u, 1e-20f);
              const float gmb = -logf(-logf(u));
              const float sc =
                  __fadd_rn(__fmul_rn(lg[r * Q + q], a.inv_temperature), gmb);
              if (better(sc, q, bv, bi)) {
                bv = sc;
                bi = q;
              }
            }
          }
        }
      } else {
        for (int q = tid; q < Q; q += kThreads) {
          const float sc = __fmul_rn(lg[r * Q + q], a.inv_temperature);
          if (better(sc, q, bv, bi)) {
            bv = sc;
            bi = q;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if ((tid & 31) == 0) {
        red_v[tid >> 5] = bv;
        red_i[tid >> 5] = bi;
      }
      __syncthreads();
      if (tid < 32) {
        bv = tid < kWarps ? red_v[tid] : -INFINITY;
        bi = tid < kWarps ? red_i[tid] : Q;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, bv, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (tid == 0) {
          const int sampled = bi < Q ? bi : 0;
          int nx = sampled;
          float amp = a.scalar ? decode_amp(sampled, mu) : 0.f;
          if (row < B) {
            // Body t consumes input t and emits input t + 1: forced while
            // t + 1 < n_forced, then the sampled code.
            if (t + 1 < a.n_forced) {
              const size_t at = (size_t)row * a.n_forced + t + 1;
              if (a.scalar) {
                amp = forced_f[at];
                nx = mu_law_encode(amp, mu);
              } else {
                nx = forced_i[at];
              }
            }
            a.codes[(size_t)row * a.n_total + t] = nx;
          }
          xin[r] = nx;
          xamp[r] = amp;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < RB * KC; i += kThreads) {
    const int row = row0 + i / KC;
    if (row < B) a.causal[(size_t)row * KC + i % KC] = causal[i];
  }
  if (a.next_amp && tid < RB && row0 + tid < B)
    a.next_amp[row0 + tid] = xamp[tid];
}

// Dynamic shared memory of one block at rb rows: the carve-up at the top
// of sampler_decode_kernel (C_lc is 0 outside the LC mode).
template <typename WT>
size_t smem_bytes(const DecodeArgsT<WT>& a, int rb) {
  const size_t floats =
      (size_t)rb * (a.KC + a.Q + 3 * a.R + 3 * a.D + 3 * a.S) +
      (size_t)rb * kThreads + kWarps + rb +   // ..., part, red_v, xamp
      (size_t)rb * (a.C_lc ? a.C_lc + 2 * (size_t)a.L * a.D : 0);  // lcr, lcp
  const size_t ints = kWarps + 2 * (size_t)a.L + rb;
  return 4 * (floats + ints);
}

}  // namespace
