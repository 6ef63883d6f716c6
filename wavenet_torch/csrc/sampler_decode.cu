// sampler_decode: whole-network autoregressive WaveNet decode, one launch
// per generation, for NVIDIA Hopper (sm_90a).
//
// Replaces four TPU (Pallas) kernels of the JAX package, which compute
// the same per-step network and differ only in where the TPU keeps the
// layer ring and whether the forced prefix is primed in the kernel:
//   wavenet_tpu/kernels/sampler.py:234         _sampler_kernel (ring in VMEM)
//   wavenet_tpu/kernels/sampler.py:1308        _sampler_kernel_hbm_stream (ring in HBM rows)
//   wavenet_tpu/kernels/sampler_packed.py:142  _decode_kernel_packed (quad-packed HBM ring)
//   wavenet_tpu/kernels/sampler.py:1057        _sampler_kernel_hbm (one pass from a
//                                              zero ring, forced prefix stepped in-kernel)
// The last is this kernel launched on a zero ring and causal register
// with the whole forced prefix (the wrapper decode_sequential).
//
// Per step t and batch row b (float32 weights and state):
//   current = [causal | feature(x)] @ causal_w
//     mu-law input: feature = onehot(x), causal holds the previous one-hot
//     scalar input: feature = the amplitude x, causal holds the previous
//                   initial_filter_width - 1 amplitudes (oldest first)
//   for each layer l:  pos = offset_l + (t0 + t) % d_l
//       past = ring[pos, b];  ring[pos, b] = current
//       fg   = [past | current] @ layer_w[l] + layer_add[l, b]
//       out  = tanh(f) * (0.5 + 0.5 * tanh(g'))        (gate pre-scaled by 0.5)
//       current += out @ dense_w[l] + dense_add[l];  skip += out @ skip_w[l]
//   logits = relu(relu(skip + skip_b) @ post1 + b1) @ post2 + b2
//   sampled = argmax(logits / T + Gumbel), ties to the lowest index
// with a forced prefix of n_forced inputs (int codes, or float amplitudes
// in scalar mode: a forced step then emits the amplitude's mu-law code and
// a sampled code re-enters as its decoded amplitude), an optional window
// of the last
// n_log steps' logits, and resume from a given ring, causal register and
// absolute phase t0 (the ring is updated in place). In scalar mode the
// launch can also return the amplitude of the input after its last step,
// so that a resumed launch starts from the value this kernel computed.
//
// Random bits: Philox4x32-10 keyed on the 64-bit seed, counter
// (class block, row within the request, absolute step lo, hi). A row's
// codes therefore depend neither on the batch size nor on the grid.
// Uniform u = bitcast((bits >> 9) | 0x3F800000) - 1, clamped at 1e-20,
// as the TPU kernels do.
//
// What bounds it. Each step reads every weight once per block: about
// 4.3 MB of float32 at the paper config (30 layers, R=D=32, S=512,
// Q=256), and does about 2.1 MFLOP per batch row (the wide config, R=D=64,
// S=1024: 15.6 MB and 7.8 MFLOP). Read from device memory
// every step, the weights would bound b1 by bytes; kept on chip, the
// launch is bound by FP32 operations, which grow with B. In practice a
// step is a strict dependency chain of ~220 __syncthreads (seven per
// layer, plus the causal layer, the head and the argmax), and the latency
// of that chain, not bytes or FLOPs, sets the step time at small B. So
// the design keeps the whole chain inside one persistent block per group
// of rows:
// the activations, the skip sum and the logits row live in shared memory
// (a few KB), the weights stay in the 50 MB L2 across steps, the ring
// lives in device memory and is touched one row per layer per step, and
// larger B shares each weight read among up to 8 rows of a block.
// Matvecs split K across thread groups and add the partial sums in a
// fixed order, so a row's result does not depend on how many rows share
// its block. Plain FP32 FMAs, no tensor cores: this is the simple, right
// first version. At the wide widths the step is longer (0.63 against 0.21
// ms at b1 on an H100): one block pulls 15.6 MB of weights from L2 per
// step with a few 4-byte loads in flight per thread, ~25 GB/s per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct DecodeArgs {
  const float* causal_w;   // [KC + C_in, R]  rows: causal register | input
  const float* layer_w;    // [L, 2R, 2D]
  const float* layer_add;  // [L, B, 2D]
  const float* dense_w;    // [L, D, R]
  const float* dense_add;  // [L, R]
  const float* skip_w;     // [L, D, S]
  const float* skip_b;     // [S]
  const float* post1_w;    // [S, S]
  const float* post1_b;    // [S]
  const float* post2_w;    // [S, Q]
  const float* post2_b;    // [Q]
  const int* ring_meta;    // [2L]: ring row offsets, then dilations
  float* ring;             // [sum_d, B, R], updated in place
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
};

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
// handed to epi(r, n, sum). Wide outputs: one thread per column over the
// whole K. Narrow outputs: G = kThreads / N groups take every G-th k and
// the partial sums are added in group order. The caller synchronises
// after the call before reading what epi wrote.
template <int RB, typename Epi>
__device__ __forceinline__ void matvec(const float* x, int xs, int K,
                                       const float* __restrict__ W, int N,
                                       float* part, Epi epi) {
  const int tid = threadIdx.x;
  if (N >= kThreads) {
    for (int n = tid; n < N; n += kThreads) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll 16
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(W + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] = fmaf(x[r * xs + k], w, acc[r]);
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
      const float w = __ldg(W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = fmaf(x[r * xs + k], w, acc[r]);
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

template <int RB>
__global__ void __launch_bounds__(kThreads)
sampler_decode_kernel(const DecodeArgs a) {
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

    // Causal layer: current = causal @ causal_w[:KC] + the input's row
    // (mu-law: row KC + x of the one-hot; scalar: x times row KC).
    matvec<RB>(causal, KC, KC, a.causal_w, R, part,
               [&](int r, int n, float s) {
                 cur[r * R + n] =
                     a.scalar ? fmaf(xamp[r],
                                     __ldg(a.causal_w + (size_t)KC * R + n), s)
                              : s + __ldg(a.causal_w +
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
    for (int i = tid; i < RB * S; i += kThreads) skip[i] = 0.f;

    for (int l = 0; l < L; ++l) {
      const int pos = meta[l] + (int)(step % (long long)meta[L + l]);
      for (int i = tid; i < RB * R; i += kThreads) {
        const int r = i / R, j = i % R, row = row0 + r;
        const float c = cur[i];
        float p = 0.f;
        if (row < B) {
          const size_t idx = ((size_t)pos * B + row) * R + j;
          p = a.ring[idx];
          a.ring[idx] = c;
        }
        xcat[r * 2 * R + j] = p;
        xcat[r * 2 * R + R + j] = c;
      }
      __syncthreads();
      const float* ladd = a.layer_add + (size_t)l * B * 2 * D;
      matvec<RB>(xcat, 2 * R, 2 * R, a.layer_w + (size_t)l * 4 * R * D,
                 2 * D, part, [&](int r, int n, float s) {
                   const int row = row0 + r;
                   fg[r * 2 * D + n] =
                       s + (row < B ? ladd[(size_t)row * 2 * D + n] : 0.f);
                 });
      __syncthreads();
      for (int i = tid; i < RB * D; i += kThreads) {
        const int r = i / D, d = i % D;
        out[i] = tanhf(fg[r * 2 * D + d]) *
                 (0.5f + 0.5f * tanhf(fg[r * 2 * D + D + d]));
      }
      __syncthreads();
      const float* dadd = a.dense_add + (size_t)l * R;
      matvec<RB>(out, D, D, a.dense_w + (size_t)l * D * R, R, part,
                 [&](int r, int n, float s) {
                   cur[r * R + n] = (cur[r * R + n] + s) + __ldg(dadd + n);
                 });
      __syncthreads();
      matvec<RB>(out, D, D, a.skip_w + (size_t)l * D * S, S, part,
                 [&](int r, int n, float s) { skip[r * S + n] += s; });
      __syncthreads();
    }

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
// of sampler_decode_kernel.
size_t smem_bytes(const DecodeArgs& a, int rb) {
  const size_t floats =
      (size_t)rb * (a.KC + a.Q + 3 * a.R + 3 * a.D + 3 * a.S) +
      (size_t)rb * kThreads + kWarps + rb;   // ..., part, red_v, xamp
  const size_t ints = kWarps + 2 * (size_t)a.L + rb;
  return 4 * (floats + ints);
}

// Rows sharing one block (and one read of the weights per step): as many
// as keep the grid at least one block per SM and the block's shared memory
// within what a block may opt in to on this device.
int rows_per_block(const DecodeArgs& a) {
  int dev = 0, n_sm = 1, smem_max = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 1;
  for (int rb = 8; rb > 1; rb >>= 1)
    if (a.B >= rb * n_sm && smem_bytes(a, rb) <= (size_t)smem_max) return rb;
  return 1;
}

template <int RB>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a, RB);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sampler_decode_kernel<RB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.B + RB - 1) / RB;
  sampler_decode_kernel<RB><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sampler_decode_f32(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    void* stream) {
  DecodeArgs a;
  a.causal_w = causal_w;
  a.layer_w = layer_w;
  a.layer_add = layer_add;
  a.dense_w = dense_w;
  a.dense_add = dense_add;
  a.skip_w = skip_w;
  a.skip_b = skip_b;
  a.post1_w = post1_w;
  a.post1_b = post1_b;
  a.post2_w = post2_w;
  a.post2_b = post2_b;
  a.ring_meta = ring_meta;
  a.ring = ring;
  a.causal = causal;
  a.forced = forced;
  a.codes = codes;
  a.logits = logits;
  a.next_amp = scalar_input ? next_amp : nullptr;
  a.B = B;
  a.L = L;
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.n_total = n_total;
  a.n_forced = n_forced;
  a.n_log = n_log;
  a.scalar = scalar_input;
  a.KC = causal_width;
  a.t0 = t0;
  a.key0 = (uint32_t)(seed & 0xffffffffull);
  a.key1 = (uint32_t)(seed >> 32);
  a.inv_temperature = inv_temperature;
  // The scalar register shifts through the partial-sum scratch, which
  // holds kThreads floats per row.
  if (B < 1 || n_total < 1 || n_forced < 1 || causal_width < 1 ||
      (scalar_input && causal_width > kThreads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (rows_per_block(a)) {
    case 1: return (int)launch<1>(a, s);
    case 2: return (int)launch<2>(a, s);
    case 4: return (int)launch<4>(a, s);
    case 8: return (int)launch<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
