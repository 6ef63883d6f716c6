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
// Per step t and batch row b (float32 state, the ring float32 or bf16;
// float32 weights, or bf16 ones in the bf16 mode, see below):
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
// step is a chain of dependent products, each waiting for its weights from
// L2, and the latency of that chain, not bytes or FLOPs, sets the step
// time at small B: on an H100 the b1 probe (wavenet_torch/tools/
// r3_b1_bisect.py) finds the 30 filter/gate products 43% of the paper
// step, the skip products (47% of the bytes) 17%, bf16 weights (half the
// bytes) 7% slower, and a 64 x 64 product in this form takes ~1.6 us
// (r4_matvec_probe.py). The design keeps the whole chain inside one
// persistent block per group of rows:
// the activations, the skip sum and the logits row live in shared memory
// (a few KB), the weights stay in the 50 MB L2 across steps, the ring
// lives in device memory and is touched one row per layer per step, and
// larger B shares each weight read among up to 8 rows of a block.
// Matvecs split K across thread groups and add the partial sums in a
// fixed order, so a row's result does not depend on how many rows share
// its block. Plain FP32 FMAs, no tensor cores: this is the simple, right
// first version. At the wide widths the step is longer (0.63 against 0.21
// ms at b1 on an H100): the same chain, twice as wide.

// The kernel itself, with the helpers it uses, lives in sampler_step.cuh,
// which the b1 probe (b1_bisect.cu, the port of tools/r3_b1_bisect.py)
// shares, and its launch and the entries' body in sampler_decode.cuh;
// sampler_decode_ring16.cu instantiates the four modes below at a bf16
// ring (ring_load, ring_store). This file instantiates it with every part
// on, at a float32 ring, with float32
// weights (sampler_decode_f32), with bf16 weights (sampler_decode_bf16:
// weights widened on load, activations rounded to bf16 where the JAX
// kernels round them, see sampler_step.cuh) and in the local-conditioning
// mode at float32 and at bf16 weights (sampler_decode_lc_f32,
// sampler_decode_lc_bf16: the LC row of TPU kernels 1 and 2,
// sampler.py:332-364 and :1479-1535, has_lc; at bf16 the stream's row is
// rounded to bf16 at every B, as the JAX kernels cast it to lc_w's type
// at :334 and :1483). The LC mode adds
// lc_t @ lc_w[l] to every layer's filter/gate pre-activation; the terms of
// all layers are computed at the top of each step, in one pass whose loads
// are independent of each other, rather than as L more dependent products
// on the chain (sampler_step.cuh: lc_terms).

#include <cuda_runtime.h>

#include "sampler_decode.cuh"

// Dynamic shared memory of one block at rb rows at these widths (C_lc 0
// without local conditioning): smem_bytes, for the route's Python copy
// (kernels/sampler.py decode_smem_bytes) to be held against.
extern "C" long long sampler_decode_smem_bytes(int L, int R, int D, int S,
                                               int Q, int causal_width,
                                               int C_lc, int rb) {
  DecodeArgsT<float> a;
  a.L = L;
  a.R = R;
  a.D = D;
  a.S = S;
  a.Q = Q;
  a.KC = causal_width;
  a.C_lc = C_lc;
  return (long long)smem_bytes(a, rb);
}

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
  return run<float>(causal_w, layer_w, layer_add, dense_w, dense_add, skip_w,
                    skip_b, post1_w, post1_b, post2_w, post2_b, ring_meta,
                    ring, causal, forced, codes, logits, next_amp, B, L, R, D,
                    S, Q, n_total, n_forced, n_log, scalar_input,
                    causal_width, t0, seed, inv_temperature, 1, stream);
}

// The bf16 mode (the JAX kernels at weight_dtype=bfloat16): the six matmul
// weights bf16, everything else as sampler_decode_f32; round_chain as
// DecodeArgsT's (1: round the layer chain's inputs to bf16).
extern "C" int sampler_decode_bf16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, void* stream) {
  return run<__nv_bfloat16>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain,
      stream);
}

// The local-conditioning mode (float32 weights): the arguments of
// sampler_decode_f32, then lc_w [L, lc_channels, 2D] (filter | gate
// pre-scaled by 0.5), the stream lc [n_total, B, lc_channels] (row t
// conditions step t) and lc_channels.
extern "C" int sampler_decode_lc_f32(
    const float* causal_w, const float* layer_w, const float* layer_add,
    const float* dense_w, const float* dense_add, const float* skip_w,
    const float* skip_b, const float* post1_w, const float* post1_b,
    const float* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    const float* lc_w, const float* lc, int lc_channels, void* stream) {
  return run<float, true>(causal_w, layer_w, layer_add, dense_w, dense_add,
                          skip_w, skip_b, post1_w, post1_b, post2_w, post2_b,
                          ring_meta, ring, causal, forced, codes, logits,
                          next_amp, B, L, R, D, S, Q, n_total, n_forced,
                          n_log, scalar_input, causal_width, t0, seed,
                          inv_temperature, 1, stream, lc_w, lc, lc_channels);
}

// The local-conditioning mode at bf16 weights: the arguments of
// sampler_decode_bf16 (round_chain included), then lc_w [L, lc_channels,
// 2D] in bf16, the stream and lc_channels as sampler_decode_lc_f32's.
extern "C" int sampler_decode_lc_bf16(
    const __nv_bfloat16* causal_w, const __nv_bfloat16* layer_w,
    const float* layer_add, const __nv_bfloat16* dense_w,
    const float* dense_add, const __nv_bfloat16* skip_w, const float* skip_b,
    const __nv_bfloat16* post1_w, const float* post1_b,
    const __nv_bfloat16* post2_w, const float* post2_b, const int* ring_meta,
    float* ring, float* causal, const void* forced, int* codes,
    float* logits, float* next_amp, int B, int L, int R, int D, int S, int Q,
    int n_total, int n_forced, int n_log, int scalar_input, int causal_width,
    long long t0, unsigned long long seed, float inv_temperature,
    int round_chain, const __nv_bfloat16* lc_w, const float* lc,
    int lc_channels, void* stream) {
  return run<__nv_bfloat16, true>(
      causal_w, layer_w, layer_add, dense_w, dense_add, skip_w, skip_b,
      post1_w, post1_b, post2_w, post2_b, ring_meta, ring, causal, forced,
      codes, logits, next_amp, B, L, R, D, S, Q, n_total, n_forced, n_log,
      scalar_input, causal_width, t0, seed, inv_temperature, round_chain,
      stream, lc_w, lc, lc_channels);
}
