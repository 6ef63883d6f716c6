"""Autoregressive generation: prefill on PyTorch, decode in one CUDA kernel.

Counterpart of ``wavenet_tpu/kernels/sampler.py`` (host side) and of its
four decode kernels, which the one kernel ``csrc/sampler_decode.cu``
replaces (its header says which and why). Generation takes one of two
routes (``generate_cuda``):

* prefill + decode (``prefill=True``, what the CLI and the server use):
  one parallel forward over the seed fills every layer's ring rows and
  the causal register (``prefill_carry``), then one launch of ``decode``
  runs every step of every row from that state, sampling in the kernel;
* sequential (``prefill=False``, the route of the JAX package's
  single-pass HBM-ring kernel): one launch of ``decode_sequential`` from
  a zero ring steps the whole forced prefix and then samples.

Mu-law models take int32 codes; scalar-input models take float32
amplitudes (the forced prefix, the seed and the carry's last input) and
still emit mu-law codes, a sampled code re-entering as its decoded
amplitude.

Layouts differ from the TPU package where the TPU forced them: the ring
is ``[sum_d, B, R]`` (no 128-lane padding), forced inputs are
``[B, n_forced]`` and a logits window comes back ``[B, n_log, Q]`` in
step order. The b1 transposed weights, batch chunking and the ring
packing were TPU layouts and have no counterpart.

Three CUDA kernels compute the decode, launched by the same wrappers:
``csrc/sampler_cluster.cu`` (the kernel in ``csrc/sampler_cluster.cuh``)
keeps the fg and dense weights of the layer chain in the shared memory of
a thread-block cluster (one cluster per group of rows; the JAX package's
all-VMEM b1 kernel ``_sampler_kernel`` is its TPU counterpart);
``csrc/sampler_tiles.cu`` (the kernel in ``csrc/sampler_tiles.cuh``) does
the same for tens of rows a cluster at the paper/gc widths only, each
thread owning a register tile of rows x columns (the JAX package's
large-batch kernels ``_sampler_kernel_hbm_stream`` and
``_decode_kernel_packed`` are its TPU counterparts); and
``csrc/sampler_decode.cu`` streams every weight from L2 (one block per
group of rows). Before the launch, from the config, the batch size and
the device, ``cluster_plan`` takes the cluster kernel
wherever its weights fit and all its clusters are resident at once
(paper/gc b1-b120 and wide b1-b28 on an H100), ``tile_plan`` takes the
tiles kernel where the cluster kernel does not and the shape is its one
compiled shape (paper/gc b121-b525 on an H100), and ``sampler_decode``
runs elsewhere. ``kernel="cluster"``, ``"tiles"`` or ``"decode"`` pins
one. Each kernel's sums have a fixed order, so a row's codes do not depend
on the batch size within one kernel's range; the kernels' orders differ in
the last bits, so across a boundary (gc b120 and b121 on an H100) a
near-tie can draw another code.

bf16 weights (``weight_dtype=torch.bfloat16``, the JAX package's
``weight_dtype=jnp.bfloat16``) run the bf16 mode of each kernel
(``csrc/sampler_cluster_bf16.cu``, ``csrc/sampler_tiles_bf16.cu``, each its
own library, and ``sampler_decode_bf16``), on the float32 mode's plans, so
the route's ranges are the same at either weight type. The weights are
widened to float32 and each product's activation operand is rounded to
bf16 first, at the JAX kernels' points (``decode_reference`` says where);
the causal register and every sum stay float32. Generation from
a config whose ``compute_dtype`` is bfloat16 prefills at float32 and
decodes at the requested weight type, as the JAX package does.

The ring is float32, or bf16 (``state_dtype=torch.bfloat16``, the JAX
package's ``state_dtype=jnp.bfloat16`` of kernels 1-3): each layer reads
its past row widened exactly to float32 and stores its float32 input
rounded to nearest even, at either weight type, with or without LC. A
bf16 ring runs the bf16-ring version of each mode
(``csrc/sampler_decode_ring16.cu``, ``csrc/sampler_cluster*_ring16.cu``,
``csrc/sampler_tiles*_ring16.cu``, each its own library, built the first
time a bf16 ring asks for it), on the float32 ring's plans: the ring
stays in device memory in every kernel, so the route does not depend on
its type.

Local conditioning (an LC config and an ``lc`` stream, the JAX kernels'
``has_lc`` mode) runs the LC mode of ``sampler_cluster``
(``csrc/sampler_cluster_lc.cu`` and, at bf16 weights,
``csrc/sampler_cluster_lc_bf16.cu``, each its own library) and of
``sampler_decode``: row t of the stream ``[n_total, B, C_lc]`` conditions
step t, and each layer's filter/gate pre-activation gains
``lc_t @ lc_w[l]``. The term depends on the stream alone, never on the
layer chain, so the kernels compute it off the chain (see their sources).
At bf16 weights ``lc_w`` is bf16 and ``lc_t`` is rounded to bf16 at every
B, as the JAX kernels cast it to ``lc_w``'s type before either branch.
``tile_plan`` refuses LC, so an LC config runs the cluster kernel in its
range and ``sampler_decode`` above it. LC in ``sampler_tiles`` is queued
(ROADMAP.md queue 1, item 2, step 2c).

``decode_reference`` is the plain PyTorch version of the three kernels,
with the same Philox4x32-10 noise; ``decode`` and ``decode_sequential``
use it only for CPU tensors.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import (
    Params, embed_gc, forward, forward_codes, maybe_refine_lc, one_hot)
from wavenet_torch.sample import (
    _input_kernel_width, float32_config, lc_for_prime, ring_slot_blocks)


class PackedSampler(NamedTuple):
    """Kernel-ready float32 weights (shapes as the JAX package's).

    The gate half of ``layer_w``/``layer_add`` is pre-scaled by 0.5 so one
    tanh gives both tanh(f) and sigmoid(g) = 0.5 + 0.5*tanh(g/2); bias and
    GC are folded into ``layer_add``; the per-layer skip biases are summed.
    ``lc_w`` (LC configs, else None) is ``[lc_filter | 0.5 * lc_gate]``,
    pre-scaled as ``layer_w``, at the matmul weights' type.
    """
    causal_w: torch.Tensor     # [kw_in * C_in, R]  (causal register | input)
    layer_w: torch.Tensor      # [L, 2R, 2D]  (K = past|current, N = filt|gate/2)
    layer_add: torch.Tensor    # [L, B, 2D]
    dense_w: torch.Tensor      # [L, D, R]
    dense_add: torch.Tensor    # [L, 1, R]
    skip_w: torch.Tensor       # [L, D, S]
    skip_b: torch.Tensor       # [1, S]
    post1_w: torch.Tensor      # [S, S]
    post1_b: torch.Tensor      # [1, S]
    post2_w: torch.Tensor      # [S, Q]
    post2_b: torch.Tensor      # [1, Q]
    lc_w: Optional[torch.Tensor] = None   # [L, C_lc, 2D]


#: The packed fields that hold matmul weights: float32, or all six bf16.
WEIGHT_FIELDS = ("causal_w", "layer_w", "dense_w", "skip_w", "post1_w",
                 "post2_w")
#: The fields every decode entry point takes first, in its order (the LC
#: entries take ``lc_w`` later, with the stream).
KERNEL_FIELDS = tuple(f for f in PackedSampler._fields if f != "lc_w")


class StreamSamplerCarry(NamedTuple):
    """Decode state: what ``decode`` resumes from."""
    ring: torch.Tensor         # [sum_d, B, R] float32 (or bf16: RING_DTYPES)
    causal: torch.Tensor       # [B, (kw_in - 1) * C_in] float32 register
    t_abs: int                 # absolute steps completed (ring phase)
    last: torch.Tensor         # [B] the first decode input: int32 code, or
                               # float32 amplitude in scalar mode


def causal_width(config: WaveNetConfig) -> int:
    """Width of the causal shift register: (kw_in - 1) * C_in."""
    return (_input_kernel_width(config) - 1) * config.input_channels


#: The ring types a decode takes (the JAX kernels' ``state_dtype``): float32,
#: or bfloat16, whose past rows are read widened to float32 and whose new
#: rows are stored rounded to nearest even.
RING_DTYPES = (torch.float32, torch.bfloat16)


def check_state_dtype(state_dtype, name: str = "state_dtype") -> None:
    """Raise ValueError unless ``state_dtype`` (of ``name``) is one of
    RING_DTYPES."""
    if state_dtype not in RING_DTYPES:
        raise ValueError(f"{name} of type {state_dtype}: float32 or "
                         "bfloat16")


def input_dtype(config: WaveNetConfig) -> torch.dtype:
    """Forced inputs and seeds: float32 amplitudes in scalar mode, else
    int32 mu-law codes."""
    return torch.float32 if config.scalar_input else torch.int32


def zero_state(config: WaveNetConfig, batch_size: int, device=None,
               dtype: torch.dtype = torch.float32):
    """(ring, causal) of a run that starts from silence: all zeros, the
    ring at ``dtype`` (float32, or bfloat16 for a bf16 ring), the causal
    register float32."""
    c = config
    ring = torch.zeros((sum(c.dilations), batch_size, c.residual_channels),
                       dtype=dtype, device=device)
    causal = torch.zeros((batch_size, causal_width(c)), dtype=torch.float32,
                         device=device)
    return ring, causal


def pack_sampler_weights(params: Params, config: WaveNetConfig,
                         batch_size: int,
                         gc_embedding: Optional[torch.Tensor] = None,
                         weight_dtype=torch.float32) -> PackedSampler:
    """Rearrange the parameter dict into the kernel's layout.

    ``weight_dtype=torch.bfloat16`` stores the matmul weights (``lc_w``
    too) in bf16, as the JAX package does; the additive terms stay
    float32. ``decode`` then runs the kernels' bf16 mode."""
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype {weight_dtype}: float32 or bfloat16")
    c = config
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    f32 = torch.float32
    causal_w = params["causal_filter"].to(f32).reshape(-1, R)
    wf, wg = params["filter"].to(f32), 0.5 * params["gate"].to(f32)
    layer_w = torch.cat([
        torch.cat([wf[:, 0], wg[:, 0]], dim=-1),          # past rows
        torch.cat([wf[:, 1], wg[:, 1]], dim=-1),          # current rows
    ], dim=1)                                             # [L, 2R, 2D]
    dev = layer_w.device
    add = torch.zeros((L, batch_size, 2 * D), dtype=f32, device=dev)
    if c.use_biases:
        b = torch.cat([params["filter_bias"], 0.5 * params["gate_bias"]],
                      dim=-1).to(f32)
        add = add + b[:, None, :]
    if gc_embedding is not None:
        gce = gc_embedding.to(f32)
        gcf = torch.einsum("bg,lgd->lbd", gce, params["gc_filter"].to(f32))
        gcg = torch.einsum("bg,lgd->lbd", gce, params["gc_gate"].to(f32))
        add = add + torch.cat([gcf, 0.5 * gcg], dim=-1)
    if c.use_biases:
        dense_add = params["dense_bias"].to(f32)[:, None, :]
        skip_b = params["skip_bias"].to(f32).sum(dim=0)[None, :]
        post1_b = params["postprocess1_bias"].to(f32)[None, :]
        post2_b = params["postprocess2_bias"].to(f32)[None, :]
    else:
        dense_add = torch.zeros((L, 1, R), dtype=f32, device=dev)
        skip_b = torch.zeros((1, S), dtype=f32, device=dev)
        post1_b = torch.zeros((1, S), dtype=f32, device=dev)
        post2_b = torch.zeros((1, Q), dtype=f32, device=dev)
    wt = weight_dtype
    lc_w = None
    if c.lc_enabled:
        lc_w = torch.cat([params["lc_filter"].to(f32),
                          0.5 * params["lc_gate"].to(f32)],
                         dim=-1).to(wt).contiguous()      # [L, C_lc, 2D]
    return PackedSampler(*(t.contiguous() for t in (
        causal_w.to(wt), layer_w.to(wt), add, params["dense"].to(wt),
        dense_add, params["skip"].to(wt), skip_b,
        params["postprocess1"].to(wt), post1_b,
        params["postprocess2"].to(wt), post2_b)), lc_w=lc_w)


def ring_offsets(config: WaveNetConfig) -> Tuple[int, ...]:
    """Per-layer start rows in the packed ring buffer."""
    return tuple(int(o) for o in np.cumsum((0,) + config.dilations[:-1]))


def unseeded_seed_codes(config: WaveNetConfig, batch_size: int, seed: int,
                        device=None) -> torch.Tensor:
    """receptive_field-1 silence codes, then one uniform-random code.

    The same recipe as the JAX package; the random code comes from a
    ``torch.Generator`` seeded with ``seed``, so it differs from JAX's.
    Scalar mode primes receptive_field amplitudes of silence (0.0).
    """
    c = config
    if c.scalar_input:
        return torch.zeros((batch_size, c.receptive_field),
                           dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(int(seed))
    first = torch.randint(0, c.quantization_channels, (batch_size, 1),
                          generator=gen, dtype=torch.int64)
    silence = torch.full((batch_size, c.receptive_field - 1),
                         c.quantization_channels // 2, dtype=torch.int64)
    return torch.cat([silence, first], dim=1).to(torch.int32).to(device)


def chunk_seed(seed: int, i: int) -> int:
    """Seed for batch chunk ``i`` (the JAX package's splitmix-style mix).

    The port decodes any batch in one launch with Philox counters keyed
    per row, so it chunks nothing; this keeps the JAX seeding available
    to callers that split a batch themselves.
    """
    return int((seed * 0x9E3779B9 + i) & 0x7FFFFFFF)


@contextlib.contextmanager
def _full_float32():
    """Float32 matmuls and convolutions in full float32 (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def prefill_carry(params: Params, config: WaveNetConfig,
                  seed_codes: torch.Tensor,
                  gc_ids: Optional[torch.Tensor] = None,
                  lc: Optional[torch.Tensor] = None
                  ) -> StreamSamplerCarry:
    """Parallel queue priming: one forward replaces T-1 decode steps.

    The ring after teacher-forcing steps 0..T-2 is the residual stream
    entering each layer at its last d_l positions, which one parallel
    forward computes (``forward_codes`` on mu-law codes, ``forward`` on
    amplitudes in scalar mode). The carry resumes decoding at absolute
    step T-1 with ``seed_codes[:, -1]`` as the first input. The forward
    runs at float32 whatever the config's ``compute_dtype``
    (``float32_config``), as the JAX package's prefill does. ``lc``
    [B, >= T-1, C_lc] conditions the primed steps (its first T-1 rows,
    already refined).
    """
    c = float32_config(config)
    if c.filter_width != 2:
        raise NotImplementedError("sampler_decode requires filter_width=2")
    seed_codes = seed_codes.to(input_dtype(c))
    B, T = seed_codes.shape
    last = seed_codes[:, -1].contiguous()
    if T == 1:
        ring, causal = zero_state(c, B, seed_codes.device)
        return StreamSamplerCarry(ring, causal, 0, last)
    ring, causal = _prefill_state(params, c, seed_codes, gc_ids, lc)
    return StreamSamplerCarry(ring, causal, T - 1, last)


def _prefill_state(params: Params, config: WaveNetConfig,
                   seed_codes: torch.Tensor,
                   gc_ids: Optional[torch.Tensor],
                   lc: Optional[torch.Tensor] = None):
    """(ring, causal) after teacher-forcing steps 0..T-2."""
    c = config
    B = seed_codes.shape[0]
    T_pre = seed_codes.shape[1] - 1
    keep = tuple(min(d, T_pre) for d in c.dilations)
    lc_in = None if lc is None else lc[:, :T_pre].to(seed_codes.device)
    with torch.no_grad(), _full_float32():
        gc_emb = (embed_gc(params, c, gc_ids.to(seed_codes.device))
                  if gc_ids is not None else None)
        if c.scalar_input:
            layer_ins = forward(params, c, seed_codes[:, :T_pre, None],
                                gc_emb, collect_layer_inputs=keep,
                                lc=lc_in)
        else:
            layer_ins = forward_codes(params, c, seed_codes[:, :T_pre],
                                      gc_emb, collect_layer_inputs=keep,
                                      lc=lc_in)
        # Ring row offsets[l] + tau % d holds x_l(tau) for the last
        # min(d, T_pre) positions tau < T_pre; other rows stay zero.
        ring = torch.cat(ring_slot_blocks(layer_ins, c.dilations, T_pre),
                         dim=0).contiguous()
        if c.scalar_input:
            # Causal register: amplitudes T_pre-kw+1 .. T_pre-1, oldest
            # first, zero-padded on the left.
            n_tail = causal_width(c)
            tail = seed_codes[:, max(0, T_pre - n_tail):T_pre]
            causal = torch.cat([tail.new_zeros((B, n_tail - tail.shape[1])),
                                tail], dim=1).contiguous()
        else:
            # Causal register: the one-hot of input T_pre - 1.
            causal = one_hot(seed_codes[:, T_pre - 1],
                             c.quantization_channels).contiguous()
    return ring, causal


# ---------------------------------------------------------------------------
# Philox4x32-10 noise (the kernel's generator, in int64 tensor ops)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for uint32 values held in int64,
    computed in 16-bit pieces so no int64 product overflows."""
    p_lo = m * (x & 0xFFFF)                      # < 2**48
    p_hi = m * (x >> 16)                         # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)         # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123): four uint32 counter words (int64
    tensors, broadcastable) and two uint32 key words -> four words."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0), lo1, (hi0 ^ c3 ^ k1), lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def gumbel_noise(seed: int, batch_size: int, step0: int, n_steps: int,
                 n_classes: int, device=None) -> torch.Tensor:
    """The kernel's Gumbel noise for steps step0..step0+n_steps-1:
    [n_steps, B, Q] float32. Counter = (class block, row, step lo, hi)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    n_blk = -(-n_classes // 4)
    i64 = dict(dtype=torch.int64, device=device)
    step = step0 + torch.arange(n_steps, **i64)
    blk = torch.arange(n_blk, **i64)[None, None, :]
    row = torch.arange(batch_size, **i64)[None, :, None]
    shape = (n_steps, batch_size, n_blk)
    words = philox4x32(
        (blk.expand(shape), row.expand(shape),
         (step & _M32)[:, None, None].expand(shape),
         (step >> 32)[:, None, None].expand(shape)),
        (seed & _M32, seed >> 32))
    bits = torch.stack(words, dim=-1).reshape(n_steps, batch_size,
                                              4 * n_blk)[..., :n_classes]
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(u, 1e-20)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Decode: the kernel's wrappers and its plain version
# ---------------------------------------------------------------------------

def _n_log(collect_logits, n_total: int) -> int:
    if collect_logits is True:
        return n_total
    if not collect_logits:
        return 0
    return min(int(collect_logits), n_total)


def decode_amp(code: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    """A sampled code as the next input of a scalar-input model: the JAX
    kernels' mu-law decode (exp of |x| * log1p(mu)), the formula of the
    CUDA kernel. On the card the two can differ in the last bits (PyTorch
    divides by a scalar through its reciprocal), so a resumed launch
    starts from the kernel's own value (``decode(next_amp=...)``)."""
    mu = float(quantization_channels - 1)
    sgn = 2.0 * (code.to(torch.float32) / mu) - 1.0
    mag = (1.0 / mu) * (torch.exp(torch.abs(sgn) * float(np.log1p(mu)))
                        - 1.0)
    return torch.sign(sgn) * mag


def mu_law_encode_f(amp: torch.Tensor,
                    quantization_channels: int) -> torch.Tensor:
    """The code a forced amplitude emits in scalar mode (clamp |amp| <= 1,
    then + 0.5 and truncate, as the JAX kernels do)."""
    mu = float(quantization_channels - 1)
    safe = torch.clamp(torch.abs(amp), max=1.0)
    magnitude = torch.log1p(mu * safe) * float(1.0 / np.log1p(mu))
    signal = torch.sign(amp) * magnitude
    return ((signal + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def _bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """An activation as the operand of a product with bf16 weights: rounded
    to bf16 (round to nearest even) and widened back, as the JAX kernels'
    ``x.astype(w_ref.dtype)`` before ``mxu_dot``."""
    return x.to(torch.bfloat16).to(torch.float32)


def weight_dtype_of(packed: PackedSampler) -> torch.dtype:
    """The type of the packed matmul weights: float32 or bfloat16."""
    return packed.layer_w.dtype


def chain_rounded(route: str, B: int, lc: bool = False,
                  ring16: bool = False) -> bool:
    """Whether a bf16 decode rounds the layer chain's inputs to bf16: on
    ``route`` "decode" (:func:`decode`, the JAX package's prefill route,
    kernels 1-3) unless B == 1, where JAX multiplies float32 activations by
    the widened weights (its VPU chain); on "sequential"
    (:func:`decode_sequential`, kernel 4, which has no b1 branch) at every
    B. With local conditioning (``lc``) or a bf16 ring (``ring16``) the
    sequential route follows the decode rule: kernel 4 takes neither, and
    JAX runs such a run from a zero ring on kernel 1 or 2, whose b1 branch
    is the VPU chain."""
    if route == "decode" or (route == "sequential" and (lc or ring16)):
        return B != 1
    if route == "sequential":
        return True
    raise ValueError(f"chain_rounded: unknown route {route!r}")


def decode_reference(packed: PackedSampler, config: WaveNetConfig,
                     ring: torch.Tensor, causal: torch.Tensor,
                     forced: torch.Tensor, n_total: int, t0: int, seed: int,
                     temperature: float = 1.0, collect_logits=False,
                     next_amp: Optional[torch.Tensor] = None,
                     round_chain: Optional[bool] = None,
                     lc: Optional[torch.Tensor] = None):
    """Plain PyTorch version of ``sampler_decode`` (same contract as
    :func:`decode`): a Python loop over steps, batched over rows. With
    ``lc`` [n_total, B, C_lc] (an LC config) step t computes
    ``fg = [past | current] @ layer_w[l] + layer_add[l] + lc[t] @ lc_w[l]``,
    in the JAX kernels' order.

    With bf16 weights (``pack_sampler_weights(..., weight_dtype=
    torch.bfloat16)``) it computes what the JAX kernels compute at
    ``weight_dtype=bfloat16``: the weights are widened to float32 and the
    activation operand of a product is rounded to bf16 first; products,
    sums, adds, tanh and the causal register stay float32 (the ring too,
    unless it is bf16: see below). The
    causal window and the head's two inputs are always rounded; the layer
    chain's three inputs (filter/gate ``[past | current]``, dense, skip)
    only where ``round_chain`` is true; ``None`` takes :func:`decode`'s
    rule (:func:`chain_rounded`). The LC row ``lc[t]`` is always rounded,
    whatever ``round_chain`` says: the JAX kernels cast it to ``lc_w``'s
    type before either of their branches, the b1 VPU chain included.
    Float32 weights ignore ``round_chain``.

    A bf16 ``ring`` (the JAX kernels at ``state_dtype=bfloat16``) holds
    each layer's past inputs rounded: a layer reads its past row widened
    exactly to float32, and stores its float32 input rounded to nearest
    even; the input enters ``[past | current]`` unrounded, and everything
    else stays as at a float32 ring. This is the plain version of every
    bf16-ring mode of the three kernels.
    """
    c = config
    L, D, Q = c.num_layers, c.dilation_channels, c.quantization_channels
    scalar, C_in = c.scalar_input, c.input_channels
    B, n_forced = forced.shape
    dev = ring.device
    offs, dil = ring_offsets(c), c.dilations
    n_log = _n_log(collect_logits, n_total)
    log_from = n_total - n_log
    inv_t = float(np.float32(1.0 / temperature))
    bf16 = weight_dtype_of(packed) == torch.bfloat16
    check_state_dtype(ring.dtype, "sampler_decode: ring")
    check_lc(c, lc)
    _check_lc_operands(packed, c, lc, n_total, B, dev)
    if round_chain is None:
        round_chain = chain_rounded("decode", B)
    keep = lambda x: x                                    # noqa: E731
    # The operands rounded at every B (the causal window, the LC row, the
    # head's inputs), and the layer chain's.
    always_in = _bf16_operand if bf16 else keep
    chain_in = _bf16_operand if bf16 and round_chain else keep
    w = packed._replace(**{k: getattr(packed, k).to(torch.float32)
                           for k in WEIGHT_FIELDS})
    if lc is not None:
        w = w._replace(lc_w=packed.lc_w.to(torch.float32))
    codes = torch.empty((B, n_total), dtype=torch.int32, device=dev)
    logits = (torch.empty((B, n_log, Q), dtype=torch.float32, device=dev)
              if n_log else None)
    chunk = max(1, (1 << 20) // (B * Q))
    # The current input: an amplitude (scalar mode) or a code.
    x = forced[:, 0].to(torch.float32) if scalar else forced[:, 0].long()
    with torch.no_grad(), _full_float32():
        for t in range(n_total):
            if t % chunk == 0:
                noise = gumbel_noise(seed, B, t0 + t,
                                     min(chunk, n_total - t), Q, dev)
            feature = (x[:, None] if scalar
                       else F.one_hot(x, Q).to(torch.float32))
            window = torch.cat([causal, feature], dim=-1)
            cur = always_in(window) @ w.causal_w
            causal.copy_(window[:, C_in:])
            skip = None
            for l in range(L):
                pos = offs[l] + (t0 + t) % dil[l]
                past = ring[pos].to(torch.float32, copy=True)
                ring[pos] = cur            # a bf16 ring rounds to nearest even
                fg = (chain_in(torch.cat([past, cur], dim=-1)) @ w.layer_w[l]
                      + w.layer_add[l])
                if lc is not None:
                    fg = fg + always_in(lc[t]) @ w.lc_w[l]
                tg = torch.tanh(fg)
                out = tg[:, :D] * (0.5 + 0.5 * tg[:, D:])
                cur = cur + chain_in(out) @ w.dense_w[l] + w.dense_add[l]
                s = chain_in(out) @ w.skip_w[l]
                skip = s if skip is None else skip + s
            h = torch.relu(skip + w.skip_b)
            h = torch.relu(always_in(h) @ w.post1_w + w.post1_b)
            lg = always_in(h) @ w.post2_w + w.post2_b
            if n_log and t >= log_from:
                logits[:, t - log_from] = lg
            sampled = torch.argmax(lg * inv_t + noise[t % chunk], dim=-1)
            if t + 1 < n_forced:
                nxt = forced[:, t + 1]
                code = mu_law_encode_f(nxt, Q) if scalar else nxt
                x = nxt.to(torch.float32) if scalar else nxt.long()
            else:
                code = sampled
                x = decode_amp(sampled, Q) if scalar else sampled
            codes[:, t] = code.to(torch.int32)
        if next_amp is not None:
            next_amp.copy_(x)
    return codes, logits


# ---------------------------------------------------------------------------
# The route: which of the two decode kernels runs
# ---------------------------------------------------------------------------

#: Threads of a block of either kernel (``kThreads`` in the sources).
THREADS = 256
#: Cluster sizes the plan tries, smallest first; above 8 CTAs a cluster is
#: "non-portable" (Hopper allows 16).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: Rows of the batch one cluster serves.
CLUSTER_ROWS = tuple(range(1, 9))


class ClusterPlan(NamedTuple):
    """How ``sampler_cluster`` splits a launch: clusters of ``CS`` CTAs,
    each serving ``RB`` rows; CTA k owns layers
    ``layer_begin[k]:layer_begin[k + 1]``."""
    CS: int
    RB: int
    layer_begin: Tuple[int, ...]


def layer_split(num_layers: int, cs: int) -> Tuple[int, ...]:
    """Contiguous layer ranges of ``cs`` CTAs, in order: ceil(L / cs) layers
    each, the shortfall taken from the last CTAs (at least one layer each).
    The last CTA's skip products sit on the step's critical path, so it
    gets the fewest."""
    base = -(-num_layers // cs)
    sizes = [base] * cs
    excess = base * cs - num_layers
    for k in range(cs - 1, -1, -1):
        take = min(excess, sizes[k] - 1)
        sizes[k] -= take
        excess -= take
    return tuple(int(x) for x in np.cumsum([0] + sizes))


def _chain_floats(R: int, D: int) -> Tuple[int, int]:
    """Floats of one layer's filter/gate and dense weights as
    ``sampler_cluster`` lays them out for its warps (``chain_shape``):
    8 warps x 32 lanes x the K terms a lane adds."""
    fg_groups, d_groups = 128 // D, 256 // R
    return (256 * -(-2 * R // fg_groups), 256 * -(-D // d_groups))


def cluster_smem_bytes(config: WaveNetConfig, cs: int, rb: int) -> int:
    """Dynamic shared memory of one ``sampler_cluster`` CTA: the carve-up
    at the top of its kernel (``cluster_smem_bytes`` there, which the
    library exports as ``sampler_cluster_smem_bytes`` for the card's tests
    to hold this copy against). An LC config's CTA also holds, a row, its
    layers' LC terms and the step's feature row (``sampler_cluster_lc``'s
    export, ``sampler_cluster_lc_smem_bytes``)."""
    c = config
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    nl = -(-L // cs)
    fg, dense = _chain_floats(R, D)
    per_cta = nl * (fg + dense + R) + 2 * nl + 2 * cs * rb
    per_row = (nl * (2 * D + 2 * R + D) + R + 3 * S + Q // cs
               + causal_width(c) + R + THREADS + 2)
    if c.lc_enabled:
        per_row += nl * 2 * D + c.lc_channels
    return 16 + 4 * (per_cta + rb * per_row)


def cluster_plan(config: WaveNetConfig, batch_size: int, smem_optin: int,
                 resident_clusters: Callable[[int, int, int], int]
                 ) -> Optional[ClusterPlan]:
    """The ``sampler_cluster`` launch for this config and batch on a device
    with ``smem_optin`` bytes of shared memory per block that keeps
    ``resident_clusters(CS, RB, smem bytes a CTA)`` clusters resident at
    once, or None (``sampler_decode`` then runs).

    The cluster size is a function of the config and the device alone, so
    that a row's sums (the layer split, the head's column split) and hence
    its codes do not depend on the batch size while the plan finds a
    launch: the smallest CS whose CTA
    holds the fg and dense weights of ceil(L / CS) layers and its scratch
    at the largest RB that fits at any CS <= 16. The rows per cluster are
    then the fewest that keep every cluster resident in one wave. Where
    no RB does, None.
    """
    c = config
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    if (c.filter_width != 2 or batch_size < 1
            or D not in (8, 16, 32, 64, 128)
            or R not in (8, 16, 32, 64, 128, 256)
            or causal_width(c) > THREADS):
        return None
    for rb_max in sorted(CLUSTER_ROWS, reverse=True):
        fits = [cs for cs in CLUSTER_SIZES
                if cs <= L and S % cs == 0 and Q % (4 * cs) == 0
                and cluster_smem_bytes(c, cs, rb_max) <= smem_optin]
        if fits:
            cs = fits[0]
            break
    else:
        return None
    for rb in CLUSTER_ROWS:
        if rb > rb_max:
            break
        resident = resident_clusters(cs, rb, cluster_smem_bytes(c, cs, rb))
        if -(-batch_size // rb) <= resident:
            return ClusterPlan(cs, rb, layer_split(L, cs))
    return None


class TilePlan(NamedTuple):
    """How ``sampler_tiles`` splits a launch: clusters of ``CS`` (8) CTAs,
    each serving ``RB`` rows; CTA k owns layers
    ``layer_begin[k]:layer_begin[k + 1]``."""
    CS: int
    RB: int
    layer_begin: Tuple[int, ...]


#: The tiles kernel's cluster size, and the rows a cluster it takes (2 to
#: 5 rows a thread over 8 row lanes): up to the 35 of gc b512 on an H100,
#: the largest batch timed beside ``sampler_decode``.
TILE_CS = 8
TILE_ROWS = tuple(range(1, 36))


def tile_shape(config: WaveNetConfig) -> bool:
    """Whether ``config`` is the one shape ``sampler_tiles`` is compiled
    for: the paper/gc widths (R = D = 32, S = 512, Q = 256), mu-law input,
    filter width 2, no LC, 8 to 32 layers (at most 4 a CTA)."""
    c = config
    return (c.residual_channels == 32 and c.dilation_channels == 32
            and c.skip_channels == 512 and c.quantization_channels == 256
            and not c.scalar_input and c.filter_width == 2
            and not c.lc_enabled and causal_width(c) == 256
            and TILE_CS <= c.num_layers <= 4 * TILE_CS)


def tile_smem_bytes(rb: int) -> int:
    """Dynamic shared memory of one ``sampler_tiles`` CTA at ``rb`` rows a
    cluster: the carve-up in the header of its source (``tiles_smem_bytes``
    there, exported as ``sampler_tiles_smem_bytes`` for the card's tests to
    hold this copy against). The rows are padded to 8 x rows a thread."""
    rbp = 8 * (2 if rb <= 16 else -(-rb // 8))
    per_cta = 4 * (2 * 32 * 2 * 32 + 32 * (32 + 4) + 32) + 2 * 4
    per_row = (512 + 4) + (4 * 32 + 4) + 256 // 8 + 2 * 8 + 2
    # outs and cur, or the head's 4 tiles of 1,024 floats over them.
    stage = max(rbp * ((4 * 32 + 4) + (32 + 4)), 4 * 1024)
    return 16 + 4 * (per_cta + rbp * per_row + stage)


def tile_plan(config: WaveNetConfig, batch_size: int, smem_optin: int,
              resident_clusters: Callable[[int, int, int], int],
              cluster_resident: Callable[[int, int, int], int],
              weight_dtype: torch.dtype = torch.float32
              ) -> Optional[TilePlan]:
    """The ``sampler_tiles`` launch for this config and batch on a device
    with ``smem_optin`` bytes of shared memory per block that keeps
    ``resident_clusters(8, RB, smem bytes a CTA)`` of its clusters resident
    at once, or None.

    None outside the kernel's compiled shape (``tile_shape``), for a
    weight type other than float32 or bfloat16, and wherever
    ``cluster_plan`` finds a launch with the device's count of the cluster
    kernel's clusters (``cluster_resident``), so that b1-b120 keep
    ``sampler_cluster`` and their codes. Else the fewest rows a cluster
    that keep every cluster resident in one wave (15 clusters of 8 on an
    H100: RB 9 at b121-b135, 35 at b512 and at the top, b525), and the
    layer split ``layer_split(L, 8)``, which does not depend on B. Both
    weight types take the same plan: the bf16 mode widens the layer
    weights into the float32 mode's shared memory.
    """
    if (batch_size < 1
            or weight_dtype not in (torch.float32, torch.bfloat16)
            or not tile_shape(config)
            or cluster_plan(config, batch_size, smem_optin,
                            cluster_resident) is not None):
        return None
    for rb in TILE_ROWS:
        nbytes = tile_smem_bytes(rb)
        if nbytes > smem_optin:
            return None
        if -(-batch_size // rb) <= resident_clusters(TILE_CS, rb, nbytes):
            return TilePlan(TILE_CS, rb,
                            layer_split(config.num_layers, TILE_CS))
    return None


#: The opt-in shared memory of a block on an H100 SXM (the constant of the
#: kernels' shared-memory asserts): what the route assumes of a card it
#: cannot ask, on the CPU, so that the choice there is the card's.
H100_SMEM_OPTIN = 232448


def decode_smem_bytes(config: WaveNetConfig, rb: int) -> int:
    """Dynamic shared memory of one ``sampler_decode`` block at ``rb`` rows:
    the carve-up at the top of its kernel (``smem_bytes`` in
    ``csrc/sampler_step.cuh``, exported as ``sampler_decode_smem_bytes``
    for the card's tests to hold this copy against). The weights stay in
    device memory; a row holds its activations, and an LC config's also
    its layers' LC terms and the step's feature row."""
    c = config
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    warps = THREADS // 32
    lc = c.lc_channels + 2 * L * D if c.lc_enabled else 0
    floats = (rb * (causal_width(c) + Q + 3 * (R + D + S) + THREADS + 1 + lc)
              + warps)
    ints = warps + 2 * L + rb
    return 4 * (floats + ints)


def can_decode(config: WaveNetConfig, smem_optin: int) -> bool:
    """Whether a decode kernel launches for this config at every batch on
    a device with ``smem_optin`` bytes of opt-in shared memory a block:
    filter_width 2, and one row of ``sampler_decode`` (``route_plan``'s
    last resort, which serves any batch a row a block) within the opt-in.
    No config of the repo comes near it: the sharded config's row is ~16
    KB."""
    return (config.filter_width == 2
            and decode_smem_bytes(config, 1) <= smem_optin)


def route_plan(config: WaveNetConfig, batch_size: int, smem_optin: int,
               cluster_resident: Callable[[int, int, int], int],
               tile_resident: Callable[[int, int, int], int],
               weight_dtype: torch.dtype = torch.float32,
               kernel: str = "auto"):
    """The decode route, pure: (kernel, plan) that ``decode(kernel=...)``
    launches for this config and batch on a device with ``smem_optin``
    bytes of opt-in shared memory a block that keeps ``cluster_resident``
    / ``tile_resident`` clusters of either cluster kernel resident:
    ("cluster", its plan) where ``cluster_plan`` finds a launch, ("tiles",
    its plan) where ``tile_plan`` does, ("decode", None) where
    ``can_decode``; a pinned ``kernel`` tries only its own rung. (None,
    None) where none can launch."""
    c = config
    if c.filter_width != 2 or batch_size < 1:
        return None, None
    if kernel in ("auto", "cluster"):
        plan = cluster_plan(c, batch_size, smem_optin, cluster_resident)
        if plan is not None:
            return "cluster", plan
    if kernel in ("auto", "tiles"):
        plan = tile_plan(c, batch_size, smem_optin, tile_resident,
                         cluster_resident, weight_dtype)
        if plan is not None:
            return "tiles", plan
    if kernel in ("auto", "decode") and can_decode(c, smem_optin):
        return "decode", None
    return None, None


def decode_route(config: WaveNetConfig, batch_size: int, smem_optin: int,
                 cluster_resident: Callable[[int, int, int], int],
                 tile_resident: Callable[[int, int, int], int],
                 weight_dtype: torch.dtype = torch.float32
                 ) -> Optional[str]:
    """The kernel that ``decode(kernel="auto")`` launches ("cluster",
    "tiles", "decode"), or None where none can: ``route_plan``'s name."""
    return route_plan(config, batch_size, smem_optin, cluster_resident,
                      tile_resident, weight_dtype)[0]


KERNEL_CHOICES = ("auto", "cluster", "tiles", "decode")


#: The arguments every decode entry point takes first: 18 pointers, 11
#: ints, t0, the seed and 1 / temperature.
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 11
                    + [ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_float])
#: Then the bf16 entries' ``round_chain``; the LC entries' ``lc_w``, stream
#: and C_lc; the cluster and tiles entries' plan (cs, rb, layer_begin);
#: last, the stream.
_ROUND = [ctypes.c_int]
_LC = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_PLAN = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _bind(lib) -> None:
    lib.sampler_decode_f32.argtypes = _DECODE_ARGTYPES + [ctypes.c_void_p]
    lib.sampler_decode_bf16.argtypes = (_DECODE_ARGTYPES + _ROUND
                                        + [ctypes.c_void_p])
    lib.sampler_decode_lc_f32.argtypes = (_DECODE_ARGTYPES + _LC
                                          + [ctypes.c_void_p])
    lib.sampler_decode_lc_bf16.argtypes = (_DECODE_ARGTYPES + _ROUND + _LC
                                           + [ctypes.c_void_p])
    lib.sampler_decode_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.sampler_decode_smem_bytes.restype = ctypes.c_longlong
    for fn in (lib.sampler_decode_f32, lib.sampler_decode_bf16,
               lib.sampler_decode_lc_f32, lib.sampler_decode_lc_bf16):
        fn.restype = ctypes.c_int


def _bind_cluster_lc(lib, bf16: bool = False) -> None:
    """Bind an LC cluster library: ``sampler_cluster_lc``
    (``sampler_cluster_lc_f32``) or, with ``bf16``,
    ``sampler_cluster_lc_bf16`` (which takes ``round_chain``); each exports
    its shared-memory size."""
    if bf16:
        fn, smem = (lib.sampler_cluster_lc_bf16,
                    lib.sampler_cluster_lc_bf16_smem_bytes)
        fn.argtypes = (_DECODE_ARGTYPES + _ROUND + _LC + _PLAN
                       + [ctypes.c_void_p])
    else:
        fn, smem = (lib.sampler_cluster_lc_f32,
                    lib.sampler_cluster_lc_smem_bytes)
        fn.argtypes = _DECODE_ARGTYPES + _LC + _PLAN + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 9
    smem.restype = ctypes.c_longlong


def _bind_cluster(lib) -> None:
    fn = lib.sampler_cluster_f32
    fn.argtypes = _DECODE_ARGTYPES + _PLAN + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sampler_cluster_smem_optin.argtypes = [ctypes.c_void_p]
    lib.sampler_cluster_smem_optin.restype = ctypes.c_int
    lib.sampler_cluster_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.sampler_cluster_smem_bytes.restype = ctypes.c_longlong
    lib.sampler_cluster_max_clusters.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.sampler_cluster_max_clusters.restype = ctypes.c_int


def _entry(used: str, bf16: bool, lc: bool, ring16: bool):
    """The C entry point of one mode of a decode kernel (``used``: "decode",
    "cluster" or "tiles"), bound: ``sampler_<kernel>[_lc]_<f32|bf16>``, with
    ``_ring16`` at a bf16 ring, from the library of that mode (built from
    ``csrc/<library>.cu`` at first use): ``sampler_<kernel>[_lc][_bf16]``,
    ``sampler_decode`` for all four of its modes, each with ``_ring16`` at
    a bf16 ring. It takes the decode arguments, then ``round_chain`` (bf16
    weights), the LC operands (LC), the plan (cluster, tiles), the
    stream."""
    from wavenet_torch.kernels import _build
    mode = ("_lc" if lc else "") + ("_bf16" if bf16 else "_f32")
    r16 = "_ring16" if ring16 else ""
    lib = ("sampler_decode" if used == "decode"
           else f"sampler_{used}{mode}".replace("_f32", "")) + r16
    fn = getattr(_build.load(lib), f"sampler_{used}{mode}{r16}")
    fn.argtypes = (_DECODE_ARGTYPES + (_ROUND if bf16 else [])
                   + (_LC if lc else []) + (_PLAN if used != "decode" else [])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_tiles(lib, bf16: bool = False) -> None:
    """Bind a tiles library: ``sampler_tiles`` (``sampler_tiles_f32``) or,
    with ``bf16``, ``sampler_tiles_bf16`` (which takes ``round_chain``);
    both export the shared-memory and residency queries."""
    if bf16:
        fn = lib.sampler_tiles_bf16
        fn.argtypes = _DECODE_ARGTYPES + _ROUND + _PLAN + [ctypes.c_void_p]
    else:
        fn = lib.sampler_tiles_f32
        fn.argtypes = _DECODE_ARGTYPES + _PLAN + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sampler_tiles_smem_bytes.argtypes = [ctypes.c_int]
    lib.sampler_tiles_smem_bytes.restype = ctypes.c_longlong
    lib.sampler_tiles_max_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.sampler_tiles_max_clusters.restype = ctypes.c_int


class _Device(NamedTuple):
    """What the route reads of one CUDA device: its opt-in shared memory
    per block, and ``resident(cs, rb, smem bytes)`` of either kernel, the
    clusters it keeps resident at once."""
    smem_optin: int
    cluster_resident: Callable[[int, int, int], int]
    tile_resident: Callable[[int, int, int], int]


_DEVICES = {}    # CUDA device index -> _Device


def _device(device) -> _Device:
    """The route's reading of ``device`` (or the current CUDA device),
    taken once per device; each count of resident clusters is taken at its
    first use, and the tiles kernel's library is loaded only for its own."""
    from wavenet_torch.kernels import _build
    if device is not None:
        torch.cuda.set_device(device)
    dev = torch.cuda.current_device()
    if dev in _DEVICES:
        return _DEVICES[dev]
    cluster_lib = _build.load("sampler_cluster")
    _bind_cluster(cluster_lib)
    smem = ctypes.c_int(0)
    err = cluster_lib.sampler_cluster_smem_optin(ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"sampler_cluster: CUDA error {err} reading the "
                           "device's attributes")
    counts = {}

    def count(kernel: str, cs: int, rb: int, nbytes: int) -> int:
        key = (kernel, cs, rb, nbytes)
        if key not in counts:
            n = ctypes.c_int(0)
            if kernel == "tiles":
                lib = _build.load("sampler_tiles")
                _bind_tiles(lib)
                err = lib.sampler_tiles_max_clusters(rb, ctypes.byref(n))
            else:
                err = cluster_lib.sampler_cluster_max_clusters(
                    cs, rb, nbytes, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"sampler_{kernel}: CUDA error {err} "
                                   "counting resident clusters")
            counts[key] = n.value
        return counts[key]

    _DEVICES[dev] = _Device(smem.value,
                            lambda cs, rb, n: count("cluster", cs, rb, n),
                            lambda cs, rb, n: count("tiles", cs, rb, n))
    return _DEVICES[dev]


def device_plan(config: WaveNetConfig, batch_size: int,
                device=None) -> Optional[ClusterPlan]:
    """``cluster_plan`` with the opt-in shared memory and the resident
    clusters of the current CUDA device (as ``sampler_cluster`` reads
    them)."""
    d = _device(device)
    return cluster_plan(config, batch_size, d.smem_optin, d.cluster_resident)


def device_tile_plan(config: WaveNetConfig, batch_size: int, device=None,
                     weight_dtype: torch.dtype = torch.float32
                     ) -> Optional[TilePlan]:
    """``tile_plan`` with the opt-in shared memory of the current CUDA
    device and its counts of resident clusters of either kernel."""
    d = _device(device)
    return tile_plan(config, batch_size, d.smem_optin, d.tile_resident,
                     d.cluster_resident, weight_dtype)


def device_decode_route(config: WaveNetConfig, batch_size: int,
                        device=None,
                        weight_dtype: torch.dtype = torch.float32
                        ) -> Optional[str]:
    """``decode_route`` with the opt-in shared memory and the counts of
    resident clusters of the current CUDA device."""
    d = _device(device)
    return decode_route(config, batch_size, d.smem_optin, d.cluster_resident,
                        d.tile_resident, weight_dtype)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(
            f"sampler_decode: {name} must be {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"sampler_decode: {name} must be contiguous")


def check_lc_mode(kernel: str = "auto") -> None:
    """What the LC modes run: the cluster or decode kernel, at float32 or
    bf16 weights. A pinned tiles kernel raises NotImplementedError naming
    the ROADMAP.md step that owns it."""
    if kernel == "tiles":
        raise NotImplementedError(
            "sampler_tiles has no local-conditioning mode yet (ROADMAP.md "
            "queue 1, item 2, step 2c)")


def check_lc(config: WaveNetConfig, lc, kernel: str = "auto") -> None:
    """The rules of local conditioning, for every entry point: an LC
    config runs what :func:`check_lc_mode` allows, and takes a stream
    ``lc``; any other config takes none (ValueError)."""
    c = config
    if c.lc_enabled:
        check_lc_mode(kernel)
        if lc is None:
            raise ValueError(
                "this model was trained with local conditioning (config "
                f"has lc_channels={c.lc_channels}): it needs an lc stream")
    elif lc is not None:
        raise ValueError("lc given, but this model was not trained with "
                         "local conditioning (no lc_channels in config)")


def _check_kernel(kernel: str, packed: PackedSampler, config: WaveNetConfig,
                  lc: Optional[torch.Tensor]) -> None:
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"kernel={kernel!r}: one of {KERNEL_CHOICES}")
    if config.lc_enabled or lc is not None:
        check_lc(config, lc, kernel)


def _check_lc_operands(packed: PackedSampler, config: WaveNetConfig,
                       lc: Optional[torch.Tensor], n_total: int, B: int,
                       device) -> None:
    """An LC stream ``lc`` [n_total, B, C_lc] float32 and packed ``lc_w``
    [L, C_lc, 2D] at the matmul weights' type (the rules:
    :func:`check_lc`)."""
    c = config
    if lc is None:
        return
    if packed.lc_w is None:
        raise ValueError("lc given but the packed weights have no lc_w")
    _check("lc_w", packed.lc_w, weight_dtype_of(packed),
           (c.num_layers, c.lc_channels, 2 * c.dilation_channels), device)
    _check("lc", lc, torch.float32, (n_total, B, c.lc_channels), device)


def _launch(packed: PackedSampler, config: WaveNetConfig, ring: torch.Tensor,
            causal: torch.Tensor, forced: torch.Tensor, n_total: int,
            t0: int, seed: int, temperature: float, collect_logits,
            next_amp: Optional[torch.Tensor] = None, *,
            route: str, kernel: str = "auto", plan=None,
            lc: Optional[torch.Tensor] = None):
    """Check every operand and launch one decode kernel once on the
    current stream: ``sampler_cluster`` where ``kernel`` is "cluster", or
    "auto" and ``cluster_plan`` finds a launch; ``sampler_tiles`` where
    ``kernel`` is "tiles", or "auto" and ``tile_plan`` finds one; else
    ``sampler_decode``. A given ``plan`` (a ``ClusterPlan`` or a
    ``TilePlan``) replaces the device's. bf16 weights launch the bf16 mode
    of the kernel, which rounds the layer chain's inputs where
    :func:`chain_rounded` says so for ``route`` ("decode" or
    "sequential", the caller's; see :func:`decode_reference`). An ``lc``
    stream launches the LC mode of the cluster or decode kernel, at bf16
    weights its bf16 LC mode. A bf16 ``ring`` launches the bf16-ring
    version of that mode, on the same plan (the ring stays in device
    memory in every kernel). Returns ``(codes, logits, kernel launched)``,
    the kernel's name with "_bf16" in the bf16 mode, "_lc" in the LC mode
    and "_ring16" last at a bf16 ring; raises if the launch is refused
    (no other mode or ring type stands in)."""
    _check_kernel(kernel, packed, config, lc)
    c = config
    if c.filter_width != 2:
        raise NotImplementedError("sampler_decode covers filter_width=2")
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    dev = ring.device
    B = forced.shape[0]
    n_forced = forced.shape[1] if forced.dim() == 2 else 0
    if n_total < 1 or n_forced < 1:
        raise ValueError("sampler_decode needs n_total >= 1 and at least "
                         "one forced input")
    f32 = torch.float32
    wt = weight_dtype_of(packed)
    if wt not in (f32, torch.bfloat16):
        raise ValueError(f"sampler_decode: weights of type {wt}: float32 "
                         "or bfloat16")
    KC = causal_width(c)
    for name, shape in (("causal_w", (KC + c.input_channels, R)),
                        ("layer_w", (L, 2 * R, 2 * D)),
                        ("layer_add", (L, B, 2 * D)), ("dense_w", (L, D, R)),
                        ("dense_add", (L, 1, R)), ("skip_w", (L, D, S)),
                        ("skip_b", (1, S)), ("post1_w", (S, S)),
                        ("post1_b", (1, S)), ("post2_w", (S, Q)),
                        ("post2_b", (1, Q))):
        _check(name, getattr(packed, name),
               wt if name in WEIGHT_FIELDS else f32, shape, dev)
    check_state_dtype(ring.dtype, "sampler_decode: ring")
    _check("ring", ring, ring.dtype, (sum(c.dilations), B, R), dev)
    _check("causal", causal, f32, (B, KC), dev)
    _check("forced", forced, input_dtype(c), (B, n_forced), dev)
    if next_amp is not None:
        _check("next_amp", next_amp, f32, (B,), dev)
    _check_lc_operands(packed, c, lc, n_total, B, dev)

    if plan is None and kernel != "decode":
        d = _device(dev)
        plan = route_plan(c, B, d.smem_optin, d.cluster_resident,
                          d.tile_resident, wt, kernel)[1]
    if kernel == "decode":
        plan = None
    elif plan is None and kernel != "auto":
        raise ValueError(
            f"sampler_{kernel}: no {kernel} plan for this config at B={B} "
            f"on {torch.cuda.get_device_name(dev)}")
    used = ("decode" if plan is None else
            "tiles" if isinstance(plan, TilePlan) else "cluster")
    if kernel != "auto" and used != kernel:
        raise ValueError(f"sampler_{kernel}: given a plan of another kernel, "
                         f"{plan}")
    bf16 = wt == torch.bfloat16
    n_log = _n_log(collect_logits, n_total)
    codes = torch.empty((B, n_total), dtype=torch.int32, device=dev)
    logits = (torch.empty((B, n_log, Q), dtype=f32, device=dev)
              if n_log else None)
    meta = torch.tensor(ring_offsets(c) + c.dilations, dtype=torch.int32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*(getattr(packed, k).data_ptr() for k in KERNEL_FIELDS),
            meta.data_ptr(), ring.data_ptr(), causal.data_ptr(),
            forced.data_ptr(), codes.data_ptr(),
            logits.data_ptr() if logits is not None else None,
            next_amp.data_ptr() if next_amp is not None else None,
            B, L, R, D, S, Q, n_total, n_forced, n_log, int(c.scalar_input),
            KC, int(t0), int(seed) & 0xFFFFFFFFFFFFFFFF,
            float(np.float32(1.0 / temperature)))
    if plan is not None and (
            len(plan.layer_begin) != plan.CS + 1
            or plan.layer_begin[0] != 0 or plan.layer_begin[-1] != L
            or any(b <= a for a, b in zip(plan.layer_begin,
                                          plan.layer_begin[1:]))):
        raise ValueError(f"sampler_{used}: bad plan {plan}")
    ring16 = ring.dtype == torch.bfloat16
    rnd = ((int(chain_rounded(route, B, lc is not None, ring16)),) if bf16
           else ())
    lc_args = (() if lc is None else
               (packed.lc_w.data_ptr(), lc.data_ptr(), c.lc_channels))
    plan_args = ()
    if used == "tiles" and (plan.CS != TILE_CS or plan.RB not in TILE_ROWS):
        raise ValueError(f"sampler_tiles: bad plan {plan}")
    if used == "cluster" and (S % plan.CS or Q % (4 * plan.CS)
                              or plan.RB not in CLUSTER_ROWS):
        raise ValueError(f"sampler_cluster: bad plan {plan}")
    if plan is not None:
        plan_args = (plan.CS, plan.RB, (ctypes.c_int * len(plan.layer_begin))(
            *plan.layer_begin))
    fn = _entry(used, bf16, lc is not None, ring16)
    err = fn(*args, *rnd, *lc_args, *plan_args, stream)
    name = (used + ("_bf16" if bf16 else "") + ("" if lc is None else "_lc")
            + ("_ring16" if ring16 else ""))
    if err != 0:
        raise RuntimeError(f"sampler_{name} launch failed: CUDA error {err}")
    return codes, logits, name


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sampler_decode: unsupported device {t.device}")
    return t.device.type


def decode(packed: PackedSampler, config: WaveNetConfig,
           ring: torch.Tensor, causal: torch.Tensor, forced: torch.Tensor,
           n_total: int, t0: int, seed: int, temperature: float = 1.0,
           collect_logits=False, next_amp: Optional[torch.Tensor] = None,
           *, kernel: str = "auto", lc: Optional[torch.Tensor] = None):
    """Run ``n_total`` decode steps for every row in one kernel launch.

    ``ring`` [sum_d, B, R] (float32, or bfloat16: the JAX kernels'
    ``state_dtype``, each stored row rounded to nearest even) and
    ``causal`` [B, (kw_in-1)*C_in] (float32) are the state to resume from
    at absolute step ``t0``; both are updated in place. ``forced`` [B, n_forced] (int32 codes, or float32
    amplitudes in scalar mode): input 0 is forced[:, 0], and inputs
    1..n_forced-1 are forced too; later inputs are the sampled codes.
    Returns ``codes`` [B, n_total] int32 (code t is input t+1, a forced
    amplitude as its mu-law code) and the logits of the last ``n_log``
    steps [B, n_log, Q] (``collect_logits`` True = all, int W = last W,
    False = None). In scalar mode ``next_amp`` [B] float32, if given,
    receives the amplitude of the input after the last step, as this
    launch computed it (what a resumed launch must start from).

    CPU tensors run ``decode_reference``; CUDA tensors launch a kernel
    (``kernel``: "auto" routes by ``cluster_plan`` then ``tile_plan``;
    "cluster", "tiles" and "decode" pin one) or raise. bf16 weights
    (``pack_sampler_weights(..., weight_dtype=torch.bfloat16)``) run the
    bf16 mode of the routed (or pinned) kernel, on the float32 mode's
    plan, the layer chain's inputs rounded as :func:`chain_rounded` says
    for this route (unless B == 1). An LC config takes ``lc`` [n_total,
    B, C_lc] float32 (row t conditions step t, already refined) and runs
    the LC mode of the cluster or decode kernel, at either weight type
    (at bf16 the LC row rounded to bf16 at every B). A bf16 ring runs the
    bf16-ring version of the routed mode (its name ends in "_ring16"), on
    the float32 ring's plan.
    """
    _check_kernel(kernel, packed, config, lc)
    if _device_type(ring) == "cpu":
        return decode_reference(packed, config, ring, causal, forced,
                                n_total, t0, seed, temperature,
                                collect_logits, next_amp, lc=lc)
    codes, logits, used = _launch(
        packed, config, ring, causal, forced, n_total, t0, seed,
        temperature, collect_logits, next_amp, route="decode",
        kernel=kernel, lc=lc)
    decode.launches += 1
    decode.launches_by[used] += 1
    return codes, logits


#: Kernel launches made by ``decode``, in all and by kernel ("cluster",
#: "tiles", "decode", and "cluster_bf16", "tiles_bf16", "decode_bf16" for
#: the bf16 modes, "cluster_lc", "decode_lc" for the LC modes,
#: "cluster_bf16_lc", "decode_bf16_lc" for the LC modes at bf16 weights;
#: each of these with "_ring16" at a bf16 ring; read by chip_smoke.py).
decode.launches = 0
decode.launches_by = collections.Counter()


def decode_sequential(packed: PackedSampler, config: WaveNetConfig,
                      forced: torch.Tensor, n_total: int, seed: int,
                      temperature: float = 1.0, collect_logits=False, *,
                      kernel: str = "auto",
                      lc: Optional[torch.Tensor] = None,
                      state_dtype: torch.dtype = torch.float32):
    """Kernel 4's route: one launch from a zero ring and causal register.

    The whole forced prefix ``forced`` [B, n_forced] is stepped inside
    the launch, then the remaining ``n_total - n_forced + 1`` inputs are
    sampled; the ring phase starts at step 0. Returns ``(codes, logits)``
    as :func:`decode`. This is what the JAX package's single-pass
    HBM-ring kernel computes (``generate_pallas(ring_in_hbm=True)``).
    CPU tensors run ``decode_reference``; CUDA tensors launch a kernel
    (``kernel`` as in :func:`decode`) or raise. With bf16 weights the
    layer chain's inputs are rounded at every B, with LC unless B == 1
    (:func:`chain_rounded`).
    ``lc`` [n_total, B, C_lc] conditions every step, the forced ones
    included, as in :func:`decode` (the JAX package's
    ``generate_pallas(prefill=False)`` on kernel 1 takes LC; its HBM-ring
    variant does not). ``state_dtype=torch.bfloat16`` starts from a zero
    bf16 ring (the JAX package's ``generate_pallas(prefill=False,
    state_dtype=bfloat16)``, kernel 1 or 2 from a zero ring; kernel 4 takes
    no state dtype), so bf16 weights then round the chain as on the decode
    route.
    """
    _check_kernel(kernel, packed, config, lc)
    check_state_dtype(state_dtype)
    ring, causal = zero_state(config, forced.shape[0], forced.device,
                              state_dtype)
    if _device_type(forced) == "cpu":
        return decode_reference(
            packed, config, ring, causal, forced, n_total, 0, seed,
            temperature, collect_logits,
            round_chain=chain_rounded("sequential", forced.shape[0],
                                      lc is not None,
                                      state_dtype == torch.bfloat16), lc=lc)
    codes, logits, used = _launch(
        packed, config, ring, causal, forced, n_total, 0, seed, temperature,
        collect_logits, route="sequential", kernel=kernel, lc=lc)
    decode_sequential.launches += 1
    decode_sequential.launches_by[used] += 1
    return codes, logits


#: Kernel launches made by ``decode_sequential``, in all and by kernel
#: (read by chip_smoke.py).
decode_sequential.launches = 0
decode_sequential.launches_by = collections.Counter()


def _check_generation(config: WaveNetConfig, lc) -> None:
    if config.filter_width != 2:
        raise NotImplementedError("sampler_decode requires filter_width=2")
    check_lc(config, lc)


def _lc_stream(lc, batch_size: int, n: int, config: WaveNetConfig, dev,
               name: str = "lc") -> Optional[torch.Tensor]:
    """``lc`` as float32 [B, n, C_lc] on ``dev``, or None."""
    if lc is None:
        return None
    lc = torch.as_tensor(lc).to(dev, torch.float32)
    shape = (batch_size, n, config.lc_channels)
    if tuple(lc.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(lc.shape)}")
    return lc


def _time_major(lc: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, n, C] -> the kernels' [n, B, C] stream (row t, step t)."""
    return None if lc is None else lc.transpose(0, 1).contiguous()


def _packed_for(params: Params, config: WaveNetConfig, batch_size: int,
                gc_ids, weight_dtype):
    dev = params["postprocess2"].device
    if gc_ids is not None:
        gc_ids = torch.as_tensor(gc_ids, dtype=torch.int64).to(dev)
    gc_emb = (embed_gc(params, config, gc_ids) if gc_ids is not None
              else None)
    packed = pack_sampler_weights(params, config, batch_size, gc_emb,
                                  weight_dtype)
    return packed, gc_ids, dev


def _seed_inputs(config: WaveNetConfig, batch_size: int, seed: int,
                 seed_codes, dev) -> torch.Tensor:
    if seed_codes is None:
        seed_codes = unseeded_seed_codes(config, batch_size, seed, dev)
    seed_codes = torch.as_tensor(seed_codes).to(dev, input_dtype(config))
    if seed_codes.shape[0] != batch_size:
        raise ValueError(f"seed_codes batch {seed_codes.shape[0]} != "
                         f"{batch_size}")
    return seed_codes.contiguous()


def generate_cuda(params: Params, config: WaveNetConfig, n_samples: int,
                  seed: int, batch_size: int = 1,
                  gc_ids: Optional[torch.Tensor] = None,
                  temperature: float = 1.0,
                  seed_codes: Optional[torch.Tensor] = None,
                  collect_logits=False, weight_dtype=torch.float32,
                  prefill: bool = True, lc=None, lc_prime=None,
                  state_dtype: torch.dtype = torch.float32):
    """Generate mu-law codes [B, n_samples] with one decode launch.

    ``seed_codes`` [B, T_seed] teacher-forces the start (int codes, or
    float amplitudes in scalar mode; default: the unseeded recipe).
    Routes, as the JAX package's ``generate_pallas``:

    * ``prefill=True``: one parallel forward primes the rings
      (``prefill_carry``), then ``decode`` runs n_samples steps (the
      TPU's kernels 1-3). With ``collect_logits`` only the decoded steps'
      logits exist.
    * ``prefill=False``: ``decode_sequential`` steps the forced prefix
      in the kernel too, from a zero ring, over n_forced-1+n_samples
      steps: the single-pass HBM-ring kernel's route (TPU kernel 4,
      ``generate_pallas(prefill=False, ring_in_hbm=True)``; the JAX
      package's other ring and IO options compute the same steps, and the
      port has one launch for all of them). With ``collect_logits`` the
      logits of every step (or the last W) come back in step order.

    ``weight_dtype=torch.bfloat16`` packs the matmul weights in bf16 and
    decodes in the kernels' bf16 mode (the JAX package's
    ``weight_dtype=jnp.bfloat16``); the prefill stays float32, and a
    config's ``compute_dtype`` changes neither. ``state_dtype`` is the
    ring's type (the JAX package's ``state_dtype``): float32, or bfloat16,
    whose rows are stored rounded to nearest even and read widened, on
    either route: the prefilled ring is rounded once before the launch
    (``sampler.py:963-964`` there), the sequential route starts from a zero
    bf16 ring. Any other type raises ValueError. (JAX's prefill route
    first tries its all-VMEM kernel at a float32 ring, whatever
    ``state_dtype`` says, a TPU VMEM budget choice the port does not copy.)
    Returns ``codes`` or ``(codes, logits [B, n_log, Q])``. The device is
    the parameters' device.

    Local conditioning (an LC config; either weight type), with the scan
    sampler's conventions: ``lc`` [B, n_samples, C_lc] conditions the
    generated samples, ``lc_prime`` [B, T_seed - 1, C_lc] the priming
    region (default ``lc[:, 0]`` held backward); both are refined here,
    once, on the raw streams (``maybe_refine_lc``). With ``prefill=True``
    the prefill forward takes the priming rows and decode step t row t of
    ``lc``; with ``prefill=False`` step t takes row t of
    ``[lc_prime | lc]``.
    """
    c = config
    _check_generation(c, lc)
    check_state_dtype(state_dtype)
    B = batch_size
    packed, gc_ids, dev = _packed_for(params, c, B, gc_ids, weight_dtype)
    seed_codes = _seed_inputs(c, B, seed, seed_codes, dev)
    n_forced = seed_codes.shape[1]
    lc = _lc_stream(lc, B, n_samples, c, dev)
    lc_p = None
    if lc is not None:
        with torch.no_grad(), _full_float32():
            lc = maybe_refine_lc(params, c, lc)
            lc_prime = _lc_stream(lc_prime, B, n_forced - 1, c, dev,
                                  "lc_prime")
            lc_p = lc_for_prime(lc, maybe_refine_lc(params, c, lc_prime),
                                n_forced - 1)
    if prefill:
        carry = prefill_carry(params, c, seed_codes, gc_ids, lc=lc_p)
        forced = carry.last[:, None].contiguous()
        ring = carry.ring.to(state_dtype)
        codes, logits = decode(packed, c, ring, carry.causal, forced,
                               n_samples, carry.t_abs, seed, temperature,
                               collect_logits, lc=_time_major(lc))
    else:
        n_total = n_forced - 1 + n_samples
        lc_full = (None if lc is None else
                   torch.cat([lc_p, lc], dim=1)[:, :n_total])
        codes, logits = decode_sequential(
            packed, c, seed_codes, n_total, seed, temperature,
            collect_logits, lc=_time_major(lc_full), state_dtype=state_dtype)
        codes = codes[:, n_forced - 1:]
    if collect_logits:
        return codes, logits
    return codes


def generate_cuda_resumable(params: Params, config: WaveNetConfig,
                            n_samples: int, seed: int, batch_size: int = 1,
                            gc_ids: Optional[torch.Tensor] = None,
                            temperature: float = 1.0,
                            seed_codes: Optional[torch.Tensor] = None,
                            carry: Optional[StreamSamplerCarry] = None,
                            weight_dtype=torch.float32, lc=None,
                            lc_prime=None):
    """One segment of generation; returns ``(codes [B, n_samples],
    carry')`` (the counterpart of ``generate_pallas_resumable``).

    First call (``carry=None``): primes as :func:`generate_cuda` does
    by default (``prefill_carry``). Continuations pass the returned carry;
    its ring and causal register are updated in place (the JAX package
    donates them). The Philox noise is keyed on the absolute step, so
    segments with the same ``seed`` equal one long run sample for sample,
    at any temperature. In scalar mode the carry's last input is the last
    code's decoded amplitude as the launch itself computed it
    (``decode(next_amp=...)``), so the next segment starts from the value
    one long launch would have used. ``weight_dtype`` as in
    :func:`generate_cuda`.

    ``lc`` [B, n_samples, C_lc] conditions this segment's samples, taken
    as given (already refined: slice one refined stream across the
    segments, as the CLI does); ``lc_prime`` conditions the first
    segment's priming region (default ``lc[:, 0]`` held backward).
    """
    c = config
    _check_generation(c, lc)
    B = batch_size
    packed, gc_ids, dev = _packed_for(params, c, B, gc_ids, weight_dtype)
    lc = _lc_stream(lc, B, n_samples, c, dev)
    if carry is None:
        seed_codes = _seed_inputs(c, B, seed, seed_codes, dev)
        n_prime = seed_codes.shape[1] - 1
        lc_p = lc_for_prime(lc, _lc_stream(lc_prime, B, n_prime, c, dev,
                                           "lc_prime"), n_prime)
        carry = prefill_carry(params, c, seed_codes, gc_ids, lc=lc_p)
    elif seed_codes is not None:
        raise ValueError("seed_codes only apply to the first segment")
    elif lc_prime is not None:
        raise ValueError("lc_prime only applies to the first segment")
    forced = carry.last[:, None].to(input_dtype(c)).contiguous()
    next_amp = (torch.empty(B, dtype=torch.float32, device=dev)
                if c.scalar_input else None)
    codes, _ = decode(packed, c, carry.ring, carry.causal, forced, n_samples,
                      carry.t_abs, seed, temperature, next_amp=next_amp,
                      lc=_time_major(lc))
    last = next_amp if c.scalar_input else codes[:, -1].contiguous()
    return codes, StreamSamplerCarry(carry.ring, carry.causal,
                                     carry.t_abs + n_samples, last)
