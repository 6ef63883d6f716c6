"""Autoregressive generation: prefill on PyTorch, decode in one CUDA kernel.

Counterpart of ``wavenet_tpu/kernels/sampler.py`` (host side) and of its
three decode kernels, which the one kernel ``csrc/sampler_decode.cu``
replaces (its header says which and why). Generation is two phases:

* prefill (``prefill_carry``): one parallel ``forward_codes`` over the
  seed codes fills every layer's ring rows and the causal register;
* decode (``decode``): one kernel launch runs every step of every row,
  resuming from that state, sampling in the kernel.

Layouts differ from the TPU package where the TPU forced them: the ring
is ``[sum_d, B, R]`` (no 128-lane padding), forced inputs are
``[B, n_forced]`` and a logits window comes back ``[B, n_log, Q]`` in
step order. The b1 transposed weights, batch chunking and the ring
packing were TPU layouts and have no counterpart.

``decode_reference`` is the plain PyTorch version of the kernel, with
the same Philox4x32-10 noise; ``decode`` uses it only for CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import (
    Params, embed_gc, forward_codes, one_hot)
from wavenet_torch.sample import ring_slot_blocks


class PackedSampler(NamedTuple):
    """Kernel-ready float32 weights (shapes as the JAX package's).

    The gate half of ``layer_w``/``layer_add`` is pre-scaled by 0.5 so one
    tanh gives both tanh(f) and sigmoid(g) = 0.5 + 0.5*tanh(g/2); bias and
    GC are folded into ``layer_add``; the per-layer skip biases are summed.
    """
    causal_w: torch.Tensor     # [2 * Q, R]   (previous input | current input)
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


class StreamSamplerCarry(NamedTuple):
    """Decode state: what ``decode`` resumes from."""
    ring: torch.Tensor         # [sum_d, B, R] float32
    causal: torch.Tensor       # [B, Q] float32 causal shift register
    t_abs: int                 # absolute steps completed (ring phase)
    last: torch.Tensor         # [B] int32, the first decode input


def _require_float32(weight_dtype) -> None:
    if weight_dtype not in (None, torch.float32):
        raise NotImplementedError(
            "sampler_decode runs float32 weights only; bf16 weights are "
            "queued in ROADMAP.md ('bf16 weights in sampler_decode')")


def pack_sampler_weights(params: Params, config: WaveNetConfig,
                         batch_size: int,
                         gc_embedding: Optional[torch.Tensor] = None,
                         weight_dtype=torch.float32) -> PackedSampler:
    """Rearrange the parameter dict into the kernel's layout."""
    _require_float32(weight_dtype)
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
    return PackedSampler(*(t.contiguous() for t in (
        causal_w, layer_w, add, params["dense"].to(f32), dense_add,
        params["skip"].to(f32), skip_b, params["postprocess1"].to(f32),
        post1_b, params["postprocess2"].to(f32), post2_b)))


def ring_offsets(config: WaveNetConfig) -> Tuple[int, ...]:
    """Per-layer start rows in the packed ring buffer."""
    return tuple(int(o) for o in np.cumsum((0,) + config.dilations[:-1]))


def unseeded_seed_codes(config: WaveNetConfig, batch_size: int, seed: int,
                        device=None) -> torch.Tensor:
    """receptive_field-1 silence codes, then one uniform-random code.

    The same recipe as the JAX package; the random code comes from a
    ``torch.Generator`` seeded with ``seed``, so it differs from JAX's.
    """
    c = config
    if c.scalar_input:
        raise NotImplementedError(
            "scalar input is not ported yet (ROADMAP.md, 'scalar input in "
            "sampler_decode')")
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
                  gc_ids: Optional[torch.Tensor] = None
                  ) -> StreamSamplerCarry:
    """Parallel queue priming: one forward replaces T-1 decode steps.

    The ring after teacher-forcing steps 0..T-2 is the residual stream
    entering each layer at its last d_l positions, which one parallel
    ``forward_codes`` computes. The carry resumes decoding at absolute
    step T-1 with ``seed_codes[:, -1]`` as the first input.
    """
    c = config
    if c.filter_width != 2:
        raise NotImplementedError("sampler_decode requires filter_width=2")
    seed_codes = seed_codes.to(torch.int32)
    B, T = seed_codes.shape
    last = seed_codes[:, -1].contiguous()
    if T == 1:
        dev = seed_codes.device
        ring = torch.zeros((sum(c.dilations), B, c.residual_channels),
                           dtype=torch.float32, device=dev)
        causal = torch.zeros((B, c.quantization_channels),
                             dtype=torch.float32, device=dev)
        return StreamSamplerCarry(ring, causal, 0, last)
    ring, causal = _prefill_state(params, c, seed_codes, gc_ids)
    return StreamSamplerCarry(ring, causal, T - 1, last)


def _prefill_state(params: Params, config: WaveNetConfig,
                   seed_codes: torch.Tensor,
                   gc_ids: Optional[torch.Tensor]):
    """(ring, causal) after teacher-forcing steps 0..T-2."""
    c = config
    T_pre = seed_codes.shape[1] - 1
    keep = tuple(min(d, T_pre) for d in c.dilations)
    with torch.no_grad(), _full_float32():
        gc_emb = (embed_gc(params, c, gc_ids.to(seed_codes.device))
                  if gc_ids is not None else None)
        layer_ins = forward_codes(params, c, seed_codes[:, :T_pre], gc_emb,
                                  collect_layer_inputs=keep)
        # Ring row offsets[l] + tau % d holds x_l(tau) for the last
        # min(d, T_pre) positions tau < T_pre; other rows stay zero.
        ring = torch.cat(ring_slot_blocks(layer_ins, c.dilations, T_pre),
                         dim=0).contiguous()
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
# Decode: the kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def _n_log(collect_logits, n_total: int) -> int:
    if collect_logits is True:
        return n_total
    if not collect_logits:
        return 0
    return min(int(collect_logits), n_total)


def decode_reference(packed: PackedSampler, config: WaveNetConfig,
                     ring: torch.Tensor, causal: torch.Tensor,
                     forced: torch.Tensor, n_total: int, t0: int, seed: int,
                     temperature: float = 1.0, collect_logits=False):
    """Plain PyTorch version of ``sampler_decode`` (same contract as
    :func:`decode`): a Python loop over steps, batched over rows."""
    c = config
    L, D, Q = c.num_layers, c.dilation_channels, c.quantization_channels
    B, n_forced = forced.shape
    dev = ring.device
    offs, dil = ring_offsets(c), c.dilations
    n_log = _n_log(collect_logits, n_total)
    log_from = n_total - n_log
    inv_t = float(np.float32(1.0 / temperature))
    codes = torch.empty((B, n_total), dtype=torch.int32, device=dev)
    logits = (torch.empty((B, n_log, Q), dtype=torch.float32, device=dev)
              if n_log else None)
    chunk = max(1, (1 << 20) // (B * Q))
    x = forced[:, 0].long()
    with torch.no_grad(), _full_float32():
        for t in range(n_total):
            if t % chunk == 0:
                noise = gumbel_noise(seed, B, t0 + t,
                                     min(chunk, n_total - t), Q, dev)
            window = torch.cat([causal, F.one_hot(x, Q).to(torch.float32)],
                               dim=-1)
            cur = window @ packed.causal_w
            causal.copy_(window[:, Q:])
            skip = None
            for l in range(L):
                pos = offs[l] + (t0 + t) % dil[l]
                past = ring[pos].clone()
                ring[pos] = cur
                fg = (torch.cat([past, cur], dim=-1) @ packed.layer_w[l]
                      + packed.layer_add[l])
                tg = torch.tanh(fg)
                out = tg[:, :D] * (0.5 + 0.5 * tg[:, D:])
                cur = cur + out @ packed.dense_w[l] + packed.dense_add[l]
                s = out @ packed.skip_w[l]
                skip = s if skip is None else skip + s
            h = torch.relu(skip + packed.skip_b)
            h = torch.relu(h @ packed.post1_w + packed.post1_b)
            lg = h @ packed.post2_w + packed.post2_b
            if n_log and t >= log_from:
                logits[:, t - log_from] = lg
            sampled = torch.argmax(lg * inv_t + noise[t % chunk], dim=-1)
            x = forced[:, t + 1].long() if t + 1 < n_forced else sampled
            codes[:, t] = x.to(torch.int32)
    return codes, logits


def _rows_per_block(batch_size: int) -> int:
    """Rows sharing one block (and one read of the weights per step):
    as many as keep the grid at least one block per SM of an H100."""
    for rb in (8, 4, 2):
        if batch_size >= rb * 132:
            return rb
    return 1


def _bind(lib) -> None:
    fn = lib.sampler_decode_f32
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(
            f"sampler_decode: {name} must be {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"sampler_decode: {name} must be contiguous")


def decode(packed: PackedSampler, config: WaveNetConfig,
           ring: torch.Tensor, causal: torch.Tensor, forced: torch.Tensor,
           n_total: int, t0: int, seed: int, temperature: float = 1.0,
           collect_logits=False):
    """Run ``n_total`` decode steps for every row in one kernel launch.

    ``ring`` [sum_d, B, R] and ``causal`` [B, Q] (float32) are the state
    to resume from at absolute step ``t0``; both are updated in place.
    ``forced`` [B, n_forced] int32: input 0 is forced[:, 0], and inputs
    1..n_forced-1 are forced too; later inputs are the sampled codes.
    Returns ``codes`` [B, n_total] int32 (code t is input t+1) and the
    logits of the last ``n_log`` steps [B, n_log, Q] (``collect_logits``
    True = all, int W = last W, False = None).

    CPU tensors run ``decode_reference``; CUDA tensors launch the kernel
    or raise.
    """
    if ring.device.type == "cpu":
        return decode_reference(packed, config, ring, causal, forced,
                                n_total, t0, seed, temperature,
                                collect_logits)
    if ring.device.type != "cuda":
        raise ValueError(f"sampler_decode: unsupported device {ring.device}")
    c = config
    if c.filter_width != 2 or c.scalar_input or c.lc_enabled:
        raise NotImplementedError(
            "sampler_decode covers mu-law input, filter_width=2, no LC")
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    dev = ring.device
    B = forced.shape[0]
    n_forced = forced.shape[1] if forced.dim() == 2 else 0
    if n_total < 1 or n_forced < 1:
        raise ValueError("sampler_decode needs n_total >= 1 and at least "
                         "one forced input")
    f32 = torch.float32
    for name, shape in (("causal_w", (2 * Q, R)), ("layer_w", (L, 2 * R, 2 * D)),
                        ("layer_add", (L, B, 2 * D)), ("dense_w", (L, D, R)),
                        ("dense_add", (L, 1, R)), ("skip_w", (L, D, S)),
                        ("skip_b", (1, S)), ("post1_w", (S, S)),
                        ("post1_b", (1, S)), ("post2_w", (S, Q)),
                        ("post2_b", (1, Q))):
        _check(name, getattr(packed, name), f32, shape, dev)
    _check("ring", ring, f32, (sum(c.dilations), B, R), dev)
    _check("causal", causal, f32, (B, Q), dev)
    _check("forced", forced, torch.int32, (B, n_forced), dev)

    from wavenet_torch.kernels import _build
    lib = _build.load("sampler_decode")
    _bind(lib)
    n_log = _n_log(collect_logits, n_total)
    codes = torch.empty((B, n_total), dtype=torch.int32, device=dev)
    logits = (torch.empty((B, n_log, Q), dtype=f32, device=dev)
              if n_log else None)
    meta = torch.tensor(ring_offsets(c) + c.dilations, dtype=torch.int32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sampler_decode_f32(
        *(getattr(packed, k).data_ptr() for k in PackedSampler._fields),
        meta.data_ptr(), ring.data_ptr(), causal.data_ptr(),
        forced.data_ptr(), codes.data_ptr(),
        logits.data_ptr() if logits is not None else None,
        B, L, R, D, S, Q, n_total, n_forced, n_log, int(t0),
        int(seed) & 0xFFFFFFFFFFFFFFFF, float(np.float32(1.0 / temperature)),
        _rows_per_block(B), stream)
    if err != 0:
        raise RuntimeError(f"sampler_decode launch failed: CUDA error {err}")
    decode.launches += 1
    return codes, logits


#: Kernel launches made by ``decode`` (read by chip_smoke.py).
decode.launches = 0


def generate_cuda(params: Params, config: WaveNetConfig, n_samples: int,
                  seed: int, batch_size: int = 1,
                  gc_ids: Optional[torch.Tensor] = None,
                  temperature: float = 1.0,
                  seed_codes: Optional[torch.Tensor] = None,
                  collect_logits=False, weight_dtype=torch.float32,
                  prefill: bool = True):
    """Generate mu-law codes [B, n_samples] with one decode launch.

    ``seed_codes`` [B, T_seed] teacher-forces the start (default: the
    unseeded recipe). ``prefill=True`` primes the rings with one parallel
    forward (``prefill_carry``) and decodes n_samples steps; False runs
    the forced steps through the kernel too. With ``collect_logits`` it
    returns ``(codes, logits [B, n_log, Q])`` of the decoded steps.
    The device is the parameters' device.
    """
    c = config
    if c.filter_width != 2:
        raise NotImplementedError("sampler_decode requires filter_width=2")
    if c.scalar_input:
        raise NotImplementedError(
            "scalar input is not ported yet (ROADMAP.md, 'scalar input in "
            "sampler_decode')")
    if c.lc_enabled:
        raise NotImplementedError(
            "local conditioning is not ported yet (ROADMAP.md, 'LC in "
            "sampler_decode')")
    _require_float32(weight_dtype)
    dev = params["postprocess2"].device
    B = batch_size
    if gc_ids is not None:
        gc_ids = torch.as_tensor(gc_ids, dtype=torch.int64).to(dev)
    gc_emb = embed_gc(params, c, gc_ids) if gc_ids is not None else None
    packed = pack_sampler_weights(params, c, B, gc_emb, weight_dtype)
    if seed_codes is None:
        seed_codes = unseeded_seed_codes(c, B, seed, dev)
    seed_codes = torch.as_tensor(seed_codes).to(dev, torch.int32)
    if seed_codes.shape[0] != B:
        raise ValueError(f"seed_codes batch {seed_codes.shape[0]} != {B}")
    if prefill:
        carry = prefill_carry(params, c, seed_codes, gc_ids)
        ring, causal, t0 = carry.ring, carry.causal, carry.t_abs
        forced = carry.last[:, None].contiguous()
        n_total, skip_front = n_samples, 0
    else:
        ring = torch.zeros((sum(c.dilations), B, c.residual_channels),
                           dtype=torch.float32, device=dev)
        causal = torch.zeros((B, c.quantization_channels),
                             dtype=torch.float32, device=dev)
        forced, t0 = seed_codes.contiguous(), 0
        n_total = seed_codes.shape[1] - 1 + n_samples
        skip_front = seed_codes.shape[1] - 1
    codes, logits = decode(packed, c, ring, causal, forced, n_total, t0,
                           seed, temperature, collect_logits)
    codes = codes[:, skip_front:]
    if collect_logits:
        return codes, logits
    return codes
