"""The scan sampler: one network step at a time over ring-buffered state.

Counterpart of ``wavenet_tpu/sample.py`` (its ``lax.scan`` becomes a
Python loop of plain PyTorch steps). Each layer's past activations live
in a ring ``[L, max_dilation, B, R]``: layer l reads and writes slot
``t mod dilation_l``, the queue semantics of the reference's FIFOs. The
causal input queue is a ``[B, kw-1, C_in]`` shift register (kw =
initial_filter_width in scalar mode, else filter_width).

This is the port's reference sampler for the CPU and what the CLI runs
for ``--sampler scan``; the kernel path is ``kernels/sampler.py``.
Differences from the JAX package: the step counter ``t`` is a Python
int; a step updates the state's ring in place (the JAX package donates
it); randomness comes from an explicit ``torch.Generator`` (the ``key``
arguments), which a chunked run keeps drawing from, so chunks equal one
run. Gumbel-argmax over logits/T samples the same distribution as
``jax.random.categorical``, from other random numbers. As in the JAX
package, the sampler computes in float32 whatever the config's
``compute_dtype`` (``float32_config``). Local conditioning follows the
JAX package's conventions: ``lc_t`` [B, C_lc] conditions the sample a step
predicts, ``generate`` refines the raw streams once and holds ``lc[:, 0]``
backward over the priming region unless ``lc_prime`` is given.

``extend_state`` advances a state by a window of known inputs in one
parallel pass (the verifier of ``speculative.py`` and the streaming
scorer of ``score.py``). Unlike ``sampler_step`` it leaves the state it is
given as it is: the committed ring is a new tensor.

``generate_sharded`` runs the scan sampler over a ``(data, model)`` mesh
of processes (``parallel/sharding.py``): each rank advances its data rows
with its model shard of the weights (the collectives of
``parallel/tensor.py``), and every rank draws each step's whole noise
block from the same generator and keeps its rows, so its codes equal
``generate``'s for the same generator.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from wavenet_torch.audio import mu_law_decode
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import (
    Params, embed_gc, forward, forward_codes, maybe_refine_lc)


class SamplerState(NamedTuple):
    """State between sampler steps."""
    t: int                    # global step (ring-buffer clock)
    causal_buf: torch.Tensor  # [B, kw-1, C_in] last kw-1 raw inputs
    layer_bufs: torch.Tensor  # [L, max_dilation, B, R] past residual acts


def _input_kernel_width(config: WaveNetConfig) -> int:
    return (config.initial_filter_width if config.scalar_input
            else config.filter_width)


def init_sampler_state(config: WaveNetConfig, batch_size: int,
                       device=None) -> SamplerState:
    """All-zero queues."""
    c = config
    kw = _input_kernel_width(c)
    return SamplerState(
        t=0,
        causal_buf=torch.zeros((batch_size, kw - 1, c.input_channels),
                               device=device),
        layer_bufs=torch.zeros((c.num_layers, max(c.dilations), batch_size,
                                c.residual_channels), device=device))


def _check_config(c: WaveNetConfig) -> None:
    if c.filter_width != 2:
        raise NotImplementedError(
            "Incremental generation only implemented for filter_width=2 "
            "(the reference has the same restriction).")


def float32_config(config: WaveNetConfig) -> WaveNetConfig:
    """The config as generation's prefill runs it: float32 whatever its
    ``compute_dtype``, on the plain stack (the JAX package's ``cfg32``).
    The samplers' steps multiply the float32 params as they are."""
    return dataclasses.replace(config, compute_dtype="float32",
                               use_pallas_stack=False, remat=False)


def sampler_step(params: Params, config: WaveNetConfig, state: SamplerState,
                 x: torch.Tensor,
                 gc_embedding: Optional[torch.Tensor] = None,
                 lc_t: Optional[torch.Tensor] = None,
                 collect_layer_inputs: bool = False, tp=None):
    """One incremental network evaluation: ``x`` [B, C_in] (one-hot, or
    the amplitude [B, 1] in scalar mode) -> (new_state, logits [B, Q]).
    ``tp``: ``params`` are this rank's model shards (``forward``'s ``tp``;
    dense, skip and postprocess2 are reduced over the group).
    ``lc_t`` [B, C_lc] conditions the sample this step predicts. The
    state's ring is updated in place. With ``collect_layer_inputs`` a
    third result is each layer's input (the residual stream), stacked
    [L, B, R]: speculative decoding commits the draft's state from them
    without a second stack pass."""
    c = config
    _check_config(c)
    window = torch.cat([state.causal_buf, x[:, None, :].to(torch.float32)],
                       dim=1)                                # [B, kw, C_in]
    current = torch.einsum("bkc,kcr->br", window, params["causal_filter"])
    bufs = state.layer_bufs
    skip_sum = None
    layer_inputs = []
    for i, dilation in enumerate(c.dilations):
        if collect_layer_inputs:
            layer_inputs.append(current)
        pos = state.t % dilation
        past = bufs[i, pos].clone()
        # Enqueue the layer's input where it was read: it is dequeued
        # again dilation steps from now.
        bufs[i, pos] = current
        w_f, w_g = params["filter"][i], params["gate"][i]    # [2, R, D]
        conv_f = past @ w_f[0] + current @ w_f[1]
        conv_g = past @ w_g[0] + current @ w_g[1]
        if gc_embedding is not None:
            conv_f = conv_f + gc_embedding @ params["gc_filter"][i]
            conv_g = conv_g + gc_embedding @ params["gc_gate"][i]
        if lc_t is not None:
            conv_f = conv_f + lc_t @ params["lc_filter"][i]
            conv_g = conv_g + lc_t @ params["lc_gate"][i]
        if c.use_biases:
            conv_f = conv_f + params["filter_bias"][i]
            conv_g = conv_g + params["gate_bias"][i]
        out = torch.tanh(conv_f) * torch.sigmoid(conv_g)
        transformed = out @ params["dense"][i]
        skip_c = out @ params["skip"][i]
        if tp is not None:
            transformed, skip_c = tp.reduce(transformed), tp.reduce(skip_c)
        if c.use_biases:
            transformed = transformed + params["dense_bias"][i]
            skip_c = skip_c + params["skip_bias"][i]
        skip_sum = skip_c if skip_sum is None else skip_sum + skip_c
        current = current + transformed

    h = torch.relu(skip_sum)
    h = h @ params["postprocess1"]
    if c.use_biases:
        h = h + params["postprocess1_bias"]
    h = torch.relu(h)
    h = h @ params["postprocess2"]
    if tp is not None:
        h = tp.reduce(h)
    if c.use_biases:
        h = h + params["postprocess2_bias"]
    new_state = SamplerState(state.t + 1, window[:, 1:], bufs)
    if collect_layer_inputs:
        return new_state, h, torch.stack(layer_inputs)
    return new_state, h


def _featurize(code_or_amp: torch.Tensor,
               config: WaveNetConfig) -> torch.Tensor:
    if config.scalar_input:
        return code_or_amp[..., None].to(torch.float32)     # [B] -> [B, 1]
    return F.one_hot(code_or_amp.long(),
                     config.quantization_channels).to(torch.float32)


def _code_to_input(code: torch.Tensor, config: WaveNetConfig) -> torch.Tensor:
    """Sampled class -> next-step input features (the decoded amplitude
    in scalar mode)."""
    if config.scalar_input:
        return mu_law_decode(code, config.quantization_channels)[..., None]
    return _featurize(code, config)


def prime_state(params: Params, config: WaveNetConfig, state: SamplerState,
                waveform: torch.Tensor,
                gc_embedding: Optional[torch.Tensor] = None,
                lc: Optional[torch.Tensor] = None) -> SamplerState:
    """Push a seed waveform [B, T] (int codes, or amplitudes in scalar
    mode) through the queues, discarding the predictions: the sequential
    oracle of :func:`prefill_state`. ``lc`` [B, T, C_lc]: row j
    conditions the (discarded) prediction after input j."""
    with torch.no_grad():
        for t in range(waveform.shape[1]):
            state, _ = sampler_step(params, config, state,
                                    _featurize(waveform[:, t], config),
                                    gc_embedding,
                                    None if lc is None else lc[:, t])
    return state


def ring_slot_blocks(layer_ins: Sequence[torch.Tensor],
                     dilations: Sequence[int], T: int) -> List[torch.Tensor]:
    """Per-layer ring-slot blocks for prefill: block_l[r] = x_l(tau_r).

    ``layer_ins[l]`` is [B, keep_l, R], the last keep_l = min(d_l, T)
    residual-stream values entering layer l. Slot tau % d_l holds
    x_l(tau) for the last keep_l positions tau < T and stays zero
    elsewhere: left-pad the kept window to d rows, then roll by T % d so
    window row j (time tau = T - d + j) lands on row tau % d.
    """
    blocks = []
    for l, d in enumerate(dilations):
        w = layer_ins[l].transpose(0, 1)                   # [keep_l, B, R]
        keep = w.shape[0]
        if keep < d:
            w = torch.cat([w.new_zeros((d - keep,) + tuple(w.shape[1:])), w],
                          dim=0)
        blocks.append(torch.roll(w, T % d, dims=0))        # [d, B, R]
    return blocks


def prefill_state(params: Params, config: WaveNetConfig,
                  waveform: torch.Tensor,
                  gc_embedding: Optional[torch.Tensor] = None,
                  lc: Optional[torch.Tensor] = None,
                  tp=None) -> SamplerState:
    """:func:`prime_state` from zero in one parallel forward: each layer's
    queue after teacher-forcing ``waveform`` [B, T] (conditioned by ``lc``
    [B, T, C_lc], as there) is the residual stream entering that layer at
    its last dilation_l positions. The forward runs at float32 whatever
    the config's ``compute_dtype``."""
    c = float32_config(config)
    _check_config(c)
    B, T = waveform.shape
    dev = waveform.device
    if T == 0:
        return init_sampler_state(c, B, dev)
    max_d = max(c.dilations)
    keep = tuple(min(d, T) for d in c.dilations)
    with torch.no_grad():
        if c.scalar_input:
            layer_ins = forward(params, c,
                                waveform[..., None].to(torch.float32),
                                gc_embedding, collect_layer_inputs=keep,
                                lc=lc, tp=tp)
        else:
            layer_ins = forward_codes(params, c, waveform, gc_embedding,
                                      collect_layer_inputs=keep, lc=lc,
                                      tp=tp)
        blocks = [F.pad(w, (0, 0, 0, 0, 0, max_d - d))
                  for d, w in zip(c.dilations,
                                  ring_slot_blocks(layer_ins, c.dilations,
                                                   T))]
        layer_bufs = torch.stack(blocks, dim=0)           # [L, max_d, B, R]
        # Causal register: the raw input features of the last kw-1 steps.
        n_tail = _input_kernel_width(c) - 1
        feats = _featurize(waveform[:, max(0, T - n_tail):], c)
        feats = F.pad(feats, (0, 0, n_tail - feats.shape[1], 0))
    return SamplerState(T, feats, layer_bufs)


def extend_state(params: Params, config: WaveNetConfig,
                 state: SamplerState, codes: torch.Tensor,
                 gc_embedding: Optional[torch.Tensor] = None,
                 valid_len: Optional[int] = None,
                 lc: Optional[torch.Tensor] = None):
    """Advance the state by up to k teacher-forced steps in one parallel
    pass: (logits [B, k, Q], new_state).

    ``codes`` [B, k] (int codes, or amplitudes in scalar mode) are
    consumed at positions t .. t+k-1; ``logits[:, j]`` predicts position
    t+j+1, as k calls of ``sampler_step`` would, but each layer's left
    context comes from the ring, so the k positions go through the stack
    together. ``lc`` [B, k, C_lc]: column j conditions the prediction at
    window position j.

    ``valid_len`` (an int, 0 <= v <= k, default k) commits the state as if
    only the first v inputs had been consumed; logits are returned for
    all k positions. Every ring row is written with the value it holds
    after v steps, gathered from [old ring | window], the causal register
    is the input window's slice at v, and t advances by v. The state
    passed in is left as it is.
    """
    with torch.no_grad():
        logits, parts = _extend_forward(params, config, state, codes,
                                        gc_embedding, lc)
        v = codes.shape[1] if valid_len is None else int(valid_len)
        return logits, _extend_commit(config, state, parts, v)


def _ordered_ring(layer_bufs: torch.Tensor, l: int, d: int,
                  t: int) -> torch.Tensor:
    """Layer l's ring rows in time order: out[i] = x_l(t - d + i), [d, B, R]
    (a copy)."""
    idx = torch.remainder(
        torch.arange(d, device=layer_bufs.device) + t, d)
    return layer_bufs[l, :d].index_select(0, idx)


def _extend_forward(params: Params, config: WaveNetConfig,
                    state: SamplerState, codes: torch.Tensor,
                    gc_embedding: Optional[torch.Tensor],
                    lc: Optional[torch.Tensor] = None):
    """Stack pass of ``extend_state``: (logits [B, k, Q], parts). Reads
    the state and writes nothing.

    ``parts`` = (the input features [causal register | window] [B,
    kw-1+k, C_in], each layer's [old ring | window inputs] [B, d_l+k, R]):
    all that ``_extend_commit`` needs to write the state for any valid
    length without another stack pass (speculative decoding chooses the
    length from these logits). Products in float32, as the JAX package's
    at ``Precision.HIGHEST``.
    """
    c = config
    if c.filter_width != 2:
        raise NotImplementedError(
            "extend_state requires filter_width=2 (the restriction of "
            "every incremental path: the dilated taps are past|current)")
    B, k = codes.shape
    L, D, S = c.num_layers, c.dilation_channels, c.skip_channels
    kw = _input_kernel_width(c)
    x = _featurize(codes, c)                                 # [B, k, C_in]
    full_in = torch.cat([state.causal_buf, x], dim=1)
    # full_in column j holds the features of position t - (kw-1) + j.
    w = params["causal_filter"]                              # [kw, C_in, R]
    cur = full_in[:, 0:k] @ w[0]
    for tap in range(1, kw):
        cur = cur + full_in[:, tap:tap + k] @ w[tap]         # [B, k, R]

    gate_outs, arrs = [], []
    for l, d in enumerate(c.dilations):
        ordered = _ordered_ring(state.layer_bufs, l, d, state.t)
        # arr column i holds x_l at time t - d + i (ring, then window).
        arr = torch.cat([ordered.transpose(0, 1), cur], dim=1)
        arrs.append(arr)
        past = arr[:, :k]                          # times t-d .. t-d+k-1
        w_f, w_g = params["filter"][l], params["gate"][l]    # [2, R, D]
        conv_f = past @ w_f[0] + cur @ w_f[1]
        conv_g = past @ w_g[0] + cur @ w_g[1]
        if gc_embedding is not None:
            conv_f = conv_f + (gc_embedding @ params["gc_filter"][l])[:, None]
            conv_g = conv_g + (gc_embedding @ params["gc_gate"][l])[:, None]
        if lc is not None:
            conv_f = conv_f + lc @ params["lc_filter"][l]
            conv_g = conv_g + lc @ params["lc_gate"][l]
        if c.use_biases:
            conv_f = conv_f + params["filter_bias"][l]
            conv_g = conv_g + params["gate_bias"][l]
        out = torch.tanh(conv_f) * torch.sigmoid(conv_g)
        gate_outs.append(out)
        transformed = out @ params["dense"][l]
        if c.use_biases:
            transformed = transformed + params["dense_bias"][l]
        cur = cur + transformed

    h = torch.cat(gate_outs, dim=-1) @ params["skip"].reshape(L * D, S)
    if c.use_biases:
        h = h + params["skip_bias"].sum(dim=0)
    h = torch.relu(h) @ params["postprocess1"]
    if c.use_biases:
        h = h + params["postprocess1_bias"]
    h = torch.relu(h) @ params["postprocess2"]
    if c.use_biases:
        h = h + params["postprocess2_bias"]
    return h.to(torch.float32), (full_in, arrs)


def _extend_commit(config: WaveNetConfig, state: SamplerState, parts,
                   v: int) -> SamplerState:
    """The state after consuming the first ``v`` inputs of the window that
    ``parts`` holds, in a new ring (``state`` is not written)."""
    c = config
    full_in, arrs = parts
    kw = _input_kernel_width(c)
    t, v = state.t, int(v)
    # After v steps the register holds positions t+v-(kw-1) .. t+v-1 =
    # full_in columns v .. v+kw-2.
    new_causal = full_in[:, v:v + kw - 1]
    new_bufs = state.layer_bufs.clone()
    for l, d in enumerate(c.dilations):
        # Row r holds x_l(tau_r), tau_r = the latest time < t+v congruent
        # to r mod d: arr column v + ((r - t - v) mod d). Rows whose time
        # predates the window take their old value from arr's ring part.
        r_ids = torch.arange(d, device=full_in.device)
        cols = v + torch.remainder(r_ids - t - v, d)
        new_bufs[l, :d] = arrs[l].index_select(1, cols).transpose(0, 1)
    return SamplerState(t + v, new_causal, new_bufs)


def sample_gumbel(key: torch.Generator, shape) -> torch.Tensor:
    """Gumbel noise of ``shape`` from ``key``, on its device."""
    u = torch.rand(shape, generator=key, device=key.device)
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))


def generate_codes_resumable(params: Params, config: WaveNetConfig,
                             state: SamplerState, first_input: torch.Tensor,
                             n_samples: int, key: torch.Generator,
                             temperature: float = 1.0,
                             gc_embedding: Optional[torch.Tensor] = None,
                             lc: Optional[torch.Tensor] = None):
    """Sample ``n_samples`` codes from ``state`` with ``first_input``
    [B, C_in] as the first input; returns (codes [B, n], state,
    next_input) for a continuation. ``lc`` [B, n_samples, C_lc]: row j
    conditions generated sample j."""
    Q = config.quantization_channels
    x = first_input
    codes = []
    with torch.no_grad():
        for j in range(n_samples):
            state, logits = sampler_step(params, config, state, x,
                                         gc_embedding,
                                         None if lc is None else lc[:, j])
            code = torch.argmax(logits / temperature
                                + sample_gumbel(key, (x.shape[0], Q)), dim=-1)
            codes.append(code.to(torch.int32))
            x = _code_to_input(code, config)
    out = (torch.stack(codes, dim=1) if codes else
           torch.empty((x.shape[0], 0), dtype=torch.int32, device=x.device))
    return out, state, x


def generate_codes(params: Params, config: WaveNetConfig,
                   state: SamplerState, first_input: torch.Tensor,
                   n_samples: int, key: torch.Generator,
                   temperature: float = 1.0,
                   gc_embedding: Optional[torch.Tensor] = None,
                   lc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample ``n_samples`` mu-law codes autoregressively: [B, n]."""
    codes, _, _ = generate_codes_resumable(
        params, config, state, first_input, n_samples, key, temperature,
        gc_embedding, lc)
    return codes


def unseeded_prime(config: WaveNetConfig, batch_size: int,
                   key: torch.Generator):
    """(silence [B, receptive_field - 1], first input [B]) of an unseeded
    run: silence codes and one random code drawn from ``key``; scalar
    mode primes amplitudes of 0.0 and starts from 0.0."""
    c = config
    n_prime = c.receptive_field - 1
    dev = key.device
    if c.scalar_input:
        return (torch.zeros((batch_size, n_prime), device=dev),
                torch.zeros((batch_size,), device=dev))
    silence = torch.full((batch_size, n_prime), c.quantization_channels // 2,
                         dtype=torch.int32, device=dev)
    first = torch.randint(0, c.quantization_channels, (batch_size,),
                          generator=key, device=dev, dtype=torch.int32)
    return silence, first


def generate_sharded(params: Params, config: WaveNetConfig, n_samples: int,
                     key: torch.Generator, mesh, batch_size: int,
                     gc_ids: Optional[torch.Tensor] = None,
                     temperature: float = 1.0,
                     seed_codes: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Batched scan-sampler generation over a ``(data, model)`` mesh of
    processes (the JAX package's ``generate_sharded``) -> codes [B, n]
    on every rank.

    Every rank calls this with the whole ``params`` and the same ``key``
    state. The ring's batch is split over "data" and the weights over
    "model" (``parallel.sharding.shard_params``; the products of each
    step reduced over the model group). The priming recipe is
    ``generate``'s; each rank draws the whole first-code draw and every
    step's whole [B, Q] noise block from ``key`` and keeps its rows, so a
    row's draws do not depend on the split and the codes equal
    ``generate(params, config, n_samples, key, batch_size, ...)``'s (up
    to the order of the reduced sums). No LC, as in JAX."""
    import torch.distributed as dist

    from wavenet_torch.parallel.sharding import (
        DATA_AXIS, axis_size, data_rows, shard_params)
    from wavenet_torch.parallel.tensor import tensor_parallel

    c = config
    _check_config(c)
    rows = data_rows(batch_size, mesh)
    local = shard_params(params, c, mesh)
    tp = tensor_parallel(mesh, c)
    dev = key.device
    gc_emb = (embed_gc(local, c, torch.as_tensor(gc_ids, device=dev)[rows])
              if gc_ids is not None else None)
    if seed_codes is None:
        prime, first = unseeded_prime(c, batch_size, key)
    else:
        prime, first = seed_codes[:, :-1], seed_codes[:, -1]
    state = prefill_state(local, c, prime[rows], gc_emb, tp=tp)
    x = _featurize(first[rows], c)
    Q = c.quantization_channels
    codes = []
    with torch.no_grad():
        for _ in range(n_samples):
            state, logits = sampler_step(local, c, state, x, gc_emb, tp=tp)
            noise = sample_gumbel(key, (batch_size, Q))[rows]
            code = torch.argmax(logits / temperature + noise, dim=-1)
            codes.append(code.to(torch.int32))
            x = _code_to_input(code, c)
    out = (torch.stack(codes, dim=1) if codes else
           torch.empty((rows.stop - rows.start, 0), dtype=torch.int32,
                       device=dev))
    if mesh is None:
        return out
    parts = [torch.empty_like(out)
             for _ in range(axis_size(mesh, DATA_AXIS))]
    dist.all_gather(parts, out.contiguous(), group=mesh.get_group(DATA_AXIS))
    return torch.cat(parts, dim=0)


def lc_for_prime(lc: Optional[torch.Tensor],
                 lc_prime: Optional[torch.Tensor],
                 n_prime: int) -> Optional[torch.Tensor]:
    """Conditioning of the priming region [B, n_prime, C_lc]: ``lc_prime``
    as given, else ``lc[:, 0]`` held backward in time (the JAX package's
    ``_lc_for_prime``)."""
    if lc is None:
        return None
    if lc_prime is not None:
        if lc_prime.shape[1] != n_prime:
            raise ValueError(f"lc_prime length {lc_prime.shape[1]} != "
                             f"priming length {n_prime}")
        return lc_prime
    B, _, C = lc.shape
    return lc[:, :1].expand(B, n_prime, C)


def generate(params: Params, config: WaveNetConfig, n_samples: int,
             key: torch.Generator, batch_size: int = 1,
             gc_ids: Optional[torch.Tensor] = None,
             temperature: float = 1.0,
             seed_codes: Optional[torch.Tensor] = None,
             lc: Optional[torch.Tensor] = None,
             lc_prime: Optional[torch.Tensor] = None) -> torch.Tensor:
    """End-to-end generation -> mu-law codes [B, n_samples].

    Without a seed the queues are primed with receptive_field-1 silence
    steps and one random first code (scalar mode: amplitudes of 0.0);
    with ``seed_codes`` [B, T] (int codes, or amplitudes in scalar mode)
    the first T-1 prime the queues and the last is the first input. The
    tensors live on ``key``'s device.

    Local conditioning: ``lc`` [B, n_samples, C_lc], one row per generated
    sample, required by an LC config; ``lc_prime`` [B, n_prime, C_lc]
    conditions the priming region (default ``lc[:, 0]`` held backward).
    Both are refined here, once (``maybe_refine_lc``).
    """
    c = config
    _check_config(c)
    if c.lc_enabled and lc is None:
        raise ValueError(
            "config has lc_channels set: pass lc=[B, n_samples, "
            f"{c.lc_channels}] (zeros for unconditioned sampling)")
    lc = maybe_refine_lc(params, c, lc)
    lc_prime = maybe_refine_lc(params, c, lc_prime)
    gc_emb = (embed_gc(params, c, torch.as_tensor(gc_ids, device=key.device))
              if gc_ids is not None else None)
    if seed_codes is None:
        prime, first = unseeded_prime(c, batch_size, key)
    else:
        prime, first = seed_codes[:, :-1], seed_codes[:, -1]
    lc_p = lc_for_prime(lc, lc_prime, prime.shape[1])
    state = prefill_state(params, c, prime, gc_emb, lc_p)
    return generate_codes(params, c, state, _featurize(first, c), n_samples,
                          key, temperature, gc_emb, lc)
