"""Functional WaveNet: parameter init, forward pass and training loss.

Counterpart of ``wavenet_tpu/models/wavenet.py``. Parameters are the same
flat dict of layer-stacked tensors (keys and shapes below), so one numpy
dict of weights runs in both packages (see ``wavenet_torch.params``).

    causal_filter             [ifw|fw, 1|Q, R]
    filter, gate              [L, fw, R, D]
    dense                     [L, D, R]
    skip                      [L, D, S]
    gc_filter, gc_gate        [L, G, D]          (if GC)
    filter_bias, gate_bias    [L, D]             (if use_biases)
    dense_bias                [L, R]             (if use_biases)
    skip_bias                 [L, S]             (if use_biases)
    postprocess1              [S, S]
    postprocess2              [S, Q]
    postprocess1_bias/2_bias  [S] / [Q]          (if use_biases)
    gc_embedding              [cardinality, G]   (if GC)
    lc_filter, lc_gate        [L, C_lc, D]       (if LC)
    lc_up_depth               [C_lc, W]          (if lc_refine_width W)
    lc_up_point, lc_up_bias   [C_lc, C_lc] / [C_lc]

Every layer keeps the full time axis (causal left padding), and the skip
projections are deferred to one matmul over all layers' gate outputs, as
in the JAX package. ``tp`` (a ``parallel.tensor.TensorParallel``) runs
the forward on this rank's shards of model-sharded params, with the
collectives of tensor parallelism (``parallel/tensor.py``); None (the
default) is the single-device forward. With ``use_pallas_stack`` (the
JAX flag's name) the dilated stack runs through a hand-written CUDA
kernel pair:
``kernels/fused_stack.py`` (``pallas_stack_version`` 3) or one of the
retired generations in ``experiments/`` (versions 1 and 2). A local
conditioning stream ``lc`` [B, T, C_lc] sends the stack to the plain
route, as in JAX (the kernels take no per-position stream); ``lc[:, t]``
conditions output position t. ``loss_fn(lc=...)`` trains with LC, on the
plain route too.

``compute_dtype="bfloat16"`` follows the JAX package's two routes. The
plain route casts the weights, biases, GC embedding and network input to
bf16 (``_maybe_cast``, at the JAX package's points), so every activation,
the residual included, is bf16; the stack route keeps the residual in
float32 inside the kernel and returns bf16 gate outputs. Both heads run
in bf16 and return float32 logits; params stay float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from wavenet_torch import resolve_device
from wavenet_torch.audio import mu_law_encode
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.ops.conv import causal_conv_padded, conv1x1

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Glorot uniform with TF conv fan semantics: fan = prod(spatial)*channels."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    elif len(shape) == 3:                       # [filter_width, in, out]
        fan_in, fan_out = shape[0] * shape[1], shape[0] * shape[2]
    elif len(shape) == 4:                       # [L, filter_width, in, out]
        fan_in, fan_out = shape[1] * shape[2], shape[1] * shape[3]
    else:
        raise ValueError(f"unsupported shape {shape}")
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def create_embedding_table(gen: torch.Generator, cardinality: int,
                           channels: int) -> torch.Tensor:
    """Identity when square (one-hot semantics), else Xavier."""
    if cardinality == channels:
        return torch.eye(cardinality, dtype=torch.float32)
    return _xavier_uniform(gen, (cardinality, channels))


def init_params(seed: Union[int, torch.Generator], config: WaveNetConfig,
                device=None) -> Params:
    """Build the parameter dict (layout in the module docstring).

    Weights are drawn on the CPU from ``seed`` (an int or a CPU
    ``torch.Generator``) and then moved to ``device``, so a seed gives
    the same weights on every device. The draws differ from
    ``jax.random``'s; carry weights across packages as numpy
    (``wavenet_torch.params``).
    """
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator().manual_seed(int(seed))
    c = config
    L = c.num_layers
    fw, R, D, S, Q = (c.filter_width, c.residual_channels,
                      c.dilation_channels, c.skip_channels,
                      c.quantization_channels)
    p: Params = {}
    if c.scalar_input:
        p["causal_filter"] = _xavier_uniform(gen, (c.initial_filter_width,
                                                   1, R))
    else:
        p["causal_filter"] = _xavier_uniform(gen, (fw, Q, R))
    p["filter"] = _xavier_uniform(gen, (L, fw, R, D))
    p["gate"] = _xavier_uniform(gen, (L, fw, R, D))
    # 1x1 convs stored as plain matrices; fans of the [1, in, out] shapes.
    p["dense"] = _xavier_uniform(gen, (L, 1, D, R))[:, 0]
    p["skip"] = _xavier_uniform(gen, (L, 1, D, S))[:, 0]
    p["postprocess1"] = _xavier_uniform(gen, (1, S, S))[0]
    p["postprocess2"] = _xavier_uniform(gen, (1, S, Q))[0]
    if c.gc_enabled:
        G = c.gc_channels
        p["gc_embedding"] = create_embedding_table(gen, c.gc_cardinality, G)
        p["gc_filter"] = _xavier_uniform(gen, (L, 1, G, D))[:, 0]
        p["gc_gate"] = _xavier_uniform(gen, (L, 1, G, D))[:, 0]
    if c.lc_enabled:
        Cl = c.lc_channels
        p["lc_filter"] = _xavier_uniform(gen, (L, 1, Cl, D))[:, 0]
        p["lc_gate"] = _xavier_uniform(gen, (L, 1, Cl, D))[:, 0]
        if c.lc_refine_width:
            # Identity at init: a delta at the depthwise center tap, an
            # identity mix and a zero bias (the JAX package's init).
            w = c.lc_refine_width
            depth = torch.zeros((Cl, w))
            depth[:, w // 2] = 1.0
            p["lc_up_depth"] = depth
            p["lc_up_point"] = torch.eye(Cl)
            p["lc_up_bias"] = torch.zeros((Cl,))
    if c.use_biases:
        p["filter_bias"] = torch.zeros((L, D))
        p["gate_bias"] = torch.zeros((L, D))
        p["dense_bias"] = torch.zeros((L, R))
        p["skip_bias"] = torch.zeros((L, S))
        p["postprocess1_bias"] = torch.zeros((S,))
        p["postprocess2_bias"] = torch.zeros((Q,))
    return {k: v.contiguous().to(dev) for k, v in p.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def one_hot(encoded: torch.Tensor, quantization_channels: int) -> torch.Tensor:
    """int [B, T] -> float32 one-hot [B, T, Q]."""
    return F.one_hot(encoded.long(), quantization_channels).to(torch.float32)


def embed_gc(params: Params, config: WaveNetConfig,
             gc_ids: torch.Tensor) -> torch.Tensor:
    """Speaker ids [B] -> embeddings [B, G] (a row gather)."""
    return params["gc_embedding"][gc_ids.long()]


class _EmbedRows(torch.autograd.Function):
    """Row gather whose backward is one_hot(codes)^T @ dout, as the JAX
    package's ``_embed_rows``: a matmul, deterministic on the card (the
    gather's own backward adds rows with atomics there)."""

    @staticmethod
    def forward(ctx, table, codes):
        ctx.save_for_backward(codes)
        ctx.rows = table.shape[0]
        return F.embedding(codes, table)

    @staticmethod
    def backward(ctx, dout):
        codes, = ctx.saved_tensors
        oh = F.one_hot(codes, ctx.rows).to(dout.dtype)
        return torch.einsum("btq,btr->qr", oh, dout), None


def _embed_rows(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return _EmbedRows.apply(table, codes.long())


def refine_lc(params: Params, config: WaveNetConfig,
              lc: torch.Tensor) -> torch.Tensor:
    """Learned LC upsampling refinement [B, T, C] -> [B, T, C]: a
    depthwise conv of width ``lc_refine_width`` (zero-padded, centered)
    then a pointwise C x C mix and a bias, in float32 (the JAX package's
    ``refine_lc``). The entry points that take a whole stream refine it
    once, before any slicing."""
    c = config
    w = c.lc_refine_width
    x = lc.to(torch.float32).transpose(1, 2)                 # [B, C, T]
    depth = params["lc_up_depth"].to(torch.float32)[:, None, :]
    y = F.conv1d(x, depth, padding=w // 2, groups=c.lc_channels)
    y = y.transpose(1, 2)                                    # [B, T, C]
    return (y @ params["lc_up_point"].to(torch.float32)
            + params["lc_up_bias"].to(torch.float32))


def maybe_refine_lc(params: Params, config: WaveNetConfig, lc):
    """``refine_lc`` when the config refines and a stream is given, else
    the stream as it is."""
    if lc is None or not config.lc_refine_width:
        return lc
    return refine_lc(params, config, lc)


def _check_supported(c: WaveNetConfig) -> None:
    if c.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {c.compute_dtype!r}: float32 or "
                         "bfloat16")


def _maybe_cast(x: torch.Tensor, config: WaveNetConfig) -> torch.Tensor:
    """``x`` in bf16 when the config computes in bf16 (the JAX package's
    ``_maybe_cast``), else as it is. The model casts at exactly the JAX
    package's points, not through ``torch.autocast``: the weights, biases,
    GC embedding and network input, so every product takes bf16 operands
    and every activation, the residual included, is bf16. Params (and
    their gradients) stay float32."""
    if config.compute_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x


def _bf16_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it in bf16: 1 / (1 + exp(-x)),
    each op rounded to bf16 (``torch.sigmoid`` rounds once, from float32)."""
    return 1.0 / (1.0 + torch.exp(-x))


def _gate(conv_filter: torch.Tensor, conv_gate: torch.Tensor):
    """tanh(filter) * sigmoid(gate); in bf16 the sigmoid is XLA's."""
    if conv_gate.dtype == torch.bfloat16:
        return torch.tanh(conv_filter) * _bf16_sigmoid(conv_gate)
    return torch.tanh(conv_filter) * torch.sigmoid(conv_gate)


@contextlib.contextmanager
def matmul_precision(config: WaveNetConfig):
    """bf16 products accumulated in float32 on the card, as XLA does:
    PyTorch lets cuBLAS reduce bf16 GEMMs in reduced precision by default
    (``allow_bf16_reduced_precision_reduction``), so a bf16 config turns
    that off for the block and restores it after. Wrap the forward and the
    backward of a bf16 step in it; float32 configs change nothing."""
    if config.compute_dtype != "bfloat16":
        yield
        return
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = saved


def forward(params: Params, config: WaveNetConfig,
            network_input: torch.Tensor,
            gc_embedding: Optional[torch.Tensor] = None,
            head_from: int = 0,
            collect_layer_inputs: Optional[Tuple[int, ...]] = None,
            lc: Optional[torch.Tensor] = None, tp=None):
    """Full-length forward pass: [B, T, C_in] -> logits [B, T, Q].

    Output position t is the prediction for input position t+1. With
    ``collect_layer_inputs`` it returns, instead of logits, the list of
    each layer's last ``collect_layer_inputs[l]`` input positions (the
    sampler prefill's ring contents), in float32. ``lc`` [B, T, C_lc]:
    ``lc[:, t]`` conditions output position t (the prediction of input
    t + 1); it is used as given (``predict_proba`` refines it).

    At ``compute_dtype="bfloat16"`` the input and weights are cast to bf16
    (``_maybe_cast``) and the logits come back in float32.
    """
    _check_supported(config)
    current = causal_conv_padded(
        _maybe_cast(network_input.to(torch.float32), config),
        _maybe_cast(params["causal_filter"], config), dilation=1)
    return _dilated_stack(params, config, current, gc_embedding, head_from,
                          collect_layer_inputs, lc, tp)


class _Local:
    """The single-device forward's collectives: none."""

    @staticmethod
    def copy(x: torch.Tensor) -> torch.Tensor:
        return x

    reduce = copy


_LOCAL = _Local()


def _dilated_stack(params: Params, c: WaveNetConfig, current: torch.Tensor,
                   gc_embedding: Optional[torch.Tensor], head_from: int = 0,
                   collect_layer_inputs: Optional[Tuple[int, ...]] = None,
                   lc: Optional[torch.Tensor] = None, tp=None):
    """Gated dilation layers + deferred skip head + postprocessing. Under
    ``tp`` the filter/gate products are column-parallel (their input
    enters through ``tp.copy``) and the dense products row-parallel
    (``tp.reduce``, then the bias)."""
    lc_c = None
    if lc is not None:
        if lc.shape[1] != current.shape[1]:
            raise ValueError(
                f"lc length {lc.shape[1]} must match the input length "
                f"{current.shape[1]} (one conditioning vector per input "
                "position)")
        lc_c = _maybe_cast(lc.to(torch.float32), c)
        if tp is not None:
            lc_c = tp.copy(lc_c)
    # The stack kernels take no per-position stream: LC runs the plain
    # route, as in JAX.
    if c.use_pallas_stack and collect_layer_inputs is None and lc_c is None:
        if c.filter_width != 2:
            raise NotImplementedError(
                "use_pallas_stack requires filter_width=2")
        if tp is not None:
            # The kernel on the gathered weights, as GSPMD runs JAX's
            # (parallel/tensor.py).
            params = tp.gather_params(params)
        return _dilated_stack_pallas(params, c, current, gc_embedding,
                                     head_from)
    tp = _LOCAL if tp is None else tp
    D = params["filter"].shape[-1]          # this rank's share under tp
    gc = None if gc_embedding is None else tp.copy(
        _maybe_cast(gc_embedding, c))

    def p(key, i):
        return _maybe_cast(params[key][i], c)

    def layer_fn(current, i):
        dilation = c.dilations[i]
        w_f, w_g = p("filter", i), p("gate", i)
        x = tp.copy(current)
        if c.merged_filter_gate:
            conv_fg = causal_conv_padded(x, torch.cat([w_f, w_g], -1),
                                         dilation)
            conv_filter, conv_gate = conv_fg[..., :D], conv_fg[..., D:]
        else:
            conv_filter = causal_conv_padded(x, w_f, dilation)
            conv_gate = causal_conv_padded(x, w_g, dilation)
        if gc is not None:
            conv_filter = conv_filter + (gc @ p("gc_filter", i))[:, None, :]
            conv_gate = conv_gate + (gc @ p("gc_gate", i))[:, None, :]
        if lc_c is not None:
            conv_filter = conv_filter + lc_c @ p("lc_filter", i)
            conv_gate = conv_gate + lc_c @ p("lc_gate", i)
        if c.use_biases:
            conv_filter = conv_filter + p("filter_bias", i)
            conv_gate = conv_gate + p("gate_bias", i)
        out = _gate(conv_filter, conv_gate)
        transformed = tp.reduce(conv1x1(out, p("dense", i)))
        if c.use_biases:
            transformed = transformed + p("dense_bias", i)
        return current + transformed, out

    gate_outs = []
    layer_inputs = []
    for i in range(c.num_layers):
        if collect_layer_inputs is not None:
            keep = collect_layer_inputs[i]
            layer_inputs.append(
                current[:, current.shape[1] - keep:].to(torch.float32))
        if c.remat and torch.is_grad_enabled():
            # Recompute the layer in the backward instead of keeping its
            # activations (the JAX package's jax.checkpoint).
            current, out = torch.utils.checkpoint.checkpoint(
                layer_fn, current, i, use_reentrant=False)
        else:
            current, out = layer_fn(current, i)
        if collect_layer_inputs is None:
            gate_outs.append(out)
    if collect_layer_inputs is not None:
        return layer_inputs
    return _head(params, c, torch.cat(gate_outs, dim=-1), head_from, tp)


def _head(params: Params, c: WaveNetConfig, all_outs: torch.Tensor,
          head_from: int, tp=None) -> torch.Tensor:
    """Deferred skip head: one matmul over all layers' gate outputs
    ``all_outs [B, T, L*D]``, then relu, 1x1, relu, 1x1; float32 logits.
    At bf16 the gate outputs (the kernel's z records too) and the weights
    are bf16, as in both JAX routes. Under ``tp`` each rank holds the
    D/tp columns of every layer in ``all_outs`` and the matching rows of
    ``skip``; skip and postprocess2 are row-parallel, postprocess1
    column-parallel."""
    tp = _LOCAL if tp is None else tp
    S = c.skip_channels
    if head_from:
        all_outs = all_outs[:, head_from:]
    skip_sum = tp.reduce(_maybe_cast(all_outs, c) @ _maybe_cast(
        params["skip"].reshape(-1, S), c))
    if c.use_biases:
        skip_sum = skip_sum + _maybe_cast(params["skip_bias"].sum(dim=0), c)
    h = tp.copy(torch.relu(skip_sum))
    h = conv1x1(h, _maybe_cast(params["postprocess1"], c))
    if c.use_biases:
        h = h + _maybe_cast(params["postprocess1_bias"], c)
    h = torch.relu(h)
    h = tp.reduce(conv1x1(h, _maybe_cast(params["postprocess2"], c)))
    if c.use_biases:
        h = h + _maybe_cast(params["postprocess2_bias"], c)
    return h.to(torch.float32)


def _dilated_stack_pallas(params: Params, c: WaveNetConfig,
                          current: torch.Tensor,
                          gc_embedding: Optional[torch.Tensor],
                          head_from: int = 0) -> torch.Tensor:
    """Dilated stack through a whole-stack kernel pair, then the deferred
    skip head in plain PyTorch (the JAX package's ``_dilated_stack_pallas``).
    Version 3 (the default) runs ``kernels/fused_stack.py``, version 2
    ``experiments/fused_stack2.py`` and any other version
    ``experiments/fused_stack.py``, as in JAX. No route pads z to lanes,
    so the skip weights are used as they are. The residual enters the
    stack in float32 whatever the compute dtype (the stack reads that
    from the config), as in JAX."""
    if c.pallas_stack_version == 3:
        from wavenet_torch.kernels.fused_stack import (
            fused_stack3 as stack, supports)
    elif c.pallas_stack_version == 2:
        from wavenet_torch.experiments.fused_stack2 import (
            fused_stack2 as stack, supports)
    else:
        from wavenet_torch.experiments.fused_stack import (
            fused_stack as stack, supports)
    if not supports(c):
        raise NotImplementedError(
            "use_pallas_stack requires filter_width=2 and max "
            "dilation <= the kernel tile size")
    from wavenet_torch.kernels.stack_pack import pack_stack_weights
    w_fg, wd, add, bd = pack_stack_weights(params, c, gc_embedding,
                                           current.shape[0])
    _, all_outs = stack(current.to(torch.float32), w_fg, wd, add, bd, c)
    return _head(params, c, all_outs, head_from)


def forward_codes(params: Params, config: WaveNetConfig,
                  codes: torch.Tensor,
                  gc_embedding: Optional[torch.Tensor] = None,
                  head_from: int = 0,
                  collect_layer_inputs: Optional[Tuple[int, ...]] = None,
                  lc: Optional[torch.Tensor] = None, tp=None):
    """Forward pass from integer mu-law codes [B, T] (no one-hot tensor).

    The causal layer over one-hot input is a row gather of the filter:
    out[t] = W[fw-1][code[t]] + sum_k W[k][code[t - (fw-1-k)]],
    gathered and summed in float32, then cast to the compute dtype.
    """
    c = config
    if c.scalar_input:
        raise ValueError("forward_codes is the mu-law path; scalar input "
                         "uses forward() on raw amplitudes.")
    _check_supported(c)
    w = params["causal_filter"]                              # [fw, Q, R]
    fw = w.shape[0]
    T = codes.shape[1]
    idx = codes.long()
    current = _embed_rows(w[fw - 1], idx)                     # [B, T, R]
    for k in range(fw - 1):
        shift = fw - 1 - k
        if shift >= T:
            continue
        tap = _embed_rows(w[k], idx[:, :T - shift])
        current = torch.cat([current[:, :shift],
                             current[:, shift:] + tap], dim=1)
    current = _maybe_cast(current, c)
    return _dilated_stack(params, c, current, gc_embedding, head_from,
                          collect_layer_inputs, lc, tp)


def predict_proba(params: Params, config: WaveNetConfig,
                  waveform: torch.Tensor,
                  gc_ids: Optional[torch.Tensor] = None,
                  lc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax probabilities [B, Q] of the sample after the window
    ``waveform`` (int mu-law codes [B, T], or float amplitudes [B, T] in
    scalar-input mode). ``lc`` [B, T, C_lc] is refined here
    (``maybe_refine_lc``); the result is conditioned on ``lc[:, -1]``."""
    gc_emb = embed_gc(params, config, gc_ids) if gc_ids is not None else None
    lc = maybe_refine_lc(params, config, lc)
    if config.scalar_input:
        logits = forward(params, config,
                         waveform[..., None].to(torch.float32), gc_emb, lc=lc)
    else:
        logits = forward_codes(params, config, waveform, gc_emb, lc=lc)
    return torch.softmax(logits[:, -1, :], dim=-1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(params: Params, config: WaveNetConfig,
            audio_batch: torch.Tensor,
            gc_ids: Optional[torch.Tensor] = None,
            l2_regularization_strength: Optional[float] = None,
            lc: Optional[torch.Tensor] = None, tp=None):
    """Teacher-forced cross-entropy, as the JAX package's ``loss_fn``.

    ``audio_batch``: float waveform [B, T], left-padded with
    receptive_field zeros by the data pipeline. Network input is
    ``encoded[:, :T-1]``, predictions are outputs ``[rf-1:]`` (the head
    runs only there, ``head_from``), targets ``encoded[:, rf:]``. L2 is
    0.5 * sum(v^2) over every parameter whose key does not end in
    ``_bias``. Returns (total_loss, aux) with ``ce_loss``,
    ``total_loss`` and, with L2, ``l2_loss``.

    ``lc`` [B, T, C_lc] rides the audio timeline (``lc[:, t]`` conditions
    the prediction of sample t). It is refined over the whole timeline
    (``maybe_refine_lc``, so its gradients reach the refiner), then the
    forward, whose output j predicts input j+1, takes ``lc[:, 1:]``.

    ``tp``: this rank's shards of model-sharded params (the forward's
    ``tp``); the loss and its L2 term are those of the whole model.
    """
    c = config
    rf = c.receptive_field
    if audio_batch.dim() == 3:
        audio_batch = audio_batch[..., 0]
    encoded = mu_law_encode(audio_batch, c.quantization_channels)
    gc_emb = embed_gc(params, c, gc_ids) if gc_ids is not None else None
    lc_in = None
    if lc is not None:
        if tuple(lc.shape[:2]) != tuple(audio_batch.shape[:2]):
            raise ValueError(
                f"lc shape {tuple(lc.shape)} must align with the audio "
                f"batch {tuple(audio_batch.shape)} (one conditioning "
                "vector per sample)")
        lc_in = maybe_refine_lc(params, c, lc)[:, 1:]
    if c.scalar_input:
        network_input = audio_batch[:, :-1, None].to(torch.float32)
        prediction = forward(params, c, network_input, gc_emb,
                             head_from=rf - 1, lc=lc_in, tp=tp)
    else:
        prediction = forward_codes(params, c, encoded[:, :-1], gc_emb,
                                   head_from=rf - 1, lc=lc_in, tp=tp)
    target = encoded[:, rf:]
    logp = torch.log_softmax(prediction, dim=-1)
    oh = one_hot(target, c.quantization_channels)
    ce = -torch.mean(torch.sum(logp * oh, dim=-1))

    aux = {"ce_loss": ce}
    total = ce
    if l2_regularization_strength:
        l2 = (tp.l2_loss(params) if tp is not None else
              sum(0.5 * torch.sum(torch.square(v)) for k, v in params.items()
                  if not k.endswith("_bias")))
        aux["l2_loss"] = l2
        total = ce + l2_regularization_strength * l2
    aux["total_loss"] = total
    return total, aux
