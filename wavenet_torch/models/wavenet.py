"""Functional WaveNet, inference half: parameter init and forward pass.

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

Every layer keeps the full time axis (causal left padding), and the skip
projections are deferred to one matmul over all layers' gate outputs, as
in the JAX package. The loss, LC (and its refinement), remat and the
fused training-stack kernel are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from wavenet_torch import resolve_device
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
        raise NotImplementedError(
            "local conditioning is not ported yet (ROADMAP.md queue 1, "
            "'LC in sampler_decode')")
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


def _check_supported(c: WaveNetConfig, lc) -> None:
    if c.compute_dtype != "float32":
        raise NotImplementedError(
            "the port runs float32 only; bf16 is queued in ROADMAP.md")
    if lc is not None or c.lc_enabled:
        raise NotImplementedError(
            "local conditioning is not ported yet (ROADMAP.md queue 1, "
            "'LC in sampler_decode')")
    if c.use_pallas_stack:
        raise NotImplementedError(
            "the fused training-stack kernel is not ported yet "
            "(ROADMAP.md queue 2, kernel 5)")


def forward(params: Params, config: WaveNetConfig,
            network_input: torch.Tensor,
            gc_embedding: Optional[torch.Tensor] = None,
            head_from: int = 0,
            collect_layer_inputs: Optional[Tuple[int, ...]] = None,
            lc: Optional[torch.Tensor] = None):
    """Full-length forward pass: [B, T, C_in] -> logits [B, T, Q].

    Output position t is the prediction for input position t+1. With
    ``collect_layer_inputs`` it returns, instead of logits, the list of
    each layer's last ``collect_layer_inputs[l]`` input positions (the
    sampler prefill's ring contents).
    """
    _check_supported(config, lc)
    current = causal_conv_padded(network_input.to(torch.float32),
                                 params["causal_filter"], dilation=1)
    return _dilated_stack(params, config, current, gc_embedding, head_from,
                          collect_layer_inputs)


def _dilated_stack(params: Params, c: WaveNetConfig, current: torch.Tensor,
                   gc_embedding: Optional[torch.Tensor], head_from: int = 0,
                   collect_layer_inputs: Optional[Tuple[int, ...]] = None):
    """Gated dilation layers + deferred skip head + postprocessing."""
    L, D, S = c.num_layers, c.dilation_channels, c.skip_channels
    gate_outs = []
    layer_inputs = []
    for i, dilation in enumerate(c.dilations):
        if collect_layer_inputs is not None:
            keep = collect_layer_inputs[i]
            layer_inputs.append(current[:, current.shape[1] - keep:])
        w_f, w_g = params["filter"][i], params["gate"][i]
        if c.merged_filter_gate:
            conv_fg = causal_conv_padded(current, torch.cat([w_f, w_g], -1),
                                         dilation)
            conv_filter, conv_gate = conv_fg[..., :D], conv_fg[..., D:]
        else:
            conv_filter = causal_conv_padded(current, w_f, dilation)
            conv_gate = causal_conv_padded(current, w_g, dilation)
        if gc_embedding is not None:
            conv_filter = conv_filter + (
                gc_embedding @ params["gc_filter"][i])[:, None, :]
            conv_gate = conv_gate + (
                gc_embedding @ params["gc_gate"][i])[:, None, :]
        if c.use_biases:
            conv_filter = conv_filter + params["filter_bias"][i]
            conv_gate = conv_gate + params["gate_bias"][i]
        out = torch.tanh(conv_filter) * torch.sigmoid(conv_gate)
        transformed = conv1x1(out, params["dense"][i])
        if c.use_biases:
            transformed = transformed + params["dense_bias"][i]
        current = current + transformed
        if collect_layer_inputs is None:
            gate_outs.append(out)
    if collect_layer_inputs is not None:
        return layer_inputs

    # Deferred skip head: one matmul over all layers' gate outputs.
    all_outs = torch.cat(gate_outs, dim=-1)                 # [B, T, L*D]
    if head_from:
        all_outs = all_outs[:, head_from:]
    skip_sum = all_outs @ params["skip"].reshape(L * D, S)
    if c.use_biases:
        skip_sum = skip_sum + params["skip_bias"].sum(dim=0)
    h = torch.relu(skip_sum)
    h = conv1x1(h, params["postprocess1"])
    if c.use_biases:
        h = h + params["postprocess1_bias"]
    h = torch.relu(h)
    h = conv1x1(h, params["postprocess2"])
    if c.use_biases:
        h = h + params["postprocess2_bias"]
    return h


def forward_codes(params: Params, config: WaveNetConfig,
                  codes: torch.Tensor,
                  gc_embedding: Optional[torch.Tensor] = None,
                  head_from: int = 0,
                  collect_layer_inputs: Optional[Tuple[int, ...]] = None,
                  lc: Optional[torch.Tensor] = None):
    """Forward pass from integer mu-law codes [B, T] (no one-hot tensor).

    The causal layer over one-hot input is a row gather of the filter:
    out[t] = W[fw-1][code[t]] + sum_k W[k][code[t - (fw-1-k)]].
    """
    c = config
    if c.scalar_input:
        raise ValueError("forward_codes is the mu-law path; scalar input "
                         "uses forward() on raw amplitudes.")
    _check_supported(c, lc)
    w = params["causal_filter"]                              # [fw, Q, R]
    fw = w.shape[0]
    T = codes.shape[1]
    idx = codes.long()
    current = F.embedding(idx, w[fw - 1])                     # [B, T, R]
    for k in range(fw - 1):
        shift = fw - 1 - k
        if shift >= T:
            continue
        tap = F.embedding(idx[:, :T - shift], w[k])
        current = torch.cat([current[:, :shift],
                             current[:, shift:] + tap], dim=1)
    return _dilated_stack(params, c, current, gc_embedding, head_from,
                          collect_layer_inputs)
