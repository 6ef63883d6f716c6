"""Analytic FLOPs and bytes of the network, and an H100's peaks.

Counterpart of ``wavenet_tpu/utils/flops.py`` (same conventions: 1 MAC =
2 FLOPs, a train step is 3x its forward, embedding gathers and folded
conditioning adds count as zero), with the peaks of the card the port
runs on instead of TPU peaks.
"""

from __future__ import annotations

from wavenet_torch.models.config import WaveNetConfig

# NVIDIA H100 SXM (NVIDIA's data sheet), at the full 700 W: FP32 on the
# CUDA cores, dense TF32 and bf16 on the tensor cores, and HBM3 bandwidth.
# f32 mode uses no single-pass TF32; its tensor-core products are 3xTF32
# (three TF32 passes per product, ``csrc/tf32_mma.cuh``), a third of the
# TF32 rate. bf16 mode multiplies in one bf16 pass (``csrc/bf16_mma.cuh``).
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
H100_TF32X3_FLOPS = H100_TF32_FLOPS / 3
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def stack_macs_per_position(config: WaveNetConfig) -> int:
    """MACs per (batch element, position) of causal layer + dilated stack
    (including the per-layer skip projection)."""
    c = config
    L, R, D, S = (c.num_layers, c.residual_channels, c.dilation_channels,
                  c.skip_channels)
    if c.scalar_input:
        causal = c.initial_filter_width * 1 * R
    else:
        causal = c.filter_width * R
    layer = c.filter_width * R * (2 * D) + D * R + D * S
    if c.lc_enabled:
        layer += c.lc_channels * (2 * D)
    return causal + L * layer


def head_macs_per_position(config: WaveNetConfig) -> int:
    """MACs per position of the post-stack head (relu-1x1-relu-1x1)."""
    c = config
    return (c.skip_channels * c.skip_channels
            + c.skip_channels * c.quantization_channels)


def train_step_flops(config: WaveNetConfig, batch_size: int,
                     sample_size: int) -> float:
    """Model FLOPs of one train step (fwd + 2x bwd): stack over the full
    rf + sample_size window, head over the loss positions."""
    c = config
    T = c.receptive_field + sample_size
    stack = 2.0 * stack_macs_per_position(c) * batch_size * T
    head = 2.0 * head_macs_per_position(c) * batch_size * sample_size
    return 3.0 * (stack + head)


def fused_stack_cost(config: WaveNetConfig, batch_size: int, positions: int,
                     backward: bool = False, emit_z: bool = True):
    """(FLOPs, bytes) of one call of a fused dilated-stack kernel on
    [batch_size, positions] rows: its matmuls (forward: the filter|gate and
    dense products; backward: the dense product twice more, the input
    rebuild, dx over both taps and the two weight gradients), and each
    input read once and each output written once: the fg, z and dz records
    in the compute dtype (2 bytes at bfloat16), everything else in float32.
    A forward with ``emit_z=False`` (generation v1) writes no z."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    rows = batch_size * positions
    weights = L * (2 * R * 2 * D + D * R + R)
    rec_bytes = 2.0 if c.compute_dtype == "bfloat16" else 4.0
    if backward:
        macs = L * rows * (2 * (2 * R * 2 * D) + 3 * D * R)
        # y, dy in and dx out; the fg and dz records in; weights in, their
        # gradients and dadd out.
        floats = rows * 3 * R + 2 * weights + L * batch_size * 2 * D
        records = rows * 3 * L * D
    else:
        macs = L * rows * (2 * R * 2 * D + D * R)
        # x and add in, y out; the fg (and z) records out.
        floats = rows * 2 * R + weights + L * batch_size * 2 * D
        records = rows * (3 if emit_z else 2) * L * D
    return 2.0 * macs, 4.0 * floats + rec_bytes * records


def dilated_layer_cost(residual_channels: int, dilation_channels: int,
                       batch_size: int, positions: int,
                       backward: bool = False):
    """(FLOPs, bytes) of one call of the one-layer kernel on [batch_size,
    positions] rows. Forward: the filter|gate and dense products; x and
    add in, y and z out. Backward: the filter|gate product again (the
    recompute), dz from dy, dx_local and dpast, and the dw and dwd
    gradients; x, dy, dz and add in, dx_local, dpast and the gradients
    out. The weights are read once; float32."""
    R, D = residual_channels, dilation_channels
    rows = batch_size * positions
    weights = 2 * R * 2 * D + D * R + R
    if backward:
        macs = rows * (3 * (2 * R * 2 * D) + 2 * D * R)
        floats = rows * (4 * R + D) + 2 * weights + 2 * batch_size * 2 * D
    else:
        macs = rows * (2 * R * 2 * D + D * R)
        floats = rows * (2 * R + D) + weights + batch_size * 2 * D
    return 2.0 * macs, 4.0 * floats


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = H100_FP32_FLOPS,
             bytes_per_s: float = H100_HBM_BYTES_PER_S):
    """Least time (ms) for the work on one H100, and what sets it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / bytes_per_s
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"
