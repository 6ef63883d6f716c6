"""Analytic FLOPs and bytes of the network, and an H100's peaks.

Counterpart of ``wavenet_tpu/utils/flops.py`` (same conventions: 1 MAC =
2 FLOPs, a train step is 3x its forward, embedding gathers and folded
conditioning adds count as zero), with the peaks of the card the port
runs on instead of TPU peaks. MFU is taken against the bf16 peak whatever
the run's compute dtype, as in the JAX package: a float32 run pays for
its slower products, and its lower MFU is real.
"""

from __future__ import annotations

from typing import Optional

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

# The peaks by CUDA device name (``torch.cuda.get_device_name()``), matched
# as prefixes as the JAX package matches ``device_kind``: the SXM part,
# whose name carries its HBM3, is the card the constants above describe.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": H100_BF16_FLOPS}
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": H100_HBM_BYTES_PER_S}


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


def forward_flops_per_position(config: WaveNetConfig) -> float:
    return 2.0 * (stack_macs_per_position(config)
                  + head_macs_per_position(config))


def train_step_flops(config: WaveNetConfig, batch_size: int,
                     sample_size: int) -> float:
    """Model FLOPs of one train step (fwd + 2x bwd): stack over the full
    rf + sample_size window, head over the loss positions."""
    c = config
    T = c.receptive_field + sample_size
    stack = 2.0 * stack_macs_per_position(c) * batch_size * T
    head = 2.0 * head_macs_per_position(c) * batch_size * sample_size
    return 3.0 * (stack + head)


def gen_flops_per_sample(config: WaveNetConfig) -> float:
    """Model FLOPs to emit one sample for one stream (a decode step)."""
    return forward_flops_per_position(config)


def weight_bytes(config: WaveNetConfig, bytes_per_el: int = 4) -> int:
    """Bytes of matmul weights that a decode step reads (the causal
    layer, the stack, LC projections and the head)."""
    c = config
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    n = (c.filter_width * c.input_channels * R
         + L * (c.filter_width * R * 2 * D + D * R + D * S)
         + S * S + S * Q)
    if c.lc_enabled:
        n += L * c.lc_channels * 2 * D
    return n * bytes_per_el


def stream_decode_hbm_bytes_per_step(config: WaveNetConfig,
                                     batch_size: int,
                                     ring_pack: bool = False) -> int:
    """Device-memory bytes a decode step moves for ``batch_size`` rows:
    each layer's ring row read and one written (``[B, R]`` float32 each),
    the codes in and out (``B`` int32 each) and, with LC, the step's
    conditioning row (``[B, C_lc]`` float32). The weights count as
    resident (shared memory or L2), as in the JAX package.

    The JAX package counts its TPU layouts: 128-lane ring rows, a
    128-wide code record and, with ``ring_pack``, the layers its packed
    ring keeps resident. The port's rings are unpadded ``[sum_d, B, R]``
    and no decode kernel packs them, so ``ring_pack`` is taken for the
    same call signature and changes nothing. At R = 128, C_lc = 128 (or
    no LC) and B a multiple of 128 the two counts are equal."""
    del ring_pack
    c = config
    B = batch_size
    ring = 2 * c.num_layers * B * c.residual_channels * 4
    io = 2 * B * 4
    lc = B * c.lc_channels * 4 if c.lc_enabled else 0
    return ring + io + lc


def _by_prefix(table: dict, device_name: str) -> Optional[float]:
    for prefix, value in table.items():
        if device_name.startswith(prefix):
            return value
    return None


def device_peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak (FLOP/s); None for a card the table
    does not hold."""
    return _by_prefix(PEAK_BF16_FLOPS, device_name)


def device_hbm_bytes_per_s(device_name: str) -> Optional[float]:
    return _by_prefix(HBM_BYTES_PER_S, device_name)


def mfu(flops_per_s: Optional[float],
        device_name: str) -> Optional[float]:
    """Model-FLOPs utilization against the card's bf16 peak; None when the
    card's peak is unknown or there is no measurement."""
    peak = device_peak_flops(device_name)
    if peak is None or flops_per_s is None:
        return None
    return flops_per_s / peak


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
