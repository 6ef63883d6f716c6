"""Whole-stack training kernel, generation v2: plain versions, the CUDA
kernel's wrappers and the differentiable op.

Counterpart of ``wavenet_tpu/experiments/fused_stack2.py`` (TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``, custom VJP ``fused_stack2``), reached
with ``use_pallas_stack`` and ``pallas_stack_version`` 2. The map is v1's;
v2 packs the two tap matmuls into one K=2R matmul (the same FP32
arithmetic here) and emits z from the kernel. The TPU kernel streams fg
and z out as 128-lane records ``[B, T, L*128]``, a DMA alignment of the
TPU; the port returns them unpadded: fg ``[B, T, L*2D]`` and z
``[B, T, L*D]`` (record lanes ``[128l, 128l+2D)`` and
``[128l+2D, 128l+3D)``).

``fused_stack2_forward`` and ``fused_stack2_backward`` run the carry
kernel (``csrc/fused_stack_carry.cu``, with z) for CUDA tensors and the
plain versions for CPU tensors; each counts its launches in
``.launches`` and by mode in ``.launches_by`` ("carry", "carry_bf16").
At ``compute_dtype="bfloat16"`` the fg and z records are bf16 and the op
returns the bf16 z record, which the kernel computed from the float32
fg, as JAX's ``_extract_z`` returns it (v1's op differs here).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from wavenet_torch.experiments.fused_stack import (
    _OP, CarryPlan, _dw_split, carry_backward, carry_forward, carry_key)
from wavenet_torch.kernels import _launch
from wavenet_torch.kernels import fused_stack as _stack
from wavenet_torch.kernels.stack_pack import pack_stack_weights
from wavenet_torch.models.config import WaveNetConfig

# The TPU kernel's backward tile and record width; ``supports`` keeps
# their limits so that the same configs take the fused path in both
# packages.
_T_TILE_BWD = 1024
_REC = 128

__all__ = ["supports", "fused_stack2_forward_reference",
           "fused_stack2_backward_reference", "fused_stack2_forward",
           "fused_stack2_backward", "fused_stack2", "pack_stack_weights"]


def supports(config: WaveNetConfig, t_tile: int = _T_TILE_BWD) -> bool:
    """Mirror of the JAX kernel's ``supports``: filter_width 2, max
    dilation <= the tile, and fg and z within one 128-lane record."""
    return (config.filter_width == 2
            and max(config.dilations) <= t_tile
            and 3 * config.dilation_channels <= _REC)


def fused_stack2_forward_reference(x, w_fg, wd, add, bd,
                                   config: WaveNetConfig,
                                   matmul=torch.matmul):
    """Plain forward -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D]); every
    product through ``matmul``."""
    return _stack.fused_stack_forward_reference(x, w_fg, wd, add, bd, config,
                                                matmul=matmul)


def fused_stack2_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                    config: WaveNetConfig,
                                    matmul=torch.matmul):
    """Plain backward -> (dx, dw [L,2,R,2D], dwd [L,D,R], dadd [L,B,2D],
    dbd [L,1,R]); every product through ``matmul``."""
    dx, dw_fg, dwd, dadd, dbd = _stack.fused_stack_backward_reference(
        y, dy, fg, dz, w_fg, wd, bd, config, matmul=matmul)
    return dx, _dw_split(dw_fg, config), dwd, dadd, dbd


def fused_stack2_forward(x, w_fg, wd, add, bd, config: WaveNetConfig,
                         _plan: Optional[CarryPlan] = None):
    """Whole stack -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D]); fg and z
    in the record dtype.

    CPU tensors run ``fused_stack2_forward_reference``; CUDA tensors
    launch the carry kernel (with z; ``_plan`` pins its grid) or raise."""
    if not _launch.use_kernel(_OP, x):
        return fused_stack2_forward_reference(x, w_fg, wd, add, bd, config)
    out = carry_forward(x, w_fg, wd, add, bd, config, emit_z=True,
                        _plan=_plan)
    fused_stack2_forward.launches += 1
    fused_stack2_forward.launches_by[carry_key(config)] += 1
    return out


def fused_stack2_backward(y, dy, fg, dz, w_fg, wd, bd,
                          config: WaveNetConfig,
                          _plan: Optional[CarryPlan] = None):
    """VJP of the stack from saved (y, fg) -> (dx, dw [L,2,R,2D], dwd,
    dadd [L,B,2D], dbd [L,1,R]) (the JAX argument order).

    CPU tensors run ``fused_stack2_backward_reference``; CUDA tensors
    launch the carry kernel (``_plan`` pins its grid) or raise."""
    if not _launch.use_kernel(_OP, y):
        return fused_stack2_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                               config)
    dx, dw_fg, dwd, dadd, dbd = carry_backward(y, dy, fg, dz, w_fg, wd, bd,
                                               config, _plan=_plan)
    fused_stack2_backward.launches += 1
    fused_stack2_backward.launches_by[carry_key(config)] += 1
    return dx, _dw_split(dw_fg, config), dwd, dadd, dbd


#: Kernel launches made by each wrapper (read by chip_smoke.py), in all
#: and by mode ("carry", "carry_bf16").
fused_stack2_forward.launches = 0
fused_stack2_backward.launches = 0
fused_stack2_forward.launches_by = collections.Counter()
fused_stack2_backward.launches_by = collections.Counter()


class _FusedStack2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_fg, wd, add, bd, config):
        y, fg, z = fused_stack2_forward(x.contiguous(), w_fg.contiguous(),
                                        wd.contiguous(), add.contiguous(),
                                        bd.contiguous(), config)
        ctx.config = config
        ctx.save_for_backward(y, fg, w_fg, wd, bd)
        return y, z

    @staticmethod
    def backward(ctx, dy, dz):
        y, fg, w_fg, wd, bd = ctx.saved_tensors
        c = ctx.config
        dx, dw, dwd, dadd, dbd = fused_stack2_backward(
            y, dy.contiguous(), fg, dz.contiguous(), w_fg.contiguous(),
            wd.contiguous(), bd.contiguous(), c)
        # dw [L, 2, R, 2D] is the packed w_fg layout [L, 2R, 2D].
        return (dx, dw.reshape(c.num_layers, 2 * c.residual_channels, -1),
                dwd, dadd, dbd, None)


def fused_stack2(x, w_fg, wd, add, bd, config: WaveNetConfig):
    """Differentiable whole-stack op: (y [B,T,R], z [B,T,L*D]); z comes
    from the kernel, in the record dtype (its cotangent comes back in
    it)."""
    return _FusedStack2.apply(x, w_fg, wd, add, bd, config)
