"""Whole-stack training kernel, generation v1: plain versions, the CUDA
kernel's wrappers and the differentiable op.

Counterpart of ``wavenet_tpu/experiments/fused_stack.py`` (TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``, custom VJP ``fused_stack``), reached
with ``use_pallas_stack`` and ``pallas_stack_version`` 1 (or any version
but 2 and 3). It computes the map of ``kernels/fused_stack.py``; the
forward emits y and the gate preactivations fg, and z = tanh(fg_f) *
sigmoid(fg_g) is computed from fg outside the kernel (``_fg_to_z``), as
in JAX. The backward takes dz and is recompute-free.

``fused_stack_forward`` and ``fused_stack_backward`` run the carry kernel
(``csrc/fused_stack_carry.cu``, shared with v2: ``carry_forward``,
``carry_backward``) for CUDA tensors and the plain versions for CPU
tensors; each counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from wavenet_torch.kernels import _launch
from wavenet_torch.kernels import fused_stack as _stack
from wavenet_torch.kernels.stack_pack import pack_stack_weights, tap_offsets
from wavenet_torch.models.config import WaveNetConfig

# The TPU kernel's time tile; ``supports`` keeps its limit so that the
# same configs take the fused path in both packages.
_T_TILE = 512

__all__ = ["supports", "fused_stack_forward_reference",
           "fused_stack_backward_reference", "fused_stack_forward",
           "fused_stack_backward", "fused_stack", "carry_forward",
           "carry_backward", "pack_stack_weights", "tap_offsets"]


def supports(config: WaveNetConfig, t_tile: int = _T_TILE) -> bool:
    """Mirror of the JAX kernel's ``supports``: filter_width 2 and max
    dilation <= the tile."""
    return config.filter_width == 2 and max(config.dilations) <= t_tile


def _dw_split(dw_fg: torch.Tensor, config: WaveNetConfig) -> torch.Tensor:
    """dw_fg [L, 2R, 2D] as the JAX backward's [L, 2, R, 2D] (a view)."""
    c = config
    return dw_fg.view(c.num_layers, 2, c.residual_channels,
                      2 * c.dilation_channels)


def _fg_to_z(fg: torch.Tensor, config: WaveNetConfig) -> torch.Tensor:
    """z [B, T, L*D] from the preactivations fg [B, T, L*2D]."""
    L, D = config.num_layers, config.dilation_channels
    B, T = fg.shape[:2]
    f = fg.view(B, T, L, 2 * D)
    return (torch.tanh(f[..., :D])
            * torch.sigmoid(f[..., D:])).reshape(B, T, L * D)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                  config: WaveNetConfig):
    """Plain forward -> (y [B,T,R], fg [B,T,L*2D])."""
    y, fg, _ = _stack.fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                                    config)
    return y, fg


def fused_stack_backward_reference(y, fg, dz, dy, w_fg, wd, bd,
                                   config: WaveNetConfig):
    """Plain backward (an explicit reverse sweep that rebuilds each
    layer's input by subtraction) -> (dx, dw [L,2,R,2D], dwd [L,D,R],
    dadd [L,B,2D], dbd [L,1,R])."""
    dx, dw_fg, dwd, dadd, dbd = _stack.fused_stack_backward_reference(
        y, dy, fg, dz, w_fg, wd, bd, config)
    return dx, _dw_split(dw_fg, config), dwd, dadd, dbd


# ---------------------------------------------------------------------------
# The carry kernel, shared with v2
# ---------------------------------------------------------------------------

_OP = "fused_stack_carry"


def _lib():
    from wavenet_torch.kernels import _build
    lib = _build.load("fused_stack_carry")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_stack_carry_supports.argtypes = [i, i, i]
    lib.fused_stack_carry_supports.restype = i
    lib.fused_stack_carry_scratch_floats.argtypes = [i] * 6
    lib.fused_stack_carry_scratch_floats.restype = ctypes.c_longlong
    lib.fused_stack_carry_fwd_f32.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.fused_stack_carry_fwd_f32.restype = i
    lib.fused_stack_carry_bwd_f32.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.fused_stack_carry_bwd_f32.restype = i
    return lib


def _check_call(lib, config: WaveNetConfig, lead: torch.Tensor, w_fg, wd,
                bd):
    """Check the config and weights; the dilations as a C array."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    if c.filter_width != 2:
        raise NotImplementedError("fused_stack_carry needs filter_width=2")
    _stack.require_float32(c, "fused_stack_carry")
    if not lib.fused_stack_carry_supports(R, D, L):
        raise NotImplementedError(
            "the fused_stack_carry kernel is built for R == D in (8, 16, 32) "
            f"and 1..256 layers; got R={R}, D={D}, L={L}")
    dev = lead.device
    _launch.check(_OP, "w_fg", w_fg, (L, 2 * R, 2 * D), dev)
    _launch.check(_OP, "wd", wd, (L, D, R), dev)
    _launch.check(_OP, "bd", bd, (L, 1, R), dev)
    return (ctypes.c_int * L)(*c.dilations)


def carry_forward(x, w_fg, wd, add, bd, config: WaveNetConfig,
                  emit_z: bool):
    """One launch of the carry kernel's forward on CUDA tensors -> (y, fg,
    z or None): z [B,T,L*D] only when ``emit_z`` (v2)."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = x.shape[:2]
    lib = _lib()
    dil = _check_call(lib, c, x, w_fg, wd, bd)
    dev = x.device
    _launch.check(_OP, "x", x, (B, T, R), dev)
    _launch.check(_OP, "add", add, (L, B, 2 * D), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((B, T, R), **f32)
    fg = torch.empty((B, T, L * 2 * D), **f32)
    z = torch.empty((B, T, L * D), **f32) if emit_z else None
    scratch = torch.empty((lib.fused_stack_carry_scratch_floats(
        0, B, L, R, D, sum(c.dilations)),), **f32)
    err = lib.fused_stack_carry_fwd_f32(
        x.data_ptr(), w_fg.data_ptr(), wd.data_ptr(), add.data_ptr(),
        bd.data_ptr(), ctypes.addressof(dil), y.data_ptr(), fg.data_ptr(),
        None if z is None else z.data_ptr(), scratch.data_ptr(), B, T, L, R,
        D, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_stack_carry forward launch failed: CUDA "
                           f"error {err}")
    return y, fg, z


def carry_backward(y, dy, fg, dz, w_fg, wd, bd, config: WaveNetConfig):
    """The carry kernel's backward on CUDA tensors -> (dx, dw_fg [L,2R,2D],
    dwd, dadd [L,B,2D], dbd [L,1,R]); gradients summed in a fixed order,
    so repeated calls are bitwise equal."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = y.shape[:2]
    lib = _lib()
    dil = _check_call(lib, c, y, w_fg, wd, bd)
    dev = y.device
    for name, t, shape in (("y", y, (B, T, R)), ("dy", dy, (B, T, R)),
                           ("fg", fg, (B, T, L * 2 * D)),
                           ("dz", dz, (B, T, L * D))):
        _launch.check(_OP, name, t, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, R), **f32)
    dw_fg = torch.empty((L, 2 * R, 2 * D), **f32)
    dwd = torch.empty((L, D, R), **f32)
    dadd = torch.empty((L, B, 2 * D), **f32)
    dbd = torch.empty((L, 1, R), **f32)
    scratch = torch.empty((lib.fused_stack_carry_scratch_floats(
        1, B, L, R, D, sum(c.dilations)),), **f32)
    err = lib.fused_stack_carry_bwd_f32(
        y.data_ptr(), dy.data_ptr(), fg.data_ptr(), dz.data_ptr(),
        w_fg.data_ptr(), wd.data_ptr(), bd.data_ptr(), ctypes.addressof(dil),
        dx.data_ptr(), dw_fg.data_ptr(), dwd.data_ptr(), dadd.data_ptr(),
        dbd.data_ptr(), scratch.data_ptr(), B, T, L, R, D,
        _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_stack_carry backward launch failed: CUDA "
                           f"error {err}")
    return dx, dw_fg, dwd, dadd, dbd


# ---------------------------------------------------------------------------
# v1's wrappers and differentiable op
# ---------------------------------------------------------------------------

def fused_stack_forward(x, w_fg, wd, add, bd, config: WaveNetConfig):
    """Whole stack -> (y [B,T,R], fg [B,T,L*2D]).

    CPU tensors run ``fused_stack_forward_reference``; CUDA tensors launch
    the carry kernel (without z) or raise."""
    if not _launch.use_kernel(_OP, x):
        return fused_stack_forward_reference(x, w_fg, wd, add, bd, config)
    y, fg, _ = carry_forward(x, w_fg, wd, add, bd, config, emit_z=False)
    fused_stack_forward.launches += 1
    return y, fg


def fused_stack_backward(y, fg, dz, dy, w_fg, wd, bd,
                         config: WaveNetConfig):
    """VJP of the stack from saved (y, fg) -> (dx, dw [L,2,R,2D], dwd,
    dadd [L,B,2D], dbd [L,1,R]) (the JAX argument order).

    CPU tensors run ``fused_stack_backward_reference``; CUDA tensors
    launch the carry kernel or raise."""
    if not _launch.use_kernel(_OP, y):
        return fused_stack_backward_reference(y, fg, dz, dy, w_fg, wd, bd,
                                              config)
    dx, dw_fg, dwd, dadd, dbd = carry_backward(y, dy, fg, dz, w_fg, wd, bd,
                                               config)
    fused_stack_backward.launches += 1
    return dx, _dw_split(dw_fg, config), dwd, dadd, dbd


#: Kernel launches made by each wrapper (read by chip_smoke.py).
fused_stack_forward.launches = 0
fused_stack_backward.launches = 0


class _FusedStack(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_fg, wd, add, bd, config):
        y, fg = fused_stack_forward(x.contiguous(), w_fg.contiguous(),
                                    wd.contiguous(), add.contiguous(),
                                    bd.contiguous(), config)
        ctx.config = config
        ctx.save_for_backward(y, fg, w_fg, wd, bd)
        return y, _fg_to_z(fg, config)

    @staticmethod
    def backward(ctx, dy, dz):
        y, fg, w_fg, wd, bd = ctx.saved_tensors
        c = ctx.config
        dx, dw, dwd, dadd, dbd = fused_stack_backward(
            y, fg, dz.contiguous(), dy.contiguous(), w_fg.contiguous(),
            wd.contiguous(), bd.contiguous(), c)
        # dw [L, 2, R, 2D] is the packed w_fg layout [L, 2R, 2D].
        return (dx, dw.reshape(c.num_layers, 2 * c.residual_channels, -1),
                dwd, dadd, dbd, None)


def fused_stack(x, w_fg, wd, add, bd, config: WaveNetConfig):
    """Differentiable whole-stack op: (y [B,T,R], z [B,T,L*D])."""
    _stack.require_float32(config, "fused_stack (pallas_stack_version 1)")
    return _FusedStack.apply(x, w_fg, wd, add, bd, config)
