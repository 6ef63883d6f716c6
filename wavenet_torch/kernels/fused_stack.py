"""The whole dilated stack of a training step: plain versions, the CUDA
kernel's wrappers and the differentiable op.

Counterpart of ``wavenet_tpu/kernels/fused_stack3.py`` (TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``, custom VJP ``fused_stack3``). Per
layer l with dilation d, over all rows (b, t):

    fg = [x(t-d) | x(t)] @ w_fg[l] + add[l, b]      (x(t-d) = 0 for t < d)
    z  = tanh(fg[:D]) * sigmoid(fg[D:])
    x' = x + (z @ wd[l] + bd[l])

The forward returns ``y`` (the last layer's output), the preactivations
``fg [B, T, L*2D]`` (what the backward reads) and the gate outputs
``z [B, T, L*D]``. Unlike the TPU kernel, ``z`` and ``fg`` carry no
128-lane record padding (a TPU layout), so the head uses the skip weights
unpadded. The backward rebuilds each layer's input by subtraction, as the
TPU kernel does: no recompute, no saved layer inputs.

``forward`` and ``backward`` run the kernel (``csrc/fused_stack.cu``) for
CUDA tensors and the plain versions for CPU tensors; each counts its
kernel launches in ``forward.launches`` / ``backward.launches`` (one per
call: the call runs L kernels forward, 2L + 1 backward).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.stack_pack import pack_stack_weights, tap_offsets
from wavenet_torch.models.config import WaveNetConfig

# Tile sizes of the TPU kernel; ``supports`` keeps its limits so that the
# same configs take the fused path in both packages.
_T_TILE_BWD = 1024
_LANE = 128

__all__ = ["supports", "fused_stack_forward_reference",
           "fused_stack_backward_reference", "forward", "backward",
           "fused_stack3", "pack_stack_weights", "tap_offsets"]


def _lane_alignable(width: int) -> bool:
    return (width % _LANE == 0) if width >= _LANE else (_LANE % width == 0)


def supports(config: WaveNetConfig, t_tile: int = _T_TILE_BWD) -> bool:
    """Mirror of the JAX kernel's ``supports``: filter_width 2, max
    dilation <= the tile, and widths its 128-lane records can pack."""
    c = config
    return (_lane_alignable(2 * c.dilation_channels)
            and _lane_alignable(c.dilation_channels)
            and c.filter_width == 2 and max(c.dilations) <= t_tile)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _past(x: torch.Tensor, d: int) -> torch.Tensor:
    """x(t - d), zero for t < d, within each batch row."""
    return F.pad(x, (0, 0, d, 0))[:, :x.shape[1]]


@torch.no_grad()
def fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                  config: WaveNetConfig):
    """Plain forward -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D])."""
    D = config.dilation_channels
    fgs, zs = [], []
    for l, d in enumerate(config.dilations):
        fg = torch.cat([_past(x, d), x], dim=-1) @ w_fg[l] + add[l][:, None]
        z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
        x = x + (z @ wd[l] + bd[l])
        fgs.append(fg)
        zs.append(z)
    return x, torch.cat(fgs, dim=-1), torch.cat(zs, dim=-1)


@torch.no_grad()
def fused_stack_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                   config: WaveNetConfig):
    """Plain backward: an explicit reverse sweep over the layers (not
    autograd) that rebuilds each layer's input by subtraction.
    -> (dx [B,T,R], dw_fg [L,2R,2D], dwd [L,D,R], dadd [L,B,2D],
    dbd [L,1,R])."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    T = y.shape[1]
    x, dcur = y.clone(), dy.clone()
    dw_fg = torch.empty_like(w_fg)
    dwd = torch.empty_like(wd)
    dbd = torch.empty((L, 1, R), dtype=y.dtype, device=y.device)
    dadd = torch.empty((L, y.shape[0], 2 * D), dtype=y.dtype,
                       device=y.device)
    for l in reversed(range(L)):
        d = c.dilations[l]
        t_ = torch.tanh(fg[..., 2 * D * l:2 * D * l + D])
        s_ = torch.sigmoid(fg[..., 2 * D * l + D:2 * D * (l + 1)])
        z = t_ * s_
        dwd[l] = torch.einsum("btd,btr->dr", z, dcur)
        dbd[l, 0] = dcur.sum(dim=(0, 1))
        dzt = dz[..., D * l:D * (l + 1)] + dcur @ wd[l].T
        da = torch.cat([dzt * s_ * (1.0 - t_ * t_),
                        dzt * t_ * s_ * (1.0 - s_)], dim=-1)
        x = (x - z @ wd[l]) - bd[l]
        dw_fg[l] = torch.einsum("btk,btn->kn",
                                torch.cat([_past(x, d), x], dim=-1), da)
        tmp = da @ w_fg[l].T                                 # [B, T, 2R]
        dcur = dcur + tmp[..., R:]
        if d < T:
            dcur[:, :T - d] += tmp[:, d:, :R]
        dadd[l] = da.sum(dim=1)
    return dcur, dw_fg, dwd, dadd, dbd


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from wavenet_torch.kernels import _build
    lib = _build.load("fused_stack")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_stack_supports_width.argtypes = [i, i]
    lib.fused_stack_supports_width.restype = i
    lib.fused_stack_bwd_scratch_floats.argtypes = [i] * 5
    lib.fused_stack_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.fused_stack_fwd_f32.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.fused_stack_fwd_f32.restype = i
    lib.fused_stack_bwd_f32.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.fused_stack_bwd_f32.restype = i
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    _launch.check("fused_stack", name, t, shape, device)


def _check_call(lib, config: WaveNetConfig, x: torch.Tensor, w_fg, wd, bd):
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    if not supports(c):
        raise NotImplementedError(
            "fused_stack needs filter_width=2 and max dilation <= "
            f"{_T_TILE_BWD}")
    if not lib.fused_stack_supports_width(R, D):
        raise NotImplementedError(
            f"the fused_stack kernel is built for R == D in (8, 16, 32); "
            f"got R={R}, D={D}")
    dev = x.device
    _check("w_fg", w_fg, (L, 2 * R, 2 * D), dev)
    _check("wd", wd, (L, D, R), dev)
    _check("bd", bd, (L, 1, R), dev)
    return (ctypes.c_int * L)(*c.dilations)


def forward(x, w_fg, wd, add, bd, config: WaveNetConfig):
    """Stack forward -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D]).

    CPU tensors run ``fused_stack_forward_reference``; CUDA tensors launch
    the kernel or raise."""
    if not _launch.use_kernel("fused_stack", x):
        return fused_stack_forward_reference(x, w_fg, wd, add, bd, config)
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = x.shape[:2]
    lib = _lib()
    dil = _check_call(lib, c, x, w_fg, wd, bd)
    _check("x", x, (B, T, R), x.device)
    _check("add", add, (L, B, 2 * D), x.device)
    y = torch.empty_like(x)
    fg = torch.empty((B, T, L * 2 * D), dtype=torch.float32, device=x.device)
    z = torch.empty((B, T, L * D), dtype=torch.float32, device=x.device)
    xbuf = torch.empty((2, B, T, R), dtype=torch.float32, device=x.device)
    err = lib.fused_stack_fwd_f32(
        x.data_ptr(), w_fg.data_ptr(), wd.data_ptr(), add.data_ptr(),
        bd.data_ptr(), ctypes.addressof(dil), y.data_ptr(), fg.data_ptr(),
        z.data_ptr(), xbuf.data_ptr(), B, T, L, R, D, _launch.stream(x.device))
    if err != 0:
        raise RuntimeError(f"fused_stack forward launch failed: CUDA error "
                           f"{err}")
    forward.launches += 1
    return y, fg, z


def backward(y, dy, fg, dz, w_fg, wd, bd, config: WaveNetConfig):
    """Stack VJP -> (dx, dw_fg [L,2R,2D], dwd [L,D,R], dadd [L,B,2D],
    dbd [L,1,R]).

    CPU tensors run ``fused_stack_backward_reference``; CUDA tensors
    launch the kernel or raise. The kernel sums the weight gradients in a
    fixed order (no atomics): repeated calls are bitwise equal."""
    if not _launch.use_kernel("fused_stack", y):
        return fused_stack_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                              config)
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = y.shape[:2]
    lib = _lib()
    dil = _check_call(lib, c, y, w_fg, wd, bd)
    dev = y.device
    for name, t, shape in (("y", y, (B, T, R)), ("dy", dy, (B, T, R)),
                           ("fg", fg, (B, T, L * 2 * D)),
                           ("dz", dz, (B, T, L * D))):
        _check(name, t, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, R), **f32)
    dw_fg = torch.empty((L, 2 * R, 2 * D), **f32)
    dwd = torch.empty((L, D, R), **f32)
    dadd = torch.empty((L, B, 2 * D), **f32)
    dbd = torch.empty((L, 1, R), **f32)
    scratch = torch.empty(
        (lib.fused_stack_bwd_scratch_floats(B, T, L, R, D),), **f32)
    err = lib.fused_stack_bwd_f32(
        y.data_ptr(), dy.data_ptr(), fg.data_ptr(), dz.data_ptr(),
        w_fg.data_ptr(), wd.data_ptr(), bd.data_ptr(), ctypes.addressof(dil),
        dx.data_ptr(), dw_fg.data_ptr(), dwd.data_ptr(), dadd.data_ptr(),
        dbd.data_ptr(), scratch.data_ptr(), B, T, L, R, D, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_stack backward launch failed: CUDA error "
                           f"{err}")
    backward.launches += 1
    return dx, dw_fg, dwd, dadd, dbd


#: Kernel launches made by ``forward`` / ``backward`` (read by chip_smoke.py).
forward.launches = 0
backward.launches = 0


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------

class _FusedStack3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_fg, wd, add, bd, config):
        y, fg, z = forward(x.contiguous(), w_fg.contiguous(),
                           wd.contiguous(), add.contiguous(),
                           bd.contiguous(), config)
        ctx.config = config
        ctx.save_for_backward(y, fg, w_fg, wd, bd)
        return y, z

    @staticmethod
    def backward(ctx, dy, dz):
        y, fg, w_fg, wd, bd = ctx.saved_tensors
        dx, dw_fg, dwd, dadd, dbd = backward(
            y, dy.contiguous(), fg, dz.contiguous(), w_fg.contiguous(),
            wd.contiguous(), bd.contiguous(), ctx.config)
        return dx, dw_fg, dwd, dadd, dbd, None


def fused_stack3(x, w_fg, wd, add, bd, config: WaveNetConfig):
    """Differentiable whole-stack op: (y [B,T,R], z [B,T,L*D])."""
    return _FusedStack3.apply(x, w_fg, wd, add, bd, config)
