"""One gated dilated layer as a differentiable op: plain versions, the CUDA
kernel's wrappers and the op.

Counterpart of ``wavenet_tpu/experiments/dilated_layer.py`` (TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``, custom VJP ``fused_dilated_layer``).
One layer (x [B,T,R], w [2,R,2D], wd [D,R], add [B,2D], bd [1,R]):

    fg = x(t-d) @ w[0] + x(t) @ w[1] + add[b]       (x(t-d) = 0 for t < d)
    z  = tanh(fg_f) * sigmoid(fg_g)
    y  = x + z @ wd + bd

The backward is flash-style, as in JAX: only the inputs are saved, and
the kernel recomputes fg and z. It emits dx_local = dy + da @ w[1]^T and
dpast = da @ w[0]^T; dpast(t + d) lands on dx(t), shift-added in plain
PyTorch by the op (``_shift_left_add``), where the JAX wrapper does it in
XLA. The kernel reads x(t - d) from device memory; the JAX wrapper's
materialised ``past`` tensor exists only because a TPU BlockSpec cannot
express a halo, and the port builds none.

``forward`` and ``backward`` run the kernel (``csrc/dilated_layer.cu``,
3xTF32 on the tensor cores) for CUDA tensors and the plain versions for
CPU tensors; each counts its launches in ``.launches``. The kernel's grid
is ``(nchunk, B)``: each block walks a chunk of consecutive tiles of
``TM`` time steps of one batch row, and ``layer_tiling`` (pure) mirrors
the library's rule for it. The plain versions take ``matmul=``:
``kernels.fused_stack.mma3_matmul`` repeats the kernel's 3xTF32
arithmetic on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.fused_stack import _contract_rows

_OP = "dilated_layer"

__all__ = ["fused_dilated_layer", "fused_dilated_layer_reference",
           "fused_dilated_layer_backward_reference", "forward", "backward",
           "TM", "LayerTiling", "layer_tiling", "device_layer_tiling"]

#: Time steps of one batch row in a tile of the kernel.
TM = 128


def _shift_right(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[t] -> x[t-d] with zero fill (the dilated 'past' tap)."""
    return F.pad(x, (0, 0, d, 0))[:, :x.shape[1]]


def _shift_left_add(base: torch.Tensor, contrib: torch.Tensor,
                    d: int) -> torch.Tensor:
    """base[t] += contrib[t + d] (the tap-0 gradient landing at t - d)."""
    return base + F.pad(contrib[:, d:], (0, 0, 0, min(d, base.shape[1])))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_dilated_layer_reference(x, w, wd, add, bd, dilation: int,
                                  matmul=torch.matmul):
    """Plain forward -> (y [B,T,R], z [B,T,D]); every product through
    ``matmul``."""
    R, D = x.shape[-1], wd.shape[0]
    cat = torch.cat([_shift_right(x, dilation), x], dim=-1)
    fg = matmul(cat, w.reshape(2 * R, 2 * D)) + add[:, None, :]
    z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
    return x + (matmul(z, wd) + bd[0]), z


@torch.no_grad()
def fused_dilated_layer_backward_reference(x, w, wd, add, dy, dz,
                                           dilation: int,
                                           matmul=torch.matmul):
    """Plain backward, recomputing fg and z from the inputs -> (dx_local
    [B,T,R], dpast [B,T,R], dw [2,R,2D], dwd [D,R], dadd [B,2D], dbd
    [1,R]); every product through ``matmul``."""
    R, D = x.shape[-1], wd.shape[0]
    past = _shift_right(x, dilation)
    fg = matmul(torch.cat([past, x], dim=-1), w.reshape(2 * R, 2 * D)) \
        + add[:, None, :]
    t_ = torch.tanh(fg[..., :D])
    s_ = torch.sigmoid(fg[..., D:])
    dzt = dz + matmul(dy, wd.T)
    da = torch.cat([dzt * s_ * (1.0 - t_ * t_),
                    dzt * t_ * s_ * (1.0 - s_)], dim=-1)
    dw = torch.stack([_contract_rows(past, da, matmul),
                      _contract_rows(x, da, matmul)])
    return (dy + matmul(da, w[1].T), matmul(da, w[0].T), dw,
            _contract_rows(t_ * s_, dy, matmul), da.sum(dim=1),
            dy.sum(dim=(0, 1))[None])


# ---------------------------------------------------------------------------
# The kernel's grid
# ---------------------------------------------------------------------------

class LayerTiling(NamedTuple):
    """A direction's grid ``(nchunk, B)``: block c of row b walks that
    row's tiles ``c * tiles_per_chunk`` up to the next chunk's (the last
    chunk may hold fewer)."""
    nchunk: int
    tiles_per_chunk: int


def layer_tiling(B: int, T: int, resident_blocks: int) -> LayerTiling:
    """The kernel's grid for B rows of T steps on a card that keeps
    ``resident_blocks`` blocks of the direction's kernel resident at once
    (pure; the library's ``dilated_layer_nchunk`` applies the same rule,
    ``csrc/stack_common.cuh`` ``chunk_tiling``). Each row's ceil(T / TM)
    tiles are cut into chunks of consecutive tiles, about
    max(1, resident_blocks // B) of them, so that the whole grid runs in
    one wave and each block keeps its split weights for all its tiles."""
    if B < 1 or T < 1 or resident_blocks < 1:
        raise ValueError(f"layer_tiling: B={B}, T={T}, resident_blocks="
                         f"{resident_blocks}")
    ntiles = -(-T // TM)
    target = max(1, resident_blocks // B)
    tpc = -(-ntiles // target)
    return LayerTiling(-(-ntiles // tpc), tpc)


def device_layer_tiling(backward: bool, B: int, T: int, R: int,
                        D: int) -> Tuple[int, LayerTiling]:
    """(resident blocks, grid) of a direction's kernel on the current card,
    from the library's resident count."""
    n = _lib().dilated_layer_resident_blocks(int(backward), R, D)
    if n < 1:
        raise RuntimeError(f"dilated_layer_resident_blocks failed: {n}")
    return n, layer_tiling(B, T, n)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    """The kernel's library, built and bound at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from wavenet_torch.kernels import _build
    lib = _build.load("dilated_layer")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dilated_layer_supports_width.argtypes = [i, i]
    lib.dilated_layer_supports_width.restype = i
    lib.dilated_layer_resident_blocks.argtypes = [i] * 3
    lib.dilated_layer_resident_blocks.restype = i
    lib.dilated_layer_nchunk.argtypes = [i] * 5
    lib.dilated_layer_nchunk.restype = i
    lib.dilated_layer_bwd_scratch_floats.argtypes = [i] * 4
    lib.dilated_layer_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.dilated_layer_fwd_f32.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.dilated_layer_fwd_f32.restype = i
    lib.dilated_layer_bwd_f32.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.dilated_layer_bwd_f32.restype = i
    _LIB = lib
    return lib


def _check_call(lib, x, w, wd, add, dilation: int):
    """Check the layer's inputs -> (B, T, R, D)."""
    B, T, R = x.shape
    D = wd.shape[0]
    if dilation < 1:
        raise ValueError(f"{_OP}: dilation must be >= 1, got {dilation}")
    if not lib.dilated_layer_supports_width(R, D):
        raise NotImplementedError(
            f"the dilated_layer kernel is built for R == D in (8, 16, 32); "
            f"got R={R}, D={D}")
    if T < 1:
        raise ValueError(f"{_OP}: x has no time steps")
    dev = x.device
    _launch.check(_OP, "x", x, (B, T, R), dev)
    _launch.check(_OP, "w", w, (2, R, 2 * D), dev)
    _launch.check(_OP, "wd", wd, (D, R), dev)
    _launch.check(_OP, "add", add, (B, 2 * D), dev)
    _check_aligned(x=x, w=w, wd=wd)
    return B, T, R, D


def _check_aligned(**tensors):
    """The kernel reads these by 16-byte cp.async (dz by 8-byte loads):
    raise unless each starts on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{_OP}: {name} must start on a 16-byte "
                             "boundary")


def forward(x, w, wd, add, bd, dilation: int):
    """Layer forward -> (y [B,T,R], z [B,T,D]).

    CPU tensors run ``fused_dilated_layer_reference``; CUDA tensors launch
    the kernel or raise."""
    if not _launch.use_kernel(_OP, x):
        with torch.no_grad():
            return fused_dilated_layer_reference(x, w, wd, add, bd, dilation)
    lib = _lib()
    B, T, R, D = _check_call(lib, x, w, wd, add, dilation)
    _launch.check(_OP, "bd", bd, (1, R), x.device)
    y = torch.empty_like(x)
    z = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    err = lib.dilated_layer_fwd_f32(
        x.data_ptr(), w.data_ptr(), wd.data_ptr(), add.data_ptr(),
        bd.data_ptr(), y.data_ptr(), z.data_ptr(), B, T, R, D, dilation,
        _launch.stream(x.device))
    if err != 0:
        raise RuntimeError(f"dilated_layer forward launch failed: CUDA error "
                           f"{err}")
    forward.launches += 1
    return y, z


def backward(x, w, wd, add, dy, dz, dilation: int):
    """Layer VJP from the saved inputs -> (dx_local, dpast, dw [2,R,2D],
    dwd [D,R], dadd [B,2D], dbd [1,R]).

    CPU tensors run ``fused_dilated_layer_backward_reference``; CUDA
    tensors launch the kernel or raise. The kernel sums the weight
    gradients in a fixed order: repeated calls are bitwise equal."""
    if not _launch.use_kernel(_OP, x):
        return fused_dilated_layer_backward_reference(x, w, wd, add, dy, dz,
                                                      dilation)
    lib = _lib()
    B, T, R, D = _check_call(lib, x, w, wd, add, dilation)
    dev = x.device
    _launch.check(_OP, "dy", dy, (B, T, R), dev)
    _launch.check(_OP, "dz", dz, (B, T, D), dev)
    _check_aligned(dy=dy, dz=dz)
    f32 = dict(dtype=torch.float32, device=dev)
    dx_local = torch.empty((B, T, R), **f32)
    dpast = torch.empty((B, T, R), **f32)
    dw = torch.empty((2, R, 2 * D), **f32)
    dwd = torch.empty((D, R), **f32)
    dadd = torch.empty((B, 2 * D), **f32)
    dbd = torch.empty((1, R), **f32)
    n_scratch = lib.dilated_layer_bwd_scratch_floats(B, T, R, D)
    if n_scratch < 0:
        raise RuntimeError(f"dilated_layer backward: scratch size failed: "
                           f"CUDA error {-n_scratch}")
    scratch = torch.empty((n_scratch,), **f32)
    err = lib.dilated_layer_bwd_f32(
        x.data_ptr(), w.data_ptr(), wd.data_ptr(), add.data_ptr(),
        dy.data_ptr(), dz.data_ptr(), dx_local.data_ptr(), dpast.data_ptr(),
        dw.data_ptr(), dwd.data_ptr(), dadd.data_ptr(), dbd.data_ptr(),
        scratch.data_ptr(), B, T, R, D, dilation, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"dilated_layer backward launch failed: CUDA error "
                           f"{err}")
    backward.launches += 1
    return dx_local, dpast, dw, dwd, dadd, dbd


#: Kernel launches made by ``forward`` / ``backward`` (read by chip_smoke.py).
forward.launches = 0
backward.launches = 0


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------

class _FusedDilatedLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, wd, add, bd, dilation):
        args = (x.contiguous(), w.contiguous(), wd.contiguous(),
                add.contiguous(), bd.contiguous())
        ctx.dilation = dilation
        ctx.save_for_backward(*args[:4])
        return forward(*args, dilation)

    @staticmethod
    def backward(ctx, dy, dz):
        x, w, wd, add = ctx.saved_tensors
        dx_local, dpast, dw, dwd, dadd, dbd = backward(
            x, w, wd, add, dy.contiguous(), dz.contiguous(), ctx.dilation)
        dx = _shift_left_add(dx_local, dpast, ctx.dilation)
        return dx, dw, dwd, dadd, dbd, None


def fused_dilated_layer(x, w, wd, add, bd, dilation: int,
                        compute_dtype=torch.float32):
    """(y [B,T,R], z [B,T,D]) for one gated dilated layer; differentiable
    in x, w, wd, add and bd. float32 only: bf16 operands are ROADMAP.md
    queue item 1."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"fused_dilated_layer runs float32 only; compute_dtype="
            f"{compute_dtype} is queued in ROADMAP.md (queue item 1, bf16: "
            "queue 2, a3)")
    return _FusedDilatedLayer.apply(x, w, wd, add, bd, dilation)
