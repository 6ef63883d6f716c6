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

``forward`` and ``backward`` run a CUDA kernel for CUDA tensors and the
plain versions for CPU tensors. JAX's op takes every width, and so does
the port, by width (``layer_kernel_plan``, pure): ``csrc/dilated_layer.cu``
("layer", 3xTF32 on the tensor cores, every weight resident in shared
memory) at R == D in 8, 16, 32, and the layer entries of
``csrc/fused_stack_tiled.cu`` ("tiled": kernel 5's tiled products, the
weights streamed through shared memory, ragged edges masked) at every
other width. Each wrapper counts its launches in ``.launches``, and by
kernel and mode ("f32", "bf16" for the layer kernel; "tiled_f32", "tiled_bf16")
in ``.launches_by``.

At ``compute_dtype=torch.bfloat16`` (the JAX op's ``compute_dtype=
jnp.bfloat16``) the layer rounds where the JAX wrapper and TPU kernels do:
x itself (so the residual too: y = (bf16(x) + bf16(z) @ wd) + bd), w and
wd before the products, z before z @ wd; the backward rounds dy and dz on
entry (dbd sums the rounded dy, dx_local = bf16(dy) + da @ w[1]^T) and da
before each product, and sums dadd from the float32 da. Products
accumulate in float32, and y, z and every gradient are float32. The
kernel's bf16 mode runs one bf16 ``mma.sync`` pass a product. The kernel's grid
is ``(nchunk, B)``: each block walks a chunk of consecutive tiles of
``TM`` time steps of one batch row, and ``layer_tiling`` (pure) mirrors
the library's rule for it. The plain versions take ``matmul=``:
``kernels.fused_stack.mma3_matmul`` repeats the kernel's 3xTF32
arithmetic on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.fused_stack import _contract_rows, _rounding

_OP = "dilated_layer"

__all__ = ["fused_dilated_layer", "fused_dilated_layer_reference",
           "fused_dilated_layer_backward_reference", "forward", "backward",
           "layer_kernel_plan", "LAYER_WIDTHS",
           "TM", "LayerTiling", "layer_tiling", "device_layer_tiling"]

#: Time steps of one batch row in a tile of the layer kernel.
TM = 128
#: The widths (R == D) ``csrc/dilated_layer.cu`` is built for
#: (``dilated_layer_supports_width``).
LAYER_WIDTHS = (8, 16, 32)
#: The compute dtypes of the layer, by their ``launches_by`` key.
MODES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _mode(compute_dtype) -> str:
    try:
        return MODES[compute_dtype]
    except KeyError:
        raise ValueError(f"{_OP}: compute_dtype {compute_dtype}: one of "
                         f"{tuple(MODES)}") from None


def layer_kernel_plan(R: int, D: int) -> str:
    """The kernel that runs a layer of widths R, D on the card: "layer"
    at R == D in ``LAYER_WIDTHS``, "tiled" at every other width."""
    return "layer" if R == D and R in LAYER_WIDTHS else "tiled"


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
                                  matmul=torch.matmul,
                                  compute_dtype=torch.float32):
    """Plain forward -> (y [B,T,R], z [B,T,D]); every product through
    ``matmul``, its operands rounded as ``compute_dtype`` says."""
    R, D = x.shape[-1], wd.shape[0]
    bf16 = _mode(compute_dtype) == "bf16"
    rnd = _rounding(compute_dtype)
    x, w, wd = rnd(x), rnd(w), rnd(wd)
    cat = torch.cat([_shift_right(x, dilation), x], dim=-1)
    fg = matmul(cat, w.reshape(2 * R, 2 * D)) + add[:, None, :]
    z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
    if bf16:   # the TPU kernel's order
        return (x + matmul(rnd(z), wd)) + bd[0], z
    return x + (matmul(z, wd) + bd[0]), z


@torch.no_grad()
def fused_dilated_layer_backward_reference(x, w, wd, add, dy, dz,
                                           dilation: int,
                                           matmul=torch.matmul,
                                           compute_dtype=torch.float32):
    """Plain backward, recomputing fg and z from the inputs -> (dx_local
    [B,T,R], dpast [B,T,R], dw [2,R,2D], dwd [D,R], dadd [B,2D], dbd
    [1,R]); every product through ``matmul``, its operands rounded as
    ``compute_dtype`` says (dy and dz on entry)."""
    R, D = x.shape[-1], wd.shape[0]
    _mode(compute_dtype)
    rnd = _rounding(compute_dtype)
    x, w, wd, dy, dz = rnd(x), rnd(w), rnd(wd), rnd(dy), rnd(dz)
    past = _shift_right(x, dilation)
    fg = matmul(torch.cat([past, x], dim=-1), w.reshape(2 * R, 2 * D)) \
        + add[:, None, :]
    t_ = torch.tanh(fg[..., :D])
    s_ = torch.sigmoid(fg[..., D:])
    dzt = dz + matmul(dy, wd.T)
    da = torch.cat([dzt * s_ * (1.0 - t_ * t_),
                    dzt * t_ * s_ * (1.0 - s_)], dim=-1)
    da_r = rnd(da)
    dw = torch.stack([_contract_rows(past, da_r, matmul),
                      _contract_rows(x, da_r, matmul)])
    return (dy + matmul(da_r, w[1].T), matmul(da_r, w[0].T), dw,
            _contract_rows(rnd(t_ * s_), dy, matmul), da.sum(dim=1),
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


def device_layer_tiling(backward: bool, B: int, T: int, R: int, D: int,
                        compute_dtype=torch.float32
                        ) -> Tuple[int, LayerTiling]:
    """(resident blocks, grid) of a direction's kernel in a mode on the
    current card, from the library's resident count."""
    n = _lib().dilated_layer_resident_blocks(
        int(backward), R, D, int(_mode(compute_dtype) == "bf16"))
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
    lib.dilated_layer_resident_blocks.argtypes = [i] * 4
    lib.dilated_layer_resident_blocks.restype = i
    lib.dilated_layer_nchunk.argtypes = [i] * 6
    lib.dilated_layer_nchunk.restype = i
    lib.dilated_layer_bwd_scratch_floats.argtypes = [i] * 5
    lib.dilated_layer_bwd_scratch_floats.restype = ctypes.c_longlong
    for mode in MODES.values():
        fwd = getattr(lib, f"dilated_layer_fwd_{mode}")
        fwd.argtypes = [p] * 7 + [i] * 5 + [p]
        fwd.restype = i
        bwd = getattr(lib, f"dilated_layer_bwd_{mode}")
        bwd.argtypes = [p] * 13 + [i] * 5 + [p]
        bwd.restype = i
    _LIB = lib
    return lib


_TILED = None


def _tiled_lib():
    """``fused_stack_tiled``'s library with its layer entries bound."""
    global _TILED
    if _TILED is not None:
        return _TILED
    from wavenet_torch.kernels import _build
    lib = _build.load("fused_stack_tiled")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_stack_tiled_layer_scratch_floats.argtypes = [i] * 6
    lib.fused_stack_tiled_layer_scratch_floats.restype = ctypes.c_longlong
    for mode in MODES.values():
        fwd = getattr(lib, f"fused_stack_tiled_layer_fwd_{mode}")
        fwd.argtypes = [p] * 8 + [i] * 5 + [p]
        fwd.restype = i
        bwd = getattr(lib, f"fused_stack_tiled_layer_bwd_{mode}")
        bwd.argtypes = [p] * 13 + [i] * 5 + [p]
        bwd.restype = i
    _TILED = lib
    return lib


def _route(x, wd):
    """(kernel run, its library) for this call."""
    used = layer_kernel_plan(x.shape[-1], wd.shape[0])
    return used, _tiled_lib() if used == "tiled" else _lib()


def _check_call(x, w, wd, add, dilation: int):
    """Check the layer's inputs -> (B, T, R, D)."""
    B, T, R = x.shape
    D = wd.shape[0]
    if dilation < 1:
        raise ValueError(f"{_OP}: dilation must be >= 1, got {dilation}")
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


def _key(used: str, mode: str) -> str:
    return mode if used == "layer" else f"{used}_{mode}"


def _tiled_scratch(lib, backward: bool, mode: str, B, T, R, D, device):
    n = lib.fused_stack_tiled_layer_scratch_floats(
        int(backward), int(mode == "bf16"), B, T, R, D)
    if n < 0:
        raise RuntimeError(f"fused_stack_tiled layer scratch: width R={R}, "
                           f"D={D} refused")
    return torch.empty((n,), dtype=torch.float32, device=device)


def forward(x, w, wd, add, bd, dilation: int, compute_dtype=torch.float32):
    """Layer forward -> (y [B,T,R], z [B,T,D]), float32, every input
    float32 (rounded in the kernel at bf16).

    CPU tensors run ``fused_dilated_layer_reference``; CUDA tensors launch
    the mode of ``compute_dtype`` of the kernel that ``layer_kernel_plan``
    names, or raise."""
    mode = _mode(compute_dtype)
    if not _launch.use_kernel(_OP, x):
        with torch.no_grad():
            return fused_dilated_layer_reference(
                x, w, wd, add, bd, dilation, compute_dtype=compute_dtype)
    used, lib = _route(x, wd)
    B, T, R, D = _check_call(x, w, wd, add, dilation)
    _launch.check(_OP, "bd", bd, (1, R), x.device)
    y = torch.empty_like(x)
    z = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), wd.data_ptr(), add.data_ptr(),
            bd.data_ptr(), y.data_ptr(), z.data_ptr())
    if used == "tiled":
        scratch = _tiled_scratch(lib, False, mode, B, T, R, D, x.device)
        err = getattr(lib, f"fused_stack_tiled_layer_fwd_{mode}")(
            *ptrs, scratch.data_ptr(), B, T, R, D, dilation,
            _launch.stream(x.device))
    else:
        err = getattr(lib, f"dilated_layer_fwd_{mode}")(
            *ptrs, B, T, R, D, dilation, _launch.stream(x.device))
    if err != 0:
        raise RuntimeError(f"{_OP} forward ({used}, {mode}) launch failed: "
                           f"CUDA error {err}")
    forward.launches += 1
    forward.launches_by[_key(used, mode)] += 1
    return y, z


def backward(x, w, wd, add, dy, dz, dilation: int,
             compute_dtype=torch.float32):
    """Layer VJP from the saved inputs -> (dx_local, dpast, dw [2,R,2D],
    dwd [D,R], dadd [B,2D], dbd [1,R]), float32 (dy and dz rounded in the
    kernel at bf16).

    CPU tensors run ``fused_dilated_layer_backward_reference``; CUDA
    tensors launch the routed kernel's mode of ``compute_dtype``, as
    ``forward`` does, or raise. Both kernels sum the weight gradients in a
    fixed order: repeated calls are bitwise equal."""
    mode = _mode(compute_dtype)
    if not _launch.use_kernel(_OP, x):
        return fused_dilated_layer_backward_reference(
            x, w, wd, add, dy, dz, dilation, compute_dtype=compute_dtype)
    used, lib = _route(x, wd)
    B, T, R, D = _check_call(x, w, wd, add, dilation)
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
    if used == "tiled":
        scratch = _tiled_scratch(lib, True, mode, B, T, R, D, dev)
        fn = getattr(lib, f"fused_stack_tiled_layer_bwd_{mode}")
    else:
        n_scratch = lib.dilated_layer_bwd_scratch_floats(
            B, T, R, D, int(mode == "bf16"))
        if n_scratch < 0:
            raise RuntimeError(f"dilated_layer backward: scratch size "
                               f"failed: CUDA error {-n_scratch}")
        scratch = torch.empty((n_scratch,), **f32)
        fn = getattr(lib, f"dilated_layer_bwd_{mode}")
    err = fn(
        x.data_ptr(), w.data_ptr(), wd.data_ptr(), add.data_ptr(),
        dy.data_ptr(), dz.data_ptr(), dx_local.data_ptr(), dpast.data_ptr(),
        dw.data_ptr(), dwd.data_ptr(), dadd.data_ptr(), dbd.data_ptr(),
        scratch.data_ptr(), B, T, R, D, dilation, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"{_OP} backward ({used}, {mode}) launch failed: "
                           f"CUDA error {err}")
    backward.launches += 1
    backward.launches_by[_key(used, mode)] += 1
    return dx_local, dpast, dw, dwd, dadd, dbd


#: Kernel launches made by ``forward`` / ``backward`` (read by chip_smoke.py),
#: in all and by kernel and mode ("f32", "bf16", "tiled_f32",
#: "tiled_bf16").
forward.launches = 0
backward.launches = 0
forward.launches_by = collections.Counter()
backward.launches_by = collections.Counter()


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------

class _FusedDilatedLayer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, wd, add, bd, dilation, compute_dtype):
        args = (x.contiguous(), w.contiguous(), wd.contiguous(),
                add.contiguous(), bd.contiguous())
        ctx.dilation, ctx.compute_dtype = dilation, compute_dtype
        ctx.save_for_backward(*args[:4])
        return forward(*args, dilation, compute_dtype)

    @staticmethod
    def backward(ctx, dy, dz):
        x, w, wd, add = ctx.saved_tensors
        dx_local, dpast, dw, dwd, dadd, dbd = backward(
            x, w, wd, add, dy.contiguous(), dz.contiguous(), ctx.dilation,
            ctx.compute_dtype)
        dx = _shift_left_add(dx_local, dpast, ctx.dilation)
        return dx, dw, dwd, dadd, dbd, None, None


def fused_dilated_layer(x, w, wd, add, bd, dilation: int,
                        compute_dtype=torch.float32):
    """(y [B,T,R], z [B,T,D]) for one gated dilated layer, float32;
    differentiable in x, w, wd, add and bd. ``compute_dtype`` (float32 or
    bfloat16) is the JAX op's: the operands' type."""
    _mode(compute_dtype)
    return _FusedDilatedLayer.apply(x, w, wd, add, bd, dilation,
                                    compute_dtype)
