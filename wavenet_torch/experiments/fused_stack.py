"""Whole-stack training kernel, generation v1: plain versions, the CUDA
kernel's wrappers and the differentiable op.

Counterpart of ``wavenet_tpu/experiments/fused_stack.py`` (TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``, custom VJP ``fused_stack``), reached
with ``use_pallas_stack`` and ``pallas_stack_version`` 1 (or any version
but 2 and 3). It computes the map of ``kernels/fused_stack.py``; the
forward emits y and the gate preactivations fg, and z = tanh(fg_f) *
sigmoid(fg_g) is computed from fg outside the kernel (``_fg_to_z``), as
in JAX. The backward takes dz and is recompute-free.

``fused_stack_forward`` and ``fused_stack_backward`` run a CUDA kernel
for CUDA tensors and the plain versions for CPU tensors. JAX's v1 takes
every width (its ``supports`` checks only the filter width and the
largest dilation), and so does the port, by width (``v1_kernel_plan``,
pure): the carry kernel (``csrc/fused_stack_carry.cu``, shared with v2:
``carry_forward``, ``carry_backward``; a wavefront across time tiles on a
grid (nchunk, B) that ``carry_plan`` sizes from the blocks the card keeps
resident) where it is built (R == D in 8, 16, 32 and at most 256 layers),
and kernel 5's kernels elsewhere, as ``kernels/fused_stack.py`` routes
its widths: ``fused_stack_mma.cu`` at R == D == 64 (and 32 beyond 256
layers), ``fused_stack.cu`` at R == D in 8, 16 beyond 256 layers, and
``fused_stack_tiled.cu``'s v1 entries at every other width, including
the D its TPU records cannot pack (e.g. 48, 3): the same products, with
no z record. ``kernel="carry"`` or ``"stack"`` pins one of the two and
raises at a width it lacks. Each wrapper counts its launches in
``.launches`` and by kernel and mode in ``.launches_by`` ("carry",
"carry_bf16", "v1_mma", "v1_simt", "v1_tiled" and their "_bf16" forms).

At ``compute_dtype="bfloat16"`` the stack rounds where the TPU kernels do
at ``kernel_dtype = bfloat16`` (``kernels/fused_stack.py``'s plain versions
and the carry kernel's bf16 mode): bf16 weights and product operands,
float32 accumulation and residual, added as ``(x + z @ wd) + bd``, and a
bf16 fg record. v1's op then returns z in float32, computed outside the
kernel from the bf16 fg record (JAX's ``_fg_to_z``); v2's returns the
kernel's bf16 z record, computed from the float32 fg. Both backwards read
dz in bf16.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

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
           "carry_backward", "CarryPlan", "carry_plan", "device_carry_plan",
           "carry_supports", "v1_kernel_plan",
           "carry_scratch_floats", "carry_key", "CARRY_TILE",
           "pack_stack_weights", "tap_offsets"]

#: Time steps of one tile of the carry kernel (csrc/fused_stack_carry.cu).
CARRY_TILE = 128
#: The carry kernel's shapes (``fused_stack_carry_supports`` in its
#: source): R == D in ``CARRY_WIDTHS``, 1..``CARRY_MAX_LAYERS`` layers.
CARRY_WIDTHS = (8, 16, 32)
CARRY_MAX_LAYERS = 256
#: ``kernel=`` values of v1's wrappers and op.
KERNEL_CHOICES = ("auto", "carry", "stack")


def supports(config: WaveNetConfig, t_tile: int = _T_TILE) -> bool:
    """Mirror of the JAX kernel's ``supports``: filter_width 2 and max
    dilation <= the tile."""
    return config.filter_width == 2 and max(config.dilations) <= t_tile


def carry_supports(config: WaveNetConfig) -> bool:
    """Whether the carry kernel is built for the config's shape (the
    library's ``fused_stack_carry_supports``, which it asks again)."""
    c = config
    return (c.residual_channels == c.dilation_channels
            and c.residual_channels in CARRY_WIDTHS
            and 1 <= c.num_layers <= CARRY_MAX_LAYERS)


def _stack_kernel(config: WaveNetConfig) -> str:
    """The kernel 5 kernel that runs v1 at the config's width: "mma" or
    "simt" where kernel 5's route takes them, "tiled" (its v1 entries, at
    every width) elsewhere."""
    R, D = config.residual_channels, config.dilation_channels
    if R == D and R in _stack.MMA_WIDTHS:
        return "mma"
    if R == D and R in _stack.SIMT_WIDTHS:
        return "simt"
    return "tiled"


def v1_kernel_plan(config: WaveNetConfig, kernel: str = "auto") -> str:
    """The kernel that runs a v1 stack of ``config`` on the card: "carry"
    where ``carry_supports`` holds, else the kernel 5 kernel of
    ``_stack_kernel`` ("mma", "simt" or "tiled"). ``kernel`` "carry" or
    "stack" pins one side (the carry kernel raises at launch at a shape
    it lacks)."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"fused_stack v1: kernel={kernel!r}: one of "
                         f"{KERNEL_CHOICES}")
    _stack.record_dtype(config)    # raises at a compute dtype it lacks
    if kernel == "carry" or (kernel == "auto" and carry_supports(config)):
        return "carry"
    return _stack_kernel(config)


def _dw_split(dw_fg: torch.Tensor, config: WaveNetConfig) -> torch.Tensor:
    """dw_fg [L, 2R, 2D] as the JAX backward's [L, 2, R, 2D] (a view)."""
    c = config
    return dw_fg.view(c.num_layers, 2, c.residual_channels,
                      2 * c.dilation_channels)


def _fg_to_z(fg: torch.Tensor, config: WaveNetConfig) -> torch.Tensor:
    """z [B, T, L*D] from the preactivations fg [B, T, L*2D], in fg's
    dtype (v1's op passes a bf16 record widened to float32, as JAX's
    ``_fg_to_z`` computes)."""
    L, D = config.num_layers, config.dilation_channels
    B, T = fg.shape[:2]
    f = fg.view(B, T, L, 2 * D)
    return (torch.tanh(f[..., :D])
            * torch.sigmoid(f[..., D:])).reshape(B, T, L * D)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                  config: WaveNetConfig, matmul=torch.matmul):
    """Plain forward -> (y [B,T,R], fg [B,T,L*2D]); every product through
    ``matmul`` (``kernels.fused_stack.mma3_matmul`` repeats the carry
    kernel's 3xTF32 arithmetic)."""
    y, fg, _ = _stack.fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                                    config, matmul=matmul)
    return y, fg


def fused_stack_backward_reference(y, fg, dz, dy, w_fg, wd, bd,
                                   config: WaveNetConfig,
                                   matmul=torch.matmul):
    """Plain backward (an explicit reverse sweep that rebuilds each
    layer's input by subtraction; every product through ``matmul``) ->
    (dx, dw [L,2,R,2D], dwd [L,D,R], dadd [L,B,2D], dbd [L,1,R])."""
    dx, dw_fg, dwd, dadd, dbd = _stack.fused_stack_backward_reference(
        y, dy, fg, dz, w_fg, wd, bd, config, matmul=matmul)
    return dx, _dw_split(dw_fg, config), dwd, dadd, dbd


# ---------------------------------------------------------------------------
# The carry kernel, shared with v2
# ---------------------------------------------------------------------------

_OP = "fused_stack_carry"


class CarryPlan(NamedTuple):
    """A carry launch's grid: ``nchunk`` blocks a batch row, grid
    ``(nchunk, B)``. Block ``c`` of a row takes the row's tiles ``j = c,
    c + nchunk, ...`` of its walk (the backward's walk runs from the last
    tile)."""
    nchunk: int
    grid: Tuple[int, int]

    def tiles(self, chunk: int, ntiles: int):
        """The walk's tiles that block ``chunk`` of a row takes, in
        order."""
        return range(chunk, ntiles, self.nchunk)


def carry_plan(B: int, resident_blocks: int) -> CarryPlan:
    """The carry kernel's grid for B rows on a card that keeps
    ``resident_blocks`` blocks of the kernel resident at once (pure; the
    library's ``fused_stack_carry_nchunk`` applies the same rule). Each
    row gets ``max(1, resident_blocks // B)`` blocks, so that where there
    are several they all fit at once (a block waits on the block of the
    tile before its own); where B alone fills the card, one block a row
    walks all its tiles."""
    if B < 1 or resident_blocks < 1:
        raise ValueError(f"carry_plan: B={B}, resident_blocks="
                         f"{resident_blocks}")
    nchunk = max(1, resident_blocks // B)
    return CarryPlan(nchunk, (nchunk, B))


def carry_scratch_floats(backward: bool, B: int, L: int, R: int, D: int,
                         sum_d: int, nchunk: int) -> int:
    """Floats of scratch device memory one carry launch takes (the
    library's ``fused_stack_carry_scratch_floats``, which a test on the
    card holds this against): the progress counters [B, L] (padded to 4
    floats), each row's rings (``sum_d`` rows of x, R wide, forward; of
    da, 2D wide, backward) and, backward, one partial sum of dw_fg, dwd,
    dbd and dadd per (layer, row, chunk)."""
    n = -(-B * L // 4) * 4
    if not backward:
        return n + B * sum_d * R
    return (n + B * sum_d * 2 * D
            + L * B * nchunk * (4 * R * D + D * R + R + 2 * D))


def _lib():
    from wavenet_torch.kernels import _build
    lib = _build.load("fused_stack_carry")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_stack_carry_supports.argtypes = [i, i, i]
    lib.fused_stack_carry_supports.restype = i
    lib.fused_stack_carry_resident_blocks.argtypes = [i] * 4
    lib.fused_stack_carry_resident_blocks.restype = i
    lib.fused_stack_carry_nchunk.argtypes = [i] * 5
    lib.fused_stack_carry_nchunk.restype = i
    lib.fused_stack_carry_scratch_floats.argtypes = [i] * 7
    lib.fused_stack_carry_scratch_floats.restype = ctypes.c_longlong
    for mode in ("f32", "bf16"):
        getattr(lib, f"fused_stack_carry_fwd_{mode}").argtypes = (
            [p] * 10 + [i] * 6 + [p])
        getattr(lib, f"fused_stack_carry_fwd_{mode}").restype = i
        getattr(lib, f"fused_stack_carry_bwd_{mode}").argtypes = (
            [p] * 14 + [i] * 6 + [p])
        getattr(lib, f"fused_stack_carry_bwd_{mode}").restype = i
    return lib


def _bf16(config: WaveNetConfig) -> bool:
    return _stack.record_dtype(config) == torch.bfloat16


def carry_key(config: WaveNetConfig) -> str:
    """The ``launches_by`` key of a carry launch for ``config``: "carry",
    or "carry_bf16" for the bf16 mode."""
    return "carry_bf16" if _bf16(config) else "carry"


_RESIDENT = {}   # (device, backward, R, D, bf16) -> resident blocks


def device_carry_plan(config: WaveNetConfig, B: int, backward: bool):
    """(resident blocks, plan) of a direction's kernel in the config's
    mode on the current card at the config's width (builds the kernel).
    The bf16 mode's smaller weight fragments may keep more blocks
    resident, so each mode has its own plan."""
    R, D = config.residual_channels, config.dilation_channels
    bf16 = _bf16(config)
    key = (torch.cuda.current_device(), bool(backward), R, D, bf16)
    if key not in _RESIDENT:
        n = _lib().fused_stack_carry_resident_blocks(int(backward), R, D,
                                                     int(bf16))
        if n < 1:
            raise RuntimeError(f"fused_stack_carry: no resident block at "
                               f"R={R}, D={D}, bf16={bf16} (code {n})")
        _RESIDENT[key] = n
    return _RESIDENT[key], carry_plan(B, _RESIDENT[key])


def _check_call(lib, config: WaveNetConfig, lead: torch.Tensor, w_fg, wd,
                bd):
    """Check the config and weights; the dilations as a C array."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    if c.filter_width != 2:
        raise NotImplementedError("fused_stack_carry needs filter_width=2")
    if not lib.fused_stack_carry_supports(R, D, L):
        raise NotImplementedError(
            "the fused_stack_carry kernel is built for R == D in (8, 16, 32) "
            f"and 1..256 layers; got R={R}, D={D}, L={L} (v1's route, "
            "kernel=\"auto\", runs every other width on kernel 5's "
            "kernels; v2 has no other)")
    dev = lead.device
    _launch.check(_OP, "w_fg", w_fg, (L, 2 * R, 2 * D), dev)
    _launch.check(_OP, "wd", wd, (L, D, R), dev)
    _launch.check(_OP, "bd", bd, (L, 1, R), dev)
    return (ctypes.c_int * L)(*c.dilations)


def carry_forward(x, w_fg, wd, add, bd, config: WaveNetConfig,
                  emit_z: bool, _plan: Optional[CarryPlan] = None):
    """One launch of the carry kernel's forward on CUDA tensors -> (y, fg,
    z or None): z [B,T,L*D] only when ``emit_z`` (v2); fg and z in the
    record dtype (bf16 at bf16, the kernel's bf16 mode). ``_plan`` pins
    the grid (tests); by default ``device_carry_plan``'s."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = x.shape[:2]
    lib = _lib()
    dil = _check_call(lib, c, x, w_fg, wd, bd)
    plan = _plan or device_carry_plan(c, B, backward=False)[1]
    dev = x.device
    _launch.check(_OP, "x", x, (B, T, R), dev)
    _launch.check(_OP, "add", add, (L, B, 2 * D), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    rec = dict(dtype=_stack.record_dtype(c), device=dev)
    y = torch.empty((B, T, R), **f32)
    fg = torch.empty((B, T, L * 2 * D), **rec)
    z = torch.empty((B, T, L * D), **rec) if emit_z else None
    scratch = torch.empty((carry_scratch_floats(
        False, B, L, R, D, sum(c.dilations), plan.nchunk),), **f32)
    fn = getattr(lib, "fused_stack_carry_fwd_"
                 + ("bf16" if _bf16(c) else "f32"))
    err = fn(
        x.data_ptr(), w_fg.data_ptr(), wd.data_ptr(), add.data_ptr(),
        bd.data_ptr(), ctypes.addressof(dil), y.data_ptr(), fg.data_ptr(),
        None if z is None else z.data_ptr(), scratch.data_ptr(), B, T, L, R,
        D, plan.nchunk, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_stack_carry forward launch failed: CUDA "
                           f"error {err}")
    return y, fg, z


def carry_backward(y, dy, fg, dz, w_fg, wd, bd, config: WaveNetConfig,
                   _plan: Optional[CarryPlan] = None):
    """The carry kernel's backward on CUDA tensors -> (dx, dw_fg [L,2R,2D],
    dwd, dadd [L,B,2D], dbd [L,1,R]), all float32; fg in the record dtype,
    dz read in it (a float32 dz is rounded to bf16 at bf16, as the TPU
    kernels read it). Gradients are summed in a fixed order, so repeated
    calls on one grid are bitwise equal. ``_plan`` as in
    ``carry_forward``."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = y.shape[:2]
    lib = _lib()
    dil = _check_call(lib, c, y, w_fg, wd, bd)
    plan = _plan or device_carry_plan(c, B, backward=True)[1]
    dev = y.device
    rec = _stack.record_dtype(c)
    dz = dz.to(rec).contiguous()
    for name, t, shape, dtype in (
            ("y", y, (B, T, R), torch.float32),
            ("dy", dy, (B, T, R), torch.float32),
            ("fg", fg, (B, T, L * 2 * D), rec),
            ("dz", dz, (B, T, L * D), rec)):
        _launch.check(_OP, name, t, shape, dev, dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, R), **f32)
    dw_fg = torch.empty((L, 2 * R, 2 * D), **f32)
    dwd = torch.empty((L, D, R), **f32)
    dadd = torch.empty((L, B, 2 * D), **f32)
    dbd = torch.empty((L, 1, R), **f32)
    scratch = torch.empty((carry_scratch_floats(
        True, B, L, R, D, sum(c.dilations), plan.nchunk),), **f32)
    fn = getattr(lib, "fused_stack_carry_bwd_"
                 + ("bf16" if _bf16(c) else "f32"))
    err = fn(
        y.data_ptr(), dy.data_ptr(), fg.data_ptr(), dz.data_ptr(),
        w_fg.data_ptr(), wd.data_ptr(), bd.data_ptr(), ctypes.addressof(dil),
        dx.data_ptr(), dw_fg.data_ptr(), dwd.data_ptr(), dadd.data_ptr(),
        dbd.data_ptr(), scratch.data_ptr(), B, T, L, R, D, plan.nchunk,
        _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_stack_carry backward launch failed: CUDA "
                           f"error {err}")
    return dx, dw_fg, dwd, dadd, dbd


# ---------------------------------------------------------------------------
# v1's wrappers and differentiable op
# ---------------------------------------------------------------------------

def fused_stack_forward(x, w_fg, wd, add, bd, config: WaveNetConfig,
                        _plan: Optional[CarryPlan] = None,
                        kernel: str = "auto"):
    """Whole stack -> (y [B,T,R], fg [B,T,L*2D]).

    CPU tensors run ``fused_stack_forward_reference``; CUDA tensors launch
    the kernel ``v1_kernel_plan(config, kernel)`` names (the carry kernel
    without z, ``_plan`` pinning its grid; or kernel 5's, its z not kept)
    or raise."""
    used = v1_kernel_plan(config, kernel)
    if not _launch.use_kernel(_OP, x):
        return fused_stack_forward_reference(x, w_fg, wd, add, bd, config)
    if used == "carry":
        y, fg, _ = carry_forward(x, w_fg, wd, add, bd, config, emit_z=False,
                                 _plan=_plan)
        key = carry_key(config)
    else:
        y, fg, _, key = _stack.launch_forward(x, w_fg, wd, add, bd, config,
                                              used, v1=True)
        key = "v1_" + key
    fused_stack_forward.launches += 1
    fused_stack_forward.launches_by[key] += 1
    return y, fg


def fused_stack_backward(y, fg, dz, dy, w_fg, wd, bd,
                         config: WaveNetConfig,
                         _plan: Optional[CarryPlan] = None,
                         kernel: str = "auto"):
    """VJP of the stack from saved (y, fg) -> (dx, dw [L,2,R,2D], dwd,
    dadd [L,B,2D], dbd [L,1,R]) (the JAX argument order).

    CPU tensors run ``fused_stack_backward_reference``; CUDA tensors
    launch the kernel ``v1_kernel_plan(config, kernel)`` names (``_plan``
    pins the carry kernel's grid) or raise."""
    used = v1_kernel_plan(config, kernel)
    if not _launch.use_kernel(_OP, y):
        return fused_stack_backward_reference(y, fg, dz, dy, w_fg, wd, bd,
                                              config)
    if used == "carry":
        dx, dw_fg, dwd, dadd, dbd = carry_backward(
            y, dy, fg, dz, w_fg, wd, bd, config, _plan=_plan)
        key = carry_key(config)
    else:
        dx, dw_fg, dwd, dadd, dbd, key = _stack.launch_backward(
            y, dy, fg, dz, w_fg, wd, bd, config, used, v1=True)
        key = "v1_" + key
    fused_stack_backward.launches += 1
    fused_stack_backward.launches_by[key] += 1
    return dx, _dw_split(dw_fg, config), dwd, dadd, dbd


#: Kernel launches made by each wrapper (read by chip_smoke.py), in all
#: and by kernel and mode ("carry", "carry_bf16", "v1_mma", "v1_tiled",
#: ..., as ``fused_stack``'s module docstring lists them).
fused_stack_forward.launches = 0
fused_stack_backward.launches = 0
fused_stack_forward.launches_by = collections.Counter()
fused_stack_backward.launches_by = collections.Counter()


class _FusedStack(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_fg, wd, add, bd, config, kernel):
        y, fg = fused_stack_forward(x.contiguous(), w_fg.contiguous(),
                                    wd.contiguous(), add.contiguous(),
                                    bd.contiguous(), config, kernel=kernel)
        ctx.config, ctx.kernel = config, kernel
        ctx.save_for_backward(y, fg, w_fg, wd, bd)
        # JAX computes z in float32 from the fg record (bf16 at bf16).
        return y, _fg_to_z(fg.float(), config)

    @staticmethod
    def backward(ctx, dy, dz):
        y, fg, w_fg, wd, bd = ctx.saved_tensors
        c = ctx.config
        dx, dw, dwd, dadd, dbd = fused_stack_backward(
            y, fg, dz.contiguous(), dy.contiguous(), w_fg.contiguous(),
            wd.contiguous(), bd.contiguous(), c, kernel=ctx.kernel)
        # dw [L, 2, R, 2D] is the packed w_fg layout [L, 2R, 2D].
        return (dx, dw.reshape(c.num_layers, 2 * c.residual_channels, -1),
                dwd, dadd, dbd, None, None)


def fused_stack(x, w_fg, wd, add, bd, config: WaveNetConfig,
                kernel: str = "auto"):
    """Differentiable whole-stack op: (y [B,T,R], z [B,T,L*D]); z is
    float32 in both compute dtypes, computed from the fg record;
    ``kernel`` as in ``v1_kernel_plan``."""
    v1_kernel_plan(config, kernel)
    return _FusedStack.apply(x, w_fg, wd, add, bd, config, kernel)
