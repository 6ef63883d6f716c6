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

Three CUDA kernel pairs compute the map. ``csrc/fused_stack_mma.cu``
("mma") multiplies on the tensor cores in 3xTF32 (the counterpart of the
TPU kernel's ``mxu_dot`` at HIGHEST: float32 parity) and is built for
R == D in (32, 64), with every weight of a layer resident in shared
memory; ``csrc/fused_stack.cu`` ("simt") multiplies on the FP32 cores at
R == D in (8, 16, 32); ``csrc/fused_stack_tiled.cu`` ("tiled") runs each
layer as tiled matrix products on the tensor cores whose weights stream
through shared memory, with ragged edges masked, at every width the TPU
kernel takes (any R, D in 1, 2, 4, ..., 64 or a multiple of 128; routed
wherever the other two are not built: R == D a multiple of 128, where
the weights no longer fit, R != D, and R == D in 1, 2, 4).
``stack_kernel_plan`` (pure) picks one. ``forward`` and ``backward`` run the routed kernel, or the one
that ``kernel=`` pins, for CUDA tensors and the plain versions for CPU
tensors; each counts its kernel launches in ``forward.launches`` /
``backward.launches`` (one per call: the call runs L kernels forward and
2L + 1 backward on "mma" and "simt", 2L and 7L on "tiled") and by kernel
in ``launches_by``. ``mma3_matmul`` repeats the 3xTF32 product arithmetic
in plain PyTorch, for the tests.

The stack computes in the config's ``compute_dtype``. At "bfloat16" it
rounds where the TPU kernel does (``fused_stack3.py`` with
``kernel_dtype = bfloat16``): the weights, the tap matrix ``[x(t-d) | x(t)]``
and the gate output z are rounded to bf16 before each product, which
accumulates in float32; the residual x, y, dx and every gradient stay
float32, and the fg and z records are bf16 tensors. The backward reads
dz in bf16 and rounds dx_{l+1}, the rebuilt layer input and da to bf16
before their products. Every kernel has a bf16 mode at its widths: the
mma and tiled kernels' one bf16 ``mma.sync`` pass a product
(``csrc/bf16_mma.cuh``), the simt kernel's FP32 FMA on operands rounded to
bf16 as they are staged into shared memory.
"""

from __future__ import annotations

import collections
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

#: ``kernel=`` values of ``forward``, ``backward`` and ``fused_stack3``.
KERNEL_CHOICES = ("auto", "mma", "simt", "tiled")
#: Widths (R == D) the mma and simt sources are built for, in either
#: mode. The tiled kernel takes every width ``supports`` takes (its
#: library says which); the route sends it the rest of them.
MMA_WIDTHS = (32, 64)
SIMT_WIDTHS = (8, 16, 32)
#: The compute dtypes of a stack, and the record dtype of each.
RECORD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SOURCES = {"mma": "fused_stack_mma", "simt": "fused_stack",
            "tiled": "fused_stack_tiled"}

__all__ = ["supports", "stack_kernel_plan", "record_dtype", "launch_key",
           "fused_stack_forward_reference",
           "fused_stack_backward_reference", "mma3_matmul", "forward",
           "backward", "fused_stack3", "pack_stack_weights", "tap_offsets"]


def _lane_alignable(width: int) -> bool:
    return (width % _LANE == 0) if width >= _LANE else (_LANE % width == 0)


def supports(config: WaveNetConfig, t_tile: int = _T_TILE_BWD) -> bool:
    """Mirror of the JAX kernel's ``supports``: filter_width 2, max
    dilation <= the tile, and widths its 128-lane records can pack."""
    c = config
    return (_lane_alignable(2 * c.dilation_channels)
            and _lane_alignable(c.dilation_channels)
            and c.filter_width == 2 and max(c.dilations) <= t_tile)


def record_dtype(config: WaveNetConfig) -> torch.dtype:
    """The dtype of the fg and z records: the compute dtype."""
    try:
        return RECORD_DTYPES[config.compute_dtype]
    except KeyError:
        raise ValueError(f"fused_stack: compute_dtype "
                         f"{config.compute_dtype!r}: one of "
                         f"{tuple(RECORD_DTYPES)}") from None


def stack_kernel_plan(config: WaveNetConfig) -> str:
    """The kernel that runs a stack of ``config`` on the card, by width and
    compute dtype. At float32: "mma" at R == D in ``MMA_WIDTHS`` (the
    paper and gc widths, where the chip run timed it faster than "simt"
    in both directions, and the wide width, which "simt" lacks), "simt"
    at the other widths ``csrc/fused_stack.cu`` is built for (R == D in
    8, 16), and "tiled" at every other width ``supports`` takes: R == D a
    multiple of 128 (the sharded config's 256; weights too large to stay
    in shared memory), R != D, and R == D in (1, 2, 4). At bfloat16 the
    same kernels in their bf16 mode. Raises at a width ``supports``
    refuses (the TPU kernel's records do not pack it). Each library's own
    ``*_supports_width`` ("simt", "tiled") is asked again at launch."""
    R, D = config.residual_channels, config.dilation_channels
    record_dtype(config)    # raises at a compute dtype the stack lacks
    if R == D and R in MMA_WIDTHS:
        return "mma"
    if R == D and R in SIMT_WIDTHS:
        return "simt"
    if not (_lane_alignable(2 * D) and _lane_alignable(D)):
        raise NotImplementedError(
            f"the fused_stack kernels take the TPU kernel's widths: D in "
            f"1, 2, 4, ..., 64 or a multiple of {_LANE}; got D={D}")
    return "tiled"


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _past(x: torch.Tensor, d: int) -> torch.Tensor:
    """x(t - d), zero for t < d, within each batch row."""
    return F.pad(x, (0, 0, d, 0))[:, :x.shape[1]]


def _rounding(dtype: torch.dtype):
    """What a product's operand goes through at compute dtype ``dtype``:
    at bf16, rounded to bf16 and back to float32 (to nearest even, as
    ``astype``), so that a float32 product of two operands is the bf16
    product, exact; at float32 nothing."""
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    return lambda t: t


@torch.no_grad()
def fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                  config: WaveNetConfig, matmul=torch.matmul):
    """Plain forward -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D]); fg and z
    in the record dtype. Every product goes through ``matmul``
    (``mma3_matmul`` repeats the mma kernel's arithmetic) on operands
    rounded as the config's compute dtype says."""
    D = config.dilation_channels
    bf16 = record_dtype(config) == torch.bfloat16
    rnd = _rounding(record_dtype(config))
    w_fg, wd = rnd(w_fg), rnd(wd)
    fgs, zs = [], []
    for l, d in enumerate(config.dilations):
        fg = matmul(rnd(torch.cat([_past(x, d), x], dim=-1)), w_fg[l]) \
            + add[l][:, None]
        z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
        if bf16:     # the TPU kernel's order: (x + z @ wd) + bd
            x = (x + matmul(rnd(z), wd[l])) + bd[l]
        else:
            x = x + (matmul(z, wd[l]) + bd[l])
        fgs.append(fg)
        zs.append(z)
    fg, z = torch.cat(fgs, dim=-1), torch.cat(zs, dim=-1)
    if bf16:
        fg, z = fg.to(torch.bfloat16), z.to(torch.bfloat16)
    return x, fg, z


def _contract_rows(u, v, matmul):
    """u [B,T,K], v [B,T,N] -> [K,N]: the sum over rows (b, t) of
    u[b, t, :, None] * v[b, t, None, :]."""
    if matmul is torch.matmul:
        return torch.einsum("btk,btn->kn", u, v)
    return matmul(u.flatten(0, 1).T, v.flatten(0, 1))


@torch.no_grad()
def fused_stack_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                   config: WaveNetConfig,
                                   matmul=torch.matmul):
    """Plain backward: an explicit reverse sweep over the layers (not
    autograd) that rebuilds each layer's input by subtraction, every
    product through ``matmul``, its operands rounded as the compute dtype
    says (the records fg and dz are read in their own dtype).
    -> (dx [B,T,R], dw_fg [L,2R,2D], dwd [L,D,R], dadd [L,B,2D],
    dbd [L,1,R])."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    T = y.shape[1]
    rnd = _rounding(record_dtype(c))
    fg, dz = fg.to(y.dtype), rnd(dz.to(y.dtype))
    w_fg_r, wd_r = rnd(w_fg), rnd(wd)
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
        z = rnd(t_ * s_)
        dc = rnd(dcur)
        dwd[l] = _contract_rows(z, dc, matmul)
        dbd[l, 0] = dcur.sum(dim=(0, 1))
        dzt = dz[..., D * l:D * (l + 1)] + matmul(dc, wd_r[l].T)
        da = torch.cat([dzt * s_ * (1.0 - t_ * t_),
                        dzt * t_ * s_ * (1.0 - s_)], dim=-1)
        x = (x - matmul(z, wd_r[l])) - bd[l]
        da_r = rnd(da)
        dw_fg[l] = _contract_rows(rnd(torch.cat([_past(x, d), x], dim=-1)),
                                  da_r, matmul)
        tmp = matmul(da_r, w_fg_r[l].T)                      # [B, T, 2R]
        dcur = dcur + tmp[..., R:]
        if d < T:
            dcur[:, :T - d] += tmp[:, d:, :R]
        dadd[l] = da.sum(dim=1)
    return dcur, dw_fg, dwd, dadd, dbd


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest,
    ties away from zero, on the words' bits (``cvt.rna.tf32.f32`` for
    every finite or infinite word)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor):
    """(hi, lo): hi = tf32(a), lo = tf32(a - hi), as the mma kernel splits
    each operand (``csrc/tf32_mma.cuh``). A NaN is kept in lo: a - hi is
    made the device's NaN 0x7fffffff (the card's float32 arithmetic makes
    no other), which a signed min holds below the rounding's wrap."""
    hi = _tf32_rna(a)
    d = (a - hi).contiguous().view(torch.int32)
    d = torch.where(d.view(torch.float32).isnan(), 0x7FFFFFFF, d)
    lo = (torch.clamp(d, max=0x7FFFEFFF) + 0x1000) & -0x2000
    return hi, lo.view(torch.float32)


def mma3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a [..., K], b [K, N], float32) as the mma kernel forms
    it: 3xTF32 over k-steps of 8, each step adding lo.hi, hi.lo, then
    hi.hi to a float32 sum (the tensor core sums a step's 8 terms in its
    own order). For the tests; the kernel never calls it."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[1:], dtype=torch.float32,
                      device=a.device)
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        out = out + al[..., ks] @ bh[ks]
        out = out + ah[..., ks] @ bl[ks]
        out = out + ah[..., ks] @ bh[ks]
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(kernel: str, v1: bool = False):
    """The loaded library of ``kernel`` ("mma", "simt" or "tiled") and
    the prefix of its C functions; every mode takes the same arguments
    (the ``_bf16`` entry points take bf16 fg and z records). ``v1``: the
    tiled library's entries of the retired v1 stack
    (``fused_stack_tiled_v1_*``: every width, no z record)."""
    from wavenet_torch.kernels import _build
    lib = _build.load(_SOURCES[kernel])
    name = _SOURCES[kernel] + ("_v1" if v1 and kernel == "tiled" else "")
    p, i = ctypes.c_void_p, ctypes.c_int
    if kernel in ("simt", "tiled"):
        getattr(lib, f"{name}_supports_width").argtypes = [i, i]
        getattr(lib, f"{name}_supports_width").restype = i
    getattr(lib, f"{name}_bwd_scratch_floats").argtypes = [i] * 5
    getattr(lib, f"{name}_bwd_scratch_floats").restype = ctypes.c_longlong
    for mode in ("f32", "bf16"):
        getattr(lib, f"{name}_fwd_{mode}").argtypes = [p] * 10 + [i] * 5 + [p]
        getattr(lib, f"{name}_fwd_{mode}").restype = i
        getattr(lib, f"{name}_bwd_{mode}").argtypes = [p] * 14 + [i] * 5 + [p]
        getattr(lib, f"{name}_bwd_{mode}").restype = i
    return lib, name


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"fused_stack: kernel={kernel!r}: one of "
                         f"{KERNEL_CHOICES}")


def launch_key(kernel: str, config: WaveNetConfig) -> str:
    """The ``launches_by`` key of a launch of ``kernel`` ("mma", "simt",
    "tiled")
    for ``config``: the kernel, with "_bf16" for its bf16 mode."""
    return kernel + ("_bf16" if record_dtype(config) == torch.bfloat16
                     else "")


def _route(kernel: str, config: WaveNetConfig, v1: bool = False):
    """The kernel a call runs (``stack_kernel_plan``'s for "auto", else the
    pinned one), its library and the C function of its mode (e.g.
    ``fused_stack_mma_fwd_bf16`` without the direction); raises at a width
    or dtype the kernel is not built for (the simt and tiled libraries say
    which widths), with no fallback to another kernel. ``v1``: a launch
    for the retired v1 stack (``experiments/fused_stack.py``), whose route
    has chosen ``kernel``; its tiled entries take every width."""
    c = config
    if v1:
        if c.filter_width != 2:
            raise NotImplementedError("the v1 stack needs filter_width=2")
    elif not supports(c):
        raise NotImplementedError(
            "fused_stack needs filter_width=2, max dilation <= "
            f"{_T_TILE_BWD} and D in 1, 2, 4, ..., 64 or a multiple of "
            f"{_LANE} (the TPU kernel's supports)")
    used = stack_kernel_plan(c) if kernel == "auto" else kernel
    bf16 = record_dtype(c) == torch.bfloat16
    lib, prefix = _lib(used, v1)
    R, D = c.residual_channels, c.dilation_channels
    built = (R == D and R in MMA_WIDTHS if used == "mma"
             else getattr(lib, f"{prefix}_supports_width")(R, D))
    if not built:
        raise NotImplementedError(
            f"{prefix}: not built for R={R}, D={D} (see stack_kernel_plan: "
            "the tiled kernel takes every width the route sends it)")
    return used, lib, prefix, "bf16" if bf16 else "f32"


def _check(name: str, t: torch.Tensor, shape, device,
           dtype=torch.float32) -> None:
    _launch.check("fused_stack", name, t, shape, device, dtype)


def _check_weights(config: WaveNetConfig, x: torch.Tensor, w_fg, wd, bd):
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    dev = x.device
    _check("w_fg", w_fg, (L, 2 * R, 2 * D), dev)
    _check("wd", wd, (L, D, R), dev)
    _check("bd", bd, (L, 1, R), dev)
    return (ctypes.c_int * L)(*c.dilations)


def _xbuf_shape(kernel: str, B: int, T: int, R: int, D: int, mode: str):
    """The forward's float32 scratch, by what each kernel writes there: the
    mma and simt kernels' two [B, T, R] layer buffers; the tiled kernel's
    bf16 mode z as float, [B, T, D] (its f32 mode writes none)."""
    if kernel != "tiled":
        return (2, B, T, R)
    return (B, T, D) if mode == "bf16" else (0,)


def launch_forward(x, w_fg, wd, add, bd, config: WaveNetConfig, kernel: str,
                   v1: bool = False):
    """One forward launch on CUDA tensors, uncounted -> (y, fg, z, the
    ``launch_key`` of the kernel run); raises where it cannot launch.
    ``v1`` (the retired v1 stack's route, which counts its own launches):
    the tiled kernel's v1 entries, at every width, whose z is one layer's
    scratch [B, T, D] rather than the record."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = x.shape[:2]
    used, lib, prefix, mode = _route(kernel, c, v1)
    dil = _check_weights(c, x, w_fg, wd, bd)
    _check("x", x, (B, T, R), x.device)
    _check("add", add, (L, B, 2 * D), x.device)
    rec = dict(dtype=record_dtype(c), device=x.device)
    y = torch.empty_like(x)
    fg = torch.empty((B, T, L * 2 * D), **rec)
    z = torch.empty((B, T, D if v1 and used == "tiled" else L * D), **rec)
    xbuf = torch.empty(_xbuf_shape(used, B, T, R, D, mode),
                       dtype=torch.float32, device=x.device)
    err = getattr(lib, f"{prefix}_fwd_{mode}")(
        x.data_ptr(), w_fg.data_ptr(), wd.data_ptr(), add.data_ptr(),
        bd.data_ptr(), ctypes.addressof(dil), y.data_ptr(), fg.data_ptr(),
        z.data_ptr(), xbuf.data_ptr(), B, T, L, R, D, _launch.stream(x.device))
    if err != 0:
        raise RuntimeError(f"{prefix} forward launch failed: CUDA error "
                           f"{err}")
    return y, fg, z, launch_key(used, c)


def forward(x, w_fg, wd, add, bd, config: WaveNetConfig, kernel="auto"):
    """Stack forward -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D]); fg and z
    in the record dtype (``record_dtype``), every input float32 (the
    weights are rounded to bf16 in the kernel, at bf16).

    CPU tensors run ``fused_stack_forward_reference`` whatever ``kernel``
    says; CUDA tensors launch the kernel that ``stack_kernel_plan`` picks
    ("auto") or that ``kernel`` pins ("mma", "simt", "tiled"), or raise."""
    _check_kernel(kernel)
    if not _launch.use_kernel("fused_stack", x):
        return fused_stack_forward_reference(x, w_fg, wd, add, bd, config)
    y, fg, z, key = launch_forward(x, w_fg, wd, add, bd, config, kernel)
    forward.launches += 1
    forward.launches_by[key] += 1
    return y, fg, z


def launch_backward(y, dy, fg, dz, w_fg, wd, bd, config: WaveNetConfig,
                    kernel: str, v1: bool = False):
    """One backward launch on CUDA tensors, uncounted -> (dx, dw_fg, dwd,
    dadd, dbd, the ``launch_key`` of the kernel run); ``v1`` as in
    ``launch_forward`` (the v1 entries' backward is kernel 5's, at every
    width)."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B, T = y.shape[:2]
    used, lib, prefix, mode = _route(kernel, c, v1)
    dil = _check_weights(c, y, w_fg, wd, bd)
    dev = y.device
    rec = record_dtype(c)
    dz = dz.to(rec).contiguous()
    for name, t, shape, dtype in (
            ("y", y, (B, T, R), torch.float32),
            ("dy", dy, (B, T, R), torch.float32),
            ("fg", fg, (B, T, L * 2 * D), rec),
            ("dz", dz, (B, T, L * D), rec)):
        _check(name, t, shape, dev, dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, R), **f32)
    dw_fg = torch.empty((L, 2 * R, 2 * D), **f32)
    dwd = torch.empty((L, D, R), **f32)
    dadd = torch.empty((L, B, 2 * D), **f32)
    dbd = torch.empty((L, 1, R), **f32)
    scratch = torch.empty(
        (getattr(lib, f"{prefix}_bwd_scratch_floats")(B, T, L, R, D),), **f32)
    err = getattr(lib, f"{prefix}_bwd_{mode}")(
        y.data_ptr(), dy.data_ptr(), fg.data_ptr(), dz.data_ptr(),
        w_fg.data_ptr(), wd.data_ptr(), bd.data_ptr(), ctypes.addressof(dil),
        dx.data_ptr(), dw_fg.data_ptr(), dwd.data_ptr(), dadd.data_ptr(),
        dbd.data_ptr(), scratch.data_ptr(), B, T, L, R, D, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"{prefix} backward launch failed: CUDA error "
                           f"{err}")
    return dx, dw_fg, dwd, dadd, dbd, launch_key(used, c)


def backward(y, dy, fg, dz, w_fg, wd, bd, config: WaveNetConfig,
             kernel="auto"):
    """Stack VJP -> (dx, dw_fg [L,2R,2D], dwd [L,D,R], dadd [L,B,2D],
    dbd [L,1,R]), all float32; fg in the record dtype, dz read in it (a
    float32 dz is rounded to bf16 at bf16, as the TPU kernel reads it).

    CPU tensors run ``fused_stack_backward_reference`` whatever ``kernel``
    says; CUDA tensors launch the routed or pinned kernel, as ``forward``
    does, or raise. Every kernel sums the weight gradients in a fixed order
    (no atomics): repeated calls are bitwise equal."""
    _check_kernel(kernel)
    if not _launch.use_kernel("fused_stack", y):
        return fused_stack_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                              config)
    *grads, key = launch_backward(y, dy, fg, dz, w_fg, wd, bd, config, kernel)
    backward.launches += 1
    backward.launches_by[key] += 1
    return tuple(grads)


#: Kernel launches made by ``forward`` / ``backward`` (read by chip_smoke.py),
#: in all and by kernel and mode ("mma", "mma_bf16", "simt", "simt_bf16",
#: "tiled", "tiled_bf16").
forward.launches = 0
backward.launches = 0
forward.launches_by = collections.Counter()
backward.launches_by = collections.Counter()


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------

class _FusedStack3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_fg, wd, add, bd, config, kernel):
        y, fg, z = forward(x.contiguous(), w_fg.contiguous(),
                           wd.contiguous(), add.contiguous(),
                           bd.contiguous(), config, kernel)
        ctx.config, ctx.kernel = config, kernel
        ctx.save_for_backward(y, fg, w_fg, wd, bd)
        return y, z

    @staticmethod
    def backward(ctx, dy, dz):
        y, fg, w_fg, wd, bd = ctx.saved_tensors
        dx, dw_fg, dwd, dadd, dbd = backward(
            y, dy.contiguous(), fg, dz.contiguous(), w_fg.contiguous(),
            wd.contiguous(), bd.contiguous(), ctx.config, ctx.kernel)
        return dx, dw_fg, dwd, dadd, dbd, None, None


def fused_stack3(x, w_fg, wd, add, bd, config: WaveNetConfig,
                 kernel: str = "auto"):
    """Differentiable whole-stack op: (y [B,T,R], z [B,T,L*D]), z in the
    record dtype (its cotangent comes back in it); ``kernel`` as in
    ``forward``."""
    _check_kernel(kernel)
    return _FusedStack3.apply(x, w_fg, wd, add, bd, config, kernel)
