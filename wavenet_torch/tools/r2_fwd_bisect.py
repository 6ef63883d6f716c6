"""Bisect the stack's forward layer: where does its time go?

Counterpart of ``tools/r2_fwd_bisect.py`` (TPU kernel ``_kernel``), which
bisects the forward that its model's stack route runs. Ported as a probe
of the port's own forwards, in two kernels (``kernel=``):

* "mma": ``fused_stack_mma``'s forward (``csrc/fused_stack_mma_fwd.cuh``,
  run by ``csrc/fwd_bisect_mma.cu``), the kernel the stack route runs at
  R == D in (32, 64): 3xTF32 on the tensor cores at float32, one bf16
  ``mma.sync`` pass in its bf16 mode (weights, tap tile and z rounded to
  bf16 in the kernel; float32 residual; bf16 fg and z records);
* "simt": kernel 5's FP32-core forward (``csrc/fused_stack_fwd.cuh``, run
  by ``csrc/fwd_bisect.cu``) at R == D in (16, 32), at float32 or with
  bf16 operands (weights and the shared cat and z tiles in bf16, products
  and sums in float32, the residual in float32, bf16 fg and z records).

"auto" (the default) takes ``kernels.fused_stack.stack_kernel_plan``'s
kernel for the config, so the probe bisects what the stack route runs; a
pinned kernel raises at a width it lacks, with no fallback. Each variant
drops parts of the per-layer kernel and is its own compile-time
instantiation. The TPU tool's toggles, mapped onto the port's layer:

    full          everything on; the stack kernel's forward itself
    noshift       no load of x(t - d): the past half of the tap tile
                  reads zeros (the TPU's per-batch dilated-tap copies off)
    nodma         no fg / z record writes (the TPU's record packing + DMA)
    bare          both off: the tap tile's current half, the products,
                  the activation and the residual update
    mxu           the products and the activation only: the tap tile is
                  zeros and never refreshed from x (the residual x(t) is
                  read in the epilogue, where the TPU kept it in VMEM)
    rolled        the past tap from one load of the tile and its d-row
                  halo instead of a second row read (the TPU's one roll
                  of the whole tile plus boundary fixes)
    rolled_nodma  rolled without the record writes

Like the TPU tool's, the variants that drop work compute something else
than the layer; each has a plain PyTorch version here with the same
signature, which the wrapper runs for CPU tensors: at float32 in "mma"
every product goes through ``kernels.fused_stack.mma3_matmul`` (the
kernel's 3xTF32 arithmetic), and the bf16 mode adds the bias as the
stack kernel's bf16 mode does, ``(x + z @ wd) + bd``.

    python -m wavenet_torch.tools.r2_fwd_bisect [--device cpu] \
        [--config paper|wide]

prints the routed kernel's table (mma at both configs), then simt's
(paper only: simt lacks the wide width).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.fused_stack import (_past, mma3_matmul,
                                               stack_kernel_plan)
from wavenet_torch.models.config import (WaveNetConfig, paper_config,
                                         wide_config)

B, SAMPLE = 8, 16000
VARIANTS = ("full", "noshift", "nodma", "bare", "mxu", "rolled",
            "rolled_nodma")
# The TPU tool's table order.
MAIN_ORDER = ("mxu", "bare", "nodma", "noshift", "rolled_nodma", "rolled",
              "full")
DTYPES = (torch.bfloat16, torch.float32)
KERNEL_CHOICES = ("auto", "mma", "simt")
#: Widths (R == D) each probe kernel is built for, and its library.
WIDTHS = {"mma": (32, 64), "simt": (16, 32)}
_SOURCES = {"mma": "fwd_bisect_mma", "simt": "fwd_bisect"}
_RECORDS = ("full", "noshift", "rolled")
_SHIFT = ("full", "nodma", "rolled", "rolled_nodma")

Out = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def writes_records(variant: str) -> bool:
    return variant in _RECORDS


def _check_variant(variant: str, dtype) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"fwd_bisect: variant {variant!r} not in {VARIANTS}")
    if dtype not in DTYPES:
        raise ValueError(f"fwd_bisect: dtype {dtype} not in {DTYPES}")


def probe_kernel(config: WaveNetConfig, kernel: str = "auto") -> str:
    """The kernel a call runs: ``stack_kernel_plan``'s for "auto" (the one
    the config's stack route runs), else the pinned one. Raises at a
    width the kernel is not built for, with no fallback, on every
    device."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"fwd_bisect: kernel={kernel!r}: one of "
                         f"{KERNEL_CHOICES}")
    used = stack_kernel_plan(config) if kernel == "auto" else kernel
    R, D = config.residual_channels, config.dilation_channels
    if config.filter_width != 2 or R != D or R not in WIDTHS[used]:
        raise NotImplementedError(
            f"fwd_bisect ({used}) is built for filter_width 2 and R == D in "
            f"{WIDTHS[used]}; got R={R}, D={D}")
    return used


def launch_key(kernel: str, variant: str, dtype) -> str:
    """The ``launches_by`` key of a launch: "<variant>_<bf16|f32>" on
    simt, with "mma_" in front on mma."""
    key = f"{variant}_{tools.DTYPE_NAMES[dtype]}"
    return key if kernel == "simt" else f"{kernel}_{key}"


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """An operand as the kernel multiplies it: rounded to ``dtype``."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _matmul(kernel: str, dtype):
    """A product as ``kernel`` forms it: 3xTF32 (``mma3_matmul``) on mma
    at float32, else float32 products of the (rounded) operands."""
    if kernel == "mma" and dtype == torch.float32:
        return mma3_matmul
    return torch.matmul


@torch.no_grad()
def fwd_bisect_reference(x, w_fg, wd, add, bd, config: WaveNetConfig,
                         variant: str = "full", dtype=torch.float32,
                         kernel: str = "auto") -> Out:
    """Plain version of variant ``variant`` on ``kernel`` (resolved as
    :func:`fwd_bisect` does) -> (y [B,T,R], fg [B,T,L*2D], z [B,T,L*D]);
    fg and z are None for the variants without records and in ``dtype``
    otherwise."""
    _check_variant(variant, dtype)
    used = probe_kernel(config, kernel)
    mm = _matmul(used, dtype)
    # mma's bf16 mode adds the bias as fused_stack_mma does.
    bias_last = used == "mma" and dtype == torch.bfloat16
    D = config.dilation_channels
    cat_on = variant != "mxu"
    shift = variant in _SHIFT
    wq, wdq = _q(w_fg, dtype), _q(wd, dtype)
    fgs, zs = [], []
    for l, d in enumerate(config.dilations):
        past = _past(x, d) if shift else torch.zeros_like(x)
        cur = x if cat_on else torch.zeros_like(x)
        fg = (mm(torch.cat([_q(past, dtype), _q(cur, dtype)], dim=-1), wq[l])
              + add[l][:, None])
        z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
        zw = mm(_q(z, dtype), wdq[l])
        x = (x + zw) + bd[l] if bias_last else x + (zw + bd[l])
        fgs.append(fg.to(dtype))
        zs.append(z.to(dtype))
    if not writes_records(variant):
        return x, None, None
    return x, torch.cat(fgs, dim=-1), torch.cat(zs, dim=-1)


def _lib(kernel: str):
    """The loaded library of ``kernel``'s probes (both r2 and r2b)."""
    from wavenet_torch.kernels import _build
    name = _SOURCES[kernel]
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    sfx = "_mma" if kernel == "mma" else ""
    for fn, args in ((f"fwd_bisect{sfx}_supports_width", [i, i]),
                     (f"fwd_bisect{sfx}_run", [i, i] + [p] * 10 + [i] * 5
                      + [p]),
                     (f"fwd_bisect2{sfx}_run", [i, i, i] + [p] * 5 + [i] * 4
                      + [p])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i
    return lib, sfx


def fwd_bisect(x, w_fg, wd, add, bd, config: WaveNetConfig,
               variant: str = "full", dtype=torch.float32,
               kernel: str = "auto") -> Out:
    """One call of variant ``variant`` on ``kernel`` (L launches) -> (y,
    fg, z) as :func:`fwd_bisect_reference`. Takes float32 tensors as
    ``kernels.fused_stack.forward`` does (the weights are rounded to
    ``dtype`` here on simt, in the kernel on mma). CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _check_variant(variant, dtype)
    used = probe_kernel(config, kernel)
    if not _launch.use_kernel("fwd_bisect", x):
        return fwd_bisect_reference(x, w_fg, wd, add, bd, config, variant,
                                    dtype, used)
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B_, T = x.shape[:2]
    dev = x.device
    lib, sfx = _lib(used)
    if not getattr(lib, f"fwd_bisect{sfx}_supports_width")(R, D):
        raise NotImplementedError(
            f"{_SOURCES[used]}: not built for R={R}, D={D}")
    for name, t, shape in (("x", x, (B_, T, R)),
                           ("w_fg", w_fg, (L, 2 * R, 2 * D)),
                           ("wd", wd, (L, D, R)),
                           ("add", add, (L, B_, 2 * D)),
                           ("bd", bd, (L, 1, R))):
        _launch.check("fwd_bisect", name, t, shape, dev)
    wq, wdq = ((w_fg, wd) if used == "mma" else
               (w_fg.to(dtype).contiguous(), wd.to(dtype).contiguous()))
    y = torch.empty_like(x)
    fg = z = None
    if writes_records(variant):
        fg = torch.empty((B_, T, L * 2 * D), dtype=dtype, device=dev)
        z = torch.empty((B_, T, L * D), dtype=dtype, device=dev)
    xbuf = torch.empty((2, B_, T, R), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*c.dilations)
    err = getattr(lib, f"fwd_bisect{sfx}_run")(
        VARIANTS.index(variant), int(dtype == torch.bfloat16), x.data_ptr(),
        wq.data_ptr(), wdq.data_ptr(), add.data_ptr(), bd.data_ptr(),
        ctypes.addressof(dil), y.data_ptr(),
        fg.data_ptr() if fg is not None else None,
        z.data_ptr() if z is not None else None, xbuf.data_ptr(), B_, T, L,
        R, D, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fwd_bisect {used} {variant} launch failed: "
                           f"CUDA error {err}")
    fwd_bisect.launches += 1
    fwd_bisect.launches_by[launch_key(used, variant, dtype)] += 1
    return y, fg, z


#: Calls of ``fwd_bisect`` that launched the kernel, in all and by
#: ``launch_key`` ("<variant>_<bf16|f32>" on simt, "mma_<variant>_<...>"
#: on mma; read by chip_smoke.py).
fwd_bisect.launches = 0
fwd_bisect.launches_by = collections.Counter()


def inputs(config: WaveNetConfig, batch: int, sample: int, device):
    """The TPU tool's inputs: x ~ N(0, 1) [B, rf + sample, R] from numpy
    seed 0, the packed weights of ``init_params(0)`` (zero biases)."""
    from wavenet_torch.kernels.stack_pack import pack_stack_weights
    from wavenet_torch.models.wavenet import init_params
    c = config
    params = init_params(0, c, device="cpu")
    T = c.receptive_field + sample
    x = np.random.RandomState(0).randn(batch, T, c.residual_channels)
    w_fg, wd, add, bd = pack_stack_weights(params, c, None, batch)
    return tuple(t.to(device).contiguous() for t in (
        torch.as_tensor(x.astype(np.float32)), w_fg, wd, add, bd))


#: ``--config`` choices: the JAX tool's paper config, and the port's other
#: stack width (R = D = 64), which only the mma kernel is built for.
CONFIGS = {"paper": paper_config, "wide": wide_config}


def main(argv=None) -> int:
    p = tools.parser(__doc__.splitlines()[0])
    p.add_argument("--config", default="paper", choices=tuple(CONFIGS))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(tools.device_line(dev), flush=True)
    c = CONFIGS[args.config]()
    args_ = inputs(c, B, SAMPLE, dev)
    routed = probe_kernel(c)
    kernels = (routed,) + tuple(k for k in WIDTHS if k != routed
                                and c.residual_channels in WIDTHS[k])

    def line(label):
        kernel, variant, dt = label.split()
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        times = tools.timed_ms(
            lambda: fwd_bisect(*args_, c, variant, dtype, kernel), dev,
            calls=10)
        return (f"[{kernel:4s} {variant:13s} {dt:4s}] median "
                f"{np.median(times):7.3f} ms "
                f"({[round(t, 3) for t in times]})")

    return tools.run_table([f"{k} {v} {d}" for k in kernels
                            for d in ("bf16", "f32") for v in MAIN_ORDER],
                           line)


if __name__ == "__main__":
    raise SystemExit(main())
