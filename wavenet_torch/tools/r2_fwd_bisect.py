"""Bisect kernel 5's forward layer: where does its time go?

Counterpart of ``tools/r2_fwd_bisect.py`` (TPU kernel ``_kernel``), ported
as a probe of the port's own forward (``csrc/fused_stack_fwd.cuh``, run by
``csrc/fwd_bisect.cu``): each variant drops parts of the per-layer kernel
and is its own compile-time instantiation, at float32 or with bf16
operands (weights and the shared cat and z tiles in bf16, products and
sums in float32, the residual in float32, bf16 fg and z records). The
TPU tool's toggles, mapped onto the port's layer:

    full          everything on; at float32 this is kernel 5's forward
    noshift       no gather of x(t - d): the past half of the cat tile
                  reads zeros (the TPU's per-batch dilated-tap copies off)
    nodma         no fg / z record writes (the TPU's record packing + DMA)
    bare          both off: the cat tile's current half, the products,
                  the activation and the residual update
    mxu           the products and the activation only: the cat tile is
                  zeros and never refreshed from x (the residual x(t) is
                  read in the epilogue, where the TPU kept it in VMEM)
    rolled        the past tap from one load of the tile and its d-row
                  halo instead of two row reads per element (the TPU's one
                  roll of the whole tile plus boundary fixes)
    rolled_nodma  rolled without the record writes

Like the TPU tool's, the variants that drop work compute something else
than the layer; each has a plain PyTorch version here with the same
signature, which the wrapper runs for CPU tensors.

    python -m wavenet_torch.tools.r2_fwd_bisect [--device cpu]
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.fused_stack import _past
from wavenet_torch.models.config import WaveNetConfig, paper_config

B, SAMPLE = 8, 16000
VARIANTS = ("full", "noshift", "nodma", "bare", "mxu", "rolled",
            "rolled_nodma")
# The TPU tool's table order.
MAIN_ORDER = ("mxu", "bare", "nodma", "noshift", "rolled_nodma", "rolled",
              "full")
DTYPES = (torch.bfloat16, torch.float32)
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


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """An operand as the kernel multiplies it: rounded to ``dtype``."""
    return t if dtype == torch.float32 else t.to(dtype).float()


@torch.no_grad()
def fwd_bisect_reference(x, w_fg, wd, add, bd, config: WaveNetConfig,
                         variant: str = "full",
                         dtype=torch.float32) -> Out:
    """Plain version of variant ``variant`` -> (y [B,T,R], fg [B,T,L*2D],
    z [B,T,L*D]); fg and z are None for the variants without records and
    in ``dtype`` otherwise."""
    _check_variant(variant, dtype)
    D = config.dilation_channels
    cat_on = variant != "mxu"
    shift = variant in _SHIFT
    wq, wdq = _q(w_fg, dtype), _q(wd, dtype)
    fgs, zs = [], []
    for l, d in enumerate(config.dilations):
        past = _past(x, d) if shift else torch.zeros_like(x)
        cur = x if cat_on else torch.zeros_like(x)
        fg = (torch.cat([_q(past, dtype), _q(cur, dtype)], dim=-1) @ wq[l]
              + add[l][:, None])
        z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
        x = x + (_q(z, dtype) @ wdq[l] + bd[l])
        fgs.append(fg.to(dtype))
        zs.append(z.to(dtype))
    if not writes_records(variant):
        return x, None, None
    return x, torch.cat(fgs, dim=-1), torch.cat(zs, dim=-1)


def _lib():
    from wavenet_torch.kernels import _build
    lib = _build.load("fwd_bisect")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fwd_bisect_supports_width.argtypes = [i, i]
    lib.fwd_bisect_supports_width.restype = i
    lib.fwd_bisect_run.argtypes = [i, i] + [p] * 10 + [i] * 5 + [p]
    lib.fwd_bisect_run.restype = i
    lib.fwd_bisect2_run.argtypes = [i, i, i] + [p] * 5 + [i] * 4 + [p]
    lib.fwd_bisect2_run.restype = i
    return lib


def fwd_bisect(x, w_fg, wd, add, bd, config: WaveNetConfig,
               variant: str = "full", dtype=torch.float32) -> Out:
    """One call of variant ``variant`` (L launches) -> (y, fg, z) as
    :func:`fwd_bisect_reference`. Takes float32 tensors as
    ``kernels.fused_stack.forward`` does (the weights are rounded to
    ``dtype`` here). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    _check_variant(variant, dtype)
    if not _launch.use_kernel("fwd_bisect", x):
        return fwd_bisect_reference(x, w_fg, wd, add, bd, config, variant,
                                    dtype)
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    B_, T = x.shape[:2]
    dev = x.device
    lib = _lib()
    if c.filter_width != 2 or not lib.fwd_bisect_supports_width(R, D):
        raise NotImplementedError(
            "fwd_bisect is built for filter_width 2 and R == D in (16, 32); "
            f"got R={R}, D={D}")
    for name, t, shape in (("x", x, (B_, T, R)),
                           ("w_fg", w_fg, (L, 2 * R, 2 * D)),
                           ("wd", wd, (L, D, R)),
                           ("add", add, (L, B_, 2 * D)),
                           ("bd", bd, (L, 1, R))):
        _launch.check("fwd_bisect", name, t, shape, dev)
    wq, wdq = w_fg.to(dtype).contiguous(), wd.to(dtype).contiguous()
    y = torch.empty_like(x)
    fg = z = None
    if writes_records(variant):
        fg = torch.empty((B_, T, L * 2 * D), dtype=dtype, device=dev)
        z = torch.empty((B_, T, L * D), dtype=dtype, device=dev)
    xbuf = torch.empty((2, B_, T, R), dtype=torch.float32, device=dev)
    dil = (ctypes.c_int * L)(*c.dilations)
    err = lib.fwd_bisect_run(
        VARIANTS.index(variant), int(dtype == torch.bfloat16), x.data_ptr(),
        wq.data_ptr(), wdq.data_ptr(), add.data_ptr(), bd.data_ptr(),
        ctypes.addressof(dil), y.data_ptr(),
        fg.data_ptr() if fg is not None else None,
        z.data_ptr() if z is not None else None, xbuf.data_ptr(), B_, T, L,
        R, D, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fwd_bisect {variant} launch failed: CUDA error "
                           f"{err}")
    fwd_bisect.launches += 1
    fwd_bisect.launches_by[f"{variant}_{tools.DTYPE_NAMES[dtype]}"] += 1
    return y, fg, z


#: Calls of ``fwd_bisect`` that launched the kernel, in all and by
#: "<variant>_<bf16|f32>" (read by chip_smoke.py).
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


def main(argv=None) -> int:
    args = tools.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device(args.device)
    print(tools.device_line(dev), flush=True)
    c = paper_config()
    args_ = inputs(c, B, SAMPLE, dev)

    def line(label):
        variant, dt = label.split()
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        times = tools.timed_ms(lambda: fwd_bisect(*args_, c, variant, dtype),
                               dev, calls=10)
        return (f"[{variant:13s} {dt:4s}] median {np.median(times):7.3f} "
                f"ms ({[round(t, 3) for t in times]})")

    return tools.run_table([f"{v} {d}" for d in ("bf16", "f32")
                            for v in MAIN_ORDER], line)


if __name__ == "__main__":
    raise SystemExit(main())
