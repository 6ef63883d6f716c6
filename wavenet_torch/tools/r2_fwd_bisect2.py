"""Second bisect of the stack's forward: its core math, one launch.

Counterpart of ``tools/r2_fwd_bisect2.py`` (TPU kernel ``_kernel``), ported
in two kernels (``kernel=``): "mma" (the default; ``csrc/fwd_bisect_mma.cu``)
multiplies on the tensor cores as the stack route's ``fused_stack_mma``
does, 3xTF32 at float32 and one bf16 ``mma.sync`` pass at bf16; "simt"
(``csrc/fwd_bisect.cu``) on the FP32 cores, with bf16 operands converted
to float32. Both are built for R == D == 32, the JAX tool's paper config
(mma checks the width on every device; simt, as before, at launch). None
of the variants reads another row (the TPU tool's cat tile, and the fat
tile's past lanes, are never written), so each runs as one launch in
which a block keeps all L layers of its rows in shared memory; each is
its own compile-time instantiation, at float32 or with bf16 operands
(the TPU tool's bf16):

    base       fg = cat @ w_fg (K = 2R, the cat tile zeros), tanh * sigmoid,
               cur += z @ wd
    mm_only    both products, z = f * g
    act_only   cur += tanh(cur) * sigmoid(cur), no products
    one_tanh   base with z = tanh(f) * (0.5 + 0.5 tanh(g))
    fat        one K = 2R + 2D product a layer, [0 | cur | 0 | z] @ wfat
               [L, 2R+2D, 2D+R], emitting fg and the next residual
    fat_1t     fat with the one-tanh gate

Tile map: the TPU tool's tile of 1024 (2048) time steps of all B rows is
a block of 64 (128) rows here (``TILES``); a block loads each layer's
weights once, so the larger block halves the weight traffic per row. A
block starts from a zero fat tile: the TPU tool's scratch carried the
previous tile's last z into the next tile's first layer, which a
tile-independent launch does not. The plain versions multiply as their
kernel does: through ``kernels.fused_stack.mma3_matmul`` on mma at
float32, else float32 products of the (rounded) operands.

    python -m wavenet_torch.tools.r2_fwd_bisect2 [--device cpu]

prints the tensor-core table, then simt's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch
from wavenet_torch.models.config import paper_config
from wavenet_torch.tools.r2_fwd_bisect import (B, SAMPLE, _lib, _matmul,
                                               _q)

VARIANTS = ("base", "mm_only", "act_only", "one_tanh", "fat", "fat_1t")
# TPU tile (time steps of all B rows) -> rows per block.
TILES = {1024: 64, 2048: 128}
# The TPU tool's table (variant, tile).
MAIN_CASES = (("fat", 1024), ("fat_1t", 1024), ("one_tanh", 2048),
              ("fat_1t", 2048), ("mm_only", 2048))
DTYPES = (torch.bfloat16, torch.float32)
KERNEL_CHOICES = ("mma", "simt")
#: The width (R == D) both kernels are built for.
WIDTH = 32


def _check(variant: str, tile: int, dtype, kernel: str, x, wd) -> None:
    """The arguments' checks; mma's width on every device (simt's at
    launch, as before)."""
    if variant not in VARIANTS:
        raise ValueError(f"fwd_bisect2: variant {variant!r} not in "
                         f"{VARIANTS}")
    if tile not in TILES:
        raise ValueError(f"fwd_bisect2: tile {tile} not in {tuple(TILES)}")
    if dtype not in DTYPES:
        raise ValueError(f"fwd_bisect2: dtype {dtype} not in {DTYPES}")
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"fwd_bisect2: kernel={kernel!r}: one of "
                         f"{KERNEL_CHOICES}")
    if kernel == "mma":
        _check_width(kernel, x.shape[-1], wd.shape[1])


def _check_width(kernel: str, R: int, D: int) -> None:
    if R != WIDTH or D != WIDTH:
        raise NotImplementedError(
            f"fwd_bisect2 ({kernel}) is built for R == D == {WIDTH}; got "
            f"R={R}, D={D}")


def launch_key(kernel: str, variant: str, tile: int, dtype) -> str:
    """The ``launches_by`` key of a launch: "<variant>_<tile>_<bf16|f32>"
    on simt, with "mma_" in front on mma."""
    key = f"{variant}_{tile}_{tools.DTYPE_NAMES[dtype]}"
    return key if kernel == "simt" else f"{kernel}_{key}"


def _gate(variant: str, f, g):
    if variant == "mm_only":
        return f * g
    if variant in ("one_tanh", "fat_1t"):
        return torch.tanh(f) * (0.5 + 0.5 * torch.tanh(g))
    return torch.tanh(f) * torch.sigmoid(g)


@torch.no_grad()
def fwd_bisect2_reference(x, w_fg, wd, wfat, variant: str = "base",
                          tile: int = 1024, dtype=torch.float32,
                          kernel: str = "mma"):
    """Plain version of variant ``variant`` on ``kernel`` -> y [B, T, R]
    (rows are independent, so ``tile`` changes nothing here)."""
    _check(variant, tile, dtype, kernel, x, wd)
    mm = _matmul(kernel, dtype)
    R = x.shape[-1]
    L, D = wd.shape[0], wd.shape[1]
    if variant == "act_only":
        for _ in range(L):
            x = x + (torch.tanh(x) * torch.sigmoid(x))[..., :D]
        return x
    if variant in ("fat", "fat_1t"):
        w = _q(wfat, dtype)
        fat = torch.zeros(x.shape[:-1] + (2 * R + 2 * D,), dtype=x.dtype,
                          device=x.device)
        fat[..., R:2 * R] = _q(x, dtype)
        for l in range(L):
            out = mm(fat, w[l])
            z = _gate(variant, out[..., :D], out[..., D:2 * D])
            fat[..., R:2 * R] = _q(out[..., 2 * D:2 * D + R], dtype)
            fat[..., 2 * R + D:] = _q(z, dtype)
        return fat[..., R:2 * R].clone()
    wq, wdq = _q(w_fg, dtype), _q(wd, dtype)
    cat = torch.zeros(x.shape[:-1] + (2 * R,), dtype=x.dtype,
                      device=x.device)
    for l in range(L):
        fg = mm(cat, wq[l])
        z = _gate(variant, fg[..., :D], fg[..., D:])
        x = x + mm(_q(z, dtype), wdq[l])
    return x


def fwd_bisect2(x, w_fg, wd, wfat, variant: str = "base", tile: int = 1024,
                dtype=torch.float32, kernel: str = "mma"):
    """One launch of variant ``variant`` on ``kernel`` at the TPU tile
    ``tile`` (64 or 128 rows per block) -> y [B, T, R]. x [B,T,R], w_fg
    [L,2R,2D], wd [L,D,R], wfat [L,2R+2D,2D+R] float32 (rounded to
    ``dtype`` here). CPU tensors run the plain version; CUDA tensors launch
    the kernel (R == D == 32) or raise."""
    _check(variant, tile, dtype, kernel, x, wd)
    if not _launch.use_kernel("fwd_bisect2", x):
        return fwd_bisect2_reference(x, w_fg, wd, wfat, variant, tile, dtype,
                                     kernel)
    B_, T, R = x.shape
    L, D = wd.shape[0], wd.shape[1]
    dev = x.device
    _check_width(kernel, R, D)
    for name, t, shape in (("x", x, (B_, T, R)),
                           ("w_fg", w_fg, (L, 2 * R, 2 * D)),
                           ("wd", wd, (L, D, R)),
                           ("wfat", wfat, (L, 2 * R + 2 * D, 2 * D + R))):
        _launch.check("fwd_bisect2", name, t, shape, dev)
    ws = [w.to(dtype).contiguous() for w in (w_fg, wd, wfat)]
    y = torch.empty_like(x)
    lib, sfx = _lib(kernel)
    err = getattr(lib, f"fwd_bisect2{sfx}_run")(
        VARIANTS.index(variant), int(TILES[tile] == 128),
        int(dtype == torch.bfloat16), x.data_ptr(),
        *(w.data_ptr() for w in ws), y.data_ptr(), B_ * T, L, R, D,
        _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"fwd_bisect2 {kernel} {variant} launch failed: "
                           f"CUDA error {err}")
    fwd_bisect2.launches += 1
    fwd_bisect2.launches_by[launch_key(kernel, variant, tile, dtype)] += 1
    return y


#: Launches made by ``fwd_bisect2``, in all and by ``launch_key``
#: ("<variant>_<tile>_<bf16|f32>" on simt, "mma_<variant>_<...>" on mma;
#: read by chip_smoke.py).
fwd_bisect2.launches = 0
fwd_bisect2.launches_by = collections.Counter()


def inputs(config, batch: int, sample: int, device):
    """The TPU tool's inputs from numpy seed 0: x ~ N(0, 1), w_fg, wd and
    wfat ~ 0.05 N(0, 1)."""
    c = config
    R, D, L = c.residual_channels, c.dilation_channels, c.num_layers
    rng = np.random.RandomState(0)
    T = c.receptive_field + sample
    x = rng.randn(batch, T, R).astype(np.float32)
    w_fg = rng.randn(L, 2 * R, 2 * D).astype(np.float32) * 0.05
    wd = rng.randn(L, D, R).astype(np.float32) * 0.05
    wfat = rng.randn(L, 2 * R + 2 * D, 2 * D + R).astype(np.float32) * 0.05
    return tuple(torch.as_tensor(a).to(device) for a in (x, w_fg, wd, wfat))


def main(argv=None) -> int:
    args = tools.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device(args.device)
    print(tools.device_line(dev), flush=True)
    args_ = inputs(paper_config(), B, SAMPLE, dev)

    def line(label):
        kernel, variant, tt, dt = label.split()
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        times = tools.timed_ms(
            lambda: fwd_bisect2(*args_, variant, int(tt), dtype, kernel), dev,
            calls=10)
        return (f"[{kernel:4s} {variant:9s} Tt={int(tt):4d} {dt:4s}] median "
                f"{np.median(times):7.3f} ms "
                f"({[round(t, 3) for t in times]})")

    return tools.run_table([f"{k} {v} {tt} {d}" for k in KERNEL_CHOICES
                            for d in ("bf16", "f32")
                            for v, tt in MAIN_CASES], line)


if __name__ == "__main__":
    raise SystemExit(main())
