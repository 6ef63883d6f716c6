"""Probe: can a dependent chain of 64-wide products avoid the block barrier?

Counterpart of ``tools/r4_matvec_probe.py`` (TPU kernel ``kernel``), ported
into ``csrc/matvec_probe.cu``. The b1 decode step is a chain of ~60
dependent [1, 64] x [64, 64] products (the fg and dense products of 30
layers). One launch runs N_STEPS steps of L chained products
x <- x @ w[i] * 0.25 from x = 0.01 and returns x:

    mxu       the decode step's product form (``csrc/sampler_step.cuh``'s
              matvec at N = 64): 256 threads, K split over groups, partial
              sums through shared memory, a block barrier per product
    vpu       one warp holds the chain and alternates two layouts, as the
              TPU tool alternates row and column vectors: x replicated in
              every lane -> y distributed (w), then x distributed -> y
              replicated by a butterfly of shuffles (the transposed wt);
              no transposes, no shared memory, no block barrier
    mxu_tanh  mxu with tanh after every even product
    vpu_tanh  vpu with the same tanh

The JAX tool's weights, uniform(-0.1, 0.1), take the chain to zero within
a few steps; ``main`` keeps them, and the functions take any weights (the
checks use 4 x random orthogonal matrices, which keep |x| in place).

    python -m wavenet_torch.tools.r4_matvec_probe [--device cpu]
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch

C = 64          # chain width (the fg product's width at the paper config)
L = 60          # chained products per step (30 fg + 30 dense)
N_STEPS = 16000
MODES = ("mxu", "vpu", "mxu_tanh", "vpu_tanh")


def _check(mode: str, w: torch.Tensor) -> None:
    if mode not in MODES:
        raise ValueError(f"matvec_probe: mode {mode!r} not in {MODES}")
    if w.dim() != 3 or w.shape[1] != w.shape[2] or w.shape[0] % 2:
        raise ValueError("matvec_probe: w must be [L, C, C] with L even, "
                         f"got {tuple(w.shape)}")


@torch.no_grad()
def matvec_probe_reference(w: torch.Tensor, wt: torch.Tensor, mode: str,
                           n_steps: int) -> torch.Tensor:
    """Plain version of mode ``mode`` -> x [1, C] after ``n_steps`` steps.
    The mxu modes are row-vector products; the vpu modes the TPU tool's
    broadcast-multiply-reduce products over w and wt alternately."""
    _check(mode, w)
    n_prod, c = w.shape[0], w.shape[1]
    tanh = mode.endswith("_tanh")
    x = torch.full((1, c), 0.01, dtype=torch.float32, device=w.device)
    for _ in range(n_steps):
        if mode.startswith("mxu"):
            for i in range(n_prod):
                x = x @ w[i]
                if tanh and i % 2 == 0:
                    x = torch.tanh(x)
                x = x * 0.25
        else:
            for i in range(0, n_prod, 2):
                col = (x * wt[i]).sum(dim=1, keepdim=True)     # [C, 1]
                if tanh:
                    col = torch.tanh(col)
                col = col * 0.25
                x = (col * w[i + 1]).sum(dim=0, keepdim=True) * 0.25
    return x


def matvec_probe(w: torch.Tensor, wt: torch.Tensor, mode: str,
                 n_steps: int) -> torch.Tensor:
    """One launch of mode ``mode``: w [L, C, C], wt = w transposed per
    product, float32, L even -> x [1, C]. CPU tensors run the plain
    version; CUDA tensors launch the kernel (C in (32, 64)) or raise."""
    _check(mode, w)
    if not _launch.use_kernel("matvec_probe", w):
        return matvec_probe_reference(w, wt, mode, n_steps)
    n_prod, c = w.shape[0], w.shape[1]
    if c not in (32, 64):
        raise NotImplementedError(
            f"matvec_probe is built for C in (32, 64); got {c}")
    for name, t in (("w", w), ("wt", wt)):
        _launch.check("matvec_probe", name, t, (n_prod, c, c), w.device)
    from wavenet_torch.kernels import _build
    lib = _build.load("matvec_probe")
    fn = lib.matvec_probe_run
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, i, i, i, p]
    fn.restype = i
    out = torch.empty((1, c), dtype=torch.float32, device=w.device)
    err = fn(MODES.index(mode), w.data_ptr(), wt.data_ptr(), out.data_ptr(),
             c, n_prod, n_steps, _launch.stream(w.device))
    if err != 0:
        raise RuntimeError(f"matvec_probe {mode} launch failed: CUDA error "
                           f"{err}")
    matvec_probe.launches += 1
    matvec_probe.launches_by[mode] += 1
    return out


#: Launches made by ``matvec_probe``, in all and by mode (read by
#: chip_smoke.py).
matvec_probe.launches = 0
matvec_probe.launches_by = collections.Counter()


def orthogonal_weights(n_prod: int, c: int, seed: int = 0) -> torch.Tensor:
    """4 x random orthogonal [c, c] matrices from numpy ``seed``: with the
    0.25 scale each product keeps |x|, so a long chain neither vanishes
    nor blows up."""
    rng = np.random.RandomState(seed)
    q = [np.linalg.qr(rng.randn(c, c))[0] for _ in range(n_prod)]
    return torch.as_tensor(4.0 * np.stack(q).astype(np.float32))


def main(argv=None) -> int:
    p = tools.parser(__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=N_STEPS,
                   help="steps per launch (the TPU tool's 16,000)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(tools.device_line(dev), flush=True)
    rng = np.random.RandomState(0)
    w = torch.as_tensor(rng.uniform(-0.1, 0.1, (L, C, C)).astype(np.float32),
                        device=dev)
    wt = w.transpose(1, 2).contiguous()
    n = args.steps

    def line(mode):
        ms = float(np.median(tools.timed_ms(
            lambda: matvec_probe(w, wt, mode, n), dev)))
        us = ms / n * 1e3
        return (f"{mode:10s} {ms:8.1f} ms  {us:6.2f} us/step  "
                f"{us / L * 1e3:6.1f} ns/product")

    return tools.run_table(MODES, line)


if __name__ == "__main__":
    raise SystemExit(main())
