"""Probe: can a dependent chain of 64-wide products avoid the block barrier?

Counterpart of ``tools/r4_matvec_probe.py`` (TPU kernel ``kernel``), ported
twice. The b1 decode step is a chain of ~60 dependent [1, 64] x [64, 64]
products (the fg and dense products of 30 layers). One launch runs N_STEPS
steps of L chained products x <- x @ w[i] * 0.25 from x = 0.01 and returns
x, on one of two kernels:

``kernel="cluster"`` (the default; ``csrc/matvec_probe_cluster.cu``): the
form of the cluster decode kernel that b1 generation runs. The products
are split in pairs over a cluster of CS CTAs (``cluster_split``: the
fewest CTAs whose shares of the weights fit shared memory; CS = 8 at
C = 64, L = 60), each CTA's weights resident in its shared memory, x
handed from CTA to CTA by ``st.async`` on an mbarrier, the last CTA back
to CTA 0 for the next step (CS hand-offs a step):

    mxu       the cluster kernel's chain form: 8 warps own C / 8 columns
              each, lanes split K, a shuffle tree, one block barrier a
              product
    vpu       one warp a CTA holds the chain in registers, alternating two
              layouts (below): shuffles only, no block barrier

``kernel="decode"`` (``csrc/matvec_probe.cu``): weights in L2, one block:

    mxu       the decode step's product form (``csrc/sampler_step.cuh``'s
              matvec at N = 64): 256 threads, K split over groups, partial
              sums through shared memory, a block barrier per product
    vpu       one warp holds the chain and alternates two layouts, as the
              TPU tool alternates row and column vectors: x replicated in
              every lane -> y distributed (w), then x distributed -> y
              replicated by a butterfly of shuffles (the transposed wt);
              no transposes, no shared memory, no block barrier

and on both ``mxu_tanh`` / ``vpu_tanh``, the same with tanh after every
even product.

The JAX tool's weights, uniform(-0.1, 0.1), take the chain to zero within
a few steps; ``main`` keeps them, and the functions take any weights (the
checks use 4 x random orthogonal matrices, which keep |x| in place).

``main`` prints the cluster table (ns a product from a one-CTA run, ns a
hand-off from the cluster's step), then the decode table:

    python -m wavenet_torch.tools.r4_matvec_probe [--device cpu]
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import numpy as np
import torch

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.sampler import CLUSTER_SIZES, layer_split

C = 64          # chain width (the fg product's width at the paper config)
L = 60          # chained products per step (30 fg + 30 dense)
N_STEPS = 16000
MODES = ("mxu", "vpu", "mxu_tanh", "vpu_tanh")
KERNELS = ("cluster", "decode")
#: Widths the kernels are built for.
WIDTHS = (32, 64)
#: Products of the one-CTA cluster run that ``main`` reads ns a product
#: from (4 pairs: a CTA's share at C = 64, L = 60, CS = 8).
ONE_CTA_L = 8


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


def pair_split(n_prod: int, cs: int):
    """The cluster kernel's split of ``n_prod`` products over ``cs`` CTAs:
    pair_begin [cs + 1], CTA k owning products [2 pair_begin[k],
    2 pair_begin[k + 1]); ``layer_split`` of the n_prod / 2 pairs (the
    fewest on the last CTAs)."""
    return layer_split(n_prod // 2, cs)


def cluster_smem_bytes(c: int, n_pairs: int) -> int:
    """Shared memory of a cluster CTA that owns ``n_pairs`` pairs of C x C
    products: the mbarrier, x twice and the weights
    (``chain_smem_bytes`` in ``csrc/matvec_probe_cluster.cu``)."""
    return 16 + 4 * (2 * c + 2 * n_pairs * c * c)


def cluster_split(n_prod: int, c: int, smem_optin: int,
                  cs: Optional[int] = None):
    """(CS, pair_begin) of the cluster kernel for ``n_prod`` products of
    width ``c`` on a device with ``smem_optin`` bytes of shared memory a
    block: ``cs`` if given, else the fewest CTAs (``CLUSTER_SIZES``) whose
    largest share fits. Raises for an odd chain, a width not built
    (``WIDTHS``), or where no cluster (or the given one) holds the
    split."""
    if n_prod < 2 or n_prod % 2:
        raise ValueError(f"matvec_probe: L must be even, got {n_prod}")
    if c not in WIDTHS:
        raise NotImplementedError(
            f"matvec_probe is built for C in {WIDTHS}; got {c}")
    for k in (CLUSTER_SIZES if cs is None else (cs,)):
        if not 1 <= k <= min(CLUSTER_SIZES[-1], n_prod // 2):
            continue
        begin = pair_split(n_prod, k)
        most = max(b - a for a, b in zip(begin, begin[1:]))
        if cluster_smem_bytes(c, most) <= smem_optin:
            return k, begin
    raise ValueError(
        f"matvec_probe: no cluster of {CLUSTER_SIZES if cs is None else cs}"
        f" CTAs holds {n_prod} products of width {c} in {smem_optin} bytes "
        "of shared memory a CTA")


def cluster_smem_optin() -> int:
    """The current CUDA device's opt-in shared memory a block, as the
    cluster kernel's library reads it (builds the library at first use)."""
    from wavenet_torch.kernels import _build
    lib = _build.load("matvec_probe_cluster")
    fn = lib.matvec_probe_cluster_smem_optin
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"matvec_probe: CUDA error {err} reading the "
                           "device's shared memory")
    return n.value


def matvec_probe(w: torch.Tensor, wt: torch.Tensor, mode: str,
                 n_steps: int, kernel: str = "cluster",
                 cs: Optional[int] = None) -> torch.Tensor:
    """One launch of mode ``mode`` on ``kernel`` ("cluster" or "decode"):
    w [L, C, C], wt = w transposed per product, float32, L even -> x
    [1, C]; ``cs`` pins the cluster's CTAs (see ``cluster_split``). CPU
    tensors run the plain version; CUDA tensors launch the kernel (C in
    ``WIDTHS``) or raise."""
    _check(mode, w)
    if kernel not in KERNELS:
        raise ValueError(f"matvec_probe: kernel {kernel!r} not in {KERNELS}")
    if not _launch.use_kernel("matvec_probe", w):
        return matvec_probe_reference(w, wt, mode, n_steps)
    n_prod, c = w.shape[0], w.shape[1]
    if c not in WIDTHS:
        raise NotImplementedError(
            f"matvec_probe is built for C in {WIDTHS}; got {c}")
    for name, t in (("w", w), ("wt", wt)):
        _launch.check("matvec_probe", name, t, (n_prod, c, c), w.device)
    from wavenet_torch.kernels import _build
    p, i = ctypes.c_void_p, ctypes.c_int
    out = torch.empty((1, c), dtype=torch.float32, device=w.device)
    args = (MODES.index(mode), w.data_ptr(), wt.data_ptr(), out.data_ptr(),
            c, n_prod, n_steps)
    if kernel == "cluster":
        k, begin = cluster_split(n_prod, c, cluster_smem_optin(), cs)
        lib = _build.load("matvec_probe_cluster")
        fn = lib.matvec_probe_cluster_run
        fn.argtypes = [i, p, p, p, i, i, i, i, p, p]
        fn.restype = i
        err = fn(*args, k, (ctypes.c_int * len(begin))(*begin),
                 _launch.stream(w.device))
    else:
        lib = _build.load("matvec_probe")
        fn = lib.matvec_probe_run
        fn.argtypes = [i, p, p, p, i, i, i, p]
        fn.restype = i
        err = fn(*args, _launch.stream(w.device))
    if err != 0:
        raise RuntimeError(f"matvec_probe {kernel} {mode} launch failed: "
                           f"CUDA error {err}")
    matvec_probe.launches += 1
    matvec_probe.launches_by[mode if kernel == "decode"
                             else f"cluster_{mode}"] += 1
    return out


#: Launches made by ``matvec_probe``, in all and by mode ("<mode>" on the
#: decode kernel, "cluster_<mode>" on the cluster kernel; read by
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
    w1, wt1 = w[:ONE_CTA_L].contiguous(), wt[:ONE_CTA_L].contiguous()
    n = args.steps

    def ms_of(kernel, mode, ww, wwt, cs=None):
        return float(np.median(tools.timed_ms(
            lambda: matvec_probe(ww, wwt, mode, n, kernel, cs), dev)))

    def cluster_line(label):
        mode = label.split()[1]
        cs = (None if dev.type == "cpu" else
              cluster_split(L, C, cluster_smem_optin())[0])
        ms = ms_of("cluster", mode, w, wt)
        one = ms_of("cluster", mode, w1, wt1, 1) / ONE_CTA_L   # a product
        us = ms / n * 1e3
        hand = ("" if cs is None else
                f"  {(us - L * one / n * 1e3) / cs * 1e3:6.1f} ns/hand-off "
                f"(CS {cs})")
        return (f"[cluster] {mode:10s} {ms:8.1f} ms  {us:6.2f} us/step  "
                f"{one / n * 1e6:6.1f} ns/product{hand}")

    def decode_line(label):
        mode = label.split()[1]
        ms = ms_of("decode", mode, w, wt)
        us = ms / n * 1e3
        return (f"[decode ] {mode:10s} {ms:8.1f} ms  {us:6.2f} us/step  "
                f"{us / L * 1e3:6.1f} ns/product")

    print(f"cluster: ns/product = a one-CTA launch of the first {ONE_CTA_L} "
          f"products (CS 1) / {ONE_CTA_L}; ns/hand-off = (a step of all {L} "
          f"products on the cluster - {L} x ns/product) / CS", flush=True)
    rc = tools.run_table([f"cluster {m}" for m in MODES], cluster_line)
    print(f"decode: ns/product = a step / {L}", flush=True)
    return tools.run_table([f"decode {m}" for m in MODES], decode_line) or rc


if __name__ == "__main__":
    raise SystemExit(main())
