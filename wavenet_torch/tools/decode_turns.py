"""Output digests and step times of the cluster and tiles decode kernels'
production modes, for one or more checkouts of the repository in turns, on
one card.

Each case is one launch of ``decode_sequential`` from a zero state on
seeded weights (non-zero biases), the first ``PREFIX`` inputs forced and
the rest sampled, with every step's logits. On the cluster kernel
(``kernel="cluster"``):

    paper_b1   the paper config at b1, float32 and bf16 weights
    gc_b64     the gc config (global conditioning) at b64, both types
    wide_b1    the wide config (scalar input) at b1, both types
    lc_b1      the paper config with local conditioning (80 channels) at
               b1, both types

so ``sampler_cluster``, ``sampler_cluster_bf16``, ``sampler_cluster_lc``
and ``sampler_cluster_lc_bf16`` each run at their compiled widths and at
runtime widths. On ``sampler_decode`` (``kernel="decode"``,
``DECODE_CASES``):

    lc_b256    the LC config at b256, both types (the LC modes of
               ``sampler_decode``, which serve LC above the cluster range)

On the tiles kernel's range (``TILE_CASES``):

    gc_b128    the gc config at b128, float32 on ``kernel="tiles"`` and
               bf16 on ``kernel="auto"`` (the kernel the route takes:
               ``sampler_decode``'s bf16 mode before the tiles kernel had
               one, ``sampler_tiles_bf16`` since)
    gc_b512    the same at b512

A digest is the SHA-256 (16 hex digits) of the codes' and the logits'
bytes: two trees' kernels compute the same thing where every digest
agrees (a bf16 digest on ``kernel="auto"`` changes where the route does).
A tree that refuses a case (LC at bf16 weights before its modes existed)
gets ``null`` there.
The paper b1 step (cluster) and each tiles case's step are then timed at
both weight types (CUDA events, the median of ``--reps`` launches of
``STEPS`` steps), and each row names the kernel every case launched.

    python -m wavenet_torch.tools.decode_turns --trees parent/ . . parent/

Each tree runs in a process of its own whose working directory and
``PYTHONPATH`` are that tree, so it imports and builds that tree's
``wavenet_torch`` (as ``stack_times`` does); the order given is the order
run (parent, change, change, parent compares two commits on one card).
Only names that every tree since the LC mode has are used
(``kernels.sampler``'s ``pack_sampler_weights``, ``decode_sequential``,
``models.config``, ``models.wavenet``'s ``init_params`` and ``embed_gc``).
Each tree prints one JSON line. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

PREFIX, STEPS_DIGEST, STEPS = 8, 512, 2048
SEED = 5
LC_CHANNELS = 80
#: (case, weight types) whose digests are taken on the cluster kernel.
CASES = (("paper_b1", ("f32", "bf16")), ("gc_b64", ("f32", "bf16")),
         ("wide_b1", ("f32", "bf16")), ("lc_b1", ("f32", "bf16")))
#: (case, weight types) whose digests are taken on sampler_decode.
DECODE_CASES = (("lc_b256", ("f32", "bf16")),)
#: (case, {weight type: the kernel pinned}) in the tiles kernel's range.
TILE_CASES = (("gc_b128", {"f32": "tiles", "bf16": "auto"}),
              ("gc_b512", {"f32": "tiles", "bf16": "auto"}))


def _digest(*tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()[:16]


def _params(c, seed: int):
    """``init_params(seed)`` with N(0, 0.1) biases (and LC weights
    perturbed by N(0, 0.05)) from torch seed ``seed + 1``, on the card."""
    import torch
    from wavenet_torch.models.wavenet import init_params
    p = init_params(seed, c, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sorted(p):
        if k.endswith("_bias"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=gen)
    for k in ("lc_filter", "lc_gate"):
        if k in p:
            p[k] = p[k] + 0.05 * torch.randn(p[k].shape, generator=gen)
    return {k: v.cuda() for k, v in p.items()}


def case(name: str, dt: str, n: int = STEPS_DIGEST):
    """(config, packed weights, forced inputs, lc stream or None) of a
    case at ``dt`` weights, seeded from SEED."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models import config as cfgs
    from wavenet_torch.models.wavenet import embed_gc
    config, batch = name.split("_b")
    c = {"paper": cfgs.paper_config, "gc": cfgs.gc_config,
         "wide": cfgs.wide_config,
         "lc": lambda: cfgs.paper_config(lc_channels=LC_CHANNELS)}[config]()
    B = int(batch)
    params = _params(c, SEED)
    rng = np.random.RandomState(SEED)
    if c.scalar_input:
        forced = torch.as_tensor(rng.uniform(-0.9, 0.9, (B, PREFIX))
                                 .astype(np.float32), device="cuda")
    else:
        forced = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                             (B, PREFIX)),
                                 dtype=torch.int32, device="cuda")
    gc = None
    if c.gc_enabled:
        ids = torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                              device="cuda")
        gc = embed_gc(params, c, ids)
    lc = None
    if c.lc_enabled:
        lc = torch.as_tensor(rng.uniform(-1, 1, (n, B, c.lc_channels))
                             .astype(np.float32), device="cuda")
    wt = torch.bfloat16 if dt == "bf16" else torch.float32
    packed = ks.pack_sampler_weights(params, c, B, gc, weight_dtype=wt)
    return c, packed, forced, lc


def _launched(fn):
    """``fn()``, and the kernel it launched as ``decode_sequential`` counts
    it (its ``launches_by`` key)."""
    from wavenet_torch.kernels import sampler as ks
    before = dict(ks.decode_sequential.launches_by)
    out = fn()
    ran = [k for k, v in ks.decode_sequential.launches_by.items()
           if v != before.get(k, 0)]
    return out, ",".join(sorted(ran))


def digest(name: str, dt: str, kernel: str = "cluster") -> str:
    """The digest of a case's codes and logits (``STEPS_DIGEST`` steps, one
    launch on ``kernel``)."""
    from wavenet_torch.kernels import sampler as ks
    c, packed, forced, lc = case(name, dt)
    kw = {} if lc is None else {"lc": lc}
    codes, logits = ks.decode_sequential(
        packed, c, forced, STEPS_DIGEST, SEED, collect_logits=True,
        kernel=kernel, **kw)
    return _digest(codes, logits)


def _digest_or_none(name: str, dt: str, kernel: str):
    """``digest``, or None where the tree refuses the case."""
    try:
        return digest(name, dt, kernel)
    except NotImplementedError:
        return None


def digests() -> dict:
    """``{"<case>_<f32|bf16>": digest}`` of every cluster case."""
    return {f"{name}_{dt}": _digest_or_none(name, dt, "cluster")
            for name, dts in CASES for dt in dts}


def step_ms(dt: str, reps: int, name: str = "paper_b1",
            kernel: str = "cluster") -> float:
    """The median ms a step of ``STEPS``-step launches of a case."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks
    c, packed, forced, _ = case(name, dt)

    def run():
        ks.decode_sequential(packed, c, forced, STEPS, SEED, kernel=kernel)

    run()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / STEPS)
    return float(np.median(times))


def _tree_row(label: str, reps: int) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_turns: needs a CUDA GPU")
    row = {"tree": label, "gpu": torch.cuda.get_device_name(0)}
    row["digests"] = digests()
    row.update({f"paper_b1_{dt}_ms_per_step": step_ms(dt, reps)
                for dt in ("f32", "bf16")})
    row["decode_digests"], row["decode_kernels"] = {}, {}
    for name, dts in DECODE_CASES:
        for dt in dts:
            key = f"{name}_{dt}"
            row["decode_digests"][key], row["decode_kernels"][key] = (
                _launched(lambda: _digest_or_none(name, dt, "decode")))
    row["tile_digests"], row["tile_kernels"] = {}, {}
    for name, kernels in TILE_CASES:
        for dt, kernel in kernels.items():
            key = f"{name}_{dt}"
            row["tile_digests"][key], row["tile_kernels"][key] = _launched(
                lambda: digest(name, dt, kernel))
            row[f"{key}_ms_per_step"] = step_ms(dt, reps, name, kernel)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to run, in this order")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:   # inside one tree's process
        print(json.dumps(_tree_row(args.child, args.reps)), flush=True)
        return 0
    from wavenet_torch.tools import run_in_trees
    return run_in_trees(__file__, args.trees, ["--reps", str(args.reps)])


if __name__ == "__main__":
    sys.exit(main())
