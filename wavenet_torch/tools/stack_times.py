"""Times of a stack kernel at a config's b8 train shape, for one or more
checkouts of the repository in turns, on one card: ``--stack mma`` (the
default) times ``fused_stack_mma`` (forward and backward, f32 and bf16
modes), ``--stack carry`` the carry kernel behind the retired generations
(``experiments.fused_stack.carry_forward`` without z, as v1 calls it, and
with z, as v2 does, and ``carry_backward``).

    python -m wavenet_torch.tools.stack_times --config gc \\
        --trees parent/ . . parent/
    python -m wavenet_torch.tools.stack_times --stack carry --config gc \\
        --trees parent/ . . parent/

Each tree runs in a process of its own whose working directory and
``PYTHONPATH`` are that tree, so it imports and builds that tree's
``wavenet_torch`` (its own ``csrc``, into its own build directory); the
order given is the order run (parent, change, change, parent compares two
commits on one card). Only ``wavenet_torch`` names that every tree since
the bf16 mode has are used (``kernels.fused_stack.forward``/``backward``/
``pack_stack_weights``/``record_dtype``, ``models.config``,
``models.wavenet.init_params``; for ``carry``, ``experiments.fused_stack``'s
``carry_forward``/``carry_backward``, which every tree since the carry
kernel has, and ``kernels.fused_stack.fused_stack_forward_reference``,
whose y and fg feed every tree's backward). The inputs are seeded: the
causal layer's output is stood in for by N(0, 0.5) activations, dy and dz
are N(0, 1). Each row is one JSON line: the tree, the card, and the
median ms of ``--reps`` calls of each (CUDA events), and a digest
(SHA-256, 16 hex digits) of each output's bytes, so that two trees'
outputs can be compared bit for bit. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _digest(t) -> str:
    import hashlib
    import torch
    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def _time_tree(label: str, config: str, reps: int, stack: str) -> dict:
    """In the tree's own process: the medians of each direction and mode."""
    import dataclasses

    import numpy as np
    import torch

    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.models import config as cfgs
    from wavenet_torch.models.wavenet import init_params

    if not torch.cuda.is_available():
        raise SystemExit("stack_times: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = getattr(cfgs, f"{config}_config")()
    B, T = 8, c32.receptive_field + 16000 - 1
    L, R, D = c32.num_layers, c32.residual_channels, c32.dilation_channels
    params = {k: v.cuda() for k, v in init_params(0, c32, device="cpu").items()}
    rng = np.random.RandomState(0)

    def rn(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device="cuda")

    gc = (params["gc_embedding"][torch.as_tensor(rng.randint(
        0, c32.gc_cardinality, B), device="cuda")] if c32.gc_enabled
          else None)
    x = rn(B, T, R, scale=0.5)
    w_fg, wd, add, bd = (t.contiguous() for t in fs.pack_stack_weights(
        params, c32, gc, B))
    dy, dz = rn(B, T, R), rn(B, T, L * D)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    row = {"tree": label, "stack": stack, "config": config, "batch": B,
           "positions": T, "gpu": torch.cuda.get_device_name(0)}
    if stack == "carry":
        from wavenet_torch.experiments import fused_stack as fs1
        yp, fgp, _ = fs.fused_stack_forward_reference(x, w_fg, wd, add, bd,
                                                      c32)
        outs = {"v1": fs1.carry_forward(x, w_fg, wd, add, bd, c32, False),
                "v2": fs1.carry_forward(x, w_fg, wd, add, bd, c32, True)}
        grads = fs1.carry_backward(yp, dy, fgp, dz, w_fg, wd, bd, c32)
        for v in ("v1", "v2"):
            for name, t in zip(("y", "fg", "z"), outs[v]):
                if t is not None:
                    row[f"digest_{name}_{v}"] = _digest(t)
            row[f"fwd_ms_{v}"] = ms(lambda: fs1.carry_forward(
                x, w_fg, wd, add, bd, c32, v == "v2"))
        for name, t in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"), grads):
            row[f"digest_{name}"] = _digest(t)
        row["bwd_ms"] = ms(lambda: fs1.carry_backward(yp, dy, fgp, dz, w_fg,
                                                      wd, bd, c32))
        return row
    for mode in ("f32", "bf16"):
        c = c32 if mode == "f32" else dataclasses.replace(
            c32, compute_dtype="bfloat16")
        y, fg, z = fs.forward(x, w_fg, wd, add, bd, c)
        dzm = dz.to(fs.record_dtype(c))
        grads = fs.backward(y, dy, fg, dzm, w_fg, wd, bd, c)
        for name, t in zip(("y", "fg", "z", "dx", "dw_fg", "dwd", "dadd",
                            "dbd"), (y, fg, z) + tuple(grads)):
            row[f"digest_{name}_{mode}"] = _digest(t)
        row[f"fwd_ms_{mode}"] = ms(lambda: fs.forward(x, w_fg, wd, add, bd,
                                                      c))
        row[f"bwd_ms_{mode}"] = ms(lambda: fs.backward(y, dy, fg, dzm, w_fg,
                                                       wd, bd, c))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="gc",
                    help="a models.config name: paper, gc, wide")
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to time, in this order")
    ap.add_argument("--stack", default="mma", choices=("mma", "carry"),
                    help="the kernel to time")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:   # inside one tree's process
        print(json.dumps(_time_tree(args.child, args.config, args.reps,
                                    args.stack)), flush=True)
        return 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--config", args.config, "--reps", str(args.reps),
             "--stack", args.stack],
            cwd=tree, env=env)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
