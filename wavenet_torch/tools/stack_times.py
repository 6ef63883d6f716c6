"""Times of the stack kernel ``fused_stack_mma`` (forward and backward, f32
and bf16 modes) at a config's b8 train shape, for one or more checkouts of
the repository in turns, on one card.

    python -m wavenet_torch.tools.stack_times --config gc \\
        --trees parent/ . . parent/

Each tree runs in a process of its own whose working directory and
``PYTHONPATH`` are that tree, so it imports and builds that tree's
``wavenet_torch`` (its own ``csrc``, into its own build directory); the
order given is the order run (parent, change, change, parent compares two
commits on one card). Only ``wavenet_torch`` names that every tree since
the bf16 mode has are used (``kernels.fused_stack.forward``/``backward``/
``pack_stack_weights``/``record_dtype``, ``models.config``,
``models.wavenet.init_params``). The inputs are seeded: the causal layer's
output is stood in for by N(0, 0.5) activations, dy and dz are N(0, 1).
Each row is one JSON line: the tree, the card, and the median ms of
``--reps`` calls of each (CUDA events). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _time_tree(label: str, config: str, reps: int) -> dict:
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

    row = {"tree": label, "config": config, "batch": B, "positions": T,
           "gpu": torch.cuda.get_device_name(0)}
    for mode in ("f32", "bf16"):
        c = c32 if mode == "f32" else dataclasses.replace(
            c32, compute_dtype="bfloat16")
        y, fg, _ = fs.forward(x, w_fg, wd, add, bd, c)
        dzm = dz.to(fs.record_dtype(c))
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
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:   # inside one tree's process
        print(json.dumps(_time_tree(args.child, args.config, args.reps)),
              flush=True)
        return 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--config", args.config, "--reps", str(args.reps)],
            cwd=tree, env=env)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
