"""Times of a stack kernel at a config's b8 train shape, for one or more
checkouts of the repository in turns, on one card: ``--stack mma`` (the
default) times ``fused_stack_mma`` (forward and backward, in the modes of
``--modes``: f32 and bf16), ``--stack simt`` ``fused_stack.cu`` the same
way (pinned, ``kernel="simt"``), ``--stack tiled``
``fused_stack_tiled.cu`` the same way (pinned, at b1: the sharded
config's train shape; ``--config sharded`` or ``w128``, the wide config
at R = D = 128), ``--stack carry`` the carry kernel behind
the retired generations
(``experiments.fused_stack.carry_forward`` without z, as v1 calls it, and
with z, as v2 does, and ``carry_backward``), ``--stack layer`` the
one-layer kernel (``experiments.dilated_layer.forward`` and ``backward``,
names every tree since the layer kernel has) at each distinct dilation of
the config, with the mean over them, in the modes of ``--modes`` (f32 by
default: a tree before the layer kernel's bf16 mode has no other).
``--modes f32`` compares a tree whose kernel has no bf16 mode yet.
``--width R D`` replaces the config's residual and dilation channels (the
ragged widths of the tiled kernel, e.g. 128 64 or 6 16 at the wide
config's depth).

    python -m wavenet_torch.tools.stack_times --config gc \\
        --trees parent/ . . parent/
    python -m wavenet_torch.tools.stack_times --stack carry --config gc \\
        --trees parent/ . . parent/
    python -m wavenet_torch.tools.stack_times --stack layer --config gc \\
        --trees parent/ . . parent/
    python -m wavenet_torch.tools.stack_times --stack simt --config tiny \\
        --modes f32 --trees parent/ . . parent/
    python -m wavenet_torch.tools.stack_times --stack tiled --config sharded
    python -m wavenet_torch.tools.stack_times --stack tiled --config w128
    python -m wavenet_torch.tools.stack_times --stack tiled --config wide \
        --width 6 16 --trees parent/ .

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
import sys


def _digest(t) -> str:
    import hashlib
    import torch
    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def _time_tree(label: str, config: str, reps: int, stack: str,
               modes=("f32", "bf16"), width=None) -> dict:
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
    if config == "w128":
        c32 = cfgs.wide_config(residual_channels=128, dilation_channels=128)
    else:
        c32 = getattr(cfgs, f"{config}_config")()
    if width:
        c32 = dataclasses.replace(c32, residual_channels=width[0],
                                  dilation_channels=width[1])
    B = 1 if stack == "tiled" else 8
    T = c32.receptive_field + 16000 - 1
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

    row = {"tree": label, "stack": stack, "config": config,
           "residual_channels": R, "dilation_channels": D, "batch": B,
           "positions": T, "gpu": torch.cuda.get_device_name(0)}
    if stack == "layer":
        return _time_layers(row, c32, x, w_fg, wd, add, bd, dy,
                            rn(B, T, D), ms, modes)
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
    # mma: the route every tree takes at gc and wide; simt and tiled pinned.
    kw = {"kernel": stack} if stack in ("simt", "tiled") else {}
    for mode in modes:
        c = c32 if mode == "f32" else dataclasses.replace(
            c32, compute_dtype="bfloat16")
        y, fg, z = fs.forward(x, w_fg, wd, add, bd, c, **kw)
        dzm = dz.to(fs.record_dtype(c))
        grads = fs.backward(y, dy, fg, dzm, w_fg, wd, bd, c, **kw)
        for name, t in zip(("y", "fg", "z", "dx", "dw_fg", "dwd", "dadd",
                            "dbd"), (y, fg, z) + tuple(grads)):
            row[f"digest_{name}_{mode}"] = _digest(t)
        row[f"fwd_ms_{mode}"] = ms(lambda: fs.forward(x, w_fg, wd, add, bd,
                                                      c, **kw))
        row[f"bwd_ms_{mode}"] = ms(lambda: fs.backward(y, dy, fg, dzm, w_fg,
                                                       wd, bd, c, **kw))
    return row


def _device_ms(fn, calls: int = 20, runs: int = 3) -> float:
    """Device time (ms) of one call of ``fn``, the median over ``runs``
    runs of ``calls`` calls back to back: CUDA events around each run,
    queued behind a spin kernel (``torch.cuda._sleep``) that holds the card
    until the host has queued the whole run, so that a call's host work
    (the wrapper's checks and allocations) does not show; the gaps between
    the calls' kernels do. Raises if the host took longer to queue a run
    than the spin held the card."""
    import time

    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()          # the spin starts after t0
        s.record()
        torch.cuda._sleep(50_000_000)     # ~25 ms at the H100's 1.98 GHz
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if host_ms >= s.elapsed_time(a):
            raise SystemExit("stack_times: the spin ended before the host "
                             "had queued the run")
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _time_layers(row, c, x, w_fg, wd, add, bd, dy, dz, ms, modes) -> dict:
    """The one-layer kernel at each distinct dilation of ``c`` (the
    weights of its first layer of that dilation), in each mode of
    ``modes`` (keys of the bf16 mode end in ``_bf16``): the median ms of
    each direction per dilation and their mean, by CUDA events around one
    call (host work of the wrapper included) and as device time
    (``*_device_ms``, ``_device_ms``: calls queued back to back behind a
    held card), and one digest of each output over the dilations in
    order."""
    base = dict(row)
    for mode in modes:
        sfx = "" if mode == "f32" else f"_{mode}"
        part = _time_layers_mode(dict(base), c, x, w_fg, wd, add, bd, dy, dz,
                                 ms, mode)
        row.update({k + sfx: v for k, v in part.items() if k not in base})
    return row


def _time_layers_mode(row, c, x, w_fg, wd, add, bd, dy, dz, ms,
                      mode) -> dict:
    """``_time_layers`` in one mode (f32: the call every tree takes, with
    no compute_dtype)."""
    import hashlib

    import numpy as np
    import torch

    from wavenet_torch.experiments import dilated_layer as dl

    kw = {} if mode == "f32" else {"compute_dtype": torch.bfloat16}

    R, D = c.residual_channels, c.dilation_channels
    names = ("y", "z", "dx_local", "dpast", "dw", "dwd", "dadd", "dbd")
    digests = {n: hashlib.sha256() for n in names}
    dils = sorted(set(c.dilations))
    fwd, bwd, dev_fwd, dev_bwd = [], [], [], []
    for d in dils:
        l = c.dilations.index(d)
        lay = (x, w_fg[l].view(2, R, 2 * D), wd[l], add[l], bd[l])
        outs = dl.forward(*lay, d, **kw) + tuple(
            dl.backward(*lay[:4], dy, dz, d, **kw))
        for n, t in zip(names, outs):
            digests[n].update(_digest(t).encode())
        fwd.append(ms(lambda: dl.forward(*lay, d, **kw)))
        bwd.append(ms(lambda: dl.backward(*lay[:4], dy, dz, d, **kw)))
        dev_fwd.append(_device_ms(lambda: dl.forward(*lay, d, **kw)))
        dev_bwd.append(_device_ms(
            lambda: dl.backward(*lay[:4], dy, dz, d, **kw)))
    row.update({"dilations": dils, "fwd_ms_per_dilation": fwd,
                "bwd_ms_per_dilation": bwd, "fwd_ms": float(np.mean(fwd)),
                "bwd_ms": float(np.mean(bwd)),
                "fwd_device_ms_per_dilation": dev_fwd,
                "bwd_device_ms_per_dilation": dev_bwd,
                "fwd_device_ms": float(np.mean(dev_fwd)),
                "bwd_device_ms": float(np.mean(dev_bwd))})
    row.update({f"digest_{n}": h.hexdigest()[:16]
                for n, h in digests.items()})
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="gc",
                    help="a models.config name (paper, gc, wide, "
                    "sharded) or w128")
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to time, in this order")
    ap.add_argument("--stack", default="mma",
                    choices=("mma", "simt", "tiled", "carry", "layer"),
                    help="the kernel to time")
    ap.add_argument("--modes", nargs="+", choices=("f32", "bf16"),
                    default=None, help="modes of mma, simt, tiled and layer "
                    "(default: f32 and bf16; layer: f32)")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--width", nargs=2, type=int, default=None,
                    metavar=("R", "D"),
                    help="the config's residual and dilation channels")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    modes = args.modes or (["f32"] if args.stack == "layer"
                           else ["f32", "bf16"])
    if args.child is not None:   # inside one tree's process
        print(json.dumps(_time_tree(args.child, args.config, args.reps,
                                    args.stack, modes, args.width)),
              flush=True)
        return 0
    from wavenet_torch.tools import run_in_trees
    width = ["--width", *map(str, args.width)] if args.width else []
    return run_in_trees(__file__, args.trees,
                        ["--config", args.config, "--reps", str(args.reps),
                         "--stack", args.stack, "--modes", *modes, *width])


if __name__ == "__main__":
    sys.exit(main())
