"""Probe: the tiles decode kernel beside its phase probe, timed in turns.

The tiles kernel (``csrc/sampler_tiles.cuh``) built with
``-DSAMPLER_TILES_PROBE`` (its header says where) has thread 0 of each CTA
of the first cluster add up the SM clocks of each phase of every step.
This tool builds that probe of each mode with ``nvcc`` into the build
directory (``csrc/sampler_tiles.cu`` for float32 weights,
``csrc/sampler_tiles_bf16.cu`` for bf16), holds the kernel (``base``, as
``_build`` builds it) and the probe against ``decode_reference``
teacher-forced at the gc config (32 steps; the bf16 window reports its
error, which carries rounding flips through the ring) and against each
other bit for bit (the probe's clock must not change what the kernel
computes), times a decode step of both in turns (base, probe, probe, base)
at gc b128, b256 and b512 on one card, and prints one JSON line per mode
and batch with the clocks a step spends in each phase of each CTA
(``PHASES``); the clocks of one CTA add up to its step.

    python -m wavenet_torch.tools.tiles_variants [--steps 1024]
        [--batches 128 256 512] [--modes f32 bf16]

Needs a CUDA GPU and nvcc: the kernel and its probe have no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from wavenet_torch.kernels import _build
from wavenet_torch.kernels import sampler as ks

#: The probe's phases (the kernel's enum Phase); the layer phases add up
#: over a CTA's layers.
PHASES = ("ring_adds_wait", "fg_product", "fg_sync",
          "dense_product", "dense_sync", "handoff_skip", "barrier1",
          "skip_sum", "gather_h1", "post1", "gather_h2", "post2",
          "gumbel_argmax", "barrier6_pick")
BATCHES = (128, 256, 512)
STEPS = 1024
#: Each mode's library, as ``_build`` names it, and its weight type.
MODES = {"f32": ("sampler_tiles", torch.float32),
         "bf16": ("sampler_tiles_bf16", torch.bfloat16)}


def build_probe(mode: str = "f32") -> ctypes.CDLL:
    """The mode's source with ``-DSAMPLER_TILES_PROBE``, hashed by its
    sources and flags like ``_build``'s libraries."""
    name = MODES[mode][0]
    src = os.path.join(_build.CSRC, name + ".cu")
    flags = list(_build.NVCC_FLAGS) + ["-DSAMPLER_TILES_PROBE", "-I",
                                       _build.CSRC]
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted([src] + [os.path.join(_build.CSRC, f)
                                for f in os.listdir(_build.CSRC)
                                if f.endswith(".cuh")]):
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_build.build_dir(), "tiles_variants")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_probe-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        t = time.perf_counter()
        proc = subprocess.run([_build._nvcc(), *flags, "-o", lib, src],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {mode} probe:\n{log}")
        print(json.dumps({"build": f"probe_{mode}",
                          "seconds": time.perf_counter() - t,
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]}),
              flush=True)
    out = ctypes.CDLL(lib)
    ks._bind_tiles(out, mode == "bf16")
    out.sampler_tiles_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return out


@contextlib.contextmanager
def serving(name: str, lib: ctypes.CDLL):
    """``kernel="tiles"`` launches ``lib`` in place of the library ``name``
    inside the block (through the build cache that ``_build.load``
    reads)."""
    with _build._LOCK:
        saved = _build._LIBS.get(name)
        _build._LIBS[name] = lib
    try:
        yield
    finally:
        with _build._LOCK:
            if saved is None:
                _build._LIBS.pop(name, None)
            else:
                _build._LIBS[name] = saved


def _case(c, params, B: int, weight_dtype, prefill: int = 300):
    from wavenet_torch.models.wavenet import embed_gc
    rng = np.random.RandomState(B)
    codes = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                        (B, prefill + 32)),
                            dtype=torch.int32, device="cuda")
    gids = torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                           device="cuda")
    carry = ks.prefill_carry(params, c, codes[:, :prefill], gids)
    packed = ks.pack_sampler_weights(params, c, B, embed_gc(params, c, gids),
                                     weight_dtype=weight_dtype)
    return packed, carry, codes[:, prefill - 1:].contiguous()


def _ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def run(steps: int = STEPS, batches=BATCHES, modes=tuple(MODES)):
    """Build, check and time each mode's kernel and its probe; returns the
    rows. Each row also says whether the probe's codes and logits equal the
    kernel's bit for bit."""
    from wavenet_torch.models.config import gc_config
    from wavenet_torch.models.wavenet import init_params
    if not torch.cuda.is_available():
        raise RuntimeError("tiles_variants needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = gc_config()
    params = init_params(0, c, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for k in sorted(params):
        if k.endswith("_bias"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    params = {k: v.cuda() for k, v in params.items()}
    rows = []
    for mode in modes:
        rows += _run_mode(mode, c, params, steps, batches)
    return rows


def _run_mode(mode: str, c, params, steps: int, batches):
    """:func:`run`'s rows of one mode ("f32" or "bf16")."""
    lib_name, wt = MODES[mode]
    libs = {"base": _build.load(lib_name), "probe": build_probe(mode)}
    ks._bind_tiles(libs["base"], mode == "bf16")
    names = list(libs)
    rows = []
    for B in batches:
        packed, carry, forced = _case(c, params, B, wt)
        ring, causal = carry.ring.clone(), carry.causal.clone()
        _, ref = ks.decode_reference(packed, c, ring, causal, forced, 32,
                                     carry.t_abs, 3, collect_logits=True)
        row = {"config": "gc", "mode": mode, "batch": B, "steps": steps,
               "plan": ks.device_tile_plan(c, B, weight_dtype=wt).RB}
        first = forced[:, :1].contiguous()
        outs = {}
        for name in names + names[::-1]:
            with serving(lib_name, libs[name]):
                if name not in outs:
                    ring, causal = carry.ring.clone(), carry.causal.clone()
                    _, lg = ks.decode(packed, c, ring, causal, forced, 32,
                                      carry.t_abs, 3, collect_logits=True,
                                      kernel="tiles")
                    ring, causal = carry.ring.clone(), carry.causal.clone()
                    codes, _ = ks.decode(packed, c, ring, causal, first, 256,
                                         carry.t_abs, 7, kernel="tiles")
                    outs[name] = (lg, codes)
                    row[f"max_abs_err_{name}"] = (lg - ref).abs().max().item()
                ring, causal = carry.ring.clone(), carry.causal.clone()
                ks.decode(packed, c, ring, causal, first, 16, 0, 5,
                          kernel="tiles")
                ms = _ms(lambda: ks.decode(packed, c, ring, causal, first,
                                           steps, 0, 5, kernel="tiles"))
            row.setdefault(f"ms_per_step_{name}", []).append(ms / steps)
        (lg0, codes0), (lg1, codes1) = outs["base"], outs["probe"]
        row["bitwise_equal_to_base"] = (torch.equal(lg0, lg1)
                                        and torch.equal(codes0, codes1))
        probe = libs["probe"]
        buf = (ctypes.c_ulonglong * (8 * len(PHASES)))()
        probe.sampler_tiles_phase_cycles(buf, 1)
        with serving(lib_name, probe):
            ring, causal = carry.ring.clone(), carry.causal.clone()
            ks.decode(packed, c, ring, causal, first, steps, 0, 5,
                      kernel="tiles")
        torch.cuda.synchronize()
        probe.sampler_tiles_phase_cycles(buf, 1)
        cyc = np.array(buf[:], dtype=np.float64).reshape(8, -1) / steps
        row["probe_cycles_per_step"] = {
            f"cta{r}": dict(zip(PHASES, cyc[r].tolist())) for r in range(8)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    p.add_argument("--modes", nargs="+", default=list(MODES),
                   choices=list(MODES))
    args = p.parse_args(argv)
    run(args.steps, args.batches, args.modes)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
