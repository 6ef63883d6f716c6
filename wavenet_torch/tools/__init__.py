"""Probes of the port's own kernels (counterpart of the JAX package's TPU
probe tools in ``tools/``).

* ``r2_fwd_bisect``: the stack's forward layer with parts toggled off
  (``tools/r2_fwd_bisect.py``), on the kernel the stack route runs
  (``kernel="auto"``): ``fused_stack_mma``'s forward on the tensor cores,
  ``csrc/fwd_bisect_mma.cu``, or kernel 5's FP32-core one,
  ``csrc/fwd_bisect.cu``;
* ``r2_fwd_bisect2``: the forward's core math, all layers of a tile in one
  launch (``tools/r2_fwd_bisect2.py``), on the tensor cores
  (``kernel="mma"``) or the FP32 cores (``"simt"``), the same sources;
* ``r3_b1_bisect``: the b1 decode step with one part ablated
  (``tools/r3_b1_bisect.py``), on the kernel b1 generation runs
  (``kernel="auto"``): ``sampler_cluster``'s step with its phase clock,
  ``csrc/b1_bisect_cluster.cu`` / ``_bf16.cu``, or ``sampler_decode``'s,
  ``csrc/b1_bisect.cu``;
* ``r4_matvec_probe``: two forms of a dependent chain of 64-wide
  products (``tools/r4_matvec_probe.py``), weights resident in a
  cluster's shared memory (``kernel="cluster"``,
  ``csrc/matvec_probe_cluster.cu``) or in L2 (``"decode"``,
  ``csrc/matvec_probe.cu``);
* ``tiles_variants`` (the port's own, no JAX counterpart): the tiles
  decode kernel's float32 and bf16 modes (``csrc/sampler_tiles.cuh``)
  beside their phase probes (SM clocks per phase), timed in turns; GPU
  only, it prints JSON lines, not a table;
* ``stack_times`` and ``decode_turns`` (the port's own): a stack kernel's
  times, or the cluster and tiles decode kernels' output digests and step
  times, for several checkouts in turns; GPU only, JSON lines.

Each module holds its kernel's wrapper (a plain PyTorch version of every
variant, with the same signature, runs instead for CPU tensors) and a
``main()`` that prints the JAX tool's table, one line per variant (the
r2, r3 and r4 tools: one table per kernel), after the card's name and
power limit: ``python -m wavenet_torch.tools.<name>``
(``--device cpu`` times the plain versions on the host). A variant that
fails to build or launch is reported in the table, and the run then exits
non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Callable, Iterable, List

import torch


#: How the probes name the operand types in their labels and counts.
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    return p


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    runs on the host."""
    if device.type != "cuda":
        return "device: cpu (the plain PyTorch versions, host clock)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn: Callable[[], object], device: torch.device,
             calls: int = 1) -> List[float]:
    """ms per call of ``fn``, three times over ``calls`` calls each (the
    JAX tools' three repetitions), after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    out = []
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end) / calls)
        else:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append(1e3 * (time.perf_counter() - t) / calls)
    return out


def run_table(labels: Iterable[str], line: Callable[[str], str]) -> int:
    """Print ``line(label)`` for each label, or the failure; 1 if any
    failed (after the whole table), else 0."""
    failed = False
    for label in labels:
        try:
            text = line(label)
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            failed = True
            text = f"{label:13s} FAILED: {type(e).__name__}: {str(e)[:300]}"
        print(text, flush=True)
    return 1 if failed else 0


def run_in_trees(script: str, trees: Iterable[str], argv) -> int:
    """Run ``python <script> --child <tree> *argv`` for each checkout in
    ``trees``, in order, each in a process whose working directory and
    ``PYTHONPATH`` are that tree, so that it imports (and builds) that
    tree's ``wavenet_torch``. Returns the first non-zero exit code, or 0."""
    for tree in trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--child", tree,
             *argv], cwd=tree, env=dict(os.environ, PYTHONPATH=tree))
        if proc.returncode != 0:
            return proc.returncode
    return 0
