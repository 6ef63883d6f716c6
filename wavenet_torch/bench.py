"""The port's benchmark on one card: ``python -m wavenet_torch.bench``.

Counterpart of the root ``bench.py``, row for row and under its names:
the headline ``gen_samples_per_s_b1_paper`` (paper config, b1 x 16,000
samples, prefill then the fused decode, float32 weights), b1 sequential,
b8, the b64-b512 ladder at bf16 weights (device and delivered rates), b64
at float32 and by scan, training at bf16 b8 with MFU and at float32 b2,
the train CLI end to end, one row per configuration (gc, wide, sharded
b1, LC) and the decode's device-memory rates. It prints the full payload
on one line, writes it to ``build/bench_full_latest.json``, and prints
last one compact line with every key of the JAX bench's compact line, in
at most 1,900 characters.

Every timing starts with a warm-up call (kernel builds, library set-up).
A generation row is timed to one of two syncs: the delivered rate reads
every code back to the host (``.cpu()``); the device rate synchronizes
the card and reads one tail row. Each generation row records which decode
kernel served it (``kernels/sampler.py``'s ``launches_by`` counts), and
the payload names the card and its power limit (``nvidia-smi``).

``vs_baseline`` divides by the TF1 fast-generation rate measured on a CPU
and committed at ``baselines/tf1_fastgen.json``; without that file it
falls back to the documented estimate of 100 samples/s, as the JAX bench
does.

No row is caught: a row that raises ends the run with its traceback and a
non-zero exit, and the caller's ``timeout`` stands in for a watchdog. The
row functions take ``device=`` so that the tests run them on the CPU at a
tiny size; ``main`` is meant for the card. ``chip_smoke.py``'s bench
phase runs every row at ``SHORT`` lengths (2,000 samples, the scan rows
200, one rep, two train steps, ten CLI steps). The decode kernels are
built first, in parallel; the payload gives the seconds of each part
(``seconds_by_part``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc as _gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from wavenet_torch import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF1_FAST_GEN_FALLBACK = 100.0   # the documented estimate (BASELINE.md)
FULL_PAYLOAD = os.path.join("build", "bench_full_latest.json")
COMPACT_LIMIT = 1900
LADDER = (64, 128, 256, 512)


class GenRow(NamedTuple):
    rate: float                 # median samples/s over the reps
    rates_per_rep: List[float]
    kernels: Dict[str, Dict[str, int]]   # decode launches, by wrapper


class TrainRow(NamedTuple):
    rate: float                 # median audio-seconds/s over the reps
    mfu: Optional[float]        # against the card's bf16 peak
    rates_per_rep: List[float]


@dataclasses.dataclass(frozen=True)
class Scale:
    """Lengths and repeats of the rows (the JAX bench's by default). The
    scan rows run at most ``scan_samples`` samples."""
    gen_samples: int = 16000
    scan_samples: int = 16000
    gen_reps: int = 3
    train_steps: int = 10
    train_reps: int = 3
    cfg_train_steps: int = 5
    cfg_train_steps_k4: int = 8
    e2e_steps: int = 40


# The scan sampler steps in eager PyTorch (~8-19 ms a step on an H100), so
# the short scale cuts its rows hardest.
SHORT = Scale(gen_samples=2000, scan_samples=200, gen_reps=1, train_steps=2,
              train_reps=1, cfg_train_steps=2, cfg_train_steps_k4=4,
              e2e_steps=10)
# The decode kernels that the generation rows launch (``sampler_tiles``
# also for the route's residency counts of its bf16 mode).
DECODE_KERNELS = ("sampler_decode", "sampler_cluster", "sampler_cluster_bf16",
                  "sampler_cluster_lc", "sampler_tiles", "sampler_tiles_bf16")


def tf1_baseline_samples_per_s(path: Optional[str] = None):
    """(rate, kind): the TF1 fast-generation rate committed at
    ``baselines/tf1_fastgen.json`` ("measured"), or the documented
    estimate ("estimate") if the file is absent or unreadable."""
    path = path or os.path.join(ROOT, "baselines", "tf1_fastgen.json")
    try:
        with open(path) as f:
            return float(json.load(f)["samples_per_s"]), "measured"
    except (OSError, KeyError, ValueError):
        return TF1_FAST_GEN_FALLBACK, "estimate"


def device_info(device) -> dict:
    """The card's name, count and power limit (``nvidia-smi``), or the
    CPU's name."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "name": "cpu"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": out[0]}


def _sync_full(out):
    """Delivered rate: every code read back to the host."""
    codes = out[0] if isinstance(out, tuple) else out
    return codes.cpu().sum()


def _sync_tail(out):
    """Device rate: the card synchronized, one tail row read back (the
    whole launch must have finished to produce it)."""
    codes = out[0] if isinstance(out, tuple) else out
    if codes.device.type == "cuda":
        torch.cuda.synchronize(codes.device)
    return codes[:, -1].cpu()


def _timed(fn, *, reps: int = 1, sync=_sync_full):
    """(median, per-rep list) of fn()'s wall time, each ended by
    ``sync``, after one warm-up call."""
    sync(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def _make_config(name: str, **kw):
    from wavenet_torch.models.config import CONFIGS, paper_config
    if name == "lc":
        # The LC measurement shape: paper + 80 log-mels (wavenet_torch.
        # features' defaults).
        return paper_config(lc_channels=80, **kw)
    return CONFIGS[name](**kw)


def _launches() -> Dict[str, collections.Counter]:
    from wavenet_torch.kernels import sampler as ks
    return {"decode": collections.Counter(ks.decode.launches_by),
            "decode_sequential":
                collections.Counter(ks.decode_sequential.launches_by)}


def _served(before: Dict[str, collections.Counter]):
    """Decode launches since ``before``, by wrapper and kernel."""
    out = {}
    for wrapper, now in _launches().items():
        diff = now - before[wrapper]
        if diff:
            out[wrapper] = dict(diff)
    return out


def _build_kernels(device) -> float:
    """Build the decode kernels the rows launch, one nvcc each, in
    parallel, so that no row's warm-up waits on a build; the seconds."""
    if torch.device(device).type != "cuda":
        return 0.0
    from concurrent.futures import ThreadPoolExecutor

    from wavenet_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(DECODE_KERNELS)) as pool:
        list(pool.map(_build.load, DECODE_KERNELS))  # raises a failed build
    return time.perf_counter() - t0


def _free(device) -> None:
    """Release the last row's tensors before the next row."""
    _gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def bench_generation_cuda(batch_size: int, n_samples: int = 16000,
                          weight_dtype=None, prefill: bool = False,
                          config_name: str = "paper", gc: bool = False,
                          lc: bool = False, reps: int = 3,
                          sync: str = "full", device="cuda") -> GenRow:
    """``kernels.sampler.generate_cuda`` at the JAX bench's arguments
    (seed 2, ``gc_ids = arange(B) % cardinality``, LC uniform(-1, 1) from
    ``RandomState(0)``). ``sync``: "full" (the delivered rate) or
    "device"."""
    from wavenet_torch.kernels.sampler import generate_cuda
    from wavenet_torch.models.wavenet import init_params

    dev = resolve_device(device)
    config = _make_config(config_name)
    params = init_params(0, config, dev)
    kw = {}
    if weight_dtype is not None:
        kw["weight_dtype"] = weight_dtype
    if gc:
        kw["gc_ids"] = (torch.arange(batch_size, device=dev)
                        % config.gc_cardinality)
    if lc:
        kw["lc"] = torch.from_numpy(np.random.RandomState(0).uniform(
            -1, 1, (batch_size, n_samples, config.lc_channels)
        ).astype(np.float32)).to(dev)
    before = _launches()
    dt, times = _timed(lambda: generate_cuda(
        params, config, n_samples, seed=2, batch_size=batch_size,
        prefill=prefill, **kw),
        reps=reps, sync=_sync_tail if sync == "device" else _sync_full)
    return GenRow(batch_size * n_samples / dt,
                  [batch_size * n_samples / t for t in times],
                  _served(before))


def bench_generation_scan(batch_size: int, n_samples: int = 16000,
                          config_name: str = "paper", device="cuda") -> float:
    """``wavenet_torch.sample.generate`` (the scan sampler), one rep."""
    from wavenet_torch.models.wavenet import init_params
    from wavenet_torch.sample import generate

    dev = resolve_device(device)
    config = _make_config(config_name)
    params = init_params(0, config, dev)
    key = torch.Generator(device=dev).manual_seed(1)
    lc = (torch.zeros((batch_size, n_samples, config.lc_channels),
                      device=dev) if config.lc_enabled else None)
    dt, _ = _timed(lambda: generate(params, config, n_samples, key,
                                    batch_size=batch_size, lc=lc), reps=1)
    return batch_size * n_samples / dt


def bench_training(batch_size: int = 8, sample_size: int = 16000,
                   compute_dtype: str = "bfloat16",
                   config_name: str = "paper", gc: bool = False,
                   lc: bool = False, remat: bool = False, n_steps: int = 10,
                   reps: int = 1, steps_per_dispatch: int = 1,
                   device="cuda") -> TrainRow:
    """Train-step rate on the plain route (``use_pallas_stack`` off, as
    the JAX bench's): ``reps`` measurements of ``n_steps`` steps each,
    every one ended by reading the loss. ``steps_per_dispatch`` K > 1
    runs ``make_train_multistep`` (the CLI's dispatch); inputs are
    synthetic, from the JAX bench's ``RandomState`` seeds."""
    from wavenet_torch.train_lib import (
        create_train_state, make_optimizer, make_train_multistep,
        make_train_step)
    from wavenet_torch.utils.flops import mfu, train_step_flops

    dev = resolve_device(device)
    config = _make_config(config_name, compute_dtype=compute_dtype,
                          remat=remat)
    state = create_train_state(0, config, make_optimizer("adam", 1e-3), dev)
    K = steps_per_dispatch
    step = (make_train_multistep(config, None, K) if K > 1
            else make_train_step(config, None))
    T = config.receptive_field + sample_size
    lead = (K,) if K > 1 else ()
    audio = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, lead + (batch_size, T)).astype(np.float32)).to(dev)
    gc_ids = None
    if gc:
        gc_ids = torch.arange(batch_size, device=dev) % config.gc_cardinality
        if K > 1:
            gc_ids = gc_ids.expand(K, batch_size)
    lc_feats = None
    if lc:
        lc_feats = torch.from_numpy(np.random.RandomState(1).uniform(
            -1, 1, lead + (batch_size, T, config.lc_channels)).astype(
                np.float32)).to(dev)

    state, metrics = step(state, audio, gc_ids, lc_feats)     # warm-up
    metrics["loss"].cpu()
    n_disp = max(1, n_steps // K)
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n_disp):
            state, metrics = step(state, audio, gc_ids, lc_feats)
        metrics["loss"].cpu()                   # waits for the last step
        dts.append((time.perf_counter() - t0) / (n_disp * K))
    dt = float(np.median(dts))
    audio_s = batch_size * sample_size / config.sample_rate
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return TrainRow(audio_s / dt,
                    mfu(train_step_flops(config, batch_size, sample_size)
                        / dt, name),
                    [audio_s / d for d in dts])


def _round(x, nd: int = 2):
    return None if x is None else round(x, nd)


def _train_fields(row: TrainRow, nd: int = 2):
    return (_round(row.rate, nd), _round(row.mfu, 4),
            [_round(r, nd) for r in row.rates_per_rep])


def bench_config_rows(scale: Scale = Scale(), device="cuda") -> dict:
    """One train and generation row per configuration: gc (b8, b8 x K4,
    b2, b1 prefill generation), wide (b8, b2, b1 prefill generation, scan
    at 2,000 samples), sharded (b1 with remat, scan at 1,000 samples) and
    LC (b8, b1 prefill generation), every config also at b8 so that config
    effects separate from batch effects. The scan lengths are capped at
    ``scale.scan_samples``."""
    def train(n_steps=scale.cfg_train_steps, **kw):
        return _train_fields(bench_training(
            n_steps=n_steps, reps=scale.train_reps, device=device, **kw))

    def gen(config_name, **kw):
        row = bench_generation_cuda(1, scale.gen_samples, prefill=True,
                                    config_name=config_name, reps=1,
                                    device=device, **kw)
        return _round(row.rate), row.kernels

    def scan(config_name, n):
        return _round(bench_generation_scan(
            1, min(n, scale.scan_samples), config_name, device=device))

    rows = {}
    rate8, util8, reps8 = train(batch_size=8, config_name="gc", gc=True)
    # K = 4: the CLI's dispatch (make_train_multistep).
    rate8k4, util8k4, reps8k4 = train(
        scale.cfg_train_steps_k4, batch_size=8, config_name="gc", gc=True,
        steps_per_dispatch=4)
    rate2, util2, reps2 = train(batch_size=2, config_name="gc", gc=True)
    g1, k1 = gen("gc", gc=True)
    rows["gc"] = {
        "train_audio_sec_per_s_bf16_b8": rate8, "mfu_train_b8": util8,
        "train_rates_per_rep_b8": reps8,
        "train_audio_sec_per_s_bf16_b8_k4": rate8k4,
        "mfu_train_b8_k4": util8k4, "train_rates_per_rep_b8_k4": reps8k4,
        "train_audio_sec_per_s_bf16_b2": rate2, "mfu_train": util2,
        "train_rates_per_rep_b2": reps2,
        "gen_samples_per_s_b1_prefill": g1,
        "decode_kernels": {"gen_samples_per_s_b1_prefill": k1},
    }
    _free(device)
    rate8, util8, reps8 = train(batch_size=8, config_name="wide")
    rate2, util2, reps2 = train(batch_size=2, config_name="wide")
    g1, k1 = gen("wide")
    rows["wide"] = {
        "train_audio_sec_per_s_bf16_b8": rate8, "mfu_train_b8": util8,
        "train_rates_per_rep_b8": reps8,
        "train_audio_sec_per_s_bf16_b2": rate2, "mfu_train": util2,
        "train_rates_per_rep_b2": reps2,
        "gen_samples_per_s_b1_prefill": g1,
        "gen_samples_per_s_b1_scan": scan("wide", 2000),
        "decode_kernels": {"gen_samples_per_s_b1_prefill": k1},
    }
    _free(device)
    # sharded: 80 layers of 256 channels at b1 with remat (the same-chip
    # row of the JAX bench); its generation runs the scan sampler, as in
    # JAX (R > 128).
    rate1, util1, reps1 = train(batch_size=1, config_name="sharded",
                                remat=True)
    rows["sharded"] = {
        "train_audio_sec_per_s_bf16_b1_remat": rate1, "mfu_train": util1,
        "train_rates_per_rep_b1": reps1,
        "gen_samples_per_s_b1_scan": scan("sharded", 1000),
    }
    _free(device)
    rate8, util8, reps8 = train(batch_size=8, config_name="lc", lc=True)
    g1, k1 = gen("lc", lc=True)
    rows["lc"] = {
        "train_audio_sec_per_s_bf16_b8": rate8, "mfu_train": util8,
        "train_rates_per_rep_b8": reps8,
        "gen_samples_per_s_b1_prefill": g1,
        "decode_kernels": {"gen_samples_per_s_b1_prefill": k1},
    }
    _free(device)
    return rows


def bench_e2e_cli(num_steps: int = 40, batch_size: int = 8,
                  sample_size: int = 16000,
                  wavenet_params: Optional[str] = None,
                  device="cuda") -> float:
    """Audio-seconds/s of ``python -m wavenet_torch.cli.train`` (reader
    threads, prefetch, K-step dispatch, checkpoint at exit), run in this
    process at bf16 on a synthetic 4-speaker corpus: the median of the
    CLI's own ``sec/step`` prints over the post-warm-up half. Raises if
    the CLI fails or prints fewer than 10 steps."""
    from wavenet_torch.audio import write_wav
    from wavenet_torch.cli.train import main as train_main

    wavenet_params = wavenet_params or os.path.join(ROOT,
                                                    "wavenet_params.json")
    with open(wavenet_params) as f:
        sr = int(json.load(f)["sample_rate"])
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="wavenet_torch_bench_") as tmp:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        rng = np.random.RandomState(0)
        t = np.arange(4 * sr) / sr
        for i in range(4):
            x = 0.5 * np.sin(2 * np.pi * (110 + 60 * i) * t
                             + rng.uniform(0, 6))
            write_wav(os.path.join(corpus, f"p{i + 1}_000.wav"), x, sr)
        with contextlib.redirect_stdout(buf):
            rc = train_main([
                "--data_dir", corpus,
                "--logdir", os.path.join(tmp, "train"),
                "--wavenet_params", wavenet_params,
                "--batch_size", str(batch_size),
                "--sample_size", str(sample_size),
                "--num_steps", str(num_steps),
                "--checkpoint_every", str(10 * num_steps),
                "--silence_threshold", "0",
                "--compute_dtype", "bfloat16", "--seed", "1",
                "--device", str(device)])
    if rc != 0:
        raise RuntimeError(f"the train CLI exited {rc}:\n{buf.getvalue()}")
    secs = [float(m.group(1)) for m in re.finditer(
        r"\((\d+\.\d+) sec/step", buf.getvalue())]
    if len(secs) < 10:
        raise RuntimeError(f"the train CLI printed {len(secs)} steps, "
                           "fewer than 10")
    dt = float(np.median(secs[len(secs) // 2:]))     # post-warm-up half
    return batch_size * sample_size / sr / dt


def run(scale: Scale = Scale(), device="cuda"):
    """Every row, in the JAX bench's order. Returns ``(payload, parts)``:
    the full payload, and the values ``compact_line`` takes."""
    from wavenet_torch.models.config import paper_config
    from wavenet_torch.utils.flops import (
        device_hbm_bytes_per_s, gen_flops_per_sample, mfu,
        stream_decode_hbm_bytes_per_step, weight_bytes)

    dev = resolve_device(device)
    info = device_info(dev)
    tf1_rate, tf1_kind = tf1_baseline_samples_per_s()
    n, reps = scale.gen_samples, scale.gen_reps
    seconds = {"build": _build_kernels(dev)}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        seconds[key] = time.perf_counter() - t0
        t0 = time.perf_counter()

    def gen(B, **kw):
        return bench_generation_cuda(B, n, device=dev, **kw)

    # The headline and b1/b8 at float32 weights; the ladder at bf16
    # weights, each at the device and the delivered rate.
    gen_b1 = gen(1, prefill=True, reps=reps)
    gen_b1_seq = gen(1, reps=reps)
    gen_b8 = gen(8, prefill=True, reps=reps)
    ladder = {}
    for B in LADDER:
        ladder[B] = {
            "device": gen(B, prefill=True, weight_dtype=torch.bfloat16,
                          reps=reps, sync="device"),
            "delivered": gen(B, prefill=True, weight_dtype=torch.bfloat16,
                             reps=max(1, reps - 1)),
        }
    gen_b64_f32 = gen(64, prefill=True, reps=reps)
    lap("generation")
    gen_b64_scan = bench_generation_scan(64, min(4000, scale.scan_samples),
                                         device=dev)
    _free(dev)
    lap("scan_b64")
    train_bf16 = bench_training(batch_size=8, compute_dtype="bfloat16",
                                n_steps=scale.train_steps,
                                reps=scale.train_reps, device=dev)
    train_fp32 = bench_training(batch_size=2, compute_dtype="float32",
                                n_steps=scale.train_steps, device=dev)
    _free(dev)
    lap("training")
    e2e_cli = bench_e2e_cli(num_steps=scale.e2e_steps, device=dev)
    _free(dev)
    lap("e2e_cli")
    configs = bench_config_rows(scale, dev)
    lap("configs")

    paper = paper_config()
    hbm_peak = device_hbm_bytes_per_s(info["name"])

    def hbm_gb_s(B):
        return (ladder[B]["device"].rate / B
                * stream_decode_hbm_bytes_per_step(paper, B) / 1e9)

    headline = gen_b1.rate
    rows = {"gen_samples_per_s_b1_paper": gen_b1,
            "gen_samples_per_s_b1_sequential_vmem": gen_b1_seq,
            "gen_samples_per_s_b8_prefill_f32": gen_b8,
            "gen_samples_per_s_b64_prefill_f32": gen_b64_f32}
    for B in LADDER:
        rows[f"gen_samples_per_s_b{B}_device_bf16w"] = ladder[B]["device"]
        rows[f"gen_samples_per_s_b{B}_prefill_bf16w"] = \
            ladder[B]["delivered"]
    payload = {
        "metric": "gen_samples_per_s_b1_paper",
        "value": _round(headline),
        "unit": "samples/s",
        "vs_baseline": _round(headline / tf1_rate),
        "extra": {
            "tf1_fast_gen_samples_per_s": round(tf1_rate, 1),
            "tf1_baseline_kind": tf1_kind,
            "gen_rates_per_rep_b1": [_round(r) for r in gen_b1.rates_per_rep],
            "gen_samples_per_s_b1_sequential_vmem": _round(gen_b1_seq.rate),
            "gen_samples_per_s_b8_prefill_f32": _round(gen_b8.rate),
            **{f"gen_samples_per_s_b{B}_device_bf16w":
               _round(ladder[B]["device"].rate) for B in LADDER},
            **{f"gen_b{B}_device_rates_per_rep":
               [_round(r) for r in ladder[B]["device"].rates_per_rep]
               for B in LADDER},
            **{f"gen_samples_per_s_b{B}_prefill_bf16w":
               _round(ladder[B]["delivered"].rate) for B in LADDER},
            **{f"gen_b{B}_delivered_rates_per_rep":
               [_round(r) for r in ladder[B]["delivered"].rates_per_rep]
               for B in LADDER},
            "gen_samples_per_s_b64_prefill_f32": _round(gen_b64_f32.rate),
            "gen_samples_per_s_b64_scan": _round(gen_b64_scan),
            "train_audio_sec_per_s_bf16_b8": _round(train_bf16.rate, 3),
            "train_rates_per_rep_bf16_b8":
                [_round(r, 3) for r in train_bf16.rates_per_rep],
            "train_audio_sec_per_s_fp32_b2": _round(train_fp32.rate, 3),
            "e2e_cli_audio_sec_per_s": _round(e2e_cli, 1),
            **{f"gen_b{B}_hbm_gb_s": _round(hbm_gb_s(B), 1)
               for B in LADDER},
            "hbm_peak_gb_s": _round(hbm_peak / 1e9 if hbm_peak else None, 1),
            "gen_b128_hbm_frac_of_peak": _round(
                hbm_gb_s(128) * 1e9 / hbm_peak if hbm_peak else None, 4),
            "mfu_train_bf16_b8": _round(train_bf16.mfu, 4),
            "mfu_gen_b64_prefill_bf16w": _round(mfu(
                ladder[64]["device"].rate * gen_flops_per_sample(paper),
                info["name"]), 4),
            "gen_b1_weight_stream_gb_s": _round(
                headline * weight_bytes(paper) / 1e9, 1),
            "configs": configs,
            "realtime_factor_b1_16khz": _round(headline / 16000.0),
            # The decode kernel that served each generation row.
            "decode_kernels": {k: r.kernels for k, r in rows.items()},
            "device": info,
            "scale": dataclasses.asdict(scale),
            "seconds_by_part": seconds,
            "config": "paper (30 layers, 32 res / 512 skip, Q=256)",
        },
    }
    parts = dict(headline=headline, tf1_rate=tf1_rate, train_b8=train_bf16,
                 e2e_cli=e2e_cli, ladder=ladder, configs=configs,
                 hbm_peak=hbm_peak)
    return payload, parts


def compact_line(headline: float, tf1_rate: float, train_b8: TrainRow,
                 e2e_cli: float, ladder: dict, configs: dict,
                 hbm_peak: Optional[float]) -> str:
    """The compact JSON line, with the JAX bench's keys: the headline,
    train b8 and its MFU, the ladder's device rates (min and max over the
    reps), b512 against b256, the delivered b512 rate, b512's share of
    the card's memory rate, the CLI, and each config's train b8 row. Over
    ``COMPACT_LIMIT`` characters it keeps train_b8 and gen_b512 only, as
    the JAX bench does."""
    from wavenet_torch.models.config import paper_config
    from wavenet_torch.utils.flops import stream_decode_hbm_bytes_per_step

    def mm(B):
        rates = ladder[B]["device"].rates_per_rep
        return [_round(min(rates), 0), _round(max(rates), 0)]

    b256, b512 = ladder[256]["device"].rate, ladder[512]["device"].rate
    b512_hbm = b512 / 512 * stream_decode_hbm_bytes_per_step(
        paper_config(), 512)
    train_rate, train_mfu, _ = _train_fields(train_b8, 3)
    compact = {
        "metric": "gen_samples_per_s_b1_paper",
        "value": _round(headline),
        "unit": "samples/s",
        "vs_baseline": _round(headline / tf1_rate),
        "extra": {
            "train_b8": train_rate, "mfu_b8": train_mfu,
            "e2e_cli": _round(e2e_cli, 1),
            "gen_b64": mm(64), "gen_b128": mm(128),
            "gen_b256": mm(256), "gen_b512": mm(512),
            "b512_over_b256": _round(b512 / b256, 3),
            "b512_delivered": _round(ladder[512]["delivered"].rate),
            "hbm_frac_b512": _round(b512_hbm / hbm_peak if hbm_peak
                                    else None, 3),
            "cfg_train_b8": {
                "gc": configs["gc"]["train_audio_sec_per_s_bf16_b8"],
                "gc_k4": configs["gc"]["train_audio_sec_per_s_bf16_b8_k4"],
                "gc_mfu_k4": configs["gc"]["mfu_train_b8_k4"],
                "wide": configs["wide"]["train_audio_sec_per_s_bf16_b8"],
                "sharded_b1": configs["sharded"][
                    "train_audio_sec_per_s_bf16_b1_remat"],
                "lc": configs["lc"]["train_audio_sec_per_s_bf16_b8"],
            },
            "gen_wide_b1_pallas":
                configs["wide"]["gen_samples_per_s_b1_prefill"],
            "full": FULL_PAYLOAD,
        },
    }
    line = json.dumps(compact)
    if len(line) > COMPACT_LIMIT:     # never truncate the JSON itself
        compact["extra"] = {"train_b8": train_rate, "gen_b512": mm(512),
                            "full": FULL_PAYLOAD}
        line = json.dumps(compact)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Benchmark of the PyTorch/CUDA port on one card")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card) or 'cpu'.")
    args = parser.parse_args(argv)
    # f32 parity: no TF32 in matmuls or convolutions (as the CLIs).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    payload, parts = run(Scale(), args.device)
    payload["extra"]["seconds"] = time.perf_counter() - t0
    path = os.path.join(ROOT, FULL_PAYLOAD)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload))
    print(compact_line(**parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
