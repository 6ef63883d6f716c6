#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (wavenet_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, on a GPU

Phases, each printing JSON lines; any failure exits non-zero:

1. Device and build: the card's name and power limit (nvidia-smi), then
   the ``sampler_decode`` kernel built from ``wavenet_torch/csrc``.
2. Kernel against plain, teacher-forced, at full width (the paper
   config at b1, the gc config at b1, b4, b64 and b512), with seeded
   non-zero biases: prefill ~3.5k random codes, teacher-force 256 more
   steps, and hold the kernel's logits, ring and causal state against
   ``decode_reference`` on the card (rtol 1e-4, atol 1e-4: another
   summation order over K <= 512), and at B <= 4 against the parallel
   ``forward_codes``. Also times one decode step of both, at each batch
   size the server uses.
3. Sampling exactness: a 512-step free run of the kernel, replayed by
   ``decode_reference`` teacher-forced on its codes with the same Philox
   noise (>= 99.9% equal, every mismatch a near-tie), same-seed runs
   bitwise equal, rows independent of the batch size.
4. Serving (the main path): ``GenerationService`` behind a localhost
   HTTP server answers /healthz, /generate at b1 (paper and gc config)
   and /generate_batch at b64 and b512; the launch count shows that the
   kernel served every request.

The line before the last holds the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a GPU or
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# non-tensor-core FP32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

PREFILL = 3500
TEACHER_STEPS = 256
FREE_STEPS = 512
SERVE_BATCH_SIZES = (1, 64, 512)
# Phase 2's (config, batch) cases; those the server's batch sizes are
# timed on, with the decode steps of one timed launch.
TEACHER_CASES = (("paper", 1), ("gc", 1), ("gc", 4), ("gc", 64), ("gc", 512))
TIMED_STEPS = {("paper", 1): 2048, ("gc", 64): 1024, ("gc", 512): 256}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def flops_per_row_step(c) -> int:
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    return 2 * (2 * Q * R + L * (4 * R * D + D * R + D * S) + S * S + S * Q)


def weight_bytes(c) -> int:
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    return 4 * (2 * Q * R + L * (4 * R * D + D * R + D * S + R)
                + 2 * S + S * S + S * Q + Q)


def bound_per_step(c, B: int, steps: int):
    """Least time per step of one decode launch: every input read once and
    every output written once (weights, per-row adds, ring and causal in
    and out, forced in, codes out), or its FP32 operations at peak."""
    L, D, Q = c.num_layers, c.dilation_channels, c.quantization_channels
    state = 4 * B * (sum(c.dilations) * c.residual_channels + Q)
    nbytes = (weight_bytes(c) + 4 * L * B * 2 * D + 2 * state + 4 * B
              + 4 * B * steps)
    t_bytes = nbytes / HBM_BYTES_PER_S / steps
    t_ops = flops_per_row_step(c) * B * steps / FP32_FLOPS / steps
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def weight_stream_bound_per_step(c, B: int):
    """Least time per step of a decode that reads every weight from device
    memory once per step (none kept on chip across steps), or its FP32
    operations at peak."""
    t_bytes = weight_bytes(c) / HBM_BYTES_PER_S
    t_ops = flops_per_row_step(c) * B / FP32_FLOPS
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def seeded_params(c, seed: int, device):
    """``init_params`` with seeded non-zero biases. ``init_params`` sets
    every bias to 0 and a trained checkpoint's are not, so without them
    no bias term of the kernel would be compared."""
    import torch
    from wavenet_torch.models.wavenet import init_params
    p = init_params(seed, c, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sorted(p):
        if k.endswith("_bias"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=gen)
    return {k: v.to(device) for k, v in p.items()}


def cuda_ms(fn, reps: int = 1) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def setup(c, B: int, rng, seed_len: int, extra: int):
    """Seeded random seed codes (and GC ids) on the card."""
    import torch
    codes = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                        (B, seed_len + extra)),
                            dtype=torch.int32, device="cuda")
    gc_ids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                              device="cuda") if c.gc_enabled else None)
    return codes, gc_ids


def phase_teacher_forced(cfgs, params, rng):
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import embed_gc, forward_codes

    results = {}
    for name, B in TEACHER_CASES:
        c, p = cfgs[name], params[name]
        codes, gc_ids = setup(c, B, rng, PREFILL, TEACHER_STEPS)
        gc_emb = None if gc_ids is None else embed_gc(p, c, gc_ids)
        carry = ks.prefill_carry(p, c, codes[:, :PREFILL], gc_ids)
        packed = ks.pack_sampler_weights(p, c, B, gc_emb)
        forced = codes[:, PREFILL - 1:PREFILL - 1 + TEACHER_STEPS].contiguous()
        ring_k, causal_k = carry.ring.clone(), carry.causal.clone()
        ring_r, causal_r = carry.ring.clone(), carry.causal.clone()
        codes_k, lg_k = ks.decode(packed, c, ring_k, causal_k, forced,
                                  TEACHER_STEPS, carry.t_abs, 11,
                                  collect_logits=True)
        codes_r, lg_r = ks.decode_reference(packed, c, ring_r, causal_r,
                                            forced, TEACHER_STEPS,
                                            carry.t_abs, 11,
                                            collect_logits=True)
        torch.cuda.synchronize()
        err = (lg_k - lg_r).abs().max().item()
        check(torch.isfinite(lg_k).all().item(),
              f"{name} B={B}: non-finite logits")
        check(torch.allclose(lg_k, lg_r, rtol=1e-4, atol=1e-4),
              f"{name} B={B}: kernel logits differ from decode_reference "
              f"(max |d| {err})")
        check(torch.allclose(ring_k, ring_r, rtol=1e-4, atol=1e-4),
              f"{name} B={B}: ring state differs")
        check(torch.equal(causal_k, causal_r),
              f"{name} B={B}: causal differs")
        check(torch.equal(codes_k[:, :-1], forced[:, 1:]),
              f"{name} B={B}: forced codes not emitted")
        row = {"phase": "teacher_forced", "config": name, "batch": B,
               "steps": TEACHER_STEPS, "max_abs_err_vs_plain": err}
        if B <= 4:
            full = forward_codes(p, c,
                                 codes[:, :PREFILL - 1 + TEACHER_STEPS],
                                 gc_emb, head_from=PREFILL - 1)
            err_f = (lg_k - full).abs().max().item()
            check(torch.allclose(lg_k, full, rtol=1e-4, atol=1e-4),
                  f"{name} B={B}: kernel logits differ from forward_codes "
                  f"(max |d| {err_f})")
            row["max_abs_err_vs_forward"] = err_f
        if (name, B) in TIMED_STEPS:
            steps = TIMED_STEPS[(name, B)]
            fk = forced[:, :1].contiguous()
            ms_k = cuda_ms(lambda: ks.decode(
                packed, c, ring_k, causal_k, fk, steps, 0, 5)) / steps
            n_plain = 8
            ms_p = cuda_ms(lambda: ks.decode_reference(
                packed, c, ring_r, causal_r, fk, n_plain, 0, 5)) / n_plain
            bound, by = bound_per_step(c, B, steps)
            ws_bound, ws_by = weight_stream_bound_per_step(c, B)
            row.update(ms_per_step=ms_k, plain_ms_per_step=ms_p,
                       bound_ms_per_step=bound, bound_by=by,
                       weight_stream_bound_ms_per_step=ws_bound,
                       weight_stream_bound_by=ws_by, timed_steps=steps)
            results[B] = dict(config=name, max_abs_err=err, ms=ms_k,
                              plain_ms=ms_p, bound_ms=bound, bound_by=by)
        emit(row)
    return results


def phase_sampling(c, params, rng):
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import embed_gc

    B, seed = 64, 1234
    codes, gc_ids = setup(c, B, rng, PREFILL, 0)
    carry = ks.prefill_carry(params, c, codes, gc_ids)
    packed = ks.pack_sampler_weights(params, c, B, embed_gc(params, c, gc_ids))
    last = carry.last[:, None].contiguous()

    def run(n_rows):
        # A copy: decode updates the ring in place.
        ring = carry.ring[:, :n_rows].clone(
            memory_format=torch.contiguous_format)
        causal = carry.causal[:n_rows].clone()
        pk = packed._replace(layer_add=packed.layer_add[:, :n_rows]
                             .contiguous())
        out, _ = ks.decode(pk, c, ring, causal, last[:n_rows].contiguous(),
                           FREE_STEPS, carry.t_abs, seed)
        return out, ring, causal

    k64, ring64, _ = run(B)
    k4a, ring4a, causal4a = run(4)
    k4b, ring4b, causal4b = run(4)
    check(torch.equal(k4a, k4b) and torch.equal(ring4a, ring4b)
          and torch.equal(causal4a, causal4b),
          "same-seed kernel runs differ")
    check(torch.equal(k64[:4], k4a), "rows 0-3 of B=64 differ from B=4")
    check(torch.equal(ring64[:, :4], ring4a), "ring rows depend on B")

    # Replay on the plain version, teacher-forced on the kernel's codes.
    n = 4
    ring_r = carry.ring[:, :n].clone(memory_format=torch.contiguous_format)
    causal_r = carry.causal[:n].clone()
    pk = packed._replace(layer_add=packed.layer_add[:, :n].contiguous())
    forced = torch.cat([last[:n], k4a[:, :-1]], dim=1).contiguous()
    _, lg_r = ks.decode_reference(pk, c, ring_r, causal_r, forced,
                                  FREE_STEPS, carry.t_abs, seed,
                                  collect_logits=True)
    noise = ks.gumbel_noise(seed, n, carry.t_abs, FREE_STEPS,
                            c.quantization_channels, "cuda")
    scores = lg_r * 1.0 + noise.transpose(0, 1)
    top2 = scores.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ref = scores.argmax(dim=-1).to(torch.int32)
    match = ref == k4a
    rate = match.float().mean().item()
    worst = margin[~match].max().item() if (~match).any() else 0.0
    check(rate >= 0.999, f"only {rate:.5f} of sampled codes match")
    check(worst < 1e-4, f"a mismatch sits at a top-2 margin of {worst}")
    emit({"phase": "sampling", "batch": n, "steps": FREE_STEPS,
          "match_rate": rate, "mismatches": int((~match).sum().item()),
          "max_mismatch_margin": worst, "bitwise_repeat": True,
          "rows_independent_of_batch": True})


def start_server(service):
    from http.server import ThreadingHTTPServer
    from wavenet_torch.serve import make_handler
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def phase_serving(cfgs, gpu):
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_smoke_")
    services = {}
    for name, c in cfgs.items():
        npz = os.path.join(tmp, f"{name}.npz")
        save_npz(npz, seeded_params(c, 7, "cpu"))
        js = os.path.join(tmp, f"{name}.json")
        with open(js, "w") as f:
            json.dump(c.to_json_dict(), f)
        services[name] = GenerationService(
            npz, js, c.gc_channels, c.gc_cardinality, warm_samples=256,
            device="cuda")
    servers = {k: start_server(s) for k, s in services.items()}
    Q = cfgs["paper"].quantization_channels
    launches = {}
    try:
        with urllib.request.urlopen(servers["paper"][1] + "/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and "CUDA" in health["sampler"],
              f"healthz: {health}")
        requests = [
            ("paper", "/generate", {"samples": 16000, "seed": 1,
                                    "format": "codes"}, 1),
            ("gc", "/generate", {"samples": 16000, "seed": 2, "gc_id": 7,
                                 "format": "codes"}, 1),
            ("paper", "/generate_batch", {"samples": 16000, "batch": 64,
                                          "seed": 3}, 64),
            ("paper", "/generate_batch", {"samples": 4000, "batch": 512,
                                          "seed": 4}, 512),
        ]
        ks.decode.launches = 0          # the main path's count starts here
        for name, path, payload, B in requests:
            before = ks.decode.launches
            t = time.perf_counter()
            body = post(servers[name][1] + path, payload)
            dt = time.perf_counter() - t
            n = payload["samples"]
            codes = body["codes"]
            rows = [codes] if B == 1 else codes
            check(len(rows) == B and all(len(r) == n for r in rows),
                  f"{path} b{B}: wrong response shape")
            flat = [v for r in rows for v in r]
            check(min(flat) >= 0 and max(flat) < Q, f"{path}: codes range")
            check(len(set(flat)) > 8, f"{path}: degenerate codes")
            delta = ks.decode.launches - before
            check(delta == 1, f"{path} b{B}: {delta} kernel launches")
            launches[B] = launches.get(B, 0) + delta
            emit({"phase": "serving", "config": name, "endpoint": path,
                  "batch": B, "samples": n, "seconds": dt,
                  "samples_per_s": B * n / dt, "kernel_launches": delta,
                  "gpu": gpu})
    finally:
        for httpd, _ in servers.values():
            httpd.shutdown()
            httpd.server_close()
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "wavenet_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(wavenet_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    from wavenet_torch.kernels import _build
    from wavenet_torch.models.config import gc_config, paper_config

    # Phase 1: device and build.
    gpu = gpu_line()
    print(gpu, flush=True)
    t = time.perf_counter()
    _build.load("sampler_decode")
    info = _build.BUILD_INFO["sampler_decode"]
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln]
    emit({"phase": "build", "kernel": "sampler_decode",
          "seconds": time.perf_counter() - t, "nvcc_seconds": info["seconds"],
          "ptxas": regs, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # Phase 2: kernel against plain, teacher-forced.
    cfgs = {"paper": paper_config(), "gc": gc_config()}
    params = {name: seeded_params(c, i, "cuda")
              for i, (name, c) in enumerate(cfgs.items())}
    rng = np.random.RandomState(0)
    measured = phase_teacher_forced(cfgs, params, rng)

    # Phase 3: sampling exactness.
    phase_sampling(cfgs["gc"], params["gc"], rng)

    # Phase 4: serving, the main path.
    launches = phase_serving(cfgs, gpu)
    missing = [B for B in SERVE_BATCH_SIZES if not launches.get(B)]
    check(not missing, f"no kernel launch at batch sizes {missing}")

    replaces = {1: "wavenet_tpu/kernels/sampler.py:234",
                64: "wavenet_tpu/kernels/sampler.py:1308",
                512: "wavenet_tpu/kernels/sampler_packed.py:142"}
    # library_ms is null: no single PyTorch call computes a decode step.
    kernels = []
    for B in SERVE_BATCH_SIZES:
        m = measured[B]
        kernels.append({
            "name": f"sampler_decode_b{B}", "route": "cuda",
            "source": "wavenet_torch/csrc/sampler_decode.cu",
            "replaces": replaces[B], "config": m["config"], "batch": B,
            "launches": launches[B], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "unit": "per decode step", "gpu": gpu})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
