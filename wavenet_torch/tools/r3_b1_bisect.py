"""Attribute the b1 decode step's time, part by part (ablation bisect).

Counterpart of ``tools/r3_b1_bisect.py`` (TPU kernel ``kernel``), ported as
a probe of the port's own decode kernels: ``kernel="cluster"`` is
``csrc/sampler_cluster.cuh``, the kernel that b1 generation runs (built with
its phase clock by ``csrc/b1_bisect_cluster.cu`` and ``_bf16.cu``), on the
route's plan (``device_plan`` at B = 1); ``kernel="decode"`` is
``csrc/sampler_step.cuh`` (``csrc/b1_bisect.cu``), the first design;
``"auto"`` takes the cluster kernel where the route does (an H100), else
decode. One launch runs N_STEPS steps of one row from a zero ring and
causal register, the first input the code Q // 2, then the sampled codes,
with one part of the step removed. Each mode is its own compile-time
instantiation, with float32 or bf16 weights (``--bf16``; the activations
are then rounded to bf16 before each product, as the JAX kernels do).
Each mode computes the JAX mode's math:

    full       the real step (at float32, ``decode_sequential``'s codes)
    no_skip    no skip product
    no_dense   current += out[:, :R], no dense product
    no_fg      fg = [past | current], no filter/gate product
    no_tanh    out = fg[:, :D] + fg[:, D:]
    no_ring    past = current, no ring read or write
    no_head    logits = current[:, :1] in every class, no head
    no_sample  argmax of the logits, no Gumbel noise
    no_feat    current = x in every channel, no causal layer
    mm_only    no_ring + no_tanh + no_skip + no_head

The noise is the production Philox, keyed on the seed, the class block,
the row and the step. ``full`` is the production step: its codes are
``decode_sequential(..., kernel=<the same>)``'s at both weight types.
``b1_bisect_reference`` is the plain version of every mode on either
kernel, in that kernel's order of sums (a step loop, the kernel's
signature plus optional noise); ``b1_bisect_logits`` computes the same
logits teacher-forced on given inputs in one pass over time, which is how
a run's codes are replayed. ``b1_bisect_phase_cycles`` reads the cluster
kernel's phase clock (SM clocks of each phase of its step, by CTA).

``main`` prints the routed kernel's table, then decode's, and for the
cluster kernel one line a CTA of SM clocks a step by phase (``full``):

    python -m wavenet_torch.tools.r3_b1_bisect [--bf16] [--device cpu]
"""

from __future__ import annotations

import collections
import ctypes
import statistics
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch
from wavenet_torch.kernels import sampler as ks
from wavenet_torch.kernels.sampler import (
    KERNEL_FIELDS, ClusterPlan, PackedSampler, gumbel_noise,
    pack_sampler_weights, ring_offsets, zero_state)
from wavenet_torch.models.config import WaveNetConfig, paper_config

B = 1
N_STEPS = 16000
SEED = 7
MODES = ("full", "no_skip", "no_dense", "no_fg", "no_tanh", "no_ring",
         "no_head", "no_sample", "no_feat", "mm_only")
# The parts each mode removes.
_OFF = {"full": (), "no_skip": ("skip",), "no_dense": ("dense",),
        "no_fg": ("fg",), "no_tanh": ("tanh",), "no_ring": ("ring",),
        "no_head": ("head",), "no_sample": ("sample",), "no_feat": ("feat",),
        "mm_only": ("ring", "tanh", "skip", "head")}
KERNELS = ("auto", "cluster", "decode")
#: The cluster kernel's phases of a step (``ClusterPhase`` in
#: ``csrc/sampler_cluster.cuh``), in order: one CTA's timeline.
PHASES = ("ring_wait", "fg_product", "fg_sync", "dense_product",
          "dense_sync", "handoff_ring_causal", "skip_partial", "barrier1",
          "skip_sum", "post1_gather", "barrier2", "post2_logits",
          "gumbel_argmax", "barrier3_pick")
#: The cluster probe's library by weight type.
_CLUSTER_SOURCES = {torch.float32: "b1_bisect_cluster",
                    torch.bfloat16: "b1_bisect_cluster_bf16"}


def _check(config: WaveNetConfig, mode: str) -> None:
    c = config
    if mode not in MODES:
        raise ValueError(f"b1_bisect: mode {mode!r} not in {MODES}")
    if (c.scalar_input or c.lc_enabled or c.filter_width != 2
            or c.residual_channels != c.dilation_channels):
        raise NotImplementedError(
            "b1_bisect takes mu-law models with filter_width 2, no LC and "
            "R == D (the JAX tool's no_fg and no_dense need R == D)")


def _check_plan(config: WaveNetConfig, kernel: str,
                plan: Optional[ClusterPlan]) -> Optional[ClusterPlan]:
    """The plan whose order of sums a plain version repeats: None for
    ``kernel`` "decode", the given one for "cluster" (which needs one:
    CS CTAs whose layer ranges cover the L layers, S and Q split by CS as
    the kernel splits them, one row)."""
    if kernel not in ("cluster", "decode"):
        raise ValueError(f"b1_bisect: kernel {kernel!r} not in "
                         "('cluster', 'decode')")
    if kernel == "decode":
        if plan is not None:
            raise ValueError("b1_bisect: a plan is the cluster kernel's")
        return None
    c = config
    L, S, Q = c.num_layers, c.skip_channels, c.quantization_channels
    if plan is None:
        raise ValueError("b1_bisect: the cluster kernel needs a plan")
    begin = tuple(plan.layer_begin)
    if (plan.RB != 1 or not 1 <= plan.CS <= ks.CLUSTER_SIZES[-1]
            or len(begin) != plan.CS + 1 or begin[0] != 0
            or begin[-1] != L or any(b <= a for a, b in zip(begin, begin[1:]))
            or S % plan.CS or Q % (4 * plan.CS)):
        raise ValueError(f"b1_bisect: bad cluster plan {plan} for L={L}, "
                         f"S={S}, Q={Q} (layer_begin must cover the L "
                         "layers, one row a cluster)")
    return plan


_THREADS = 256   # the kernels' block


def _operands(x: torch.Tensor, w: torch.Tensor):
    """x rounded to w's type (bf16 weights), both in float64."""
    if w.dtype != torch.float32:
        x = x.to(w.dtype)
    return x.double(), w.double()


def _fma_chain(x: torch.Tensor, w: torch.Tensor, ks_, acc=None):
    """acc [n, N] float32 + x[:, k] * w[k] for k in ``ks_`` in order, one
    float32 FMA at a time (x and w already float64: exact products, one
    rounding)."""
    if acc is None:
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                          device=x.device)
    for k in ks_:
        acc = (x[:, k:k + 1] * w[k] + acc.double()).float()
    return acc


def _mv(x: torch.Tensor, w: torch.Tensor,
        n_cols: Optional[int] = None) -> torch.Tensor:
    """x [n, K] @ w [K, N] in the order of sampler_step.cuh's matvec (and of
    sampler_cluster.cuh's head_matvec on a slice of ``n_cols`` columns): x
    rounded to w's type, float32 FMAs over k, one chain per output for
    n_cols >= 256, else 256 / n_cols chains over every (256 / n_cols)-th k
    whose sums are added in order (n_cols defaults to N). Equal sums round
    the same way, so bf16 activations round as in the kernel."""
    x, w = _operands(x, w)
    K, N = w.shape
    n = N if n_cols is None else n_cols
    G = 1 if n >= _THREADS else _THREADS // n
    out = None
    for g in range(G):
        acc = _fma_chain(x, w, range(g, K, G))
        out = acc if out is None else out + acc
    return out


def _lanes(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """x [n, K] @ w [K, N] in the order of sampler_cluster.cuh's chain
    products (chain_shape: a warp owns D / 4 filter/gate columns, so 32 /
    (D / 4) groups, or R / 8 dense columns, so 32 / (R / 8)): ``groups``
    lanes split K, each an FMA chain over k = g, g + groups, ... in order,
    then a shuffle butterfly adds the lanes' sums pairwise by the bits of
    g, lowest first."""
    x, w = _operands(x, w)
    K = w.shape[0]
    parts = [_fma_chain(x, w, range(g, K, groups)) for g in range(groups)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _layer(packed: PackedSampler, config: WaveNetConfig, off, l: int,
           past: torch.Tensor, cur: torch.Tensor, skip,
           plan: Optional[ClusterPlan] = None):
    """One layer of the ablated step on rows of (past, cur) -> (cur, skip).
    Rows are time steps in ``b1_bisect_logits`` and the batch row in the
    step loop; layer_add has one row (B = 1). ``plan`` None: the decode
    kernel's sums (skip the running sum of the layers' products); else the
    cluster kernel's (skip the list of its CTAs' partials so far, each one
    FMA chain over its layers' k in order)."""
    R, D = config.residual_channels, config.dilation_channels
    if "fg" in off:
        fg = torch.cat([past, cur], dim=-1)
    else:
        xc = torch.cat([past, cur], dim=-1)
        fg = (_mv(xc, packed.layer_w[l]) if plan is None else
              _lanes(xc, packed.layer_w[l], 32 // (D // 4)))
        fg = fg + packed.layer_add[l]
    if "tanh" in off:
        out = fg[:, :D] + fg[:, D:]
    else:
        tg = torch.tanh(fg)
        out = tg[:, :D] * (0.5 + 0.5 * tg[:, D:])
    if "dense" in off:
        cur = cur + out[:, :cur.shape[1]]
    else:
        d = (_mv(out, packed.dense_w[l]) if plan is None else
             _lanes(out, packed.dense_w[l], 32 // (R // 8)))
        cur = (cur + d) + packed.dense_add[l]
    if "skip" not in off:
        if plan is None:
            s = _mv(out, packed.skip_w[l])
            skip = s if skip is None else skip + s
        else:
            skip = [] if skip is None else skip
            if l in plan.layer_begin:     # the first layer of a CTA
                skip.append(None)
            x, w = _operands(out, packed.skip_w[l])
            skip[-1] = _fma_chain(x, w, range(w.shape[0]), skip[-1])
    return cur, skip


def _head(packed: PackedSampler, config: WaveNetConfig, off, cur, skip,
          plan: Optional[ClusterPlan] = None):
    """The logits of the step's last ``cur`` and skip (see ``_layer``); on
    the cluster kernel the CTAs' partials are added in rank order and each
    CTA's slice of post1 and post2 is a product of S / CS and Q / CS
    columns."""
    S, Q = config.skip_channels, config.quantization_channels
    if "head" in off:
        return cur[:, :1].expand(cur.shape[0], Q)
    if skip is None:
        skip = torch.zeros((cur.shape[0], S), device=cur.device)
    elif plan is not None:
        total = skip[0]
        for part in skip[1:]:
            total = total + part
        skip = total
    cs = 1 if plan is None else plan.CS
    h = torch.relu(skip + packed.skip_b)
    h = torch.relu(_mv(h, packed.post1_w, S // cs) + packed.post1_b)
    return _mv(h, packed.post2_w, Q // cs) + packed.post2_b


def _features(packed: PackedSampler, config: WaveNetConfig, off,
              x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """current of input codes ``x`` [n] after one-hots ``prev`` [n, Q]."""
    if "feat" in off:
        return x.float()[:, None].expand(x.shape[0],
                                         config.residual_channels)
    # Two one-hot rows: the sum of their weight rows in any order.
    window = torch.cat([prev, F.one_hot(x.long(), config.quantization_channels)
                        .float()], dim=-1)
    return window @ packed.causal_w.float()


@torch.no_grad()
def b1_bisect_reference(packed: PackedSampler, config: WaveNetConfig,
                        mode: str, n_steps: int, seed: int = SEED,
                        noise: Optional[torch.Tensor] = None,
                        collect_logits: bool = False,
                        kernel: str = "decode",
                        plan: Optional[ClusterPlan] = None):
    """Plain version of mode ``mode`` on ``kernel`` ("decode", or "cluster"
    on ``plan``), in that kernel's order of sums: ``n_steps`` steps of one
    row from a zero state, first input Q // 2 -> codes [1, n_steps] int32
    (and the logits [1, n_steps, Q] with ``collect_logits``). ``noise``
    [n_steps, 1, Q] replaces the Philox Gumbel noise (the kernel's by
    default)."""
    _check(config, mode)
    plan = _check_plan(config, kernel, plan)
    c, off = config, _OFF[mode]
    Q = c.quantization_channels
    dev = packed.layer_w.device
    if noise is None and "sample" not in off:
        noise = gumbel_noise(seed, 1, 0, n_steps, Q, dev)
    ring, _ = zero_state(c, 1, dev)
    prev = torch.zeros((1, Q), device=dev)
    offs = ring_offsets(c)
    x = torch.full((1,), Q // 2, dtype=torch.int64, device=dev)
    codes = torch.empty((1, n_steps), dtype=torch.int32, device=dev)
    logits = []
    for t in range(n_steps):
        cur = _features(packed, c, off, x, prev)
        if "feat" not in off:
            prev = F.one_hot(x, Q).float()
        skip = None
        for l, d in enumerate(c.dilations):
            if "ring" in off:
                past = cur
            else:
                pos = offs[l] + t % d
                past = ring[pos].clone()
                ring[pos] = cur
            cur, skip = _layer(packed, c, off, l, past, cur, skip, plan)
        lg = _head(packed, c, off, cur, skip, plan)
        if collect_logits:
            logits.append(lg)
        score = lg if "sample" in off else lg + noise[t]
        x = torch.argmax(score, dim=-1)
        codes[:, t] = x.to(torch.int32)
    if collect_logits:
        return codes, torch.stack(logits, dim=1)
    return codes


@torch.no_grad()
def b1_bisect_logits(packed: PackedSampler, config: WaveNetConfig,
                     mode: str, inputs: torch.Tensor, kernel: str = "decode",
                     plan: Optional[ClusterPlan] = None) -> torch.Tensor:
    """The logits [1, n, Q] of mode ``mode`` on ``kernel`` (as
    ``b1_bisect_reference``) at each step, teacher-forced on the step
    inputs ``inputs`` [1, n] (input 0 is Q // 2), in one pass over time:
    the ring from a zero start holds x_l(t - d), so each layer is a dilated
    product over all steps at once."""
    _check(config, mode)
    plan = _check_plan(config, kernel, plan)
    c, off = config, _OFF[mode]
    x = inputs[0].long()
    onehot = F.one_hot(x, c.quantization_channels).float()
    prev = F.pad(onehot, (0, 0, 1, 0))[:-1]
    cur = _features(packed, c, off, x, prev)
    skip = None
    for l, d in enumerate(c.dilations):
        past = cur if "ring" in off else F.pad(cur, (0, 0, d, 0))[:-d]
        cur, skip = _layer(packed, c, off, l, past, cur, skip, plan)
    return _head(packed, c, off, cur, skip, plan)[None]


def _bind(lib, name: str = "b1_bisect_run") -> None:
    """``b1_bisect_run`` of b1_bisect.cu, or ``b1_bisect_cluster_run``
    (its arguments, then the plan: cs and layer_begin)."""
    fn = getattr(lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i] + [p] * 17 + [i] * 6 + [ctypes.c_ulonglong] + (
        [i, p] if name == "b1_bisect_cluster_run" else []) + [p]
    fn.restype = i


def _route(config: WaveNetConfig, kernel: str, device,
           plan: Optional[ClusterPlan] = None):
    """(kernel, plan) that ``b1_bisect`` launches on ``device`` (a CUDA
    one) for ``kernel`` in KERNELS: "auto" takes the cluster kernel where
    the route finds a cluster plan at B = 1 (``device_plan``), else decode;
    a pinned "cluster" raises where it has none. A given ``plan`` replaces
    the device's."""
    if kernel == "decode":
        _check_plan(config, "decode", plan)
        return "decode", None
    if plan is None:
        device = torch.device(device)
        plan = ks.device_plan(config, 1, device if device.index is not None
                              else None)
    if plan is None:
        if kernel == "cluster":
            raise ValueError(
                "b1_bisect: no cluster plan for this config at B=1 on "
                f"{torch.cuda.get_device_name(device)}")
        return "decode", None
    return "cluster", _check_plan(config, "cluster", plan)


def b1_bisect(packed: PackedSampler, config: WaveNetConfig, mode: str,
              n_steps: int, seed: int = SEED, collect_logits: bool = False,
              kernel: str = "auto", plan: Optional[ClusterPlan] = None):
    """One launch of mode ``mode``: ``n_steps`` steps of one row from a
    zero ring and causal register, first input Q // 2 -> codes [1, n_steps]
    int32 (and the logits [1, n_steps, Q] with ``collect_logits``).
    ``packed`` holds float32 or bf16 weights for batch 1
    (``pack_sampler_weights(..., 1, weight_dtype=...)``). ``kernel``:
    "auto", "cluster" or "decode" (see ``_route``); a ``plan`` replaces
    the device's cluster plan. CPU tensors run the plain version: in the
    cluster kernel's order of sums on the given plan (which the CPU needs
    for "cluster"), else in the decode kernel's; CUDA tensors launch the
    kernel or raise."""
    _check(config, mode)
    if kernel not in KERNELS:
        raise ValueError(f"b1_bisect: kernel {kernel!r} not in {KERNELS}")
    if not _launch.use_kernel("b1_bisect", packed.layer_w):
        used = ("cluster" if kernel == "cluster"
                or (kernel == "auto" and plan is not None) else "decode")
        return b1_bisect_reference(packed, config, mode, n_steps, seed,
                                   collect_logits=collect_logits,
                                   kernel=used, plan=plan)
    c = config
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    dev = packed.layer_w.device
    wt = packed.layer_w.dtype
    if wt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"b1_bisect: weights {wt}: float32 or bfloat16")
    shapes = {"causal_w": (2 * Q, R), "layer_w": (L, 2 * R, 2 * D),
              "layer_add": (L, 1, 2 * D), "dense_w": (L, D, R),
              "dense_add": (L, 1, R), "skip_w": (L, D, S),
              "skip_b": (1, S), "post1_w": (S, S), "post1_b": (1, S),
              "post2_w": (S, Q), "post2_b": (1, Q)}
    for name, shape in shapes.items():
        t = getattr(packed, name)
        want = wt if name.endswith("_w") else torch.float32
        if (t.dtype != want or t.device != dev or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"b1_bisect: {name} must be contiguous {want} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    used, plan = _route(c, kernel, dev, plan)
    from wavenet_torch.kernels import _build
    ring, causal = zero_state(c, 1, dev)
    forced = torch.full((1, 1), Q // 2, dtype=torch.int32, device=dev)
    codes = torch.empty((1, n_steps), dtype=torch.int32, device=dev)
    logits = (torch.empty((1, n_steps, Q), dtype=torch.float32, device=dev)
              if collect_logits else None)
    meta = torch.tensor(ring_offsets(c) + c.dilations, dtype=torch.int32,
                        device=dev)
    args = (MODES.index(mode), int(wt == torch.bfloat16),
            *(getattr(packed, k).data_ptr() for k in KERNEL_FIELDS),
            meta.data_ptr(), ring.data_ptr(), causal.data_ptr(),
            forced.data_ptr(), codes.data_ptr(),
            logits.data_ptr() if logits is not None else None, L, R, D, S, Q,
            n_steps, int(seed) & 0xFFFFFFFFFFFFFFFF)
    if used == "cluster":
        lib = _build.load(_CLUSTER_SOURCES[wt])
        _bind(lib, "b1_bisect_cluster_run")
        begin = (ctypes.c_int * len(plan.layer_begin))(*plan.layer_begin)
        err = lib.b1_bisect_cluster_run(*args, plan.CS, begin,
                                        _launch.stream(dev))
    else:
        lib = _build.load("b1_bisect")
        _bind(lib)
        err = lib.b1_bisect_run(*args, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"b1_bisect {used} {mode} launch failed: CUDA "
                           f"error {err}")
    b1_bisect.launches += 1
    key = f"{mode}_{tools.DTYPE_NAMES[wt]}"
    b1_bisect.launches_by[key if used == "decode" else f"cluster_{key}"] += 1
    return (codes, logits) if collect_logits else codes


#: Launches made by ``b1_bisect``, in all and by "<mode>_<bf16|f32>" on
#: the decode kernel, "cluster_<mode>_<bf16|f32>" on the cluster kernel
#: (read by chip_smoke.py).
b1_bisect.launches = 0
b1_bisect.launches_by = collections.Counter()


def b1_bisect_phase_cycles(cs: int, weight_dtype=torch.float32,
                           reset: bool = True):
    """The cluster kernel's phase clock at ``weight_dtype``, summed over its
    launches since the last reset (each ``reset`` read zeroes it): SM clocks
    [cs, len(PHASES)] of each CTA's phases, in ``PHASES`` order, and [cs]
    of each CTA's whole step loop, as numpy uint64. Divide by the steps
    launched for clocks a step. Synchronises the current device first."""
    from wavenet_torch.kernels import _build
    lib = _build.load(_CLUSTER_SOURCES[weight_dtype])
    n, mc = lib.b1_bisect_cluster_phases(), lib.b1_bisect_cluster_max_cluster()
    if n != len(PHASES) or not 1 <= cs <= mc:
        raise RuntimeError(f"b1_bisect: the library has {n} phases and "
                           f"{mc} CTAs at most, asked for {cs} CTAs of "
                           f"{len(PHASES)}")
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (mc * (n + 1)))()
    fn = lib.b1_bisect_cluster_phase_cycles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    err = fn(buf, int(reset))
    if err != 0:
        raise RuntimeError(f"b1_bisect: CUDA error {err} reading the clock")
    cycles = np.frombuffer(buf, dtype=np.uint64).reshape(mc, n + 1)[:cs]
    return cycles[:, :n].copy(), cycles[:, n].copy()


def phase_lines(phases, steps, n_steps: int):
    """One line a CTA: its SM clocks a step, in all and by phase."""
    return [f"CTA {k}: {steps[k] / n_steps:9.0f} clocks/step = " +
            " + ".join(f"{name} {phases[k, i] / n_steps:.0f}"
                       for i, name in enumerate(PHASES))
            for k in range(len(steps))]


def main(argv=None) -> int:
    p = tools.parser(__doc__.splitlines()[0])
    p.add_argument("--bf16", action="store_true", help="bf16 weights")
    p.add_argument("--steps", type=int, default=N_STEPS,
                   help="steps per launch (the TPU tool's 16,000)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(tools.device_line(dev), flush=True)
    from wavenet_torch.models.wavenet import init_params
    c = paper_config()
    wt = torch.bfloat16 if args.bf16 else torch.float32
    packed = pack_sampler_weights(init_params(0, c, device=dev), c, B,
                                  weight_dtype=wt)
    n = args.steps
    routed, plan = (_route(c, "auto", dev) if dev.type == "cuda"
                    else ("decode", None))
    kernels = (routed,) + (("decode",) if routed != "decode" else ())
    results = {}

    def line(label):
        kernel, mode = label.split()
        ms = statistics.median(tools.timed_ms(
            lambda: b1_bisect(packed, c, mode, n, kernel=kernel), dev))
        results[label] = ms
        delta = ""
        if mode != "full" and f"{kernel} full" in results:
            delta = (f"  (saves {(results[f'{kernel} full'] - ms) / n * 1e3:5.2f}"
                     " us)")
        return (f"[{kernel:7s}] {mode:10s} {ms:8.1f} ms  "
                f"{ms / n * 1e3:6.2f} us/step{delta}")

    rc = tools.run_table([f"{k} {m}" for k in kernels for m in MODES], line)
    if routed == "cluster":
        print(f"cluster plan {plan}: SM clocks a step of `full` by CTA and "
              "phase (thread 0 of each CTA)", flush=True)
        b1_bisect_phase_cycles(plan.CS, wt)            # zero the clock
        b1_bisect(packed, c, "full", n, kernel="cluster")
        for text in phase_lines(*b1_bisect_phase_cycles(plan.CS, wt), n):
            print(text, flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
