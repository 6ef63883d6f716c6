"""Attribute the b1 decode step's time, part by part (ablation bisect).

Counterpart of ``tools/r3_b1_bisect.py`` (TPU kernel ``kernel``), ported as
a probe of the port's own decode kernel (``csrc/sampler_step.cuh``, run by
``csrc/b1_bisect.cu``): one launch runs N_STEPS steps of one row from a
zero ring and causal register, the first input the code Q // 2, then the
sampled codes, with one part of the step removed. Each mode is its own
compile-time instantiation, with float32 or bf16 weights (``--bf16``; the
activations are then rounded to bf16 before each product, as the JAX
kernels do). Each mode computes the JAX mode's math:

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
the row and the step. ``b1_bisect_reference`` is the plain version of
every mode (a step loop, the kernel's signature plus optional noise);
``b1_bisect_logits`` computes the same logits teacher-forced on given
inputs in one pass over time, which is how a run's codes are replayed.

    python -m wavenet_torch.tools.r3_b1_bisect [--bf16] [--device cpu]
"""

from __future__ import annotations

import collections
import ctypes
import statistics
from typing import Optional

import torch
import torch.nn.functional as F

from wavenet_torch import resolve_device, tools
from wavenet_torch.kernels import _launch
from wavenet_torch.kernels.sampler import (
    KERNEL_FIELDS, PackedSampler, gumbel_noise, pack_sampler_weights,
    ring_offsets, zero_state)
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


def _check(config: WaveNetConfig, mode: str) -> None:
    c = config
    if mode not in MODES:
        raise ValueError(f"b1_bisect: mode {mode!r} not in {MODES}")
    if (c.scalar_input or c.lc_enabled or c.filter_width != 2
            or c.residual_channels != c.dilation_channels):
        raise NotImplementedError(
            "b1_bisect takes mu-law models with filter_width 2, no LC and "
            "R == D (the JAX tool's no_fg and no_dense need R == D)")


_THREADS = 256   # the kernel's block


def _mv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [n, K] @ w [K, N] in the kernel's order of operations: x rounded
    to w's type, float32 FMAs (exact products and one rounding, here in
    float64) over k, one chain per output for N >= 256, else 256 / N chains
    over every (256 / N)-th k whose sums are added in order. Equal sums
    round the same way, so bf16 activations round as in the kernel."""
    if w.dtype != torch.float32:
        x = x.to(w.dtype)
    x, w = x.double(), w.double()
    K, N = w.shape
    G = 1 if N >= _THREADS else _THREADS // N
    out = None
    for g in range(G):
        acc = torch.zeros((x.shape[0], N), dtype=torch.float32,
                          device=x.device)
        for k in range(g, K, G):
            acc = (x[:, k:k + 1] * w[k] + acc.double()).float()
        out = acc if out is None else out + acc
    return out


def _layer(packed: PackedSampler, config: WaveNetConfig, off, l: int,
           past: torch.Tensor, cur: torch.Tensor, skip):
    """One layer of the ablated step on rows of (past, cur) -> (cur, skip).
    Rows are time steps in ``b1_bisect_logits`` and the batch row in the
    step loop; layer_add has one row (B = 1)."""
    D = config.dilation_channels
    if "fg" in off:
        fg = torch.cat([past, cur], dim=-1)
    else:
        fg = (_mv(torch.cat([past, cur], dim=-1), packed.layer_w[l])
              + packed.layer_add[l])
    if "tanh" in off:
        out = fg[:, :D] + fg[:, D:]
    else:
        tg = torch.tanh(fg)
        out = tg[:, :D] * (0.5 + 0.5 * tg[:, D:])
    if "dense" in off:
        cur = cur + out[:, :cur.shape[1]]
    else:
        cur = (cur + _mv(out, packed.dense_w[l])) + packed.dense_add[l]
    if "skip" not in off:
        s = _mv(out, packed.skip_w[l])
        skip = s if skip is None else skip + s
    return cur, skip


def _head(packed: PackedSampler, config: WaveNetConfig, off, cur, skip):
    Q = config.quantization_channels
    if "head" in off:
        return cur[:, :1].expand(cur.shape[0], Q)
    if skip is None:
        skip = torch.zeros((cur.shape[0], config.skip_channels),
                           device=cur.device)
    h = torch.relu(skip + packed.skip_b)
    h = torch.relu(_mv(h, packed.post1_w) + packed.post1_b)
    return _mv(h, packed.post2_w) + packed.post2_b


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
                        collect_logits: bool = False):
    """Plain version of mode ``mode``: ``n_steps`` steps of one row from a
    zero state, first input Q // 2 -> codes [1, n_steps] int32 (and the
    logits [1, n_steps, Q] with ``collect_logits``). ``noise`` [n_steps, 1,
    Q] replaces the Philox Gumbel noise (the kernel's by default)."""
    _check(config, mode)
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
            cur, skip = _layer(packed, c, off, l, past, cur, skip)
        lg = _head(packed, c, off, cur, skip)
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
                     mode: str, inputs: torch.Tensor) -> torch.Tensor:
    """The logits [1, n, Q] of mode ``mode`` at each step, teacher-forced
    on the step inputs ``inputs`` [1, n] (input 0 is Q // 2), in one pass
    over time: the ring from a zero start holds x_l(t - d), so each layer
    is a dilated product over all steps at once."""
    _check(config, mode)
    c, off = config, _OFF[mode]
    x = inputs[0].long()
    onehot = F.one_hot(x, c.quantization_channels).float()
    prev = F.pad(onehot, (0, 0, 1, 0))[:-1]
    cur = _features(packed, c, off, x, prev)
    skip = None
    for l, d in enumerate(c.dilations):
        past = cur if "ring" in off else F.pad(cur, (0, 0, d, 0))[:-d]
        cur, skip = _layer(packed, c, off, l, past, cur, skip)
    return _head(packed, c, off, cur, skip)[None]


def _bind(lib) -> None:
    fn = lib.b1_bisect_run
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i] + [p] * 17 + [i] * 6 + [ctypes.c_ulonglong, p]
    fn.restype = i


def b1_bisect(packed: PackedSampler, config: WaveNetConfig, mode: str,
              n_steps: int, seed: int = SEED, collect_logits: bool = False):
    """One launch of mode ``mode``: ``n_steps`` steps of one row from a
    zero ring and causal register, first input Q // 2 -> codes [1, n_steps]
    int32 (and the logits [1, n_steps, Q] with ``collect_logits``).
    ``packed`` holds float32 or bf16 weights for batch 1
    (``pack_sampler_weights(..., 1, weight_dtype=...)``). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    _check(config, mode)
    if not _launch.use_kernel("b1_bisect", packed.layer_w):
        return b1_bisect_reference(packed, config, mode, n_steps, seed,
                                   collect_logits=collect_logits)
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
    from wavenet_torch.kernels import _build
    lib = _build.load("b1_bisect")
    _bind(lib)
    ring, causal = zero_state(c, 1, dev)
    forced = torch.full((1, 1), Q // 2, dtype=torch.int32, device=dev)
    codes = torch.empty((1, n_steps), dtype=torch.int32, device=dev)
    logits = (torch.empty((1, n_steps, Q), dtype=torch.float32, device=dev)
              if collect_logits else None)
    meta = torch.tensor(ring_offsets(c) + c.dilations, dtype=torch.int32,
                        device=dev)
    err = lib.b1_bisect_run(
        MODES.index(mode), int(wt == torch.bfloat16),
        *(getattr(packed, k).data_ptr() for k in KERNEL_FIELDS),
        meta.data_ptr(), ring.data_ptr(), causal.data_ptr(),
        forced.data_ptr(), codes.data_ptr(),
        logits.data_ptr() if logits is not None else None, L, R, D, S, Q,
        n_steps, int(seed) & 0xFFFFFFFFFFFFFFFF, _launch.stream(dev))
    if err != 0:
        raise RuntimeError(f"b1_bisect {mode} launch failed: CUDA error "
                           f"{err}")
    b1_bisect.launches += 1
    b1_bisect.launches_by[f"{mode}_{tools.DTYPE_NAMES[wt]}"] += 1
    return (codes, logits) if collect_logits else codes


#: Launches made by ``b1_bisect``, in all and by "<mode>_<bf16|f32>"
#: (read by chip_smoke.py).
b1_bisect.launches = 0
b1_bisect.launches_by = collections.Counter()


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
    packed = pack_sampler_weights(
        init_params(0, c, device=dev), c, B,
        weight_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    n = args.steps
    results = {}

    def line(mode):
        ms = statistics.median(tools.timed_ms(
            lambda: b1_bisect(packed, c, mode, n), dev))
        results[mode] = ms
        delta = ""
        if mode != "full" and "full" in results:
            delta = f"  (saves {(results['full'] - ms) / n * 1e3:5.2f} us)"
        return f"{mode:10s} {ms:8.1f} ms  {ms / n * 1e3:6.2f} us/step{delta}"

    return tools.run_table(MODES, line)


if __name__ == "__main__":
    raise SystemExit(main())
