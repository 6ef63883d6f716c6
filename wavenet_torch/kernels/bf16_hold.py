"""Holding a bf16 decode kernel against its plain version.

A decode at bf16 weights (TPU kernels 1-4 at ``weight_dtype=bfloat16``)
is held against ``decode_reference`` at bf16 weights on the scale of
bf16's own distance from float32 (the plain version at float32 weights
from the same state). Another float32 summation order flips a few bf16
roundings of the activations, and a flip carries on through the layers
and the ring, heavy-tailed: on the CPU, a float64-summed plain bf16 run at
the paper widths over 30 steps lay 1e-5 of bf16's median gap from the
float32-summed one at the median point and 0.43-0.65 of the worst gap at
the worst point. Held one step at a time from the kernel's own state
(:func:`stepwise`), no flip carries into a later step: on an H100 the
kernels' errors lay 1.0e-5 to 2.4e-5 of the median gap at the median and
0.003 to 0.031 of the mean gap on average. The chain's rounding rule
swapped lies 0.8-1.0 of the gap at the median; an indexing fault O(1) of
the values. Each row is held by its own median, so that a fault confined
to a few rows (one cluster, one row block) cannot hide under the others'
medians. Used by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.

Where the chain is rounded at each of many wide layers (the sharded
config: 80 layers of R = D = 256), one step holds so many roundings that
a flip in an early layer moves the later layers' inputs by a bf16 ulp,
and later roundings flip in turn: another float32 sum order of the plain
version itself then lies a sizeable part of the gap away. There the
kernel is held to that distance (:func:`hold_as_plain`): each ratio
within PLAIN_FACTOR times the plain version's own when stepped on the CPU
(:func:`cpu_launch`, another float32 sum order), or within the limits
above, and never past PLAIN_CAP of the gap: a kernel that ignored its
bf16 weights lies the whole gap away (every ratio 1).
``wavenet_torch/tools/bf16_spread.py`` takes the readings behind both
constants.

A bf16 ring (``state_dtype=torch.bfloat16``) changes no step's logits:
a ring row is stored after it is read. What it changes is the rows a step
writes, each layer's float32 input rounded to nearest even. At float32
weights a kernel's input to a layer lies within float32 round-off of the
plain version's, so its rounded row equals the plain version's but where
that input lies within those last bits of a rounding boundary:
:func:`hold_ring16` allows RING16_FLIP_SHARE of the elements to differ,
each by one bf16 ulp or, where a sum cancels to near zero, by
RING16_ATOL. A kernel that truncated instead of rounding would differ in
about half of them. On the CPU, the plain version with its products
summed in float64 against itself in float32 (gc widths, b16, 12 steps
from a bf16 ring) differed in at most 0.052% of the stored elements, by
one ulp or (values near 1e-5) by up to 8 ulps, 2e-6. At bf16 weights a
rounding flip of one operand moves the later layers' inputs, and their
roundings flip in turn: there the same runs differed in up to 3.0% of the
elements, by up to 0.031, yet within :func:`hold`'s limits (mean ratio
0.047, worst 1.0), so rows at bf16 weights are held by :func:`hold`.
"""

from __future__ import annotations

import torch

from wavenet_torch.kernels import sampler as ks

#: Limits on the error over bf16's gap from float32: each row's median
#: over its median (and the whole's median over the whole's), the mean over
#: the mean, the worst point over the worst.
MEDIAN_RATIO, MEAN_RATIO, MAX_RATIO = 0.05, 0.2, 4.0


def ratios(got: torch.Tensor, ref: torch.Tensor,
           ref32: torch.Tensor) -> dict:
    """``got``'s distance from ``ref`` (bf16 plain) on the scale of ``ref -
    ref32`` (float32 plain), all [B, ...] with rows first: {max |d|,
    median, worst row's median, mean and worst ratio}."""
    err, gap = (got - ref).abs(), (ref - ref32).abs()
    row_err = err.flatten(1).median(dim=1).values
    row_gap = gap.flatten(1).median(dim=1).values
    # A zero gap (a bf16 ring where both plain versions round alike) over
    # a zero error reads 0, over any error a huge ratio.
    tiny = torch.finfo(torch.float32).tiny
    return {"max_abs_err": err.max().item(),
            "median_ratio": (err.median() / gap.median().clamp_min(tiny))
            .item(),
            "row_median_ratio": (row_err / row_gap.clamp_min(tiny))
            .max().item(),
            "mean_ratio": (err.mean() / gap.mean().clamp_min(tiny)).item(),
            "max_ratio": (err.max() / gap.max().clamp_min(tiny)).item()}


def hold(where: str, got: torch.Tensor, ref: torch.Tensor,
         ref32: torch.Tensor) -> dict:
    """Hold ``got`` against ``ref`` (bf16 plain) on the scale of
    ``ref - ref32`` (float32 plain), all [B, ...] with rows first. Raises
    AssertionError past a limit; returns :func:`ratios`."""
    err, gap = (got - ref).abs(), (ref - ref32).abs()
    row_err = err.flatten(1).median(dim=1).values
    row_gap = gap.flatten(1).median(dim=1).values
    out = ratios(got, ref, ref32)
    if not torch.isfinite(got).all().item():
        raise AssertionError(f"{where}: non-finite values")
    bad = (row_err > MEDIAN_RATIO * row_gap).nonzero().flatten().tolist()
    if bad:
        raise AssertionError(
            f"{where}: rows {bad[:8]} (of {len(bad)}) have a median error "
            f"past {MEDIAN_RATIO} of their median gap (worst "
            f"{out['row_median_ratio']:.4g})")
    for key, limit, what in (("median_ratio", MEDIAN_RATIO, "median"),
                             ("mean_ratio", MEAN_RATIO, "mean"),
                             ("max_ratio", MAX_RATIO, "worst")):
        if not out[key] <= limit:
            raise AssertionError(f"{where}: {what} error {out[key]:.4g} of "
                                 f"bf16's {what} gap (limit {limit})")
    return out


def stepwise(c, pk16, pk32, ring, causal, forced, t0, seed, round_chain,
             launch, lc=None):
    """A bf16 window one step a launch: ``launch(ring, causal, x, t)`` runs
    the kernel one step from its own state (updated in place) and returns
    that step's logits; each step is compared with one step of the plain
    version at bf16 and at float32 weights from the same state, so no
    rounding flip of an earlier step carries into a later one. An LC
    config's stream ``lc`` [n, B, C_lc] conditions the window (row t of it
    step ``t0 + t``; ``launch`` takes the same row). The ring is float32
    or bf16 (its type is ``ring``'s; the plain versions step from the same
    ring). Raises AssertionError where the kernel's causal register
    differs from the plain one's or it changed a ring row that the step
    does not write. Returns (logits: kernel, bf16 plain, float32 plain,
    each [B, n, Q]; the ring positions each step wrote: kernel, bf16
    plain, float32 plain, each [B, P, R] float32, a bf16 ring's rows
    widened). At float32 weights pass the same packed weights twice."""
    out = [[] for _ in range(6)]
    offs = ks.ring_offsets(c)
    for t in range(forced.shape[1]):
        x = forced[:, t:t + 1].contiguous()
        ring0, causal0 = ring.clone(), causal.clone()
        out[0].append(launch(ring, causal, x, t0 + t))
        rings = []
        for k, pk in ((1, pk16), (2, pk32)):
            r, cz = ring0.clone(), causal0.clone()
            out[k].append(ks.decode_reference(
                pk, c, r, cz, x, 1, t0 + t, seed, collect_logits=True,
                round_chain=round_chain,
                lc=None if lc is None else lc[t:t + 1])[1])
            rings.append(r)
            if k == 1 and not torch.equal(cz, causal):
                raise AssertionError("bf16 step: causal register differs")
        step_rows = torch.zeros(ring.shape[0], dtype=torch.bool,
                                device=ring.device)
        step_rows[[o + (t0 + t) % d for o, d in zip(offs, c.dilations)]] = (
            True)
        if not torch.equal(ring[~step_rows], ring0[~step_rows]):
            raise AssertionError("bf16 step: ring values outside the step "
                                 "changed")
        pos = ((ring != ring0) | (rings[0] != ring0)
               | (rings[1] != ring0)).flatten(1).any(1)
        for k, r in ((3, ring), (4, rings[0]), (5, rings[1])):
            out[k].append(r[pos].transpose(0, 1).float())
    return [torch.cat(v, dim=1) for v in out]


#: :func:`hold_ring16`'s limit on the share of a bf16 ring's elements that
#: may differ from the plain version's, and how far each may: one bf16 ulp,
#: or RING16_ATOL (a sum that cancels to near zero keeps float32's absolute
#: round-off, many ulps of its small value).
RING16_FLIP_SHARE, RING16_ATOL = 0.005, 1e-5


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps, elementwise, of bf16 values (bf16 tensors or
    float32 ones holding bf16 values): the distance of their bit patterns
    on the number line, so that -0 and +0 are 0 apart."""
    def line(x):
        bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(a) - line(b)).abs()


def hold_ring16(where: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Hold a kernel's bf16 ring rows ``got`` against the plain version's
    ``ref`` from the same state at float32 weights: equal, but for at most
    RING16_FLIP_SHARE of the elements, each one bf16 ulp or RING16_ATOL
    apart. Raises AssertionError past either limit; returns
    {"differ_share", "max_ulps", "max_abs_err", "far"} (far: elements
    past both the ulp and RING16_ATOL)."""
    if not torch.isfinite(got).all().item():
        raise AssertionError(f"{where}: non-finite ring values")
    d = bf16_ulps(got, ref)
    err = (got.float() - ref.float()).abs()
    out = {"differ_share": (d > 0).float().mean().item(),
           "max_ulps": int(d.max().item()), "max_abs_err": err.max().item(),
           "far": int(((d > 1) & (err > RING16_ATOL)).sum().item())}
    if out["far"] or out["differ_share"] > RING16_FLIP_SHARE:
        raise AssertionError(
            f"{where}: bf16 ring rows {out['differ_share']:.4g} of the "
            f"elements differ (limit {RING16_FLIP_SHARE}), {out['far']} "
            f"more than one ulp and {RING16_ATOL} apart")
    return out


#: :func:`hold_as_plain`'s factor on the plain version's own distance, and
#: its cap on the median, row-median and mean ratios (the worst point
#: keeps MAX_RATIO). ``tools/bf16_spread.py`` at the sharded widths (80
#: layers; b2, b3, b4, b8; seeds 0-2; 32 steps; PERF.md) read the kernel's
#: ratio up to 4.53x the plain version's (the ring's median, where the
#: plain version itself reads 0.025-0.14 of the gap), and either's
#: median, row-median and mean ratios up to 0.59; a kernel that ignored
#: its bf16 weights reads 1.
PLAIN_FACTOR, PLAIN_CAP = 6.0, 0.75


def hold_as_plain(where: str, kern: dict, plain: dict) -> dict:
    """Hold the kernel's :func:`ratios` ``kern`` to ``plain``, those of the
    plain version summed in another float32 order (the same steps on the
    CPU, :func:`cpu_launch`): each within PLAIN_FACTOR times the plain
    version's, or within this module's limit where that is larger, and
    never past PLAIN_CAP of bf16's own gap (the worst point MAX_RATIO).
    Raises AssertionError past a limit; returns the limits held."""
    limits = {}
    for key, limit, cap in (("median_ratio", MEDIAN_RATIO, PLAIN_CAP),
                            ("row_median_ratio", MEDIAN_RATIO, PLAIN_CAP),
                            ("mean_ratio", MEAN_RATIO, PLAIN_CAP),
                            ("max_ratio", MAX_RATIO, MAX_RATIO)):
        limits[key] = min(cap, max(limit, PLAIN_FACTOR * plain[key]))
    bad = [k for k in limits if not kern[k] <= limits[k]]
    if bad:
        raise AssertionError(f"{where}: {bad} past their limits {limits}; "
                             f"the kernel {kern}, the plain version in "
                             f"another sum order {plain}")
    return limits


def cpu_launch(c, packed, seed: int, round_chain: bool):
    """A :func:`stepwise` ``launch`` that steps the plain version on the
    CPU (another float32 sum order than the card's) from the caller's
    state, which it updates in place."""
    pc = type(packed)(*[t.cpu() if isinstance(t, torch.Tensor) else t
                        for t in packed])

    def launch(ring, causal, x, t):
        r, cz = ring.cpu(), causal.cpu()
        lg = ks.decode_reference(pc, c, r, cz, x.cpu(), 1, t, seed,
                                 collect_logits=True,
                                 round_chain=round_chain)[1]
        ring.copy_(r)
        causal.copy_(cz)
        return lg.to(ring.device)

    return launch
