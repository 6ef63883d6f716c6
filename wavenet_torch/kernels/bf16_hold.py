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
"""

from __future__ import annotations

import torch

from wavenet_torch.kernels import sampler as ks

#: Limits on the error over bf16's gap from float32: each row's median
#: over its median (and the whole's median over the whole's), the mean over
#: the mean, the worst point over the worst.
MEDIAN_RATIO, MEAN_RATIO, MAX_RATIO = 0.05, 0.2, 4.0


def hold(where: str, got: torch.Tensor, ref: torch.Tensor,
         ref32: torch.Tensor) -> dict:
    """Hold ``got`` against ``ref`` (bf16 plain) on the scale of
    ``ref - ref32`` (float32 plain), all [B, ...] with rows first. Raises
    AssertionError past a limit; returns {max |d|, median, worst row's
    median, mean and worst ratio}."""
    err, gap = (got - ref).abs(), (ref - ref32).abs()
    row_err = err.flatten(1).median(dim=1).values
    row_gap = gap.flatten(1).median(dim=1).values
    tiny = torch.finfo(torch.float32).tiny
    row_ratio = row_err / row_gap.clamp_min(tiny)
    out = {"max_abs_err": err.max().item(),
           "median_ratio": (err.median() / gap.median()).item(),
           "row_median_ratio": row_ratio.max().item(),
           "mean_ratio": (err.mean() / gap.mean()).item(),
           "max_ratio": (err.max() / gap.max()).item()}
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
    step ``t0 + t``; ``launch`` takes the same row). Raises
    AssertionError where the kernel's causal register differs from the
    plain one's or it changed a ring row that the step does not write.
    Returns (logits: kernel, bf16 plain, float32 plain, each [B, n, Q];
    the ring positions each step wrote: kernel, bf16 plain, float32
    plain, each [B, P, R])."""
    out = [[] for _ in range(6)]
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
        wrote = (rings[0] != ring0) | (rings[1] != ring0)
        if not torch.equal(ring[~wrote], ring0[~wrote]):
            raise AssertionError("bf16 step: ring values outside the step "
                                 "changed")
        pos = wrote.flatten(1).any(1)
        for k, r in ((3, ring), (4, rings[0]), (5, rings[1])):
            out[k].append(r[pos].transpose(0, 1))
    return [torch.cat(v, dim=1) for v in out]
