"""How far a bf16 decode lies from its plain version where the layer chain
is rounded at many wide layers: the readings behind
``kernels.bf16_hold``'s ``PLAIN_FACTOR`` and ``PLAIN_CAP``.

At the sharded widths (R = D = 256, S = 512) and B > 1 the bf16 mode
rounds the chain at every layer, so another float32 sum order flips
roundings that later layers carry on. For each seed and batch this runs,
one step a launch from the kernel's own state (``bf16_hold.stepwise``),
``sampler_decode``'s bf16 mode and the plain version summed on the CPU
(``bf16_hold.cpu_launch``, another float32 order), and holds each against
the plain bf16 version on the card on the scale of bf16's gap from the
float32 plain version (``bf16_hold.ratios``), for the logits and the ring
values each step wrote. A kernel that ignored its bf16 weights would read
1 in every ratio.

    python -m wavenet_torch.tools.bf16_spread [--layers 80] [--steps 32] \\
        [--batches 2 3 4 8] [--seeds 0 1 2]

``--layers`` cuts the sharded config's 80 layers to that many (dilations
1, 2, 4, ... 512 repeated, as the config's own). Prints one JSON line a
case and a last line with, per ratio, the largest reading of the kernel,
of the plain version and of their quotient. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json

RATIOS = ("median_ratio", "row_median_ratio", "mean_ratio", "max_ratio")


def seeded_params(c, seed: int):
    """``init_params`` with seeded non-zero biases, on the card."""
    import torch
    from wavenet_torch.models.wavenet import init_params
    p = init_params(seed, c, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sorted(p):
        if k.endswith("_bias"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=gen)
    return {k: v.cuda() for k, v in p.items()}


def case(c, seed: int, B: int, steps: int) -> dict:
    """One seed and batch: {"kernel": {what: ratios}, "plain_cpu": ...}."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import bf16_hold
    from wavenet_torch.kernels import sampler as ks

    params = seeded_params(c, seed)
    rng = np.random.RandomState(seed + B)
    codes = torch.as_tensor(
        rng.randint(0, c.quantization_channels, (B, 70 + steps)),
        dtype=torch.int32, device="cuda")
    carry = ks.prefill_carry(params, c, codes[:, :70], None)
    pk32 = ks.pack_sampler_weights(params, c, B, None)
    pk16 = ks.pack_sampler_weights(params, c, B, None,
                                   weight_dtype=torch.bfloat16)
    forced = codes[:, 69:69 + steps].contiguous()
    rc = ks.chain_rounded("decode", B)

    def step(ring, causal, x, t):
        return ks.decode(pk16, c, ring, causal, x, 1, t, 3,
                         collect_logits=True, kernel="decode")[1]

    out = {}
    for who, launch in (("kernel", step),
                        ("plain_cpu", bf16_hold.cpu_launch(c, pk16, 3, rc))):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        got = bf16_hold.stepwise(c, pk16, pk32, ring, causal, forced,
                                 carry.t_abs, 3, rc, launch)
        torch.cuda.synchronize()
        out[who] = {"logits": bf16_hold.ratios(*got[:3]),
                    "ring": bf16_hold.ratios(*got[3:])}
    return out


def main(argv=None) -> int:
    import torch
    from wavenet_torch.models.config import sharded_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=80)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 3, 4, 8])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16_spread needs a CUDA GPU")
    full = sharded_config()
    c = sharded_config(dilations=tuple(
        full.dilations[i % len(full.dilations)] for i in range(args.layers)))
    worst = {who: {k: 0.0 for k in RATIOS}
             for who in ("kernel", "plain_cpu", "quotient")}
    for seed in args.seeds:
        for B in args.batches:
            r = case(c, seed, B, args.steps)
            print(json.dumps({"layers": c.num_layers, "seed": seed,
                              "batch": B, "steps": args.steps, **r}),
                  flush=True)
            for what in ("logits", "ring"):
                for k in RATIOS:
                    kern, plain = r["kernel"][what][k], r["plain_cpu"][what][k]
                    worst["kernel"][k] = max(worst["kernel"][k], kern)
                    worst["plain_cpu"][k] = max(worst["plain_cpu"][k], plain)
                    worst["quotient"][k] = max(worst["quotient"][k],
                                               kern / max(plain, 1e-30))
    print(json.dumps({"layers": c.num_layers, "worst": worst}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
