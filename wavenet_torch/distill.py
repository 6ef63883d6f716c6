"""Draft distillation for speculative decoding.

Counterpart of ``wavenet_tpu/distill.py``. Speculative decoding's speed-up
is the draft's acceptance rate, and acceptance measures agreement with
the target's free-running distribution, not with the training data: a
draft trained on the same corpus can agree teacher-forced and still
diverge free-running. ``distill_draft`` samples a corpus from the target
(the scan sampler, ``sample.generate``) and fits the draft config to it
with the train step and Adam, so the draft learns the on-policy agreement
that acceptance measures.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import Params


def distill_draft(params: Params, config: WaveNetConfig,
                  draft_config: WaveNetConfig, key: torch.Generator,
                  *, n_clips: int = 4, clip_samples: int = 4000,
                  steps: int = 500, learning_rate: float = 2e-3,
                  temperature: float = 1.0,
                  seed_codes: Optional[torch.Tensor] = None,
                  log=None) -> Tuple[Params, float]:
    """Train ``draft_config`` on the target's own samples.

    Returns (draft_params, final_loss); the draft lives on ``key``'s
    device, as the corpus does. ``seed_codes`` [1, T] optionally primes
    the sampling (real audio, say, so the corpus starts on-manifold); the
    clips draw from ``key`` one after another. The draft's initial weights
    are seeded from ``key``'s first draw. Mu-law models only, as
    speculative decoding.
    """
    from wavenet_torch.audio import mu_law_decode
    from wavenet_torch.sample import generate
    from wavenet_torch.train_lib import (
        create_train_state, make_optimizer, make_train_step)

    c = config
    if c.scalar_input or draft_config.scalar_input:
        raise NotImplementedError("distillation is mu-law-only, like "
                                  "speculative decoding")
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    init_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=key,
                                  device=key.device))

    # On-policy corpus: free-running target samples, with the draft's
    # receptive field of left context per clip so that its training
    # chunks are fully conditioned.
    T = draft_config.receptive_field + clip_samples
    seeds = seed_codes.repeat(n_clips, 1) if seed_codes is not None else None
    codes = generate(params, c, T, key, batch_size=n_clips,
                     temperature=temperature, seed_codes=seeds)
    corpus = mu_law_decode(codes, c.quantization_channels)   # [n, T]

    state = create_train_state(init_seed, draft_config,
                               make_optimizer("adam", learning_rate),
                               device=key.device)
    step_fn = make_train_step(draft_config)
    for i in range(steps):
        state, metrics = step_fn(state, corpus)
        if log is not None and (i + 1) % max(1, steps // 10) == 0:
            log(f"distill step {i + 1}/{steps} "
                f"loss {float(metrics['loss']):.3f}")
    loss = float(metrics["loss"])
    return {k: v.detach() for k, v in state.params.items()}, loss
