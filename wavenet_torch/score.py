"""Teacher-forced scoring: the per-sample log-likelihood of given audio.

Counterpart of ``wavenet_tpu/score.py``. ``log_likelihood`` scores every
position of a waveform in one forward (``forward_codes``, or ``forward``
in scalar mode), so scoring runs at training forward speed; with
``use_pallas_stack`` that forward runs the fused stack kernel on the card.
``log_likelihood_streaming`` scores any length in ``sample.extend_state``
windows with device memory bounded by the window. ``main`` is the
evaluation CLI:

    python -m wavenet_torch.score <ckpt_dir> a.wav [b.wav ...] \\
        --wavenet_params wavenet_params.json [--gc_id N] \\
        [--gc_channels C --gc_cardinality K] [--device cpu]

It prints one JSON line per file: {"file", "samples", "total_logp",
"bits_per_sample", "nll_nats_per_sample"}. The held-out likelihood is the
reference's loss metric. The checkpoint is the port's ``ckpt-STEP/``
(``train_lib.restore_params_only``); ``--device`` (default ``cuda``)
picks the card or the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from wavenet_torch.audio import mu_law_encode
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import (
    Params, embed_gc, forward, forward_codes, maybe_refine_lc)


def _target_logp(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log softmax(logits) at the target codes: [B, k, Q], [B, k] -> [B, k]."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def log_likelihood(params: Params, config: WaveNetConfig,
                   audio: torch.Tensor,
                   gc_ids: Optional[torch.Tensor] = None,
                   lc: Optional[torch.Tensor] = None):
    """Log-likelihoods of a waveform under the model.

    ``audio``: float waveform [B, T] in [-1, 1], not pre-padded: positions
    before the receptive field are scored with the context there is,
    causally zero-padded as in training. ``lc`` [B, T, C_lc] on the audio's
    timeline: ``lc[:, t]`` conditions the prediction of sample t (the
    convention of ``loss_fn``); it is refined here.

    Returns a dict of tensors:
      logp_per_sample [B, T-1]: log p(x_{t+1} | x_{<=t}) for t = 0..T-2
      total_logp      [B]: the sum over the scored positions
      bits_per_sample [B]: -total_logp / ((T-1) ln 2)
    """
    c = config
    with torch.no_grad():
        codes = mu_law_encode(audio, c.quantization_channels)    # [B, T]
        gc_emb = embed_gc(params, c, gc_ids) if gc_ids is not None else None
        lc_in = (maybe_refine_lc(params, c, lc)[:, 1:]
                 if lc is not None else None)
        if c.scalar_input:
            net_in = audio[:, :-1, None].to(torch.float32)
            logits = forward(params, c, net_in, gc_emb, lc=lc_in)
        else:
            logits = forward_codes(params, c, codes[:, :-1], gc_emb,
                                   lc=lc_in)
        per = _target_logp(logits, codes[:, 1:])
        total = per.sum(dim=-1)
        bits = -total / (per.shape[-1] * math.log(2.0))
    return {"logp_per_sample": per, "total_logp": total,
            "bits_per_sample": bits}


def _score_chunk(params: Params, config: WaveNetConfig, state, window,
                 targets, gc_emb, lc=None):
    """One streaming window: (new state, summed log p of ``targets`` [B])."""
    from wavenet_torch.sample import extend_state

    logits, state = extend_state(params, config, state, window, gc_emb,
                                 lc=lc)
    return state, _target_logp(logits, targets).sum(dim=-1)


def log_likelihood_streaming(params: Params, config: WaveNetConfig,
                             audio: torch.Tensor,
                             gc_ids: Optional[torch.Tensor] = None,
                             chunk: int = 65536,
                             lc: Optional[torch.Tensor] = None):
    """``log_likelihood`` with device memory bounded by ``chunk``, for any
    length.

    The one-shot scorer holds [B, T, Q] logits, about 1 GB a minute of
    16 kHz audio at Q = 256 in float32. Here the waveform advances through
    ``sample.extend_state`` windows of ``chunk`` inputs, the ring state
    carried between them as in decode; the last window is as long as
    what is left. Matches ``log_likelihood`` to float32 round-off.

    Returns ``total_logp`` [B] and ``bits_per_sample`` [B] (no per-sample
    array, whose O(T) transfer is what this avoids).
    """
    from wavenet_torch.sample import init_sampler_state

    c = config
    if c.scalar_input:
        raise NotImplementedError(
            "streaming scoring is mu-law-only (extend_state consumes "
            "codes); use log_likelihood for scalar-input models")
    B, T = audio.shape
    with torch.no_grad():
        codes = mu_law_encode(audio, c.quantization_channels)
        gc_emb = embed_gc(params, c, gc_ids) if gc_ids is not None else None
        # Refined once over the whole stream (so window boundaries see
        # their full context), then sliced: window position j of a window
        # at ``pos`` predicts target pos+1+j, conditioned by lc[pos+1+j].
        lc = maybe_refine_lc(params, c, lc)
        state = init_sampler_state(c, B, audio.device)
        total = torch.zeros((B,), device=audio.device)
        n_in = T - 1          # input t scores target t+1
        pos = 0
        while pos < n_in:
            k = min(chunk, n_in - pos)
            lc_k = lc[:, pos + 1:pos + 1 + k] if lc is not None else None
            state, part = _score_chunk(
                params, c, state, codes[:, pos:pos + k],
                codes[:, pos + 1:pos + 1 + k], gc_emb, lc_k)
            total = total + part
            pos += k
        bits = -total / (n_in * math.log(2.0))
    return {"total_logp": total, "bits_per_sample": bits}


def main(argv=None):
    """Evaluation CLI: score wav files under a checkpoint (module
    docstring)."""
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(
        description="Score wav files under a WaveNet checkpoint "
                    "(PyTorch/CUDA port)")
    ap.add_argument("checkpoint")
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--wavenet_params", default="./wavenet_params.json")
    ap.add_argument("--gc_channels", type=int, default=None)
    ap.add_argument("--gc_cardinality", type=int, default=None)
    ap.add_argument("--gc_id", type=int, default=None)
    ap.add_argument("--gc_from_filename", action="store_true",
                    help="Derive each file's speaker id from the VCTK "
                         "p<id>_ filename pattern (the training-corpus "
                         "convention), instead of one global --gc_id.")
    ap.add_argument("--lc_channels", type=int, default=None,
                    help="Score under local conditioning: loads each "
                         "file's <stem>.lc.npy sidecar (the training "
                         "convention) and conditions the likelihood "
                         "on it.")
    ap.add_argument("--lc_hop", type=int, default=None)
    ap.add_argument("--lc_upsample", type=str, default="repeat",
                    choices=["repeat", "linear"])
    ap.add_argument("--lc_refine_width", type=int, default=0)
    ap.add_argument("--streaming_chunk", type=int, default=65536,
                    help="Files longer than this score through bounded-"
                         "memory extend_state windows (mu-law models); "
                         "0 forces the one-shot scorer.")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (the card) or 'cpu'.")
    args = ap.parse_args(argv)

    from wavenet_torch import resolve_device
    from wavenet_torch.audio import read_wav
    from wavenet_torch.train_lib import restore_params_only

    if args.lc_channels is not None and args.lc_hop is None:
        raise ValueError("--lc_channels requires --lc_hop (samples per "
                         "conditioning frame), like the train CLI.")
    device = resolve_device(args.device)
    # float32 parity: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args.wavenet_params) as f:
        raw = json.load(f)
    config = WaveNetConfig.from_json(raw, gc_channels=args.gc_channels,
                                     gc_cardinality=args.gc_cardinality,
                                     lc_channels=args.lc_channels,
                                     lc_refine_width=args.lc_refine_width)
    params = restore_params_only(args.checkpoint, device=device)
    if params is None:
        raise FileNotFoundError(f"no checkpoint in {args.checkpoint}")
    if args.gc_id is not None and args.gc_channels is None:
        raise ValueError("--gc_id needs --gc_channels (and "
                         "--gc_cardinality), like the generate CLI.")
    gc_ids = (torch.tensor([args.gc_id], device=device)
              if args.gc_id is not None else None)

    for path in args.wavs:
        audio, _ = read_wav(path, raw["sample_rate"])
        if args.gc_from_filename:
            from wavenet_torch.data.reader import parse_speaker_id
            spk = parse_speaker_id(os.path.basename(path))
            if spk is None:
                raise ValueError(f"--gc_from_filename: '{path}' does not "
                                 "match the p<id>_ pattern")
            gc_ids = torch.tensor([spk], device=device)
        lc = None
        if args.lc_channels is not None:
            from wavenet_torch.lc import (
                fit_lc_to_length, load_lc_sidecar, upsample_lc)
            feats = load_lc_sidecar(path)
            if feats is None:
                raise FileNotFoundError(f"no <stem>.lc.npy next to {path}")
            up = upsample_lc(feats, args.lc_hop, args.lc_upsample)
            lc = torch.as_tensor(fit_lc_to_length(up, audio.shape[0]),
                                 device=device)[None]
        stream = (args.streaming_chunk
                  and audio.shape[0] > args.streaming_chunk
                  and not config.scalar_input)
        scorer = log_likelihood_streaming if stream else log_likelihood
        kw = {"chunk": args.streaming_chunk} if stream else {}
        out = scorer(params, config,
                     torch.as_tensor(audio, device=device)[None, :],
                     gc_ids, lc=lc, **kw)
        total = float(out["total_logp"][0])
        bits = float(out["bits_per_sample"][0])
        n = int(audio.shape[0])
        print(json.dumps({
            "file": path, "samples": n,
            "total_logp": round(total, 3),
            "bits_per_sample": round(bits, 5),
            "nll_nats_per_sample": round(-total / max(1, n - 1), 5),
        }), flush=True)
    return 0


if __name__ == "__main__":
    main()
