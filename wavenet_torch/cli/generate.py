"""Generation CLI of the port: the JAX CLI's flags, defaults and paths.

    python -m wavenet_torch.cli.generate LOGDIR --wavenet_params P.json \\
        --samples 16000 --wav_out_path out.wav [--gc_channels 32 \\
        --gc_cardinality 109 --gc_id 5] [--batch_size 64] [--device cpu]

Counterpart of ``wavenet_tpu/cli/generate.py``. The checkpoint is the
port's ``ckpt-STEP/`` (a directory of them, or one of them), read with
``train_lib.restore_params_only``. The fast path runs
``sampler_select.generate_with_fallback``: prefill + one launch of a
decode kernel on the card (``sampler_cluster``, ``sampler_tiles`` or
``sampler_decode``, as ``kernels.sampler.cluster_plan`` and ``tile_plan``
route; their plain version on the CPU), or the scan sampler with
``--sampler scan`` and where no decode kernel can launch
(``sampler_select.decode_offered``). ``--sampler_precision bfloat16``
decodes with bf16 weights (the bf16 mode of the routed kernel), on the
fast and the ``--save_every`` paths, as the JAX CLI does; the scan and slow paths
ignore it. The params format, as the JAX CLI's, has no
``compute_dtype``: the config is float32 whatever the file says (a bf16
config object generates at float32 through ``generate_with_fallback``,
and the slow path runs ``predict_proba`` on the config itself, as in
JAX). ``--save_every`` generates in
resumable segments and rewrites the partial wav after each;
``--fast_generation false`` re-runs the full network per sample.
``--device`` (default ``cuda``) picks the card or, for tests, the CPU.

Local conditioning, as the JAX CLI: ``--lc_channels C --lc_file F.npy
--lc_hop H`` loads frames [F, C] (``python -m wavenet_torch.features``
writes them), upsamples them to sample rate (``--lc_upsample``), fits the
stream to ``--samples`` and gives every batch row the same stream; on the
card the LC modes of ``sampler_cluster`` and ``sampler_decode`` decode it.
``--lc_refine_width`` refines the stream (once, the whole stream, before
``--save_every`` slices it). At ``--sampler_precision bfloat16`` the LC
modes run at bf16 weights, as the JAX CLI passes both to its sampler.

Speculative decoding, as the JAX CLI: ``--draft_checkpoint D`` (the
draft's ``ckpt-STEP/`` directory, its config from
``--draft_wavenet_params``, default ``--wavenet_params``) runs
``speculative.generate_speculative`` with ``--speculative_k`` proposals a
segment, batches as independent lanes, and prints the draft's acceptance.
With ``--save_every`` it generates in resumable segments at batch 1 from
one generator, so the segments equal one run. It takes no LC stream.

``--compilation_cache`` is accepted and has no effect: PyTorch compiles
nothing ahead of a call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SAMPLES = 16000
TEMPERATURE = 1.0
LOGDIR = "./logdir"
WAVENET_PARAMS = "./wavenet_params.json"
SAVE_EVERY = None
SILENCE_THRESHOLD = 0.1


def get_arguments(argv=None):
    def _str_to_bool(s):
        if s.lower() not in ("true", "false"):
            raise ValueError("Argument needs to be a boolean, got {}".format(s))
        return s.lower() == "true"

    parser = argparse.ArgumentParser(
        description="WaveNet generation (PyTorch/CUDA port)")
    parser.add_argument("checkpoint", type=str,
                        help="Directory with ckpt-<step> checkpoints (or a "
                             "specific ckpt-<step> path).")
    parser.add_argument("--samples", type=int, default=SAMPLES)
    parser.add_argument("--temperature", type=float, default=TEMPERATURE)
    parser.add_argument("--logdir", type=str, default=LOGDIR)
    parser.add_argument("--wavenet_params", type=str, default=WAVENET_PARAMS)
    parser.add_argument("--wav_out_path", type=str, default=None)
    parser.add_argument("--save_every", type=int, default=SAVE_EVERY,
                        help="Write the partial wav every n samples.")
    parser.add_argument("--fast_generation", type=_str_to_bool, default=True)
    parser.add_argument("--sampler_precision", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="Weights of the decode kernel: float32, or "
                             "bfloat16 (throughput mode).")
    parser.add_argument("--sampler", type=str, default="auto",
                        choices=["auto", "pallas", "scan"],
                        help="auto/pallas: prefill + a decode kernel; "
                             "scan: the scan sampler.")
    parser.add_argument("--draft_checkpoint", type=str, default=None,
                        help="Checkpoint dir of a draft model: speculative "
                             "decoding (the draft proposes "
                             "--speculative_k samples, the target verifies "
                             "them in one parallel pass; the output is "
                             "distributed as the target's). Mu-law models "
                             "only; batches run as independent streams.")
    parser.add_argument("--draft_wavenet_params", type=str, default=None,
                        help="Model params JSON for --draft_checkpoint "
                             "(defaults to --wavenet_params).")
    parser.add_argument("--speculative_k", type=int, default=8,
                        help="Draft proposals per verify pass.")
    parser.add_argument("--wav_seed", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Generate this many waveforms at once "
                             "(wav_out_path gets a -<i> suffix per batch "
                             "element).")
    parser.add_argument("--gc_channels", type=int, default=None)
    parser.add_argument("--gc_cardinality", type=int, default=None)
    parser.add_argument("--gc_id", type=int, default=None,
                        help="ID of category to generate, int value.")
    parser.add_argument("--lc_channels", type=int, default=None,
                        help="Local conditioning: feature channels of "
                             "--lc_file.")
    parser.add_argument("--lc_file", type=str, default=None)
    parser.add_argument("--lc_hop", type=int, default=None)
    parser.add_argument("--lc_upsample", type=str, default="repeat",
                        choices=["repeat", "linear"])
    parser.add_argument("--lc_refine_width", type=int, default=0)
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed for sampling.")
    parser.add_argument("--compilation_cache", type=str,
                        default="~/.cache/wavenet_tpu_xla",
                        help="Accepted for the JAX CLI's sake; no effect.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card) or 'cpu'.")
    return parser.parse_args(argv)


def create_seed(filename, sample_rate, quantization_channels, window_size,
                silence_threshold=SILENCE_THRESHOLD, scalar_input=False):
    """Load and trim a seed wav: mu-law codes, or the trimmed amplitudes
    for a scalar-input model."""
    from wavenet_torch.audio import mu_law_encode_np, read_wav, trim_silence

    audio, _ = read_wav(filename, sample_rate)
    audio = trim_silence(audio, silence_threshold)
    cut = audio[:window_size] if window_size else audio
    if scalar_input:
        return cut.astype(np.float32)
    return mu_law_encode_np(cut, quantization_channels)


def main(argv=None):
    args = get_arguments(argv)
    if (args.draft_checkpoint and args.save_every
            and args.batch_size != 1):
        raise ValueError("--save_every with --draft_checkpoint runs at "
                         "batch size 1 (acceptance makes emitted counts "
                         "ragged across lanes)")

    import torch

    from wavenet_torch import resolve_device
    from wavenet_torch.audio import mu_law_decode_np, write_wav
    from wavenet_torch.models.config import WaveNetConfig
    from wavenet_torch.train_lib import restore_params_only

    device = resolve_device(args.device)
    # f32 parity: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with open(args.wavenet_params, "r") as f:
        wavenet_params = json.load(f)

    if args.gc_channels is not None and args.gc_cardinality is None:
        raise ValueError("Global conditioning needs --gc_cardinality "
                         "(training derived it from the data; generation "
                         "requires the flag, like the reference).")

    if args.lc_channels is not None:
        if args.lc_file is None or args.lc_hop is None:
            raise ValueError("--lc_channels needs --lc_file and --lc_hop "
                             "(per-timestep conditioning for the generated "
                             "audio).")
        if args.draft_checkpoint:
            raise ValueError("--draft_checkpoint (speculative decoding) "
                             "does not support local conditioning yet.")

    config = WaveNetConfig.from_json(
        wavenet_params, gc_channels=args.gc_channels,
        gc_cardinality=args.gc_cardinality, lc_channels=args.lc_channels,
        lc_refine_width=args.lc_refine_width)

    ckpt_dir = args.checkpoint
    step = None
    base = os.path.basename(os.path.normpath(ckpt_dir))
    if base.startswith("ckpt-"):
        step = int(base.split("-")[1])
        ckpt_dir = os.path.dirname(os.path.normpath(ckpt_dir))
    params = restore_params_only(ckpt_dir, step, device)
    if params is None:
        raise FileNotFoundError(f"No checkpoint found in {args.checkpoint}")
    print(f"Restoring model from {args.checkpoint}")

    gc_ids = None
    if args.gc_id is not None:
        if args.gc_channels is None:
            raise ValueError("Globally conditioning is enabled, but global "
                             "condition was not specified. Use --gc_channels.")
        gc_ids = torch.full((args.batch_size,), args.gc_id, dtype=torch.int64,
                            device=device)

    seed_codes = None
    if args.wav_seed:
        codes = create_seed(args.wav_seed, wavenet_params["sample_rate"],
                            config.quantization_channels,
                            config.receptive_field,
                            scalar_input=config.scalar_input)
        seed_codes = torch.as_tensor(codes, device=device)[None].repeat(
            args.batch_size, 1)

    lc = None
    if args.lc_channels is not None:
        from wavenet_torch.lc import fit_lc_to_length, upsample_lc
        feats = np.load(args.lc_file)
        if feats.ndim == 1:
            feats = feats[:, None]
        if feats.shape[1] != args.lc_channels:
            raise ValueError(f"--lc_file has {feats.shape[1]} channels, "
                             f"expected --lc_channels={args.lc_channels}")
        stream = fit_lc_to_length(
            upsample_lc(feats, args.lc_hop, args.lc_upsample), args.samples)
        lc = torch.as_tensor(stream, device=device)[None].repeat(
            args.batch_size, 1, 1)

    seed = args.seed if args.seed is not None else 0
    if args.draft_checkpoint:
        codes = _generate_speculative(params, config, args, seed, gc_ids,
                                      seed_codes, wavenet_params, device)
    elif args.fast_generation and args.save_every:
        codes = _generate_fast_chunked(params, config, args, seed, gc_ids,
                                       seed_codes, wavenet_params, lc)
    elif args.fast_generation:
        codes = _generate_fast(params, config, args, seed, gc_ids,
                               seed_codes, lc)
    else:
        # Slow path: the full forward over the trailing receptive-field
        # window per sample.
        codes = _generate_slow(params, config, args, seed, gc_ids,
                               seed_codes, lc)

    codes = np.asarray(torch.as_tensor(codes).cpu())
    waveform = mu_law_decode_np(codes, config.quantization_channels)

    if seed_codes is None and np.max(np.abs(waveform)) < 0.02:
        # The cold-start attractor: a converged model conditioned on pure
        # silence keeps predicting silence.
        print("WARNING: generated audio is near-silent. Converged models "
              "often get stuck on the silence attractor when unseeded — "
              "pass --wav_seed <some.wav> to prime generation with real "
              "audio, or raise --temperature.")

    if args.wav_out_path:
        sr = wavenet_params["sample_rate"]
        if args.batch_size == 1:
            write_wav(args.wav_out_path, waveform[0], sr)
            print(f"Updated wav file at {args.wav_out_path}")
        else:
            root, ext = os.path.splitext(args.wav_out_path)
            for i in range(args.batch_size):
                path = f"{root}-{i}{ext}"
                write_wav(path, waveform[i], sr)
                print(f"Updated wav file at {path}")
    print("Finished generating.")
    return 0


def _load_draft(args, device):
    from wavenet_torch.models.config import WaveNetConfig
    from wavenet_torch.train_lib import restore_params_only

    with open(args.draft_wavenet_params or args.wavenet_params) as f:
        draft_json = json.load(f)
    draft_config = WaveNetConfig.from_json(
        draft_json, gc_channels=args.gc_channels,
        gc_cardinality=args.gc_cardinality)
    draft_params = restore_params_only(args.draft_checkpoint, device=device)
    if draft_params is None:
        raise FileNotFoundError(
            f"No draft checkpoint in {args.draft_checkpoint}")
    print(f"Restoring draft model from {args.draft_checkpoint}")
    return draft_params, draft_config


def _generate_speculative(params, config, args, seed, gc_ids, seed_codes,
                          wavenet_params, device):
    """Speculative decoding: the draft proposes, the target verifies
    (``speculative.py``); the codes are distributed as the target's. With
    --save_every, resumable segments from one generator, rewriting the
    partial wav after each."""
    import torch

    from wavenet_torch.speculative import generate_speculative

    draft_params, draft_config = _load_draft(args, device)
    key = torch.Generator(device=device).manual_seed(seed)
    common = dict(k=args.speculative_k, temperature=args.temperature,
                  gc_ids=gc_ids, draft_gc_ids=gc_ids)
    if not args.save_every:
        codes, (n_seg, n_acc, n_out) = generate_speculative(
            params, config, draft_params, draft_config, args.samples, key,
            seed_codes=seed_codes, batch_size=args.batch_size,
            return_stats=True, **common)
        rate = n_acc / max(1, n_seg * args.speculative_k)
        print(f"Speculative decode: {n_seg} segments, draft acceptance "
              f"{100 * rate:.1f}%, "
              f"{n_out / max(1, n_seg):.2f} samples/pass.")
        return codes.cpu().numpy()

    carry, chunks, done = None, [], 0
    while done < args.samples:
        part, carry = generate_speculative(
            params, config, draft_params, draft_config, args.save_every, key,
            seed_codes=seed_codes if carry is None else None, carry=carry,
            return_carry=True, **common)
        chunks.append(part.cpu().numpy())
        done += part.shape[1]
        if args.wav_out_path:
            _write_partial([np.concatenate(chunks, axis=1)[:, :args.samples]],
                            config, args, wavenet_params,
                            min(done, args.samples))
    return np.concatenate(chunks, axis=1)[:, :args.samples]


def _generate_fast(params, config, args, seed, gc_ids, seed_codes,
                   lc=None):
    """The selected sampler (``sampler_select``, shared with the server)."""
    from wavenet_torch.sampler_select import generate_with_fallback

    codes, _, _ = generate_with_fallback(
        params, config, args.samples, seed=seed,
        batch_size=args.batch_size, gc_ids=gc_ids,
        temperature=args.temperature, seed_codes=seed_codes,
        sampler=args.sampler, precision=args.sampler_precision, lc=lc)
    return codes


def _generate_fast_chunked(params, config, args, seed, gc_ids, seed_codes,
                           wavenet_params, lc=None):
    """--save_every: generate in segments, rewriting the partial wav after
    each; resumable decode-kernel segments, or the scan sampler with
    ``--sampler scan`` and where no decode kernel can launch
    (``sampler_select.sampler_attempts``). An LC stream is refined once, whole, then sliced
    per segment, so that segment boundaries see their full context."""
    if lc is not None and config.lc_refine_width:
        import torch

        from wavenet_torch.models.wavenet import refine_lc
        with torch.no_grad():
            lc = refine_lc(params, config, lc)
    from wavenet_torch.sampler_select import sampler_attempts

    if sampler_attempts(config, args.sampler, args.sampler_precision,
                        device=args.device, batch_size=args.batch_size):
        return _generate_chunked_pallas(params, config, args, seed, gc_ids,
                                        seed_codes, wavenet_params, lc)
    return _generate_chunked_scan(params, config, args, seed, gc_ids,
                                  seed_codes, wavenet_params, lc)


def _write_partial(chunks, config, args, wavenet_params, done) -> None:
    from wavenet_torch.audio import mu_law_decode_np, write_wav

    partial = np.concatenate(chunks, axis=1)
    write_wav(args.wav_out_path,
              mu_law_decode_np(partial[0], config.quantization_channels),
              wavenet_params["sample_rate"])
    print(f"Sample {done}/{args.samples} — partial wav updated")


def _generate_chunked_pallas(params, config, args, seed, gc_ids, seed_codes,
                             wavenet_params, lc=None):
    """Resumable ``generate_cuda_resumable`` segments. Every segment uses
    the run's seed: the kernel's noise is keyed on the absolute step, so
    the segments equal one run (the JAX package reseeds per segment)."""
    from wavenet_torch.kernels.sampler import generate_cuda_resumable
    from wavenet_torch.sampler_select import PRECISIONS, sampler_name

    chunks, carry, done = [], None, 0
    while done < args.samples:
        n = min(args.save_every, args.samples - done)
        codes, carry = generate_cuda_resumable(
            params, config, n, seed=seed, batch_size=args.batch_size,
            gc_ids=gc_ids, temperature=args.temperature,
            seed_codes=seed_codes if carry is None else None, carry=carry,
            weight_dtype=PRECISIONS[args.sampler_precision],
            lc=None if lc is None else lc[:, done:done + n])
        if done == 0:
            name = sampler_name(codes.device, args.sampler_precision,
                                lc is not None)
            print(f"Using {name} sampler, resumable.")
        chunks.append(codes.cpu().numpy())
        done += n
        if args.wav_out_path:
            _write_partial(chunks, config, args, wavenet_params, done)
    return np.concatenate(chunks, axis=1)


def _generate_chunked_scan(params, config, args, seed, gc_ids, seed_codes,
                           wavenet_params, lc=None):
    """Scan-sampler segments from one ``torch.Generator``."""
    import torch

    from wavenet_torch.models.wavenet import embed_gc
    from wavenet_torch.sample import (
        _featurize, generate_codes_resumable, lc_for_prime, prefill_state,
        unseeded_prime)

    c = config
    dev = params["postprocess2"].device
    key = torch.Generator(device=dev).manual_seed(seed)
    gc_emb = embed_gc(params, c, gc_ids) if gc_ids is not None else None
    if seed_codes is None:
        prime, first = unseeded_prime(c, args.batch_size, key)
    else:
        prime, first = seed_codes[:, :-1], seed_codes[:, -1]
    state = prefill_state(params, c, prime, gc_emb,
                          lc_for_prime(lc, None, prime.shape[1]))
    x = _featurize(first, c)
    print("Using scan sampler, resumable.")
    chunks, done = [], 0
    while done < args.samples:
        n = min(args.save_every, args.samples - done)
        codes, state, x = generate_codes_resumable(
            params, c, state, x, n, key, args.temperature, gc_emb,
            None if lc is None else lc[:, done:done + n])
        chunks.append(codes.cpu().numpy())
        done += n
        if args.wav_out_path:
            _write_partial(chunks, config, args, wavenet_params, done)
    return np.concatenate(chunks, axis=1)


def _generate_slow(params, config, args, seed, gc_ids, seed_codes,
                   lc=None):
    """O(receptive_field) per sample: ``predict_proba`` on the trailing
    window of raw inputs (int codes, or amplitudes in scalar mode, where
    a sampled class re-enters decoded), left-padded with silence. With
    local conditioning a feature window rolls alongside, one row ahead of
    the code window: its last row, ``lc[:, i]``, conditions draw i, and
    the timeline before generation holds ``lc[:, 0]``, as in JAX."""
    import torch

    from wavenet_torch.audio import mu_law_decode
    from wavenet_torch.models.wavenet import predict_proba
    from wavenet_torch.sample import sample_gumbel

    c = config
    rf = c.receptive_field
    dev = params["postprocess2"].device
    key = torch.Generator(device=dev).manual_seed(seed)
    win_dtype = torch.float32 if c.scalar_input else torch.int32
    silence = 0.0 if c.scalar_input else c.quantization_channels // 2
    if seed_codes is not None:
        window = seed_codes.to(win_dtype)
    else:
        window = torch.full((args.batch_size, 1), silence, dtype=win_dtype,
                            device=dev)
    lc_hist = (None if lc is None else
               lc[:, :1].repeat(1, window.shape[1], 1))
    out = []
    with torch.no_grad():
        for i in range(args.samples):
            win = window[:, -rf:]
            if win.shape[1] < rf:
                win = torch.nn.functional.pad(win, (rf - win.shape[1], 0),
                                              value=silence)
            lc_win = None
            if lc is not None:
                lc_hist = torch.cat([lc_hist, lc[:, i:i + 1]], dim=1)
                lc_win = lc_hist[:, -rf:]
                if lc_win.shape[1] < rf:
                    lc_win = torch.cat(
                        [lc_win[:, :1].repeat(1, rf - lc_win.shape[1], 1),
                         lc_win], dim=1)
            probs = predict_proba(params, c, win, gc_ids, lc=lc_win)
            logits = torch.log(torch.clamp_min(probs, 1e-30))
            code = torch.argmax(logits / args.temperature
                                + sample_gumbel(key, logits.shape), dim=-1)
            nxt = (mu_law_decode(code, c.quantization_channels)
                   if c.scalar_input else code.to(torch.int32))
            window = torch.cat([window, nxt[:, None]], dim=1)
            out.append(code.to(torch.int32))
            if i % 100 == 0:
                print(f"Sample {i}/{args.samples}")
    return torch.stack(out, dim=1)


if __name__ == "__main__":
    sys.exit(main())
