"""Log-mel features for local conditioning, and the sidecar writer.

Counterpart of ``wavenet_tpu/features.py`` (NumPy/SciPy only): an STFT
log-mel spectrogram and a CLI that walks a corpus and writes the
``<stem>.lc.npy`` sidecars (``wavenet_torch.lc``'s convention, one frame
per ``hop`` samples) that training, generation and serving take as
conditioning.

Typical use, 16 kHz corpus, 80 mels at a 12.5 ms hop::

    python -m wavenet_torch.features corpus/ --n_mels 80 --hop 200
    python -m wavenet_torch.cli.generate LOGDIR --lc_channels 80 \\
        --lc_file corpus/p1_001.lc.npy --lc_hop 200 ...
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def hz_to_mel(f):
    """HTK mel scale: m = 2595 log10(1 + f/700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft // 2 + 1] (HTK scale,
    unit-height triangles over mel-spaced edges)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    if not 0 <= fmin < fmax <= sample_rate / 2.0:
        raise ValueError(f"need 0 <= fmin < fmax <= nyquist, got "
                         f"[{fmin}, {fmax}] at sr={sample_rate}")
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_edges = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_edges = mel_to_hz(mel_edges)                      # [n_mels + 2]
    fb = np.zeros((n_mels, n_bins), np.float64)
    for m in range(n_mels):
        lo, center, hi = hz_edges[m], hz_edges[m + 1], hz_edges[m + 2]
        up = (fft_freqs - lo) / max(center - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - center, 1e-10)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def stft_magnitude(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| [frames, n_fft // 2 + 1] of centered (reflect-padded)
    frames: frame f covers the samples around f*hop, so it aligns with
    output sample f*hop, as ``upsample_lc`` maps frames to samples."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    pad = n_fft // 2
    # Reflect needs len > 1; degenerate clips fall back to zero-padding.
    if len(audio) > 1:
        x = np.pad(audio, pad, mode="reflect")
    else:
        x = np.pad(audio, pad, mode="constant")
    n_frames = 1 + len(audio) // hop
    window = np.hanning(n_fft).astype(np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop]
    frames = frames[:n_frames]
    if len(frames) < n_frames:                 # short clips
        short = np.zeros((n_frames - len(frames), n_fft), np.float32)
        frames = np.concatenate([frames, short], axis=0)
    spec = np.fft.rfft(frames * window, axis=1)
    return np.abs(spec).astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, sample_rate: int,
                        n_mels: int = 80, hop: int = 200,
                        n_fft: int = 1024, fmin: float = 0.0,
                        fmax: Optional[float] = None,
                        floor: float = 1e-5) -> np.ndarray:
    """Log-mel frames [ceil(T / hop), n_mels] of a [-1, 1] waveform: the
    natural log of the mel energy clamped at ``floor``. Pass the
    generation's ``--lc_hop`` as ``hop``, so that the upsampled stream
    rides the audio timeline one to one."""
    mag = stft_magnitude(audio, n_fft, hop)                  # [F, bins]
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    mel = mag @ fb.T                                         # [F, n_mels]
    out = np.log(np.maximum(mel, floor)).astype(np.float32)
    # One frame per hop of the original length.
    n_keep = -(-len(np.atleast_1d(audio).reshape(-1)) // hop)
    return out[:n_keep]


def write_sidecars(audio_dir: str, sample_rate: int, n_mels: int,
                   hop: int, n_fft: int = 1024,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   normalize: bool = True,
                   stats_path: Optional[str] = None,
                   log=print) -> int:
    """Write a ``<stem>.lc.npy`` log-mel sidecar beside every wav under
    ``audio_dir``; returns the number written.

    Audio is decoded and resampled as the data reader does
    (``wavenet_torch.audio.read_wav``). ``normalize`` standardizes each
    feature over the corpus and saves the mean and std to
    ``lc_stats.npz`` in ``audio_dir``; ``stats_path`` applies an existing
    ``lc_stats.npz`` instead (held-out splits must use the training
    corpus's scale).
    """
    from wavenet_torch.audio import read_wav
    from wavenet_torch.data.reader import find_files

    files = find_files(audio_dir)
    if not files:
        raise FileNotFoundError(f"no wav files under '{audio_dir}'")
    ext_stats = None
    if stats_path is not None:
        with np.load(stats_path) as z:
            if int(z["n_mels"]) != n_mels or int(z["hop"]) != hop or \
                    int(z["sample_rate"]) != sample_rate:
                raise ValueError(
                    f"{stats_path} was computed for n_mels="
                    f"{int(z['n_mels'])}, hop={int(z['hop'])}, sr="
                    f"{int(z['sample_rate'])}; requested "
                    f"({n_mels}, {hop}, {sample_rate})")
            ext_stats = (z["mean"], z["std"])
    feats = []
    for path in files:
        audio, _ = read_wav(path, sample_rate)
        feats.append(log_mel_spectrogram(audio, sample_rate, n_mels, hop,
                                         n_fft, fmin, fmax))
    if ext_stats is not None:
        mean, std = ext_stats
        feats = [(f - mean) / std for f in feats]
    elif normalize:
        allf = np.concatenate(feats, axis=0)
        mean = allf.mean(axis=0)
        std = np.maximum(allf.std(axis=0), 1e-6)
        feats = [(f - mean) / std for f in feats]
        np.savez(os.path.join(audio_dir, "lc_stats.npz"),
                 mean=mean, std=std, n_mels=n_mels, hop=hop,
                 n_fft=n_fft, sample_rate=sample_rate)
    for path, f in zip(files, feats):
        stem, _ = os.path.splitext(path)
        np.save(stem + ".lc.npy", f.astype(np.float32))
        log(f"{stem}.lc.npy: {f.shape[0]} frames x {f.shape[1]} mels")
    return len(files)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Write <stem>.lc.npy log-mel sidecars for local "
                    "conditioning.")
    p.add_argument("audio_dir", help="Corpus directory (walked for .wav).")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_mels", type=int, default=80,
                   help="Feature dim; generate with --lc_channels N_MELS.")
    p.add_argument("--hop", type=int, default=200,
                   help="Samples per frame at --sample_rate; generate "
                        "with --lc_hop HOP.")
    p.add_argument("--n_fft", type=int, default=1024)
    p.add_argument("--fmin", type=float, default=0.0)
    p.add_argument("--fmax", type=float, default=None)
    p.add_argument("--no_normalize", action="store_true",
                   help="Skip per-dim corpus standardization.")
    p.add_argument("--stats", type=str, default=None,
                   help="Apply mean/std from an existing lc_stats.npz "
                        "(the training corpus's, for held-out splits).")
    args = p.parse_args(argv)
    n = write_sidecars(args.audio_dir, args.sample_rate, args.n_mels,
                       args.hop, args.n_fft, args.fmin, args.fmax,
                       normalize=not args.no_normalize,
                       stats_path=args.stats)
    print(f"Wrote {n} sidecars. Use them with: --lc_channels {args.n_mels} "
          f"--lc_hop {args.hop}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
