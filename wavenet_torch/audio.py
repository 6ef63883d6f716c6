"""Audio numerics and I/O: mu-law codec, wav read/write, resampling, trim.

Counterpart of ``wavenet_tpu/audio.py``: the codec as torch functions
(device-side) and as numpy functions (host-side), with the same formulas
(the ``min(|x|, 1)`` clamp and the ``+ 0.5`` round-half-up), plus wav
I/O through scipy.
"""

from __future__ import annotations

import fractions
from typing import Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# mu-law companding (torch; device-side)
# ---------------------------------------------------------------------------

def mu_law_encode(audio: torch.Tensor,
                  quantization_channels: int = 256) -> torch.Tensor:
    """Float waveform in [-1, 1] -> int32 codes in [0, Q-1]."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    mu = torch.tensor(quantization_channels - 1, dtype=torch.float32,
                      device=audio.device)
    safe = torch.clamp(torch.abs(audio), max=1.0)
    magnitude = torch.log1p(mu * safe) / torch.log1p(mu)
    signal = torch.sign(audio) * magnitude
    return ((signal + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mu_law_decode(output: torch.Tensor,
                  quantization_channels: int = 256) -> torch.Tensor:
    """Codes in [0, Q-1] -> float waveform in [-1, 1]."""
    mu = float(quantization_channels - 1)
    signal = 2.0 * (torch.as_tensor(output).to(torch.float32) / mu) - 1.0
    magnitude = (1.0 / mu) * ((1.0 + mu) ** torch.abs(signal) - 1.0)
    return torch.sign(signal) * magnitude


# numpy twins, for the host-side path.

def mu_law_encode_np(audio: np.ndarray,
                     quantization_channels: int = 256) -> np.ndarray:
    mu = np.float32(quantization_channels - 1)
    audio = np.asarray(audio, dtype=np.float32)
    safe = np.minimum(np.abs(audio), 1.0)
    magnitude = np.log1p(mu * safe) / np.log1p(mu)
    signal = np.sign(audio) * magnitude
    return ((signal + 1.0) / 2.0 * mu + 0.5).astype(np.int32)


def mu_law_decode_np(output: np.ndarray,
                     quantization_channels: int = 256) -> np.ndarray:
    mu = quantization_channels - 1
    signal = 2.0 * (np.asarray(output, dtype=np.float32) / mu) - 1.0
    magnitude = (1.0 / mu) * ((1.0 + mu) ** np.abs(signal) - 1.0)
    return np.sign(signal) * magnitude


# ---------------------------------------------------------------------------
# wav I/O (host-side, scipy)
# ---------------------------------------------------------------------------

def read_wav(path: str,
             sample_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    native_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sample_rate is not None and sample_rate != native_sr:
        audio = resample(audio, native_sr, sample_rate)
        native_sr = sample_rate
    return np.ascontiguousarray(audio, dtype=np.float32), native_sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float waveform in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (clipped * 32767.0).astype(np.int16))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling."""
    from scipy.signal import resample_poly

    if orig_sr == target_sr:
        return audio
    ratio = fractions.Fraction(target_sr, orig_sr)
    return resample_poly(audio, ratio.numerator,
                         ratio.denominator).astype(np.float32)


def _frame_rms(audio: np.ndarray, frame_length: int,
               hop_length: int) -> np.ndarray:
    """Per-frame RMS energy with centered frames."""
    pad = frame_length // 2
    padded = np.pad(audio, pad, mode="constant")
    n_frames = 1 + (len(padded) - frame_length) // hop_length
    if n_frames <= 0:
        return np.zeros((0,), dtype=np.float32)
    strides = (padded.strides[0] * hop_length, padded.strides[0])
    frames = np.lib.stride_tricks.as_strided(
        padded, shape=(n_frames, frame_length), strides=strides)
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2,
                           axis=1)).astype(np.float32)


def trim_silence_indices(audio: np.ndarray, threshold: float,
                         frame_length: int = 2048) -> "tuple[int, int]":
    """(start, end) sample indices of the non-silent region; (0, 0) if
    the whole clip is silent."""
    if len(audio) < frame_length:
        frame_length = max(len(audio), 1)
    hop_length = frame_length // 4 if frame_length >= 4 else 1
    energy = _frame_rms(audio, frame_length, hop_length)
    loud = np.nonzero(energy > threshold)[0]
    if len(loud) == 0:
        return 0, 0
    start = loud[0] * hop_length
    end = min(len(audio), (loud[-1] + 1) * hop_length)
    return start, end


def trim_silence(audio: np.ndarray, threshold: float,
                 frame_length: int = 2048) -> np.ndarray:
    """Remove leading/trailing silence below an RMS threshold."""
    start, end = trim_silence_indices(audio, threshold, frame_length)
    return audio[start:end]
