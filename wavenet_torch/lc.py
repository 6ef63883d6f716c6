"""Local conditioning: frame-rate features -> sample-rate streams.

Counterpart of ``wavenet_tpu/lc.py``. Local conditioning (WaveNet paper
arXiv:1609.03499 §2.5) feeds a second, slower time series h (mel frames,
linguistic features, F0) into every layer's filter/gate pre-activations.
The network consumes the upsampled stream ``[B, T, lc_channels]``; this
module holds the non-learned mappings to sample rate (``repeat`` and
``linear``), the crop/pad to a length and the ``<stem>.lc.npy`` sidecar
reader, in NumPy; and, for training, the frame chunks that the reader
ships instead of the upsampled stream (``LCFrameChunk``) and their
upsampling on the device (``upsample_chunk``, in the train step).

Alignment convention (shared by the forward pass, the loss and every
sampler): the upsampled stream rides the audio timeline; ``lc[t]``
conditions the prediction of sample t.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np


def upsample_lc(features: np.ndarray, hop: int,
                mode: str = "repeat") -> np.ndarray:
    """Upsample frame-rate features [F, C] to sample rate [F*hop, C].

    ``repeat`` holds every frame hop samples (the paper's non-learned
    option); ``linear`` interpolates between frame centers (frame f maps
    to sample f*hop + hop//2), holding the first/last frame at the edges.
    """
    features = np.asarray(features, dtype=np.float32)
    if features.ndim == 1:
        features = features[:, None]
    if features.ndim != 2:
        raise ValueError(f"features must be [F, C], got {features.shape}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    F = features.shape[0]
    if mode == "repeat":
        return np.repeat(features, hop, axis=0)
    if mode == "linear":
        T = F * hop
        centers = np.arange(F, dtype=np.float64) * hop + hop // 2
        t = np.arange(T, dtype=np.float64)
        out = np.empty((T, features.shape[1]), np.float32)
        for ch in range(features.shape[1]):
            out[:, ch] = np.interp(t, centers, features[:, ch])
        return out
    raise ValueError(f"unknown upsample mode '{mode}' "
                     "(choose 'repeat' or 'linear')")


def fit_lc_to_length(lc: np.ndarray, n: int,
                     pad_mode: str = "edge") -> np.ndarray:
    """Crop or pad an upsampled stream [T, C] to exactly n samples: the
    edge value repeated (``edge``) or zeros (``zero``)."""
    lc = np.asarray(lc, dtype=np.float32)
    if lc.shape[0] >= n:
        return lc[:n]
    if pad_mode == "edge":
        pad = np.repeat(lc[-1:], n - lc.shape[0], axis=0) if lc.shape[0] \
            else np.zeros((n, lc.shape[1]), np.float32)
    elif pad_mode == "zero":
        pad = np.zeros((n - lc.shape[0], lc.shape[1]), np.float32)
    else:
        raise ValueError(f"unknown pad_mode '{pad_mode}'")
    return np.concatenate([lc, pad], axis=0)


def load_lc_sidecar(wav_path: str) -> Optional[np.ndarray]:
    """The ``<stem>.lc.npy`` features [F, C] beside a wav, or None."""
    stem, _ = os.path.splitext(wav_path)
    path = stem + ".lc.npy"
    if not os.path.exists(path):
        return None
    arr = np.load(path)
    if arr.ndim == 1:
        arr = arr[:, None]
    return np.ascontiguousarray(arr, dtype=np.float32)


# ---------------------------------------------------------------------------
# Frame chunks, upsampled on the device
# ---------------------------------------------------------------------------
#
# The upsampled stream costs C x 4 bytes a sample on the way to the device
# (~54 MB a paper-config b8 x 16k batch at 80 mels); at hop 200 the frames
# are ~0.5% of that. The reader can ship a chunk's frame window and its
# alignment instead, and the train step rebuilds the host's stream on the
# device: a gather for ``repeat``, a gather and a lerp for ``linear``.


class LCFrameChunk(NamedTuple):
    """One chunk's frame window and alignment, batched ``[B, ...]``
    (numpy arrays from the reader, tensors on the device).

    Chunk position t lies at ``orig_start + t`` on the untrimmed
    utterance's sample timeline. Row 0 of ``frames`` is utterance frame
    ``f0``; ``f_valid`` is the utterance's frame count (the edge hold
    clips to it). Positions with orig < ``zero_before`` (the
    receptive-field zero pad, before the trim start) or t >= ``n_valid``
    (the last short chunk's zero tail) are zero.
    """
    frames: Any        # [B, Fw, C] float32
    orig_start: Any    # [B] int32
    f0: Any            # [B] int32
    f_valid: Any       # [B] int32 (>= 1)
    n_valid: Any       # [B] int32
    zero_before: Any   # [B] int32 (the trim start)


def frame_window_size(width: int, hop: int) -> int:
    """Frame-window rows a ``width``-sample chunk needs."""
    return width // hop + 3


def upsample_chunk(chunk: LCFrameChunk, hop: int, mode: str, width: int):
    """``LCFrameChunk`` -> upsampled stream ``[B, width, C]`` float32, on
    the device of ``chunk.frames``.

    Equals the reader's host chain (``upsample_lc``, ``fit_lc_to_length``,
    the trim slice, the zero pad and the chunking): bit for bit in
    ``repeat`` mode, to float32 rounding in ``linear``. The counterpart
    of the JAX package's ``upsample_chunk_jax``, step for step.
    """
    import torch

    frames = torch.as_tensor(chunk.frames).to(torch.float32)
    dev = frames.device

    def col(x):
        return torch.as_tensor(x, device=dev).to(torch.int64)[:, None]

    n_rows, C = frames.shape[1], frames.shape[2]
    t = torch.arange(width, device=dev)[None, :]                # [1, W]
    orig = col(chunk.orig_start) + t                            # [B, W]
    last, f0 = col(chunk.f_valid) - 1, col(chunk.f0)

    def take(idx):
        """Frame rows at utterance frames ``idx`` (clipped to the
        utterance, then to the window)."""
        idx = torch.minimum(idx.clamp(min=0), last) - f0
        idx = idx.clamp(0, n_rows - 1)
        return torch.gather(frames, 1, idx[:, :, None].expand(-1, -1, C))

    if mode == "repeat":
        out = take(torch.div(orig, hop, rounding_mode="floor"))
    elif mode == "linear":
        # Between frame centres f*hop + hop//2, edges held: where the two
        # clipped ends coincide the lerp is a no-op, as np.interp is
        # outside its range.
        x = (orig - hop // 2) / hop                             # float32
        xf = torch.floor(x)
        w = (x - xf)[:, :, None]
        i0 = xf.to(torch.int64)
        v0, v1 = take(i0), take(i0 + 1)
        out = v0 + (v1 - v0) * w
    else:
        raise ValueError(f"unknown upsample mode '{mode}'")
    keep = (orig >= col(chunk.zero_before)) & (t < col(chunk.n_valid))
    return torch.where(keep[:, :, None], out, torch.zeros((), device=dev))
