"""Local conditioning: frame-rate features -> sample-rate streams.

Counterpart of ``wavenet_tpu/lc.py`` (its host functions; NumPy only).
Local conditioning (WaveNet paper arXiv:1609.03499 §2.5) feeds a second,
slower time series h (mel frames, linguistic features, F0) into every
layer's filter/gate pre-activations. The network consumes the upsampled
stream ``[B, T, lc_channels]``; this module holds the non-learned
mappings to sample rate (``repeat`` and ``linear``), the crop/pad to a
length and the ``<stem>.lc.npy`` sidecar reader.

Alignment convention (shared by the forward pass and every sampler): the
upsampled stream rides the audio timeline; ``lc[t]`` conditions the
prediction of sample t. The training-side frame chunks and their device
upsampling wait for LC training (ROADMAP.md queue 1, item 2, step 2b).
"""

from __future__ import annotations

import os
from typing import Optional

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
