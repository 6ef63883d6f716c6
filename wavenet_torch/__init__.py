"""wavenet_torch: the PyTorch/CUDA port of wavenet_tpu.

Module and function names follow ``wavenet_tpu`` so each counterpart is
easy to find; parameters are the same flat dict of layer-stacked arrays,
so one numpy dict of weights runs in both packages. This package imports
``torch``, numpy and scipy only — never ``jax`` or ``wavenet_tpu``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU; :func:`resolve_device` raises when a GPU is asked for and
none is present, so nothing falls back silently.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "WaveNetConfig", "CONFIGS"]


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without a GPU);
    "cpu" -> the CPU. Never falls back from CUDA to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wavenet_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


from wavenet_torch.models.config import CONFIGS, WaveNetConfig  # noqa: E402
