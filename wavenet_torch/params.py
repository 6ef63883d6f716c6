"""Weights across packages: numpy dicts <-> torch parameter dicts, and npz.

A parameter dict is flat (``models/wavenet.py`` lists the keys), so the
JAX package's ``{k: np.asarray(v)}`` loads here unchanged, and
``params_to_numpy`` gives back a dict the JAX package accepts.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from wavenet_torch import resolve_device


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) dict -> float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in arrays.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def save_npz(path: str, params: Mapping[str, torch.Tensor]) -> None:
    np.savez(path, **params_to_numpy(params))


def load_npz(path: str, device=None) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)
