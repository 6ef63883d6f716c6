"""Dilated causal convolution as shifted matmuls.

Counterpart of ``wavenet_tpu/ops/conv.py``. Layout is the JAX package's:
activations ``[batch, time, channels]``, filters ``[width, in, out]``.
The conv is filter-tap-many shifted matmuls (not cuDNN), so in float32
it runs in full float32 as long as TF32 matmuls are off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv_padded(value: torch.Tensor, filter_: torch.Tensor,
                       dilation: int = 1) -> torch.Tensor:
    """out[t] = sum_k x[t - (fw-1-k)*d] @ W[k], with x[<0] = 0.

    Output length equals input length.
    """
    fw = filter_.shape[0]
    T = value.shape[1]
    out = value @ filter_[fw - 1]
    for k in range(fw - 1):
        shift = (fw - 1 - k) * dilation
        if shift >= T:
            continue
        shifted = F.pad(value, (0, 0, shift, 0))[:, :T, :]
        out = out + shifted @ filter_[k]
    return out


def conv1x1(value: torch.Tensor, filter_: torch.Tensor) -> torch.Tensor:
    """1x1 conv == per-timestep matmul. filter_ is [1, in, out] or [in, out]."""
    w = filter_[0] if filter_.dim() == 3 else filter_
    return value @ w
