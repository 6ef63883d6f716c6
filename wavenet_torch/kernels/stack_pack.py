"""Weight packing for the fused dilated-stack training kernel.

Counterpart of ``wavenet_tpu/kernels/stack_pack.py``: filter|gate taps
concatenated on K and N, so each layer's two dilated convs become one
[T, 2R] x [2R, 2D] matmul, with the biases and the global-conditioning
contribution folded into one additive term per (layer, batch row).
Plain differentiable PyTorch: autograd maps the kernel's ``dw_fg`` and
``dadd`` back onto ``filter``, ``gate``, the biases, ``gc_filter``,
``gc_gate`` and ``gc_embedding``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wavenet_torch.models.config import WaveNetConfig


def tap_offsets(config: WaveNetConfig) -> Tuple[int, ...]:
    """Row offset of each layer's tap window in a packed ring carry."""
    return tuple(int(o) for o in np.cumsum((0,) + config.dilations[:-1]))


def pack_stack_weights(params, config: WaveNetConfig,
                       gc_embedding: Optional[torch.Tensor],
                       batch_size: int):
    """Model params -> (w_fg [L,2R,2D], wd [L,D,R], add [L,B,2D], bd [L,1,R])."""
    c = config
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    wf, wg = params["filter"], params["gate"]
    dev = wf.device
    w_fg = torch.cat([torch.cat([wf[:, 0], wg[:, 0]], dim=-1),
                      torch.cat([wf[:, 1], wg[:, 1]], dim=-1)], dim=1)
    wd = params["dense"]
    add = torch.zeros((L, batch_size, 2 * D), dtype=torch.float32,
                      device=dev)
    if c.use_biases:
        add = add + torch.cat([params["filter_bias"], params["gate_bias"]],
                              dim=-1)[:, None, :]
        bd = params["dense_bias"][:, None, :]
    else:
        bd = torch.zeros((L, 1, R), dtype=torch.float32, device=dev)
    if gc_embedding is not None:
        w_gc = torch.cat([params["gc_filter"], params["gc_gate"]], dim=-1)
        add = add + torch.einsum("bg,lgd->lbd",
                                 gc_embedding.to(torch.float32), w_gc)
    return w_fg, wd, add, bd
