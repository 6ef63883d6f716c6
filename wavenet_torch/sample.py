"""Ring-slot math shared by the sampler prefill.

Counterpart of ``wavenet_tpu/sample.py:ring_slot_blocks``; the scan
sampler of that module is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def ring_slot_blocks(layer_ins: Sequence[torch.Tensor],
                     dilations: Sequence[int], T: int) -> List[torch.Tensor]:
    """Per-layer ring-slot blocks for prefill: block_l[r] = x_l(tau_r).

    ``layer_ins[l]`` is [B, keep_l, R], the last keep_l = min(d_l, T)
    residual-stream values entering layer l. Slot tau % d_l holds
    x_l(tau) for the last keep_l positions tau < T and stays zero
    elsewhere: left-pad the kept window to d rows, then roll by T % d so
    window row j (time tau = T - d + j) lands on row tau % d.
    """
    blocks = []
    for l, d in enumerate(dilations):
        w = layer_ins[l].transpose(0, 1)                   # [keep_l, B, R]
        keep = w.shape[0]
        if keep < d:
            w = torch.cat([w.new_zeros((d - keep,) + tuple(w.shape[1:])), w],
                          dim=0)
        blocks.append(torch.roll(w, T % d, dims=0))        # [d, B, R]
    return blocks
