"""Receptive-field arithmetic for dilated causal conv stacks.

Counterpart of ``wavenet_tpu/utils/receptive_field.py``:

    receptive_field = (filter_width - 1) * sum(dilations) + 1
    receptive_field += (initial_filter_width - 1) if scalar_input
                       else (filter_width - 1)
"""

from __future__ import annotations

from typing import Sequence


def calculate_receptive_field(
    filter_width: int,
    dilations: Sequence[int],
    scalar_input: bool = False,
    initial_filter_width: int = 32,
) -> int:
    """Number of input samples a single output sample depends on."""
    receptive_field = (filter_width - 1) * sum(dilations) + 1
    if scalar_input:
        receptive_field += initial_filter_width - 1
    else:
        receptive_field += filter_width - 1
    return receptive_field
