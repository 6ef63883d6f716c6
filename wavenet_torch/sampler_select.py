"""Sampler naming, shared by the server (counterpart of
``wavenet_tpu/sampler_select.py``).

The JAX package tries an ordered list of Pallas variants and falls back
to a ``lax.scan`` sampler when one fails to compile. The port has one
sampler: prefill + the ``sampler_decode`` kernel (``generate_cuda``). On a
GPU a failure raises; there is no fallback. On the CPU the same call runs
the kernel's plain version (``decode_reference``), because the tensors
lie there.
"""

from __future__ import annotations


def sampler_name(device) -> str:
    if getattr(device, "type", str(device)) == "cuda":
        return "CUDA (prefill + sampler_decode kernel)"
    return "PyTorch reference (prefill + decode_reference)"
