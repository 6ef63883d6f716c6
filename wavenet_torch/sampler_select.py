"""Sampler selection, shared by the CLI and the server (counterpart of
``wavenet_tpu/sampler_select.py``).

The JAX package tries an ordered ladder of Pallas variants and falls
back to its ``lax.scan`` sampler when one fails to compile. The port
keeps the ladder's first rung only: prefill + one launch of a decode
kernel (``generate_cuda``: ``sampler_cluster`` or ``sampler_decode``, as
``cluster_plan`` routes), which serves any batch size in one launch. On a GPU a failure raises; there is no fallback. On
the CPU the same call runs the kernel's plain version
(``decode_reference``), because the tensors lie there. ``sampler="scan"``
runs the scan sampler of ``wavenet_torch.sample``.
"""

from __future__ import annotations

import torch


def sampler_name(device) -> str:
    """What the CLI's and the server's generation runs on ``device``."""
    if getattr(device, "type", str(device)) == "cuda":
        return "CUDA (prefill + sampler_cluster/sampler_decode kernel)"
    return "PyTorch reference (prefill + decode_reference)"


def sampler_attempts(config, sampler: str = "auto",
                     precision: str = "float32", device="cuda"):
    """Ordered (name, ``generate_cuda`` kwargs) candidates; empty means
    the scan sampler. One candidate at most: the port has no VMEM budget
    to fall through, so neither the batch size nor the length prunes the
    ladder as in the JAX package."""
    if precision == "bfloat16":
        raise NotImplementedError(
            "bfloat16 sampling is not ported yet (ROADMAP.md queue 1, "
            "item 1, step 1c)")
    if sampler not in ("auto", "pallas") or config.filter_width != 2:
        return []
    return [(sampler_name(device), dict(prefill=True))]


def generate_with_fallback(params, config, n_samples: int, *,
                           seed: int = 0, batch_size: int = 1, gc_ids=None,
                           temperature: float = 1.0, seed_codes=None,
                           sampler: str = "auto",
                           precision: str = "float32", log=print):
    """Generate with the selected sampler; returns (codes [B, n_samples],
    name, kwargs), kwargs None when the scan sampler ran. The device is
    the parameters' device; the scan sampler draws from a
    ``torch.Generator`` seeded with ``seed`` there."""
    from wavenet_torch.kernels.sampler import generate_cuda
    from wavenet_torch.sample import generate

    dev = params["postprocess2"].device
    attempts = sampler_attempts(config, sampler, precision, dev)
    if attempts:
        name, kw = attempts[0]
        codes = generate_cuda(params, config, n_samples, seed=seed,
                              batch_size=batch_size, gc_ids=gc_ids,
                              temperature=temperature,
                              seed_codes=seed_codes, **kw)
        log(f"Using {name} sampler.")
        return codes, name, kw

    log("Using scan sampler.")
    key = torch.Generator(device=dev).manual_seed(int(seed))
    if seed_codes is not None:
        seed_codes = torch.as_tensor(seed_codes).to(dev)
    codes = generate(params, config, n_samples, key, batch_size=batch_size,
                     gc_ids=gc_ids, temperature=temperature,
                     seed_codes=seed_codes)
    return codes, "scan", None
