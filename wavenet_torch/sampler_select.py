"""Sampler selection, shared by the CLI and the server (counterpart of
``wavenet_tpu/sampler_select.py``).

The JAX package tries an ordered ladder of Pallas variants and falls
back to its ``lax.scan`` sampler when one fails to compile. The port
keeps the ladder's first rung only: prefill + one launch of a decode
kernel (``generate_cuda``), which serves any batch size in one launch.
The route (``kernels.sampler.cluster_plan``, then ``tile_plan``) takes
``sampler_cluster`` (paper/gc b1-b120 and wide b1-b28 on an H100),
``sampler_tiles`` (paper/gc b121-b525) or ``sampler_decode`` (the rest).
``precision="bfloat16"`` forwards ``weight_dtype=torch.bfloat16``, as the
JAX ladder's first rung does: the bf16 mode of the same kernel runs, the
ring stays float32. A local-conditioning stream (``lc``) runs the LC
modes of ``sampler_cluster`` and ``sampler_decode``, at either precision
(the tiles kernel has none, so LC above the cluster range runs
``sampler_decode``). On a GPU a failure raises; there is no fallback. On
the CPU the same call runs the kernels' plain version
(``decode_reference``), because the tensors lie there.
``sampler="scan"`` runs the scan sampler of ``wavenet_torch.sample``,
which ignores the precision, as in the JAX package.
"""

from __future__ import annotations

import torch

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sampler_name(device, precision: str = "float32",
                 lc: bool = False) -> str:
    """What the CLI's and the server's generation runs on ``device``;
    ``lc``: with a local-conditioning stream."""
    tag = (", bf16 weights" if precision == "bfloat16" else "") + (
        ", local conditioning" if lc else "")
    if getattr(device, "type", str(device)) == "cuda":
        kernels = ("sampler_cluster/sampler_decode" if lc else
                   "sampler_cluster/sampler_tiles/sampler_decode")
        return f"CUDA (prefill + {kernels} kernel{tag})"
    return f"PyTorch reference (prefill + decode_reference{tag})"


def sampler_attempts(config, sampler: str = "auto",
                     precision: str = "float32", device="cuda",
                     lc: bool = False):
    """Ordered (name, ``generate_cuda`` kwargs) candidates; empty means
    the scan sampler. One candidate at most: the port has no VMEM budget
    to fall through, so neither the batch size nor the length prunes the
    ladder as in the JAX package."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of "
                         f"{tuple(PRECISIONS)}")
    if sampler not in ("auto", "pallas") or config.filter_width != 2:
        return []
    kw = dict(prefill=True)
    if precision == "bfloat16":
        kw["weight_dtype"] = torch.bfloat16
    return [(sampler_name(device, precision, lc), kw)]


def generate_with_fallback(params, config, n_samples: int, *,
                           seed: int = 0, batch_size: int = 1, gc_ids=None,
                           temperature: float = 1.0, seed_codes=None,
                           sampler: str = "auto",
                           precision: str = "float32", log=print, lc=None):
    """Generate with the selected sampler; returns (codes [B, n_samples],
    name, kwargs), kwargs None when the scan sampler ran. The device is
    the parameters' device; the scan sampler draws from a
    ``torch.Generator`` seeded with ``seed`` there. ``lc`` [B, n_samples,
    C_lc] (local conditioning) goes to either sampler as it is."""
    from wavenet_torch.kernels.sampler import generate_cuda
    from wavenet_torch.sample import generate

    dev = params["postprocess2"].device
    attempts = sampler_attempts(config, sampler, precision, dev,
                                lc is not None)
    if attempts:
        name, kw = attempts[0]
        codes = generate_cuda(params, config, n_samples, seed=seed,
                              batch_size=batch_size, gc_ids=gc_ids,
                              temperature=temperature,
                              seed_codes=seed_codes, lc=lc, **kw)
        log(f"Using {name} sampler.")
        return codes, name, kw

    log("Using scan sampler.")
    key = torch.Generator(device=dev).manual_seed(int(seed))
    if seed_codes is not None:
        seed_codes = torch.as_tensor(seed_codes).to(dev)
    if lc is not None:
        lc = torch.as_tensor(lc).to(dev, torch.float32)
    codes = generate(params, config, n_samples, key, batch_size=batch_size,
                     gc_ids=gc_ids, temperature=temperature,
                     seed_codes=seed_codes, lc=lc)
    return codes, "scan", None
