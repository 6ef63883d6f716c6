"""Sampler selection, shared by the CLI and the server (counterpart of
``wavenet_tpu/sampler_select.py``).

The JAX package tries an ordered ladder of Pallas variants, each offered
only where its estimate of a TPU core's VMEM fits, and falls back to its
``lax.scan`` sampler when none is offered or none compiles. The port
keeps what that ladder decides for a reason of the model (no kernel at
``filter_width != 2``) and routes the rest by what its own CUDA kernels
hold (``kernels.sampler.route_plan``, from the card's opt-in shared
memory; on the CPU an H100's): prefill + one launch of a decode kernel
(``generate_cuda``), which serves any batch size in one launch, wherever
one can launch. The route (``kernels.sampler.cluster_plan``, then
``tile_plan``) takes ``sampler_cluster`` (paper/gc b1-b120 and wide
b1-b28 on an H100), ``sampler_tiles`` (paper/gc b121-b525) or
``sampler_decode`` (the rest, the sharded config at every batch among
them). ``precision="bfloat16"`` forwards ``weight_dtype=torch.bfloat16``,
as the JAX ladder's first rung does: the bf16 mode of the same kernel
runs, the ring stays float32. The JAX ladder reaches its bf16-ring rungs
(``state_dtype=bfloat16``) only after that rung fails to compile; the
port has one rung, which raises instead, so the CLI and the server never
ask for a bf16 ring (``generate_cuda(state_dtype=torch.bfloat16)`` takes
one). A local-conditioning stream (``lc``) runs
the LC modes of ``sampler_cluster`` and ``sampler_decode``, at either
precision (the tiles kernel has none, so LC above the cluster range runs
``sampler_decode``). On a GPU a failure raises; there is no fallback. On
the CPU the same call runs the kernels' plain version
(``decode_reference``), because the tensors lie there.
``sampler="scan"`` runs the scan sampler of ``wavenet_torch.sample``,
which ignores the precision, as in the JAX package.
"""

from __future__ import annotations

import torch

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decode_offered(config, batch_size: int, device="cuda") -> bool:
    """Whether a decode kernel launches for ``batch_size`` rows on
    ``device``: on a CUDA device where its route names one
    (``kernels.sampler.device_decode_route``, from its own opt-in shared
    memory and resident clusters); elsewhere, or with no card present,
    where one would on an H100 (``kernels.sampler.can_decode`` at
    ``H100_SMEM_OPTIN``: the route names a kernel wherever one row of
    ``sampler_decode`` fits)."""
    from wavenet_torch.kernels import sampler as ks

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return ks.device_decode_route(config, batch_size, dev.index) \
            is not None
    return batch_size >= 1 and ks.can_decode(config, ks.H100_SMEM_OPTIN)


def sampler_name(device, precision: str = "float32",
                 lc: bool = False) -> str:
    """What the CLI's and the server's generation runs on ``device`` where
    a decode kernel can launch; ``lc``: with a local-conditioning
    stream."""
    tag = (", bf16 weights" if precision == "bfloat16" else "") + (
        ", local conditioning" if lc else "")
    if getattr(device, "type", str(device)) == "cuda":
        kernels = ("sampler_cluster/sampler_decode" if lc else
                   "sampler_cluster/sampler_tiles/sampler_decode")
        return f"CUDA (prefill + {kernels} kernel{tag})"
    return f"PyTorch reference (prefill + decode_reference{tag})"


def sampler_attempts(config, sampler: str = "auto",
                     precision: str = "float32", device="cuda",
                     lc: bool = False, batch_size: int = 1):
    """Ordered (name, ``generate_cuda`` kwargs) candidates; empty means
    the scan sampler. One candidate at most (the decode kernels serve any
    batch in one launch), offered wherever a decode kernel can launch for
    ``batch_size`` rows (``decode_offered``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of "
                         f"{tuple(PRECISIONS)}")
    if sampler not in ("auto", "pallas"):
        return []
    if not decode_offered(config, batch_size, device):
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
                                lc is not None, batch_size)
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
