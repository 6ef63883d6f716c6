"""Sampler selection, shared by the CLI and the server (counterpart of
``wavenet_tpu/sampler_select.py``).

The JAX package tries an ordered ladder of Pallas variants, each offered
only where its VMEM estimate is under ``GENEROUS_VMEM``, and falls back to
its ``lax.scan`` sampler when none is offered or none compiles. The port
routes as that ladder does: where JAX offers no rung at the batch size and
run length (``jax_ladder_offers``, on the port's own copies of the three
estimators; the sharded config at every batch), it runs the scan sampler;
elsewhere it takes the ladder's first rung only: prefill + one launch of a
decode kernel (``generate_cuda``), which serves any batch size in one
launch. The route (``kernels.sampler.cluster_plan``, then ``tile_plan``)
takes ``sampler_cluster`` (paper/gc b1-b120 and wide b1-b28 on an H100),
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

from typing import Optional

import torch

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The JAX ladder's budget and its estimators' constants
# (wavenet_tpu/sampler_select.py, wavenet_tpu/kernels/sampler.py): an
# attempt whose estimated VMEM is not below the budget is not offered.
GENEROUS_VMEM = 40 * 1024 * 1024
_IO_CHUNK = 1024     # rows per forced/codes chunk of the streamed kernel


def _lanes(n: int) -> int:
    """A buffer's last dimension padded to 128 lanes."""
    return -(-n // 128) * 128


def _weights(c, B: int) -> int:
    """The lane-padded weight floats every estimator counts."""
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    return (2 * c.input_channels * _lanes(R)
            + L * (2 * R * _lanes(2 * D) + B * _lanes(2 * D)
                   + D * (_lanes(R) + _lanes(S)) + _lanes(R))
            + _lanes(S) + S * _lanes(S) + _lanes(S) + S * _lanes(Q)
            + _lanes(Q))


def sampler_vmem_bytes(config, batch_size: int, n_samples: int,
                       state_bytes: int = 4) -> int:
    """The JAX all-VMEM sampler's estimate (its ladder's defaults: one
    logits row, no resume inputs, no transposed weights); ``state_bytes``
    2 is the bf16 ring's."""
    c, B = config, batch_size
    state = sum(c.dilations) * B * _lanes(c.residual_channels)
    outputs = n_samples * _lanes(B) + B * _lanes(c.quantization_channels)
    lc = 0
    if c.lc_enabled:
        lc = (c.num_layers * c.lc_channels * _lanes(2 * c.dilation_channels)
              + n_samples * B * _lanes(c.lc_channels))
    return (4 * (_weights(c, B) + outputs + lc + B * _lanes(c.input_channels))
            + state_bytes * state)


def hbm_sampler_vmem_bytes(config, batch_size: int, n_samples: int) -> int:
    """The JAX HBM-ring sampler's estimate (the ring in HBM)."""
    c, B = config, batch_size
    streams = 2 * n_samples * _lanes(B)
    slots = 2 * c.num_layers * B * 128 + 64 * B * 128
    return 4 * (_weights(c, B) + streams + slots
                + B * _lanes(c.quantization_channels))


def _io_chunk_for(batch_size: int) -> int:
    return max(8, (_IO_CHUNK * 128) // _lanes(batch_size))


def stream_hbm_sampler_vmem_bytes(config, batch_size: int) -> int:
    """The JAX streamed-IO HBM-ring sampler's estimate (independent of the
    run's length)."""
    c, B = config, batch_size
    weights = _weights(c, B)
    zc = min(64, sum(c.dilations), max(8, (1 << 21) // (max(B, 1) * 128 * 4)))
    slots = 2 * c.num_layers * B * 128 + zc * B * 128
    io = 2 * 2 * _io_chunk_for(B) * _lanes(B)
    if c.lc_enabled:
        weights += c.num_layers * c.lc_channels * _lanes(
            2 * c.dilation_channels)
        io += 2 * (1 << 19)
    return 4 * (weights + slots + io + B * _lanes(c.quantization_channels))


def jax_ladder_offers(config, batch_size: int, n_total: int) -> bool:
    """Whether the JAX ladder offers any Pallas rung for ``batch_size``
    streams of ``n_total`` steps (forced prefix + samples): the streamed
    decode (chunks of 512 past b512), the all-VMEM kernel at f32 or bf16
    ring state, the HBM ring, or a batch-chunked bf16 ring."""
    B, G = batch_size, GENEROUS_VMEM
    if (stream_hbm_sampler_vmem_bytes(config, B) < G
            or (B > 512 and stream_hbm_sampler_vmem_bytes(config, 512) < G)
            or hbm_sampler_vmem_bytes(config, B, n_total) < G):
        return True
    return any(sampler_vmem_bytes(config, bc, n_total, state_bytes=sb) < G
               for bc, sb in [(B, 4), (B, 2)] + [
                   (bc, 2) for bc in (16, 8, 4, 2, 1)
                   if B % bc == 0 and bc < B])


def sampler_name(device, precision: str = "float32",
                 lc: bool = False) -> str:
    """What the CLI's and the server's generation runs on ``device`` where
    the ladder offers a kernel; ``lc``: with a local-conditioning stream."""
    tag = (", bf16 weights" if precision == "bfloat16" else "") + (
        ", local conditioning" if lc else "")
    if getattr(device, "type", str(device)) == "cuda":
        kernels = ("sampler_cluster/sampler_decode" if lc else
                   "sampler_cluster/sampler_tiles/sampler_decode")
        return f"CUDA (prefill + {kernels} kernel{tag})"
    return f"PyTorch reference (prefill + decode_reference{tag})"


def sampler_attempts(config, sampler: str = "auto",
                     precision: str = "float32", device="cuda",
                     lc: bool = False, batch_size: int = 1,
                     n_total: Optional[int] = None):
    """Ordered (name, ``generate_cuda`` kwargs) candidates; empty means
    the scan sampler. One candidate at most (the decode kernels serve any
    batch in one launch), offered where the JAX ladder offers a rung for
    ``batch_size`` streams of ``n_total`` steps (forced prefix + samples;
    default the receptive field alone)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of "
                         f"{tuple(PRECISIONS)}")
    if sampler not in ("auto", "pallas") or config.filter_width != 2:
        return []
    if n_total is None:
        n_total = config.receptive_field
    if not jax_ladder_offers(config, batch_size, n_total):
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
    n_forced = (config.receptive_field if seed_codes is None
                else int(seed_codes.shape[1]))
    attempts = sampler_attempts(config, sampler, precision, dev,
                                lc is not None, batch_size,
                                n_samples + n_forced)
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
