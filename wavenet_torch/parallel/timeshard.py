"""Sequence (time-axis) parallelism with a receptive-field halo exchange.

Counterpart of ``wavenet_tpu/parallel/timeshard.py``. WaveNet has no
attention: every layer is causal with a finite receptive field, so ONE
exchange at the input suffices:

* the time axis of a chunk is split over a mesh axis ("time"; a
  ``DeviceMesh`` of processes, ``parallel/sharding.py``),
* each rank fetches the previous rank's last ``receptive_field`` raw
  samples (one all-gather of the ranks' tails over the time group, each
  rank keeping its left neighbour's; zeros on rank 0, which are the
  reader's left padding),
* each rank runs the normal stack on ``[halo | local]`` and scores only
  its own positions; the sums of cross-entropy over valid positions (and
  of its gradients) are all-reduced over time (and data) and divided by
  the count of valid positions.

Loss and gradients equal the unsharded ``loss_fn``'s up to float
reordering (tests/test_torch_timeshard.py holds them to JAX's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from wavenet_torch.audio import mu_law_encode
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import embed_gc, forward, forward_codes
from wavenet_torch.parallel.sharding import axis_index, axis_size, data_rows
from wavenet_torch.parallel.tensor import reduce_from_group

TIME_AXIS = "time"


def _check_slice(config: WaveNetConfig, Tl: int) -> None:
    rf = config.receptive_field
    if Tl <= rf:
        raise ValueError(f"local time slice ({Tl}) must exceed the "
                         f"receptive field ({rf})")


def _halo(local: torch.Tensor, rf: int, mesh, axis: str) -> torch.Tensor:
    """The previous time rank's last ``rf`` samples [B, rf] (zeros on
    rank 0)."""
    n = axis_size(mesh, axis)
    idx = axis_index(mesh, axis)
    tail = local[:, -rf:].detach().contiguous()
    if n == 1:
        return torch.zeros_like(tail)
    tails = [torch.empty_like(tail) for _ in range(n)]
    dist.all_gather(tails, tail, group=mesh.get_group(axis))
    return tails[idx - 1] if idx > 0 else torch.zeros_like(tail)


def _local_ce_sum(params, config: WaveNetConfig, halo: torch.Tensor,
                  local: torch.Tensor, shard_index: int,
                  gc_emb) -> torch.Tensor:
    """Sum of per-position CE over this rank's VALID target positions.

    ``halo``: [B, rf] raw samples of the previous rank (zeros on rank 0).
    ``local``: [B, Tl] this rank's raw samples. A local position is valid
    where its GLOBAL index is >= receptive_field (only rank 0 masks)."""
    c = config
    rf = c.receptive_field
    B, Tl = local.shape
    window = torch.cat([halo, local], dim=1)                 # [B, rf + Tl]
    encoded = mu_law_encode(window, c.quantization_channels)
    # Predictions of window positions [rf, rf + Tl) are logit rows
    # [rf - 1, rf + Tl - 1), the one-step alignment of loss_fn; the head
    # runs only there.
    if c.scalar_input:
        raw = forward(params, c, window[:, :-1, None].to(torch.float32),
                      gc_emb, head_from=rf - 1)
    else:
        raw = forward_codes(params, c, encoded[:, :-1], gc_emb,
                            head_from=rf - 1)
    logp = torch.log_softmax(raw, dim=-1)                    # [B, Tl, Q]
    targets = encoded[:, rf:].long()
    ce = -torch.gather(logp, -1, targets[..., None])[..., 0]
    global_pos = shard_index * Tl + torch.arange(Tl, device=local.device)
    valid = (global_pos >= rf).to(ce.dtype)
    return torch.sum(ce * valid[None, :])


def _l2(params) -> torch.Tensor:
    return sum(0.5 * torch.sum(torch.square(v)) for k, v in params.items()
               if not k.endswith("_bias"))


def _groups(mesh, axes):
    """The groups of the named axes of ``mesh`` (at one rank an
    all-reduce copies, exactly)."""
    if mesh is None:
        return []
    return [mesh.get_group(a) for a in axes if a is not None]


def time_sharded_loss(params, config: WaveNetConfig, audio: torch.Tensor,
                      gc_ids: Optional[torch.Tensor] = None,
                      l2_regularization_strength: Optional[float] = None,
                      mesh=None, axis_name: str = TIME_AXIS,
                      data_axis: Optional[str] = None):
    """Loss over a time-sharded batch, from this rank's slice.

    ``audio``: the local [B, Tl] time slice (and, with ``data_axis``, the
    rank's data rows) of a [B, T] chunk whose first receptive_field
    samples are zero padding (reader layout); ``gc_ids`` the local rows'.
    Returns ``loss_fn``'s (total, aux), the CE mean taken over ALL
    ranks' valid positions. Its gradients on a rank are that rank's part:
    summed over the time (and data) groups they are the whole loss's
    (``make_time_sharded_grad_fn`` does this)."""
    c = config
    rf = c.receptive_field
    B, Tl = audio.shape
    _check_slice(c, Tl)
    n_shards = axis_size(mesh, axis_name)
    halo = _halo(audio, rf, mesh, axis_name)
    gc_emb = embed_gc(params, c, gc_ids) if gc_ids is not None else None
    ce_sum = _local_ce_sum(params, c, halo, audio,
                           axis_index(mesh, axis_name), gc_emb)
    for group in _groups(mesh, (axis_name, data_axis)):
        ce_sum = reduce_from_group(ce_sum, group)
    n_batch = B * (axis_size(mesh, data_axis) if data_axis else 1)
    n_valid = n_batch * (n_shards * Tl - rf)
    ce = ce_sum / n_valid
    aux = {"ce_loss": ce}
    total = ce
    if l2_regularization_strength:
        # Params are replicated: the L2 term is the same on every rank and
        # added once, outside the sums.
        l2 = _l2(params)
        aux["l2_loss"] = l2
        total = ce + l2_regularization_strength * l2
    aux["total_loss"] = total
    return total, aux


def make_time_sharded_grad_fn(config: WaveNetConfig, mesh,
                              l2_regularization_strength=None,
                              time_axis: str = TIME_AXIS,
                              data_axis: Optional[str] = None):
    """Build ``fn(params, audio[, gc_ids]) -> ((loss, aux), grads)``.

    ``mesh`` (a ``DeviceMesh``) has ``time_axis`` (and ``data_axis`` if
    given). Every rank passes the whole [B, T] chunk and its [B] speaker
    ids, and the whole params (replicated); the rank computes on its data
    rows and its time slice (the JAX function's ``P(data_axis,
    time_axis)``). Gradients come back whole on every rank (summed over
    the mesh, divided by the count of valid positions, plus the L2
    term's, added once), ready for a replicated optimizer update."""
    c = config
    lam = l2_regularization_strength

    def fn(params, audio: torch.Tensor, gc_ids=None):
        rf = c.receptive_field
        n_t = axis_size(mesh, time_axis)
        B, T = audio.shape
        if T % n_t:
            raise ValueError(f"time length {T} not divisible by the time "
                             f"axis {n_t}")
        Tl = T // n_t
        _check_slice(c, Tl)
        rows = data_rows(B, mesh, data_axis) if data_axis else slice(0, B)
        t_idx = axis_index(mesh, time_axis)
        local = audio[rows, t_idx * Tl:(t_idx + 1) * Tl]
        halo = _halo(local, rf, mesh, time_axis)
        keys = sorted(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad():
            gc_emb = (embed_gc(leaves, c, gc_ids[rows])
                      if c.gc_enabled and gc_ids is not None else None)
            local_sum = _local_ce_sum(leaves, c, halo, local, t_idx, gc_emb)
            grads = torch.autograd.grad(local_sum,
                                        [leaves[k] for k in keys],
                                        allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(keys, grads)]
        # One flat all-reduce a group: [ce sum | every gradient].
        flat = torch.cat([local_sum.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        for g in _groups(mesh, (time_axis, data_axis)):
            dist.all_reduce(flat, group=g)
        flat = flat / (B * (T - rf))          # the valid positions
        ce = flat[0]
        out, offset = {}, 1
        for k in keys:
            n = leaves[k].numel()
            out[k] = flat[offset:offset + n].view_as(leaves[k])
            offset += n
        aux = {"ce_loss": ce}
        total = ce
        if lam:
            # Params are replicated: the L2 term and its gradient are the
            # same on every rank, added once, outside the sums.
            with torch.no_grad():
                l2 = _l2(params)
            aux["l2_loss"] = l2
            total = ce + lam * l2
            out = {k: (g + lam * params[k].detach()
                       if not k.endswith("_bias") else g)
                   for k, g in out.items()}
        aux["total_loss"] = total
        return (total, aux), {k: out[k] for k in params}

    return fn
