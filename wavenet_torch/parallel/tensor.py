"""The collectives of tensor (channel) parallelism, written by hand.

GSPMD derives the JAX package's tensor-parallel program from the sharding
annotations of ``parallel/sharding.py``. PyTorch has no such compiler
here, so the forward calls the collectives itself, in Megatron's pattern:

* ``copy`` (identity forward, all-reduce of the gradient backward) where a
  replicated activation enters a column-parallel product (the residual
  stream into filter/gate, the GC and LC rows, the head's hidden into
  postprocess1);
* ``reduce`` (all-reduce forward, identity backward) after a
  row-parallel product (dense, skip, postprocess2); the row-parallel
  biases ``dense_bias``, ``skip_bias`` and ``postprocess2_bias`` are added
  once, after it, as the single-device forward adds them.

``models/wavenet.py`` and ``sample.py`` take a :class:`TensorParallel`
as ``tp=`` and run their single-device code when it is None. Under
``remat`` the layer's ``reduce`` runs again when the backward recomputes
the layer, on every rank in the same order.

The fused stack kernels take whole weights. JAX's ``_dilated_stack_pallas``
under ``jit`` with model-sharded weights runs its Pallas kernel as a custom
call, whose operands the SPMD partitioner gathers; the port does the same
(``gather_params``: the kernel runs on the gathered weights on every rank,
and each rank keeps its slice of their gradients).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from wavenet_torch.parallel.sharding import (
    DATA_AXIS, MODEL_AXIS, axis_index, axis_size, shard_dims)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` (all-reduce); the gradient passes as it is,
    each rank's own part of the sum."""
    return _ReduceFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    """Concatenate the group's shards along ``dim``; the gradient of the
    whole (the same on every rank) is sliced back to this rank's shard."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
                .contiguous(), None, None)


class TensorParallel:
    """The "model" axis of ``mesh``: its group and the layout of
    ``config``'s params over it."""

    def __init__(self, mesh, config, axis: str = MODEL_AXIS):
        self.group = mesh.get_group(axis)
        self.size = axis_size(mesh, axis)
        self.rank = axis_index(mesh, axis)
        self.config = config

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToGroup.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_group(x, self.group)

    def gather_params(self, params) -> dict:
        """Whole params from this rank's shards (differentiable)."""
        dims = shard_dims(self.config, params)
        return {k: (v if dims[k] is None
                    else _GatherFromGroup.apply(v, dims[k], self.group))
                for k, v in params.items()}

    def l2_loss(self, params) -> torch.Tensor:
        """0.5 * sum(v^2) over the whole non-bias params: the sharded
        ones' sum reduced over the group, the replicated ones' added
        once."""
        dims = shard_dims(self.config, params)

        def part(sharded: bool):
            return sum(0.5 * torch.sum(torch.square(v))
                       for k, v in params.items()
                       if not k.endswith("_bias")
                       and (dims[k] is not None) == sharded)

        return self.reduce(part(True)) + part(False)

    def sum_of_squares(self, tensors: dict) -> torch.Tensor:
        """sum(t^2) over the whole tensors of which ``tensors`` (keyed as
        the params) holds this rank's shards."""
        dims = shard_dims(self.config, tensors)
        sq = {k: torch.sum(torch.square(v)) for k, v in tensors.items()}
        sharded = sum(sq[k] for k in sorted(sq) if dims[k] is not None)
        replicated = sum(sq[k] for k in sorted(sq) if dims[k] is None)
        with torch.no_grad():
            return self.reduce(sharded) + replicated


def tensor_parallel(mesh, config):
    """A :class:`TensorParallel` where ``mesh`` splits the model over
    more than one rank, else None (the single-device forward)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return None
    return TensorParallel(mesh, config)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh,
                     axis: str = DATA_AXIS) -> None:
    """Average each tensor over ``axis`` in place, in one all-reduce of a
    flat buffer. On a mesh the collective runs whatever the axis size (at
    one rank it copies: the mean of one is exact)."""
    tensors = list(tensors)
    if mesh is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    flat /= axis_size(mesh, axis)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
