"""Mesh + sharding layout: data parallel x tensor (channel) parallel.

Counterpart of ``wavenet_tpu/parallel/sharding.py``. PyTorch's idiom is
one process per device: the processes of a ``torch.distributed`` group
make up a ``(data, model)`` ``DeviceMesh``
(``torch.distributed.device_mesh.init_device_mesh``; NCCL on ``cuda``,
gloo on ``cpu``), and each process keeps only its own shard of every
sharded tensor, as a plain tensor. GSPMD inserts the collectives of the
JAX package from its annotations; here ``parallel/tensor.py`` writes them
into the forward (Megatron's pattern) and the train step averages the
gradients over "data" itself.

Tensor-parallel layout (the JAX package's), the Megatron column/row
pattern mapped onto the WaveNet gated unit:

  filter/gate  [L, fw, R, D] — COLUMN parallel: shard output D. Each rank
                               computes its slice of tanh/sigmoid locally.
  dense        [L, D, R]     — ROW parallel: shard input D; the partial
                               residual projections are all-reduced.
  skip         [L, D, S]     — ROW parallel over D, like dense.
  postprocess1 [S, S]        — COLUMN parallel: shard output S.
  postprocess2 [S, Q]        — ROW parallel: shard input S; logits
                               all-reduced.
  gc weights   [L, G, D]     — column parallel with filter/gate.

Residual-channel activations [B, T, R] stay replicated over "model" (R is
small); the batch shards over "data". A spec is a tuple with one entry a
dimension, the mesh axis that dimension is split over or None (the JAX
``PartitionSpec``'s entries). Without a process group ``make_mesh`` gives
None, which every helper here takes as the single-device mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wavenet_torch.models.config import WaveNetConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(device_type: Optional[str] = None, model_parallelism: int = 1,
              axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)):
    """A (data, model) ``DeviceMesh`` over the processes of the default
    group, ``model_parallelism`` consecutive ranks to one model replica;
    None on one process with no group (the single-device path).
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if model_parallelism != 1:
            raise ValueError(
                f"model_parallelism={model_parallelism} needs that many "
                "processes (one per device) in a torch.distributed group")
        return None
    n = dist.get_world_size()
    if n % model_parallelism != 0:
        raise ValueError(f"{n} processes not divisible by "
                         f"model_parallelism={model_parallelism}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallelism,
                                          model_parallelism),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` of ``mesh`` (1 for the single-device mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for the single-device
    mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def param_partition_specs(config: WaveNetConfig, params_like) -> dict:
    """Spec tuple of every key of ``params_like`` (``init_params``'s)."""
    c = config
    specs = {
        "causal_filter": (None, None, None),     # small; replicated
        "filter": (None, None, None, MODEL_AXIS),
        "gate": (None, None, None, MODEL_AXIS),
        "dense": (None, MODEL_AXIS, None),
        "skip": (None, MODEL_AXIS, None),
        "postprocess1": (None, MODEL_AXIS),
        "postprocess2": (MODEL_AXIS, None),
    }
    if c.gc_enabled:
        specs["gc_embedding"] = (None, None)
        specs["gc_filter"] = (None, None, MODEL_AXIS)
        specs["gc_gate"] = (None, None, MODEL_AXIS)
    if c.lc_enabled:
        # Column parallel with filter/gate, like the GC projections.
        specs["lc_filter"] = (None, None, MODEL_AXIS)
        specs["lc_gate"] = (None, None, MODEL_AXIS)
        if c.lc_refine_width:
            # The learned-upsampler refinement is tiny; replicated.
            specs["lc_up_depth"] = (None, None)
            specs["lc_up_point"] = (None, None)
            specs["lc_up_bias"] = (None,)
    if c.use_biases:
        specs["filter_bias"] = (None, MODEL_AXIS)
        specs["gate_bias"] = (None, MODEL_AXIS)
        specs["dense_bias"] = (None, None)
        specs["skip_bias"] = (None, None)
        specs["postprocess1_bias"] = (MODEL_AXIS,)
        specs["postprocess2_bias"] = (None,)
    missing = set(params_like) - set(specs)
    if missing:
        raise ValueError(f"No partition spec for params: {missing}")
    return {k: specs[k] for k in params_like}


def shard_dims(config: WaveNetConfig, params_like) -> dict:
    """Key -> the dimension split over "model", or None (replicated)."""
    return {k: (spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None)
            for k, spec in param_partition_specs(config, params_like).items()}


def batch_spec() -> tuple:
    return (DATA_AXIS, None)


def _local_slice(x: torch.Tensor, dim: Optional[int], mesh,
                 axis: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (a copy)."""
    n = axis_size(mesh, axis)
    if dim is None or n == 1:
        return x.detach().clone()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {n} ranks of {axis!r}")
    size = x.shape[dim] // n
    return x.detach().narrow(dim, axis_index(mesh, axis) * size,
                             size).clone()


def shard_params(params, config: WaveNetConfig, mesh):
    """This rank's shard of every param (whole where replicated)."""
    dims = shard_dims(config, params)
    return {k: _local_slice(v, dims[k], mesh) for k, v in params.items()}


def shard_train_state(state, config: WaveNetConfig, mesh):
    """A ``TrainState`` of this rank's shards: the params as new leaves,
    and an optimizer of the same kind over them whose per-param state
    (Adam's moments, ...) is sharded like its param."""
    from wavenet_torch.train_lib import TrainState

    if mesh is None:
        return state
    dims = shard_dims(config, state.params)
    keys = sorted(state.params)
    leaves = {k: _local_slice(state.params[k], dims[k], mesh)
              .requires_grad_(True) for k in keys}
    full = state.optimizer.state_dict()
    sliced = {i: {name: (_local_slice(v, dims[keys[i]], mesh)
                         if isinstance(v, torch.Tensor)
                         and v.shape == state.params[keys[i]].shape else v)
                  for name, v in s.items()}
              for i, s in full["state"].items()}
    opt = type(state.optimizer)([leaves[k] for k in keys],
                                **state.optimizer.defaults)
    opt.load_state_dict({"state": sliced,
                         "param_groups": full["param_groups"]})
    return TrainState(step=state.step, params=leaves, optimizer=opt)


def data_rows(n: int, mesh, axis: str = DATA_AXIS) -> slice:
    """This rank's rows of a global batch of ``n`` over ``axis``."""
    dp = axis_size(mesh, axis)
    if n % dp:
        raise ValueError(f"batch {n} not divisible by the {axis} axis {dp}")
    b = n // dp
    i = axis_index(mesh, axis)
    return slice(i * b, (i + 1) * b)


def shard_batch(audio, mesh, gc_ids=None, lc=None, stacked: bool = False):
    """This rank's data rows of a global batch (numpy arrays or tensors).

    Returns (audio, gc_ids, lc); unused streams come back as None. ``lc``
    is a stream [B, T, C] or an ``LCFrameChunk`` (every field batch-major).
    ``stacked``: inputs lead with a steps-per-dispatch axis (audio
    [K, B, T]), and the batch axis is axis 1."""
    lead = 1 if stacked else 0
    rows = data_rows(audio.shape[lead], mesh)

    def take(x):
        return x[:, rows] if stacked else x[rows]

    lc_s = None
    if lc is not None:
        lc_s = (type(lc)(*map(take, lc)) if isinstance(lc, tuple)
                else take(lc))
    return take(audio), None if gc_ids is None else take(gc_ids), lc_s
