"""Multi-process support: process-group init and global batch assembly.

Counterpart of ``wavenet_tpu/parallel/distributed.py``. One process runs
per device, so the JAX package's multi-host leg is the port's only way to
more than one device:

* :func:`initialize_multihost` calls ``torch.distributed.init_process_group``
  (NCCL on ``cuda``, gloo on ``cpu``) from the train CLI's flags, or from
  the environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``: the counterpart of
  ``JAX_COORDINATOR_ADDRESS``). On ``cuda`` each process takes the card
  ``LOCAL_RANK`` (else its rank) names, modulo the cards it sees, and a
  failed NCCL start raises: nothing falls back to gloo.
* :func:`make_global_mesh` is the ``(data, model)`` mesh over every
  process (``parallel.sharding.make_mesh``).
* :func:`global_batch_from_local` keeps each process's local batch as its
  data shard (the reader is seeded per data rank).

Without flags or environment, :func:`initialize_multihost` does nothing
and returns False, and the helpers take the single-device path.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from wavenet_torch.parallel.sharding import MODEL_AXIS, DATA_AXIS, make_mesh


def _env_configured() -> bool:
    return all(os.environ.get(k) for k in ("MASTER_ADDR", "RANK",
                                           "WORLD_SIZE"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> bool:
    """Join the process group if flags or ``torchrun``'s environment ask
    for one. Returns True when more than one process runs.

    ``coordinator_address`` is rank 0's ``host:port`` (or an init-method
    URL: ``tcp://host:port``, ``file:///path``); with it,
    ``num_processes`` and ``process_id`` are required. ``device`` picks
    the backend: NCCL on ``cuda``, gloo on ``cpu``."""
    import torch.distributed as dist

    from wavenet_torch import resolve_device

    explicit = coordinator_address is not None
    if not explicit and not _env_configured():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None
                   else os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    # A first collective starts the backend's communicator now, so that a
    # backend that cannot start raises here.
    probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"{backend} all-reduce over {world} processes "
                           f"gave {probe.item()}")
    return world > 1


def make_global_mesh(model_parallelism: int = 1,
                     device_type: Optional[str] = None):
    """The (data, model) mesh over every process of the group, model
    groups of consecutive ranks (``parallel.sharding.make_mesh``)."""
    return make_mesh(device_type, model_parallelism, (DATA_AXIS, MODEL_AXIS))


def global_batch_from_local(local_audio, mesh, local_gc_ids=None,
                            local_lc=None):
    """Each process's [b_local, T] batch (and its speaker ids and LC
    stream or frame chunk) is its shard of the global [b_local x data
    ranks, T] batch over "data": returned as it is, as (audio, gc_ids,
    lc)."""
    del mesh    # the layout is the mesh's data axis itself
    return local_audio, local_gc_ids, local_lc
