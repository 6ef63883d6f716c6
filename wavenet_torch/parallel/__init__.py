"""Parallelism on ``torch.distributed``: mesh and sharding layout, tensor
parallel collectives, time-axis (sequence) parallelism and multi-process
init (counterpart of ``wavenet_tpu/parallel/``).

One process runs per device. The processes form a ``DeviceMesh``
(NCCL on ``cuda``, gloo on ``cpu``); the tensor-parallel forward calls its
collectives itself (``tensor.py``), the train step averages gradients over
"data", and the time axis takes one halo exchange (``timeshard.py``).
"""

from wavenet_torch.parallel.sharding import (
    batch_spec,
    make_mesh,
    param_partition_specs,
    shard_batch,
    shard_params,
    shard_train_state,
)
from wavenet_torch.parallel.timeshard import (
    TIME_AXIS,
    make_time_sharded_grad_fn,
    time_sharded_loss,
)
from wavenet_torch.parallel.distributed import (
    global_batch_from_local,
    initialize_multihost,
    make_global_mesh,
)

__all__ = [
    "batch_spec",
    "make_mesh",
    "param_partition_specs",
    "shard_batch",
    "shard_params",
    "shard_train_state",
    "TIME_AXIS",
    "make_time_sharded_grad_fn",
    "time_sharded_loss",
    "global_batch_from_local",
    "initialize_multihost",
    "make_global_mesh",
]
