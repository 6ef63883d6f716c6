"""Training loop building blocks: train step, checkpoints, step timing.

Counterpart of ``wavenet_tpu/train_lib.py``. PyTorch runs eagerly, so a
step is the loss, its backward and the optimizer's update, and a
"multistep" is K such steps in a loop with the metrics stacked ``[K]``.
The optimizer holds its own state, so ``TrainState`` carries the
optimizer itself.

Checkpoints are directories ``ckpt-STEP/`` holding ``params.npz`` (the
npz ``python -m wavenet_torch.serve --params_npz`` reads), ``optimizer.pt``
(the optimizer's state dict) and ``step.json``. A save writes into a
temporary directory and renames it when complete, so a kill mid-save
never leaves a partial ``ckpt-STEP`` and the newest complete one stays
loadable. The JAX package writes orbax directories instead.

On a ``(data, model)`` mesh of processes (``parallel/sharding.py``) the
state holds this rank's shards (``parallel.sharding.shard_train_state``),
the step runs the tensor-parallel forward, averages the gradients over
"data" and updates the shards, and a save gathers the whole state and
writes it from global rank 0 in the same unsharded format, which one
process and the server restore.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from wavenet_torch.lc import LCFrameChunk, upsample_chunk
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import (Params, init_params, loss_fn,
                                          matmul_precision)
from wavenet_torch.ops.optimizers import OptimizerFactory, optimizer_factory
from wavenet_torch.params import load_npz

_CKPT = re.compile(r"ckpt-(\d+)")


@dataclasses.dataclass
class TrainState:
    """Params (leaf tensors that require grad), their optimizer and the
    step counter."""
    step: int
    params: Params
    optimizer: torch.optim.Optimizer


def train_state_from_params(params: Params, optimizer: OptimizerFactory,
                            step: int = 0) -> TrainState:
    """Fresh leaf copies of ``params`` and an optimizer over them (in
    sorted key order, which the optimizer's state dict refers to)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    return TrainState(step=step, params=leaves,
                      optimizer=optimizer([leaves[k] for k in sorted(leaves)]))


def create_train_state(seed: int, config: WaveNetConfig,
                       optimizer: OptimizerFactory,
                       device=None) -> TrainState:
    return train_state_from_params(init_params(seed, config, device),
                                   optimizer)


def make_optimizer(name: str, learning_rate: float,
                   momentum: float = 0.9) -> OptimizerFactory:
    """The reference's optimizer_factory lookup."""
    try:
        factory = optimizer_factory[name]
    except KeyError:
        raise ValueError(f"Unknown optimizer '{name}'. "
                         f"Choose from {sorted(optimizer_factory)}.")
    return factory(learning_rate, momentum)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


def _lc_stream(lc, lc_hop: Optional[int], lc_upsample: str, width: int):
    """The conditioning stream [B, width, C] of a step's ``lc``: a tensor
    as it is, an ``LCFrameChunk`` upsampled on its device."""
    if not isinstance(lc, LCFrameChunk):
        return lc
    if lc_hop is None:
        raise ValueError("LCFrameChunk input needs lc_hop at "
                         "make_train_step time")
    return upsample_chunk(lc, lc_hop, lc_upsample, width)


def make_train_step(config: WaveNetConfig,
                    l2_regularization_strength: Optional[float] = None,
                    lc_hop: Optional[int] = None,
                    lc_upsample: str = "repeat", mesh=None):
    """(state, audio [B, T], gc_ids [B] | None, lc | None) ->
    (state, metrics).

    ``lc`` is the conditioning stream [B, T, C_lc] or an
    ``lc.LCFrameChunk``, which the step upsamples on its device
    (``lc.upsample_chunk``, ``lc_hop`` and ``lc_upsample`` as the reader's).
    Updates ``state`` in place. Metrics are 0-d tensors on the params'
    device (loss, ce_loss, total_loss, l2_loss with L2, grad_norm); reading
    one waits for the step. A parameter that received no gradient gets a
    zero one, as in the JAX step, so every optimizer state advances.
    At bf16 (``config.compute_dtype``) the params, their gradients and the
    optimizer state stay float32; only the model's products and
    activations are bf16 (``models.wavenet._maybe_cast``).

    ``mesh``: ``state`` holds this rank's shards and ``audio`` its data
    rows; the forward is tensor-parallel where the model axis has more
    than one rank, the gradients (one flat all-reduce) and the loss
    metrics are averaged over "data", and the grad norm is the whole
    model's."""
    from wavenet_torch.parallel.tensor import (
        all_reduce_mean_, tensor_parallel)

    tp = tensor_parallel(mesh, config)

    def train_step(state: TrainState, audio: torch.Tensor,
                   gc_ids: Optional[torch.Tensor] = None, lc=None):
        lc = _lc_stream(lc, lc_hop, lc_upsample, audio.shape[1])
        for p in state.params.values():
            p.grad = None
        with matmul_precision(config):
            total, aux = loss_fn(state.params, config, audio, gc_ids,
                                 l2_regularization_strength, lc, tp=tp)
            total.backward()
        grads = []
        for k in sorted(state.params):
            p = state.params[k]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        all_reduce_mean_(grads, mesh)
        grad_norm = (_global_norm(grads) if tp is None else torch.sqrt(
            tp.sum_of_squares({k: state.params[k].grad
                               for k in state.params})))
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        if mesh is not None:
            metrics = {k: v.clone() for k, v in metrics.items()}
            all_reduce_mean_(metrics.values(), mesh)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def make_train_multistep(config: WaveNetConfig,
                         l2_regularization_strength: Optional[float] = None,
                         steps_per_dispatch: int = 1,
                         lc_hop: Optional[int] = None,
                         lc_upsample: str = "repeat", mesh=None):
    """K train steps per call: audio [K, B, T], gc_ids [K, B] | None, lc
    (a stream [K, B, T, C] or an ``LCFrameChunk`` whose fields lead with
    K) | None -> (state, metrics with every entry stacked [K]). ``mesh``
    as ``make_train_step``'s."""
    step = make_train_step(config, l2_regularization_strength, lc_hop,
                           lc_upsample, mesh)

    def train_multistep(state: TrainState, audio: torch.Tensor,
                        gc_ids: Optional[torch.Tensor] = None, lc=None):
        if audio.shape[0] != steps_per_dispatch:
            raise ValueError(f"audio has {audio.shape[0]} steps, expected "
                             f"{steps_per_dispatch}")
        out = []
        for k in range(steps_per_dispatch):
            lc_k = (None if lc is None else
                    LCFrameChunk(*(f[k] for f in lc))
                    if isinstance(lc, LCFrameChunk) else lc[k])
            state, m = step(state, audio[k],
                            None if gc_ids is None else gc_ids[k], lc_k)
            out.append(m)
        return state, {key: torch.stack([m[key] for m in out])
                       for key in out[0]}

    return train_multistep


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _prune_checkpoints(root: str, max_to_keep: Optional[int]) -> None:
    """Keep the newest ``max_to_keep`` complete ckpt-STEP directories
    (a save in progress has another name and is never counted)."""
    if max_to_keep is None or max_to_keep <= 0:
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(root)
                   if (m := _CKPT.fullmatch(d))
                   and os.path.isdir(os.path.join(root, d)))
    for old in steps[:-max_to_keep]:
        shutil.rmtree(os.path.join(root, f"ckpt-{old}"), ignore_errors=True)


def _write_checkpoint(root: str, snapshot: dict,
                      max_to_keep: Optional[int]) -> None:
    step = snapshot["step"]
    tmp = tempfile.mkdtemp(prefix=f"ckpt-{step}.tmp-", dir=root)
    np.savez(os.path.join(tmp, "params.npz"), **snapshot["params"])
    torch.save(snapshot["opt_state"], os.path.join(tmp, "optimizer.pt"))
    with open(os.path.join(tmp, "step.json"), "w") as f:
        json.dump({"step": step}, f)
    path = os.path.join(root, f"ckpt-{step}")
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _prune_checkpoints(root, max_to_keep)


class _AsyncCheckpointer:
    """One background save at a time; an error is raised by ``wait``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()

    def save(self, root: str, snapshot: dict,
             max_to_keep: Optional[int]) -> None:
        self.wait()

        def run():
            try:
                _write_checkpoint(root, snapshot, max_to_keep)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._err = e

        with self._lock:
            self._thread = threading.Thread(target=run, daemon=False,
                                            name="checkpoint-save")
            self._thread.start()

    def wait(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


_ASYNC = _AsyncCheckpointer()


def _gathered(state: TrainState, config: WaveNetConfig, mesh):
    """(params, optimizer state dict) of the whole model from this rank's
    shards (a collective over the model group, on every rank)."""
    import torch.distributed as dist

    from wavenet_torch.parallel.sharding import MODEL_AXIS, shard_dims
    group = mesh.get_group(MODEL_AXIS)
    n = dist.get_world_size(group)
    dims = shard_dims(config, state.params)
    keys = sorted(state.params)

    def whole(x, dim):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    params = {k: whole(v, dims[k]) if dims[k] is not None else v.detach()
              for k, v in state.params.items()}
    opt = state.optimizer.state_dict()
    opt["state"] = {
        i: {name: (whole(v, dims[keys[i]])
                   if dims[keys[i]] is not None and isinstance(v, torch.Tensor)
                   and v.shape == state.params[keys[i]].shape else v)
            for name, v in s.items()}
        for i, s in opt["state"].items()}
    return params, opt


def save_checkpoint(directory: str, state: TrainState,
                    max_to_keep: Optional[int] = None,
                    use_async: bool = False, mesh=None,
                    config: Optional[WaveNetConfig] = None) -> None:
    """Write ``directory/ckpt-<step>/``, then prune to ``max_to_keep``.

    ``use_async``: copy the state to the host now (training goes on
    updating it in place), write it in a background thread; a later save
    first waits for this one. Call :func:`wait_for_checkpoints` before
    exiting.

    ``mesh`` (with the ``config`` the shards are laid out by): every rank
    calls this; the whole state is gathered over the model group and only
    global rank 0 writes it."""
    import torch.distributed as dist

    params, opt_state = state.params, None
    if mesh is not None:
        from wavenet_torch.parallel.sharding import MODEL_AXIS, axis_size
        if axis_size(mesh, MODEL_AXIS) > 1:
            params, opt_state = _gathered(state, config, mesh)
        if dist.get_rank() != 0:
            return
    root = os.path.abspath(directory)
    os.makedirs(root, exist_ok=True)
    # Copies: on the CPU, .numpy() would share memory with parameters
    # that the next step updates in place while a background save runs.
    snapshot = {"step": int(state.step),
                "params": {k: v.numpy() for k, v in
                           _to_cpu(params).items()},
                "opt_state": _to_cpu(opt_state if opt_state is not None
                                     else state.optimizer.state_dict())}
    if use_async:
        _ASYNC.save(root, snapshot, max_to_keep)
    else:
        _write_checkpoint(root, snapshot, max_to_keep)


def wait_for_checkpoints() -> None:
    """Block until a background save has finished (raises its error)."""
    _ASYNC.wait()


def latest_checkpoint_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _CKPT.fullmatch(name))]
    return max(steps) if steps else None


def _checkpoint_path(directory: str, step: Optional[int]) -> Optional[str]:
    if step is None:
        step = latest_checkpoint_step(directory)
        if step is None:
            return None
    return os.path.join(os.path.abspath(directory), f"ckpt-{step}")


def restore_checkpoint(directory: str, state: TrainState,
                       step: Optional[int] = None) -> Optional[TrainState]:
    """Load the latest (or given) step into ``state`` (params, optimizer
    state, step) and return it; None if no checkpoint exists."""
    path = _checkpoint_path(directory, step)
    if path is None:
        return None
    dev = next(iter(state.params.values())).device
    params = load_npz(os.path.join(path, "params.npz"), dev)
    if set(params) != set(state.params):
        raise ValueError(f"{path}: parameter names differ from the model's")
    with torch.no_grad():
        for k, v in params.items():
            state.params[k].copy_(v)
    state.optimizer.load_state_dict(torch.load(
        os.path.join(path, "optimizer.pt"), map_location=dev,
        weights_only=True))
    with open(os.path.join(path, "step.json")) as f:
        state.step = int(json.load(f)["step"])
    return state


def restore_params_only(directory: str, step: Optional[int] = None,
                        device=None) -> Optional[Params]:
    """Weights only, for generation; None if no checkpoint exists."""
    path = _checkpoint_path(directory, step)
    if path is None:
        return None
    return load_npz(os.path.join(path, "params.npz"), device)


# ---------------------------------------------------------------------------
# Step timing / throughput
# ---------------------------------------------------------------------------

class StepTimer:
    def __init__(self):
        self._last = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self._last
        self._last = now
        return dt


def audio_seconds_per_second(samples_per_batch: int, sample_rate: int,
                             sec_per_step: float) -> float:
    """Seconds of audio consumed per wall second."""
    return (samples_per_batch / sample_rate) / sec_per_step

