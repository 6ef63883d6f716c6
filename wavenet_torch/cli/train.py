"""Training CLI of the port: the JAX CLI's flags, printed lines and loop.

    python -m wavenet_torch.cli.train --data_dir CORPUS --logdir LOGDIR \\
        --gc_channels 32 --use_pallas_stack --batch_size 8 --sample_size 16000

Counterpart of ``wavenet_tpu/cli/train.py``: same logdir rules, one line
``step N - loss = ...`` per train step, a NaN guard that stops without
saving a non-finite state, checkpoints every ``--checkpoint_every`` steps
and at the end, and a restart from the newest checkpoint ("Restored model
from step N"). ``--use_pallas_stack`` runs the dilated stack through the
hand-written CUDA kernel pair (``kernels/fused_stack.py``). ``--device``
(default ``cuda``) picks the card or, for tests, the CPU. ``--lc_channels``
with ``--lc_hop`` trains with local conditioning from ``<stem>.lc.npy``
sidecars: the reader ships frame windows that the step upsamples on the
device, or with ``--lc_host_upsample`` the upsampled stream.

Several processes (one per device) train one model over a ``(data,
model)`` mesh (``wavenet_torch/parallel``): launch each with
``--coordinator_address HOST:PORT --num_processes N --process_id I`` (or
an init-method URL, ``file:///path``, as the address), or under
``torchrun`` (its ``MASTER_ADDR``/``RANK``/``WORLD_SIZE`` environment).
NCCL runs on ``cuda``, gloo on ``cpu``. ``--model_parallelism M`` puts
M consecutive ranks on one model replica (tensor parallel over D and S);
the other factor of N is the data axis. ``--batch_size`` is the batch
of one data rank (the global batch is ``batch_size`` x N / M), as the
JAX CLI's is the batch of one host. Each rank's reader is seeded by its
data rank (``--seed`` + data rank), so the model ranks of one data index
read the same batches (under ``--model_parallelism`` > 1 an unseeded run
broadcasts rank 0's draw of a seed, and the reader takes one thread).
Only global rank 0 prints, logs and writes checkpoints (gathered, in the
one-process format, which one process and the server restore).

Flags whose path is not ported yet raise NotImplementedError naming the
ROADMAP.md queue that owns them. ``--compilation_cache`` is accepted and
has no effect: PyTorch compiles nothing ahead of a step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import datetime

import numpy as np

BATCH_SIZE = 1
DATA_DIRECTORY = "./VCTK-Corpus"
LOGDIR_ROOT = "./logdir"
CHECKPOINT_EVERY = 50
NUM_STEPS = int(1e5)
LEARNING_RATE = 1e-3
WAVENET_PARAMS = "./wavenet_params.json"
STARTED_DATESTRING = "{0:%Y-%m-%dT%H-%M-%S}".format(datetime.now())
SAMPLE_SIZE = 100000
L2_REGULARIZATION_STRENGTH = 0
SILENCE_THRESHOLD = 0.3
MOMENTUM = 0.9
MAX_TO_KEEP = 5


def get_arguments(argv=None):
    def _str_to_bool(s):
        if s.lower() not in ("true", "false"):
            raise ValueError("Argument needs to be a boolean, got {}".format(s))
        return s.lower() == "true"

    parser = argparse.ArgumentParser(
        description="WaveNet training (PyTorch/CUDA port)")
    parser.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    parser.add_argument("--data_dir", type=str, default=DATA_DIRECTORY)
    parser.add_argument("--store_metadata", type=_str_to_bool, default=False,
                        help="Profiler traces (not ported yet).")
    parser.add_argument("--logdir", type=str, default=None)
    parser.add_argument("--logdir_root", type=str, default=None)
    parser.add_argument("--restore_from", type=str, default=None)
    parser.add_argument("--checkpoint_every", type=int,
                        default=CHECKPOINT_EVERY)
    parser.add_argument("--num_steps", type=int, default=NUM_STEPS)
    parser.add_argument("--learning_rate", type=float, default=LEARNING_RATE)
    parser.add_argument("--wavenet_params", type=str, default=WAVENET_PARAMS)
    parser.add_argument("--sample_size", type=int, default=SAMPLE_SIZE)
    parser.add_argument("--l2_regularization_strength", type=float,
                        default=L2_REGULARIZATION_STRENGTH)
    parser.add_argument("--silence_threshold", type=float,
                        default=SILENCE_THRESHOLD)
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "sgd", "rmsprop"])
    parser.add_argument("--momentum", type=float, default=MOMENTUM)
    parser.add_argument("--histograms", type=_str_to_bool, default=False,
                        help="Parameter histograms (not ported yet).")
    parser.add_argument("--gc_channels", type=int, default=None,
                        help="Global condition channels; enables speaker "
                             "conditioning.")
    parser.add_argument("--lc_channels", type=int, default=None,
                        help="Local condition channels: per-timestep "
                             "conditioning from <stem>.lc.npy sidecar "
                             "files ([frames, lc_channels]) next to each "
                             "wav.")
    parser.add_argument("--lc_hop", type=int, default=None,
                        help="Output samples per LC frame (at the model "
                             "sample_rate). Required with --lc_channels.")
    parser.add_argument("--lc_upsample", type=str, default="repeat",
                        choices=["repeat", "linear"],
                        help="How LC frames are upsampled to sample rate.")
    parser.add_argument("--lc_host_upsample", action="store_true",
                        help="Ship the upsampled LC stream to the device "
                             "instead of frame windows (C_lc floats a "
                             "sample against one frame a hop).")
    parser.add_argument("--lc_refine_width", type=int, default=0,
                        help="Odd depthwise-conv width of a trainable "
                             "refinement of the upsampled stream (try "
                             "2*lc_hop+1). 0 disables.")
    parser.add_argument("--max_checkpoints", type=int, default=MAX_TO_KEEP)
    parser.add_argument("--async_checkpoint", type=_str_to_bool,
                        default=True,
                        help="Write checkpoints in a background thread "
                             "(the state is copied to the host first).")
    parser.add_argument("--num_threads", type=int, default=1,
                        help="Reader worker threads.")
    parser.add_argument("--prefetch_depth", type=int, default=2,
                        help="Input batches staged on the device ahead of "
                             "the step by a background thread; 0 copies "
                             "inline.")
    parser.add_argument("--steps_per_dispatch", type=int, default=4,
                        help="Train steps per call of the step function; "
                             "the loss is still printed per step, "
                             "checkpoints land on call boundaries and "
                             "--num_steps is exact.")
    parser.add_argument("--model_parallelism", type=int, default=1,
                        help="Processes (devices) a model replica is "
                             "split over (tensor parallel).")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="Rank 0's host:port (or an init-method URL) "
                             "for a multi-process run.")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--remat", action="store_true",
                        help="Recompute each layer in the backward (less "
                             "activation memory).")
    parser.add_argument("--use_pallas_stack", action="store_true",
                        help="Run the dilated stack through the fused "
                             "CUDA training kernel pair.")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--compilation_cache", type=str,
                        default="~/.cache/wavenet_tpu_xla",
                        help="Accepted for the JAX CLI's sake; no effect.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the card) or 'cpu'.")
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Raise NotImplementedError for flags whose path the port lacks."""
    unported = [
        (args.store_metadata, "--store_metadata", "queue 1, item 10"),
        (args.histograms, "--histograms", "queue 1, item 10"),
    ]
    for bad, flag, owner in unported:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md {owner})")


def get_default_logdir(logdir_root):
    return os.path.join(logdir_root, "train", STARTED_DATESTRING)


def validate_directories(args):
    """The reference's logdir mutual-exclusion rules."""
    if args.logdir and args.logdir_root:
        raise ValueError("--logdir and --logdir_root cannot be specified "
                         "at the same time.")
    if args.logdir and args.restore_from:
        raise ValueError(
            "--logdir and --restore_from cannot be specified at the same "
            "time. This is to keep your previous model from unexpected "
            "overwrites.\n"
            "Use --logdir_root to specify the root of the directory which "
            "will be automatically created with current date and time, or "
            "use only --logdir to just continue the training from the "
            "model in the directory.")
    logdir = args.logdir
    logdir_root = args.logdir_root
    if logdir_root is None:
        logdir_root = LOGDIR_ROOT
    if logdir is None:
        logdir = get_default_logdir(logdir_root)
        print(f"Using default logdir: {logdir}")
    restore_from = args.restore_from
    if restore_from is None:
        restore_from = logdir
    return {"logdir": logdir, "logdir_root": logdir_root,
            "restore_from": restore_from}


def main(argv=None):
    args = get_arguments(argv)
    check_ported(args)
    try:
        directories = validate_directories(args)
    except ValueError as e:
        print(f"Some arguments are wrong:\n{e}")
        return 1

    import torch
    import torch.distributed as dist

    from wavenet_torch import resolve_device
    from wavenet_torch.parallel.distributed import initialize_multihost

    resolve_device(args.device)
    joined = dist.is_initialized()
    initialize_multihost(args.coordinator_address, args.num_processes,
                         args.process_id, device=args.device)
    started = dist.is_initialized() and not joined
    try:
        return _train(args, directories)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, directories):
    import torch
    import torch.distributed as dist

    from wavenet_torch import resolve_device
    from wavenet_torch.data.prefetch import DevicePrefetcher, to_device
    from wavenet_torch.data.reader import AudioReader
    from wavenet_torch.lc import LCFrameChunk
    from wavenet_torch.models.config import WaveNetConfig
    from wavenet_torch.parallel.distributed import (
        global_batch_from_local, make_global_mesh)
    from wavenet_torch.parallel.sharding import (
        DATA_AXIS, axis_index, make_mesh, shard_train_state)
    from wavenet_torch.train_lib import (
        StepTimer, audio_seconds_per_second, create_train_state,
        make_optimizer, make_train_multistep, make_train_step,
        restore_checkpoint, save_checkpoint, wait_for_checkpoints)
    from wavenet_torch.utils.summaries import SummaryWriter

    device = resolve_device(args.device)
    # f32 parity: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if dist.is_initialized():
        mesh = make_global_mesh(args.model_parallelism, device.type)
    else:
        mesh = make_mesh(model_parallelism=args.model_parallelism)
    chief = mesh is None or dist.get_rank() == 0
    log = print if chief else (lambda *a, **k: None)
    seed = args.seed
    if args.model_parallelism > 1:
        # The model ranks of one data index must read the same batches:
        # one seed for all, one reader thread (threads interleave).
        if args.num_threads != 1:
            print("Some arguments are wrong:\n--model_parallelism > 1 "
                  "needs --num_threads 1 (the model ranks of a data index "
                  "read the same batches).")
            return 1
        if seed is None:
            drawn = [int(np.random.randint(2 ** 31)) if chief else 0]
            dist.broadcast_object_list(drawn, src=0)
            seed = drawn[0]

    logdir = directories["logdir"]
    restore_from = directories["restore_from"]

    with open(args.wavenet_params, "r") as f:
        wavenet_params = json.load(f)
    gc_enabled = args.gc_channels is not None
    lc_enabled = args.lc_channels is not None
    if lc_enabled and args.lc_hop is None:
        print("Some arguments are wrong:\n--lc_channels requires --lc_hop "
              "(output samples per conditioning frame).")
        return 1
    probe = WaveNetConfig.from_json(wavenet_params)
    reader = AudioReader(
        args.data_dir,
        sample_rate=wavenet_params["sample_rate"],
        gc_enabled=gc_enabled,
        receptive_field=probe.receptive_field,
        sample_size=args.sample_size,
        silence_threshold=(args.silence_threshold
                           if args.silence_threshold > 0 else None),
        # Disjoint streams per data rank under a fixed seed (sampling with
        # replacement makes any per-rank offset valid).
        seed=(seed + axis_index(mesh, DATA_AXIS)
              if seed is not None else None),
        num_threads=args.num_threads,
        lc_enabled=lc_enabled,
        lc_channels=args.lc_channels,
        lc_hop=args.lc_hop,
        lc_upsample=args.lc_upsample,
        lc_device_upsample=lc_enabled and not args.lc_host_upsample,
    )
    config = WaveNetConfig.from_json(
        wavenet_params,
        gc_channels=args.gc_channels,
        gc_cardinality=reader.gc_category_cardinality if gc_enabled else None,
        lc_channels=args.lc_channels,
        lc_refine_width=args.lc_refine_width,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
        use_pallas_stack=args.use_pallas_stack,
    )
    l2 = args.l2_regularization_strength or None

    optimizer = make_optimizer(args.optimizer, args.learning_rate,
                               args.momentum)
    state = create_train_state(args.seed if args.seed is not None else 0,
                               config, optimizer, device)
    if restore_checkpoint(restore_from, state) is not None:
        log(f"Restored model from step {state.step}")
    else:
        log("No checkpoint found; starting new training.")
    state = shard_train_state(state, config, mesh)

    dispatch_k = max(1, args.steps_per_dispatch)
    lc_kw = dict(lc_hop=args.lc_hop, lc_upsample=args.lc_upsample,
                 mesh=mesh)
    train_step = (make_train_multistep(config, l2, dispatch_k, **lc_kw)
                  if dispatch_k > 1 else make_train_step(config, l2, **lc_kw))
    single_step = train_step if dispatch_k == 1 else None

    def save():
        save_checkpoint(logdir, state, args.max_checkpoints,
                        use_async=args.async_checkpoint, mesh=mesh,
                        config=config)

    if chief:
        os.makedirs(logdir, exist_ok=True)
    writer = SummaryWriter(logdir) if chief else None
    reader.start_threads()

    def fill(k=dispatch_k, stacked=dispatch_k > 1):
        """One dispatch's input on the device (in the prefetch thread:
        the copy overlaps the running step)."""
        auds, gcs, lcs = [], [], []
        for _ in range(k):
            auds.append(reader.dequeue(args.batch_size))
            if gc_enabled:
                gcs.append(reader.dequeue_gc(args.batch_size).astype(
                    np.int64))
            if lc_enabled:
                lcs.append(reader.dequeue_lc(args.batch_size))
        if stacked:
            audio = np.stack(auds)
            gc_ids = np.stack(gcs) if gc_enabled else None
            lc = None
            if lc_enabled:    # a stream, or each field of a frame chunk
                lc = (LCFrameChunk(*map(np.stack, zip(*lcs)))
                      if isinstance(lcs[0], LCFrameChunk)
                      else np.stack(lcs))
        else:
            audio, gc_ids = auds[0], (gcs[0] if gc_enabled else None)
            lc = lcs[0] if lc_enabled else None
        audio, gc_ids, lc = global_batch_from_local(audio, mesh, gc_ids, lc)
        n_samples = int(np.prod(audio.shape[-2:]))   # per train step
        return (to_device(audio, device),
                None if gc_ids is None else to_device(gc_ids, device),
                None if lc is None else to_device(lc, device), n_samples)

    saved_global_step = state.step
    n_dispatches = max(0, args.num_steps - saved_global_step) // dispatch_k
    prefetcher = None
    if args.prefetch_depth > 0 and n_dispatches > 0:
        prefetcher = DevicePrefetcher(fill, depth=args.prefetch_depth,
                                      max_items=n_dispatches)
    last_saved_step = saved_global_step
    timer = StepTimer()
    step = saved_global_step
    poisoned = False
    # The loss of a dispatch is read after the next one is queued, so the
    # host's read does not idle the card; checkpoint dispatches are read
    # at once, so a non-finite state is never saved.
    pending = None   # (first_step, metrics, samples_per_step)

    def handle(item):
        """Print and log one dispatch's losses; True if one is not finite."""
        s0, metrics, n_samples = item
        losses = metrics["loss"].reshape(-1).cpu().numpy()
        l2s = (metrics["l2_loss"].reshape(-1).cpu().numpy()
               if "l2_loss" in metrics else None)
        duration = timer.lap() / len(losses)
        for i, loss_value in enumerate(losses):
            s = s0 + i
            loss_value = float(loss_value)
            if not np.isfinite(loss_value):
                log(f"step {s} - NON-FINITE loss ({loss_value}); "
                    "stopping without saving the poisoned state.")
                return True
            if not chief:
                continue
            aps = audio_seconds_per_second(
                n_samples, wavenet_params["sample_rate"], duration)
            print(f"step {s} - loss = {loss_value:.3f}, "
                  f"({duration:.3f} sec/step, {aps:.2f} audio-sec/s)",
                  flush=True)
            writer.scalar("loss", loss_value, s)
            writer.scalar("sec_per_step", duration, s)
            if l2s is not None:
                writer.scalar("l2_loss", float(l2s[i]), s)
        return False

    def crosses(step_start, step_end, every):
        """Does [step_start, step_end] contain a multiple of ``every``?"""
        return step_end // every > (step_start - 1) // every

    try:
        while step < args.num_steps:
            first = step + 1
            if step + dispatch_k > args.num_steps:
                # Fewer than steps_per_dispatch steps left: single steps,
                # so --num_steps is hit exactly.
                if prefetcher is not None:
                    prefetcher.stop()
                    prefetcher = None
                if single_step is None:
                    single_step = make_train_step(config, l2, **lc_kw)
                audio, gc_ids, lc, n_samples = fill(k=1, stacked=False)
                state, metrics = single_step(state, audio, gc_ids, lc)
                k = 1
            else:
                audio, gc_ids, lc, n_samples = (
                    prefetcher.get() if prefetcher is not None else fill())
                state, metrics = train_step(state, audio, gc_ids, lc)
                k = dispatch_k
            step += k

            if pending is not None:
                poisoned = handle(pending)
                pending = None
                if poisoned:
                    break
            if (crosses(first, step, args.checkpoint_every)
                    or step == args.num_steps):
                poisoned = handle((first, metrics, n_samples))
                if poisoned:
                    break
                save()
                last_saved_step = step
            else:
                pending = (first, metrics, n_samples)
    except KeyboardInterrupt:
        print()
        pending = None
    finally:
        if prefetcher is not None:
            prefetcher.stop()
        if pending is not None and not poisoned:
            poisoned = handle(pending)
        if step > last_saved_step and not poisoned:
            save()
        wait_for_checkpoints()
        reader.stop_threads()
        if writer is not None:
            writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
