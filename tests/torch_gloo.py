"""Gloo process groups for the port's parallel tests, on the CPU.

``run(task, outdir, world)`` starts ``world`` processes of this file, which
join one gloo group through a ``file://`` rendezvous in ``outdir`` (no
port, so parallel test workers never compete for one), run the task of
that name with one intra-op thread each, and write their results to
``outdir/result<rank>.pt``. A hard deadline kills every process and fails
the calling test, so a rendezvous that hangs cannot hold up the suite.

Inputs are numpy arrays the test writes to ``outdir/inputs.pt`` (the
weights come from the JAX package, which these processes do not import).

    python tests/torch_gloo.py TASK OUTDIR RANK WORLD
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Seconds a group may take, start-up (~5-10 s) included.
DEADLINE = 120


def spawn(cmds, outdir: str, deadline: float = DEADLINE):
    """Run the commands (argv lists) side by side from the repo's root,
    each with one intra-op thread and no ``torchrun`` environment; returns
    their outputs. Raises AssertionError (with the outputs) if one exits
    non-zero or the deadline passes, killing every one still running."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)
    paths = [os.path.join(outdir, f"rank{r}.log") for r in range(len(cmds))]
    logs = [open(path, "w") for path in paths]
    procs = [subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                              env=env, cwd=ROOT)
             for cmd, log in zip(cmds, logs)]
    end = time.monotonic() + deadline
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end:
                raise AssertionError(f"{cmds[0]} passed its {deadline} s "
                                     "deadline" + _tails(paths))
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"{cmds[0]} exited {codes}" + _tails(paths))
    outs = []
    for path in paths:
        with open(path) as f:
            outs.append(f.read())
    return outs


def run(task: str, outdir: str, world: int, deadline: float = DEADLINE):
    """Run ``task`` in ``world`` gloo processes; returns each rank's
    result dict (``spawn``'s errors)."""
    import torch

    spawn([[sys.executable, os.path.abspath(__file__), task, outdir, str(r),
            str(world)] for r in range(world)], outdir, deadline)
    return [torch.load(os.path.join(outdir, f"result{r}.pt"),
                       weights_only=False) for r in range(world)]


def _tails(paths):
    out = []
    for r, path in enumerate(paths):
        with open(path) as f:
            out.append(f"\n--- process {r} ---\n" + f.read()[-3000:])
    return "".join(out)


# ---------------------------------------------------------------------------
# Tasks (each runs on every rank of the group)
# ---------------------------------------------------------------------------

def _params(arrays):
    from wavenet_torch.params import params_from_numpy
    return params_from_numpy(arrays, "cpu")


def task_sharding(inp, rank, world):
    """The dp x tp train step, sharding, generate_sharded and the fused
    stack's route under tensor parallelism."""
    import dataclasses

    import torch

    from wavenet_torch import train_lib as tl
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.models.config import WaveNetConfig
    from wavenet_torch.parallel import (
        make_global_mesh, make_mesh, shard_batch, shard_params,
        shard_train_state)
    from wavenet_torch.sample import generate_sharded

    cfg = WaveNetConfig(**inp["cfg"])
    out = {"losses": {}, "shapes": {}}

    # Record the widths the fused stack is called at (its plain versions
    # run here: the tensors lie on the CPU).
    seen = []
    real = fs.fused_stack3

    def spy(x, w_fg, *args, **kw):
        seen.append(tuple(w_fg.shape))
        return real(x, w_fg, *args, **kw)

    fs.fused_stack3 = spy

    def train(c, tp):
        mesh = make_mesh("cpu", tp)
        state = tl.train_state_from_params(_params(inp["weights"]),
                                           tl.make_optimizer("adam", 1e-3))
        state = shard_train_state(state, c, mesh)
        step = tl.make_train_step(c, 0.001, mesh=mesh)
        losses = []
        for audio, gc in inp["batches"]:
            a, g, _ = shard_batch(audio, mesh, gc)
            state, m = step(state, torch.as_tensor(a),
                            torch.as_tensor(g).long())
            losses.append(float(m["loss"]))
        return mesh, state, losses

    for tp in (1, 2, 4):
        mesh, state, out["losses"][tp] = train(cfg, tp)
        out["shapes"][tp] = {k: tuple(v.shape)
                             for k, v in state.params.items()}
        a, g, _ = shard_batch(inp["batches"][0][0], mesh,
                              inp["batches"][0][1])
        out["shapes"][tp]["batch"] = a.shape
    for name, kw in (("remat", dict(remat=True)),
                     ("pallas", dict(use_pallas_stack=True))):
        _, _, out["losses"][name] = train(dataclasses.replace(cfg, **kw), 2)
    out["stack_widths"] = sorted(set(seen))

    # Multi-process helpers over the whole group.
    mesh = make_global_mesh(model_parallelism=2)
    out["global_mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out["shard_filter"] = shard_params(_params(inp["weights"]), cfg,
                                       mesh)["filter"].numpy()

    out["codes"] = {}
    for tp in (1, 2, 4):
        mesh = make_mesh("cpu", tp)
        for gc in (False, True):
            key = torch.Generator().manual_seed(inp["gen_seed"])
            codes = generate_sharded(
                _params(inp["weights"]), cfg, inp["gen_n"], key, mesh,
                inp["gen_batch"],
                gc_ids=torch.as_tensor(inp["gen_gc"]) if gc else None)
            out["codes"][tp, gc] = codes.numpy()
    return out


def task_timeshard(inp, rank, world):
    """The time-sharded loss and gradients at the JAX tests' cases."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from wavenet_torch.models.config import WaveNetConfig
    from wavenet_torch.parallel import (
        make_time_sharded_grad_fn, time_sharded_loss)

    out = {}
    meshes = {shape: init_device_mesh("cpu", shape,
                                      mesh_dim_names=("data", "time"))
              for shape in ((1, 4), (2, 2))}
    for name, case in inp["cases"].items():
        cfg = WaveNetConfig(**case["cfg"])
        params = _params(case["weights"])
        mesh = meshes[case["mesh"]]
        data_axis = "data" if case["mesh"][0] > 1 else None
        fn = make_time_sharded_grad_fn(cfg, mesh, case.get("l2"),
                                       time_axis="time", data_axis=data_axis)
        audio = torch.as_tensor(case["audio"])
        gc = (torch.as_tensor(case["gc"]) if case.get("gc") is not None
              else None)
        try:
            (total, aux), grads = fn(params, audio, gc)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        res = {"total": float(total),
               **{k: float(v) for k, v in aux.items()},
               "grads": {k: v.numpy() for k, v in grads.items()}}
        # The differentiable loss from this rank's slice: its gradients,
        # summed over the groups, are fn's (before the L2 term's).
        n_t = case["mesh"][1]
        B, T = audio.shape
        Tl = T // n_t
        t = mesh.get_local_rank("time")
        rows = slice(None)
        if data_axis:
            b = B // case["mesh"][0]
            d = mesh.get_local_rank("data")
            rows = slice(d * b, (d + 1) * b)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        loss, _ = time_sharded_loss(
            leaves, cfg, audio[rows, t * Tl:(t + 1) * Tl],
            None if gc is None else gc[rows], mesh=mesh, axis_name="time",
            data_axis=data_axis)
        loss.backward()
        res["loss_fn_total"] = float(loss)
        summed = {}
        for k, v in leaves.items():
            g = torch.zeros_like(v) if v.grad is None else v.grad.clone()
            dist.all_reduce(g)
            summed[k] = g.numpy()
        res["loss_grads"] = summed
        out[name] = res
    return out


TASKS = {"sharding": task_sharding, "timeshard": task_timeshard}


def main(task, outdir, rank, world):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        outdir, "rendezvous"), rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(outdir, "inputs.pt"),
                         weights_only=False)
        result = TASKS[task](inp, rank, world)
        torch.save(result, os.path.join(outdir, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
