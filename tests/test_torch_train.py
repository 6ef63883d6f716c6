"""The port's training path against the JAX package, on the CPU.

``loss_fn`` (plain stack and the fused stack's plain versions), the
optimizers, the train step and multistep, checkpoints, the data reader,
the prefetcher, the FLOPs model and the train CLI, at tiny sizes. Inputs
and weights are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.ops.optimizers import optimizer_factory as joptimizers
from wavenet_tpu.train_lib import make_train_step as jmake_train_step
from wavenet_tpu.utils import flops as jflops
from wavenet_torch.data.prefetch import DevicePrefetcher
from wavenet_torch.data.reader import AudioReader
from wavenet_torch.kernels.fused_stack import stack_kernel_plan
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.ops.optimizers import optimizer_factory as toptimizers
from wavenet_torch.params import params_from_numpy
from wavenet_torch.utils import flops as tflops
from wavenet_torch import train_lib as tl

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

# The JAX dilated-layer test's config: 4 layers, GC, biases.
BASE = dict(dilations=(1, 2, 4, 8), residual_channels=4, dilation_channels=4,
            skip_channels=8, quantization_channels=32, use_biases=True,
            gc_channels=4, gc_cardinality=4)


def _weights(cfg, seed):
    """JAX init with seeded non-zero biases, as numpy."""
    p = {k: np.asarray(v)
         for k, v in jw.init_params(jax.random.PRNGKey(seed), cfg).items()}
    rng = np.random.RandomState(seed + 100)
    for k in sorted(p):
        if k.endswith("_bias"):
            p[k] = (0.1 * rng.randn(*p[k].shape)).astype(np.float32)
    return p


def _audio(cfg, B, extra, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (B, cfg.receptive_field + extra)).astype(
        np.float32)


@pytest.mark.parametrize("pallas", [False, True])
def test_loss_and_grads_match_jax(pallas):
    jcfg = JConfig(**BASE, use_pallas_stack=pallas)
    tcfg = TConfig(**BASE, use_pallas_stack=pallas)
    w = _weights(jcfg, 0)
    audio = _audio(jcfg, 2, 20, 1)
    ids = np.array([0, 3])

    grad_fn = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True),
                      static_argnums=(1, 4))
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            (l_j, _), g_j = grad_fn(jp, jcfg, jnp.asarray(audio),
                                    jnp.asarray(ids), 0.01)
    else:
        (l_j, _), g_j = grad_fn(jp, jcfg, jnp.asarray(audio),
                                jnp.asarray(ids), 0.01)

    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(w, "cpu").items()}
    l_t, aux = tw.loss_fn(tp, tcfg, torch.from_numpy(audio),
                          torch.from_numpy(ids), 0.01)
    l_t.backward()
    assert set(aux) == {"ce_loss", "l2_loss", "total_loss"}
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    assert set(g_j) == set(tp)
    for k in g_j:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_j[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


_JAX_GRAD = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True),
                    static_argnums=(1, 4))


@pytest.mark.parametrize("version", [1, 2])
def test_retired_stack_loss_matches_jax(version):
    """``loss_fn`` with ``use_pallas_stack`` at a retired version (the
    plain versions of ``experiments/fused_stack{,2}.py`` on the CPU)
    against the JAX ``loss_fn`` on its plain stack: the loss and every
    gradient, with the JAX package's tolerances
    (``tests/test_dilated_layer.py``)."""
    jcfg = JConfig(**BASE)
    tcfg = TConfig(**BASE, use_pallas_stack=True,
                   pallas_stack_version=version)
    w = _weights(jcfg, version)
    audio = _audio(jcfg, 2, 20, version)
    ids = np.array([0, 3])
    (l_j, _), g_j = _JAX_GRAD({k: jnp.asarray(v) for k, v in w.items()},
                              jcfg, jnp.asarray(audio), jnp.asarray(ids),
                              0.01)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(w, "cpu").items()}
    l_t, _ = tw.loss_fn(tp, tcfg, torch.from_numpy(audio),
                        torch.from_numpy(ids), 0.01)
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    assert set(g_j) == set(tp)
    for k in g_j:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_j[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


# The wide config's shape (scalar input, initial_filter_width 32, R = D =
# 64, S = 1024) cut to 4 layers and S = 128: the width fused_stack_mma
# gained for the wide config's training.
WIDE = dict(dilations=(1, 2, 4, 8), residual_channels=64,
            dilation_channels=64, skip_channels=128, quantization_channels=256,
            use_biases=True, scalar_input=True, initial_filter_width=32)


def test_wide_stack_loss_matches_jax():
    """``loss_fn`` with ``use_pallas_stack`` at the wide width (the fused
    stack's plain versions on the CPU, the shape ``stack_kernel_plan``
    sends to ``fused_stack_mma``) against the JAX ``loss_fn`` on its plain
    XLA route at float32: the loss within 1e-5 relative and every gradient
    within the file's tolerances."""
    jcfg = JConfig(**WIDE)
    tcfg = TConfig(**WIDE, use_pallas_stack=True)
    assert stack_kernel_plan(tcfg) == "mma"
    w = _weights(jcfg, 7)
    audio = _audio(jcfg, 2, 40, 7)
    (l_j, _), g_j = _JAX_GRAD({k: jnp.asarray(v) for k, v in w.items()},
                              jcfg, jnp.asarray(audio), None, 0.01)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(w, "cpu").items()}
    l_t, _ = tw.loss_fn(tp, tcfg, torch.from_numpy(audio), None, 0.01)
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    assert set(g_j) == set(tp)
    for k in g_j:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_j[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


def test_routing_matches_jax():
    tcfg = TConfig(**BASE, use_pallas_stack=True)
    p = tw.init_params(0, tcfg, "cpu")
    codes = torch.zeros((1, 20), dtype=torch.int64)
    # Version 3 runs kernels/fused_stack.py, 2 experiments/fused_stack2.py
    # and any other version experiments/fused_stack.py, as in JAX.
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.experiments import fused_stack2 as fs2
    from wavenet_torch.kernels import fused_stack as fs3
    want = tw.forward_codes(p, dataclasses.replace(
        tcfg, use_pallas_stack=False), codes)
    seen = {}
    for version, module, name in ((3, fs3, "fused_stack3"),
                                  (2, fs2, "fused_stack2"),
                                  (1, fs1, "fused_stack"),
                                  (7, fs1, "fused_stack")):
        op = getattr(module, name)
        calls = []

        def spy(*a, _op=op, _calls=calls):
            _calls.append(1)
            return _op(*a)

        setattr(module, name, spy)
        try:
            got = tw.forward_codes(p, dataclasses.replace(
                tcfg, pallas_stack_version=version), codes)
        finally:
            setattr(module, name, op)
        seen[version] = len(calls)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert seen == {3: 1, 2: 1, 1: 1, 7: 1}
    for version in (1, 2, 3):
        deep = dataclasses.replace(tcfg, pallas_stack_version=version,
                                   dilations=(1, 2048))
        with pytest.raises(NotImplementedError, match="tile size"):
            tw.forward_codes(tw.init_params(0, deep, "cpu"), deep, codes)
    with pytest.raises(NotImplementedError, match="filter_width"):
        wide = dataclasses.replace(tcfg, filter_width=3)
        tw.forward_codes(tw.init_params(0, wide, "cpu"), wide, codes)
    # The sampler prefill (collect_layer_inputs) takes the plain path.
    plain = dataclasses.replace(tcfg, use_pallas_stack=False)
    got = tw.forward_codes(p, tcfg, codes, collect_layer_inputs=(2,) * 4)
    want = tw.forward_codes(p, plain, codes, collect_layer_inputs=(2,) * 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_remat_and_predict_proba():
    tcfg = TConfig(**BASE)
    w = _weights(JConfig(**BASE), 2)
    audio = torch.from_numpy(_audio(tcfg, 2, 12, 3))
    ids = torch.tensor([1, 2])
    grads = []
    for remat in (False, True):
        tp = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(w, "cpu").items()}
        loss, _ = tw.loss_fn(tp, dataclasses.replace(tcfg, remat=remat),
                             audio, ids)
        loss.backward()
        grads.append({k: v.grad for k, v in tp.items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6,
                                   atol=1e-7)
    codes = np.random.RandomState(4).randint(0, 32, (2, 30))
    jprob = jw.predict_proba({k: jnp.asarray(v) for k, v in w.items()},
                             JConfig(**BASE), jnp.asarray(codes),
                             jnp.asarray([1, 2]))
    tprob = tw.predict_proba(params_from_numpy(w, "cpu"), tcfg,
                             torch.from_numpy(codes), ids)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizers_match_optax(name):
    rng = np.random.RandomState(5)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(3)]

    opt = joptimizers[name](1e-2, 0.9)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = toptimizers[name](1e-2, 0.9)([tp[k] for k in sorted(tp)])
    for g in grads:
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_step_matches_jax_and_multistep():
    """Three steps of the port's fused-stack step (its plain versions on
    the CPU) against the JAX package's plain step; then two single steps
    against one two-step multistep."""
    jcfg = JConfig(**BASE)
    tcfg = TConfig(**BASE, use_pallas_stack=True)
    w = _weights(jcfg, 6)
    rng = np.random.RandomState(7)
    audio = rng.uniform(-1, 1, (3, 2, jcfg.receptive_field + 16)).astype(
        np.float32)
    ids = rng.randint(0, 4, (3, 2))

    jopt = joptimizers["adam"](1e-3, 0.9)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    from wavenet_tpu.train_lib import TrainState as JState
    js = JState(step=jnp.zeros((), jnp.int32), params=jp,
                opt_state=jopt.init(jp))
    jstep = jmake_train_step(jcfg, jopt, 0.01)
    jloss = []
    for i in range(3):
        js, m = jstep(js, jnp.asarray(audio[i]), jnp.asarray(ids[i]))
        jloss.append(float(m["loss"]))

    opt = tl.make_optimizer("adam", 1e-3)
    ts = tl.train_state_from_params(params_from_numpy(w, "cpu"), opt)
    step = tl.make_train_step(tcfg, 0.01)
    tloss = []
    for i in range(3):
        ts, m = step(ts, torch.from_numpy(audio[i]), torch.from_numpy(ids[i]))
        tloss.append(m["loss"].item())
        assert m["grad_norm"].item() > 0
    assert ts.step == 3
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for k in w:
        np.testing.assert_allclose(ts.params[k].detach().numpy(),
                                   np.asarray(js.params[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)

    a = tl.train_state_from_params(params_from_numpy(w, "cpu"), opt)
    b = tl.train_state_from_params(params_from_numpy(w, "cpu"), opt)
    single = []
    for i in range(2):
        a, m = step(a, torch.from_numpy(audio[i]), torch.from_numpy(ids[i]))
        single.append(m)
    multi = tl.make_train_multistep(tcfg, 0.01, steps_per_dispatch=2)
    b, mb = multi(b, torch.from_numpy(audio[:2]), torch.from_numpy(ids[:2]))
    assert b.step == a.step == 2 and mb["loss"].shape == (2,)
    for key in single[0]:
        assert torch.equal(mb[key], torch.stack([m[key] for m in single]))
    for k in w:
        assert torch.equal(a.params[k], b.params[k]), k


def _tiny_state(seed=0):
    cfg = TConfig(**BASE)
    return cfg, tl.create_train_state(seed, cfg, tl.make_optimizer("adam",
                                                                   1e-3),
                                      "cpu")


def _advance(cfg, state, n=1):
    step = tl.make_train_step(cfg)
    audio = torch.from_numpy(_audio(cfg, 2, 8, 9))
    for _ in range(n):
        state, _ = step(state, audio, torch.tensor([0, 1]))
    return state


@pytest.mark.parametrize("use_async", [False, True])
def test_checkpoint_roundtrip_and_prune(tmp_path, use_async):
    cfg, s = _tiny_state()
    root = str(tmp_path / "ckpts")
    for _ in range(3):
        s = _advance(cfg, s)
        tl.save_checkpoint(root, s, max_to_keep=2, use_async=use_async)
    tl.wait_for_checkpoints()
    assert sorted(os.listdir(root)) == ["ckpt-2", "ckpt-3"]
    assert tl.latest_checkpoint_step(root) == 3

    _, fresh = _tiny_state(seed=1)
    restored = tl.restore_checkpoint(root, fresh)
    assert restored.step == 3
    for k in s.params:
        assert torch.equal(restored.params[k], s.params[k]), k
    # The optimizer state came back too: one more step agrees exactly.
    a, b = _advance(cfg, s), _advance(cfg, restored)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert tl.restore_checkpoint(str(tmp_path / "none"), fresh) is None
    assert tl.restore_params_only(str(tmp_path / "none")) is None


def test_async_save_snapshots_the_state(tmp_path):
    """A background save writes the state as it was at the call, though
    training goes on updating the parameters in place."""
    cfg, s = _tiny_state()
    want = {k: v.detach().clone() for k, v in s.params.items()}
    tl.save_checkpoint(str(tmp_path), s, use_async=True)
    with torch.no_grad():
        for v in s.params.values():
            v.add_(1.0)
    tl.wait_for_checkpoints()
    got = tl.restore_params_only(str(tmp_path), device="cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_partial_save_never_corrupts_latest(tmp_path):
    """A save killed midway leaves only its temporary directory, which
    neither ``latest_checkpoint_step`` nor pruning counts."""
    cfg, s = _tiny_state()
    root = tmp_path / "ckpts"
    s = _advance(cfg, s)
    tl.save_checkpoint(str(root), s)
    fake = root / "ckpt-8.tmp-1234"
    fake.mkdir()
    (fake / "params.npz").write_bytes(b"truncated")
    assert tl.latest_checkpoint_step(str(root)) == 1
    _, fresh = _tiny_state(seed=1)
    assert tl.restore_checkpoint(str(root), fresh).step == 1
    s = _advance(cfg, s)
    tl.save_checkpoint(str(root), s, max_to_keep=1)
    assert sorted(os.listdir(root)) == ["ckpt-2", "ckpt-8.tmp-1234"]


def test_restored_params_serve(tmp_path):
    from wavenet_torch.serve import GenerationService

    cfg, s = _tiny_state()
    tl.save_checkpoint(str(tmp_path), _advance(cfg, s, 2))
    params = tl.restore_params_only(str(tmp_path), device="cpu")
    assert set(params) == set(s.params)
    js = str(tmp_path / "p.json")
    with open(js, "w") as f:
        json.dump(cfg.to_json_dict(), f)
    svc = GenerationService(os.path.join(tmp_path, "ckpt-2", "params.npz"),
                            js, cfg.gc_channels, cfg.gc_cardinality,
                            warm_samples=0, device="cpu")
    wave = svc.generate(40, gc_id=1, seed=3)
    assert wave.shape == (40,) and np.all(np.abs(wave) <= 1)
    for k, v in params.items():
        assert torch.equal(svc.params[k], v), k


def _corpus(tmp_path, sr=2000, seconds=1.5):
    from scipy.io import wavfile
    data = tmp_path / "corpus"
    data.mkdir()
    rng = np.random.RandomState(0)
    for spk, freq in [(1, 155.56), (2, 196.0), (3, 233.08)]:
        t = np.arange(int(sr * seconds)) / sr
        x = 0.6 * np.sin(2 * np.pi * freq * t + rng.uniform(0, 6))
        wavfile.write(str(data / f"p{spk}_000.wav"), sr,
                      (x * 32767).astype(np.int16))
    return str(data)


def test_reader_chunks_and_gc(tmp_path):
    data = _corpus(tmp_path)
    with AudioReader(data, 2000, gc_enabled=True, receptive_field=10,
                     sample_size=100, seed=0) as reader:
        assert reader.gc_category_cardinality == 4
        a = reader.dequeue(3)
        ids = reader.dequeue_gc(3)
    assert a.shape == (3, 110) and a.dtype == np.float32
    assert set(ids.tolist()) <= {1, 2, 3}
    with pytest.raises(ValueError, match="lc_channels and lc_hop"):
        AudioReader(data, 2000, lc_enabled=True)


def test_prefetcher_order_errors_and_bound():
    items = iter(range(100))
    pf = DevicePrefetcher(lambda: next(items), depth=2, max_items=5)
    assert [pf.get(timeout=5) for _ in range(5)] == [0, 1, 2, 3, 4]
    pf.stop()
    assert next(items) == 5          # the worker took no sixth item

    def fail():
        raise OSError("disk")
    pf = DevicePrefetcher(fail)
    with pytest.raises(OSError, match="disk"):
        pf.get(timeout=5)
    pf.stop()
    assert not any(t.name == "device-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_flops_match_jax():
    for kw in (BASE, dict(dilations=tuple([2 ** i for i in range(10)] * 3),
                          residual_channels=32, dilation_channels=32,
                          skip_channels=512)):
        jc, tc = JConfig(**kw), TConfig(**kw)
        assert (tflops.train_step_flops(tc, 8, 16000)
                == jflops.train_step_flops(jc, 8, 16000))
        assert (tflops.stack_macs_per_position(tc)
                == jflops.stack_macs_per_position(jc))
        assert (tflops.head_macs_per_position(tc)
                == jflops.head_macs_per_position(jc))


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    from wavenet_torch.cli import train as cli

    data = _corpus(tmp_path)
    pfile = tmp_path / "params.json"
    pfile.write_text(json.dumps(
        {"filter_width": 2, "sample_rate": 2000, "dilations": [1, 2, 4, 8],
         "residual_channels": 8, "dilation_channels": 8, "skip_channels": 16,
         "quantization_channels": 32, "use_biases": True}))
    logdir = str(tmp_path / "logdir")
    common = ["--data_dir", data, "--wavenet_params", str(pfile),
              "--logdir", logdir, "--batch_size", "2", "--sample_size",
              "100", "--checkpoint_every", "2", "--gc_channels", "4",
              "--use_pallas_stack", "--device", "cpu", "--seed", "1",
              "--silence_threshold", "0.02", "--steps_per_dispatch", "2"]
    assert cli.main(common + ["--num_steps", "4"]) == 0
    out = capsys.readouterr().out
    losses = [float(ln.split("loss = ")[1].split(",")[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert {"ckpt-2", "ckpt-4", "metrics.jsonl"} <= set(os.listdir(logdir))
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        assert sum(json.loads(ln)["tag"] == "loss" for ln in f) == 4

    assert cli.main(common + ["--num_steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "Restored model from step 4" in out
    assert "step 5 - loss = " in out
    assert tl.latest_checkpoint_step(logdir) == 5

    # LC trains (tests/test_torch_lc_train.py); without --lc_hop the CLI
    # stops as the JAX CLI does.
    assert cli.main(common + ["--num_steps", "6", "--lc_channels", "4"]) == 1
    assert "--lc_channels requires --lc_hop" in capsys.readouterr().out
    for flag in (["--store_metadata", "true"], ["--histograms", "true"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 10"):
            cli.main(common + ["--num_steps", "6"] + flag)
    # Item 9 runs in several processes (tests/test_torch_parallel_cli.py):
    # one process cannot hold a model split two ways, and an address needs
    # the process counts.
    with pytest.raises(ValueError, match="processes"):
        cli.main(common + ["--num_steps", "6", "--model_parallelism", "2"])
    with pytest.raises(ValueError, match="num_processes"):
        cli.main(common + ["--num_steps", "6", "--coordinator_address",
                           "127.0.0.1:1"])
