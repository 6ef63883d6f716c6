"""The port's dp x tp sharding against the JAX package, on the CPU.

Mirrors tests/test_sharding.py. One gloo group of 4 processes
(``tests/torch_gloo.py``, spawned once for the module) trains 3 Adam
steps on (data, model) meshes with tp = 1, 2, 4 from the JAX package's
weights, and runs ``generate_sharded``; the losses are held against JAX's
single-device ``run_steps`` and the codes against the port's own
``sample.generate``. The rest runs in this process.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.models.wavenet import init_params as jinit
from wavenet_tpu.parallel.sharding import (
    param_partition_specs as jspecs)
from wavenet_tpu.train_lib import (
    create_train_state, make_optimizer, make_train_step)
from wavenet_torch import parallel as tparallel
from wavenet_torch import train_lib as tl
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy
from wavenet_torch.sample import generate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gloo  # noqa: E402

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

# tests/test_sharding.py's cfg_for_tp: D and S divisible by tp = 2 and 4.
TP_CFG = dict(dilations=(1, 2, 4, 8), residual_channels=8,
              dilation_channels=8, skip_channels=16,
              quantization_channels=64, use_biases=True, gc_channels=4,
              gc_cardinality=4)
WORLD = 4
GEN_N, GEN_BATCH, GEN_SEED = 40, 8, 9


def make_batch(cfg, batch=8, extra=24, seed=0):
    """tests/test_sharding.py's batches."""
    rng = np.random.RandomState(seed)
    T = cfg.receptive_field + extra
    audio = rng.uniform(-1, 1, (batch, T)).astype(np.float32)
    gc = rng.randint(0, cfg.gc_cardinality, batch).astype(np.int32)
    return audio, gc


def jax_run_steps(cfg, n_steps=3):
    """tests/test_sharding.py's single-device ``run_steps``: the losses
    and the initial weights (numpy)."""
    optimizer = make_optimizer("adam", 1e-3)
    state = create_train_state(jax.random.PRNGKey(0), cfg, optimizer)
    weights = {k: np.asarray(v) for k, v in state.params.items()}
    step_fn = make_train_step(cfg, optimizer, 0.001)
    losses = []
    for i in range(n_steps):
        audio, gc = make_batch(cfg, seed=i)
        state, metrics = step_fn(state, jnp.asarray(audio), jnp.asarray(gc))
        losses.append(float(jax.device_get(metrics["loss"])))
    return losses, weights


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """JAX's reference, then the 4-process run: (reference losses,
    weights, every rank's results)."""
    ref_losses, weights = jax_run_steps(JConfig(**TP_CFG))
    cfg = TConfig(**TP_CFG)
    outdir = str(tmp_path_factory.mktemp("torch_sharding"))
    rng = np.random.RandomState(5)
    torch.save({"cfg": TP_CFG, "weights": weights,
                "batches": [make_batch(cfg, seed=i) for i in range(3)],
                "gen_n": GEN_N, "gen_batch": GEN_BATCH, "gen_seed": GEN_SEED,
                "gen_gc": rng.randint(0, 4, GEN_BATCH)},
               os.path.join(outdir, "inputs.pt"))
    results = torch_gloo.run("sharding", outdir, WORLD)
    return ref_losses, weights, results


@pytest.mark.parametrize("model_parallelism", [1, 2, 4])
def test_sharded_matches_single_device(group, model_parallelism):
    ref, _, results = group
    for r in results:
        np.testing.assert_allclose(r["losses"][model_parallelism], ref,
                                   rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["remat", "pallas"])
def test_tp2_variants_match_single_device(group, variant):
    """``remat`` recomputes each layer's all-reduce in the backward;
    ``use_pallas_stack`` runs the stack on the gathered weights. Both at
    (data 2, model 2) against JAX's single-device losses."""
    ref, _, results = group
    for r in results:
        np.testing.assert_allclose(r["losses"][variant], ref, rtol=5e-5,
                                   atol=1e-6)


def test_pallas_stack_under_tp_runs_on_gathered_weights(group):
    """The fused stack is called with the whole D (its w_fg [L, 2R, 2D]),
    never a model shard's: JAX's Pallas call under GSPMD takes gathered
    operands (parallel/tensor.py)."""
    D = TP_CFG["dilation_channels"]
    for r in group[2]:
        assert r["stack_widths"]
        assert all(w[-1] == 2 * D for w in r["stack_widths"]), \
            r["stack_widths"]


def test_params_actually_sharded(group):
    """tp = 4 on a (1, 4) mesh: filter's D split 4 ways, each rank its own
    block; the batch rows split over data at tp = 2 (2 data ranks)."""
    _, weights, results = group
    c = TP_CFG
    for rank, r in enumerate(results):
        s4 = r["shapes"][4]
        assert s4["filter"][-1] == c["dilation_channels"] // 4
        assert s4["dense"][1] == c["dilation_channels"] // 4
        assert s4["postprocess1"][1] == c["skip_channels"] // 4
        assert s4["postprocess2"][0] == c["skip_channels"] // 4
        assert s4["causal_filter"] == weights["causal_filter"].shape
        assert r["shapes"][1]["filter"] == weights["filter"].shape
        assert r["shapes"][2]["batch"][0] == 8 // 2
        assert r["shapes"][4]["batch"][0] == 8
        # make_global_mesh(2) at world 4: (data 2, model 2), rank's block.
        assert r["global_mesh"] == {"data": 2, "model": 2}
        m = rank % 2
        np.testing.assert_array_equal(
            r["shard_filter"], weights["filter"][..., m * 4:(m + 1) * 4])


@pytest.mark.parametrize("gc", [False, True], ids=["nogc", "gc"])
@pytest.mark.parametrize("model_parallelism", [1, 2, 4])
def test_sharded_generation_matches_single_device(group, model_parallelism,
                                                  gc):
    """dp x tp scan sampling emits ``sample.generate``'s codes for the
    same generator, on every rank."""
    _, weights, results = group
    cfg = TConfig(**TP_CFG)
    gc_ids = (torch.as_tensor(np.random.RandomState(5).randint(
        0, 4, GEN_BATCH)) if gc else None)
    ref = generate(params_from_numpy(weights, "cpu"), cfg, GEN_N,
                   torch.Generator().manual_seed(GEN_SEED),
                   batch_size=GEN_BATCH, gc_ids=gc_ids).numpy()
    for r in results:
        np.testing.assert_array_equal(r["codes"][model_parallelism, gc],
                                      ref)


@pytest.mark.parametrize("extra", [{}, dict(use_biases=False,
                                            scalar_input=True,
                                            dilations=(1, 2)),
                                   dict(lc_channels=3, lc_refine_width=5)])
def test_spec_covers_every_param(extra):
    """The port's spec of every param is JAX's."""
    jcfg = JConfig(**{**TP_CFG, **extra})
    params = jinit(jax.random.PRNGKey(0), jcfg)
    specs = tparallel.param_partition_specs(TConfig(**{**TP_CFG, **extra}),
                                            params)
    assert set(specs) == set(params)
    for k, spec in jspecs(jcfg, params).items():
        assert specs[k] == tuple(spec), k
        assert len(specs[k]) <= params[k].ndim, k
    assert tparallel.batch_spec() == ("data", None)


def test_multihost_helpers_single_process_degrade(monkeypatch):
    """On one process with no group these take the local path."""
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tparallel.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    assert tparallel.make_mesh() is None
    assert tparallel.make_global_mesh() is None
    with pytest.raises(ValueError, match="model_parallelism"):
        tparallel.make_global_mesh(model_parallelism=2)
    cfg = TConfig(**TP_CFG)
    audio, gc = make_batch(cfg)
    a, g, lc = tparallel.global_batch_from_local(audio, None, gc)
    assert a is audio and g is gc and lc is None
    a, g, _ = tparallel.shard_batch(audio, None, gc)
    np.testing.assert_array_equal(a, audio)
    np.testing.assert_array_equal(g, gc)
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in jinit(jax.random.PRNGKey(0),
                                            JConfig(**TP_CFG)).items()},
        "cpu")
    sharded = tparallel.shard_params(params, cfg, None)
    assert all(torch.equal(sharded[k], params[k]) for k in params)
    state = tl.train_state_from_params(params, tl.make_optimizer("adam",
                                                                 1e-3))
    assert tparallel.shard_train_state(state, cfg, None) is state


def test_coordinator_flags_need_process_counts():
    with pytest.raises(ValueError, match="num_processes"):
        tparallel.initialize_multihost("127.0.0.1:1", device="cpu")
