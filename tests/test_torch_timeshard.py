"""The port's time-axis (sequence) parallelism against the JAX package.

Mirrors tests/test_timeshard.py's five cases. One gloo group of 4
processes (``tests/torch_gloo.py``, spawned once for the module) runs
``make_time_sharded_grad_fn`` on a (data 1, time 4) and a (data 2,
time 2) mesh from the JAX package's weights; the loss and gradients are
held against JAX's unsharded ``loss_fn`` at that test's tolerances
(loss rtol 1e-5, gradients rtol 2e-4 / atol 1e-6). Each case also holds
``time_sharded_loss``'s gradients, summed over the ranks, to the same
reference.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.models.wavenet import init_params, loss_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gloo  # noqa: E402

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

WORLD = 4


def small_cfg(**kw):
    """tests/test_timeshard.py's config."""
    d = dict(dilations=(1, 2, 4, 8), residual_channels=6,
             dilation_channels=5, skip_channels=9,
             quantization_channels=32, use_biases=True, sample_rate=2000)
    d.update(kw)
    return d


def padded_audio(rng, rf, B, T):
    """Reader-layout chunk: receptive_field zeros then signal."""
    audio = rng.uniform(-0.9, 0.9, (B, T)).astype(np.float32)
    audio[:, :rf] = 0.0
    return audio


def _case(cfg_kw, key, B, T, mesh, rng, gc=None, l2=None, zeros=False):
    cfg = JConfig(**cfg_kw)
    weights = {k: np.asarray(v)
               for k, v in init_params(jax.random.PRNGKey(key), cfg).items()}
    audio = (np.zeros((B, T), np.float32) if zeros
             else padded_audio(rng, cfg.receptive_field, B, T))
    return {"cfg": cfg_kw, "weights": weights, "audio": audio, "mesh": mesh,
            "gc": None if gc is None else np.asarray(gc), "l2": l2}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    rng = np.random.RandomState(42)
    cases = {
        # Tl = 64 > rf = 16 on 4 time ranks (JAX: 32 on 8).
        "loss": _case(small_cfg(), 0, 2, 256, (1, 4), rng),
        "grads": _case(small_cfg(), 1, 1, 256, (1, 4), rng),
        "data_time": _case(small_cfg(), 2, 2, 256, (2, 2), rng),
        "gc_l2": _case(small_cfg(gc_channels=4, gc_cardinality=5), 3, 2,
                       256, (1, 4), rng, gc=[1, 4], l2=0.01),
        # rf = 64: a local slice of 256 / 4 = 64 is not longer.
        "short": _case(small_cfg(dilations=(1, 2, 4, 8, 16, 32)), 4, 1,
                       256, (1, 4), rng, zeros=True),
    }
    outdir = str(tmp_path_factory.mktemp("torch_timeshard"))
    torch.save({"cases": cases}, os.path.join(outdir, "inputs.pt"))
    return cases, torch_gloo.run("timeshard", outdir, WORLD)


def _reference(case):
    """JAX's unsharded (total, aux, grads)."""
    cfg = JConfig(**case["cfg"])
    p = {k: jnp.asarray(v) for k, v in case["weights"].items()}
    audio = jnp.asarray(case["audio"])
    gc = None if case["gc"] is None else jnp.asarray(case["gc"])

    def f(params):
        return loss_fn(params, cfg, audio, gc, case["l2"])

    (total, aux), grads = jax.value_and_grad(f, has_aux=True)(p)
    return float(total), {k: float(v) for k, v in aux.items()}, \
        {k: np.asarray(v) for k, v in grads.items()}


def _hold_grads(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def test_loss_matches_unsharded(group):
    cases, results = group
    total, aux, _ = _reference(cases["loss"])
    for r in results:
        np.testing.assert_allclose(r["loss"]["total"], total, rtol=1e-5)
        np.testing.assert_allclose(r["loss"]["ce_loss"], aux["ce_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["loss"]["loss_fn_total"], total,
                                   rtol=1e-5)


def test_grads_match_unsharded(group):
    cases, results = group
    _, _, grads = _reference(cases["grads"])
    for r in results:
        _hold_grads(r["grads"]["grads"], grads)
        _hold_grads(r["grads"]["loss_grads"], grads)


def test_data_and_time_axes_combined(group):
    """2-way batch sharding x 2-way time sharding on one mesh."""
    cases, results = group
    total, _, grads = _reference(cases["data_time"])
    for r in results:
        np.testing.assert_allclose(r["data_time"]["total"], total,
                                   rtol=1e-5)
        _hold_grads(r["data_time"]["grads"], grads)
        _hold_grads(r["data_time"]["loss_grads"], grads)


def test_gc_and_l2(group):
    cases, results = group
    case = cases["gc_l2"]
    total, aux, grads = _reference(case)
    for r in results:
        res = r["gc_l2"]
        np.testing.assert_allclose(res["total"], total, rtol=1e-5)
        np.testing.assert_allclose(res["l2_loss"], aux["l2_loss"],
                                   rtol=1e-5)
        _hold_grads(res["grads"], grads)
        # time_sharded_loss was called without L2: add its gradient.
        _hold_grads({k: g + (0.01 * case["weights"][k]
                             if not k.endswith("_bias") else 0)
                     for k, g in res["loss_grads"].items()}, grads)


def test_local_slice_must_exceed_receptive_field(group):
    for r in group[1]:
        assert "receptive field" in r["short"]["error"]
        assert "(64)" in r["short"]["error"]
