"""The b1 probe's plain versions against the JAX package's TPU probe tool.

``wavenet_torch.tools.r3_b1_bisect`` (the port of ``tools/r3_b1_bisect.py``)
is held against that tool, loaded from its file with ``N_STEPS`` set to a
few steps on a tiny config and run in interpret mode with zero-initialised
scratch. The tool's module gets a stand-in for ``pltpu`` whose
``prng_random_bits`` returns zeros: the Gumbel term is then one constant,
every mode's codes are an argmax, and the port's plain version, given the
same constant noise, must emit the same codes exactly, in the decode
kernel's order of sums and in the cluster kernel's on plans of 1, 2 and 4
CTAs (the JAX tool runs once per mode and weight type, for both). The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_gpu.py).
"""

import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.kernels import sampler as js
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch.kernels import sampler as ts
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy
from wavenet_torch.tools import r3_b1_bisect as r3

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(dilations=(1, 2, 4, 1, 2), residual_channels=8,
           dilation_channels=8, skip_channels=16, quantization_channels=32)
N_STEPS = 6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


class _ZeroBitsPltpu(types.ModuleType):
    """``pltpu`` whose random bits are zeros (and whose seed is a no-op)."""

    def __getattr__(self, name):
        return getattr(pltpu, name)

    @staticmethod
    def prng_seed(*seeds):
        del seeds

    @staticmethod
    def prng_random_bits(shape):
        return jnp.zeros(shape, jnp.int32)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_tool_r3_b1_bisect", os.path.join(ROOT, "tools",
                                               "r3_b1_bisect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N_STEPS = N_STEPS
    mod.pltpu = _ZeroBitsPltpu("pltpu")
    return mod


@pytest.fixture(scope="module")
def params():
    """The tiny config's weights with seeded non-zero biases, as numpy."""
    p = {k: v.numpy() for k, v in
         tw.init_params(0, TConfig(**CFG), device="cpu").items()}
    rng = np.random.RandomState(0)
    return {k: ((0.1 * rng.randn(*v.shape)).astype(np.float32)
                if k.endswith("_bias") else v) for k, v in sorted(p.items())}


def _packed(params, dt):
    jdt, tdt = DTYPES[dt]
    jpk = js.pack_sampler_weights({k: jnp.asarray(v) for k, v in
                                   params.items()}, JConfig(**CFG), 1,
                                  weight_dtype=jdt)
    tpk = ts.pack_sampler_weights(params_from_numpy(params, "cpu"),
                                  TConfig(**CFG), 1, weight_dtype=tdt)
    return jpk, tpk


def _zero_bits_noise(n: int, q: int) -> torch.Tensor:
    """The Gumbel term of all-zero random bits: u clamps to 1e-20."""
    u = torch.full((n, 1, q), 1e-20, dtype=torch.float32)
    return -torch.log(-torch.log(u))


@pytest.fixture(scope="module")
def jax_codes(tool, params):
    """The JAX tool's codes [1, N_STEPS] by (mode, dtype), each run once in
    interpret mode on first use."""
    cache = {}

    def codes(mode, dt):
        if (mode, dt) not in cache:
            jpk, _ = _packed(params, dt)
            with pltpu.force_tpu_interpret_mode(
                    pltpu.InterpretParams(uninitialized_memory="zero")):
                want = np.asarray(tool.run(jpk, jnp.asarray([7], jnp.int32),
                                           JConfig(**CFG), mode))
            cache[mode, dt] = want.reshape(1, N_STEPS)
        return cache[mode, dt]

    return codes


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", r3.MODES)
def test_b1_bisect_matches_jax_tool(jax_codes, params, mode, dt):
    _, tpk = _packed(params, dt)
    c = TConfig(**CFG)
    got = r3.b1_bisect_reference(
        tpk, c, mode, N_STEPS,
        noise=_zero_bits_noise(N_STEPS, c.quantization_channels))
    np.testing.assert_array_equal(got.numpy(), jax_codes(mode, dt))


def _plan(cs: int) -> ts.ClusterPlan:
    """The cluster kernel's plan of ``cs`` CTAs at the tiny config (one row
    a cluster, layers as the route splits them)."""
    return ts.ClusterPlan(cs, 1, ts.layer_split(len(CFG["dilations"]), cs))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", r3.MODES)
@pytest.mark.parametrize("cs", [1, 2, 4])
def test_b1_bisect_cluster_order_matches_jax_tool(jax_codes, params, cs,
                                                  mode, dt):
    """The plain version in the cluster kernel's order of sums (its lanes'
    K groups and shuffle tree, the CTAs' skip partials, the head split by
    CS) emits the JAX tool's codes."""
    _, tpk = _packed(params, dt)
    c = TConfig(**CFG)
    got = r3.b1_bisect_reference(
        tpk, c, mode, N_STEPS,
        noise=_zero_bits_noise(N_STEPS, c.quantization_channels),
        kernel="cluster", plan=_plan(cs))
    np.testing.assert_array_equal(got.numpy(), jax_codes(mode, dt))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", r3.MODES)
def test_teacher_forced_logits_equal_the_step_loop(params, mode, dt):
    """``b1_bisect_logits`` (one pass over time, how a kernel run's codes
    are replayed) gives the step loop's logits on the loop's own inputs."""
    _, tpk = _packed(params, dt)
    c = TConfig(**CFG)
    n = 24
    codes, lg = r3.b1_bisect_reference(tpk, c, mode, n, seed=3,
                                       collect_logits=True)
    first = torch.full((1, 1), c.quantization_channels // 2,
                       dtype=torch.int32)
    inputs = torch.cat([first, codes[:, :-1]], dim=1)
    np.testing.assert_allclose(r3.b1_bisect_logits(tpk, c, mode,
                                                   inputs).numpy(),
                               lg.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", r3.MODES)
def test_cluster_teacher_forced_logits_equal_the_step_loop(params, mode, dt):
    """``b1_bisect_logits(kernel="cluster")`` gives the cluster-order step
    loop's logits on the loop's own inputs, bit for bit (the same sums in
    the same order, over time at once), on a plan of 2 CTAs."""
    _, tpk = _packed(params, dt)
    c, plan = TConfig(**CFG), _plan(2)
    n = 24
    codes, lg = r3.b1_bisect_reference(tpk, c, mode, n, seed=3,
                                       collect_logits=True, kernel="cluster",
                                       plan=plan)
    first = torch.full((1, 1), c.quantization_channels // 2,
                       dtype=torch.int32)
    inputs = torch.cat([first, codes[:, :-1]], dim=1)
    got = r3.b1_bisect_logits(tpk, c, mode, inputs, kernel="cluster",
                              plan=plan)
    np.testing.assert_array_equal(got.numpy(), lg.numpy())


def test_full_f32_is_the_sequential_route(params):
    """``full`` at float32 is the production step: its codes are
    ``decode_sequential``'s from the same zero state, first code and seed."""
    _, tpk = _packed(params, "f32")
    c = TConfig(**CFG)
    first = torch.full((1, 1), c.quantization_channels // 2,
                       dtype=torch.int32)
    want, _ = ts.decode_sequential(tpk, c, first, 40, seed=11)
    before = r3.b1_bisect.launches
    got = r3.b1_bisect(tpk, c, "full", 40, seed=11)
    assert r3.b1_bisect.launches == before      # the CPU runs the plain one
    assert torch.equal(got, want)


def test_b1_bisect_refuses_what_it_does_not_take(params):
    _, tpk = _packed(params, "f32")
    c = TConfig(**CFG)
    with pytest.raises(ValueError, match="mode"):
        r3.b1_bisect(tpk, c, "no_such_mode", 4)
    with pytest.raises(NotImplementedError, match="R == D"):
        r3.b1_bisect(tpk, TConfig(**dict(CFG, dilation_channels=4)),
                     "full", 4)
    with pytest.raises(ValueError, match="kernel"):
        r3.b1_bisect(tpk, c, "full", 4, kernel="tiles")
    with pytest.raises(ValueError, match="kernel"):
        r3.b1_bisect_logits(tpk, c, "full", torch.zeros((1, 4)),
                            kernel="auto")
    # The CPU has no device plan: the cluster order needs one.
    with pytest.raises(ValueError, match="needs a plan"):
        r3.b1_bisect(tpk, c, "full", 4, kernel="cluster")
    with pytest.raises(ValueError, match="cluster kernel's"):
        r3.b1_bisect_reference(tpk, c, "full", 4, plan=_plan(2))
    # Layer ranges that stop short of L, or pass it.
    for begin in ((0, 2, 4), (0, 3, 6)):
        with pytest.raises(ValueError, match="cover the L"):
            r3.b1_bisect(tpk, c, "full", 4, kernel="cluster",
                         plan=ts.ClusterPlan(2, 1, begin))
    with pytest.raises(ValueError, match="cover the L"):
        r3.b1_bisect_logits(tpk, c, "full", torch.zeros((1, 4)),
                            kernel="cluster",
                            plan=ts.ClusterPlan(2, 1, (0, 5)))
