"""The product-chain probe's plain versions against the JAX package's TPU
probe tool.

``wavenet_torch.tools.r4_matvec_probe`` (the port of
``tools/r4_matvec_probe.py``) is held against that tool, loaded from its
file with C = 8, L = 4 and N_STEPS = 3 and run in interpret mode, on
4 x random orthogonal weights (with the 0.25 scale each product keeps |x|,
so the chain neither vanishes nor blows up). The CUDA kernel is held
against these plain versions on the card (tests/test_torch_gpu.py).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_torch.tools import r4_matvec_probe as r4

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, L, N_STEPS = 8, 4, 3


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_tool_r4_matvec_probe",
        os.path.join(ROOT, "tools", "r4_matvec_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.C, mod.L, mod.N_STEPS = C, L, N_STEPS
    return mod


@pytest.mark.parametrize("mode", r4.MODES)
def test_matvec_probe_matches_jax_tool(tool, mode):
    w = r4.orthogonal_weights(L, C, seed=1)
    wt = w.transpose(1, 2).contiguous()
    with pltpu.force_tpu_interpret_mode(
            pltpu.InterpretParams(uninitialized_memory="zero")):
        want = np.asarray(tool.run(jnp.asarray(w.numpy()),
                                   jnp.asarray(wt.numpy()), mode))
    before = r4.matvec_probe.launches
    got = r4.matvec_probe(w, wt, mode, N_STEPS)
    assert r4.matvec_probe.launches == before   # the CPU runs the plain one
    assert np.abs(want).max() > 1e-3            # the chain did not vanish
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_orthogonal_chain_keeps_its_norm():
    w = r4.orthogonal_weights(L, C)
    x = r4.matvec_probe_reference(w, w.transpose(1, 2), "mxu", 50)
    np.testing.assert_allclose(x.norm().item(), 0.01 * C ** 0.5, rtol=1e-4)


def test_matvec_probe_refuses_an_odd_chain():
    w = r4.orthogonal_weights(3, C)
    with pytest.raises(ValueError, match="even"):
        r4.matvec_probe(w, w, "vpu", 1)
