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


def test_pair_split_by_hand():
    """60 products over 8 CTAs: 30 pairs, 4 a CTA and 2 on the last."""
    begin = r4.pair_split(60, 8)
    assert begin == (0, 4, 8, 12, 16, 20, 24, 28, 30)
    assert [b - a for a, b in zip(begin, begin[1:])] == [4] * 7 + [2]
    assert r4.pair_split(8, 1) == (0, 4)


H100_SMEM_OPTIN = 232448   # bytes of shared memory a block may opt into


@pytest.mark.parametrize("n_prod,c,cs,most", [
    (60, 64, 8, 4),     # 4 pairs of 16 KB products: 128 KB a CTA
    (8, 64, 1, 4),      # main's one-CTA run
    (60, 32, 2, 15),    # 15 pairs of 4 KB products: 120 KB
])
def test_cluster_split_takes_the_fewest_ctas(n_prod, c, cs, most):
    k, begin = r4.cluster_split(n_prod, c, H100_SMEM_OPTIN)
    assert k == cs and begin == r4.pair_split(n_prod, cs)
    assert max(b - a for a, b in zip(begin, begin[1:])) == most
    assert r4.cluster_smem_bytes(c, most) <= H100_SMEM_OPTIN
    if cs > 1:   # half the CTAs would not hold their shares
        fewer = r4.pair_split(n_prod, cs // 2)
        assert r4.cluster_smem_bytes(c, max(
            b - a for a, b in zip(fewer, fewer[1:]))) > H100_SMEM_OPTIN


def test_cluster_split_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="even"):
        r4.cluster_split(59, 64, H100_SMEM_OPTIN)
    for c in (16, 48, 128):
        with pytest.raises(NotImplementedError, match="C in"):
            r4.cluster_split(60, c, H100_SMEM_OPTIN)
    # Too little shared memory for any cluster, or for the one pinned.
    with pytest.raises(ValueError, match="no cluster"):
        r4.cluster_split(60, 64, 16 * 1024)
    with pytest.raises(ValueError, match="no cluster"):
        r4.cluster_split(60, 64, H100_SMEM_OPTIN, cs=4)


def test_matvec_probe_kernels_run_one_plain_version():
    """On the CPU either kernel runs the plain version, and an unknown
    kernel is refused."""
    w = r4.orthogonal_weights(L, C, seed=3)
    wt = w.transpose(1, 2).contiguous()
    for mode in r4.MODES:
        got = {k: r4.matvec_probe(w, wt, mode, 4, kernel=k)
               for k in r4.KERNELS}
        assert torch.equal(got["cluster"], got["decode"])
    with pytest.raises(ValueError, match="kernel"):
        r4.matvec_probe(w, wt, "mxu", 1, kernel="tiles")
