"""The fat-matmul re-association (``wavenet_torch.kernels.fat``) against
the JAX package's ``wavenet_tpu/kernels/fat.py``: the assembled weights
and the fat recurrence on the same numpy inputs, and gradients through the
assembly. The twin of ``tests/test_fat.py``, with its config and
tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.kernels import fat as jfat
from wavenet_torch.kernels import fat as tfat
from wavenet_torch.models.config import WaveNetConfig as TConfig

from test_fused_stack import small_cfg

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

B, T = 2, 150


def _inputs(seed):
    """Packed stack weights with non-zero dense biases (which the
    shifted-bias pad fill must cancel) and the stack input, as numpy."""
    cfg = small_cfg()
    L, R, D = cfg.num_layers, cfg.residual_channels, cfg.dilation_channels
    rng = np.random.RandomState(seed)
    w = [(0.3 * rng.randn(L, 2 * R, 2 * D)).astype(np.float32),
         (0.3 * rng.randn(L, D, R)).astype(np.float32),
         (0.1 * rng.randn(L, B, 2 * D)).astype(np.float32),
         (0.3 * rng.randn(L, 1, R)).astype(np.float32)]
    x = (0.5 * rng.randn(B, T, R)).astype(np.float32)
    tcfg = TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TConfig)})
    return cfg, tcfg, w, x


@pytest.mark.parametrize("one_tanh", [False, True])
def test_fat_forward_matches_jax(one_tanh):
    jcfg, tcfg, w, x = _inputs(0)
    assert tfat.fat_widths(tcfg) == jfat.fat_widths(jcfg)
    Fj, bj, cj = jfat.assemble_fat_weights(*[jnp.asarray(a) for a in w],
                                           jcfg, one_tanh=one_tanh)
    Ft, bt, ct = tfat.assemble_fat_weights(*[torch.from_numpy(a) for a in w],
                                           tcfg, one_tanh=one_tanh)
    for name, a, b in (("F", Ft, Fj), ("beta", bt, bj), ("fill", ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    y_j, z_j = jfat.fat_forward_reference(jnp.asarray(x), Fj, bj, cj, jcfg,
                                          one_tanh=one_tanh)
    y, z = tfat.fat_forward_reference(torch.from_numpy(x), Ft, bt, ct, tcfg,
                                      one_tanh=one_tanh)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-4,
                               atol=1e-5)


def test_gated_from_onetanh_matches_jax():
    th = np.tanh(np.random.RandomState(1).randn(3, 5, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tfat.gated_from_onetanh(torch.from_numpy(th), 8).numpy(),
        np.asarray(jfat.gated_from_onetanh(jnp.asarray(th), 8)))


def test_fat_gradients_through_assembly_match_jax():
    """Gradients of the fat recurrence with respect to the packed weights
    and the input, differentiated through the assembly in both packages."""
    jcfg, tcfg, w, x = _inputs(2)
    L, R, D = jcfg.num_layers, jcfg.residual_channels, jcfg.dilation_channels
    rng = np.random.RandomState(3)
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, L * D).astype(np.float32)

    def loss_j(x, w_fg, wd, add, bd):
        Fw, beta, fill = jfat.assemble_fat_weights(w_fg, wd, add, bd, jcfg)
        y, z = jfat.fat_forward_reference(x, Fw, beta, fill, jcfg)
        return jnp.sum(y * cy) + jnp.sum(z * cz)

    g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(
        jnp.asarray(x), *[jnp.asarray(a) for a in w])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + w]
    Fw, beta, fill = tfat.assemble_fat_weights(*leaves[1:], tcfg)
    y, z = tfat.fat_forward_reference(leaves[0], Fw, beta, fill, tcfg)
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z * torch.from_numpy(cz))).backward()
    for name, t, g in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"), leaves, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-3,
                                   atol=2e-4, err_msg=name)
