"""The retired stack generation v1 (``wavenet_torch.experiments.fused_stack``)
against the JAX package's TPU kernels, and both generations' autograd ops.

The port's forward and backward (on the CPU: their plain versions) are
held against ``wavenet_tpu/experiments/fused_stack.py`` run in interpret
mode, with the backward functions called directly on the same saved
tensors. v2 is ``tests/test_torch_stack_v2.py``; ``loss_fn`` at versions 1
and 2 is in ``tests/test_torch_train.py``. Inputs are made with numpy from
a seed. The CUDA kernel itself is held against these plain versions on
the card (``tests/test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.experiments import fused_stack as jfs1
from wavenet_tpu.experiments import fused_stack2 as jfs2
from wavenet_tpu.models import wavenet as jw
from wavenet_torch.experiments import fused_stack as tfs1
from wavenet_torch.experiments import fused_stack2 as tfs2
from wavenet_torch.kernels.stack_pack import pack_stack_weights
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_fused_stack import small_cfg

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

# Another f32 summation order than the TPU kernels'.
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
# The backward sums ~300 rows per weight gradient and rebuilds each
# layer's input by subtraction.
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, TILE = 2, 150, 64
# d = 64 equals the JAX kernels' tile here: the past tap is all carry.
DILATIONS = (1, 2, 4, 16, 64)


# The JAX kernels under jit: the cases of a test share one compile.
_JFWD = jax.jit(jfs1.fused_stack_forward, static_argnums=(5, 6, 7, 8))
_JBWD = jax.jit(jfs1.fused_stack_backward, static_argnums=(7, 8, 9))


def _tcfg(jcfg):
    return TConfig(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def _setup(gc: bool, seed: int):
    """Config, packed weights (numpy) with seeded non-zero biases, the
    stack input and the cotangents."""
    jcfg = small_cfg(dilations=DILATIONS, gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None)
    rng = np.random.RandomState(seed)
    jp = {k: np.asarray(v)
          for k, v in jw.init_params(jax.random.PRNGKey(seed), jcfg).items()}
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    tp = params_from_numpy(jp, "cpu")
    gc_emb = tp["gc_embedding"][torch.tensor([0, 3])] if gc else None
    pack = [t.numpy() for t in pack_stack_weights(tp, _tcfg(jcfg), gc_emb,
                                                  B)]
    # GC enters only through ``add``: both cases give the kernels one
    # config, so that they share one compile.
    jcfg = small_cfg(dilations=DILATIONS)
    c = _tcfg(jcfg)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    x = (0.5 * rng.randn(B, T, R)).astype(np.float32)
    dy = rng.randn(B, T, R).astype(np.float32)
    dz = rng.randn(B, T, L * D).astype(np.float32)
    return jcfg, c, pack, x, dy, dz


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=name)


def _check_grads(got, want):
    for name, g, w in zip(("dx", "dw", "dwd", "dadd", "dbd"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, BWD_TOL, name)


@pytest.mark.parametrize("gc", [False, True])
def test_v1_matches_jax_kernels(gc):
    jcfg, c, pack, x, dy, dz = _setup(gc, 0)
    assert tfs1.supports(c, TILE) and jfs1.supports(jcfg, TILE)
    jpack = [jnp.asarray(a) for a in pack]
    tpack = [torch.from_numpy(a) for a in pack]
    with pltpu.force_tpu_interpret_mode():
        y_j, fg_j = _JFWD(jnp.asarray(x), *jpack, jcfg,
                                             jnp.float32, jnp.float32, TILE)
    before = tfs1.fused_stack_forward.launches
    y, fg = tfs1.fused_stack_forward(torch.from_numpy(x), *tpack, c)
    assert tfs1.fused_stack_forward.launches == before  # the plain one
    _close(y, y_j, FWD_TOL, "y")
    _close(fg, fg_j, FWD_TOL, "fg")
    _close(tfs1._fg_to_z(fg, c), jfs1._fg_to_z(fg_j, jcfg), FWD_TOL, "z")

    # The backward functions on the same saved tensors (the JAX ones).
    w_fg, wd, _, bd = jpack
    with pltpu.force_tpu_interpret_mode():
        want = _JBWD(
            y_j, fg_j, jnp.asarray(dz), jnp.asarray(dy), w_fg, wd, bd, jcfg,
            jnp.float32, TILE)
    w_fg, wd, _, bd = tpack
    before = tfs1.fused_stack_backward.launches
    got = tfs1.fused_stack_backward(
        torch.from_numpy(np.asarray(y_j)), torch.from_numpy(np.asarray(fg_j)),
        torch.from_numpy(dz), torch.from_numpy(dy), w_fg, wd, bd, c)
    assert tfs1.fused_stack_backward.launches == before
    _check_grads(got, want)


def test_ops_match_plain_autograd():
    """``fused_stack`` and ``fused_stack2`` (the autograd ops) against
    autograd of the plain forward written out layer by layer."""
    _, c, pack, x, dy, dz = _setup(True, 2)
    D = c.dilation_channels
    args = [torch.from_numpy(a) for a in [x] + pack]
    ref = [a.clone().requires_grad_(True) for a in args]
    xr, w_r, wd_r, add_r, bd_r = ref
    zs = []
    for l, d in enumerate(c.dilations):
        past = torch.nn.functional.pad(xr, (0, 0, d, 0))[:, :T]
        fgl = torch.cat([past, xr], -1) @ w_r[l] + add_r[l][:, None]
        zl = torch.tanh(fgl[..., :D]) * torch.sigmoid(fgl[..., D:])
        xr = xr + (zl @ wd_r[l] + bd_r[l])
        zs.append(zl)
    (torch.sum(xr * torch.from_numpy(dy))
     + torch.sum(torch.cat(zs, -1) * torch.from_numpy(dz))).backward()
    for op in (tfs1.fused_stack, tfs2.fused_stack2):
        leaves = [a.clone().requires_grad_(True) for a in args]
        y, z = op(*leaves, c)
        torch.testing.assert_close(y.detach(), xr.detach(), rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(z.detach(), torch.cat(zs, -1).detach(),
                                   rtol=1e-6, atol=1e-6)
        (torch.sum(y * torch.from_numpy(dy))
         + torch.sum(z * torch.from_numpy(dz))).backward()
        for name, a, b in zip(("x", "w_fg", "wd", "add", "bd"), leaves, ref):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5,
                                       msg=name)


@pytest.mark.parametrize("kw,v1,v2", [
    ({}, True, True),
    (dict(filter_width=3), False, False),
    (dict(dilations=(1, 512)), True, True),
    (dict(dilations=(1, 1024)), False, True),
    (dict(dilations=(1, 2048)), False, False),
    (dict(residual_channels=48, dilation_channels=48), True, False),
])
def test_supports_mirrors_jax(kw, v1, v2):
    jcfg = small_cfg(**kw)
    assert jfs1.supports(jcfg) is v1 and tfs1.supports(_tcfg(jcfg)) is v1
    assert jfs2.supports(jcfg) is v2 and tfs2.supports(_tcfg(jcfg)) is v2


def test_unsupported_device_raises():
    c = _tcfg(small_cfg())
    x = torch.empty((1, 4, 8), device="meta")
    for call in (lambda: tfs1.fused_stack_forward(x, *[None] * 4, c),
                 lambda: tfs1.fused_stack_backward(x, *[None] * 6, c),
                 lambda: tfs2.fused_stack2_forward(x, *[None] * 4, c),
                 lambda: tfs2.fused_stack2_backward(x, *[None] * 6, c)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
