"""The fused-stack plain versions against the JAX package's TPU kernel pair.

``wavenet_torch.kernels.fused_stack`` (forward, backward, the autograd op)
is held against ``wavenet_tpu.kernels.fused_stack3`` run in interpret mode
on the CPU, at the JAX kernel tests' own small config (5 layers, R=D=8)
and tolerances (``tests/test_fused_stack3.py``). The same inputs, made
with numpy from a seed, go to both. The CUDA kernel itself is held
against these plain versions on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.kernels import fused_stack3 as jfs
from wavenet_tpu.models.wavenet import embed_gc as jembed_gc
from wavenet_tpu.models.wavenet import init_params as jinit_params
from wavenet_torch.kernels import fused_stack as tfs
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_fused_stack import small_cfg

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
B, T = 2, 150   # several 64-row tiles of the JAX kernel


def _tcfg(jcfg):
    return TConfig(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def _setup(gc: bool, seed: int):
    jcfg = small_cfg(gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None)
    jp = {k: np.asarray(v)
          for k, v in jinit_params(jax.random.PRNGKey(seed), jcfg).items()}
    rng = np.random.RandomState(seed)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, jcfg.residual_channels) * 0.5).astype(np.float32)
    ids = np.array([0, 3]) if gc else None
    return jcfg, jp, x, ids, rng


def _packs(jcfg, jp, ids):
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    jgc = None if ids is None else jembed_gc(jparams, jcfg, jnp.asarray(ids))
    jpack = jfs.pack_stack_weights(jparams, jcfg, jgc, B)
    tp = params_from_numpy(jp, "cpu")
    tgc = None if ids is None else tp["gc_embedding"][torch.as_tensor(ids)]
    tpack = tfs.pack_stack_weights(tp, _tcfg(jcfg), tgc, B)
    return jpack, tpack


@pytest.mark.parametrize("gc", [False, True])
def test_forward_matches_jax_kernel(gc):
    jcfg, jp, x, ids, _ = _setup(gc, 0)
    jpack, tpack = _packs(jcfg, jp, ids)
    for a, b in zip(jpack, tpack):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    y_j, fg_j, z_j = jfs.fused_stack3_forward(
        jnp.asarray(x), *jpack, jcfg, jnp.float32, jnp.float32, 64,
        uniform_add=not gc, interpret=True)
    c = _tcfg(jcfg)
    before = tfs.forward.launches
    y, fg, z = tfs.forward(torch.from_numpy(x), *tpack, c)
    assert tfs.forward.launches == before      # the CPU runs the plain one
    L, D = c.num_layers, c.dilation_channels
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    # The TPU kernel pads z and fg to 128-lane records; the port does not.
    np.testing.assert_allclose(
        z.numpy(), np.asarray(z_j)[:, :T, :L * D], **FWD_TOL)
    np.testing.assert_allclose(
        fg.numpy(), np.asarray(fg_j)[:, :T, :L * 2 * D], **FWD_TOL)
    assert z.shape == (B, T, L * D) and fg.shape == (B, T, L * 2 * D)


def test_backward_matches_jax_grad():
    jcfg, jp, x, ids, rng = _setup(True, 1)
    jpack, tpack = _packs(jcfg, jp, ids)
    c = _tcfg(jcfg)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, L * D).astype(np.float32)

    def loss(x, w_fg, wd, add, bd):
        y, z = jfs.fused_stack3(x, w_fg, wd, add, bd, jcfg, jnp.float32,
                                64, 64, False, True)
        return jnp.sum(y * cy) + jnp.sum(z[..., :L * D] * cz)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *jpack)

    args = (torch.from_numpy(x),) + tuple(tpack)
    y, fg, _ = tfs.fused_stack_forward_reference(*args, c)
    w_fg, wd, _, bd = tpack
    before = tfs.backward.launches
    got = tfs.backward(y, torch.from_numpy(cy), fg, torch.from_numpy(cz),
                       w_fg, wd, bd, c)
    assert tfs.backward.launches == before
    names = ("dx", "dw_fg", "dwd", "dadd", "dbd")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)

    # The same gradients from autograd of the plain forward, through the
    # differentiable op (which calls the explicit reverse sweep).
    leaves = [a.clone().requires_grad_(True) for a in args]
    yo, zo = tfs.fused_stack3(*leaves, c)
    torch.testing.assert_close(yo.detach(), y, rtol=0, atol=0)
    (torch.sum(yo * torch.from_numpy(cy))
     + torch.sum(zo * torch.from_numpy(cz))).backward()
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    xr, w_r, wd_r, add_r, bd_r = ref_leaves
    total = 0.0
    for l, d in enumerate(c.dilations):
        past = torch.nn.functional.pad(xr, (0, 0, d, 0))[:, :T]
        fgl = torch.cat([past, xr], -1) @ w_r[l] + add_r[l][:, None]
        zl = torch.tanh(fgl[..., :D]) * torch.sigmoid(fgl[..., D:])
        total = total + torch.sum(zl * torch.from_numpy(cz[..., D * l:
                                                              D * (l + 1)]))
        xr = xr + (zl @ wd_r[l] + bd_r[l])
    (total + torch.sum(xr * torch.from_numpy(cy))).backward()
    for name, a, b in zip(names, leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5,
                                   msg=name)
        torch.testing.assert_close(a.grad, got[names.index(name)], rtol=0,
                                   atol=0, msg=name)


@pytest.mark.parametrize("kw,want", [
    ({}, True),
    (dict(filter_width=3), False),
    (dict(dilations=(1, 2048)), False),
    (dict(residual_channels=16, dilation_channels=48), False),
    (dict(residual_channels=256, dilation_channels=256), True),
])
def test_supports_mirrors_jax(kw, want):
    jcfg = small_cfg(**kw)
    assert jfs.supports(jcfg) is want
    assert tfs.supports(_tcfg(jcfg)) is want


def test_unsupported_device_raises():
    c = _tcfg(small_cfg())
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.forward(x, None, None, None, None, c)
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.backward(x, None, None, None, None, None, None, c)
