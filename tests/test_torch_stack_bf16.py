"""The fused stack's plain bf16 versions against the JAX package's TPU
kernel pair in its bf16 mode.

At ``compute_dtype="bfloat16"`` the JAX model runs ``fused_stack3`` with
``kernel_dtype = bfloat16``: bf16 weights and tap matrix, float32
accumulation and residual, bf16 fg and z records, and a backward that
rounds z, dx_{l+1} and da to bf16 before its products
(``wavenet_tpu/kernels/fused_stack3.py``). ``wavenet_torch.kernels.
fused_stack``'s plain versions round at the same points; here they are held
against the TPU kernels run in interpret mode on the CPU, at the JAX kernel
tests' small config (5 layers, R = D = 8) and at its layers with R = D = 16
(the tiny config's width, where the card runs ``csrc/fused_stack.cu``'s
bf16 mode), B2 x T150, gc and no gc, with inputs made by numpy from a
seed.

Tolerances: the JAX kernel's own bf16 result differs from its float32
result by ~3e-3 of max |y| and 3e-3 to 8e-3 of max |grad| on these inputs
(measured: y 9.5e-3 at max |y| 3.0; gradients 2.6e-3 to 7.5e-3 of their
max). The port's bf16 is held to a tenth of that gap, and the bf16 records
to one bf16 ulp. Measured: the two agree to float32 rounding (y within
2.4e-7, records equal, gradients within 8.1e-5 of their max), since both
round the same values at the same points and only the order of float32
sums differs. The CUDA kernel's bf16 mode is held against these plain
versions on the card (``tests/test_torch_gpu.py``).

At the wide width (R = D = 64, 4 layers, gc) the products sum 128 terms
(and at R = D = 16 32 terms, enough for the same), and the other float32
order flips a bf16 rounding in a small share of
each layer's records (layer 0's fg records too, where both start from
the same x), and every later layer carries a flip on: the port's own
plain bf16 stack summed in float64 lies about as far from itself summed
in float32 as it lies from JAX's, up to a quarter of the bf16 gap at the
worst point of y. So there (1) each layer is held on the JAX kernel's
own input to it, rebuilt from its bf16 z records, with no flip carried:
its fg and z records within 2**-5 of the layer's max |ref| at the worst
point and 1e-4 of it on average (``chip_smoke.py``'s per-layer rule: a
flip of a bf16 tap moves a small fg by more than its own ulp), and y
within the float32 forward tolerance of the rebuilt output; and (2) the
whole outputs and gradients on the scale of the bf16 gap, as the card's
tests hold two bf16 sum orders: the mean error within WIDE_MEAN_RATIO of
the mean gap, the worst within WIDE_MAX_RATIO of the worst gap.
An indexing or rounding fault lies O(1) of the values away.
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

torch.set_num_threads(1)

B, T = 2, 150   # several 64-row tiles of the JAX kernel, the last ragged
GAP_FRACTION = 0.1      # of JAX's own bf16-vs-float32 gap
WIDE_MEAN_RATIO, WIDE_MAX_RATIO = 0.5, 1.5
LAYER_MAX_RTOL, LAYER_MEAN_RTOL = 2.0 ** -5, 1e-4
NAMES = ("dx", "dw_fg", "dwd", "dadd", "dbd")


# The JAX kernel tests' small config, its layers at R = D = 16, and the
# wide width R = D = 64 with a tap of a whole 64-row tile (gc only: each
# interpret run takes seconds). From R = D = 16 (K = 32 terms a product)
# the other float32 order flips bf16 roundings too, so the wide rule holds
# there.
WIDTHS = {"small": {}, "w16": dict(residual_channels=16,
                                   dilation_channels=16),
          "w64": dict(dilations=(1, 64, 2, 33), residual_channels=64,
                      dilation_channels=64)}
CASES = pytest.mark.parametrize(
    "gc,width", [(False, "small"), (True, "small"), (False, "w16"),
                 (True, "w16"), (True, "w64")],
    ids=["False", "True", "w16", "w16_gc", "w64"])


def _setup(gc: bool, width: str = "small"):
    jcfg = small_cfg(gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None, **WIDTHS[width])
    jp = {k: np.asarray(v)
          for k, v in jinit_params(jax.random.PRNGKey(0), jcfg).items()}
    rng = np.random.RandomState(0)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, jcfg.residual_channels) * 0.5).astype(np.float32)
    ids = np.array([0, 3]) if gc else None
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    jgc = None if ids is None else jembed_gc(jparams, jcfg, jnp.asarray(ids))
    jpack = jfs.pack_stack_weights(jparams, jcfg, jgc, B)
    tp = params_from_numpy(jp, "cpu")
    tgc = None if ids is None else tp["gc_embedding"][torch.as_tensor(ids)]
    c16 = TConfig(**{**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(TConfig)},
                     "compute_dtype": "bfloat16"})
    tpack = tfs.pack_stack_weights(tp, c16, tgc, B)
    return jcfg, c16, x, jpack, tpack, rng


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (2**-7 of its power-of-two floor)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _hold(width, name, got, w16, w32):
    """The port's bf16 output against JAX's (``w16``), on the scale of
    JAX's own bf16-vs-float32 gap (``w32``): the small config's rule, or
    the wide width's (the module docstring says why)."""
    err, gap = np.abs(got - w16), np.abs(w16 - w32)
    assert gap.max() > 1e-3 * np.abs(w32).max(), name   # bf16 is in play
    if width == "small":
        assert err.max() <= GAP_FRACTION * gap.max(), name
    else:
        assert err.mean() <= WIDE_MEAN_RATIO * gap.mean(), name
        assert err.max() <= WIDE_MAX_RATIO * gap.max(), name


def _hold_layers(c, x, tpack, y16, fg16, z16):
    """Each layer of the plain bf16 forward on the JAX kernel's own input
    to it, rebuilt from JAX's bf16 z records as the kernel adds them: the
    fg and z records within LAYER_MAX_RTOL of the layer's max |ref| at the
    worst point and LAYER_MEAN_RTOL on average, y within the float32
    forward tolerance of the rebuilt output."""
    w_fg, wd, add, bd = tpack
    D = c.dilation_channels
    xl = torch.from_numpy(x)
    for l, d in enumerate(c.dilations):
        one = dataclasses.replace(c, dilations=(d,))
        _, fg, z = tfs.fused_stack_forward_reference(
            xl, w_fg[l:l + 1], wd[l:l + 1], add[l:l + 1], bd[l:l + 1], one)
        for name, got, want in (("fg", fg, fg16[..., 2 * D * l:2 * D * (l + 1)]),
                                ("z", z, z16[..., D * l:D * (l + 1)])):
            err = np.abs(got.float().numpy() - want)
            scale = np.abs(want).max()
            assert err.max() <= LAYER_MAX_RTOL * scale, (name, l)
            assert err.mean() <= LAYER_MEAN_RTOL * scale, (name, l)
        zr = torch.from_numpy(np.array(z16[..., D * l:D * (l + 1)]))
        xl = (xl + zr @ wd[l].to(torch.bfloat16).float()) + bd[l]
    np.testing.assert_allclose(xl.numpy(), y16, rtol=1e-4, atol=1e-5)


@CASES
def test_forward_matches_jax_bf16_kernel(gc, width):
    jcfg, c, x, jpack, tpack, _ = _setup(gc, width)
    L, D = c.num_layers, c.dilation_channels
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        y, fg, z = jfs.fused_stack3_forward(
            jnp.asarray(x), *jpack, jcfg, dt, dt, 64, uniform_add=not gc,
            interpret=True)
        want[dt] = (np.asarray(y),
                    np.asarray(fg.astype(jnp.float32))[:, :T, :L * 2 * D],
                    np.asarray(z.astype(jnp.float32))[:, :T, :L * D])
    y, fg, z = tfs.forward(torch.from_numpy(x), *tpack, c)
    assert y.dtype == torch.float32
    assert fg.dtype == z.dtype == torch.bfloat16
    assert fg.shape == (B, T, L * 2 * D) and z.shape == (B, T, L * D)
    for name, got, w16, w32 in zip(("y", "fg", "z"), (y, fg, z),
                                   want[jnp.bfloat16], want[jnp.float32]):
        got = got.float().numpy()
        _hold(width, name, got, w16, w32)
        if name != "y" and width == "small":   # one bf16 ulp apart
            assert np.all(np.abs(got - w16) <= _bf16_ulp(w16)), name
    if width != "small":
        _hold_layers(c, x, tpack, *want[jnp.bfloat16])


@CASES
def test_backward_matches_jax_bf16_kernel(gc, width):
    jcfg, c, x, jpack, tpack, rng = _setup(gc, width)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, L * D).astype(np.float32)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        def loss(x, w_fg, wd, add, bd, dt=dt):
            y, z = jfs.fused_stack3(x, w_fg, wd, add, bd, jcfg, dt, 64, 64,
                                    False, True)
            return (jnp.sum(y * cy)
                    + jnp.sum(z[..., :L * D].astype(jnp.float32) * cz))
        want[dt] = [np.asarray(g) for g in jax.grad(
            loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *jpack)]
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in tpack]
    y, z = tfs.fused_stack3(*leaves, c)
    assert z.dtype == torch.bfloat16
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z.float() * torch.from_numpy(cz))).backward()
    for name, leaf, w16, w32 in zip(NAMES, leaves, want[jnp.bfloat16],
                                    want[jnp.float32]):
        got = leaf.grad
        assert got.dtype == torch.float32, name
        _hold(width, name, got.numpy(), w16, w32)


def test_plain_bf16_backward_reads_the_records_in_bf16():
    """The backward reads fg and dz as bf16 records: a float32 dz is
    rounded first, as the TPU kernel's ``dz.astype(fg_dtype)``."""
    _, c, x, _, tpack, rng = _setup(True)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    y, fg, _ = tfs.fused_stack_forward_reference(torch.from_numpy(x), *tpack,
                                                 c)
    dy = torch.from_numpy(rng.randn(B, T, R).astype(np.float32))
    dz = torch.from_numpy(rng.randn(B, T, L * D).astype(np.float32))
    w_fg, wd, _, bd = tpack
    a = tfs.backward(y, dy, fg, dz, w_fg, wd, bd, c)
    b = tfs.backward(y, dy, fg, dz.to(torch.bfloat16), w_fg, wd, bd, c)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    f32 = dataclasses.replace(c, compute_dtype="float32")
    c32 = tfs.backward(y, dy, fg.float(), dz, w_fg, wd, bd, f32)
    assert not torch.equal(a[0], c32[0])   # the rounding is in play
