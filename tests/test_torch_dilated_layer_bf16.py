"""The per-layer op ``fused_dilated_layer`` at ``compute_dtype=bfloat16``
against the JAX package's TPU kernel pair in its bf16 mode.

The JAX op (``wavenet_tpu/experiments/dilated_layer.py``) at
``compute_dtype=jnp.bfloat16`` rounds x itself (so the residual passes
through bf16), w and wd before the kernel, z before z @ wd; its backward
rounds dy and dz before the kernel and da before each product; products
accumulate in float32, and y, z and every gradient are float32. On the
CPU the port's op runs its plain bf16 versions, which round at the same
points; here they are held against the TPU kernels run in interpret mode,
forward and gradients through the custom VJP, at widths 8 and 16, B2 x
T70, dilations 1, 4 and T (the past tap all zero padding), with inputs
made by numpy from a seed.

Tolerance: a tenth of the JAX kernel's own bf16-versus-float32 gap on the
same inputs (the worst point of each output). Both round the same values
at the same points, so only the order of float32 sums differs. Two exact
checks besides: with wd = 0, y is bf16(x) + bd bitwise in both packages
(the residual is rounded, and nothing else enters); and dbd is the sum of
bf16(dy) bitwise, on a dy whose roundings are all of magnitude >= 2**-4,
so that every float32 partial sum is exact in any order. The CUDA kernel's
bf16 mode is held against these plain versions on the card
(``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.experiments import dilated_layer as jdl
from wavenet_torch.experiments import dilated_layer as tdl

torch.set_num_threads(1)

B, T = 2, 70
GAP_FRACTION = 0.1
NAMES = ("dx", "dw", "dwd", "dadd", "dbd")
CASES = [(W, d) for W in (8, 16) for d in (1, 4, T)]


def _inputs(W, d):
    rng = np.random.RandomState(100 * W + d)
    args = [(0.5 * rng.randn(B, T, W)).astype(np.float32),
            (0.3 * rng.randn(2, W, 2 * W)).astype(np.float32),
            (0.3 * rng.randn(W, W)).astype(np.float32),
            (0.1 * rng.randn(B, 2 * W)).astype(np.float32),
            (0.1 * rng.randn(1, W)).astype(np.float32)]
    cy = rng.randn(B, T, W).astype(np.float32)
    cz = rng.randn(B, T, W).astype(np.float32)
    return args, cy, cz


def _jax_run(args, cy, cz, d):
    """The JAX op in interpret mode at float32 and bf16: {dtype: (y, z,
    grads)}."""
    ja = [jnp.asarray(a) for a in args]
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for dt in (jnp.float32, jnp.bfloat16):
            def loss(*a, dt=dt):
                y, z = jdl.fused_dilated_layer(*a, d, dt)
                return jnp.sum(y * cy) + jnp.sum(z * cz)
            y, z = jdl.fused_dilated_layer(*ja, d, dt)
            g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ja)
            out[dt] = (np.asarray(y), np.asarray(z),
                       [np.asarray(t) for t in g])
    return out


@pytest.fixture(scope="module")
def jax_results():
    """Each case's inputs and JAX results, computed once for the module."""
    cache = {}

    def get(W, d):
        if (W, d) not in cache:
            args, cy, cz = _inputs(W, d)
            cache[(W, d)] = (args, cy, cz, _jax_run(args, cy, cz, d))
        return cache[(W, d)]
    return get


def _hold(name, got, w16, w32):
    gap = np.abs(w16 - w32).max()
    assert gap > 1e-4 * np.abs(w32).max(), name     # bf16 is in play
    err = np.abs(got - w16).max()
    assert err <= GAP_FRACTION * gap, (name, err, gap)


@pytest.mark.parametrize("W,d", CASES)
def test_forward_matches_jax_bf16_kernel(jax_results, W, d):
    args, _, _, want = jax_results(W, d)
    y, z = tdl.fused_dilated_layer(*[torch.from_numpy(a) for a in args], d,
                                   compute_dtype=torch.bfloat16)
    assert y.dtype == z.dtype == torch.float32
    for i, (name, got) in enumerate((("y", y), ("z", z))):
        _hold(name, got.detach().numpy(), want[jnp.bfloat16][i],
              want[jnp.float32][i])


@pytest.mark.parametrize("W,d", CASES)
def test_backward_matches_jax_bf16_kernel(jax_results, W, d):
    args, cy, cz, want = jax_results(W, d)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    f0, b0 = tdl.forward.launches, tdl.backward.launches
    y, z = tdl.fused_dilated_layer(*leaves, d, compute_dtype=torch.bfloat16)
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z * torch.from_numpy(cz))).backward()
    # The CPU runs the plain versions: no kernel launch is counted.
    assert (tdl.forward.launches, tdl.backward.launches) == (f0, b0)
    for name, leaf, w16, w32 in zip(NAMES, leaves, want[jnp.bfloat16][2],
                                    want[jnp.float32][2]):
        assert leaf.grad.dtype == torch.float32, name
        _hold(name, leaf.grad.numpy(), w16, w32)


@pytest.mark.parametrize("W", [8, 16])
def test_residual_is_rounded_in_both_packages(W):
    """wd = 0: y = bf16(x) + bd bitwise, in the JAX op, the port's op and
    the port's plain version; at float32 y = x + bd."""
    args, _, _ = _inputs(W, 4)
    args[2] = np.zeros_like(args[2])
    x, bd = args[0], args[4]
    want = (x.astype(jnp.bfloat16).astype(np.float32) + bd[0]).astype(
        np.float32)
    assert not np.array_equal(want, x + bd[0])       # the rounding shows
    with pltpu.force_tpu_interpret_mode():
        yj, _ = jdl.fused_dilated_layer(*[jnp.asarray(a) for a in args], 4,
                                        jnp.bfloat16)
    t = [torch.from_numpy(a) for a in args]
    yt, _ = tdl.fused_dilated_layer(*t, 4, compute_dtype=torch.bfloat16)
    yp, _ = tdl.fused_dilated_layer_reference(*t, 4,
                                              compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(yj), want)
    np.testing.assert_array_equal(yt.numpy(), want)
    np.testing.assert_array_equal(yp.numpy(), want)
    y32, _ = tdl.fused_dilated_layer(*t, 4)
    np.testing.assert_array_equal(y32.numpy(), x + bd[0])


@pytest.mark.parametrize("W", [8, 16])
def test_dbd_sums_the_rounded_dy(W):
    """dbd = sum of bf16(dy), bitwise, in both packages: dy's roundings
    are all of magnitude >= 2**-4 and below 4, so the float32 sums of
    B * T of them are exact in any order; the unrounded dy sums to
    another value."""
    args, _, cz = _inputs(W, 1)
    rng = np.random.RandomState(7)
    mag = rng.uniform(2.0 ** -4 * 1.01, 3.9, (B, T, W))
    dy = (np.sign(rng.randn(B, T, W)) * mag).astype(np.float32)
    dy16 = dy.astype(jnp.bfloat16).astype(np.float64)
    want = dy16.sum(axis=(0, 1)).astype(np.float32)[None]
    assert not np.array_equal(want, dy.astype(np.float64).sum(
        axis=(0, 1)).astype(np.float32)[None])
    ja = [jnp.asarray(a) for a in args]

    def loss(*a):
        y, z = jdl.fused_dilated_layer(*a, 1, jnp.bfloat16)
        return jnp.sum(y * dy) + jnp.sum(z * cz)
    with pltpu.force_tpu_interpret_mode():
        dbd_j = jax.grad(loss, argnums=4)(*ja)
    t = [torch.from_numpy(a) for a in args]
    got = tdl.backward(*t[:4], torch.from_numpy(dy), torch.from_numpy(cz), 1,
                       compute_dtype=torch.bfloat16)[5]
    np.testing.assert_array_equal(np.asarray(dbd_j), want)
    np.testing.assert_array_equal(got.numpy(), want)
