"""The per-layer op ``fused_dilated_layer`` at the widths the layer kernel
is not built for, against the JAX package's TPU kernel pair.

JAX's op (``wavenet_tpu/experiments/dilated_layer.py``) takes every R, D;
the port's layer kernel (``csrc/dilated_layer.cu``) is built for R == D
in 8, 16, 32, and ``layer_kernel_plan`` sends every other width to the
layer entries of ``csrc/fused_stack_tiled.cu``. On the CPU the same calls
run the plain versions, the kernels' plain version there. They are held
against JAX's op in interpret mode, forward and every gradient through
its custom VJP, at (R, D) = (64, 64), (48, 128), (16, 8) and (256, 256),
B2 x T70, dilations 1 and 4, with inputs made by numpy from a seed (the
weights shrunk with the fan-in above 32, as an init does): float32 at
``tests/test_torch_dilated_layer.py``'s tolerances, bf16 on the scale of
JAX's own bf16-versus-float32 gap: at (16, 8) and (64, 64) by
``tests/test_torch_dilated_layer_bf16.py``'s rule (a tenth of the gap at
the worst point), at (48, 128) and (256, 256) by
``tests/test_torch_stack_bf16.py``'s wide rule (the mean error within half
the mean gap, the worst within 1.5 of the worst gap). There the tenth does
not hold: a product of 128 to 512 terms summed in another float32 order
flips the bf16 rounding of a few z or fg values, and dwd (a sum over rows
of those z) carries each flip whole. Measured: y at (256, 256) 0.12 of
the gap, dwd at (48, 128) and (256, 256) 0.16 and 0.19, everything else
within a tenth. The route is a pure function of the widths, held here as
a table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.experiments import dilated_layer as jdl
from wavenet_torch.experiments import dilated_layer as tdl

from test_torch_dilated_layer_bf16 import _hold
from test_torch_stack_bf16 import WIDE_MAX_RATIO, WIDE_MEAN_RATIO

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 70
NAMES = ("dx", "dw", "dwd", "dadd", "dbd")
WIDTHS = ((64, 64), (48, 128), (16, 8), (256, 256))
CASES = pytest.mark.parametrize(
    "R,D,d", [(r, dd, d) for r, dd in WIDTHS for d in (1, 4)],
    ids=[f"r{r}_d{dd}_dil{d}" for r, dd in WIDTHS for d in (1, 4)])
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def setup(R: int, D: int, d: int):
    rng = np.random.RandomState(1000 * R + 10 * D + d)

    def ws(fan):
        return 0.3 * min(1.0, (32 / fan) ** 0.5)

    args = [(0.5 * rng.randn(B, T, R)).astype(np.float32),
            (ws(R) * rng.randn(2, R, 2 * D)).astype(np.float32),
            (ws(D) * rng.randn(D, R)).astype(np.float32),
            (0.1 * rng.randn(B, 2 * D)).astype(np.float32),
            (0.1 * rng.randn(1, R)).astype(np.float32)]
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, D).astype(np.float32)
    return args, cy, cz


@functools.lru_cache(maxsize=None)
def jax_op(R: int, D: int, d: int, dtype: str):
    """JAX's (y, z) and ``jax.grad`` of every input, in interpret mode."""
    args, cy, cz = setup(R, D, d)
    ja = [jnp.asarray(a) for a in args]
    dt = _DT[dtype][0]

    def loss(*a):
        y, z = jdl.fused_dilated_layer(*a, d, dt)
        return jnp.sum(y * cy) + jnp.sum(z * cz)

    with pltpu.force_tpu_interpret_mode():
        y, z = jdl.fused_dilated_layer(*ja, d, dt)
        g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ja)
    return np.asarray(y), np.asarray(z), [np.asarray(t) for t in g]


def _hold_bf16(R, D, name, got, w16, w32):
    """The layer's bf16 rule at R, D <= 64, the stack's wide rule above
    (the module docstring says why)."""
    if max(R, D) <= 64:
        _hold(name, got, w16, w32)
        return
    err, gap = np.abs(got - w16), np.abs(w16 - w32)
    assert gap.max() > 1e-4 * np.abs(w32).max(), name     # bf16 is in play
    assert err.mean() <= WIDE_MEAN_RATIO * gap.mean(), (name, err.mean(),
                                                        gap.mean())
    assert err.max() <= WIDE_MAX_RATIO * gap.max(), (name, err.max(),
                                                     gap.max())


def _port(R, D, d, dtype):
    """The port's op (the plain versions on the CPU, no launch): (y, z,
    gradients) as numpy."""
    args, cy, cz = setup(R, D, d)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    f0, b0 = tdl.forward.launches, tdl.backward.launches
    y, z = tdl.fused_dilated_layer(*leaves, d, compute_dtype=_DT[dtype][1])
    assert y.dtype == z.dtype == torch.float32
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z * torch.from_numpy(cz))).backward()
    assert (tdl.forward.launches, tdl.backward.launches) == (f0, b0)
    return (y.detach().numpy(), z.detach().numpy(),
            [t.grad.numpy() for t in leaves])


@CASES
@DTYPES
def test_forward_matches_jax_op(R, D, d, dtype):
    y, z, _ = _port(R, D, d, dtype)
    want = jax_op(R, D, d, dtype)
    for i, (name, got) in enumerate((("y", y), ("z", z))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want[i], **FWD_TOL, err_msg=name)
        else:
            _hold_bf16(R, D, name, got, want[i],
                       jax_op(R, D, d, "float32")[i])


@CASES
@DTYPES
def test_gradients_match_jax_grad(R, D, d, dtype):
    _, _, grads = _port(R, D, d, dtype)
    want = jax_op(R, D, d, dtype)[2]
    want32 = jax_op(R, D, d, "float32")[2]
    for name, got, w, w32 in zip(NAMES, grads, want, want32):
        assert got.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, w, **GRAD_TOL, err_msg=name)
        else:
            _hold_bf16(R, D, name, got, w, w32)


@pytest.mark.parametrize("R,D,want", [
    (8, 8, "layer"), (16, 16, "layer"), (32, 32, "layer"),
    (64, 64, "tiled"), (256, 256, "tiled"), (48, 128, "tiled"),
    (16, 8, "tiled"), (4, 4, "tiled"), (5, 3, "tiled")])
def test_route_by_width(R, D, want):
    """``layer_kernel_plan``: the layer kernel at R == D in 8, 16, 32 (the
    widths it is built for, ``LAYER_WIDTHS``), the tiled kernel's layer
    entries at every other width, so that no width reaches a kernel that
    lacks it."""
    assert tdl.layer_kernel_plan(R, D) == want
    assert (want == "layer") == (R == D and R in tdl.LAYER_WIDTHS)
