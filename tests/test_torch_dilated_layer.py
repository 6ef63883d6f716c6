"""The per-layer op ``fused_dilated_layer`` (``wavenet_torch.experiments.
dilated_layer``) against the JAX package's TPU kernel pair.

On the CPU the op runs its plain forward and backward; here they are held
against ``wavenet_tpu/experiments/dilated_layer.py`` run in interpret
mode (forward, and gradients through its custom VJP), at the JAX tests'
own widths (``tests/test_dilated_layer.py``) and tolerances. Inputs are
made with numpy from a seed. The CUDA kernel itself is held against the
plain versions on the card (``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.experiments import dilated_layer as jdl
from wavenet_torch.experiments import dilated_layer as tdl

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, R, D = 2, 70, 4, 4


def _inputs(seed):
    rng = np.random.RandomState(seed)
    args = [(0.5 * rng.randn(B, T, R)).astype(np.float32),
            (0.3 * rng.randn(2, R, 2 * D)).astype(np.float32),
            (0.3 * rng.randn(D, R)).astype(np.float32),
            (0.1 * rng.randn(B, 2 * D)).astype(np.float32),
            (0.1 * rng.randn(1, R)).astype(np.float32)]
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, D).astype(np.float32)
    return args, cy, cz


# d = T: the past tap is all zero padding.
@pytest.mark.parametrize("dilation", [1, 4, T])
def test_matches_jax_op(dilation):
    args, cy, cz = _inputs(dilation)

    def loss(fn, *a):
        y, z = fn(*a, dilation)
        return jnp.sum(y * cy) + jnp.sum(z * cz)

    ja = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        y_j, z_j = jdl.fused_dilated_layer(*ja, dilation)
        g_j = jax.grad(lambda *a: loss(jdl.fused_dilated_layer, *a),
                       argnums=(0, 1, 2, 3, 4))(*ja)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    f0, b0 = tdl.forward.launches, tdl.backward.launches
    y, z = tdl.fused_dilated_layer(*leaves, dilation)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), **FWD_TOL)
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z * torch.from_numpy(cz))).backward()
    # The CPU runs the plain versions: no kernel launch is counted.
    assert (tdl.forward.launches, tdl.backward.launches) == (f0, b0)
    for name, t, g in zip(("dx", "dw", "dwd", "dadd", "dbd"), leaves, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL,
                                   err_msg=name)


def test_plain_forward_matches_jax_reference():
    args, _, _ = _inputs(5)
    for d in (1, 8, 100):
        y, z = tdl.fused_dilated_layer_reference(
            *[torch.from_numpy(a) for a in args], d)
        y_j, z_j = jdl.fused_dilated_layer_reference(
            *[jnp.asarray(a) for a in args], d)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_j), **FWD_TOL)


def test_shifts_match_jax():
    x = np.random.RandomState(6).randn(2, 9, 3).astype(np.float32)
    c = np.random.RandomState(7).randn(2, 9, 3).astype(np.float32)
    for d in (1, 4, 9):
        np.testing.assert_array_equal(
            tdl._shift_right(torch.from_numpy(x), d).numpy(),
            np.asarray(jdl._shift_right(jnp.asarray(x), d)))
        np.testing.assert_allclose(
            tdl._shift_left_add(torch.from_numpy(x), torch.from_numpy(c),
                                d).numpy(),
            np.asarray(jdl._shift_left_add(jnp.asarray(x), jnp.asarray(c),
                                           d)), rtol=0, atol=0)


def test_bf16_and_unsupported_device_raise():
    args, _, _ = _inputs(8)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(NotImplementedError, match="queue item 1"):
        tdl.fused_dilated_layer(*t, 4, compute_dtype=torch.bfloat16)
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.forward(x, None, None, None, None, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.backward(x, None, None, None, None, None, 1)
