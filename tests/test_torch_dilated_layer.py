"""The per-layer op ``fused_dilated_layer`` (``wavenet_torch.experiments.
dilated_layer``) against the JAX package's TPU kernel pair.

On the CPU the op runs its plain forward and backward; here they are held
against ``wavenet_tpu/experiments/dilated_layer.py`` run in interpret
mode (forward, and gradients through its custom VJP), at the JAX tests'
own widths (``tests/test_dilated_layer.py``) and tolerances. The plain
versions with every product through ``mma3_matmul`` (the CUDA kernel's
3xTF32 arithmetic) are held against the JAX reference within the
tolerances the card applies to the kernel, and ``layer_tiling`` (the
kernel's grid) is checked to cover every tile once. Inputs are made with
numpy from a seed. The CUDA kernel itself is held against the plain
versions on the card (``tests/test_torch_gpu.py``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.experiments import dilated_layer as jdl
from wavenet_torch.experiments import dilated_layer as tdl
from wavenet_torch.kernels.fused_stack import mma3_matmul

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, R, D = 2, 70, 4, 4
# The card's tolerances for the kernel (tests/test_torch_gpu.py,
# chip_smoke.py): another summation order, 3xTF32 products.
CARD_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
CARD_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _inputs(seed, R=R, D=D):
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
    """bf16 runs (on the CPU its plain version: float32 outputs that
    differ from the float32 op's; ``tests/test_torch_dilated_layer_bf16.py``
    holds it against JAX); a dtype the op lacks and an unsupported device
    raise."""
    args, _, _ = _inputs(8)
    t = [torch.from_numpy(a) for a in args]
    y16, z16 = tdl.fused_dilated_layer(*t, 4, compute_dtype=torch.bfloat16)
    y32, z32 = tdl.fused_dilated_layer(*t, 4)
    assert y16.dtype == z16.dtype == torch.float32
    assert torch.isfinite(y16).all() and torch.isfinite(z16).all()
    assert not torch.equal(y16, y32) and not torch.equal(z16, z32)
    with pytest.raises(ValueError, match="compute_dtype"):
        tdl.fused_dilated_layer(*t, 4, compute_dtype=torch.float16)
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.forward(x, None, None, None, None, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.backward(x, None, None, None, None, None, 1)


# T < TM, T not a multiple of TM, B above the resident blocks, one long row
# (many tiles a chunk), and the gc b8 train shape at one and two blocks an
# SM of an H100.
@pytest.mark.parametrize("B_,T_,resident", [
    (2, 70, 264), (3, 1000, 264), (300, 500, 264), (1, 150000, 132),
    (8, 19070, 264), (8, 19070, 132), (5, 128, 7),
])
def test_layer_tiling_covers_every_tile_once(B_, T_, resident):
    tl = tdl.layer_tiling(B_, T_, resident)
    ntiles = -(-T_ // tdl.TM)
    # One wave: B rows of nchunk blocks fit the resident blocks, or one
    # block a row where B alone exceeds them.
    assert tl.nchunk * B_ <= max(resident, B_)
    # The grid is the same for every row; each chunk holds at least one
    # tile, and together they hold each tile of the row once.
    tiles = [j for c in range(tl.nchunk)
             for j in range(c * tl.tiles_per_chunk,
                            min((c + 1) * tl.tiles_per_chunk, ntiles))]
    assert tiles == list(range(ntiles))
    assert all(c * tl.tiles_per_chunk < ntiles for c in range(tl.nchunk))


def test_layer_tiling_rejects_empty_shapes():
    for args in ((0, 10, 8), (1, 0, 8), (1, 10, 0)):
        with pytest.raises(ValueError, match="layer_tiling"):
            tdl.layer_tiling(*args)


# The kernel's arithmetic, emulated: forward and gradients within the
# card's tolerances of the JAX reference (HIGHEST-precision einsums, and
# jax.grad of it), at the JAX tests' width and the kernel's narrowest.
@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("dilation", [1, 4, T])
def test_mma3_arithmetic_matches_jax_reference(W, dilation):
    args, cy, cz = _inputs(10 + dilation, W, W)
    ja = [jnp.asarray(a) for a in args]
    y_j, z_j = jdl.fused_dilated_layer_reference(*ja, dilation)

    def loss(*a):
        y, z = jdl.fused_dilated_layer_reference(*a, dilation)
        return jnp.sum(y * cy) + jnp.sum(z * cz)

    g_j = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ja)
    t = [torch.from_numpy(a) for a in args]
    y, z = tdl.fused_dilated_layer_reference(*t, dilation, matmul=mma3_matmul)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **CARD_FWD_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), **CARD_FWD_TOL)
    dx_local, dpast, dw, dwd, dadd, dbd = (
        tdl.fused_dilated_layer_backward_reference(
            *t[:4], torch.from_numpy(cy), torch.from_numpy(cz), dilation,
            matmul=mma3_matmul))
    dx = tdl._shift_left_add(dx_local, dpast, dilation)
    for name, got, want in zip(("dx", "dw", "dwd", "dadd", "dbd"),
                               (dx, dw, dwd, dadd, dbd), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **CARD_GRAD_TOL, err_msg=name)


def test_stack_times_layer_refuses_the_cpu():
    """``stack_times --stack layer`` times the kernel on the card; without
    one it fails rather than time the plain versions."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "wavenet_torch.tools.stack_times", "--stack",
         "layer", "--trees", root, "--reps", "1"], capture_output=True,
        text=True, cwd=root, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "needs a CUDA GPU" in proc.stderr
