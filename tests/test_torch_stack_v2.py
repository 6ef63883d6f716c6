"""The retired stack generation v2 (``wavenet_torch.experiments.fused_stack2``)
against the JAX package's TPU kernels.

The port's forward and backward (on the CPU: their plain versions) are
held against ``wavenet_tpu/experiments/fused_stack2.py`` run in interpret
mode, with the backward functions called directly on the same saved
tensors; the inputs, tolerances and config are those of
``tests/test_torch_stack_v1.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.experiments import fused_stack2 as jfs2
from wavenet_torch.experiments import fused_stack2 as tfs2

from test_torch_stack_v1 import B, FWD_TOL, T, TILE, _check_grads, _close, _setup

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

# The JAX kernels under jit: the cases of a test share one compile.
_JFWD = jax.jit(jfs2.fused_stack2_forward, static_argnums=(5, 6, 7, 8, 9))
_JBWD = jax.jit(jfs2.fused_stack2_backward, static_argnums=(7, 8, 9, 10))


@pytest.mark.parametrize("gc", [False, True])
def test_v2_matches_jax_kernels(gc):
    jcfg, c, pack, x, dy, dz = _setup(gc, 1)
    assert tfs2.supports(c, TILE) and jfs2.supports(jcfg, TILE)
    jpack = [jnp.asarray(a) for a in pack]
    tpack = [torch.from_numpy(a) for a in pack]
    y_j, fgz_j = _JFWD(jnp.asarray(x), *jpack, jcfg, jnp.float32,
                       jnp.float32, TILE, True)
    y, fg, z = tfs2.fused_stack2_forward(torch.from_numpy(x), *tpack, c)
    L, D = c.num_layers, c.dilation_channels
    # The TPU kernel's 128-lane records: fg in lanes [0, 2D), z in
    # [2D, 3D) of each layer's record; the port's outputs are unpadded.
    rec = np.asarray(fgz_j).reshape(B, T, L, 128)
    _close(y, y_j, FWD_TOL, "y")
    _close(fg, rec[..., :2 * D].reshape(B, T, L * 2 * D), FWD_TOL, "fg")
    _close(z, rec[..., 2 * D:3 * D].reshape(B, T, L * D), FWD_TOL, "z")

    w_fg, wd, _, bd = jpack
    want = _JBWD(
        y_j, jnp.asarray(dy), fgz_j, jnp.asarray(dz), w_fg, wd, bd, jcfg,
        jnp.float32, TILE, True)
    w_fg, wd, _, bd = tpack
    got = tfs2.fused_stack2_backward(
        torch.from_numpy(np.asarray(y_j)), torch.from_numpy(dy),
        torch.from_numpy(np.ascontiguousarray(
            rec[..., :2 * D].reshape(B, T, L * 2 * D))),
        torch.from_numpy(dz), w_fg, wd, bd, c)
    _check_grads(got, want)
