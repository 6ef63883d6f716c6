"""The carry kernel's plan and arithmetic (``csrc/fused_stack_carry.cu``,
behind the retired stack generations v1 and v2), on the CPU.

The kernel runs a wavefront across time tiles: ``carry_plan`` gives each
batch row ``max(1, resident // B)`` blocks, and block c of a row takes the
row's tiles c, c + nchunk, ... of its walk. These tests hold the pure plan
and the scratch layout (``carry_scratch_floats``) to that rule, and show
without a GPU that the kernel's 3xTF32 products keep the JAX kernels'
float32 parity: v1's and v2's plain versions with every product through
``kernels.fused_stack.mma3_matmul`` against
``wavenet_tpu/experiments/fused_stack{,2}.py`` in interpret mode, at the
tolerances of ``tests/test_torch_stack_v1.py``. The kernel itself is held
against the plain versions on the card (``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_torch.experiments import fused_stack as tfs1
from wavenet_torch.experiments import fused_stack2 as tfs2
from wavenet_torch.kernels.fused_stack import mma3_matmul

from test_torch_stack_v1 import (B, FWD_TOL, T, TILE, _JBWD, _JFWD,
                                 _check_grads, _close, _setup)
from test_torch_stack_v2 import _JBWD as _J2BWD
from test_torch_stack_v2 import _JFWD as _J2FWD

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

# (B, resident blocks) -> blocks a row. An H100 keeps 132 blocks of the
# backward resident (one an SM) and 264 of the forward (two).
PLANS = {(1, 132): 132, (8, 132): 16, (64, 132): 2, (131, 132): 1,
         (132, 132): 1, (133, 132): 1, (512, 132): 1,
         (1, 264): 264, (8, 264): 33, (64, 264): 4, (131, 264): 2,
         (132, 264): 2, (133, 264): 1, (512, 264): 1}


@pytest.mark.parametrize("B,resident", sorted(PLANS))
def test_carry_plan(B, resident):
    plan = tfs1.carry_plan(B, resident)
    assert plan.nchunk == PLANS[(B, resident)]
    assert plan.grid == (plan.nchunk, B)
    if plan.nchunk > 1:
        # A cooperative grid: every block resident at once, and no room
        # for another block a row.
        assert plan.nchunk * B <= resident < (plan.nchunk + 1) * B
    else:
        # B alone fills the card: one block a row, no waits.
        assert 2 * B > resident
    # Every tile of a row is owned by exactly one of the row's blocks,
    # each walking its tiles in order.
    for ntiles in (1, 3, plan.nchunk, plan.nchunk + 1, 149,
                   2 * plan.nchunk + 5):
        owned = []
        for c in range(plan.nchunk):
            mine = list(plan.tiles(c, ntiles))
            assert mine == sorted(mine)
            assert all(j % plan.nchunk == c for j in mine)
            owned += mine
        assert sorted(owned) == list(range(ntiles))


@pytest.mark.parametrize("B,resident", [(0, 132), (8, 0), (-1, 5)])
def test_carry_plan_refuses_empty_shapes(B, resident):
    with pytest.raises(ValueError, match="carry_plan"):
        tfs1.carry_plan(B, resident)


@pytest.mark.parametrize("backward,nchunk,want", [
    # 2 rows, 3 layers, R = D = 8, dilations summing to 7: 6 progress
    # counters padded to 8 floats, then 2 rings of 7 rows.
    (False, 1, 8 + 2 * 7 * 8),
    (False, 5, 8 + 2 * 7 * 8),          # the forward keeps no partials
    (True, 1, 8 + 2 * 7 * 16 + 3 * 2 * (4 * 64 + 64 + 8 + 16)),
    (True, 3, 8 + 2 * 7 * 16 + 3 * 2 * 3 * (4 * 64 + 64 + 8 + 16)),
])
def test_carry_scratch_floats(backward, nchunk, want):
    assert tfs1.carry_scratch_floats(backward, 2, 3, 8, 8, 7, nchunk) == want


def test_carry_scratch_partials_grow_with_the_grid():
    """One partial sum of (dw_fg, dwd, dbd, dadd) per (layer, row, chunk):
    the backward's scratch grows by that much per chunk; the counters are
    padded so that the rings start 16-byte aligned."""
    L, R, D, Bn, sum_d = 30, 32, 32, 8, 3069
    one = tfs1.carry_scratch_floats(True, Bn, L, R, D, sum_d, 1)
    for n in (2, 16, 33):
        got = tfs1.carry_scratch_floats(True, Bn, L, R, D, sum_d, n)
        assert got - one == (n - 1) * L * Bn * (4 * R * D + D * R + R + 2 * D)
    for b, l in ((1, 1), (3, 5), (8, 30)):
        n = tfs1.carry_scratch_floats(False, b, l, R, D, 0, 1)
        assert n % 4 == 0 and n >= b * l


def test_cpu_wrappers_ignore_a_pinned_plan():
    """On CPU tensors the wrappers run the plain versions, whatever grid
    is pinned, and launch nothing."""
    _, c, pack, x, dy, dz = _setup(True, 4)
    args = [torch.from_numpy(a) for a in [x] + pack]
    plan = tfs1.CarryPlan(3, (3, B))
    counts = (tfs1.fused_stack_forward.launches,
              tfs2.fused_stack2_forward.launches,
              tfs1.fused_stack_backward.launches,
              tfs2.fused_stack2_backward.launches)
    y, fg = tfs1.fused_stack_forward(*args, c, _plan=plan)
    want = tfs1.fused_stack_forward_reference(*args, c)
    assert torch.equal(y, want[0]) and torch.equal(fg, want[1])
    out2 = tfs2.fused_stack2_forward(*args, c, _plan=plan)
    assert torch.equal(out2[0], y) and torch.equal(out2[1], fg)
    w_fg, wd, _, bd = args[1:]
    g1 = tfs1.fused_stack_backward(y, fg, torch.from_numpy(dz),
                                   torch.from_numpy(dy), w_fg, wd, bd, c,
                                   _plan=plan)
    g2 = tfs2.fused_stack2_backward(y, torch.from_numpy(dy), fg,
                                    torch.from_numpy(dz), w_fg, wd, bd, c,
                                    _plan=plan)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert counts == (tfs1.fused_stack_forward.launches,
                      tfs2.fused_stack2_forward.launches,
                      tfs1.fused_stack_backward.launches,
                      tfs2.fused_stack2_backward.launches)


@pytest.mark.parametrize("gc", [False, True])
def test_v1_mma3_matches_jax_kernels(gc):
    """v1's plain versions with the carry kernel's 3xTF32 products against
    the v1 TPU kernels (interpret mode); the backward on the JAX kernel's
    saved tensors."""
    jcfg, c, pack, x, dy, dz = _setup(gc, 5)
    jpack = [jnp.asarray(a) for a in pack]
    tpack = [torch.from_numpy(a) for a in pack]
    with pltpu.force_tpu_interpret_mode():
        y_j, fg_j = _JFWD(jnp.asarray(x), *jpack, jcfg, jnp.float32,
                          jnp.float32, TILE)
    y, fg = tfs1.fused_stack_forward_reference(torch.from_numpy(x), *tpack,
                                               c, matmul=mma3_matmul)
    _close(y, y_j, FWD_TOL, "y")
    _close(fg, fg_j, FWD_TOL, "fg")
    w_fg, wd, _, bd = jpack
    with pltpu.force_tpu_interpret_mode():
        want = _JBWD(y_j, fg_j, jnp.asarray(dz), jnp.asarray(dy), w_fg, wd,
                     bd, jcfg, jnp.float32, TILE)
    w_fg, wd, _, bd = tpack
    got = tfs1.fused_stack_backward_reference(
        torch.from_numpy(np.asarray(y_j)), torch.from_numpy(np.asarray(fg_j)),
        torch.from_numpy(dz), torch.from_numpy(dy), w_fg, wd, bd, c,
        matmul=mma3_matmul)
    _check_grads(got, want)


@pytest.mark.parametrize("gc", [False, True])
def test_v2_mma3_matches_jax_kernels(gc):
    """v2's plain versions with the carry kernel's 3xTF32 products against
    the v2 TPU kernels (interpret mode; fg and z in 128-lane records)."""
    jcfg, c, pack, x, dy, dz = _setup(gc, 6)
    jpack = [jnp.asarray(a) for a in pack]
    tpack = [torch.from_numpy(a) for a in pack]
    y_j, fgz_j = _J2FWD(jnp.asarray(x), *jpack, jcfg, jnp.float32,
                        jnp.float32, TILE, True)
    y, fg, z = tfs2.fused_stack2_forward_reference(
        torch.from_numpy(x), *tpack, c, matmul=mma3_matmul)
    L, D = c.num_layers, c.dilation_channels
    rec = np.asarray(fgz_j).reshape(B, T, L, 128)
    _close(y, y_j, FWD_TOL, "y")
    _close(fg, rec[..., :2 * D].reshape(B, T, L * 2 * D), FWD_TOL, "fg")
    _close(z, rec[..., 2 * D:3 * D].reshape(B, T, L * D), FWD_TOL, "z")
    w_fg, wd, _, bd = jpack
    want = _J2BWD(y_j, jnp.asarray(dy), fgz_j, jnp.asarray(dz), w_fg, wd, bd,
                  jcfg, jnp.float32, TILE, True)
    w_fg, wd, _, bd = tpack
    got = tfs2.fused_stack2_backward_reference(
        torch.from_numpy(np.asarray(y_j)), torch.from_numpy(dy),
        torch.from_numpy(np.ascontiguousarray(
            rec[..., :2 * D].reshape(B, T, L * 2 * D))),
        torch.from_numpy(dz), w_fg, wd, bd, c, matmul=mma3_matmul)
    _check_grads(got, want)
