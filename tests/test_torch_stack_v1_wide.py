"""The retired v1 stack at every width JAX's v1 takes, against the JAX
package's v1 TPU kernels (``wavenet_tpu/experiments/fused_stack.py``).

JAX's v1 checks only the filter width and the largest dilation, so it
trains at the wide (R = D = 64) and sharded (256) widths, at R != D, and
at a D its v3 records cannot pack (48, 3). The port routes v1 by width
(``v1_kernel_plan``): the carry kernel where it is built (R == D in 8,
16, 32), kernel 5's kernels elsewhere (``fused_stack_mma.cu`` at 64, the
v1 entries of ``fused_stack_tiled.cu`` at every other width). On the CPU
the same calls run the plain versions, the kernels' plain version there.
They are held against JAX's v1 kernel pair in interpret mode at 3 layers
(dilations 1, 2, 4), B2 x T150, tile 64, with inputs made by numpy from
a seed: forward from the same inputs, backward on JAX's own saved y and
fg; f32 at ``test_torch_stack_v1.py``'s tolerances, bf16 on the scale of
JAX's own bf16-to-float32 gap by ``test_torch_stack_bf16.py``'s rule for
the width (``test_torch_stack_ragged.py``'s ``bf16_rule``). The route is
a pure function of the config, held here as a table.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.experiments import fused_stack as jfs1
from wavenet_tpu.models import wavenet as jw
from wavenet_torch.experiments import fused_stack as tfs1
from wavenet_torch.kernels.stack_pack import pack_stack_weights
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_fused_stack import small_cfg
from test_torch_stack_bf16 import _bf16_ulp, _hold
from test_torch_stack_ragged import bf16_rule

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, TILE = 2, 150, 64
DILATIONS = (1, 2, 4)
NAMES = ("dx", "dw", "dwd", "dadd", "dbd")
WIDTHS = [(64, 64, False), (64, 64, True), (48, 128, False),
          (24, 48, True), (5, 3, False), (16, 8, True)]
CASES = pytest.mark.parametrize(
    "R,D,gc", WIDTHS, ids=[f"r{r}_d{d}" + ("_gc" if g else "")
                           for r, d, g in WIDTHS])
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

_JFWD = jax.jit(jfs1.fused_stack_forward, static_argnums=(5, 6, 7, 8))
_JBWD = jax.jit(jfs1.fused_stack_backward, static_argnums=(7, 8, 9))


@functools.lru_cache(maxsize=None)
def setup(R: int, D: int, gc: bool):
    """Configs, packed weights (numpy) with seeded non-zero biases, the
    stack input and the cotangents at one width."""
    jcfg = small_cfg(dilations=DILATIONS, residual_channels=R,
                     dilation_channels=D, gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None)
    seed = 100 * R + D + gc
    rng = np.random.RandomState(seed)
    jp = {k: np.asarray(v) for k, v in
          jw.init_params(jax.random.PRNGKey(seed), jcfg).items()}
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    c = TConfig(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TConfig)})
    tp = params_from_numpy(jp, "cpu")
    gc_emb = tp["gc_embedding"][torch.tensor([0, 3])] if gc else None
    pack = [t.numpy() for t in pack_stack_weights(tp, c, gc_emb, B)]
    x = (0.5 * rng.randn(B, T, R)).astype(np.float32)
    dy = rng.randn(B, T, R).astype(np.float32)
    dz = rng.randn(B, T, len(DILATIONS) * D).astype(np.float32)
    return jcfg, c, pack, x, dy, dz


@functools.lru_cache(maxsize=None)
def jax_v1(R: int, D: int, gc: bool, dtype: str):
    """JAX's v1 forward (y, fg) and its backward on its own saved tensors,
    as numpy float32, and the saved tensors themselves."""
    jcfg, _, pack, x, dy, dz = setup(R, D, gc)
    jp = [jnp.asarray(a) for a in pack]
    dt = _JDT[dtype]
    with pltpu.force_tpu_interpret_mode():
        y, fg = _JFWD(jnp.asarray(x), *jp, jcfg, dt, dt, TILE)
        w_fg, wd, _, bd = jp
        g = _JBWD(y, fg, jnp.asarray(dz), jnp.asarray(dy), w_fg, wd, bd,
                  jcfg, dt, TILE)
    f32 = [np.asarray(a.astype(jnp.float32)) for a in (y, fg)]
    return f32[0], f32[1], [np.asarray(a) for a in g]


def _cfg(c, dtype):
    return dataclasses.replace(c, compute_dtype=dtype)


@CASES
@DTYPES
def test_forward_matches_jax_v1_kernel(R, D, gc, dtype):
    """The port's v1 forward (the plain version on the CPU, no launch)
    against JAX's v1 kernel: y, the fg record and z from it."""
    _, c32, pack, x, _, _ = setup(R, D, gc)
    c = _cfg(c32, dtype)
    before = tfs1.fused_stack_forward.launches
    y, fg = tfs1.fused_stack_forward(torch.from_numpy(x),
                                     *[torch.from_numpy(a) for a in pack], c)
    assert tfs1.fused_stack_forward.launches == before
    assert fg.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    assert fg.shape == (B, T, len(DILATIONS) * 2 * D)
    y_j, fg_j, _ = jax_v1(R, D, gc, dtype)
    got = (y.numpy(), fg.float().numpy())
    if dtype == "float32":
        for name, g, w in zip(("y", "fg"), got, (y_j, fg_j)):
            np.testing.assert_allclose(g, w, **FWD_TOL, err_msg=name)
        np.testing.assert_allclose(
            tfs1._fg_to_z(fg, c).numpy(),
            np.asarray(jfs1._fg_to_z(jnp.asarray(fg_j), c)), **FWD_TOL)
        return
    rule = bf16_rule(R, D)
    y32, fg32, _ = jax_v1(R, D, gc, "float32")
    for name, g, w16, w32 in zip(("y", "fg"), got, (y_j, fg_j), (y32, fg32)):
        _hold(rule, name, g, w16, w32)
    if rule == "small":               # the records one bf16 ulp apart
        assert np.all(np.abs(got[1] - fg_j) <= _bf16_ulp(fg_j))


@CASES
@DTYPES
def test_backward_matches_jax_v1_kernel(R, D, gc, dtype):
    """The port's v1 backward on JAX's own saved y and fg record (bf16 at
    bf16), with the float32 dz that both round to bf16 on entry."""
    _, c32, pack, _, dy, dz = setup(R, D, gc)
    c = _cfg(c32, dtype)
    y_j, fg_j, want = jax_v1(R, D, gc, dtype)
    fg = torch.from_numpy(fg_j.copy())
    if dtype == "bfloat16":
        fg = fg.to(torch.bfloat16)
    w_fg, wd, _, bd = [torch.from_numpy(a) for a in pack]
    before = tfs1.fused_stack_backward.launches
    got = tfs1.fused_stack_backward(torch.from_numpy(y_j.copy()), fg,
                                    torch.from_numpy(dz),
                                    torch.from_numpy(dy), w_fg, wd, bd, c)
    assert tfs1.fused_stack_backward.launches == before
    want32 = jax_v1(R, D, gc, "float32")[2] if dtype == "bfloat16" else None
    for i, (name, g) in enumerate(zip(NAMES, got)):
        assert g.dtype == torch.float32 and g.shape == want[i].shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), want[i], **BWD_TOL,
                                       err_msg=name)
        else:
            _hold(bf16_rule(R, D), name, g.numpy(), want[i], want32[i])


ROUTES = [
    # (R, D, layers, route, pinned "stack")
    (8, 8, 5, "carry", "simt"), (16, 16, 30, "carry", "simt"),
    (32, 32, 30, "carry", "mma"), (32, 32, 300, "mma", "mma"),
    (16, 16, 257, "simt", "simt"), (64, 64, 30, "mma", "mma"),
    (128, 128, 3, "tiled", "tiled"), (256, 256, 80, "tiled", "tiled"),
    (48, 128, 3, "tiled", "tiled"), (24, 48, 3, "tiled", "tiled"),
    (5, 3, 3, "tiled", "tiled"), (16, 8, 3, "tiled", "tiled"),
    (4, 4, 3, "tiled", "tiled"), (48, 48, 3, "tiled", "tiled"),
]


@pytest.mark.parametrize("R,D,L,route,stack", ROUTES)
def test_route_by_width(R, D, L, route, stack):
    """``v1_kernel_plan`` as a table: the carry kernel where it is built
    (R == D in 8, 16, 32, at most 256 layers), else kernel 5's kernel of
    the width (mma at 64, and at 32 past 256 layers; simt at 8 and 16 past
    256 layers; tiled elsewhere, the D no TPU record packs included), in
    either compute dtype; "carry" pinned names the carry kernel, which
    raises at launch where it is not built."""
    dil = tuple((1, 2, 4, 8)[i % 4] for i in range(L))
    for dtype in ("float32", "bfloat16"):
        c = TConfig(dilations=dil, residual_channels=R, dilation_channels=D,
                    compute_dtype=dtype)
        assert tfs1.carry_supports(c) == (route == "carry")
        assert tfs1.v1_kernel_plan(c) == route
        assert tfs1.v1_kernel_plan(c, "stack") == stack
        assert tfs1.v1_kernel_plan(c, "carry") == "carry"
    with pytest.raises(ValueError, match="kernel"):
        tfs1.v1_kernel_plan(c, "tiled")
    with pytest.raises(ValueError, match="compute_dtype"):
        tfs1.v1_kernel_plan(dataclasses.replace(c, compute_dtype="float16"))
