"""The fused stack at the widths the tiled kernel takes with ragged tiles
(R != D) against the JAX package's TPU kernel pair.

``stack_kernel_plan`` sends every width the TPU kernel takes that the mma
and simt kernels are not built for to ``csrc/fused_stack_tiled.cu`` on the
card: R == D a multiple of 128 (``test_torch_stack_tiled.py``), R != D
(here: (R, D) = (16, 8), (6, 16), (48, 128), (128, 64)) and R == D in 1,
2, 4 (``test_torch_stack_tiny.py``). On the CPU the same calls run the
plain versions (``fused_stack_forward_reference`` /
``fused_stack_backward_reference``), the kernel's plain version there.
They are held against ``wavenet_tpu.kernels.fused_stack3`` run in
interpret mode, at 3 layers (dilations 1, 2, 4), B2 x T150, 64-row
tiles, gc on at (16, 8) and off elsewhere, with inputs made by numpy from
a seed: f32 at the fused-stack tests' tolerances, bf16 on the scale of
JAX's own bf16-to-float32 gap by ``test_torch_stack_bf16.py``'s rule for
the width: its small rule (a tenth of the gap, records within one bf16
ulp) where every product sums at most 16 terms (R, D <= 8), its wide rule
(``_hold`` and, per layer on JAX's own inputs, ``_hold_layers``) where a
product sums 32 or more and the other float32 order flips bf16 roundings.

Below D = 128 the TPU kernel packs several layers into a 128-lane record;
its layers lie side by side from lane 0, so the port's fg[..., :L*2D] and
z[..., :L*D] are JAX's records' leading lanes.

Each JAX call is cached, so that the f32 and bf16 cases of one width run
the kernel once per dtype and direction.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.kernels import fused_stack3 as jfs
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.models.wavenet import embed_gc as jembed_gc
from wavenet_tpu.models.wavenet import init_params as jinit_params
from wavenet_torch.kernels import fused_stack as tfs
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_fused_stack import small_cfg
from test_torch_stack_bf16 import _bf16_ulp, _hold, _hold_layers

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
B, T = 2, 150   # several 64-row tiles of the JAX kernel, the last ragged
DILATIONS = (1, 2, 4)
NAMES = ("dx", "dw_fg", "dwd", "dadd", "dbd")
# (R, D, gc): gc at (16, 8), one add for all rows elsewhere.
CASES = pytest.mark.parametrize(
    "R,D,gc", [(16, 8, True), (6, 16, False), (48, 128, False),
               (128, 64, False)], ids=["r16_d8_gc", "r6_d16", "r48_d128",
                                       "r128_d64"])
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


def bf16_rule(R: int, D: int) -> str:
    """``test_torch_stack_bf16.py``'s rule for the width: "small" where
    every product sums at most 16 terms, else "wide"."""
    return "small" if max(R, D) <= 8 else "wide"


@functools.lru_cache(maxsize=None)
def setup(R: int, D: int, gc: bool):
    jcfg = small_cfg(dilations=DILATIONS, residual_channels=R,
                     dilation_channels=D, gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None)
    seed = 100 * R + D
    jp = {k: np.asarray(v) for k, v in
          jinit_params(jax.random.PRNGKey(seed), jcfg).items()}
    rng = np.random.RandomState(seed)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, R) * 0.5).astype(np.float32)
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, len(DILATIONS) * D).astype(np.float32)
    ids = np.array([0, 3]) if gc else None
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    jgc = None if ids is None else jembed_gc(jparams, jcfg, jnp.asarray(ids))
    jpack = jfs.pack_stack_weights(jparams, jcfg, jgc, B)
    tp = params_from_numpy(jp, "cpu")
    tgc = None if ids is None else tp["gc_embedding"][torch.as_tensor(ids)]
    c = TConfig(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TConfig)})
    tpack = tfs.pack_stack_weights(tp, c, tgc, B)
    return jcfg, c, x, cy, cz, jpack, tpack


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def jax_forward(R: int, D: int, gc: bool, dtype: str):
    """JAX's (y, fg, z) as float32, records cut to the port's lanes."""
    jcfg, c, x, _, _, jpack, _ = setup(R, D, gc)
    L, dt = c.num_layers, _JDT[dtype]
    y, fg, z = jfs.fused_stack3_forward(
        jnp.asarray(x), *jpack, jcfg, dt, dt, 64, uniform_add=not gc,
        interpret=True)
    return (np.asarray(y),
            np.asarray(fg.astype(jnp.float32))[:, :T, :L * 2 * D],
            np.asarray(z.astype(jnp.float32))[:, :T, :L * D])


@functools.lru_cache(maxsize=None)
def jax_grads(R: int, D: int, gc: bool, dtype: str):
    jcfg, c, x, cy, cz, jpack, _ = setup(R, D, gc)
    L, dt = c.num_layers, _JDT[dtype]

    def loss(x, w_fg, wd, add, bd):
        y, z = jfs.fused_stack3(x, w_fg, wd, add, bd, jcfg, dt, 64, 64,
                                not gc, True)
        return (jnp.sum(y * cy)
                + jnp.sum(z[..., :L * D].astype(jnp.float32) * cz))

    return [np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *jpack)]


def check_forward(R: int, D: int, gc: bool, dtype: str) -> None:
    """The port's forward (the plain version, on the CPU) against JAX's
    kernel at one width and dtype."""
    _, c32, x, _, _, _, tpack = setup(R, D, gc)
    c = dataclasses.replace(c32, compute_dtype=dtype)
    L = c.num_layers
    assert tfs.stack_kernel_plan(c) == "tiled"
    before = tfs.forward.launches
    y, fg, z = tfs.forward(torch.from_numpy(x), *tpack, c)
    assert tfs.forward.launches == before      # the CPU runs the plain one
    assert fg.dtype == z.dtype == tfs.record_dtype(c)
    assert fg.shape == (B, T, L * 2 * D) and z.shape == (B, T, L * D)
    got = [t.float().numpy() for t in (y, fg, z)]
    want = jax_forward(R, D, gc, dtype)
    if dtype == "float32":
        for name, g, w in zip(("y", "fg", "z"), got, want):
            np.testing.assert_allclose(g, w, **FWD_TOL, err_msg=name)
        return
    rule = bf16_rule(R, D)
    want32 = jax_forward(R, D, gc, "float32")
    for name, g, w16, w32 in zip(("y", "fg", "z"), got, want, want32):
        _hold(rule, name, g, w16, w32)
        if name != "y" and rule == "small":    # one bf16 ulp apart
            assert np.all(np.abs(g - w16) <= _bf16_ulp(w16)), name
    if rule == "wide":
        _hold_layers(c, x, tpack, *want)


def check_backward(R: int, D: int, gc: bool, dtype: str) -> None:
    """The port's VJP through the differentiable op against ``jax.grad``
    of JAX's kernel at one width and dtype."""
    _, c32, x, cy, cz, _, tpack = setup(R, D, gc)
    c = dataclasses.replace(c32, compute_dtype=dtype)
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in tpack]
    before = tfs.backward.launches
    y, z = tfs.fused_stack3(*leaves, c)
    assert z.dtype == tfs.record_dtype(c)
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z.float() * torch.from_numpy(cz))).backward()
    assert tfs.backward.launches == before
    want = jax_grads(R, D, gc, dtype)
    want32 = jax_grads(R, D, gc, "float32") if dtype == "bfloat16" else None
    for i, (name, leaf) in enumerate(zip(NAMES, leaves)):
        got = leaf.grad.numpy()
        assert leaf.grad.dtype == torch.float32, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want[i], **GRAD_TOL,
                                       err_msg=name)
        else:
            _hold(bf16_rule(R, D), name, got, want[i], want32[i])


@CASES
@DTYPES
def test_forward_matches_jax_kernel(R, D, gc, dtype):
    check_forward(R, D, gc, dtype)


@CASES
@DTYPES
def test_backward_matches_jax_grad(R, D, gc, dtype):
    check_backward(R, D, gc, dtype)


# The wide config's shape (mu-law 256, S = 1024, scalar input) cut to 3
# layers and S = 128, at R = 128, D = 64: a width only the tiled kernel
# takes, through loss_fn with use_pallas_stack.
W128_64 = dict(dilations=DILATIONS, residual_channels=128,
               dilation_channels=64, skip_channels=128,
               quantization_channels=64, use_biases=True, scalar_input=True)


def test_loss_and_grads_match_jax_at_128_64():
    jcfg = JConfig(**W128_64, use_pallas_stack=True)
    tcfg = TConfig(**W128_64, use_pallas_stack=True)
    assert tfs.stack_kernel_plan(tcfg) == "tiled"
    w = {k: np.asarray(v) for k, v in
         jw.init_params(jax.random.PRNGKey(6), jcfg).items()}
    rng = np.random.RandomState(6)
    for k in sorted(w):
        if k.endswith("_bias"):
            w[k] = (0.1 * rng.randn(*w[k].shape)).astype(np.float32)
    audio = rng.uniform(-1, 1, (2, jcfg.receptive_field + 60)).astype(
        np.float32)
    grad_fn = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True),
                      static_argnums=(1, 4))
    with pltpu.force_tpu_interpret_mode():
        (l_j, _), g_j = grad_fn({k: jnp.asarray(v) for k, v in w.items()},
                                jcfg, jnp.asarray(audio), None, 0.01)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(w, "cpu").items()}
    l_t, _ = tw.loss_fn(tp, tcfg, torch.from_numpy(audio), None, 0.01)
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    assert set(g_j) == set(tp)
    for k in g_j:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_j[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
