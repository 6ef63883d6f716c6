"""The retired stack generations v1 and v2 at ``compute_dtype="bfloat16"``
against the JAX package's TPU kernels at ``kernel_dtype = bfloat16``.

At bf16 JAX runs ``wavenet_tpu/experiments/fused_stack{,2}.py`` with bf16
weights and product operands, float32 accumulation and residual (added
as ``(x + z @ wd) + bd``) and a bf16 fg record; the backward reads dz in
bf16. The two ops differ in the z they return: v1's is float32, computed
outside the kernel from the bf16 fg record (``_fg_to_z``); v2's is the
kernel's bf16 z record, computed from the float32 fg (``_extract_z``), as
v3's is. The port's ops (on the CPU: the plain versions) are held against
them here, with inputs made by numpy from a seed.

Kernel level: ``tests/test_torch_stack_v1.py``'s config (5 layers, R = D
= 8, B2 x T150, tile 64, gc and no gc). The forward against the JAX
kernels run in interpret mode, the backward on the JAX kernels' own saved
tensors, held to ``tests/test_torch_stack_bf16.py``'s rule: a tenth of the
JAX kernel's own bf16-vs-float32 gap at the worst point, the bf16 records
within one bf16 ulp. The float32 side of the gap is JAX's v1 kernel pair at
float32 (v1 and v2 compute one map there). Measured: y within 2.4e-7
against a gap of 9.9e-3, the records equal, the gradients within 0.072 of
the gap at worst (dw, gc: 1.1e-2 against 0.155; a float32 difference in
the rebuilt layer input flips a bf16 rounding of the dw product's operand).

Model level: ``tests/test_torch_bf16.py``'s 8-layer R = D = 16 config with
gc, ``loss_fn`` and every gradient at versions 1 and 2 against JAX's,
held by that file's rule: a quarter of JAX's own bf16-vs-float32 gap (JAX
at version 2 and float32), biases 1.5 of it. One more case: the head's
weight gradients are bf16 product outputs in both packages, and where
another float32 sum order flips a bf16 rounding of a z record the head
carries the flip to one element of its gradient, by one bf16 ulp of that
element; a gradient that misses the quarter at its worst point is held to
one bf16 ulp of JAX's value at every point and a quarter of the mean gap
on average. Measured: the loss within 9.5e-7 against gaps of 2.1e-4 /
2.6e-4 (v1 / v2), every gradient but the head's within 2.4e-5 of its gap,
v2's postprocess2 gradient one bf16 ulp (6.1e-5) apart at one element
against a worst gap of 2.2e-4 (mean 6.8e-8 against 1.4e-5). And the JAX
package's own fact holds in the port: at bf16 v2's loss equals v3's (both
return the bf16 z record), v1's does not (5.2e-5 apart; JAX: 5.1e-5).
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
from wavenet_tpu.experiments import fused_stack2 as jfs2
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import train_lib as tl
from wavenet_torch.experiments import fused_stack as tfs1
from wavenet_torch.experiments import fused_stack2 as tfs2
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_torch_bf16 import BASE, BIAS_GAP_FRACTION, GAP_FRACTION, GC
from test_torch_stack_bf16 import WIDE_MAX_RATIO, WIDE_MEAN_RATIO, _bf16_ulp
from test_torch_stack_v1 import B, T, TILE, _setup

torch.set_num_threads(1)

KERNEL_GAP_FRACTION = 0.1   # of the JAX kernel's own bf16-vs-float32 gap
NAMES = ("dx", "dw", "dwd", "dadd", "dbd")
MODEL_T = 100

# The JAX kernels under jit: the cases share one compile a dtype.
_J1F = jax.jit(jfs1.fused_stack_forward, static_argnums=(5, 6, 7, 8))
_J1B = jax.jit(jfs1.fused_stack_backward, static_argnums=(7, 8, 9))
_J2F = jax.jit(jfs2.fused_stack2_forward, static_argnums=(5, 6, 7, 8, 9))
_J2B = jax.jit(jfs2.fused_stack2_backward, static_argnums=(7, 8, 9, 10))


def _np(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _t16(a) -> torch.Tensor:
    """A JAX array as a bf16 torch tensor (exact for a bf16 array)."""
    return torch.from_numpy(np.ascontiguousarray(_np(a))).to(torch.bfloat16)


@pytest.fixture(scope="module", params=[False, True], ids=["nogc", "gc"])
def kernels(request):
    """The JAX kernels' outputs at both dtypes on one seeded case: v1's
    forward and backward at float32 (the gap's other side) and bf16, v2's
    at bf16 (its fg and z records split out of the 128-lane records)."""
    jcfg, c, pack, x, dy, dz = _setup(request.param, 0)
    L, D = c.num_layers, c.dilation_channels
    jp = [jnp.asarray(a) for a in pack]
    jx, jdy, jdz = jnp.asarray(x), jnp.asarray(dy), jnp.asarray(dz)
    w_fg, wd, _, bd = jp
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            y, fg = _J1F(jx, *jp, jcfg, dt, dt, TILE)
            g = _J1B(y, fg, jdz, jdy, w_fg, wd, bd, jcfg, dt, TILE)
            out[name] = dict(y=y, fg=fg, grads=[_np(a) for a in g])
    y2, fgz = _J2F(jx, *jp, jcfg, jnp.bfloat16, jnp.bfloat16, TILE, True)
    g2 = _J2B(y2, jdy, fgz, jdz, w_fg, wd, bd, jcfg, jnp.bfloat16, TILE,
              True)
    rec = fgz.reshape(B, T, L, 128)
    out["v2"] = dict(y=y2, fg=rec[..., :2 * D].reshape(B, T, L * 2 * D),
                     z=rec[..., 2 * D:3 * D].reshape(B, T, L * D),
                     grads=[_np(a) for a in g2])
    c16 = dataclasses.replace(c, compute_dtype="bfloat16")
    tpack = [torch.from_numpy(a) for a in pack]
    return dict(c16=c16, x=torch.from_numpy(x), pack=tpack,
                dy=torch.from_numpy(dy), dz=torch.from_numpy(dz), **out)


def _hold_kernel(name, got, w16, w32):
    err, gap = np.abs(got - w16), np.abs(w16 - w32)
    assert gap.max() > 1e-3 * np.abs(w32).max(), name    # bf16 is in play
    assert err.max() <= KERNEL_GAP_FRACTION * gap.max(), (
        name, err.max(), gap.max())


def _hold_record(name, got: torch.Tensor, want):
    assert got.dtype == torch.bfloat16, name
    w = _np(want)
    assert np.all(np.abs(got.float().numpy() - w) <= _bf16_ulp(w)), name


def test_v1_forward_matches_jax_bf16_kernel(kernels):
    k = kernels
    before = tfs1.fused_stack_forward.launches
    y, fg = tfs1.fused_stack_forward(k["x"], *k["pack"], k["c16"])
    assert tfs1.fused_stack_forward.launches == before    # the plain one
    assert y.dtype == torch.float32
    _hold_kernel("y", y.numpy(), _np(k["bf16"]["y"]), _np(k["f32"]["y"]))
    _hold_record("fg", fg, k["bf16"]["fg"])


def test_v2_forward_matches_jax_bf16_kernel(kernels):
    k = kernels
    before = tfs2.fused_stack2_forward.launches
    y, fg, z = tfs2.fused_stack2_forward(k["x"], *k["pack"], k["c16"])
    assert tfs2.fused_stack2_forward.launches == before
    assert y.dtype == torch.float32
    _hold_kernel("y", y.numpy(), _np(k["v2"]["y"]), _np(k["f32"]["y"]))
    _hold_record("fg", fg, k["v2"]["fg"])
    _hold_record("z", z, k["v2"]["z"])


@pytest.mark.parametrize("version", [1, 2])
def test_backward_matches_jax_bf16_kernel(kernels, version):
    """Each version's backward on its JAX kernel's own saved y and bf16 fg
    record, with the float32 dz that JAX rounds to bf16 on entry."""
    k = kernels
    w_fg, wd, _, bd = k["pack"]
    c16 = k["c16"]
    if version == 1:
        saved = k["bf16"]
        got = tfs1.fused_stack_backward(
            torch.from_numpy(_np(saved["y"])), _t16(saved["fg"]), k["dz"],
            k["dy"], w_fg, wd, bd, c16)
    else:
        saved = k["v2"]
        got = tfs2.fused_stack2_backward(
            torch.from_numpy(_np(saved["y"])), k["dy"], _t16(saved["fg"]),
            k["dz"], w_fg, wd, bd, c16)
    for name, g, w16, w32 in zip(NAMES, got, saved["grads"],
                                 k["f32"]["grads"]):
        assert g.dtype == torch.float32 and g.shape == w16.shape, name
        _hold_kernel(name, g.numpy(), w16, w32)


def test_ops_return_each_versions_z(kernels):
    """v1's op returns z in float32 from its bf16 fg record (JAX's
    ``_fg_to_z``); v2's returns the forward's bf16 z record, which holds
    z of the float32 fg: the two differ. Both backwards read dz in bf16:
    a float32 cotangent and its bf16 rounding give equal gradients."""
    k = kernels
    c16 = k["c16"]
    _, fg = tfs1.fused_stack_forward(k["x"], *k["pack"], c16)
    y1, z1 = tfs1.fused_stack(k["x"], *k["pack"], c16)
    assert z1.dtype == torch.float32
    want = np.asarray(jfs1._fg_to_z(jnp.asarray(fg.float().numpy()),
                                    c16))
    np.testing.assert_allclose(z1.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not torch.equal(z1, z1.to(torch.bfloat16).float())   # float32
    _, _, z_rec = tfs2.fused_stack2_forward(k["x"], *k["pack"], c16)
    y2, z2 = tfs2.fused_stack2(k["x"], *k["pack"], c16)
    assert z2.dtype == torch.bfloat16 and torch.equal(z2, z_rec)
    assert torch.equal(y1, y2)
    assert not torch.equal(z1.to(torch.bfloat16), z2)

    for op in (tfs1.fused_stack, tfs2.fused_stack2):
        grads = []
        for dz in (k["dz"], k["dz"].to(torch.bfloat16).float()):
            leaves = [a.clone().requires_grad_(True)
                      for a in [k["x"]] + k["pack"]]
            y, z = op(*leaves, c16)
            (torch.sum(y * k["dy"]) + torch.sum(z.float() * dz)).backward()
            grads.append([t.grad for t in leaves])
        assert all(torch.equal(a, b) for a, b in zip(*grads)), op


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

def _model_cfgs(version: int, dtype: str):
    d = dict(BASE, **GC, compute_dtype=dtype, use_pallas_stack=True,
             pallas_stack_version=version)
    return JConfig(**d), TConfig(**d)


@pytest.fixture(scope="module")
def models():
    """``loss_fn`` and its gradients: JAX at versions 1 and 2 at bf16 and
    at version 2 at float32 (its TPU kernels in interpret mode); the port
    at versions 1, 2 and 3 at bf16 (on the CPU: the plain versions)."""
    jc, _ = _model_cfgs(2, "float32")
    jp = {k: np.asarray(v)
          for k, v in jw.init_params(jax.random.PRNGKey(0), jc).items()}
    rng = np.random.RandomState(0)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    ids = np.array([0, 2])
    n = MODEL_T + jc.receptive_field
    audio = (0.5 * np.sin(np.arange(n)[None] * np.array([[0.05], [0.11]]))
             + 0.05 * rng.randn(2, n)).astype(np.float32)
    jpp = {k: jnp.asarray(v) for k, v in jp.items()}
    out = {}
    for version, dtype in ((1, "bfloat16"), (2, "bfloat16"),
                           (2, "float32")):
        jcv, _ = _model_cfgs(version, dtype)
        with pltpu.force_tpu_interpret_mode():
            (loss, _), grads = jax.value_and_grad(
                lambda p, jcv=jcv: jw.loss_fn(p, jcv, jnp.asarray(audio),
                                              jnp.asarray(ids)),
                has_aux=True)(jpp)
        out[("jax", version, dtype)] = (
            float(loss), {k: np.asarray(v) for k, v in grads.items()})
    for version in (1, 2, 3):
        _, tc = _model_cfgs(version, "bfloat16")
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params_from_numpy(jp, "cpu").items()}
        loss, _ = tw.loss_fn(leaves, tc, torch.from_numpy(audio),
                             torch.as_tensor(ids))
        loss.backward()
        assert all(v.grad.dtype == torch.float32 for v in leaves.values())
        out[("port", version)] = (float(loss.detach()),
                                  {k: v.grad.numpy()
                                   for k, v in leaves.items()})
    return out


def _hold_model(got, j16, j32, fraction, what):
    gap = np.abs(j16 - j32).max()
    err = np.abs(got - j16).max()
    assert err <= fraction * gap, f"{what}: {err} against a gap of {gap}"


@pytest.mark.parametrize("version", [1, 2])
def test_loss_matches_jax_bf16(models, version):
    j16 = models[("jax", version, "bfloat16")][0]
    j32 = models[("jax", 2, "float32")][0]
    assert abs(j16 - j32) > 1e-5 * abs(j32)     # bf16 is in play
    _hold_model(np.float32(models[("port", version)][0]), np.float32(j16),
                np.float32(j32), GAP_FRACTION, "loss")


@pytest.mark.parametrize("version", [1, 2])
def test_weight_gradients_match_jax_bf16(models, version):
    g16 = models[("jax", version, "bfloat16")][1]
    g32 = models[("jax", 2, "float32")][1]
    port = models[("port", version)][1]
    assert set(port) == set(g16)
    for k in sorted(g32):
        if k.endswith("_bias"):
            continue
        err, gap = np.abs(port[k] - g16[k]), np.abs(g16[k] - g32[k])
        if err.max() <= GAP_FRACTION * gap.max():
            continue
        # One flipped bf16 rounding carried through the head (docstring).
        assert np.all(err <= _bf16_ulp(g16[k])), k
        assert err.mean() <= GAP_FRACTION * gap.mean(), k


@pytest.mark.parametrize("version", [1, 2])
def test_bias_gradients_match_jax_bf16(models, version):
    g16 = models[("jax", version, "bfloat16")][1]
    g32 = models[("jax", 2, "float32")][1]
    port = models[("port", version)][1]
    for k in sorted(g32):
        if k.endswith("_bias"):
            _hold_model(port[k], g16[k], g32[k], BIAS_GAP_FRACTION, k)


def test_v2_loss_equals_v3_and_v1_does_not(models):
    """The JAX package's fact, in both packages: at bf16, v2 and v3 return
    the same bf16 z record, so their losses agree to float32 rounding;
    v1's z comes from the bf16 fg record, and its loss does not."""
    l1, l2, l3 = (models[("port", v)][0] for v in (1, 2, 3))
    assert abs(l2 - l3) <= 4e-7 * abs(l3)
    assert abs(l1 - l3) > 1e-6 * abs(l3)
    j1, j2 = (models[("jax", v, "bfloat16")][0] for v in (1, 2))
    assert abs(j1 - j2) > 1e-6 * abs(j2)


@pytest.mark.parametrize("version", [1, 2])
def test_train_step_bf16_retired_stack(version):
    """Two Adam steps through ``make_train_step`` at bf16 on a retired
    stack (the plain versions on the CPU, no kernel launch): finite
    losses, float32 params."""
    c = TConfig(dilations=(1, 2, 4, 8), residual_channels=8,
                dilation_channels=8, skip_channels=16,
                quantization_channels=32, use_biases=True,
                compute_dtype="bfloat16", use_pallas_stack=True,
                pallas_stack_version=version)
    state = tl.create_train_state(0, c, tl.make_optimizer("adam", 1e-3),
                                  "cpu")
    step = tl.make_train_step(c)
    rng = np.random.RandomState(version)
    audio = torch.from_numpy(
        (0.5 * rng.uniform(-1, 1, (2, c.receptive_field + 200)))
        .astype(np.float32))
    wrappers = (tfs1.fused_stack_forward, tfs1.fused_stack_backward,
                tfs2.fused_stack2_forward, tfs2.fused_stack2_backward)
    before = [w.launches for w in wrappers]
    losses = []
    for _ in range(2):
        state, m = step(state, audio)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert all(v.dtype == torch.float32 for v in state.params.values())
    assert [w.launches for w in wrappers] == before


# The wide width (R = D = 64, 4 layers), where v1 runs kernel 5's mma
# kernel on the card: loss_fn and every gradient against JAX's v1 at
# float32 (rtol 1e-5 on the loss, the stack's gradient tolerances) and at
# bf16 by this file's model rule for the loss and the biases, the weights'
# gradients by test_torch_stack_bf16.py's wide rule (mean error within half
# the mean gap, the worst within 1.5 of the worst gap). The model rule's
# head exception (one bf16 ulp) does not hold there: the products sum 128
# terms, the other float32 order flips bf16 roundings of several fg record
# values, and the head carries each flip into its gradients by more than
# one ulp (measured: postprocess2's gradient 0.45 of the worst gap at one
# point, 0.026 of the mean gap on average; the loss 0.05 of its gap; the
# other weights within 0.07 of theirs, the biases within 0.99).
W64 = dict(BASE, dilations=(1, 2, 4, 8), residual_channels=64,
           dilation_channels=64)


@functools.lru_cache(maxsize=None)
def _w64_run(dtype: str):
    d = dict(W64, **GC, compute_dtype=dtype, use_pallas_stack=True,
             pallas_stack_version=1)
    jc, tc = JConfig(**d), TConfig(**d)
    jp = {k: np.asarray(v)
          for k, v in jw.init_params(jax.random.PRNGKey(4), jc).items()}
    rng = np.random.RandomState(4)
    for k in sorted(jp):
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    ids = np.array([1, 2])
    n = MODEL_T + jc.receptive_field
    audio = (0.5 * np.sin(np.arange(n)[None] * np.array([[0.07], [0.13]]))
             + 0.05 * rng.randn(2, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        (loss, _), grads = jax.value_and_grad(
            lambda p: jw.loss_fn(p, jc, jnp.asarray(audio), jnp.asarray(ids)),
            has_aux=True)({k: jnp.asarray(v) for k, v in jp.items()})
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in params_from_numpy(jp, "cpu").items()}
    before = tfs1.fused_stack_forward.launches
    tloss, _ = tw.loss_fn(leaves, tc, torch.from_numpy(audio),
                          torch.as_tensor(ids))
    tloss.backward()
    assert tfs1.fused_stack_forward.launches == before   # the plain one
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()},
            float(tloss.detach()), {k: v.grad.numpy()
                                    for k, v in leaves.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v1_loss_and_grads_match_jax_at_width_64(dtype):
    j_loss, j_g, t_loss, t_g = _w64_run(dtype)
    assert set(t_g) == set(j_g)
    if dtype == "float32":
        np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
        for k in sorted(j_g):
            np.testing.assert_allclose(t_g[k], j_g[k], rtol=2e-4, atol=1e-5,
                                       err_msg=k)
        return
    j32_loss, j32_g = _w64_run("float32")[:2]
    assert abs(j_loss - j32_loss) > 1e-6 * abs(j32_loss)   # bf16 in play
    _hold_model(np.float32(t_loss), np.float32(j_loss), np.float32(j32_loss),
                GAP_FRACTION, "loss")
    for k in sorted(j_g):
        if k.endswith("_bias"):
            _hold_model(t_g[k], j_g[k], j32_g[k], BIAS_GAP_FRACTION, k)
            continue
        err, gap = np.abs(t_g[k] - j_g[k]), np.abs(j_g[k] - j32_g[k])
        assert err.mean() <= WIDE_MEAN_RATIO * gap.mean(), k
        assert err.max() <= WIDE_MAX_RATIO * gap.max(), k
