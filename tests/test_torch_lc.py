"""wavenet_torch local conditioning against the JAX package (CPU, float32):
the model's LC projections and refinement, and ``wavenet_torch.lc``.

Mirrors tests/test_lc.py's model cases. Weights cross as numpy, with every
bias, the LC projections and the refinement's weights perturbed from a
seed (``init_params`` draws the refiner as an identity and the biases as
zeros, which would hide a dropped term). Tolerance rtol 1e-4, atol 1e-5:
the JAX kernel tests' own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import lc as jlc
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.utils import flops as jflops
from wavenet_torch import lc as tlc
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy
from wavenet_torch.utils import flops as tflops

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)

BASE = dict(dilations=(1, 2, 4, 8, 1, 2), residual_channels=8,
            dilation_channels=6, skip_channels=16, quantization_channels=32,
            lc_channels=3)


def perturbed(params, seed):
    """The numpy param dict with seeded non-zero biases and a seeded
    perturbation of the LC weights and the refiner."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(params.items()):
        v = np.asarray(v, np.float32)
        if k.endswith("_bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k.startswith("lc_"):
            v = (v + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def pair(gc=False, seed=1, **kw):
    d = dict(BASE)
    if gc:
        d.update(gc_channels=4, gc_cardinality=5)
    d.update(kw)
    jc, tc = JConfig(**d), TConfig(**d)
    npp = perturbed(jw.init_params(jax.random.PRNGKey(seed), jc), seed)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    return jc, tc, jp, params_from_numpy(npp, "cpu")


def _inputs(c, rng, B=2, T=None):
    T = T or c.receptive_field + 9
    codes = rng.randint(0, c.quantization_channels, (B, T))
    lc = rng.standard_normal((B, T, c.lc_channels)).astype(np.float32)
    return codes, lc


def test_perturbed_params_touch_every_lc_term():
    _, _, jp, tp = pair(lc_refine_width=3)
    for k in ("lc_filter", "lc_gate", "lc_up_depth", "lc_up_point",
              "lc_up_bias", "filter_bias"):
        assert (tp[k] != 0).any(), k
    # The refiner is no longer the identity of init_params.
    assert not torch.equal(tp["lc_up_point"], torch.eye(3))


@pytest.mark.parametrize("refine", [0, 3])
@pytest.mark.parametrize("gc", [False, True])
def test_init_params_keys_and_shapes_match_jax(gc, refine):
    d = dict(BASE, lc_refine_width=refine)
    if gc:
        d.update(gc_channels=4, gc_cardinality=5)
    jp = jw.init_params(jax.random.PRNGKey(0), JConfig(**d))
    tp = tw.init_params(0, TConfig(**d), device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
    if refine:
        # Both refiners start as the identity.
        for k in ("lc_up_depth", "lc_up_point", "lc_up_bias"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("gc", [False, True])
@pytest.mark.parametrize("merged", [True, False])
def test_forward_codes_with_lc_matches_jax(gc, merged, rng):
    jc, tc, jp, tp = pair(gc, merged_filter_gate=merged)
    codes, lc = _inputs(tc, rng)
    ids = np.array([1, 4]) if gc else None
    jg = None if ids is None else jw.embed_gc(jp, jc, jnp.asarray(ids))
    tg = None if ids is None else tw.embed_gc(tp, tc, torch.as_tensor(ids))
    ref = jw.forward_codes(jp, jc, jnp.asarray(codes), jg,
                           lc=jnp.asarray(lc))
    got = tw.forward_codes(tp, tc, torch.as_tensor(codes), tg,
                           lc=torch.as_tensor(lc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # The conditioning moves the logits.
    plain = tw.forward_codes(tp, tc, torch.as_tensor(codes), tg)
    assert (got - plain).abs().max() > 1e-2


def test_scalar_forward_with_lc_matches_jax(rng):
    jc, tc, jp, tp = pair(scalar_input=True, initial_filter_width=4)
    B, T = 2, tc.receptive_field + 7
    x = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
    lc = rng.standard_normal((B, T, 3)).astype(np.float32)
    ref = jw.forward(jp, jc, jnp.asarray(x), lc=jnp.asarray(lc))
    got = tw.forward(tp, tc, torch.as_tensor(x), lc=torch.as_tensor(lc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_collected_layer_inputs_with_lc_match_jax(rng):
    """The prefill's ring contents (``collect_layer_inputs``) carry the
    conditioning too."""
    jc, tc, jp, tp = pair(gc=True)
    codes, lc = _inputs(tc, rng)
    keep = tuple(min(d, codes.shape[1]) for d in tc.dilations)
    ids = np.array([0, 3])
    ref = jw.forward_codes(jp, jc, jnp.asarray(codes),
                           jw.embed_gc(jp, jc, jnp.asarray(ids)),
                           collect_layer_inputs=keep, lc=jnp.asarray(lc))
    got = tw.forward_codes(tp, tc, torch.as_tensor(codes),
                           tw.embed_gc(tp, tc, torch.as_tensor(ids)),
                           collect_layer_inputs=keep, lc=torch.as_tensor(lc))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("width", [1, 3, 9])
def test_refine_lc_matches_jax(width, rng):
    jc, tc, jp, tp = pair(lc_refine_width=width)
    lc = rng.standard_normal((2, 40, 3)).astype(np.float32)
    ref = jw.refine_lc(jp, jc, jnp.asarray(lc))
    got = tw.refine_lc(tp, tc, torch.as_tensor(lc))
    assert got.shape == (2, 40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # maybe_refine_lc: refines with a width, passes through without one.
    np.testing.assert_array_equal(
        tw.maybe_refine_lc(tp, tc, torch.as_tensor(lc)).numpy(),
        got.numpy())
    off = dataclasses.replace(tc, lc_refine_width=0)
    assert tw.maybe_refine_lc(tp, off, torch.as_tensor(lc)) is not None
    np.testing.assert_array_equal(
        tw.maybe_refine_lc(tp, off, torch.as_tensor(lc)).numpy(), lc)
    assert tw.maybe_refine_lc(tp, tc, None) is None


def test_refine_lc_is_the_identity_at_init(rng):
    c = TConfig(**dict(BASE, lc_refine_width=5))
    p = tw.init_params(0, c, device="cpu")
    lc = torch.as_tensor(rng.standard_normal((2, 30, 3)).astype(np.float32))
    torch.testing.assert_close(tw.refine_lc(p, c, lc), lc, rtol=0, atol=0)


@pytest.mark.parametrize("refine", [0, 3])
def test_predict_proba_with_lc_matches_jax(refine, rng):
    """``predict_proba`` refines the window's stream itself, as in JAX."""
    jc, tc, jp, tp = pair(gc=True, lc_refine_width=refine)
    codes, lc = _inputs(tc, rng, T=tc.receptive_field)
    ids = np.array([2, 0])
    ref = jw.predict_proba(jp, jc, jnp.asarray(codes), jnp.asarray(ids),
                           lc=jnp.asarray(lc))
    got = tw.predict_proba(tp, tc, torch.as_tensor(codes),
                           torch.as_tensor(ids), lc=torch.as_tensor(lc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)


def test_zero_lc_weights_give_the_unconditioned_logits(rng):
    """With zero projections any stream is a no-op: the logits equal the
    same weights' without LC (tests/test_lc.py's identity)."""
    _, tc, _, tp = pair(gc=True)
    tp = dict(tp, lc_filter=torch.zeros_like(tp["lc_filter"]),
              lc_gate=torch.zeros_like(tp["lc_gate"]))
    codes, lc = _inputs(tc, rng)
    ids = torch.tensor([1, 2])
    with_lc = tw.forward_codes(tp, tc, torch.as_tensor(codes),
                               tw.embed_gc(tp, tc, ids),
                               lc=torch.as_tensor(lc))
    base = {k: v for k, v in tp.items() if not k.startswith("lc_")}
    c0 = dataclasses.replace(tc, lc_channels=None)
    without = tw.forward_codes(base, c0, torch.as_tensor(codes),
                               tw.embed_gc(base, c0, ids))
    torch.testing.assert_close(with_lc, without, rtol=0, atol=1e-6)


def test_lc_takes_the_plain_stack_under_use_pallas_stack(rng):
    """LC sends the stack to the plain route even with use_pallas_stack,
    as the JAX package's ``_dilated_stack`` does, so it runs on the CPU
    and equals the plain config's result."""
    _, tc, _, tp = pair()
    codes, lc = _inputs(tc, rng)
    fused = dataclasses.replace(tc, use_pallas_stack=True)
    got = tw.forward_codes(tp, fused, torch.as_tensor(codes),
                           lc=torch.as_tensor(lc))
    ref = tw.forward_codes(tp, tc, torch.as_tensor(codes),
                           lc=torch.as_tensor(lc))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_lc_length_must_match_the_input(rng):
    _, tc, _, tp = pair()
    codes, lc = _inputs(tc, rng)
    with pytest.raises(ValueError, match="lc length"):
        tw.forward_codes(tp, tc, torch.as_tensor(codes),
                         lc=torch.as_tensor(lc[:, 1:]))


def test_lc_training_is_refused_naming_its_step(rng):
    """The call that raised before LC training was ported (step 2b) now
    returns the JAX package's loss (the gradients: test_torch_lc_train)."""
    jc, tc, jp, tp = pair()
    audio = rng.uniform(-1, 1, (2, tc.receptive_field + 8)).astype(
        np.float32)
    lc = np.zeros((2, audio.shape[1], 3), np.float32)
    got, _ = tw.loss_fn(tp, tc, torch.as_tensor(audio),
                        lc=torch.as_tensor(lc))
    want, _ = jw.loss_fn(jp, jc, jnp.asarray(audio), lc=jnp.asarray(lc))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_flops_count_lc_as_jax_does():
    from wavenet_torch.models.config import paper_config
    from wavenet_tpu.models.config import paper_config as jpaper
    tc, jc = paper_config(lc_channels=80), jpaper(lc_channels=80)
    assert (tflops.stack_macs_per_position(tc)
            == jflops.stack_macs_per_position(jc))
    assert (tflops.train_step_flops(tc, 8, 16000)
            == jflops.train_step_flops(jc, 8, 16000))
    # 80 channels into 2D = 64 pre-activations, per layer.
    assert (tflops.stack_macs_per_position(tc)
            - tflops.stack_macs_per_position(paper_config())) == 30 * 80 * 64


# ---------------------------------------------------------------------------
# wavenet_torch.lc against wavenet_tpu.lc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["repeat", "linear"])
@pytest.mark.parametrize("hop", [1, 4, 200])
def test_upsample_lc_matches_jax(mode, hop, rng):
    feats = rng.standard_normal((7, 5)).astype(np.float32)
    got = tlc.upsample_lc(feats, hop, mode)
    ref = jlc.upsample_lc(feats, hop, mode)
    assert got.shape == (7 * hop, 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tlc.upsample_lc(feats[:, 0], hop, mode),
                                  jlc.upsample_lc(feats[:, 0], hop, mode))


def test_upsample_lc_rejects_what_jax_rejects():
    for args in ((np.zeros((2, 2, 2)), 2), (np.zeros((3, 2)), 0),
                 (np.zeros((3, 2)), 2, "cubic")):
        for mod in (tlc, jlc):
            with pytest.raises(ValueError):
                mod.upsample_lc(*args)


@pytest.mark.parametrize("n", [0, 5, 12, 30])
@pytest.mark.parametrize("pad_mode", ["edge", "zero"])
def test_fit_lc_to_length_matches_jax(n, pad_mode, rng):
    lc = rng.standard_normal((12, 3)).astype(np.float32)
    np.testing.assert_array_equal(tlc.fit_lc_to_length(lc, n, pad_mode),
                                  jlc.fit_lc_to_length(lc, n, pad_mode))
    empty = np.zeros((0, 3), np.float32)
    np.testing.assert_array_equal(tlc.fit_lc_to_length(empty, n),
                                  jlc.fit_lc_to_length(empty, n))
    with pytest.raises(ValueError):
        tlc.fit_lc_to_length(lc, 20, "wrap")


def test_load_lc_sidecar_matches_jax(tmp_path, rng):
    wav = tmp_path / "p1_001.wav"
    assert tlc.load_lc_sidecar(str(wav)) is None
    assert jlc.load_lc_sidecar(str(wav)) is None
    for arr in (rng.standard_normal((9, 4)), rng.standard_normal(9)):
        np.save(tmp_path / "p1_001.lc.npy", arr)
        got = tlc.load_lc_sidecar(str(wav))
        ref = jlc.load_lc_sidecar(str(wav))
        assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, ref)
