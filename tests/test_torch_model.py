"""wavenet_torch forward pass against the JAX package (CPU, float32).

Tolerance rtol 1e-4, atol 1e-5: the JAX kernel tests' own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.ops import conv as jconv
from wavenet_torch.kernels import sampler as ks
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.ops import conv as tconv
from wavenet_torch.params import params_from_numpy

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _with_biases(params, seed):
    """The numpy param dict with seeded non-zero biases: ``init_params``
    sets every bias to 0, and a trained checkpoint's are not."""
    rng = np.random.RandomState(seed)
    return {k: ((0.1 * rng.randn(*v.shape)).astype(np.float32)
                if k.endswith("_bias") else v)
            for k, v in sorted(params.items())}


def _pair(gc=False, **kw):
    d = dict(dilations=(1, 2, 4, 8, 1, 2), residual_channels=8,
             dilation_channels=6, skip_channels=16, quantization_channels=32)
    if gc:
        d.update(gc_channels=4, gc_cardinality=5)
    d.update(kw)
    jc, tc = JConfig(**d), TConfig(**d)
    npp = _with_biases({k: np.asarray(v) for k, v in
                        jw.init_params(jax.random.PRNGKey(1), jc).items()},
                       1)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    return jc, tc, jp, params_from_numpy(npp, "cpu")


def test_parity_params_have_non_zero_biases():
    jc, _, jp, tp = _pair(gc=True)
    names = [k for k in tp if k.endswith("_bias")]
    assert len(names) == 6 and jc.use_biases
    for k in names:
        assert (tp[k] != 0).all(), k
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def _gc(jp, jc, tp, tc, ids):
    if ids is None:
        return None, None
    return (jw.embed_gc(jp, jc, jnp.asarray(ids)),
            tw.embed_gc(tp, tc, torch.as_tensor(ids)))


@pytest.mark.parametrize("gc", [False, True])
@pytest.mark.parametrize("merged", [True, False])
def test_forward_codes_matches_jax(gc, merged, rng):
    jc, tc, jp, tp = _pair(gc, merged_filter_gate=merged)
    codes = rng.randint(0, 32, (2, 40))
    ids = np.array([0, 4]) if gc else None
    jg, tg = _gc(jp, jc, tp, tc, ids)
    if gc:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    ref = np.asarray(jw.forward_codes(jp, jc, jnp.asarray(codes), jg))
    got = tw.forward_codes(tp, tc, torch.as_tensor(codes), tg).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    oh = tw.one_hot(torch.as_tensor(codes), 32)
    np.testing.assert_allclose(tw.forward(tp, tc, oh, tg).numpy(), ref,
                               **TOL)
    head = tw.forward_codes(tp, tc, torch.as_tensor(codes), tg,
                            head_from=17).numpy()
    np.testing.assert_allclose(head, ref[:, 17:], **TOL)


@pytest.mark.parametrize("gc", [False, True])
def test_collect_layer_inputs_matches_jax(gc, rng):
    jc, tc, jp, tp = _pair(gc)
    codes = rng.randint(0, 32, (3, 11))
    ids = np.array([1, 2, 3]) if gc else None
    jg, tg = _gc(jp, jc, tp, tc, ids)
    keep = tuple(min(d, 11) for d in jc.dilations)
    ref = jw.forward_codes(jp, jc, jnp.asarray(codes), jg,
                           collect_layer_inputs=keep)
    got = tw.forward_codes(tp, tc, torch.as_tensor(codes), tg,
                           collect_layer_inputs=keep)
    assert len(got) == len(ref) == jc.num_layers
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_causal_conv_padded_matches_jax(rng):
    x = rng.randn(2, 13, 5).astype(np.float32)
    for fw, d in ((2, 1), (2, 4), (3, 2), (2, 20)):
        w = rng.randn(fw, 5, 7).astype(np.float32)
        ref = np.asarray(jconv.causal_conv_padded(jnp.asarray(x),
                                                  jnp.asarray(w), d))
        got = tconv.causal_conv_padded(torch.from_numpy(x),
                                       torch.from_numpy(w), d).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
    w1 = rng.randn(1, 5, 3).astype(np.float32)
    np.testing.assert_allclose(
        tconv.conv1x1(torch.from_numpy(x), torch.from_numpy(w1)).numpy(),
        np.asarray(jconv.conv1x1(jnp.asarray(x), jnp.asarray(w1))), **TOL)


def test_prefill_of_bf16_config_equals_float32(rng):
    """A config that computes in bf16 (tests/test_torch_bf16.py) prefills
    at float32, as the JAX package's ``cfg32``: its carry is bitwise the
    float32 config's."""
    _, tc, _, tp = _pair(gc=True)
    codes = torch.as_tensor(rng.randint(0, 32, (2, 20)))
    ids = torch.tensor([1, 4])
    ref = ks.prefill_carry(tp, tc, codes, ids)
    got = ks.prefill_carry(tp, TConfig(**{**tc.__dict__,
                                          "compute_dtype": "bfloat16"}),
                           codes, ids)
    assert got.t_abs == ref.t_abs
    for a, b in ((got.ring, ref.ring), (got.causal, ref.causal),
                 (got.last, ref.last)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_unported_options_raise(rng):
    # The forward and the loss take LC (tests/test_torch_lc.py,
    # tests/test_torch_lc_train.py); a stream for a model without LC
    # weights raises, as in JAX.
    _, tc, _, tp = _pair()
    audio = torch.zeros((1, tc.receptive_field + 8))
    with pytest.raises(KeyError, match="lc_filter"):
        tw.loss_fn(tp, tc, audio, lc=torch.zeros(1, audio.shape[1], 2))
    codes = torch.as_tensor(rng.randint(0, 32, (1, 8)))
    with pytest.raises(ValueError):
        tw.forward_codes(tp, TConfig(**{**tc.__dict__,
                                        "scalar_input": True}), codes)
