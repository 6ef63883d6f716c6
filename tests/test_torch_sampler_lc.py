"""wavenet_torch generation with local conditioning against the JAX
package (CPU): the LC row of TPU kernels 1 and 2, the scan sampler, the
resumable segments, the generate CLI and the server.

The port's ``decode_reference(lc=)`` (the plain twin of the LC modes of
``sampler_cluster`` and ``sampler_decode``) is held against each TPU
kernel's LC mode on that kernel's own inputs: the JAX kernel runs in
interpret mode with ``collect_logits=True``, then the port is
teacher-forced on the codes the JAX run emitted and its logits must equal
the JAX kernel's at every step (rtol 1e-4, atol 1e-5, the JAX kernel
tests' tolerance). Kernel 1 (``_sampler_kernel``) runs as
``generate_pallas`` takes it (``prefill=False``: the whole forced prefix
in the kernel; ``prefill=True``: resumed from the parallel prefill),
kernel 2 (``_sampler_kernel_hbm_stream``) through its streamed-IO route
from a zero ring and through its resume path from a prefilled carry. B = 1
runs the JAX kernels' b1 VPU chain. Every comparison perturbs the LC
weights, the refiner and the biases from a seed (``init_params`` gives an
identity refiner and zero biases, which would hide a dropped term).
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu import sample as jsample
from wavenet_tpu.kernels import sampler as js
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import sample as tsample
from wavenet_torch.kernels import sampler as ts
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_torch_sampler.py's SMALL with three LC channels.
SMALL = dict(dilations=(1, 2, 4, 8), residual_channels=4,
             dilation_channels=4, skip_channels=8, quantization_channels=32,
             lc_channels=3)
GC = dict(gc_channels=4, gc_cardinality=4)


def _pair(gc=False, key=0, out_scale=1.0, **kw):
    """JAX and port configs and params from one numpy dict: seeded biases,
    LC weights and refiner perturbed from the seed; ``out_scale`` widens
    the logits' gaps."""
    d = dict(SMALL, **(GC if gc else {}), **kw)
    jc, tc = JConfig(**d), TConfig(**d)
    rng = np.random.RandomState(key)
    npp = {}
    for k, v in sorted(jw.init_params(jax.random.PRNGKey(key), jc).items()):
        v = np.asarray(v, np.float32)
        if k.endswith("_bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k.startswith("lc_"):
            v = (v + 0.3 * rng.randn(*v.shape)).astype(np.float32)
        if k == "postprocess2":
            v = (out_scale * v).astype(np.float32)
        npp[k] = v
    return (jc, tc, {k: jnp.asarray(v) for k, v in npp.items()},
            params_from_numpy(npp, "cpu"), npp)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _port_streams(tp, tc, lc, lc_prime, n_prime):
    """The port's (refined stream, priming rows) for JAX's ``lc`` and
    ``lc_prime``, as ``generate_cuda`` prepares them."""
    lc = tw.maybe_refine_lc(tp, tc, _t(lc))
    lp = None if lc_prime is None else tw.maybe_refine_lc(tp, tc,
                                                          _t(lc_prime))
    return lc, tsample.lc_for_prime(lc, lp, n_prime)


def _replay_sequential(tc, tp, seed_codes, gc_ids, lc, lc_prime, codes_jax,
                       logits_jax):
    """The port from a zero ring over JAX's inputs (the forced prefix, then
    JAX's sampled codes), conditioned by ``[lc_prime | lc]``; logits of
    every step against JAX's."""
    B, n_forced = seed_codes.shape
    n_total = n_forced - 1 + codes_jax.shape[1]
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    packed = ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids))
    lc_r, lc_p = _port_streams(tp, tc, lc, lc_prime, n_forced - 1)
    stream = torch.cat([lc_p, lc_r], dim=1).transpose(0, 1).contiguous()
    forced = torch.cat([_t(seed_codes, torch.int32),
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    ring, causal = ts.zero_state(tc, B)
    codes, logits = ts.decode_reference(
        packed, tc, ring, causal, forced.contiguous(), n_total, 0, seed=0,
        collect_logits=True, lc=stream)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_jax), **TOL)
    np.testing.assert_array_equal(codes[:, n_forced - 1:-1].numpy(),
                                  np.asarray(codes_jax)[:, :-1])


def _replay_prefill(tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes_jax,
                    logits_jax):
    """The port's LC prefill, then ``decode_reference(lc=)`` teacher-forced
    on JAX's decoded codes; logits of every decode step against JAX's."""
    B, n = codes_jax.shape
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    carry = ts.prefill_carry(tp, tc, _t(seed_codes, torch.int32), gids,
                             lc=lc_p)
    packed = ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids))
    forced = torch.cat([carry.last[:, None],
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    codes, logits = ts.decode_reference(
        packed, tc, carry.ring, carry.causal, forced.contiguous(), n,
        carry.t_abs, seed=0, collect_logits=True,
        lc=lc_r.transpose(0, 1).contiguous())
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_jax), **TOL)
    np.testing.assert_array_equal(codes[:, :-1].numpy(),
                                  np.asarray(codes_jax)[:, :-1])


def _case(rng, jc, B, extra, n):
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + extra))
    gc_ids = rng.randint(0, 4, (B,)) if jc.gc_enabled else None
    lc = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    lc_prime = rng.uniform(-1, 1, (B, seed_codes.shape[1] - 1, 3)).astype(
        np.float32)
    return seed_codes, gc_ids, lc, lc_prime


def _jx(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("gc", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel1_sequential_lc_matches_on_its_codes(B, gc, rng):
    """TPU kernel 1 (``_sampler_kernel``, ``generate_pallas(prefill=
    False)``): the forced prefix and the sampled steps in one launch, each
    step conditioned by its row of ``[lc_prime | lc]``."""
    jc, tc, jp, tp, _ = _pair(gc, key=B)
    seed_codes, gc_ids, lc, lc_prime = _case(rng, jc, B, 4, 7)
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=7, seed=3, batch_size=B, gc_ids=_jx(gc_ids),
        seed_codes=jnp.asarray(seed_codes), lc=jnp.asarray(lc),
        lc_prime=jnp.asarray(lc_prime), collect_logits=True, interpret=True)
    _replay_sequential(tc, tp, seed_codes, gc_ids, lc, lc_prime, codes,
                       logits)


@pytest.mark.parametrize("gc", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel2_sequential_lc_matches_on_its_codes(B, gc, rng):
    """TPU kernel 2 (``_sampler_kernel_hbm_stream``) from a zero ring, its
    LC rows streamed in double-buffered chunks
    (``generate_pallas(ring_in_hbm=True, stream_io=True)``)."""
    jc, tc, jp, tp, _ = _pair(gc, key=10 + B)
    seed_codes, gc_ids, lc, lc_prime = _case(rng, jc, B, 3, 9)
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=9, seed=4, batch_size=B, gc_ids=_jx(gc_ids),
        seed_codes=jnp.asarray(seed_codes), lc=jnp.asarray(lc),
        lc_prime=jnp.asarray(lc_prime), collect_logits=True,
        ring_in_hbm=True, stream_io=True, interpret=True)
    _replay_sequential(tc, tp, seed_codes, gc_ids, lc, lc_prime, codes,
                       logits)


@pytest.mark.parametrize("lc_prime", ["given", "held"])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel1_prefill_lc_matches_on_its_codes(B, lc_prime, rng):
    """TPU kernel 1 resumed from the LC prefill (``generate_pallas(prefill=
    True)`` at small B), with an explicit ``lc_prime`` and with the
    default (``lc[:, 0]`` held backward)."""
    jc, tc, jp, tp, _ = _pair(True, key=20 + B)
    seed_codes, gc_ids, lc, lp = _case(rng, jc, B, 5, 8)
    lp = lp if lc_prime == "given" else None
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=8, seed=3, batch_size=B,
        gc_ids=jnp.asarray(gc_ids), seed_codes=jnp.asarray(seed_codes),
        lc=jnp.asarray(lc), lc_prime=_jx(lp), collect_logits=True,
        interpret=True, prefill=True)
    lc_r, lc_p = _port_streams(tp, tc, lc, lp, seed_codes.shape[1] - 1)
    _replay_prefill(tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes, logits)


@pytest.mark.parametrize("B", [1, 3])
def test_kernel2_resumed_lc_matches_on_its_codes(B, rng):
    """TPU kernel 2 through its resume path from the JAX LC prefill, with
    ``lc_refine_width``: the refined streams go in, as ``generate_pallas``
    passes them."""
    jc, tc, jp, tp, _ = _pair(True, key=30 + B, lc_refine_width=3)
    seed_codes, gc_ids, lc, lp = _case(rng, jc, B, 6, 11)
    n = lc.shape[1]
    n_prime = seed_codes.shape[1] - 1
    lc_j = jw.maybe_refine_lc(jp, jc, jnp.asarray(lc))
    lp_j = jsample._lc_for_prime(lc_j, jw.maybe_refine_lc(
        jp, jc, jnp.asarray(lp)), n_prime)
    carry = js.prefill_carry(jp, jc, jnp.asarray(seed_codes),
                             jnp.asarray(gc_ids), lc=lp_j)
    packed = js.pack_sampler_weights(
        jp, jc, B, jw.embed_gc(jp, jc, jnp.asarray(gc_ids)))
    T_pad = -(-n // js._IO_CHUNK) * js._IO_CHUNK
    forced = jnp.zeros((T_pad, 128), jnp.int32).at[0, 0:B].set(carry.last)
    with pltpu.force_tpu_interpret_mode():
        codes, logits, _, _ = js._run_sampler_kernel_hbm_stream(
            packed, forced, jnp.asarray([5, carry.t_abs], jnp.int32),
            carry.ring, carry.causal, jc, n, 1, B, 1.0, True, resume=True,
            lc_stream=jnp.moveaxis(lc_j, 1, 0))
    lc_r, lc_p = _port_streams(tp, tc, lc, lp, n_prime)
    np.testing.assert_allclose(lc_r.numpy(), np.asarray(lc_j), **TOL)
    _replay_prefill(tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes,
                    jnp.moveaxis(logits, 0, 1))


def test_pack_sampler_weights_lc_w_matches_jax():
    jc, tc, jp, tp, _ = _pair(True)
    ids = np.array([0, 3, 1])
    jpk = js.pack_sampler_weights(jp, jc, 3,
                                  jw.embed_gc(jp, jc, jnp.asarray(ids)))
    tpk = ts.pack_sampler_weights(tp, tc, 3, tw.embed_gc(tp, tc, _t(ids)))
    assert tpk.lc_w.shape == (4, 3, 8)
    np.testing.assert_allclose(tpk.lc_w.numpy(), np.asarray(jpk.lc_w),
                               rtol=0, atol=1e-7)
    # Layouts without LC pack none.
    assert ts.pack_sampler_weights(
        tp, dataclasses.replace(tc, lc_channels=None), 3,
        tw.embed_gc(tp, tc, _t(ids))).lc_w is None


@pytest.mark.parametrize("split", ["mid", "short"])
def test_prefill_carry_with_lc_matches_jax(split, rng):
    jc, tc, jp, tp, _ = _pair(True)
    B = 2
    P = {"mid": jc.receptive_field + 2, "short": 3}[split]
    codes = rng.randint(0, 32, (B, P))
    lc = rng.uniform(-1, 1, (B, P - 1, 3)).astype(np.float32)
    ids = np.array([0, 3])
    ref = js.prefill_carry(jp, jc, jnp.asarray(codes), jnp.asarray(ids),
                           lc=jnp.asarray(lc))
    got = ts.prefill_carry(tp, tc, _t(codes, torch.int32), _t(ids),
                           lc=_t(lc))
    R = tc.residual_channels
    assert got.t_abs == ref.t_abs == P - 1
    np.testing.assert_allclose(got.ring.numpy(),
                               np.asarray(ref.ring)[:, :, :R], **TOL)
    np.testing.assert_array_equal(got.causal.numpy(), np.asarray(ref.causal))


# ---------------------------------------------------------------------------
# The scan sampler
# ---------------------------------------------------------------------------

def test_scan_prefill_state_with_lc_matches_jax(rng):
    jc, tc, jp, tp, _ = _pair(True)
    T = jc.receptive_field + 5
    codes = rng.randint(0, 32, (2, T))
    lc = rng.uniform(-1, 1, (2, T, 3)).astype(np.float32)
    gj = jw.embed_gc(jp, jc, jnp.asarray([1, 2]))
    gt = tw.embed_gc(tp, tc, torch.tensor([1, 2]))
    ref = jsample.prefill_state(jp, jc, jnp.asarray(codes), gj,
                                jnp.asarray(lc))
    got = tsample.prefill_state(tp, tc, _t(codes), gt, _t(lc))
    assert got.t == int(ref.t)
    np.testing.assert_allclose(got.layer_bufs.numpy(),
                               np.asarray(ref.layer_bufs), **TOL)
    # The sequential oracle from zero lands on the same state.
    seq = tsample.prime_state(tp, tc, tsample.init_sampler_state(tc, 2),
                              _t(codes), gt, _t(lc))
    np.testing.assert_allclose(seq.layer_bufs.numpy(),
                               got.layer_bufs.numpy(), **TOL)


def test_scan_step_with_lc_matches_jax(rng):
    jc, tc, jp, tp, _ = _pair(True)
    T = jc.receptive_field + 3
    codes = rng.randint(0, 32, (2, T))
    lc = rng.uniform(-1, 1, (2, T + 4, 3)).astype(np.float32)
    gj = jw.embed_gc(jp, jc, jnp.asarray([0, 3]))
    gt = tw.embed_gc(tp, tc, torch.tensor([0, 3]))
    sj = jsample.prefill_state(jp, jc, jnp.asarray(codes), gj,
                               jnp.asarray(lc[:, :T]))
    st = tsample.prefill_state(tp, tc, _t(codes), gt, _t(lc[:, :T]))
    xs = rng.randint(0, 32, (4, 2))
    for i in range(4):
        sj, lj = jsample.sampler_step(
            jp, jc, sj, jsample._featurize(jnp.asarray(xs[i]), jc), gj,
            lc_t=jnp.asarray(lc[:, T + i]))
        st, lt = tsample.sampler_step(
            tp, tc, st, tsample._featurize(_t(xs[i]), tc), gt,
            _t(lc[:, T + i]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("refine", [0, 3])
def test_scan_generate_with_lc_equals_jax_at_argmax(refine, rng):
    """Greedy free runs of the scan samplers with the same LC stream agree
    code for code (temperature 1e-6 makes sampling an argmax), and equal
    the port's kernel route: the fast = slow keystone with LC."""
    jc, tc, jp, tp, _ = _pair(False, key=5, out_scale=30.0,
                              lc_refine_width=refine)
    B, n = 2, 12
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field))
    lc = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    ref = jsample.generate(jp, jc, n, jax.random.PRNGKey(0), batch_size=B,
                           seed_codes=jnp.asarray(seed_codes),
                           temperature=1e-6, lc=jnp.asarray(lc))
    got = tsample.generate(tp, tc, n, torch.Generator().manual_seed(0),
                           batch_size=B, seed_codes=_t(seed_codes),
                           temperature=1e-6, lc=_t(lc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) > 1
    for prefill in (True, False):
        kern = ts.generate_cuda(tp, tc, n, 0, batch_size=B,
                                seed_codes=_t(seed_codes), temperature=1e-6,
                                lc=_t(lc), prefill=prefill)
        np.testing.assert_array_equal(kern.numpy(), np.asarray(ref))


def test_scan_generate_needs_lc_on_an_lc_config():
    _, tc, _, tp, _ = _pair()
    with pytest.raises(ValueError, match="lc_channels"):
        tsample.generate(tp, tc, 4, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="lc_channels"):
        ts.generate_cuda(tp, tc, 4, 0)


# ---------------------------------------------------------------------------
# Resumable segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("explicit_prime", [False, True])
def test_resumable_lc_segments_equal_one_run(explicit_prime, rng):
    """``generate_cuda_resumable`` with the stream sliced per segment equals
    one ``generate_cuda`` run bitwise, at any temperature (the JAX
    package's test_lc_resumable_segments_equal_one_run)."""
    _, tc, _, tp, _ = _pair(True, key=7)
    B, n = 2, 20
    seed_codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 2)))
    ids = _t([1, 2], torch.int64)
    lc = _t(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32))
    lp = (_t(rng.uniform(-1, 1, (B, seed_codes.shape[1] - 1, 3))
             .astype(np.float32)) if explicit_prime else None)
    full = ts.generate_cuda(tp, tc, n, 5, batch_size=B, gc_ids=ids,
                            seed_codes=seed_codes, lc=lc, lc_prime=lp)
    parts, carry = [], None
    for a, b in ((0, 9), (9, 13), (13, 20)):
        codes, carry = ts.generate_cuda_resumable(
            tp, tc, b - a, 5, batch_size=B, gc_ids=ids,
            seed_codes=seed_codes if carry is None else None, carry=carry,
            lc=lc[:, a:b], lc_prime=lp if carry is None else None)
        parts.append(codes)
    assert torch.equal(torch.cat(parts, dim=1), full)
    with pytest.raises(ValueError, match="lc_prime"):
        ts.generate_cuda_resumable(tp, tc, 2, 5, batch_size=B, gc_ids=ids,
                                   carry=carry, lc=lc[:, :2],
                                   lc_prime=lc[:, :1])


def test_lc_refusals():
    """LC at bf16 weights runs on every entry point (the bf16 LC modes;
    tests/test_torch_sampler_lc_bf16.py holds them against JAX); a pinned
    tiles kernel raises naming its ROADMAP step; a missing, extra or
    misshapen stream raises ValueError."""
    _, tc, _, tp, _ = _pair()
    lc = torch.zeros((2, 4, 3))
    assert ts.generate_cuda(tp, tc, 4, 0, batch_size=2, lc=lc,
                            weight_dtype=torch.bfloat16).shape == (2, 4)
    codes, _ = ts.generate_cuda_resumable(tp, tc, 4, 0, batch_size=2, lc=lc,
                                          weight_dtype=torch.bfloat16)
    assert codes.shape == (2, 4)
    pk16 = ts.pack_sampler_weights(tp, tc, 2, weight_dtype=torch.bfloat16)
    assert pk16.lc_w.dtype == torch.bfloat16
    ring, causal = ts.zero_state(tc, 2)
    x = torch.zeros((2, 1), dtype=torch.int32)
    stream = torch.zeros((4, 2, 3))
    codes, _ = ts.decode(pk16, tc, ring, causal, x, 4, 0, 0, lc=stream)
    assert codes.shape == (2, 4)
    ring, causal = ts.zero_state(tc, 2)
    pk = ts.pack_sampler_weights(tp, tc, 2)
    with pytest.raises(NotImplementedError, match="step 2c"):
        ts.decode(pk, tc, ring, causal, x, 4, 0, 0, lc=stream,
                  kernel="tiles")
    with pytest.raises(ValueError, match="lc"):
        ts.decode(pk, tc, ring, causal, x, 4, 0, 0)
    with pytest.raises(ValueError, match="lc"):
        ts.decode(pk, tc, ring, causal, x, 4, 0, 0, lc=stream[:3])
    c0 = dataclasses.replace(tc, lc_channels=None)
    with pytest.raises(ValueError, match="lc"):
        ts.decode(pk, c0, ring, causal, x, 4, 0, 0, lc=stream)
    with pytest.raises(ValueError, match="lc"):
        ts.generate_cuda(tp, tc, 4, 0, batch_size=2, lc=lc[:, :3])
    assert not ts.tile_shape(tc)


# ---------------------------------------------------------------------------
# The generate CLI, beside the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lc_model(tmp_path_factory):
    """Params JSON, a port checkpoint, a JAX checkpoint of the same LC
    weights, and an 8-frame feature file at hop 3."""
    from wavenet_tpu import train_lib as jtl
    from wavenet_torch import train_lib as ttl

    tmp = tmp_path_factory.mktemp("torch_lc_generate")
    jc, tc, _, tp, npp = _pair(True, key=11, out_scale=30.0)
    pfile = tmp / "m.json"
    pfile.write_text(json.dumps(dict(tc.to_json_dict(), sample_rate=2000,
                                     lc_channels=None)))
    tdir, jdir = tmp / "m_torch", tmp / "m_jax"
    ttl.save_checkpoint(str(tdir), ttl.train_state_from_params(
        tp, ttl.make_optimizer("adam", 1e-3)))
    state = jtl.create_train_state(jax.random.PRNGKey(0), jc,
                                   jtl.make_optimizer("adam", 1e-3))
    state = dataclasses.replace(
        state, params={k: jnp.asarray(v) for k, v in npp.items()})
    jtl.save_checkpoint(str(jdir), state)
    feats = tmp / "f.lc.npy"
    np.save(feats, np.random.RandomState(3).uniform(-2, 2, (8, 3))
            .astype(np.float32))
    bad = tmp / "bad.lc.npy"
    np.save(bad, np.zeros((8, 5), np.float32))
    return dict(pfile=str(pfile), tdir=str(tdir), jdir=str(jdir), tc=tc,
                feats=str(feats), bad=str(bad), tmp=tmp)


def _codes_of(path, Q):
    """The mu-law codes a written wav holds (nearest decoded level)."""
    from scipy.io import wavfile
    from wavenet_torch.audio import mu_law_decode_np
    levels = np.clip(mu_law_decode_np(np.arange(Q), Q), -1, 1) * 32767.0
    _, x = wavfile.read(path)
    return np.abs(x.astype(np.float64)[..., None] - levels).argmin(-1)


LC_FLAGS = ["--lc_channels", "3", "--lc_hop", "3", "--gc_channels", "4",
            "--gc_cardinality", "4", "--gc_id", "2"]
CLI_PATHS = {"fast": [], "save_every": ["--save_every", "9"],
             "slow": ["--fast_generation", "false"]}


@pytest.mark.parametrize("path", sorted(CLI_PATHS))
@pytest.mark.parametrize("upsample", ["repeat", "linear"])
def test_cli_lc_codes_equal_jax_cli(lc_model, path, upsample):
    """``--lc_file`` on the fast, ``--save_every`` and slow paths, with
    both upsampling modes: the port's codes equal the JAX CLI's at
    temperature 1e-6, at B = 2 (both seeded with ``--wav_seed``: an
    unseeded mu-law start draws a random first code, which the packages
    draw differently)."""
    from wavenet_torch.cli import generate as tgen
    from wavenet_tpu.cli import generate as jgen

    wav_seed = str(lc_model["tmp"] / "seed.wav")
    from wavenet_torch.audio import write_wav
    t = np.arange(300) / 2000.0
    write_wav(wav_seed, 0.6 * np.sin(2 * np.pi * 180.0 * t), 2000)
    common = ["--wavenet_params", lc_model["pfile"], "--samples", "24",
              "--temperature", "1e-6", "--batch_size", "2", "--seed", "3",
              "--lc_file", lc_model["feats"], "--lc_upsample", upsample,
              "--wav_seed", wav_seed] + LC_FLAGS + CLI_PATHS[path]
    out = {}
    for pkg, main, ckpt, extra in (
            ("jax", jgen.main, lc_model["jdir"], ["--compilation_cache", ""]),
            ("torch", tgen.main, lc_model["tdir"], ["--device", "cpu"])):
        wav = str(lc_model["tmp"] / f"{path}_{upsample}_{pkg}.wav")
        assert main([ckpt, "--wav_out_path", wav] + common + extra) == 0
        out[pkg] = np.stack([_codes_of(wav[:-4] + f"-{i}.wav", 32)
                             for i in range(2)])
    assert out["torch"].shape == (2, 24)
    np.testing.assert_array_equal(out["torch"], out["jax"])
    assert len(np.unique(out["torch"])) > 1


def test_cli_lc_stream_steers_and_bad_files_raise(lc_model, tmp_path):
    from wavenet_torch.cli import generate as tgen

    base = [lc_model["tdir"], "--wavenet_params", lc_model["pfile"],
            "--samples", "24", "--temperature", "1e-6", "--seed", "3",
            "--device", "cpu", "--lc_hop", "3"] + LC_FLAGS[:2] + LC_FLAGS[4:]
    runs = []
    for feats in (lc_model["feats"], str(tmp_path / "zeros.lc.npy")):
        if "zeros" in feats:
            np.save(feats, np.zeros((8, 3), np.float32))
        wav = str(tmp_path / f"{len(runs)}.wav")
        assert tgen.main(base + ["--lc_file", feats,
                                 "--wav_out_path", wav]) == 0
        runs.append(_codes_of(wav, 32))
    assert not np.array_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="channels"):
        tgen.main(base + ["--lc_file", lc_model["bad"]])
    with pytest.raises(ValueError, match="--lc_file and --lc_hop"):
        tgen.main([lc_model["tdir"], "--wavenet_params",
                   lc_model["pfile"], "--device", "cpu"] + LC_FLAGS[:2])
    wav = str(tmp_path / "bf16.wav")
    assert tgen.main(base + ["--lc_file", lc_model["feats"],
                             "--sampler_precision", "bfloat16",
                             "--wav_out_path", wav]) == 0
    assert _codes_of(wav, 32).shape == (24,)


# ---------------------------------------------------------------------------
# The server (tests/test_serve.py's LC cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lc_server(tmp_path_factory):
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService, make_handler

    tmp = tmp_path_factory.mktemp("torch_lc_serve")
    _, tc, _, tp, _ = _pair(False, key=4, out_scale=30.0)
    js_path = tmp / "m.json"
    js_path.write_text(json.dumps(dict(tc.to_json_dict(), sample_rate=2000)))
    npz = tmp / "m.npz"
    save_npz(str(npz), tp)
    service = GenerationService(str(npz), str(js_path), warm_samples=8,
                                device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_lc_hop_upsampling(lc_server):
    """Frames with ``lc_hop`` equal the same stream sent at sample rate."""
    service, url = lc_server
    assert "local conditioning" in service.sampler_name
    frames = np.random.RandomState(0).uniform(-2, 2, (6, 3)).round(3)
    s1, b1 = _post(url + "/generate", {"samples": 40, "seed": 2,
                                       "format": "codes", "temperature": 1e-6,
                                       "lc": frames.tolist(), "lc_hop": 8})
    rows = np.repeat(frames, 8, axis=0)[:40]
    s2, b2 = _post(url + "/generate", {"samples": 40, "seed": 2,
                                       "format": "codes", "temperature": 1e-6,
                                       "lc": rows.tolist()})
    assert s1 == s2 == 200
    c1 = json.loads(b1)["codes"]
    assert len(c1) == 40 and c1 == json.loads(b2)["codes"]
    # linear upsampling is another stream.
    s3, b3 = _post(url + "/generate", {"samples": 40, "seed": 2,
                                       "format": "codes", "temperature": 1e-6,
                                       "lc": frames.tolist(), "lc_hop": 8,
                                       "lc_upsample": "linear"})
    assert s3 == 200 and len(json.loads(b3)["codes"]) == 40


def test_serve_lc_changes_the_output(lc_server):
    service, url = lc_server
    outs = []
    for v in (-2.0, 2.0):
        status, body = _post(url + "/generate", {
            "samples": 32, "seed": 1, "format": "codes",
            "temperature": 1e-6, "lc": [[v, -v, v]] * 4, "lc_hop": 8})
        assert status == 200
        outs.append(json.loads(body)["codes"])
    assert outs[0] != outs[1]
    # A short stream at sample rate is edge-extended to the request.
    status, body = _post(url + "/generate", {
        "samples": 30, "seed": 1, "format": "codes", "temperature": 1e-6,
        "lc": [[2.0, -2.0, 2.0]] * 5})
    assert status == 200 and len(json.loads(body)["codes"]) == 30
    # The library call takes the sample-rate stream directly.
    wave = service.generate(30, seed=1, temperature=1e-6,
                            lc=np.tile([[2.0, -2.0, 2.0]], (30, 1)))
    assert wave.shape == (30,)


def test_serve_lc_bad_requests(lc_server):
    _, url = lc_server
    for payload in ({"samples": 16, "lc": [[[0.0]]]},
                    {"samples": 16, "lc": [[0.0, 1.0]]},
                    {"samples": 16},
                    {"samples": 16, "lc": [[0.0] * 3], "lc_hop": 4,
                     "lc_upsample": "cubic"}):
        status, body = _post(url + "/generate", payload)
        assert status == 400, payload
        assert "error" in json.loads(body)
    status, body = _post(url + "/generate_batch", {"samples": 16,
                                                   "batch": 2})
    assert status == 400 and "local conditioning" in json.loads(body)["error"]
