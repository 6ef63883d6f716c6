"""wavenet_torch scoring against the JAX package (CPU): ``sample.extend_state``
and ``score.py``.

Weights are one numpy dict carried into both packages (seeded non-zero
biases). ``extend_state`` logits are held to JAX's on the same state and
window within rtol 1e-4, atol 1e-5 (the port's parity rule), the committed
states (ring, causal register, t) within atol 2e-5 at valid_len 0, a
partial v and k. ``log_likelihood`` is held to JAX's per sample within atol
1e-4 and in total within rtol 1e-5, atol 1e-3; the streaming scorer to the
one-shot one as JAX's own test holds them (rtol 1e-5, atol 1e-4), across
window boundaries and a ragged tail. The score CLI prints the JAX CLI's
JSON fields and values on the same weights.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import sample as jsample
from wavenet_tpu import score as jscore
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import sample as tsample
from wavenet_torch import score as tscore
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_ATOL = 2e-5
PER_SAMPLE_ATOL = 1e-4
TOTAL_TOL = dict(rtol=1e-5, atol=1e-3)
STREAM_TOL = dict(rtol=1e-5, atol=1e-4)

SMALL = dict(dilations=(1, 2, 4, 8, 1, 2), residual_channels=4,
             dilation_channels=4, skip_channels=8, quantization_channels=32,
             use_biases=True)
VARIANTS = {
    "mulaw": SMALL,
    "gc": dict(SMALL, gc_channels=4, gc_cardinality=4),
    "lc": dict(SMALL, lc_channels=3, lc_refine_width=3),
    "scalar": dict(SMALL, scalar_input=True, initial_filter_width=4),
}


def _pair(base, key=0):
    """JAX and port configs and params from one numpy dict."""
    jc, tc = JConfig(**base), TConfig(**base)
    rng = np.random.RandomState(key)
    npp = {}
    for k, v in sorted(jw.init_params(jax.random.PRNGKey(key), jc).items()):
        v = np.asarray(v)
        if k.endswith("_bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        npp[k] = v
    return jc, tc, {k: jnp.asarray(v) for k, v in npp.items()}, \
        params_from_numpy(npp, "cpu"), npp


def _window(c, rng, B, T):
    if c.scalar_input:
        return rng.uniform(-1, 1, (B, T)).astype(np.float32)
    return rng.randint(0, c.quantization_channels, (B, T)).astype(np.int32)


def _gc(c, B):
    if not c.gc_enabled:
        return None, None
    ids = np.arange(B) % c.gc_cardinality
    return ids, ids


def _close_state(got, ref):
    assert got.t == int(ref.t)
    np.testing.assert_allclose(got.layer_bufs.numpy(),
                               np.asarray(ref.layer_bufs), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(got.causal_buf.numpy(),
                               np.asarray(ref.causal_buf), rtol=0,
                               atol=STATE_ATOL)


# ---------------------------------------------------------------------------
# extend_state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_extend_state_matches_jax(variant, rng):
    """From a prefilled state, a k-window: logits against JAX's and
    against k ``sampler_step`` calls of the port; committed states at
    v = 0, a partial v and k against JAX's; the input state unchanged."""
    jc, tc, jp, tp, _ = _pair(VARIANTS[variant], key=3)
    B, T, k = 2, tc.receptive_field + 5, 7
    prefix, win = _window(tc, rng, B, T), _window(tc, rng, B, k)
    gj = gt = None
    if tc.gc_enabled:
        ids = np.array([1, 3])
        gj = jw.embed_gc(jp, jc, jnp.asarray(ids))
        gt = tsample.embed_gc(tp, tc, torch.as_tensor(ids))
    lc_p = lc_w = lcj_w = None
    if tc.lc_enabled:
        lc_all = rng.randn(B, T + k, tc.lc_channels).astype(np.float32)
        lc_p, lc_w = lc_all[:, :T], lc_all[:, T:]
        lcj_w = jnp.asarray(lc_w)
    js0 = jsample.prefill_state(jp, jc, jnp.asarray(prefix), gj,
                                None if lc_p is None else jnp.asarray(lc_p))
    ts0 = tsample.prefill_state(tp, tc, torch.as_tensor(prefix), gt,
                                None if lc_p is None
                                else torch.as_tensor(lc_p))
    ring0 = ts0.layer_bufs.clone()
    for v in (0, 3, k):
        lj, sj = jsample.extend_state(jp, jc, js0, jnp.asarray(win), gj,
                                      valid_len=v, lc=lcj_w)
        lt, st = tsample.extend_state(
            tp, tc, ts0, torch.as_tensor(win), gt, valid_len=v,
            lc=None if lc_w is None else torch.as_tensor(lc_w))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _close_state(st, sj)
        assert torch.equal(ts0.layer_bufs, ring0)   # not written

    # Against the sequential steps of the port (in place on a copy).
    st = ts0._replace(layer_bufs=ts0.layer_bufs.clone())
    seq = []
    for j in range(k):
        st, lg = tsample.sampler_step(
            tp, tc, st, tsample._featurize(torch.as_tensor(win[:, j]), tc),
            gt, None if lc_w is None else torch.as_tensor(lc_w[:, j]))
        seq.append(lg)
    lt, ext = tsample.extend_state(
        tp, tc, ts0, torch.as_tensor(win), gt,
        lc=None if lc_w is None else torch.as_tensor(lc_w))
    np.testing.assert_allclose(lt.numpy(), torch.stack(seq, 1).numpy(),
                               **LOGIT_TOL)
    assert ext.t == st.t
    np.testing.assert_allclose(ext.layer_bufs.numpy(), st.layer_bufs.numpy(),
                               rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(ext.causal_buf.numpy(), st.causal_buf.numpy(),
                               rtol=0, atol=STATE_ATOL)


def test_extend_state_chained_windows_and_collected_inputs(rng):
    """Windows chained from a zero state equal the sequential steps, and
    ``collect_layer_inputs`` returns JAX's per-layer inputs."""
    jc, tc, jp, tp, _ = _pair(VARIANTS["mulaw"], key=5)
    B = 1
    codes = _window(tc, rng, B, 40)
    st = tsample.init_sampler_state(tc, B)
    parts = []
    for a, b in ((0, 13), (13, 14), (14, 40)):
        lg, st = tsample.extend_state(tp, tc, st,
                                      torch.as_tensor(codes[:, a:b]))
        parts.append(lg)
    ref = jsample.prime_state(jp, jc, jsample.init_sampler_state(jc, B),
                              jnp.asarray(codes))
    _close_state(st, ref)
    full = jw.forward_codes(jp, jc, jnp.asarray(codes))
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(),
                               np.asarray(full), **LOGIT_TOL)

    js, ts = jsample.init_sampler_state(jc, B), tsample.init_sampler_state(
        tc, B)
    for j in range(5):
        x = codes[:, j]
        js, lj, xj = jsample.sampler_step(
            jp, jc, js, jsample._featurize(jnp.asarray(x), jc),
            collect_layer_inputs=True)
        ts, lt, xt = tsample.sampler_step(
            tp, tc, ts, tsample._featurize(torch.as_tensor(x), tc),
            collect_layer_inputs=True)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=STATE_ATOL)


def test_extend_state_rejects_wide_filters():
    tc = TConfig(**dict(SMALL, filter_width=3))
    from wavenet_torch.models.wavenet import init_params
    tp = init_params(0, tc, device="cpu")
    with pytest.raises(NotImplementedError):
        tsample.extend_state(tp, tc, tsample.init_sampler_state(tc, 1),
                             torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# log_likelihood, one-shot and streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["pallas_stack"])
def test_log_likelihood_matches_jax(variant, rng):
    """The one-shot scorer against JAX's; at ``use_pallas_stack`` the port
    routes the forward through the fused stack (its plain version on the
    CPU) and is held to JAX's plain forward."""
    base = VARIANTS["gc" if variant == "pallas_stack" else variant]
    jc, tc, jp, tp, _ = _pair(base, key=7)
    if variant == "pallas_stack":
        tc = dataclasses.replace(tc, use_pallas_stack=True)
    B, T = 2, 150
    audio = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    ids = np.array([1, 2]) if tc.gc_enabled else None
    lc = (rng.randn(B, T, tc.lc_channels).astype(np.float32)
          if tc.lc_enabled else None)
    ref = jscore.log_likelihood(
        jp, jc, jnp.asarray(audio),
        None if ids is None else jnp.asarray(ids),
        lc=None if lc is None else jnp.asarray(lc))
    got = tscore.log_likelihood(
        tp, tc, torch.as_tensor(audio),
        None if ids is None else torch.as_tensor(ids),
        lc=None if lc is None else torch.as_tensor(lc))
    assert got["logp_per_sample"].shape == (B, T - 1)
    assert bool((got["logp_per_sample"] <= 0).all())
    np.testing.assert_allclose(got["logp_per_sample"].numpy(),
                               np.asarray(ref["logp_per_sample"]), rtol=0,
                               atol=PER_SAMPLE_ATOL)
    for key in ("total_logp", "bits_per_sample"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   **TOTAL_TOL)
    # The last position agrees with predict_proba.
    from wavenet_torch.audio import mu_law_encode
    from wavenet_torch.models.wavenet import predict_proba
    enc = mu_law_encode(torch.as_tensor(audio), tc.quantization_channels)
    win = torch.as_tensor(audio[:, :-1]) if tc.scalar_input else enc[:, :-1]
    p = predict_proba(tp, tc, win,
                      None if ids is None else torch.as_tensor(ids),
                      lc=None if lc is None
                      else torch.as_tensor(lc[:, 1:]))
    want = torch.log(p[torch.arange(B), enc[:, -1].long()])
    np.testing.assert_allclose(got["logp_per_sample"][:, -1].numpy(),
                               want.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant,chunk", [("gc", 64), ("lc", 50),
                                           ("mulaw", 1000)])
def test_streaming_matches_one_shot_and_jax(variant, chunk, rng):
    """Streaming windows (several, a ragged tail; or one) against the
    port's one-shot scorer and JAX's streaming scorer."""
    jc, tc, jp, tp, _ = _pair(VARIANTS[variant], key=9)
    B, T = 2, 301
    audio = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    ids = np.array([1, 3]) if tc.gc_enabled else None
    lc = (rng.randn(B, T, tc.lc_channels).astype(np.float32)
          if tc.lc_enabled else None)
    targs = (torch.as_tensor(audio),
             None if ids is None else torch.as_tensor(ids))
    tlc = None if lc is None else torch.as_tensor(lc)
    one = tscore.log_likelihood(tp, tc, *targs, lc=tlc)
    got = tscore.log_likelihood_streaming(tp, tc, *targs, chunk=chunk,
                                          lc=tlc)
    for key in ("total_logp", "bits_per_sample"):
        np.testing.assert_allclose(got[key].numpy(), one[key].numpy(),
                                   **STREAM_TOL)
    ref = jscore.log_likelihood_streaming(
        jp, jc, jnp.asarray(audio),
        None if ids is None else jnp.asarray(ids), chunk=chunk,
        lc=None if lc is None else jnp.asarray(lc))
    np.testing.assert_allclose(got["total_logp"].numpy(),
                               np.asarray(ref["total_logp"]), **TOTAL_TOL)


def test_streaming_rejects_scalar_input(rng):
    _, tc, _, tp, _ = _pair(VARIANTS["scalar"])
    with pytest.raises(NotImplementedError):
        tscore.log_likelihood_streaming(
            tp, tc, torch.zeros((1, 20)), chunk=8)


# ---------------------------------------------------------------------------
# The score CLI beside the JAX CLI
# ---------------------------------------------------------------------------

def _write_both(tmp, base, json_extra=()):
    """Params JSON, a port checkpoint and a JAX checkpoint of the same
    weights: (json path, port dir, JAX dir)."""
    from wavenet_tpu import train_lib as jtl
    from wavenet_torch import train_lib as ttl

    jc, tc, _, tp, npp = _pair(base, key=11)
    raw = dict(tc.to_json_dict(), sample_rate=2000)
    for k in json_extra:
        raw.pop(k, None)
    pfile = tmp / "params.json"
    pfile.write_text(json.dumps(raw))
    tdir, jdir = tmp / "torch", tmp / "jax"
    ttl.save_checkpoint(str(tdir), ttl.train_state_from_params(
        tp, ttl.make_optimizer("adam", 1e-3)))
    state = jtl.create_train_state(jax.random.PRNGKey(0), jc,
                                   jtl.make_optimizer("adam", 1e-3))
    jtl.save_checkpoint(str(jdir), dataclasses.replace(
        state, params={k: jnp.asarray(v) for k, v in npp.items()}))
    return str(pfile), str(tdir), str(jdir)


def _score_both(capsys, pfile, tdir, jdir, wavs, flags):
    out = {}
    for pkg, main, ckpt, extra in (
            ("jax", jscore.main, jdir, []),
            ("torch", tscore.main, tdir, ["--device", "cpu"])):
        assert main([ckpt] + wavs + [f"--wavenet_params={pfile}"] + flags
                    + extra) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        out[pkg] = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(out["torch"]) == len(out["jax"]) == len(wavs)
    for got, ref in zip(out["torch"], out["jax"]):
        assert set(got) == set(ref) == {"file", "samples", "total_logp",
                                        "bits_per_sample",
                                        "nll_nats_per_sample"}
        assert got["file"] == ref["file"]
        assert got["samples"] == ref["samples"]
        np.testing.assert_allclose(got["total_logp"], ref["total_logp"],
                                   rtol=1e-5, atol=2e-3)
        for k in ("bits_per_sample", "nll_nats_per_sample"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                       atol=2e-5)
    return out["torch"]


def _wav(path, n, f0=200.0):
    from scipy.io import wavfile
    t = np.arange(n) / 2000.0
    wavfile.write(str(path), 2000,
                  (0.5 * np.sin(2 * np.pi * f0 * t) * 32767).astype(np.int16))
    return str(path)


def test_score_cli_matches_jax_cli(tmp_path, capsys):
    """One short file (one-shot) and one past --streaming_chunk
    (streaming), as the JAX CLI scores them."""
    pfile, tdir, jdir = _write_both(tmp_path, dict(SMALL, sample_rate=2000))
    wavs = [_wav(tmp_path / "a.wav", 400), _wav(tmp_path / "b.wav", 700,
                                                 330.0)]
    rows = _score_both(capsys, pfile, tdir, jdir, wavs,
                       ["--streaming_chunk=512"])
    assert [r["samples"] for r in rows] == [400, 700]
    # An untrained-like model is near uniform over Q = 32: ~5 bits.
    assert all(3.0 < r["bits_per_sample"] < 7.0 for r in rows)


def test_score_cli_lc_and_gc_from_filename(tmp_path, capsys):
    """An LC + GC model: each file's .lc.npy sidecar and its p<id>_
    speaker id, as the JAX CLI reads them; a missing sidecar raises."""
    base = dict(SMALL, sample_rate=2000, gc_channels=4, gc_cardinality=5,
                lc_channels=3)
    pfile, tdir, jdir = _write_both(
        tmp_path, base, ("gc_channels", "gc_cardinality", "lc_channels"))
    rng = np.random.RandomState(0)
    wav = _wav(tmp_path / "p3_001.wav", 400)
    np.save(str(tmp_path / "p3_001.lc.npy"),
            rng.randn(400 // 50, 3).astype(np.float32))
    flags = ["--gc_channels=4", "--gc_cardinality=5", "--gc_from_filename",
             "--lc_channels=3", "--lc_hop=50"]
    _score_both(capsys, pfile, tdir, jdir, [wav], flags)
    wav2 = _wav(tmp_path / "p2_002.wav", 400)
    with pytest.raises(FileNotFoundError, match="lc.npy"):
        tscore.main([tdir, wav2, f"--wavenet_params={pfile}",
                     "--lc_channels=3", "--lc_hop=50", "--device", "cpu"])
    with pytest.raises(ValueError, match="lc_hop"):
        tscore.main([tdir, wav, f"--wavenet_params={pfile}",
                     "--lc_channels=3", "--device", "cpu"])
