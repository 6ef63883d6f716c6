"""wavenet_torch generation entry points against the JAX package (CPU).

The scan sampler (``wavenet_torch.sample``) is held against the JAX
package's on states and logits (rtol 1e-4, atol 1e-5, the JAX sampler
tests' tolerance); its codes are compared only at an argmax temperature,
since the two packages draw other random numbers. The generate CLI is run
beside the JAX CLI on the same weights (one npz in a port ``ckpt-0/``, the
same arrays in a JAX orbax checkpoint) at temperature 1e-6, where the
weights make sampling an argmax: the codes of every path must be equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import sample as jsample
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import sample as tsample
from wavenet_torch import sampler_select as tsel
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)

SMALL = dict(dilations=(1, 2, 4, 8), residual_channels=4,
             dilation_channels=4, skip_channels=8, quantization_channels=32)
SCALAR = dict(SMALL, scalar_input=True, initial_filter_width=4)
GC = dict(gc_channels=4, gc_cardinality=4)


def _pair(base, key=0, gc=False, out_scale=1.0):
    """JAX and port configs and params from one numpy dict (seeded
    non-zero biases; ``out_scale`` widens the logits' gaps)."""
    d = dict(base, **(GC if gc else {}))
    jc, tc = JConfig(**d), TConfig(**d)
    rng = np.random.RandomState(key)
    npp = {}
    for k, v in sorted(jw.init_params(jax.random.PRNGKey(key), jc).items()):
        v = np.asarray(v)
        if k.endswith("_bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        if k == "postprocess2":
            v = (out_scale * v).astype(np.float32)
        npp[k] = v
    return jc, tc, {k: jnp.asarray(v) for k, v in npp.items()}, \
        params_from_numpy(npp, "cpu"), npp


def _inputs(c, rng, B, T):
    if c.scalar_input:
        return rng.uniform(-1, 1, (B, T)).astype(np.float32)
    return rng.randint(0, c.quantization_channels, (B, T)).astype(np.int32)


def _close_states(got, ref):
    assert got.t == int(ref.t)
    np.testing.assert_allclose(got.layer_bufs.numpy(),
                               np.asarray(ref.layer_bufs), **TOL)
    np.testing.assert_allclose(got.causal_buf.numpy(),
                               np.asarray(ref.causal_buf), **TOL)


# ---------------------------------------------------------------------------
# The scan sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["mulaw", "gc", "scalar"])
def test_prime_and_prefill_state_match_jax(variant, rng):
    jc, tc, jp, tp, _ = _pair(SCALAR if variant == "scalar" else SMALL,
                              gc=variant == "gc")
    B, T = 2, jc.receptive_field + 3
    wave = _inputs(tc, rng, B, T)
    ids = np.array([1, 3])
    jemb = jw.embed_gc(jp, jc, jnp.asarray(ids)) if variant == "gc" else None
    temb = tw.embed_gc(tp, tc, torch.as_tensor(ids)) \
        if variant == "gc" else None
    ref = jsample.prime_state(jp, jc, jsample.init_sampler_state(jc, B),
                              jnp.asarray(wave), jemb)
    got = tsample.prime_state(tp, tc, tsample.init_sampler_state(tc, B),
                              torch.as_tensor(wave), temb)
    _close_states(got, ref)
    _close_states(tsample.prefill_state(tp, tc, torch.as_tensor(wave), temb),
                  jsample.prefill_state(jp, jc, jnp.asarray(wave), jemb))
    # Short prefill (T < the largest dilation) and the empty one.
    _close_states(tsample.prefill_state(tp, tc, torch.as_tensor(wave[:, :3]),
                                        temb),
                  jsample.prefill_state(jp, jc, jnp.asarray(wave[:, :3]),
                                        jemb))
    assert tsample.prefill_state(tp, tc, torch.as_tensor(wave[:, :0])).t == 0


@pytest.mark.parametrize("scalar", [False, True])
def test_sampler_step_matches_jax_teacher_forced(scalar, rng):
    jc, tc, jp, tp, _ = _pair(SCALAR if scalar else SMALL, key=2)
    B, T = 2, jc.receptive_field + 4
    wave = _inputs(tc, rng, B, T)
    js_, ts_ = (jsample.init_sampler_state(jc, B),
                tsample.init_sampler_state(tc, B))
    full = np.asarray(jw.forward(
        jp, jc, jnp.asarray(wave)[..., None] if scalar
        else jw.one_hot(jnp.asarray(wave), jc.quantization_channels)))
    for t in range(T):
        js_, lj = jsample.sampler_step(
            jp, jc, js_, jsample._featurize(jnp.asarray(wave[:, t]), jc))
        ts_, lt = tsample.sampler_step(
            tp, tc, ts_, tsample._featurize(torch.as_tensor(wave[:, t]), tc))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(lt.numpy(), full[:, t], **TOL)
    _close_states(ts_, js_)


@pytest.mark.parametrize("scalar", [False, True])
def test_generate_codes_resumable_matches_jax(scalar, rng):
    """At an argmax temperature the codes, states and next inputs equal
    the JAX sampler's; chunks from one generator equal one run."""
    jc, tc, jp, tp, _ = _pair(SCALAR if scalar else SMALL, key=3,
                              out_scale=30.0)
    B = 2
    wave = _inputs(tc, rng, B, jc.receptive_field)
    jst = jsample.prefill_state(jp, jc, jnp.asarray(wave[:, :-1]))
    first = wave[:, -1]
    jcodes, jst, jx = jsample.generate_codes_resumable(
        jp, jc, jst, jsample._featurize(jnp.asarray(first), jc), 24,
        jax.random.PRNGKey(0), 1e-6)
    key = torch.Generator().manual_seed(0)
    tst = tsample.prefill_state(tp, tc, torch.as_tensor(wave[:, :-1]))
    x = tsample._featurize(torch.as_tensor(first), tc)
    a, tst, x = tsample.generate_codes_resumable(tp, tc, tst, x, 10, key,
                                                 1e-6)
    b, tst, x = tsample.generate_codes_resumable(tp, tc, tst, x, 14, key,
                                                 1e-6)
    codes = torch.cat([a, b], dim=1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert len(np.unique(codes.numpy())) > 1
    _close_states(tst, jst)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    # At temperature 1: in range, deterministic per generator seed.
    run = [tsample.generate(tp, tc, 16, torch.Generator().manual_seed(s),
                            batch_size=B) for s in (5, 5, 6)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])
    assert 0 <= run[0].min() and run[0].max() < tc.quantization_channels


def test_sampler_select():
    tc = TConfig(**SMALL)
    (name, kw), = tsel.sampler_attempts(tc)
    assert kw == {"prefill": True} and "CUDA" in name
    assert "decode_reference" in tsel.sampler_attempts(
        tc, device=torch.device("cpu"))[0][0]
    assert tsel.sampler_attempts(tc, sampler="scan") == []
    assert tsel.sampler_attempts(TConfig(**SMALL, filter_width=3)) == []
    (name, kw), = tsel.sampler_attempts(tc, precision="bfloat16")
    assert kw == {"prefill": True, "weight_dtype": torch.bfloat16}
    assert "bf16" in name
    assert tsel.sampler_attempts(tc, sampler="scan",
                                 precision="bfloat16") == []
    with pytest.raises(ValueError):
        tsel.sampler_attempts(tc, precision="float16")
    _, _, _, tp, _ = _pair(SMALL)
    logs = []
    codes, name, kw = tsel.generate_with_fallback(
        tp, tc, 12, seed=2, batch_size=2, log=logs.append)
    assert codes.shape == (2, 12) and "decode_reference" in name
    assert logs == [f"Using {name} sampler."]
    codes, name, kw = tsel.generate_with_fallback(
        tp, tc, 12, seed=2, batch_size=2, sampler="scan", log=logs.append)
    assert codes.shape == (2, 12) and (name, kw) == ("scan", None)


# ---------------------------------------------------------------------------
# The generate CLI against the JAX CLI
# ---------------------------------------------------------------------------

def _write_model(tmp, name, base, gc):
    """Params JSON, a port checkpoint and a JAX checkpoint of the same
    weights; returns (json path, port dir, JAX dir, config)."""
    from wavenet_tpu import train_lib as jtl
    from wavenet_torch import train_lib as ttl

    jc, tc, _, tp, npp = _pair(base, key=11, gc=gc, out_scale=30.0)
    pfile = tmp / f"{name}.json"
    pfile.write_text(json.dumps(dict(tc.to_json_dict(), sample_rate=2000)))
    tdir, jdir = tmp / f"{name}_torch", tmp / f"{name}_jax"
    ttl.save_checkpoint(str(tdir), ttl.train_state_from_params(
        tp, ttl.make_optimizer("adam", 1e-3)))
    state = jtl.create_train_state(jax.random.PRNGKey(0), jc,
                                   jtl.make_optimizer("adam", 1e-3))
    state = dataclasses.replace(
        state, params={k: jnp.asarray(v) for k, v in npp.items()})
    jtl.save_checkpoint(str(jdir), state)
    return str(pfile), str(tdir), str(jdir), tc


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_generate")
    from wavenet_torch.audio import write_wav
    t = np.arange(600) / 2000.0
    wav = str(tmp / "seed.wav")
    write_wav(wav, 0.6 * np.sin(2 * np.pi * 180.0 * t), 2000)
    return {"scalar": _write_model(tmp, "scalar", SCALAR, gc=False),
            "gc": _write_model(tmp, "gc", SMALL, gc=True), "wav": wav,
            "tmp": tmp}


def _codes_of(path, Q):
    """The mu-law codes a written wav holds (nearest decoded level)."""
    from scipy.io import wavfile
    from wavenet_torch.audio import mu_law_decode_np
    levels = np.clip(mu_law_decode_np(np.arange(Q), Q), -1, 1) * 32767.0
    _, x = wavfile.read(path)
    return np.abs(x.astype(np.float64)[..., None] - levels).argmin(-1)


def _run_both(models, model, flags, B, tag):
    from wavenet_torch.cli import generate as tgen
    from wavenet_tpu.cli import generate as jgen

    pfile, tdir, jdir, tc = models[model]
    common = ["--wavenet_params", pfile, "--samples", "24",
              "--temperature", "1e-6", "--batch_size", str(B), "--seed", "3"]
    if model == "gc":
        common += ["--gc_channels", "4", "--gc_cardinality", "4",
                   "--gc_id", "2"]
    out = {}
    for pkg, main, ckpt, extra in (
            ("jax", jgen.main, jdir, ["--compilation_cache", ""]),
            ("torch", tgen.main, tdir, ["--device", "cpu"])):
        wav = str(models["tmp"] / f"{tag}_{pkg}.wav")
        assert main([ckpt, "--wav_out_path", wav] + common + flags
                    + extra) == 0
        paths = ([wav] if B == 1 else
                 [wav[:-4] + f"-{i}.wav" for i in range(B)])
        out[pkg] = np.stack([_codes_of(p, tc.quantization_channels)
                             for p in paths])
    return out["jax"], out["torch"]


CLI_PATHS = {"fast": [], "save_every": ["--save_every", "10"],
             "slow": ["--fast_generation", "false"]}


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("path", sorted(CLI_PATHS))
@pytest.mark.parametrize("model", ["scalar", "gc_wav_seed"])
def test_cli_codes_equal_jax_cli(models, model, path, B):
    """Scalar models start from silence in both packages; the mu-law GC
    model is seeded with --wav_seed (an unseeded mu-law start draws a
    random first code, which the packages draw differently)."""
    flags = list(CLI_PATHS[path])
    name = "scalar"
    if model == "gc_wav_seed":
        flags += ["--wav_seed", models["wav"]]
        name = "gc"
    ref, got = _run_both(models, name, flags, B, f"{model}_{path}_{B}")
    assert ref.shape == (B, 24)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) > 1


def test_cli_slow_mulaw_unseeded_and_scan_sampler(models):
    """The slow path starts from one silence code in both packages; the
    port's scan sampler (--sampler scan, with and without --save_every)
    gives the codes of its kernel path at an argmax temperature."""
    ref, got = _run_both(models, "gc", ["--fast_generation", "false"], 1,
                         "gc_slow_unseeded")
    np.testing.assert_array_equal(got, ref)
    seeded = ["--wav_seed", models["wav"]]
    ref, _ = _run_both(models, "gc", seeded, 2, "gc_fast")
    for flags in (["--sampler", "scan"],
                  ["--sampler", "scan", "--save_every", "7"]):
        _, got = _run_both(models, "gc", seeded + flags, 2, "gc_scan")
        np.testing.assert_array_equal(got, ref)


def test_cli_flags_match_jax_cli():
    from wavenet_torch.cli import generate as tgen
    from wavenet_tpu.cli import generate as jgen

    ref = vars(jgen.get_arguments(["ckpt"]))
    got = vars(tgen.get_arguments(["ckpt"]))
    assert got.pop("device") == "cuda"
    assert got == ref
    assert tgen.SILENCE_THRESHOLD == jgen.SILENCE_THRESHOLD


# LC runs at either precision (tests/test_torch_sampler_lc.py,
# tests/test_torch_sampler_lc_bf16.py) and --draft_checkpoint runs
# (tests/test_torch_speculative.py): no flag of the CLI is refused as
# unported. At bf16, LC without its stream or hop is the CLI's own error.
@pytest.mark.parametrize("flags", [
    ["--lc_channels", "2", "--sampler_precision", "bfloat16"],
    ["--lc_channels", "2", "--lc_file", "f.npy", "--sampler_precision",
     "bfloat16"],
    ["--lc_channels", "2", "--lc_hop", "80", "--sampler_precision",
     "bfloat16"]])
def test_cli_unported_flags_raise(flags):
    from wavenet_torch.cli import generate as tgen
    params = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "wavenet_params.json")
    with pytest.raises(ValueError, match="--lc_file and --lc_hop"):
        tgen.main(["ckpt", "--wavenet_params", params, "--device", "cpu"]
                  + flags)


def test_cli_errors_and_warning(models, tmp_path, capsys):
    from wavenet_torch.cli import generate as tgen

    pfile, tdir, _, _ = models["scalar"]
    with pytest.raises(FileNotFoundError):
        tgen.main([str(tmp_path), "--wavenet_params", pfile,
                   "--device", "cpu"])
    with pytest.raises(ValueError, match="gc_cardinality"):
        tgen.main([tdir, "--wavenet_params", pfile, "--device", "cpu",
                   "--gc_channels", "4"])
    # A model whose head always answers silence (code Q/2) warns.
    silent = tmp_path / "silent"
    from wavenet_torch import train_lib as ttl
    from wavenet_torch.params import load_npz
    p = load_npz(f"{tdir}/ckpt-0/params.npz", "cpu")
    p["postprocess2"].zero_()
    p["postprocess2_bias"].zero_()
    p["postprocess2_bias"][16] = 100.0
    ttl.save_checkpoint(str(silent), ttl.train_state_from_params(
        p, ttl.make_optimizer("adam", 1e-3)))
    assert tgen.main([f"{silent}/ckpt-0", "--wavenet_params", pfile,
                      "--device", "cpu", "--samples", "8"]) == 0
    assert "near-silent" in capsys.readouterr().out
