"""wavenet_torch speculative decoding, distillation and their entry points
(CPU), held against the JAX package where the two can agree.

The emitted codes cannot equal the JAX package's (the random streams
differ), so the tests mirror ``tests/test_speculative.py`` by property:
a draft equal to the target accepts every proposal; the committed target
and draft states equal the JAX package's ``prefill_state`` on the port's
emitted stream (atol 2e-5); the first sample's distribution is within
total variation 0.1 of the target's softmax from JAX's ``forward_codes``
(1,200 draws over 16 codes: the sampling spread is ~0.04, a wrong
acceptance or residual shifts whole modes); batched lanes equal their
solo runs bitwise; resumable segments are a prefix of one run, with the
carry's ``t`` chained. Weights are one numpy dict carried into both
packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import sample as jsample
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy
from wavenet_torch.speculative import (
    _speculative_loop, generate_speculative, lane_generators)
from wavenet_torch import sample as tsample

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

STATE_ATOL = 2e-5
TV_BOUND = 0.1

TARGET = dict(dilations=(1, 2, 4, 8), residual_channels=4,
              dilation_channels=4, skip_channels=8, quantization_channels=16,
              use_biases=True)
DRAFT = dict(TARGET, dilations=(1, 2))


def _pair(base, key):
    """JAX params and port params of one numpy dict (seeded biases)."""
    jc = JConfig(**base)
    rng = np.random.RandomState(key)
    npp = {}
    for k, v in sorted(jw.init_params(jax.random.PRNGKey(key), jc).items()):
        v = np.asarray(v)
        if k.endswith("_bias"):
            v = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        npp[k] = v
    return ({k: jnp.asarray(v) for k, v in npp.items()},
            params_from_numpy(npp, "cpu"))


def _key(seed):
    return torch.Generator().manual_seed(seed)


def _seed(cfg, rng, B=1):
    return torch.as_tensor(rng.randint(0, cfg.quantization_channels,
                                       (B, cfg.receptive_field)),
                           dtype=torch.int32)


def test_draft_equals_target_accepts_everything(rng):
    cfg = TConfig(**TARGET)
    _, tp = _pair(TARGET, 0)
    seed = _seed(cfg, rng)
    codes, (n_seg, n_acc, n_out) = generate_speculative(
        tp, cfg, tp, cfg, n_samples=40, key=_key(3), k=5, seed_codes=seed,
        return_stats=True)
    assert codes.shape == (1, 40) and codes.dtype == torch.int32
    assert 0 <= int(codes.min()) and int(codes.max()) < 16
    assert n_acc == n_seg * 5          # p_t == p_d: every proposal kept
    assert n_out >= 40
    again = generate_speculative(tp, cfg, tp, cfg, n_samples=40,
                                 key=_key(3), k=5, seed_codes=seed)
    assert torch.equal(codes, again)


@pytest.mark.parametrize("k", [1, 4])
def test_committed_state_equals_teacher_forcing(k, rng):
    """After a run, the target's and the draft's states equal JAX's
    prefill of the stream the loop consumed: the seed and every emitted
    code but the last (the next segment's input)."""
    cfg, dcfg = TConfig(**TARGET), TConfig(**DRAFT)
    jp, tp = _pair(TARGET, 0)
    jdp, tdp = _pair(DRAFT, 5)
    seed = _seed(cfg, rng)
    t0 = tsample.prefill_state(tp, cfg, seed[:, :-1])
    d0 = tsample.prefill_state(tdp, dcfg, seed[:, :-1])
    ring0 = t0.layer_bufs.clone()
    codes, t_st, d_st, last, (n_seg, n_acc, n_out) = _speculative_loop(
        tp, cfg, tdp, dcfg, t0, d0, seed[:, -1], _key(7), 23, k, 1.0,
        None, None)
    assert torch.equal(t0.layer_bufs, ring0)      # inputs not written
    assert codes.shape == (1, n_out) and 23 <= n_out <= 23 + k
    assert int(last[0]) == int(codes[0, -1])
    full = np.concatenate([seed[0].numpy(), codes[0].numpy()])
    consumed = seed.shape[1] - 1 + n_out
    assert t_st.t == d_st.t == consumed
    stream = jnp.asarray(full[:consumed])[None, :]
    for got, params, c in ((t_st, jp, JConfig(**TARGET)),
                           (d_st, jdp, JConfig(**DRAFT))):
        ref = jsample.prefill_state(params, c, stream)
        np.testing.assert_allclose(got.layer_bufs.numpy(),
                                   np.asarray(ref.layer_bufs), rtol=0,
                                   atol=STATE_ATOL)
        np.testing.assert_allclose(got.causal_buf.numpy(),
                                   np.asarray(ref.causal_buf), rtol=0,
                                   atol=STATE_ATOL)


def test_first_sample_distribution_is_target(rng):
    """The first emitted sample's marginal is the target's softmax (from
    JAX's forward_codes), whatever the draft."""
    cfg, dcfg = TConfig(**TARGET), TConfig(**DRAFT)
    jp, tp = _pair(TARGET, 1)
    _, tdp = _pair(DRAFT, 6)
    seed = _seed(cfg, rng)
    p_t = np.asarray(jax.nn.softmax(
        jw.forward_codes(jp, JConfig(**TARGET), jnp.asarray(seed))[0, -1]))
    N = 1200
    counts = np.zeros(16)
    key = _key(100)
    for _ in range(N):
        c = generate_speculative(tp, cfg, tdp, dcfg, n_samples=1, key=key,
                                 k=3, seed_codes=seed)
        counts[int(c[0, 0])] += 1
    tv = 0.5 * np.abs(counts / N - p_t).sum()
    assert tv < TV_BOUND, (tv, counts / N, p_t)


def test_temperature_and_gc(rng):
    gc = dict(gc_channels=4, gc_cardinality=4)
    cfg = TConfig(**TARGET, **gc)
    dcfg = TConfig(**dict(TARGET, dilations=(1, 2)), **gc)
    _, tp = _pair(dict(TARGET, **gc), 2)
    _, tdp = _pair(dict(TARGET, dilations=(1, 2), **gc), 8)
    codes = generate_speculative(
        tp, cfg, tdp, dcfg, n_samples=30, key=_key(4), k=4,
        temperature=0.8, gc_ids=torch.tensor([2]),
        draft_gc_ids=torch.tensor([2]), seed_codes=_seed(cfg, rng))
    assert codes.shape == (1, 30)
    assert 0 <= int(codes.min()) and int(codes.max()) < 16
    other = generate_speculative(
        tp, cfg, tdp, dcfg, n_samples=30, key=_key(4), k=4,
        temperature=0.8, gc_ids=torch.tensor([0]),
        draft_gc_ids=torch.tensor([0]), seed_codes=_seed(cfg, rng))
    assert other.shape == (1, 30)


def test_batched_lanes_equal_solo_runs(rng):
    """B > 1 runs independent lanes: lane i emits what its solo loop with
    ``lane_generators(key, B)[i]`` emits, bitwise; GC ids go per lane."""
    gc = dict(gc_channels=4, gc_cardinality=4)
    cfg, dcfg = TConfig(**TARGET, **gc), TConfig(**DRAFT, **gc)
    _, tp = _pair(dict(TARGET, **gc), 0)
    _, tdp = _pair(dict(DRAFT, **gc), 5)
    B, n = 3, 15
    seeds = _seed(cfg, rng, B)
    ids = torch.tensor([0, 3, 1])
    batched, stats = generate_speculative(
        tp, cfg, tdp, dcfg, n, _key(21), k=4, seed_codes=seeds, gc_ids=ids,
        draft_gc_ids=ids, return_stats=True)
    assert batched.shape == (B, n)
    lanes = lane_generators(_key(21), B)
    total = [0, 0, 0]
    for i in range(B):
        gt = tsample.embed_gc(tp, cfg, ids[i:i + 1])
        gd = tsample.embed_gc(tdp, dcfg, ids[i:i + 1])
        st = tsample.prefill_state(tp, cfg, seeds[i:i + 1, :-1], gt)
        dst = tsample.prefill_state(tdp, dcfg, seeds[i:i + 1, :-1], gd)
        solo, _, _, _, s = _speculative_loop(
            tp, cfg, tdp, dcfg, st, dst, seeds[i:i + 1, -1], lanes[i], n, 4,
            1.0, gt, gd)
        assert torch.equal(batched[i], solo[0, :n])
        total = [a + b for a, b in zip(total, s)]
    assert tuple(total) == stats


def test_resumable_segments_prefix_equals_one_run(rng):
    """Segments are a prefix of one run and chain ``t``; a continuation
    drawing from the same generator equals the single run."""
    cfg = TConfig(**TARGET)
    _, tp = _pair(TARGET, 0)
    _, tdp = _pair(DRAFT, 5)
    dcfg = TConfig(**DRAFT)
    seed = _seed(cfg, rng)
    one = generate_speculative(tp, cfg, tdp, dcfg, 30, _key(13), k=4,
                               seed_codes=seed)
    a_full, carry = generate_speculative(tp, cfg, tdp, dcfg, 10, _key(13),
                                         k=4, seed_codes=seed,
                                         return_carry=True)
    n_cmp = min(a_full.shape[1], 30)
    assert n_cmp >= 10
    assert torch.equal(a_full[0, :n_cmp], one[0, :n_cmp])
    b_full, carry2 = generate_speculative(tp, cfg, tdp, dcfg, 8, _key(14),
                                          k=4, carry=carry,
                                          return_carry=True)
    assert b_full.shape[1] >= 8
    assert carry2.t_state.t == carry.t_state.t + b_full.shape[1]
    assert carry2.d_state.t == carry2.t_state.t

    key = _key(13)
    parts, carry = [], None
    while sum(p.shape[1] for p in parts) < 30:
        part, carry = generate_speculative(
            tp, cfg, tdp, dcfg, 7, key, k=4,
            seed_codes=seed if carry is None else None, carry=carry,
            return_carry=True)
        parts.append(part)
    assert torch.equal(torch.cat(parts, 1)[:, :30], one)


@pytest.mark.parametrize("case,exc", [
    ("scalar", NotImplementedError), ("lc", NotImplementedError),
    ("draft_lc", NotImplementedError), ("quantization", ValueError),
    ("carry_batch", ValueError)])
def test_refusals_match_jax(case, exc):
    cfg, dcfg = TConfig(**TARGET), TConfig(**TARGET)
    kw = {}
    if case == "scalar":
        cfg = dcfg = TConfig(**TARGET, scalar_input=True,
                             initial_filter_width=2)
    elif case == "lc":
        cfg = TConfig(**TARGET, lc_channels=2)
    elif case == "draft_lc":
        dcfg = TConfig(**TARGET, lc_channels=2)
    elif case == "quantization":
        dcfg = TConfig(**dict(TARGET, quantization_channels=32))
    else:
        kw = dict(batch_size=2, return_carry=True)
    from wavenet_torch.models.wavenet import init_params
    tp, tdp = init_params(0, cfg, "cpu"), init_params(0, dcfg, "cpu")
    with pytest.raises(exc):
        generate_speculative(tp, cfg, tdp, dcfg, n_samples=4, key=_key(0),
                             **kw)


def test_distill_draft_mechanics(rng):
    """The draft trains on the target's samples: a finite loss below
    uniform's, params on the key's device, and the result drives
    speculative decoding; bad arguments raise as in JAX."""
    from wavenet_torch.distill import distill_draft

    cfg, dcfg = TConfig(**TARGET), TConfig(**DRAFT)
    _, tp = _pair(TARGET, 0)
    seed = _seed(cfg, rng)
    dparams, loss = distill_draft(tp, cfg, dcfg, _key(4), n_clips=2,
                                  clip_samples=120, steps=40,
                                  seed_codes=seed)
    assert np.isfinite(loss) and loss < np.log(16)
    assert all(v.device.type == "cpu" and not v.requires_grad
               for v in dparams.values())
    codes = generate_speculative(tp, cfg, dparams, dcfg, n_samples=12,
                                 key=_key(5), k=3, seed_codes=seed)
    assert codes.shape == (1, 12)
    with pytest.raises(ValueError):
        distill_draft(tp, cfg, dcfg, _key(4), steps=0)
    scalar = TConfig(**TARGET, scalar_input=True, initial_filter_width=2)
    with pytest.raises(NotImplementedError):
        distill_draft(tp, cfg, scalar, _key(4), steps=1)


def test_perturbed_draft_reaches_high_acceptance():
    """``tests/test_end_to_end.py``'s speculative case at a reduced size: a
    target trained briefly on a sine, a lightly perturbed copy as the
    draft; acceptance > 0.6 and > 3 samples a verify pass."""
    from wavenet_torch import train_lib as ttl
    from wavenet_torch.audio import mu_law_encode

    cfg = TConfig(dilations=(1, 2, 4, 8, 16, 1, 2, 4, 8, 16),
                  residual_channels=8, dilation_channels=8,
                  skip_channels=16, quantization_channels=64,
                  use_biases=True)
    t = np.arange(4 * cfg.receptive_field + 600) / 2000.0
    audio = torch.as_tensor(
        (0.6 * np.sin(2 * np.pi * 155.56 * t))[None].astype(np.float32))
    state = ttl.create_train_state(0, cfg, ttl.make_optimizer("adam", 4e-3),
                                   device="cpu")
    step = ttl.make_train_step(cfg)
    first = None
    for _ in range(60):
        state, m = step(state, audio)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first
    params = {k: v.detach() for k, v in state.params.items()}
    gen = torch.Generator().manual_seed(11)
    dparams = {k: v + 0.01 * v.std() * torch.randn(v.shape, generator=gen)
               for k, v in params.items()}
    seed = mu_law_encode(audio[:, :cfg.receptive_field], 64)
    _, (n_seg, n_acc, n_out) = generate_speculative(
        params, cfg, dparams, cfg, 300, _key(3), k=6, seed_codes=seed,
        return_stats=True)
    assert n_acc / (n_seg * 6) > 0.6, (n_seg, n_acc)
    assert n_out / n_seg > 3.0


# ---------------------------------------------------------------------------
# The generate CLI and the server with a draft
# ---------------------------------------------------------------------------

PJ = dict(filter_width=2, sample_rate=2000, dilations=[1, 2, 4],
          residual_channels=4, dilation_channels=4, skip_channels=8,
          quantization_channels=16, use_biases=True, scalar_input=False,
          initial_filter_width=2)


def _ckpt(tmp_path, pj=PJ):
    from wavenet_torch import train_lib as ttl
    pfile = tmp_path / "params.json"
    pfile.write_text(json.dumps(pj))
    cfg = TConfig.from_json(pj)
    state = ttl.create_train_state(0, cfg, ttl.make_optimizer("adam", 1e-3),
                                   device="cpu")
    ckpt = str(tmp_path / "ckpts")
    ttl.save_checkpoint(ckpt, state)
    return str(pfile), ckpt


def test_cli_speculative_flag(tmp_path, capsys):
    """--draft_checkpoint writes a wav of 44 + 2n bytes, with and without
    --save_every; the segments equal the single run."""
    from scipy.io import wavfile

    from wavenet_torch.cli.generate import main as gen_main

    pfile, ckpt = _ckpt(tmp_path)
    common = [ckpt, f"--wavenet_params={pfile}", "--seed=1",
              f"--draft_checkpoint={ckpt}", "--speculative_k=3",
              "--device", "cpu"]
    out = tmp_path / "out.wav"
    assert gen_main(common + ["--samples=14", f"--wav_out_path={out}"]) == 0
    assert out.stat().st_size == 44 + 2 * 14
    log = capsys.readouterr().out
    assert "draft acceptance 100.0%" in log and "samples/pass" in log
    out2 = tmp_path / "out2.wav"
    assert gen_main(common + ["--samples=14", "--save_every=6",
                              f"--wav_out_path={out2}"]) == 0
    assert out2.stat().st_size == 44 + 2 * 14
    assert "partial wav updated" in capsys.readouterr().out
    np.testing.assert_array_equal(wavfile.read(str(out))[1],
                                  wavfile.read(str(out2))[1])
    # Batches run as lanes, one wav each.
    out3 = tmp_path / "out3.wav"
    assert gen_main(common + ["--samples=10", "--batch_size=2",
                              f"--wav_out_path={out3}"]) == 0
    for i in range(2):
        assert (tmp_path / f"out3-{i}.wav").stat().st_size == 44 + 2 * 10


@pytest.mark.parametrize("flags,exc,match", [
    (["--save_every=10", "--batch_size=2"], ValueError, "batch size 1"),
    (["--lc_channels=2", "--lc_file=f.npy", "--lc_hop=80"], ValueError,
     "local conditioning")])
def test_cli_draft_refusals(tmp_path, flags, exc, match):
    from wavenet_torch.cli.generate import main as gen_main
    pfile, _ = _ckpt(tmp_path)
    with pytest.raises(exc, match=match):
        gen_main(["/nonexistent", "--draft_checkpoint=/nonexistent",
                  "--samples=20", f"--wavenet_params={pfile}",
                  "--device", "cpu"] + flags)
