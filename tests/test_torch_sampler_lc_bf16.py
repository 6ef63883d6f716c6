"""Local conditioning at bf16 weights, the port against the JAX package
(CPU): the LC row of TPU kernels 1 and 2 at ``weight_dtype=bfloat16``,
the resumable segments and the generate CLI at ``--sampler_precision
bfloat16``.

The JAX kernels cast the LC row to ``lc_w``'s type before either of their
branches (``lc_ref[0, t].astype(lc_w_ref.dtype)``), so at bf16 weights the
LC operand is rounded at every B, also at B = 1, where the layer chain's
inputs are not (the b1 VPU chain). The port's ``decode_reference(lc=)``
at bf16 (the plain twin of the bf16 LC modes of ``sampler_cluster`` and
``sampler_decode``) follows that rule. Each TPU kernel runs here in
interpret mode at bf16 weights, and the port is teacher-forced on that
run's codes through its own entry points (``decode`` on the prefill
route, ``decode_sequential`` from a zero ring): its logits must equal the
JAX kernel's at every step within rtol 1e-4, atol 1e-5 (the tolerance of
tests/test_torch_sampler_lc.py and tests/test_torch_sampler_bf16.py),
its codes JAX's. The configs and streams are
tests/test_torch_sampler_lc.py's (4 layers, R = D = 4, S = 8, Q = 32,
three LC channels, LC weights and biases perturbed from a seed).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sampler_lc import (
    LC_FLAGS, SMALL, TOL, _case, _codes_of, _jx, _pair, _port_streams, _t)
from wavenet_tpu.kernels import sampler as js
from wavenet_torch.kernels import sampler as ts
from wavenet_torch.models import wavenet as tw

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

BF16 = torch.bfloat16


def _packed(tc, tp, B, gc_ids, weight_dtype=BF16):
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    return ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids),
        weight_dtype=weight_dtype), gids


def _replay_sequential(tc, tp, seed_codes, gc_ids, lc, lc_prime,
                       codes_jax):
    """``decode_sequential`` at bf16 weights over a JAX run's inputs (the
    forced prefix, then JAX's sampled codes), conditioned by
    ``[lc_prime | lc]``: (codes of the sampled steps, logits of every
    step)."""
    B, n_forced = seed_codes.shape
    n_total = n_forced - 1 + codes_jax.shape[1]
    packed, _ = _packed(tc, tp, B, gc_ids)
    lc_r, lc_p = _port_streams(tp, tc, lc, lc_prime, n_forced - 1)
    stream = torch.cat([lc_p, lc_r], dim=1).transpose(0, 1).contiguous()
    forced = torch.cat([_t(seed_codes, torch.int32),
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    codes, logits = ts.decode_sequential(
        packed, tc, forced.contiguous(), n_total, 0, collect_logits=True,
        lc=stream)
    return codes[:, n_forced - 1:], logits


def _replay_prefill(tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes_jax):
    """The port's LC prefill, then ``decode`` at bf16 weights teacher-forced
    on JAX's decoded codes: (codes, logits of every decode step)."""
    B, n = codes_jax.shape
    packed, gids = _packed(tc, tp, B, gc_ids)
    carry = ts.prefill_carry(tp, tc, _t(seed_codes, torch.int32), gids,
                             lc=lc_p)
    forced = torch.cat([carry.last[:, None],
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    return ts.decode(packed, tc, carry.ring, carry.causal,
                     forced.contiguous(), n, carry.t_abs, 0,
                     collect_logits=True,
                     lc=lc_r.transpose(0, 1).contiguous())


def _hold(replayed, codes_jax, logits_jax):
    """Logits of every replayed step against JAX's; the codes of every
    step but the last (whose draw the replay makes itself)."""
    codes, logits = replayed
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_jax), **TOL)
    np.testing.assert_array_equal(codes[:, :-1].numpy(),
                                  np.asarray(codes_jax)[:, :-1])


def _sequential_run(B, gc, rng, stream_io=False):
    """TPU kernel 1 (``generate_pallas(prefill=False)``) or, with
    ``stream_io``, kernel 2 streamed from a zero ring, at bf16 weights:
    (configs, params, inputs, codes, logits)."""
    jc, tc, jp, tp, _ = _pair(gc, key=40 + B + (10 if stream_io else 0))
    seed_codes, gc_ids, lc, lc_prime = _case(rng, jc, B, 3, 9)
    hbm = dict(ring_in_hbm=True, stream_io=True) if stream_io else {}
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=9, seed=4, batch_size=B, gc_ids=_jx(gc_ids),
        seed_codes=jnp.asarray(seed_codes), lc=jnp.asarray(lc),
        lc_prime=jnp.asarray(lc_prime), collect_logits=True,
        interpret=True, weight_dtype=jnp.bfloat16, **hbm)
    return tc, tp, seed_codes, gc_ids, lc, lc_prime, codes, logits


def _prefill_run(B, lc_prime, rng):
    """TPU kernel 1 resumed from the LC prefill at bf16 weights
    (``generate_pallas(prefill=True)``), with an explicit ``lc_prime`` or
    the default (``lc[:, 0]`` held backward): (configs, params, inputs,
    refined streams, codes, logits)."""
    jc, tc, jp, tp, _ = _pair(True, key=50 + B)
    seed_codes, gc_ids, lc, lp = _case(rng, jc, B, 5, 8)
    lp = lp if lc_prime == "given" else None
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=8, seed=3, batch_size=B,
        gc_ids=jnp.asarray(gc_ids), seed_codes=jnp.asarray(seed_codes),
        lc=jnp.asarray(lc), lc_prime=_jx(lp), collect_logits=True,
        interpret=True, prefill=True, weight_dtype=jnp.bfloat16)
    lc_r, lc_p = _port_streams(tp, tc, lc, lp, seed_codes.shape[1] - 1)
    return tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes, logits


@pytest.mark.parametrize("gc", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel1_sequential_lc_bf16_matches_on_its_codes(B, gc, rng):
    """TPU kernel 1 from a zero ring at bf16 weights: the forced prefix
    and the sampled steps in one launch, each step conditioned by its row
    of ``[lc_prime | lc]``; at b1 its VPU chain (the chain's inputs float32,
    the LC row rounded), at b3 its MXU chain (both rounded)."""
    tc, tp, seed_codes, gc_ids, lc, lc_prime, codes, logits = (
        _sequential_run(B, gc, rng))
    _hold(_replay_sequential(tc, tp, seed_codes, gc_ids, lc, lc_prime,
                             codes), codes, logits)


@pytest.mark.parametrize("B", [1, 3])
def test_kernel2_streamed_lc_bf16_matches_on_its_codes(B, rng):
    """TPU kernel 2 (``_sampler_kernel_hbm_stream``) from a zero ring at
    bf16 weights, its LC rows streamed in double-buffered chunks and cast
    to ``lc_w``'s type as they are read
    (``generate_pallas(ring_in_hbm=True, stream_io=True)``)."""
    tc, tp, seed_codes, gc_ids, lc, lc_prime, codes, logits = (
        _sequential_run(B, True, rng, stream_io=True))
    _hold(_replay_sequential(tc, tp, seed_codes, gc_ids, lc, lc_prime,
                             codes), codes, logits)


@pytest.mark.parametrize("lc_prime", ["given", "held"])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel1_prefill_lc_bf16_matches_on_its_codes(B, lc_prime, rng):
    """TPU kernel 1 resumed from the LC prefill at bf16 weights (the
    route of the generate CLI and the server)."""
    tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes, logits = _prefill_run(
        B, lc_prime, rng)
    _hold(_replay_prefill(tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes),
          codes, logits)


@pytest.mark.parametrize("route", ["prefill", "sequential"])
def test_unrounded_lc_operand_misses_jax(route, rng, monkeypatch):
    """The rule is not vacuous: at B = 1, where the chain's inputs stay
    float32, the same plain version with the LC row left unrounded (every
    other operand as before) misses the JAX kernel by more than the
    tolerance."""
    C_lc = SMALL["lc_channels"]
    round_all = ts._bf16_operand
    monkeypatch.setattr(ts, "_bf16_operand", lambda x: x if x.shape[-1]
                        == C_lc else round_all(x))
    if route == "prefill":
        tc, tp, seed_codes, gc_ids, lc_r, lc_p, codes, logits = (
            _prefill_run(1, "given", rng))
        _, got = _replay_prefill(tc, tp, seed_codes, gc_ids, lc_r, lc_p,
                                 codes)
    else:
        tc, tp, seed_codes, gc_ids, lc, lc_prime, codes, logits = (
            _sequential_run(1, True, rng))
        _, got = _replay_sequential(tc, tp, seed_codes, gc_ids, lc,
                                    lc_prime, codes)
    # No other operand of the step has C_lc columns.
    assert C_lc not in (tc.residual_channels, 2 * tc.residual_channels,
                        tc.dilation_channels, tc.skip_channels,
                        ts.causal_width(tc) + tc.input_channels)
    assert not np.allclose(got.numpy(), np.asarray(logits), **TOL)


def test_lc_bf16_is_not_float32(rng):
    """bf16 weights move the LC logits by far more than the tolerance (the
    comparisons above are not float32 ones in disguise), and by less than
    a few bf16 steps of their scale."""
    _, tc, _, tp, _ = _pair(True, key=3)
    B, n = 3, 9
    seed_codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 4)),
                    torch.int32)
    ids = np.array([0, 2, 3])
    lc = _t(rng.uniform(-1, 1, (n, B, 3)).astype(np.float32))
    out = {}
    for wt in (torch.float32, BF16):
        carry = ts.prefill_carry(tp, tc, seed_codes, _t(ids, torch.int64),
                                 lc=lc[:1].transpose(0, 1).repeat(
                                     1, seed_codes.shape[1] - 1, 1))
        packed, _ = _packed(tc, tp, B, ids, wt)
        assert packed.lc_w.dtype == wt
        out[wt] = ts.decode(packed, tc, carry.ring, carry.causal,
                            carry.last[:, None], n, carry.t_abs, 1,
                            collect_logits=True, lc=lc)[1]
    gap = (out[BF16] - out[torch.float32]).abs().max().item()
    scale = out[torch.float32].abs().max().item()
    assert 1e-4 * scale < gap < 0.1 * scale


def test_resumable_lc_bf16_segments_equal_one_run(rng):
    """``generate_cuda_resumable`` at bf16 weights with the stream sliced
    per segment equals one ``generate_cuda`` run at bf16 bitwise."""
    _, tc, _, tp, _ = _pair(True, key=8)
    B, n = 2, 20
    seed_codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 2)))
    ids = _t([1, 3], torch.int64)
    lc = _t(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32))
    full = ts.generate_cuda(tp, tc, n, 5, batch_size=B, gc_ids=ids,
                            seed_codes=seed_codes, lc=lc, weight_dtype=BF16)
    f32 = ts.generate_cuda(tp, tc, n, 5, batch_size=B, gc_ids=ids,
                           seed_codes=seed_codes, lc=lc)
    parts, carry = [], None
    for a, b in ((0, 7), (7, 20)):
        codes, carry = ts.generate_cuda_resumable(
            tp, tc, b - a, 5, batch_size=B, gc_ids=ids,
            seed_codes=seed_codes if carry is None else None, carry=carry,
            lc=lc[:, a:b], weight_dtype=BF16)
        parts.append(codes)
    assert torch.equal(torch.cat(parts, dim=1), full)
    assert full.shape == f32.shape == (B, n)


@pytest.mark.parametrize("route,B,rounded", [
    ("decode", 1, False), ("decode", 3, True), ("sequential", 1, False),
    ("sequential", 3, True)])
def test_chain_rounded_rule_with_lc(route, B, rounded):
    """With LC both routes round the chain unless B == 1: JAX runs an LC
    run from a zero ring on kernel 1 or 2 (kernel 4 takes no LC), whose b1
    branch is the VPU chain."""
    assert ts.chain_rounded(route, B, lc=True) is rounded


def test_lc_w_takes_the_weights_type():
    """``lc_w`` is packed at the matmul weights' type, and a launch whose
    ``lc_w`` is of another type raises; the tiles kernel still has no LC
    mode at either type."""
    _, tc, _, tp, _ = _pair()
    pk16 = ts.pack_sampler_weights(tp, tc, 2, weight_dtype=BF16)
    ring, causal = ts.zero_state(tc, 2)
    x = torch.zeros((2, 1), dtype=torch.int32)
    stream = torch.zeros((4, 2, 3))
    mixed = pk16._replace(lc_w=pk16.lc_w.float())
    with pytest.raises(ValueError, match="lc_w"):
        ts.decode(mixed, tc, ring, causal, x, 4, 0, 0, lc=stream)
    with pytest.raises(NotImplementedError, match="step 2c"):
        ts.decode(pk16, tc, ring, causal, x, 4, 0, 0, lc=stream,
                  kernel="tiles")


@pytest.mark.parametrize("device,want", [
    ("cuda", "CUDA (prefill + sampler_cluster/sampler_decode kernel, bf16 "
             "weights, local conditioning)"),
    ("cpu", "PyTorch reference (prefill + decode_reference, bf16 weights, "
            "local conditioning)")])
def test_sampler_name_of_lc_bf16(device, want):
    from wavenet_torch import sampler_select as tsel
    assert tsel.sampler_name(torch.device(device), "bfloat16", True) == want


# ---------------------------------------------------------------------------
# The generate CLI at --sampler_precision bfloat16 with an LC file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lc_ckpt(tmp_path_factory):
    """A port checkpoint and params JSON of the SMALL LC gc config, and
    two 8-frame feature files at hop 3."""
    from wavenet_torch import train_lib as ttl

    tmp = tmp_path_factory.mktemp("torch_lc_bf16_generate")
    _, tc, _, tp, _ = _pair(True, key=11, out_scale=30.0)
    pfile = tmp / "m.json"
    pfile.write_text(json.dumps(dict(tc.to_json_dict(), sample_rate=2000,
                                     lc_channels=None)))
    ttl.save_checkpoint(str(tmp / "ckpt"), ttl.train_state_from_params(
        tp, ttl.make_optimizer("adam", 1e-3)))
    feats = []
    for seed in (3, 4):
        path = tmp / f"f{seed}.lc.npy"
        np.save(path, np.random.RandomState(seed).uniform(-2, 2, (8, 3))
                .astype(np.float32))
        feats.append(str(path))
    return dict(pfile=str(pfile), ckpt=str(tmp / "ckpt"), feats=feats,
                tmp=tmp)


def _cli(m, name, B, feats, extra, capsys):
    from wavenet_torch.cli import generate as tgen
    wav = m["tmp"] / f"{name}.wav"
    rc = tgen.main([m["ckpt"], "--wavenet_params", m["pfile"], "--samples",
                    "24", "--temperature", "1e-6", "--batch_size", str(B),
                    "--seed", "3", "--lc_file", feats,
                    "--sampler_precision", "bfloat16", "--device", "cpu",
                    "--wav_out_path", str(wav)] + LC_FLAGS + extra)
    assert rc == 0
    out = capsys.readouterr().out
    assert "bf16 weights" in out and "local conditioning" in out
    paths = ([str(wav)] if B == 1 else
             [str(m["tmp"] / f"{name}-{i}.wav") for i in range(B)])
    return np.stack([_codes_of(p, 32) for p in paths])


@pytest.mark.parametrize("B", [1, 2])
def test_cli_lc_bf16_runs_and_segments_equal_one_run(lc_ckpt, B, capsys):
    """``--lc_file ... --sampler_precision bfloat16``: a wav of the asked
    length per row, the sampler named with bf16 weights and local
    conditioning, and ``--save_every`` segments equal to the single
    run."""
    one = _cli(lc_ckpt, f"one{B}", B, lc_ckpt["feats"][0], [], capsys)
    assert one.shape == (B, 24)
    seg = _cli(lc_ckpt, f"seg{B}", B, lc_ckpt["feats"][0],
               ["--save_every", "9"], capsys)
    np.testing.assert_array_equal(seg, one)
    assert len(np.unique(one)) > 1


def test_cli_lc_bf16_stream_steers(lc_ckpt, capsys):
    """Another LC stream gives another waveform at bf16 weights."""
    runs = [_cli(lc_ckpt, f"steer{i}", 1, feats, [], capsys)
            for i, feats in enumerate(lc_ckpt["feats"])]
    assert not np.array_equal(runs[0], runs[1])
