"""bf16-weight generation of the port against the JAX package (CPU).

The JAX decode kernels at ``weight_dtype=bfloat16`` multiply bf16 weights
by activations rounded to bf16 (``x.astype(w_ref.dtype)`` before
``mxu_dot``), except on the prefill route at B = 1, whose VPU chain
multiplies float32 activations by the widened weights in the layer chain.
The port's ``decode_reference`` (the plain twin of the bf16 modes of
``sampler_cluster``, ``sampler_tiles`` and ``sampler_decode``) follows that
rule (``round_chain``). Each TPU kernel runs here in interpret mode on bf16
weights, and the port is teacher-forced on that run's codes: its logits
must equal the JAX kernel's at every step within rtol 1e-4, atol 1e-5,
the tolerance of tests/test_torch_sampler.py.

Also here: generation from a config whose ``compute_dtype`` is bfloat16
(float32 prefill and decode, as the JAX package), the bf16 rung of the
sampler ladder, the generate CLI at ``--sampler_precision bfloat16`` and
the route's rule that bf16 weights take the float32 mode's plans.
The kernels themselves are held against ``decode_reference`` on the card
in tests/test_torch_gpu.py and chip_smoke.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.kernels import sampler as js
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import sample as tsample
from wavenet_torch import sampler_select as tsel
from wavenet_torch.kernels import sampler as ts
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = torch.bfloat16

SMALL = dict(dilations=(1, 2, 4, 8), residual_channels=4,
             dilation_channels=4, skip_channels=8, quantization_channels=32)
RING_PACK = dict(dilations=(1, 2, 4, 8, 16, 32, 1, 2, 4, 8, 16, 32),
                 residual_channels=8, dilation_channels=8, skip_channels=16,
                 quantization_channels=64)
SCALAR = dict(SMALL, scalar_input=True, initial_filter_width=4)


def _pair(base, gc=False, key=0):
    """JAX and port configs and the same seeded params, biases non-zero."""
    d = dict(base)
    if gc:
        d.update(gc_channels=4, gc_cardinality=4)
    jc, tc = JConfig(**d), TConfig(**d)
    rng = np.random.RandomState(key)
    npp = {k: ((0.1 * rng.randn(*v.shape)).astype(np.float32)
               if k.endswith("_bias") else np.asarray(v))
           for k, v in sorted(jw.init_params(jax.random.PRNGKey(key),
                                             jc).items())}
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    return jc, tc, jp, params_from_numpy(npp, "cpu")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _replay(tc, tp, seed_codes, gc_ids, codes_jax, round_chain=None):
    """The port's bf16 prefill route teacher-forced on a JAX run's emitted
    codes: (codes, logits [B, n, Q])."""
    B, n = codes_jax.shape
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    carry = ts.prefill_carry(tp, tc, _t(seed_codes, torch.int32), gids)
    packed = ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids),
        weight_dtype=BF16)
    forced = torch.cat([carry.last[:, None],
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    return ts.decode_reference(
        packed, tc, carry.ring, carry.causal, forced.contiguous(), n,
        carry.t_abs, seed=0, collect_logits=True, round_chain=round_chain)


def _hold(tc, tp, seed_codes, gc_ids, codes_jax, logits_jax):
    codes, logits = _replay(tc, tp, seed_codes, gc_ids, codes_jax)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_jax), **TOL)
    np.testing.assert_array_equal(codes[:, :-1].numpy(),
                                  np.asarray(codes_jax)[:, :-1])


def _vmem_run(B, rng):
    """TPU kernel #1 at bf16 weights: (configs, params, seed codes, GC ids,
    codes, logits)."""
    jc, tc, jp, tp = _pair(SMALL, gc=True)
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 4))
    gc_ids = rng.randint(0, 4, (B,))
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=9, seed=3, batch_size=B,
        gc_ids=jnp.asarray(gc_ids), seed_codes=jnp.asarray(seed_codes),
        collect_logits=True, interpret=True, prefill=True,
        weight_dtype=jnp.bfloat16)
    return tc, tp, seed_codes, gc_ids, codes, logits


@pytest.mark.parametrize("B", [1, 3])
def test_matches_vmem_kernel_bf16(B, rng):
    """TPU kernel #1, ``_sampler_kernel``, at bf16 weights: its VPU chain
    at b1 (chain not rounded), its MXU chain at b3 (rounded)."""
    _hold(*_vmem_run(B, rng))


@pytest.mark.parametrize("B", [1, 3])
def test_swapped_b1_rule_misses_jax(B, rng):
    """The b1 rule is not vacuous: with the chain's rounding swapped
    (rounded at b1, float32 at b3) the logits miss the JAX kernel's by
    more than the tolerance."""
    tc, tp, seed_codes, gc_ids, codes, logits = _vmem_run(B, rng)
    _, swapped = _replay(tc, tp, seed_codes, gc_ids, codes,
                         round_chain=not ts.chain_rounded("decode", B))
    assert not np.allclose(swapped.numpy(), np.asarray(logits), **TOL)


@pytest.mark.parametrize("B", [1, 2, 16])
def test_matches_hbm_stream_kernel_bf16(B, rng):
    """TPU kernel #2, ``_sampler_kernel_hbm_stream``, at bf16 weights,
    through its resume path from a prefilled carry (the VPU chain at b1:
    the b1 packing carries its transposed weights; b16 has as many rows as
    a cluster of the tiles kernel's bf16 mode holds at b240)."""
    jc, tc, jp, tp = _pair(SMALL, gc=True, key=2)
    n = 11
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 6))
    gc_ids = rng.randint(0, 4, (B,))
    carry = js.prefill_carry(jp, jc, jnp.asarray(seed_codes),
                             jnp.asarray(gc_ids))
    packed = js.pack_sampler_weights(
        jp, jc, B, jw.embed_gc(jp, jc, jnp.asarray(gc_ids)),
        weight_dtype=jnp.bfloat16)
    assert (packed.layer_wT is not None) == (B == 1)
    T_pad = -(-n // js._IO_CHUNK) * js._IO_CHUNK
    forced = jnp.zeros((T_pad, 128), jnp.int32).at[0, 0:B].set(carry.last)
    with pltpu.force_tpu_interpret_mode():
        codes, logits, _, _ = js._run_sampler_kernel_hbm_stream(
            packed, forced, jnp.asarray([5, carry.t_abs], jnp.int32),
            carry.ring, carry.causal, jc, n, 1, B, 1.0, True, resume=True)
    _hold(tc, tp, seed_codes, gc_ids, codes, jnp.moveaxis(logits, 0, 1))


def test_matches_packed_kernel_bf16(rng):
    """TPU kernel #3, ``_decode_kernel_packed`` (``ring_pack=True``), at
    bf16 weights and the configuration of tests/test_ring_pack.py."""
    jc, tc, jp, tp = _pair(RING_PACK)
    B = 8
    seed_codes = rng.randint(0, 64, (B, jc.receptive_field + 3))
    codes, logits = js.generate_pallas(
        jp, jc, 11, seed=3, batch_size=B, seed_codes=jnp.asarray(seed_codes),
        prefill=True, ring_pack=True, collect_logits=True, interpret=True,
        weight_dtype=jnp.bfloat16)
    _hold(tc, tp, seed_codes, None, codes, logits)


@pytest.mark.parametrize("variant,B", [("gc", 1), ("gc", 2), ("scalar", 2)])
def test_matches_hbm_ring_kernel_bf16(variant, B, rng):
    """TPU kernel #4, ``_sampler_kernel_hbm`` (``ring_in_hbm=True``), at
    bf16 weights: the forced prefix from a zero ring, then sampled steps;
    it rounds the chain at every B (no b1 branch), as
    ``decode_sequential`` does."""
    base = SCALAR if variant == "scalar" else SMALL
    jc, tc, jp, tp = _pair(base, gc=variant == "gc", key=5)
    T = jc.receptive_field + 5
    if variant == "scalar":
        seed_codes = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    else:
        seed_codes = rng.randint(0, 32, (B, T))
    gc_ids = np.array([1, 3])[:B] if variant == "gc" else None
    n_samples = 9
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=n_samples, seed=3, batch_size=B,
        gc_ids=None if gc_ids is None else jnp.asarray(gc_ids),
        seed_codes=jnp.asarray(seed_codes), collect_logits=True,
        interpret=True, ring_in_hbm=True, weight_dtype=jnp.bfloat16)
    codes = _t(codes, torch.int32)
    dtype = ts.input_dtype(tc)
    nxt = (ts.decode_amp(codes[:, :-1], tc.quantization_channels)
           if tc.scalar_input else codes[:, :-1])
    forced = torch.cat([_t(seed_codes, dtype), nxt.to(dtype)], dim=1)
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    packed = ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids),
        weight_dtype=BF16)
    n_forced = seed_codes.shape[1]
    got_codes, got = ts.decode_sequential(
        packed, tc, forced.contiguous(), n_forced - 1 + n_samples, 0,
        collect_logits=True)
    np.testing.assert_array_equal(got_codes[:, n_forced - 1:-1].numpy(),
                                  codes[:, :-1].numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)


def test_bf16_is_not_float32(rng):
    """bf16 weights move the logits by far more than the tolerance (the
    comparisons above are not float32 ones in disguise), and by less than
    a few bf16 steps of their scale."""
    jc, tc, jp, tp = _pair(SMALL, gc=True)
    B = 3
    seed_codes = _t(rng.randint(0, 32, (B, jc.receptive_field + 4)),
                    torch.int32)
    ids = _t([0, 2, 3], torch.int64)
    out = {}
    for wt in (torch.float32, BF16):
        carry = ts.prefill_carry(tp, tc, seed_codes, ids)
        packed = ts.pack_sampler_weights(tp, tc, B, tw.embed_gc(tp, tc, ids),
                                         weight_dtype=wt)
        out[wt] = ts.decode_reference(
            packed, tc, carry.ring, carry.causal, carry.last[:, None], 9,
            carry.t_abs, 1, collect_logits=True)[1]
    gap = (out[BF16] - out[torch.float32]).abs().max().item()
    scale = out[torch.float32].abs().max().item()
    assert 1e-4 * scale < gap < 0.1 * scale


# ---------------------------------------------------------------------------
# Generation from a config that computes in bf16
# ---------------------------------------------------------------------------

def _bf16_config(c):
    return dataclasses.replace(c, compute_dtype="bfloat16")


def test_prefill_carry_of_bf16_config_matches_jax(rng):
    """``prefill_carry`` of a bf16 config is the float32 config's, bitwise,
    and JAX's (which forces the config to float32, ``cfg32``)."""
    jc, tc, jp, tp = _pair(SMALL, gc=True)
    codes = rng.randint(0, 32, (2, jc.receptive_field + 7))
    ids = np.array([1, 3])
    got = ts.prefill_carry(tp, _bf16_config(tc), _t(codes, torch.int32),
                           _t(ids, torch.int64))
    f32 = ts.prefill_carry(tp, tc, _t(codes, torch.int32),
                           _t(ids, torch.int64))
    ref = js.prefill_carry(jp, _bf16_config(jc), jnp.asarray(codes),
                           jnp.asarray(ids))
    assert torch.equal(got.ring, f32.ring)
    assert torch.equal(got.causal, f32.causal)
    np.testing.assert_allclose(
        got.ring.numpy(),
        np.asarray(ref.ring)[:, :, :tc.residual_channels], **TOL)
    np.testing.assert_allclose(got.causal.numpy(), np.asarray(ref.causal),
                               **TOL)
    assert got.t_abs == ref.t_abs


@pytest.mark.parametrize("weight_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("prefill", [True, False])
def test_generate_cuda_of_bf16_config_equals_float32(weight_dtype, prefill):
    """``generate_cuda`` on CPU tensors from a bf16 config: the float32
    config's codes, bitwise, at either weight type and on either route."""
    _, tc, _, tp = _pair(SMALL, gc=True)
    kw = dict(batch_size=2, gc_ids=torch.tensor([0, 3]),
              weight_dtype=weight_dtype, prefill=prefill)
    ref = ts.generate_cuda(tp, tc, 16, 7, **kw)
    got = ts.generate_cuda(tp, _bf16_config(tc), 16, 7, **kw)
    assert torch.equal(got, ref)


def test_scan_sampler_of_bf16_config_equals_float32():
    """The scan sampler ignores ``compute_dtype``, as the JAX one does."""
    _, tc, _, tp = _pair(SMALL, gc=True)
    run = [tsample.generate(tp, c, 12, torch.Generator().manual_seed(4),
                            batch_size=2, gc_ids=torch.tensor([1, 2]))
           for c in (tc, _bf16_config(tc))]
    assert torch.equal(run[0], run[1])


def test_service_of_bf16_config_equals_float32(tmp_path):
    """The server's generation from a bf16 config: the float32 config's."""
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService

    _, tc, _, tp = _pair(SMALL)
    npz, pfile = tmp_path / "m.npz", tmp_path / "m.json"
    save_npz(str(npz), tp)
    pfile.write_text(json.dumps(dict(tc.to_json_dict(), sample_rate=2000)))
    service = GenerationService(str(npz), str(pfile), warm_samples=0,
                                device="cpu")
    ref = service.generate_batch(20, batch=2, seed=5)
    service.config = _bf16_config(service.config)
    assert np.array_equal(service.generate_batch(20, batch=2, seed=5), ref)


# ---------------------------------------------------------------------------
# The ladder, the route and the generate CLI at bf16
# ---------------------------------------------------------------------------

def test_sampler_attempts_bf16():
    tc = TConfig(**SMALL)
    (name, kw), = tsel.sampler_attempts(tc, precision="bfloat16")
    assert kw == {"prefill": True, "weight_dtype": BF16} and "bf16" in name
    (name, kw), = tsel.sampler_attempts(tc, "pallas", "bfloat16",
                                        torch.device("cpu"))
    assert kw["weight_dtype"] == BF16 and "decode_reference" in name
    assert tsel.sampler_attempts(tc, "scan", "bfloat16") == []


@pytest.mark.parametrize("route,B,rounded", [
    ("decode", 1, False), ("decode", 2, True), ("decode", 512, True),
    ("sequential", 1, True), ("sequential", 64, True)])
def test_chain_rounded_rule(route, B, rounded):
    """The one rule for the layer chain's rounding: the prefill route
    (``decode``) rounds unless B == 1, kernel 4's route at every B."""
    assert ts.chain_rounded(route, B) is rounded


def test_chain_rounded_refuses_unknown_route():
    with pytest.raises(ValueError, match="route"):
        ts.chain_rounded("tiles", 2)


@pytest.mark.parametrize("fault_row", [None, 0, 7])
def test_bf16_hold_catches_one_row_fault(fault_row, rng):
    """``kernels.bf16_hold``, which holds the bf16 kernels on the card, run
    here with the plain version standing in for the kernel: a sound run
    passes; one row of eight on the swapped chain rule (a fault of one
    cluster's or one row block's rows) fails by that row's median of its
    logits or of its ring values, as the callers hold both, where the
    whole's median alone would pass it."""
    from wavenet_torch.kernels import bf16_hold
    _, tc, _, tp = _pair(SMALL, gc=True)
    B = 8
    gids = torch.as_tensor(rng.randint(0, 4, (B,)))
    codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 12)), torch.int32)
    carry = ts.prefill_carry(tp, tc, codes[:, :-11], gids)
    emb = tw.embed_gc(tp, tc, gids)
    pk32 = ts.pack_sampler_weights(tp, tc, B, emb)
    pk16 = ts.pack_sampler_weights(tp, tc, B, emb, weight_dtype=BF16)

    def launch(ring, causal, x, t):
        r2, c2 = ring.clone(), causal.clone()
        lg = ts.decode_reference(pk16, tc, ring, causal, x, 1, t, 0,
                                 collect_logits=True)[1]
        if fault_row is not None:
            lg2 = ts.decode_reference(pk16, tc, r2, c2, x, 1, t, 0,
                                      collect_logits=True,
                                      round_chain=False)[1]
            lg[fault_row] = lg2[fault_row]
            ring[:, fault_row] = r2[:, fault_row]
        return lg

    forced = codes[:, -12:].contiguous()
    lg, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
        tc, pk16, pk32, carry.ring.clone(), carry.causal.clone(), forced,
        carry.t_abs, 0, ts.chain_rounded("decode", B), launch)
    assert lg.shape == (B, 12, 32) and rk.shape[0] == B
    if fault_row is None:
        assert bf16_hold.hold("sound", lg, lg16, lg32)["max_abs_err"] == 0
        bf16_hold.hold("sound ring", rk, r16, r32)
        return
    for got, ref, ref32 in ((lg, lg16, lg32), (rk, r16, r32)):
        err, gap = (got - ref).abs(), (ref - ref32).abs()
        assert err.median() <= bf16_hold.MEDIAN_RATIO * gap.median()
    with pytest.raises(AssertionError, match=rf"rows \[{fault_row}\]"):
        bf16_hold.hold("fault", lg, lg16, lg32)
        bf16_hold.hold("fault ring", rk, r16, r32)


def test_hold_as_plain_rejects_float32_weights(rng):
    """``kernels.bf16_hold.hold_as_plain``, the rule of the chain rounded at
    many wide layers, run here with plain versions standing in for the
    kernel: float32 weights planted in the bf16 mode lie bf16's whole gap
    from the plain bf16 version (every ratio 1), and the hold rejects
    them, even beside a plain version that lies as far from itself; the
    plain bf16 version itself passes."""
    from wavenet_torch.kernels import bf16_hold
    _, tc, _, tp = _pair(SMALL, gc=True)
    B = 8
    rc = ts.chain_rounded("decode", B)
    assert rc
    gids = torch.as_tensor(rng.randint(0, 4, (B,)))
    codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 12)), torch.int32)
    carry = ts.prefill_carry(tp, tc, codes[:, :-11], gids)
    emb = tw.embed_gc(tp, tc, gids)
    pk32 = ts.pack_sampler_weights(tp, tc, B, emb)
    pk16 = ts.pack_sampler_weights(tp, tc, B, emb, weight_dtype=BF16)
    forced = codes[:, -12:].contiguous()

    def run(pk):
        def launch(ring, causal, x, t):
            return ts.decode_reference(pk, tc, ring, causal, x, 1, t, 0,
                                       collect_logits=True,
                                       round_chain=rc)[1]
        got = bf16_hold.stepwise(tc, pk16, pk32, carry.ring.clone(),
                                 carry.causal.clone(), forced, carry.t_abs,
                                 0, rc, launch)
        return bf16_hold.ratios(*got[:3]), bf16_hold.ratios(*got[3:])

    for planted in run(pk32):
        for k in ("median_ratio", "row_median_ratio", "mean_ratio"):
            assert planted[k] == pytest.approx(1.0), k
        for plain in (planted, {k: 0.0 for k in planted}):
            with pytest.raises(AssertionError, match="past their limits"):
                bf16_hold.hold_as_plain("planted", planted, plain)
    for sound in run(pk16):
        assert sound["max_abs_err"] == 0
        bf16_hold.hold_as_plain("sound", sound, {k: 0.0 for k in sound})


# An H100 SXM: opt-in shared memory per block and resident clusters (those
# of tests/test_torch_sampler_tiles.py).
H100_SMEM = 232448


def _h100_resident(cs, rb, nbytes):
    return {8: 15, 16: 7}[cs]


@pytest.mark.parametrize("B", [1, 64, 120, 121, 128, 512, 525])
def test_tile_plan_takes_no_bf16_and_cluster_plan_is_unchanged(B):
    """bf16 b121-b525 runs ``sampler_tiles``' bf16 mode on the float32
    plan: ``tile_plan`` at bf16 weights returns the float32 plan there and
    None where the cluster kernel runs; ``cluster_plan`` takes no weight
    type, so b1-b120 keep the cluster kernel at bf16 with the float32
    mode's plan. Another weight type has no plan."""
    from wavenet_torch.models.config import gc_config
    c = gc_config()
    args = (c, B, H100_SMEM, _h100_resident, _h100_resident)
    plan32 = ts.tile_plan(*args)
    assert (plan32 is not None) == (B > 120)
    assert ts.tile_plan(*args, weight_dtype=BF16) == plan32
    assert ts.tile_plan(*args, weight_dtype=torch.float16) is None
    plan = ts.cluster_plan(c, B, H100_SMEM, _h100_resident)
    assert (plan is not None) == (B <= 120)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A port checkpoint and params JSON of the SMALL gc config."""
    from wavenet_torch import train_lib as ttl
    tmp = tmp_path_factory.mktemp("torch_sampler_bf16")
    _, tc, _, tp = _pair(SMALL, gc=True, key=11)
    pfile = tmp / "m.json"
    pfile.write_text(json.dumps(dict(tc.to_json_dict(), sample_rate=2000)))
    ttl.save_checkpoint(str(tmp / "ckpt"), ttl.train_state_from_params(
        tp, ttl.make_optimizer("adam", 1e-3)))
    return str(pfile), str(tmp / "ckpt"), tc, tp, tmp


def _codes_of(path, Q):
    """The mu-law codes a written wav holds (nearest decoded level)."""
    from scipy.io import wavfile
    from wavenet_torch.audio import mu_law_decode_np
    levels = np.clip(mu_law_decode_np(np.arange(Q), Q), -1, 1) * 32767.0
    _, x = wavfile.read(path)
    return np.abs(x.astype(np.float64)[..., None] - levels).argmin(-1)


def _cli(model, name, B, extra):
    from wavenet_torch.cli import generate as tgen
    pfile, ckpt, tc, _, tmp = model
    wav = tmp / f"{name}.wav"
    rc = tgen.main([ckpt, "--wavenet_params", pfile, "--samples", "24",
                    "--temperature", "1e-6", "--batch_size", str(B),
                    "--seed", "3", "--gc_channels", "4",
                    "--gc_cardinality", "4", "--gc_id", "2",
                    "--sampler_precision", "bfloat16", "--device", "cpu",
                    "--wav_out_path", str(wav)] + extra)
    assert rc == 0
    if B == 1:
        return _codes_of(str(wav), tc.quantization_channels)[None]
    return np.stack([_codes_of(str(tmp / f"{name}-{i}.wav"),
                               tc.quantization_channels) for i in range(B)])


@pytest.mark.parametrize("B", [1, 2])
def test_cli_sampler_precision_bfloat16(model, B, capsys):
    """``--sampler_precision bfloat16``: the codes of
    ``generate_cuda(weight_dtype=bfloat16)``, and its ``--save_every``
    segments equal the single run."""
    _, _, tc, tp, _ = model
    ref = ts.generate_cuda(tp, tc, 24, 3, batch_size=B,
                           gc_ids=torch.full((B,), 2), temperature=1e-6,
                           weight_dtype=BF16).numpy()
    one = _cli(model, f"one{B}", B, [])
    assert "bf16 weights" in capsys.readouterr().out
    np.testing.assert_array_equal(one, ref)
    seg = _cli(model, f"seg{B}", B, ["--save_every", "10"])
    assert "bf16 weights" in capsys.readouterr().out
    np.testing.assert_array_equal(seg, one)
