"""wavenet_torch generation against the JAX package (CPU).

The port's ``decode_reference`` (the plain twin of the CUDA kernel
``sampler_decode``) is held against each TPU decode kernel on that
kernel's own inputs: the JAX kernel runs in interpret mode with
``collect_logits=True``, then the port is teacher-forced on the codes the
JAX run emitted, and its logits must equal the JAX kernel's at every
decode step (rtol 1e-4, atol 1e-5, the JAX kernel tests' tolerance).
Sampled codes cannot be compared across the two PRNGs.

The kernel itself is held against ``decode_reference`` on the card in
tests/test_torch_gpu.py and in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.kernels import sampler as js
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch.kernels import sampler as ts
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
RING_PACK = dict(dilations=(1, 2, 4, 8, 16, 32, 1, 2, 4, 8, 16, 32),
                 residual_channels=8, dilation_channels=8, skip_channels=16,
                 quantization_channels=64)


def _with_biases(params, seed):
    """The numpy param dict with seeded non-zero biases: ``init_params``
    sets every bias to 0, and a trained checkpoint's are not."""
    rng = np.random.RandomState(seed)
    return {k: ((0.1 * rng.randn(*v.shape)).astype(np.float32)
                if k.endswith("_bias") else v)
            for k, v in sorted(params.items())}


def _pair(base, gc=False, key=0):
    d = dict(base)
    if gc:
        d.update(gc_channels=4, gc_cardinality=4)
    jc, tc = JConfig(**d), TConfig(**d)
    npp = _with_biases({k: np.asarray(v) for k, v in
                        jw.init_params(jax.random.PRNGKey(key), jc).items()},
                       key)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    return jc, tc, jp, params_from_numpy(npp, "cpu")


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _replay(tc, tp, seed_codes, gc_ids, codes_jax, logits_jax):
    """Teacher-force the port on a JAX run's emitted codes; compare logits
    of every decode step."""
    B, n = codes_jax.shape
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    carry = ts.prefill_carry(tp, tc, _t(seed_codes, torch.int32), gids)
    packed = ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids))
    forced = torch.cat([carry.last[:, None],
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    codes, logits = ts.decode_reference(
        packed, tc, carry.ring, carry.causal, forced.contiguous(), n,
        carry.t_abs, seed=0, collect_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_jax), **TOL)
    np.testing.assert_array_equal(codes[:, :-1].numpy(),
                                  np.asarray(codes_jax)[:, :-1])


@pytest.mark.parametrize("B", [1, 3])
def test_matches_vmem_kernel_on_its_codes(B, rng):
    """TPU kernel #1, ``_sampler_kernel``: the prefilled VMEM decode that
    ``generate_pallas(prefill=True)`` takes at small B (the VPU chain at
    b1)."""
    jc, tc, jp, tp = _pair(SMALL, gc=True)
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 4))
    gc_ids = rng.randint(0, 4, (B,))
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=9, seed=3, batch_size=B,
        gc_ids=jnp.asarray(gc_ids), seed_codes=jnp.asarray(seed_codes),
        collect_logits=True, interpret=True, prefill=True)
    _replay(tc, tp, seed_codes, gc_ids, codes, logits)


def test_matches_hbm_stream_kernel_on_its_codes(rng):
    """TPU kernel #2, ``_sampler_kernel_hbm_stream``, through its resume
    path from a prefilled carry."""
    jc, tc, jp, tp = _pair(SMALL, gc=True, key=2)
    B, n = 2, 11
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 6))
    gc_ids = rng.randint(0, 4, (B,))
    carry = js.prefill_carry(jp, jc, jnp.asarray(seed_codes),
                             jnp.asarray(gc_ids))
    packed = js.pack_sampler_weights(
        jp, jc, B, jw.embed_gc(jp, jc, jnp.asarray(gc_ids)))
    T_pad = -(-n // js._IO_CHUNK) * js._IO_CHUNK
    forced = jnp.zeros((T_pad, 128), jnp.int32).at[0, 0:B].set(carry.last)
    with pltpu.force_tpu_interpret_mode():
        codes, logits, _, _ = js._run_sampler_kernel_hbm_stream(
            packed, forced, jnp.asarray([5, carry.t_abs], jnp.int32),
            carry.ring, carry.causal, jc, n, 1, B, 1.0, True, resume=True)
    _replay(tc, tp, seed_codes, gc_ids, codes, jnp.moveaxis(logits, 0, 1))


def test_matches_packed_kernel_on_its_codes(rng):
    """TPU kernel #3, ``_decode_kernel_packed`` (``ring_pack=True``), at
    the configuration of tests/test_ring_pack.py."""
    jc, tc, jp, tp = _pair(RING_PACK)
    B = 8
    seed_codes = rng.randint(0, 64, (B, jc.receptive_field + 3))
    codes, logits = js.generate_pallas(
        jp, jc, 11, seed=3, batch_size=B, seed_codes=jnp.asarray(seed_codes),
        prefill=True, ring_pack=True, collect_logits=True, interpret=True)
    _replay(tc, tp, seed_codes, None, codes, logits)


def test_pack_sampler_weights_matches_jax(rng):
    jc, tc, jp, tp = _pair(SMALL, gc=True)
    ids = np.array([0, 3, 1])
    jpk = js.pack_sampler_weights(jp, jc, 3,
                                  jw.embed_gc(jp, jc, jnp.asarray(ids)))
    tpk = ts.pack_sampler_weights(tp, tc, 3,
                                  tw.embed_gc(tp, tc, _t(ids)))
    # A config without LC packs no lc_w in either package
    # (tests/test_torch_sampler_lc.py compares an LC config's).
    assert tpk.lc_w is None and jpk.lc_w is None
    for name in ts.KERNEL_FIELDS:
        np.testing.assert_allclose(getattr(tpk, name).numpy(),
                                   np.asarray(getattr(jpk, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    assert ts.ring_offsets(tc) == js.ring_offsets(jc)
    # bf16 weights as the JAX packer stores them; the adds stay float32.
    jpk = js.pack_sampler_weights(jp, jc, 3,
                                  jw.embed_gc(jp, jc, jnp.asarray(ids)),
                                  weight_dtype=jnp.bfloat16)
    tpk = ts.pack_sampler_weights(tp, tc, 3,
                                  tw.embed_gc(tp, tc, _t(ids)),
                                  weight_dtype=torch.bfloat16)
    for name in ts.KERNEL_FIELDS:
        j = np.asarray(getattr(jpk, name))
        t = getattr(tpk, name)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        np.testing.assert_allclose(t.float().numpy(), j.astype(np.float32),
                                   rtol=0, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("gc", [False, True])
@pytest.mark.parametrize("split", ["mid", "edge", "short"])
def test_prefill_carry_matches_jax(gc, split, rng):
    """The splits of tests/test_prefill.py."""
    jc, tc, jp, tp = _pair(SMALL, gc=gc)
    B = 2
    codes = rng.randint(0, 32, (B, jc.receptive_field + 9))
    P = {"mid": jc.receptive_field + 2, "edge": jc.receptive_field - 2,
         "short": 2}[split]
    ids = np.array([0, 3]) if gc else None
    ref = js.prefill_carry(jp, jc, jnp.asarray(codes[:, :P]),
                           None if ids is None else jnp.asarray(ids))
    got = ts.prefill_carry(tp, tc, _t(codes[:, :P], torch.int32),
                           None if ids is None else _t(ids))
    R = tc.residual_channels
    assert got.t_abs == ref.t_abs == P - 1
    assert got.ring.shape == (sum(tc.dilations), B, R)
    np.testing.assert_allclose(got.ring.numpy(),
                               np.asarray(ref.ring)[:, :, :R], **TOL)
    np.testing.assert_array_equal(got.causal.numpy(), np.asarray(ref.causal))
    np.testing.assert_array_equal(got.last.numpy(), np.asarray(ref.last))


def test_prefill_of_one_code_is_zero_state():
    _, tc, _, tp = _pair(SMALL)
    carry = ts.prefill_carry(tp, tc, torch.tensor([[5], [7]],
                                                  dtype=torch.int32))
    assert carry.t_abs == 0 and not carry.ring.any() and not carry.causal.any()


def test_ring_slot_blocks_matches_jax(rng):
    from wavenet_tpu.sample import ring_slot_blocks as jblocks
    from wavenet_torch.sample import ring_slot_blocks as tblocks
    dil = (1, 2, 4, 8)
    for T in (3, 8, 13):
        ins = [rng.randn(2, min(d, T), 3).astype(np.float32) for d in dil]
        ref = jblocks([jnp.asarray(x) for x in ins], dil, T)
        got = tblocks([torch.from_numpy(x) for x in ins], dil, T)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_philox_known_answers():
    """Random123 known answers for Philox4x32-10."""
    z = torch.zeros((), dtype=torch.int64)
    f = torch.full((), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(w) for w in ts.philox4x32((z, z, z, z), (0, 0))] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert [int(w) for w in ts.philox4x32((f, f, f, f),
                                          (0xFFFFFFFF, 0xFFFFFFFF))] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_gumbel_noise_is_per_row_and_step():
    a = ts.gumbel_noise(9, 4, 100, 6, 32)
    b = ts.gumbel_noise(9, 2, 103, 3, 32)
    assert a.shape == (6, 4, 32) and torch.isfinite(a).all()
    assert torch.equal(a[3:, :2], b)          # independent of B and t0 split
    assert not torch.equal(a, ts.gumbel_noise(10, 4, 100, 6, 32))


def test_teacher_forced_logits_match_forward(rng):
    """prefill=False drives the forced prefix through the decode too:
    every step's logits equal the parallel forward."""
    _, tc, _, tp = _pair(SMALL, gc=True)
    codes = _t(rng.randint(0, 32, (2, tc.receptive_field + 7)), torch.int32)
    gids = torch.tensor([1, 2])
    out, logits = ts.generate_cuda(tp, tc, 1, seed=0, batch_size=2,
                                   gc_ids=gids, seed_codes=codes,
                                   collect_logits=True, prefill=False)
    full = tw.forward_codes(tp, tc, codes, tw.embed_gc(tp, tc, gids))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **TOL)
    assert out.shape == (2, 1)
    # The same run through prefill: its one decode step is the last one.
    _, lg1 = ts.generate_cuda(tp, tc, 1, seed=0, batch_size=2, gc_ids=gids,
                              seed_codes=codes, collect_logits=True)
    np.testing.assert_allclose(lg1[:, 0].numpy(), full[:, -1].numpy(), **TOL)


def test_generation_is_deterministic_per_seed_and_in_range():
    _, tc, _, tp = _pair(SMALL)
    a = ts.generate_cuda(tp, tc, 24, seed=5, batch_size=3)
    b = ts.generate_cuda(tp, tc, 24, seed=5, batch_size=3)
    c = ts.generate_cuda(tp, tc, 24, seed=6, batch_size=3)
    assert a.shape == (3, 24) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= a.min().item() and a.max().item() < 32
    codes, lg = ts.generate_cuda(tp, tc, 24, seed=5, batch_size=3,
                                 collect_logits=4)
    assert torch.equal(codes, a) and lg.shape == (3, 4, 32)


def test_decode_resumes_in_place(rng):
    """Two decode calls chained through the in-place ring and causal
    state equal one call (the ring phase follows the absolute step)."""
    _, tc, _, tp = _pair(SMALL)
    seed = _t(rng.randint(0, 32, (2, 20)), torch.int32)
    carry = ts.prefill_carry(tp, tc, seed)
    packed = ts.pack_sampler_weights(tp, tc, 2)
    one_ring, one_causal = carry.ring.clone(), carry.causal.clone()
    one, lg_one = ts.decode(packed, tc, one_ring, one_causal,
                            carry.last[:, None], 10, carry.t_abs, 4,
                            collect_logits=True)
    forced = torch.cat([carry.last[:, None], one], dim=1).contiguous()
    ring, causal = carry.ring.clone(), carry.causal.clone()
    _, lg_a = ts.decode(packed, tc, ring, causal, forced[:, :5], 4,
                        carry.t_abs, 4, collect_logits=True)
    _, lg_b = ts.decode(packed, tc, ring, causal, forced[:, 4:].contiguous(),
                        6, carry.t_abs + 4, 4, collect_logits=True)
    np.testing.assert_allclose(torch.cat([lg_a, lg_b], 1).numpy(),
                               lg_one.numpy(), **TOL)
    np.testing.assert_allclose(ring.numpy(), one_ring.numpy(), **TOL)
    assert torch.equal(causal, one_causal)


def test_unported_paths_raise():
    _, tc, _, tp = _pair(SMALL)
    with pytest.raises(NotImplementedError):
        ts.generate_cuda(tp, TConfig(**{**SMALL, "filter_width": 3}), 4, 0)
    # bf16 weights decode (tests/test_torch_sampler_bf16.py) on every
    # kernel, the tiles kernel pinned included: on the CPU that is the
    # plain version, decode_reference, on either route.
    packed = ts.pack_sampler_weights(tp, tc, 1, weight_dtype=torch.bfloat16)
    forced = torch.zeros((1, 1), dtype=torch.int32)
    ring, causal = ts.zero_state(tc, 1)
    got = ts.decode(packed, tc, ring, causal, forced, 4, 0, 0, kernel="tiles",
                    collect_logits=True)
    ring_r, causal_r = ts.zero_state(tc, 1)
    ref = ts.decode_reference(packed, tc, ring_r, causal_r, forced, 4, 0, 0,
                              collect_logits=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(ring, ring_r) and torch.equal(causal, causal_r)
    got = ts.decode_sequential(packed, tc, forced, 4, 0, kernel="tiles",
                               collect_logits=True)
    ring_r, causal_r = ts.zero_state(tc, 1)
    ref = ts.decode_reference(packed, tc, ring_r, causal_r, forced, 4, 0, 0,
                              collect_logits=True, round_chain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # LC decodes at either weight type (tests/test_torch_sampler_lc.py,
    # tests/test_torch_sampler_lc_bf16.py), but not on a pinned tiles
    # kernel.
    lc_c = TConfig(**{**SMALL, "lc_channels": 2})
    lc_p = tw.init_params(0, lc_c, device="cpu")
    assert ts.generate_cuda(lc_p, lc_c, 4, 0, lc=torch.zeros(1, 4, 2),
                            weight_dtype=torch.bfloat16).shape == (1, 4)
    lc_packed = ts.pack_sampler_weights(lc_p, lc_c, 1,
                                        weight_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.decode(lc_packed, lc_c, *ts.zero_state(lc_c, 1), forced, 4, 0, 0,
                  kernel="tiles", lc=torch.zeros(4, 1, 2))


# ---------------------------------------------------------------------------
# Scalar input, and TPU kernel #4 (the single-pass HBM-ring kernel)
# ---------------------------------------------------------------------------

SCALAR = dict(SMALL, scalar_input=True, initial_filter_width=4)


def test_unseeded_seed_codes_scalar_is_silence():
    tc = TConfig(**SCALAR)
    got = ts.unseeded_seed_codes(tc, 3, 7)
    ref = js.unseeded_seed_codes(JConfig(**SCALAR), 3, 7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _sequential_replay(jc, tc, jp, tp, seed_codes, gc_ids, n_samples,
                       collect, **route):
    """TPU kernel run by ``generate_pallas(prefill=False, **route)`` in
    interpret mode, then the port's sequential route teacher-forced on the
    inputs that run fed itself; returns (JAX logits, port logits)."""
    B = seed_codes.shape[0]
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=n_samples, seed=3, batch_size=B,
        gc_ids=None if gc_ids is None else jnp.asarray(gc_ids),
        seed_codes=jnp.asarray(seed_codes), collect_logits=collect,
        interpret=True, **route)
    codes = _t(codes, torch.int32)
    dtype = ts.input_dtype(tc)
    nxt = (ts.decode_amp(codes[:, :-1], tc.quantization_channels)
           if tc.scalar_input else codes[:, :-1])
    forced = torch.cat([_t(seed_codes, dtype), nxt.to(dtype)], dim=1)
    packed = ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids))
    n_forced = seed_codes.shape[1]
    got_codes, got = ts.decode_sequential(
        packed, tc, forced.contiguous(), n_forced - 1 + n_samples, 0,
        collect_logits=collect)
    np.testing.assert_array_equal(got_codes[:, n_forced - 1:-1].numpy(),
                                  codes[:, :-1].numpy())
    return np.asarray(logits), got.numpy()


@pytest.mark.parametrize("variant", ["mulaw", "gc", "scalar"])
def test_matches_hbm_ring_kernel_on_its_codes(variant, rng):
    """TPU kernel #4, ``_sampler_kernel_hbm`` (``ring_in_hbm=True``): the
    forced prefix stepped from a zero ring, then sampled steps; every
    step's logits (the twins of test_hbm_ring_matches_forward and
    test_hbm_ring_variants)."""
    base = SCALAR if variant == "scalar" else SMALL
    jc, tc, jp, tp = _pair(base, gc=variant == "gc", key=5)
    B = 3 if variant == "mulaw" else 2
    T = jc.receptive_field + 5
    if variant == "scalar":
        seed_codes = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    else:
        seed_codes = rng.randint(0, 32, (B, T))
    gc_ids = np.array([1, 3]) if variant == "gc" else None
    ref, got = _sequential_replay(jc, tc, jp, tp, seed_codes, gc_ids, 9,
                                  True, ring_in_hbm=True)
    np.testing.assert_allclose(got, ref, **TOL)


def test_hbm_ring_windowed_logits_match_full(rng):
    """A window of the last W steps' logits (twin of
    test_windowed_logits_hbm_ring): against the TPU kernel's window, and
    equal to the tail of the port's full collection."""
    jc, tc, jp, tp = _pair(SMALL)
    B, W = 2, 5
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 11))
    ref, got = _sequential_replay(jc, tc, jp, tp, seed_codes, None, 4, W,
                                  ring_in_hbm=True)
    np.testing.assert_allclose(got, ref, **TOL)
    full = ts.generate_cuda(tp, tc, 4, seed=1, batch_size=B,
                            seed_codes=_t(seed_codes), collect_logits=True,
                            prefill=False)[1]
    win = ts.generate_cuda(tp, tc, 4, seed=1, batch_size=B,
                           seed_codes=_t(seed_codes), collect_logits=W,
                           prefill=False)[1]
    assert win.shape == (B, W, 32)
    assert torch.equal(win, full[:, -W:])


def test_scalar_matches_vmem_kernel_on_its_codes(rng):
    """Scalar mode of TPU kernel #1 (``_sampler_kernel``, the twin of
    test_scalar_input_pallas_matches_forward), and every teacher-forced
    step against the JAX ``forward``."""
    jc, tc, jp, tp = _pair(SCALAR, key=4)
    B, T = 2, jc.receptive_field + 6
    audio = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    ref, got = _sequential_replay(jc, tc, jp, tp, audio, None, 7, True)
    np.testing.assert_allclose(got, ref, **TOL)
    full = jw.forward(jp, jc, jnp.asarray(audio)[..., None])
    np.testing.assert_allclose(got[:, :T], np.asarray(full), **TOL)


@pytest.mark.parametrize("split", ["mid", "edge", "short"])
def test_scalar_prefill_carry_matches_jax(split, rng):
    jc, tc, jp, tp = _pair(SCALAR, key=1)
    B = 2
    audio = rng.uniform(-1, 1, (B, jc.receptive_field + 9)).astype(np.float32)
    P = {"mid": jc.receptive_field + 2, "edge": jc.receptive_field - 2,
         "short": 2}[split]
    ref = js.prefill_carry(jp, jc, jnp.asarray(audio[:, :P]))
    got = ts.prefill_carry(tp, tc, _t(audio[:, :P]))
    R = tc.residual_channels
    assert got.t_abs == ref.t_abs == P - 1
    assert got.causal.shape == (B, tc.initial_filter_width - 1)
    np.testing.assert_allclose(got.ring.numpy(),
                               np.asarray(ref.ring)[:, :, :R], **TOL)
    np.testing.assert_array_equal(got.causal.numpy(), np.asarray(ref.causal))
    np.testing.assert_array_equal(got.last.numpy(), np.asarray(ref.last))


def test_scalar_prefill_decode_matches_forward(rng):
    """The prefill route in scalar mode: prefill the seed, then decode the
    rest teacher-forced; every decoded step equals the JAX forward."""
    jc, tc, jp, tp = _pair(SCALAR, key=2)
    B, T = 2, jc.receptive_field + 12
    audio = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    P = jc.receptive_field + 1
    carry = ts.prefill_carry(tp, tc, _t(audio[:, :P]))
    packed = ts.pack_sampler_weights(tp, tc, B)
    forced = _t(audio[:, P - 1:]).contiguous()
    _, logits = ts.decode(packed, tc, carry.ring, carry.causal, forced,
                          T - P + 1, carry.t_abs, 0, collect_logits=True)
    full = np.asarray(jw.forward(jp, jc, jnp.asarray(audio)[..., None]))
    np.testing.assert_allclose(logits.numpy(), full[:, P - 1:], **TOL)


def test_wide_shaped_params_cross_packages(rng):
    """``params_from_numpy`` carries a parameter set of the wide config's
    shapes (R=D=64, S=1024, scalar input, 32-tap causal layer; three
    layers) across: the port's prefill + decode equals the JAX forward."""
    d = dict(dilations=(1, 2, 4), residual_channels=64, dilation_channels=64,
             skip_channels=1024, quantization_channels=256,
             scalar_input=True, initial_filter_width=32)
    jc, tc, jp, tp = _pair(d, key=6)
    assert tp["causal_filter"].shape == (32, 1, 64)
    B, T = 2, jc.receptive_field + 4
    audio = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    _, logits = ts.generate_cuda(tp, tc, 1, seed=0, batch_size=B,
                                 seed_codes=_t(audio[:, :T - 3]),
                                 collect_logits=True)
    full = np.asarray(jw.forward(jp, jc, jnp.asarray(audio)[..., None]))
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, T - 4], **TOL)
    np.testing.assert_allclose(
        tw.forward(tp, tc, _t(audio)[..., None]).numpy(), full, **TOL)


# ---------------------------------------------------------------------------
# Resumable segments (generate_cuda_resumable)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scalar", [False, True])
def test_resumable_segments_equal_one_run(scalar, rng):
    """Two resumed segments == one long run from a zero ring, sample for
    sample, at an argmax temperature (the twin of
    test_resumable_stream_segments_equal_one_run)."""
    jc, tc, jp, tp = _pair(SCALAR if scalar else SMALL)
    B, rf = 2, tc.receptive_field
    seed_codes = _t(rng.uniform(-1, 1, (B, rf)).astype(np.float32)
                    if scalar else rng.randint(0, 32, (B, rf)))
    full = ts.generate_cuda(tp, tc, 20, seed=0, batch_size=B,
                            seed_codes=seed_codes, temperature=1e-6,
                            prefill=False)
    seg1, carry = ts.generate_cuda_resumable(
        tp, tc, 9, seed=0, batch_size=B, seed_codes=seed_codes,
        temperature=1e-6)
    seg2, carry = ts.generate_cuda_resumable(
        tp, tc, 11, seed=0, batch_size=B, temperature=1e-6, carry=carry)
    assert carry.t_abs == rf - 1 + 20
    assert torch.equal(torch.cat([seg1, seg2], dim=1), full)


def test_resumable_three_segments_equal_one_run_at_any_temperature(rng):
    """Three segments (twin of test_resumable_stream_three_segments);
    the noise is keyed on the absolute step, so at temperature 1 too they
    are bitwise the prefill route's single run."""
    _, tc, _, tp = _pair(SMALL, key=1)
    seed_codes = _t(rng.randint(0, 32, (1, tc.receptive_field)))
    for temperature in (1e-6, 1.0):
        full = ts.generate_cuda(tp, tc, 18, seed=4, seed_codes=seed_codes,
                                temperature=temperature)
        outs, carry = [], None
        for n in (5, 6, 7):
            seg, carry = ts.generate_cuda_resumable(
                tp, tc, n, seed=4,
                seed_codes=seed_codes if carry is None else None,
                temperature=temperature, carry=carry)
            outs.append(seg)
        assert torch.equal(torch.cat(outs, dim=1), full)
    with pytest.raises(ValueError, match="first segment"):
        ts.generate_cuda_resumable(tp, tc, 2, seed=4, seed_codes=seed_codes,
                                   carry=carry)


@pytest.mark.parametrize("split", [3, 8])
def test_decode_next_amp_resumes_one_launch(split, rng):
    """``next_amp`` receives the input after a launch's last step (a forced
    amplitude when the launch ends inside the forced prefix, else the
    decoded last code); a launch resumed from it continues the long one."""
    _, tc, _, tp = _pair(SCALAR, key=3)
    B, n_total = 2, 14
    packed = ts.pack_sampler_weights(tp, tc, B)
    forced = _t(rng.uniform(-1, 1, (B, 6)).astype(np.float32))
    ring, causal = ts.zero_state(tc, B)
    full, _ = ts.decode(packed, tc, ring, causal, forced, n_total, 0, 9)
    ring, causal = ts.zero_state(tc, B)
    nxt = torch.empty(B)
    head, _ = ts.decode(packed, tc, ring, causal, forced, split, 0, 9,
                        next_amp=nxt)
    want = (forced[:, split] if split < forced.shape[1]
            else ts.decode_amp(head[:, -1], tc.quantization_channels))
    assert torch.equal(nxt, want)
    rest = torch.cat([nxt[:, None], forced[:, split + 1:]], dim=1)
    tail, _ = ts.decode(packed, tc, ring, causal, rest.contiguous(),
                        n_total - split, split, 9)
    assert torch.equal(torch.cat([head, tail], dim=1), full)
