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
    for name in ts.PackedSampler._fields:
        np.testing.assert_allclose(getattr(tpk, name).numpy(),
                                   np.asarray(getattr(jpk, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    assert ts.ring_offsets(tc) == js.ring_offsets(jc)
    with pytest.raises(NotImplementedError):
        ts.pack_sampler_weights(tp, tc, 3, weight_dtype=torch.bfloat16)


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
    with pytest.raises(NotImplementedError):
        ts.generate_cuda(tp, tc, 4, 0, weight_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        ts.unseeded_seed_codes(TConfig(**{**SMALL, "scalar_input": True}),
                               1, 0)

