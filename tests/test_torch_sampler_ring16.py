"""The bf16 ring, the port against the JAX package (CPU): TPU kernels 1-3
at ``state_dtype=bfloat16``.

The JAX decode kernels keep their ring of past layer inputs at the state
dtype: each layer reads its past row widened to float32 and stores the
layer's float32 input rounded to bf16 ("past values requantize on store");
the step's own input enters ``[past | current]`` unrounded, and the causal
register and every sum stay float32. The port's ``decode_reference`` on a
bf16 ring (the plain twin of the bf16-ring modes of ``sampler_cluster``,
``sampler_tiles`` and ``sampler_decode``) computes the same. Each TPU
kernel runs here in interpret mode at a bf16 ring, and the port is
teacher-forced on that run's codes through its own entry points: its
logits must equal the JAX kernel's at every step within rtol 1e-4, atol
1e-5 (the tolerance of tests/test_torch_sampler.py), its codes JAX's but
the last.

Where JAX applies the bf16 ring: kernel 1 from a zero ring
(``generate_pallas(prefill=False)``), kernel 2 through its resume path and
from a zero ring (``ring_in_hbm=True, stream_io=True``), and kernel 3
(``ring_pack=True``). JAX's prefill route first tries its all-VMEM kernel
at a float32 ring whatever ``state_dtype`` says (a TPU VMEM budget
choice); the port applies ``state_dtype`` on every route. On the
sequential route a bf16 ring runs as JAX's kernels 1 and 2 from a zero
ring, whose b1 branch keeps the chain float32 at bf16 weights
(``chain_rounded(..., ring16=True)``), not as kernel 4, which takes no
state dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_sampler import RING_PACK, SMALL, TOL, _pair, _t
from test_torch_sampler_bf16 import SCALAR
from test_torch_sampler_lc import _case, _jx, _port_streams
from test_torch_sampler_lc import _pair as _lc_pair
from wavenet_tpu import sample as jsample
from wavenet_tpu.kernels import sampler as js
from wavenet_tpu.models import wavenet as jw
from wavenet_torch.kernels import sampler as ts
from wavenet_torch.models import wavenet as tw

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

BF16 = torch.bfloat16
WEIGHTS = {"f32": (torch.float32, jnp.float32),
           "bf16": (BF16, jnp.bfloat16)}


def _packed(tc, tp, B, gc_ids, wt):
    gids = None if gc_ids is None else _t(gc_ids, torch.int64)
    return ts.pack_sampler_weights(
        tp, tc, B, None if gids is None else tw.embed_gc(tp, tc, gids),
        weight_dtype=wt), gids


def _hold(replayed, codes_jax, logits_jax):
    """Logits of every replayed step against JAX's; the codes of every
    step but the last (whose draw the replay makes itself)."""
    codes, logits = replayed
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_jax), **TOL)
    np.testing.assert_array_equal(codes[:, :-1].numpy(),
                                  np.asarray(codes_jax)[:, :-1])


def _replay_sequential(tc, tp, seed_codes, gc_ids, codes_jax, wt,
                       state_dtype=BF16, stream=None):
    """``decode_sequential`` over a JAX run's inputs (the forced prefix,
    then JAX's sampled codes; scalar mode: their decoded amplitudes), from
    a zero ring of ``state_dtype``: (codes of the sampled steps, logits of
    every step)."""
    B, n_forced = seed_codes.shape
    n_total = n_forced - 1 + codes_jax.shape[1]
    packed, _ = _packed(tc, tp, B, gc_ids, wt)
    codes = _t(codes_jax, torch.int32)
    dtype = ts.input_dtype(tc)
    nxt = (ts.decode_amp(codes[:, :-1], tc.quantization_channels)
           if tc.scalar_input else codes[:, :-1])
    forced = torch.cat([_t(seed_codes, dtype), nxt.to(dtype)], dim=1)
    got_codes, logits = ts.decode_sequential(
        packed, tc, forced.contiguous(), n_total, 0, collect_logits=True,
        lc=stream, state_dtype=state_dtype)
    return got_codes[:, n_forced - 1:], logits


def _kernel1_run(B, wdt, rng, variant="gc"):
    """TPU kernel 1 (``generate_pallas(prefill=False)``) from a zero bf16
    ring: (configs, params, seed codes, GC ids, codes, logits of every
    step)."""
    base = SCALAR if variant == "scalar" else SMALL
    jc, tc, jp, tp = _pair(base, gc=variant == "gc", key=60 + B)
    T = jc.receptive_field + 4
    if variant == "scalar":
        seed_codes = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    else:
        seed_codes = rng.randint(0, 32, (B, T))
    gc_ids = rng.randint(0, 4, (B,)) if variant == "gc" else None
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=9, seed=3, batch_size=B, gc_ids=_jx(gc_ids),
        seed_codes=jnp.asarray(seed_codes), collect_logits=True,
        interpret=True, weight_dtype=WEIGHTS[wdt][1],
        state_dtype=jnp.bfloat16)
    return tc, tp, seed_codes, gc_ids, codes, logits


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel1_ring16_matches_on_its_codes(B, wdt, rng):
    """TPU kernel 1 (``_sampler_kernel``) from a zero bf16 ring, the
    forced prefix and the sampled steps in one launch, against
    ``decode_sequential(state_dtype=bfloat16)``; at bf16 weights its VPU
    chain at b1 (the chain float32), its MXU chain at b3 (rounded)."""
    tc, tp, seed_codes, gc_ids, codes, logits = _kernel1_run(B, wdt, rng)
    _hold(_replay_sequential(tc, tp, seed_codes, gc_ids, codes,
                             WEIGHTS[wdt][0]), codes, logits)


def test_kernel1_ring16_scalar_matches_on_its_codes(rng):
    """Scalar input (amplitudes in, mu-law codes out) on kernel 1 from a
    zero bf16 ring."""
    tc, tp, seed_codes, gc_ids, codes, logits = _kernel1_run(
        2, "f32", rng, variant="scalar")
    _hold(_replay_sequential(tc, tp, seed_codes, gc_ids, codes,
                             torch.float32), codes, logits)


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
def test_kernel1_ring16_lc_matches_on_its_codes(wdt, rng):
    """Local conditioning on kernel 1 from a zero bf16 ring: each step
    conditioned by its row of ``[lc_prime | lc]``."""
    jc, tc, jp, tp, _ = _lc_pair(True, key=70)
    B = 3
    seed_codes, gc_ids, lc, lc_prime = _case(rng, jc, B, 3, 8)
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=8, seed=4, batch_size=B, gc_ids=_jx(gc_ids),
        seed_codes=jnp.asarray(seed_codes), lc=jnp.asarray(lc),
        lc_prime=jnp.asarray(lc_prime), collect_logits=True, interpret=True,
        weight_dtype=WEIGHTS[wdt][1], state_dtype=jnp.bfloat16)
    lc_r, lc_p = _port_streams(tp, tc, lc, lc_prime, seed_codes.shape[1] - 1)
    stream = torch.cat([lc_p, lc_r], dim=1).transpose(0, 1).contiguous()
    _hold(_replay_sequential(tc, tp, seed_codes, gc_ids, codes,
                             WEIGHTS[wdt][0], stream=stream), codes, logits)


def _replay_resumed(tc, tp, seed_codes, gc_ids, codes_jax, wt, lc_r=None,
                    lc_p=None, state_dtype=BF16):
    """The port's prefill, its ring cast to ``state_dtype``, then
    ``decode_reference`` teacher-forced on JAX's decoded codes: (codes,
    logits of every decode step)."""
    B, n = codes_jax.shape
    packed, gids = _packed(tc, tp, B, gc_ids, wt)
    carry = ts.prefill_carry(tp, tc, _t(seed_codes, torch.int32), gids,
                             lc=lc_p)
    forced = torch.cat([carry.last[:, None],
                        _t(codes_jax, torch.int32)[:, :-1]], dim=1)
    return ts.decode_reference(
        packed, tc, carry.ring.to(state_dtype), carry.causal,
        forced.contiguous(), n, carry.t_abs, 0, collect_logits=True,
        lc=None if lc_r is None else lc_r.transpose(0, 1).contiguous())


def _kernel2_resumed_run(B, wdt, rng, lc=False):
    """TPU kernel 2 (``_sampler_kernel_hbm_stream``) through its resume
    path, fed the JAX prefill's ring cast to bf16 (as ``generate_pallas``
    casts it, ``sampler.py:963-964``): (configs, params, seed codes, GC
    ids, the port's refined LC streams or None, codes, logits)."""
    if lc:
        jc, tc, jp, tp, _ = _lc_pair(True, key=80 + B)
        seed_codes, gc_ids, lc_in, lp = _case(rng, jc, B, 6, 11)
        n_prime = seed_codes.shape[1] - 1
        lc_j = jw.maybe_refine_lc(jp, jc, jnp.asarray(lc_in))
        lp_j = jsample._lc_for_prime(lc_j, jw.maybe_refine_lc(
            jp, jc, jnp.asarray(lp)), n_prime)
        streams = _port_streams(tp, tc, lc_in, lp, n_prime)
        n = lc_in.shape[1]
    else:
        jc, tc, jp, tp = _pair(SMALL, gc=True, key=90 + B)
        n = 11
        seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 6))
        gc_ids = rng.randint(0, 4, (B,))
        lp_j = lc_j = None
        streams = (None, None)
    carry = js.prefill_carry(jp, jc, jnp.asarray(seed_codes),
                             jnp.asarray(gc_ids), lc=lp_j)
    packed = js.pack_sampler_weights(
        jp, jc, B, jw.embed_gc(jp, jc, jnp.asarray(gc_ids)),
        weight_dtype=WEIGHTS[wdt][1])
    T_pad = -(-n // js._IO_CHUNK) * js._IO_CHUNK
    forced = jnp.zeros((T_pad, 128), jnp.int32).at[0, 0:B].set(carry.last)
    with pltpu.force_tpu_interpret_mode():
        codes, logits, _, _ = js._run_sampler_kernel_hbm_stream(
            packed, forced, jnp.asarray([5, carry.t_abs], jnp.int32),
            carry.ring.astype(jnp.bfloat16), carry.causal, jc, n, 1, B, 1.0,
            True, resume=True,
            lc_stream=None if lc_j is None else jnp.moveaxis(lc_j, 1, 0))
    return (tc, tp, seed_codes, gc_ids, streams, codes,
            jnp.moveaxis(logits, 0, 1))


@pytest.mark.parametrize("B,wdt", [(1, "bf16"), (2, "bf16"), (16, "bf16"),
                                   (2, "f32")])
def test_kernel2_resumed_ring16_matches_on_its_codes(B, wdt, rng):
    """TPU kernel 2's resume path from a prefilled ring cast to bf16 (the
    VPU chain at b1; b16 has as many rows as a cluster of the tiles
    kernel holds at b240)."""
    tc, tp, seed_codes, gc_ids, _, codes, logits = _kernel2_resumed_run(
        B, wdt, rng)
    _hold(_replay_resumed(tc, tp, seed_codes, gc_ids, codes,
                          WEIGHTS[wdt][0]), codes, logits)


def test_kernel2_resumed_ring16_lc_matches_on_its_codes(rng):
    """Local conditioning on kernel 2's resume path at a bf16 ring, the
    refined streams fed as ``generate_pallas`` feeds them."""
    tc, tp, seed_codes, gc_ids, (lc_r, lc_p), codes, logits = (
        _kernel2_resumed_run(3, "f32", rng, lc=True))
    _hold(_replay_resumed(tc, tp, seed_codes, gc_ids, codes, torch.float32,
                          lc_r, lc_p), codes, logits)


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
def test_kernel2_zero_ring16_matches_on_its_codes(wdt, rng):
    """TPU kernel 2 from a zero bf16 ring (``generate_pallas(prefill=False,
    ring_in_hbm=True, stream_io=True)``, ``_stream_zero_state``)."""
    jc, tc, jp, tp = _pair(SMALL, gc=True, key=100)
    B = 2
    seed_codes = rng.randint(0, 32, (B, jc.receptive_field + 3))
    gc_ids = rng.randint(0, 4, (B,))
    codes, logits = js.generate_pallas(
        jp, jc, n_samples=9, seed=4, batch_size=B, gc_ids=jnp.asarray(gc_ids),
        seed_codes=jnp.asarray(seed_codes), collect_logits=True,
        ring_in_hbm=True, stream_io=True, interpret=True,
        weight_dtype=WEIGHTS[wdt][1], state_dtype=jnp.bfloat16)
    _hold(_replay_sequential(tc, tp, seed_codes, gc_ids, codes,
                             WEIGHTS[wdt][0]), codes, logits)


def _packed_run(wdt, rng):
    """TPU kernel 3 (``_decode_kernel_packed``, ``ring_pack=True``) at a
    bf16 ring, the configuration of tests/test_ring_pack.py."""
    jc, tc, jp, tp = _pair(RING_PACK)
    B = 8
    seed_codes = rng.randint(0, 64, (B, jc.receptive_field + 3))
    codes, logits = js.generate_pallas(
        jp, jc, 11, seed=3, batch_size=B, seed_codes=jnp.asarray(seed_codes),
        prefill=True, ring_pack=True, collect_logits=True, interpret=True,
        weight_dtype=WEIGHTS[wdt][1], state_dtype=jnp.bfloat16)
    return tc, tp, seed_codes, codes, logits


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
def test_kernel3_ring16_matches_on_its_codes(wdt, rng):
    """TPU kernel 3: every ring row packed at the state dtype
    (``pack_ring_rows``), small-dilation layers resident, against
    ``decode`` from the prefilled ring cast to bf16."""
    tc, tp, seed_codes, codes, logits = _packed_run(wdt, rng)
    B, n = codes.shape
    packed, _ = _packed(tc, tp, B, None, WEIGHTS[wdt][0])
    carry = ts.prefill_carry(tp, tc, _t(seed_codes, torch.int32))
    forced = torch.cat([carry.last[:, None],
                        _t(codes, torch.int32)[:, :-1]], dim=1)
    ring = carry.ring.to(BF16)
    _hold(ts.decode(packed, tc, ring, carry.causal, forced.contiguous(), n,
                    carry.t_abs, 0, collect_logits=True), codes, logits)
    assert ring.dtype == BF16


def test_float32_ring_misses_the_bf16_ring(rng):
    """The comparisons are not vacuous: the port at a float32 ring misses
    JAX's bf16-ring logits by more than the tolerance, on the sequential
    route and on the resumed one."""
    tc, tp, seed_codes, gc_ids, codes, logits = _kernel1_run(3, "f32", rng)
    _, got = _replay_sequential(tc, tp, seed_codes, gc_ids, codes,
                                torch.float32, state_dtype=torch.float32)
    assert not np.allclose(got.numpy(), np.asarray(logits), **TOL)
    tc, tp, seed_codes, gc_ids, _, codes, logits = _kernel2_resumed_run(
        2, "f32", rng)
    _, got = _replay_resumed(tc, tp, seed_codes, gc_ids, codes,
                             torch.float32, state_dtype=torch.float32)
    assert not np.allclose(got.numpy(), np.asarray(logits), **TOL)


def test_swapped_sequential_rule_misses_kernel1(rng):
    """The sequential route's b1 rule at a bf16 ring is JAX's kernel 1
    (the chain float32 at bf16 weights), not kernel 4's (rounded at every
    B): the rounded chain misses JAX's logits by more than the
    tolerance."""
    tc, tp, seed_codes, gc_ids, codes, logits = _kernel1_run(1, "bf16", rng)
    assert not ts.chain_rounded("sequential", 1, ring16=True)
    assert ts.chain_rounded("sequential", 1)
    B, n_forced = seed_codes.shape
    packed, _ = _packed(tc, tp, B, gc_ids, BF16)
    forced = torch.cat([_t(seed_codes, torch.int32),
                        _t(codes, torch.int32)[:, :-1]], dim=1)
    ring, causal = ts.zero_state(tc, B, dtype=BF16)
    _, got = ts.decode_reference(
        packed, tc, ring, causal, forced.contiguous(),
        n_forced - 1 + codes.shape[1], 0, 0, collect_logits=True,
        round_chain=True)
    assert not np.allclose(got.numpy(), np.asarray(logits), **TOL)


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
def test_one_step_stores_the_rounded_rows(wdt, rng):
    """One step of ``decode_reference`` on a bf16 ring writes exactly the
    float32-ring run's rows rounded to nearest even, from the same state
    (a float32 ring holding the bf16 ring's values), and leaves the step's
    logits bitwise the float32-ring step's: a row is stored after it is
    read."""
    _, tc, _, tp = _pair(SMALL, gc=True, key=110)
    B = 3
    seed_codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 5)),
                    torch.int32)
    packed, _ = _packed(tc, tp, B, None, WEIGHTS[wdt][0])
    carry = ts.prefill_carry(tp, tc, seed_codes)
    ring16 = carry.ring.to(BF16)
    ring32 = ring16.float()
    x = carry.last[:, None].contiguous()
    out = {}
    for name, ring in (("16", ring16), ("32", ring32)):
        out[name] = ts.decode_reference(packed, tc, ring, carry.causal.clone(),
                                        x, 1, carry.t_abs, 7,
                                        collect_logits=True)
    assert torch.equal(out["16"][1], out["32"][1])
    assert torch.equal(out["16"][0], out["32"][0])
    assert torch.equal(ring16, ring32.to(BF16))
    assert not torch.equal(ring32, ring16.float())   # some row was rounded


@pytest.mark.parametrize("B", [1, 3])
def test_bf16_ring_is_exact_on_a_rounded_bf16_chain(B, rng):
    """At bf16 weights with the layer chain rounded (B > 1 on the decode
    route), the filter/gate product rounds each past row to bf16 as its
    operand anyway, and rounding twice to nearest even is rounding once:
    a bf16 ring then gives the float32 ring's logits and codes bitwise,
    over a window of sampled steps. At b1 (the JAX prefill route's VPU
    chain, float32 operands) the two differ."""
    _, tc, _, tp = _pair(SMALL, gc=True, key=150)
    seed_codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 3)),
                    torch.int32)
    gids = torch.as_tensor(rng.randint(0, 4, (B,)))
    packed, _ = _packed(tc, tp, B, gids.numpy(), BF16)
    carry = ts.prefill_carry(tp, tc, seed_codes, gids)
    x = carry.last[:, None].contiguous()
    out = [ts.decode_reference(packed, tc, carry.ring.to(dt, copy=True),
                               carry.causal.clone(), x, 20, carry.t_abs, 3,
                               collect_logits=True)
           for dt in (BF16, torch.float32)]
    same = all(torch.equal(a, b) for a, b in zip(*out))
    assert same == ts.chain_rounded("decode", B)


@pytest.mark.parametrize("prefill", [True, False])
def test_generate_cuda_state_dtype(prefill, rng):
    """``generate_cuda(state_dtype=...)`` on either route: a bf16 ring
    moves the logits off the float32 ring's, same seeds repeat bitwise, and
    a type other than float32 or bfloat16 raises ValueError."""
    _, tc, _, tp = _pair(SMALL, gc=True, key=120)
    B = 2
    seed_codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 3)),
                    torch.int32)
    kw = dict(batch_size=B, gc_ids=torch.tensor([1, 2]),
              seed_codes=seed_codes, collect_logits=True, prefill=prefill)
    runs = {dt: [ts.generate_cuda(tp, tc, 12, seed=5, state_dtype=dt, **kw)
                 for _ in range(2)]
            for dt in (torch.float32, BF16)}
    for (c1, l1), (c2, l2) in runs.values():
        assert torch.equal(c1, c2) and torch.equal(l1, l2)
        assert c1.shape == (B, 12) and torch.isfinite(l1).all()
    assert not torch.allclose(runs[BF16][0][1], runs[torch.float32][0][1],
                              **TOL)
    with pytest.raises(ValueError, match="state_dtype"):
        ts.generate_cuda(tp, tc, 4, seed=5, state_dtype=torch.float16, **kw)


def test_decode_refuses_other_ring_types():
    """``decode``, ``decode_sequential`` and ``decode_reference`` take a
    float32 or bf16 ring and raise ValueError for any other."""
    _, tc, _, tp = _pair(SMALL, key=130)
    packed = ts.pack_sampler_weights(tp, tc, 1)
    forced = torch.zeros((1, 1), dtype=torch.int32)
    ring, causal = ts.zero_state(tc, 1, dtype=torch.float16)
    with pytest.raises(ValueError, match="ring of type torch.float16"):
        ts.decode(packed, tc, ring, causal, forced, 1, 0, 0)
    with pytest.raises(ValueError, match="state_dtype"):
        ts.decode_sequential(packed, tc, forced, 1, 0,
                             state_dtype=torch.float16)


# An H100 SXM's clusters resident at once (tests/test_torch_sampler_select.py).
H100_CLUSTERS = {8: 15, 16: 7}


def _h100_resident(cs, rb, nbytes):
    return H100_CLUSTERS.get(cs, 132 // cs)


def _fake_card(monkeypatch):
    """``_launch`` on CPU tensors as on an H100: the route reads an H100's
    opt-in and resident clusters, and each library is a stand-in whose
    entries record (library, entry, plan arguments) and return 0."""
    from wavenet_torch.kernels import _build
    calls = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            def fn(*args):
                calls.append((self.name, entry, args[-4:-1]))
                return 0
            self.__dict__[entry] = fn
            return fn

    monkeypatch.setattr(ts, "_device", lambda dev: ts._Device(
        ts.H100_SMEM_OPTIN, _h100_resident, _h100_resident))
    monkeypatch.setattr(_build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    return calls


@pytest.mark.parametrize("B,kernel", [(1, "cluster"), (121, "tiles"),
                                      (512, "tiles"), (600, "decode")])
@pytest.mark.parametrize("wdt", ["f32", "bf16"])
def test_bf16_ring_takes_the_float32_route(B, kernel, wdt, monkeypatch):
    """The ring lives in device memory in every kernel, so a bf16-ring
    request routes exactly as a float32 one (gc b1 on the cluster kernel,
    b121-b525 on the tiles kernel, the rest on ``sampler_decode``): the
    same plan, launched on the bf16-ring library's entry of the same mode,
    counted with "_ring16" last."""
    from wavenet_torch.models.config import gc_config
    calls = _fake_card(monkeypatch)
    c = gc_config()
    wt = WEIGHTS[wdt][0]
    packed = ts.pack_sampler_weights(
        {k: v for k, v in tw.init_params(0, c, device="cpu").items()}, c, B,
        weight_dtype=wt)
    forced = torch.zeros((B, 1), dtype=torch.int32)
    names = {}
    for dt in (torch.float32, BF16):
        ring, causal = ts.zero_state(c, B, dtype=dt)
        names[dt] = ts._launch(packed, c, ring, causal, forced, 1, 0, 0, 1.0,
                               False, route="decode")[2]
    (lib32, fn32, plan32), (lib16, fn16, plan16) = calls
    mode = "_bf16" if wdt == "bf16" else ""
    assert names[torch.float32] == kernel + mode
    assert names[BF16] == kernel + mode + "_ring16"
    assert (lib16, fn16) == (lib32 + "_ring16", fn32 + "_ring16")
    assert lib32 == ("sampler_decode" if kernel == "decode"
                     else f"sampler_{kernel}{mode}")
    if kernel != "decode":
        assert plan16[:2] == plan32[:2] and list(plan16[2]) == list(plan32[2])


@pytest.mark.parametrize("store", ["rounded", "truncated"])
def test_hold_ring16_takes_rounding_and_refuses_truncation(store, rng):
    """``bf16_hold.stepwise`` from a bf16 ring with ``hold_ring16`` on the
    rows a step writes, run here with the plain version standing in for a
    kernel: stored rounded to nearest even, the rows equal the plain
    version's; stored truncated (the float32 input's low 16 bits
    dropped), about half of them differ and the hold refuses them. The
    logits are the same either way: a row is stored after it is read."""
    from wavenet_torch.kernels import bf16_hold
    _, tc, _, tp = _pair(SMALL, gc=True, key=140)
    B = 8
    gids = torch.as_tensor(rng.randint(0, 4, (B,)))
    codes = _t(rng.randint(0, 32, (B, tc.receptive_field + 12)), torch.int32)
    carry = ts.prefill_carry(tp, tc, codes[:, :-11], gids)
    pk = ts.pack_sampler_weights(tp, tc, B, tw.embed_gc(tp, tc, gids))

    def launch(ring, causal, x, t):
        r32 = ring.float()
        lg = ts.decode_reference(pk, tc, r32, causal, x, 1, t, 0,
                                 collect_logits=True)[1]
        if store == "truncated":
            r32 = (r32.view(torch.int32) & -65536).view(torch.float32)
        ring.copy_(r32.to(BF16))
        return lg

    lg, lg16, _, rk, r16, _ = bf16_hold.stepwise(
        tc, pk, pk, carry.ring.to(BF16), carry.causal.clone(),
        codes[:, -12:].contiguous(), carry.t_abs, 0, False, launch)
    assert torch.equal(lg, lg16) and rk.dtype == torch.float32
    if store == "rounded":
        assert bf16_hold.hold_ring16("rounded", rk, r16)["differ_share"] == 0
        return
    assert 0.3 < (bf16_hold.bf16_ulps(rk, r16) > 0).float().mean() < 0.7
    with pytest.raises(AssertionError, match="elements differ"):
        bf16_hold.hold_ring16("truncated", rk, r16)


def test_bf16_ulps_by_hand():
    """Distances in bf16 ulps: neighbours 1 apart across the powers of
    two and zero, -0 and +0 equal, and the smallest subnormal 1 from 0."""
    from wavenet_torch.kernels import bf16_hold
    one = torch.tensor([1.0], dtype=BF16)
    up = (one.view(torch.int16) + 1).view(BF16)
    down = (one.view(torch.int16) - 1).view(BF16)
    tiny = torch.tensor([1], dtype=torch.int16).view(BF16)
    cases = [(one, up, 1), (down, up, 2), (-one, -up, 1),
             (torch.tensor([-0.0]), torch.tensor([0.0]), 0),
             (tiny, torch.tensor([0.0]), 1), (-tiny, tiny, 2)]
    for a, b, want in cases:
        assert bf16_hold.bf16_ulps(a, b).item() == want, (a, b)
