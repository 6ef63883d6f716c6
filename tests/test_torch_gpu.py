"""The port's CUDA kernels (``sampler_decode`` and ``sampler_cluster`` on
their prefill and sequential routes, mu-law and scalar input, in float32
and in their bf16 modes, ``sampler_tiles`` at the paper/gc widths in both
modes, each also at a bf16 ring, and the route between them;
``fused_stack`` (the 3xTF32 "mma" kernel, the FP32-core "simt" one and
the "tiled" one of the other widths: 128 and up, R != D, 1, 2, 4);
``fused_stack_carry`` behind the retired stack generations v1 and v2;
``dilated_layer``; the probes ``fwd_bisect`` and ``fwd_bisect2`` (on the
FP32 cores and on the tensor cores), ``b1_bisect`` and ``matvec_probe`` of
``wavenet_torch.tools``) against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA GPU:
the kernels have no CPU mode. The file imports no JAX, so on a machine with
a GPU and without JAX it runs alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from wavenet_torch.experiments import dilated_layer as dl
from wavenet_torch.experiments import fused_stack as fs1
from wavenet_torch.experiments import fused_stack2 as fs2
from wavenet_torch.kernels import bf16_hold
from wavenet_torch.kernels import fused_stack as fs
from wavenet_torch.kernels import sampler as ks
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import embed_gc, init_params

# Teacher-forced logits: another summation order over K <= 512.
TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = dict(dilations=(1, 2, 4, 8, 16, 1, 2, 4), residual_channels=8,
             dilation_channels=8, skip_channels=64, quantization_channels=64,
             gc_channels=4, gc_cardinality=4)


@pytest.fixture
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sampler_decode kernel has no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = WaveNetConfig(**SMALL)
    # Seeded non-zero biases (init_params sets them to 0), so that every
    # bias term of the kernel is compared.
    params = init_params(0, c, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for k in sorted(params):
        if k.endswith("_bias"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    params = {k: v.cuda() for k, v in params.items()}
    rng = np.random.RandomState(0)
    return c, params, rng


def _state(c, params, rng, B, T):
    codes = torch.as_tensor(rng.randint(0, c.quantization_channels, (B, T)),
                            dtype=torch.int32, device="cuda")
    gids = torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                           device="cuda")
    packed = ks.pack_sampler_weights(params, c, B, embed_gc(params, c, gids))
    return codes, gids, packed


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 5, 300, 600, 1100])
def test_kernel_matches_reference_teacher_forced(setup, B):
    c, params, rng = setup
    codes, gids, packed = _state(c, params, rng, B, 60)
    carry = ks.prefill_carry(params, c, codes[:, :40], gids)
    forced = codes[:, 39:].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    before = ks.decode.launches
    kk, lk = ks.decode(packed, c, rk, ck, forced, 24, carry.t_abs, 3,
                       collect_logits=True, kernel="decode")
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 24,
                                 carry.t_abs, 3, collect_logits=True)
    torch.cuda.synchronize()
    assert ks.decode.launches == before + 1
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    assert torch.equal(ck, cr)
    assert torch.equal(kk[:, :20], forced[:, 1:])


@pytest.mark.gpu
def test_kernel_sampling_is_deterministic_and_per_row(setup):
    """Same seed, same codes; a row's codes do not depend on B or on how
    many rows share a block (300 rows run two to a block, 2 rows one)."""
    c, params, rng = setup
    codes, gids, packed = _state(c, params, rng, 300, 30)
    carry = ks.prefill_carry(params, c, codes, gids)

    def run(n):
        # A copy: decode updates the ring in place.
        ring = carry.ring[:, :n].clone(
            memory_format=torch.contiguous_format)
        causal = carry.causal[:n].clone()
        pk = packed._replace(layer_add=packed.layer_add[:, :n].contiguous())
        out, lg = ks.decode(pk, c, ring, causal,
                            carry.last[:n, None].contiguous(), 64,
                            carry.t_abs, 11, collect_logits=8,
                            kernel="decode")
        return out, lg

    a, la = run(300)
    b, lb = run(300)
    s, _ = run(2)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert torch.equal(a[:2], s)
    assert la.shape == (300, 8, c.quantization_channels)
    assert 0 <= a.min().item() and a.max().item() < c.quantization_channels


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(setup):
    c, params, rng = setup
    codes, gids, packed = _state(c, params, rng, 2, 20)
    carry = ks.prefill_carry(params, c, codes, gids)
    forced = carry.last[:, None].contiguous()
    with pytest.raises(ValueError, match="ring"):
        ks.decode(packed, c, carry.ring.double(), carry.causal, forced, 4,
                  carry.t_abs, 0)
    with pytest.raises(ValueError, match="forced"):
        ks.decode(packed, c, carry.ring, carry.causal, forced.long(), 4,
                  carry.t_abs, 0)
    with pytest.raises(ValueError, match="contiguous"):
        ks.decode(packed, c, carry.ring.transpose(0, 1).contiguous()
                  .transpose(0, 1), carry.causal, forced, 4, carry.t_abs, 0)


# The wide config's widths (R=D=64, S=1024, scalar input, a 32-tap causal
# layer) over a short dilation stack.
WIDE_SMALL = dict(dilations=(1, 2, 4, 8, 16, 1, 2, 4), residual_channels=64,
                  dilation_channels=64, skip_channels=1024,
                  quantization_channels=256, scalar_input=True,
                  initial_filter_width=32)


def _seeded_params(c, seed=0):
    params = init_params(seed, c, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sorted(params):
        if k.endswith("_bias"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    return {k: v.cuda() for k, v in params.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 5, 1100])
def test_scalar_kernel_matches_reference_at_wide_widths(setup, B):
    """Scalar input at the wide widths, teacher-forced from a prefilled
    state on 31 amplitudes; 1100 rows run eight to a block (~135 KB of
    shared memory)."""
    c = WaveNetConfig(**WIDE_SMALL)
    params = _seeded_params(c)
    rng = np.random.RandomState(B)
    audio = torch.as_tensor(rng.uniform(-0.9, 0.9, (B, 100))
                            .astype(np.float32), device="cuda")
    carry = ks.prefill_carry(params, c, audio[:, :70])
    packed = ks.pack_sampler_weights(params, c, B)
    forced = audio[:, 69:].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    kk, lk = ks.decode(packed, c, rk, ck, forced, 30, carry.t_abs, 3,
                       collect_logits=True, kernel="decode")
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 30,
                                 carry.t_abs, 3, collect_logits=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=0)
    # Forced amplitudes come back as their mu-law codes.
    assert torch.equal(kk, kr)
    assert torch.equal(kk, ks.mu_law_encode_f(forced[:, 1:],
                                              c.quantization_channels))


def _replay_sequential(c, packed, prefix, codes_k, n_total, seed, window):
    """The plain version from a zero ring, teacher-forced on the inputs
    that the kernel's run fed itself (its sampled codes, decoded in
    scalar mode); with bf16 weights the chain rounded at every B, as
    ``decode_sequential`` does."""
    sampled = codes_k[:, prefix.shape[1] - 1:-1]
    nxt = (ks.decode_amp(sampled, c.quantization_channels)
           if c.scalar_input else sampled)
    forced = torch.cat([prefix, nxt.to(prefix.dtype)], dim=1).contiguous()
    ring, causal = ks.zero_state(c, prefix.shape[0], "cuda")
    return ks.decode_reference(packed, c, ring, causal, forced, n_total, 0,
                               seed, collect_logits=window,
                               round_chain=ks.chain_rounded(
                                   "sequential", prefix.shape[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_sequential_route_matches_reference(setup, wide):
    """Kernel 4's route (``decode_sequential``: the forced prefix stepped
    from a zero ring, then sampled steps) with a logits window, against
    the plain version replaying the kernel's inputs; same-seed runs are
    bitwise equal."""
    c = WaveNetConfig(**WIDE_SMALL) if wide else setup[0]
    params = _seeded_params(c) if wide else setup[1]
    rng = np.random.RandomState(7)
    B, n_samples, W = 3, 30, 12
    if c.scalar_input:
        prefix = torch.as_tensor(rng.uniform(-0.9, 0.9, (
            B, c.receptive_field)).astype(np.float32), device="cuda")
        gids = None
    else:
        prefix = torch.as_tensor(rng.randint(0, c.quantization_channels, (
            B, c.receptive_field)), dtype=torch.int32, device="cuda")
        gids = torch.as_tensor([0, 3, 1], device="cuda")
    packed = ks.pack_sampler_weights(
        params, c, B, None if gids is None else embed_gc(params, c, gids))
    n_total = prefix.shape[1] - 1 + n_samples
    before = ks.decode_sequential.launches
    codes, lg = ks.decode_sequential(packed, c, prefix, n_total, 5,
                                     collect_logits=W)
    again, _ = ks.decode_sequential(packed, c, prefix, n_total, 5)
    torch.cuda.synchronize()
    assert ks.decode_sequential.launches == before + 2
    assert torch.equal(codes, again)
    assert lg.shape == (B, W, c.quantization_channels)
    codes_r, lg_r = _replay_sequential(c, packed, prefix, codes, n_total, 5,
                                       W)
    torch.testing.assert_close(lg, lg_r, **TOL)
    assert torch.equal(codes[:, :-1], codes_r[:, :-1])
    # generate_cuda's route: the sampled tail of the same launch.
    out = ks.generate_cuda(params, c, n_samples, seed=5, batch_size=B,
                           gc_ids=gids, seed_codes=prefix, prefill=False)
    assert torch.equal(out, codes[:, prefix.shape[1] - 1:])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
def test_scalar_resumable_segments_equal_one_run(setup, B):
    """At the wide widths, three resumed segments at temperature 1 equal
    one launch bit for bit: each segment starts from the amplitude that
    the previous launch computed (``next_amp``)."""
    c = WaveNetConfig(**WIDE_SMALL)
    params = _seeded_params(c)
    rng = np.random.RandomState(9)
    prefix = torch.as_tensor(rng.uniform(-0.9, 0.9, (
        B, c.receptive_field)).astype(np.float32), device="cuda")
    full = ks.generate_cuda(params, c, 600, seed=4, batch_size=B,
                            seed_codes=prefix)
    outs, carry = [], None
    for n in (200, 150, 250):
        seg, carry = ks.generate_cuda_resumable(
            params, c, n, seed=4, batch_size=B,
            seed_codes=prefix if carry is None else None, carry=carry)
        outs.append(seg)
    torch.cuda.synchronize()
    assert carry.last.dtype == torch.float32
    assert torch.equal(torch.cat(outs, dim=1), full)


@pytest.mark.gpu
def test_sharded_generation_runs_sampler_decode(setup, tmp_path, capsys):
    """At the sharded config (80 layers, R = D = 256), where the JAX
    ladder's TPU VMEM budget offers no Pallas rung, the port routes by its
    own kernels: the generate CLI and the server run ``sampler_decode``,
    name it, and launch it once a request (counted by ``decode``)."""
    import json
    from wavenet_torch import sampler_select
    from wavenet_torch import train_lib as tl
    from wavenet_torch.cli import generate as cli
    from wavenet_torch.models.config import sharded_config
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService
    c = sharded_config()
    assert ks.device_decode_route(c, 1) == "decode"
    assert sampler_select.decode_offered(c, 1, "cuda")
    params = init_params(0, c, device="cpu")
    logdir = str(tmp_path / "logdir")
    tl.save_checkpoint(logdir, tl.train_state_from_params(
        params, tl.make_optimizer("adam", 1e-3)))
    pfile = tmp_path / "sharded.json"
    pfile.write_text(json.dumps(c.to_json_dict()))
    npz = str(tmp_path / "sharded.npz")
    save_npz(npz, params)
    before = (ks.decode.launches, ks.decode_sequential.launches,
              ks.decode.launches_by["decode"])
    assert cli.main([logdir, "--wavenet_params", str(pfile), "--samples",
                     "16", "--wav_out_path", str(tmp_path / "out.wav"),
                     "--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert "Using CUDA (prefill + " in out and "scan" not in out
    service = GenerationService(npz, str(pfile), warm_samples=0,
                                device="cuda")
    assert "CUDA" in service.sampler_name
    wave = service.generate(16, seed=2)
    assert wave.shape == (16,) and np.isfinite(wave).all()
    assert "CUDA" in service.sampler_name
    assert (ks.decode.launches, ks.decode_sequential.launches,
            ks.decode.launches_by["decode"]) == (before[0] + 2, before[1],
                                                 before[2] + 2)


def _sharded_decode_case(B, seed=0):
    """(config, params, packed, prefilled carry, 65 teacher-forced inputs)
    at the sharded widths (R = D = 256, S = 512) with 4 layers."""
    from wavenet_torch.models.config import sharded_config
    c = sharded_config(dilations=(1, 2, 4, 8))
    params = _seeded_params(c, seed)
    rng = np.random.RandomState(seed + B)
    x = torch.as_tensor(rng.randint(0, c.quantization_channels, (B, 135)),
                        dtype=torch.int32, device="cuda")
    carry = ks.prefill_carry(params, c, x[:, :70], None)
    packed = ks.pack_sampler_weights(params, c, B, None)
    return c, params, packed, carry, x[:, 69:].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3])
def test_sampler_decode_holds_the_sharded_width(setup, B, bf16):
    """``sampler_decode`` at the sharded widths (R = D = 256, S = 512; 4
    layers), the kernel the route gives that config at every batch,
    teacher-forced for 64 steps against ``decode_reference``: float32
    weights at TOL, bf16 weights one step a launch by ``bf16_hold`` (at b3,
    where the chain is rounded, as far as the plain version lies from
    itself stepped on the CPU: ``hold_as_plain``)."""
    c, params, packed, carry, forced = _sharded_decode_case(B)
    assert ks.device_decode_route(c, B) == "decode"
    forced = forced[:, :64].contiguous()
    if not bf16:
        rk, ck = carry.ring.clone(), carry.causal.clone()
        rr, cr = carry.ring.clone(), carry.causal.clone()
        before = ks.decode.launches_by["decode"]
        kk, lk = ks.decode(packed, c, rk, ck, forced, 64, carry.t_abs, 3,
                           collect_logits=True)
        kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 64,
                                     carry.t_abs, 3, collect_logits=True)
        torch.cuda.synchronize()
        assert ks.decode.launches_by["decode"] == before + 1
        torch.testing.assert_close(lk, lr, **TOL)
        torch.testing.assert_close(rk, rr, **TOL)
        assert torch.equal(ck, cr)
        assert torch.equal(kk[:, :-1], forced[:, 1:])
        return
    pk16 = packed._replace(**{k: getattr(packed, k).to(torch.bfloat16)
                              for k in ks.WEIGHT_FIELDS})
    rk, ck = carry.ring.clone(), carry.causal.clone()
    before = ks.decode.launches_by["decode_bf16"]
    _, lk = ks.decode(pk16, c, rk, ck, forced, 64, carry.t_abs, 3,
                      collect_logits=True)
    torch.cuda.synchronize()
    assert ks.decode.launches_by["decode_bf16"] == before + 1

    def step(ring, causal, x, t):
        return ks.decode(pk16, c, ring, causal, x, 1, t, 3,
                         collect_logits=True)[1]

    rc = ks.chain_rounded("decode", B)
    ring, causal = carry.ring.clone(), carry.causal.clone()
    if not rc:      # b1: the chain float32, the tight rule
        lg = _bf16_stepwise(f"sharded B={B}", c, pk16, packed, ring, causal,
                            forced, carry.t_abs, 3, rc, step)
        assert torch.equal(lg, lk) and torch.equal(ring, rk)
        return
    # The chain rounded at every layer: held as far as the plain version
    # lies from itself summed on the CPU (bf16_hold's docstring).
    got = bf16_hold.stepwise(c, pk16, packed, ring, causal, forced,
                             carry.t_abs, 3, rc, step)
    assert torch.equal(got[0], lk) and torch.equal(ring, rk)
    ring, causal = carry.ring.clone(), carry.causal.clone()
    cpu = bf16_hold.stepwise(c, pk16, packed, ring, causal, forced,
                             carry.t_abs, 3, rc,
                             bf16_hold.cpu_launch(c, pk16, 3, rc))
    torch.cuda.synchronize()
    for i in (0, 3):
        bf16_hold.hold_as_plain(f"sharded B={B} {i}",
                                bf16_hold.ratios(*got[i:i + 3]),
                                bf16_hold.ratios(*cpu[i:i + 3]))


@pytest.mark.gpu
def test_decode_smem_bytes_match_library(setup):
    """``decode_smem_bytes`` (the route's copy) against the library's
    ``sampler_decode_smem_bytes`` at every config of the repo, LC too, at
    each rows-a-block the kernel takes."""
    from wavenet_torch.kernels import _build
    from wavenet_torch.models import config as mc
    lib = _build.load("sampler_decode")
    ks._bind(lib)
    cfgs = [getattr(mc, n)() for n in ("tiny_config", "paper_config",
                                       "gc_config", "wide_config",
                                       "sharded_config")]
    cfgs.append(mc.paper_config(lc_channels=80))
    for c in cfgs:
        for rb in (1, 2, 4, 8):
            assert lib.sampler_decode_smem_bytes(
                c.num_layers, c.residual_channels, c.dilation_channels,
                c.skip_channels, c.quantization_channels, ks.causal_width(c),
                c.lc_channels if c.lc_enabled else 0, rb) == (
                    ks.decode_smem_bytes(c, rb)), (c, rb)


# Fused stack: another summation order; gradients also rebuild each
# layer's input by subtraction (the tolerances of the JAX kernel's tests).
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _stack_inputs(W, dilations, B, T, seed=0):
    """A stack's inputs and cotangents at W = R = D, or W = (R, D)."""
    R, D = W if isinstance(W, tuple) else (W, W)
    c = WaveNetConfig(dilations=dilations, residual_channels=R,
                      dilation_channels=D, skip_channels=16,
                      quantization_channels=32)
    L = c.num_layers
    rng = np.random.RandomState(seed)

    def rn(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device="cuda")

    # Above a width of 32 the weights shrink with the fan-in, as an init
    # does, so that the activations stay at 32's size (see WIDE_SLICE_RTOL).
    def ws(fan):
        return 0.2 * min(1.0, (32 / fan) ** 0.5)

    args = (rn(B, T, R, scale=0.5), rn(L, 2 * R, 2 * D, scale=ws(R)),
            rn(L, D, R, scale=ws(D)), rn(L, B, 2 * D, scale=0.1),
            rn(L, 1, R, scale=0.1))
    cot = (rn(B, T, R), rn(B, T, L * D))
    return c, args, cot


_DIL10 = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("W,dilations,B,T,kernel", [
    (8, (1, 2, 4, 8, 16), 2, 150, "auto"),
    (16, (1, 64, 2, 512), 3, 700, "auto"),
    (32, _DIL10, 2, 1500, "simt"),
    (32, _DIL10, 2, 1500, "mma"),
    (32, _DIL10, 3, 1500, "mma"),
    (32, (512, 1, 100, 2), 3, 1000, "auto"),
])
def test_fused_stack_matches_reference(setup, W, dilations, B, T, kernel):
    """Each kernel against the plain versions (T is not a multiple of the
    64-row tile); ``launches_by`` counts the kernel that ran, and repeated
    calls are bitwise equal."""
    c, args, (dy, dz) = _stack_inputs(W, dilations, B, T)
    used = fs.stack_kernel_plan(c) if kernel == "auto" else kernel
    f0, b0 = fs.forward.launches, fs.backward.launches
    fb0, bb0 = fs.forward.launches_by[used], fs.backward.launches_by[used]
    y, fg, z = fs.forward(*args, c, kernel=kernel)
    yr, fgr, zr = fs.fused_stack_forward_reference(*args, c)
    torch.cuda.synchronize()
    assert fs.forward.launches == f0 + 1
    assert fs.forward.launches_by[used] == fb0 + 1
    for got, ref in ((y, yr), (fg, fgr), (z, zr)):
        torch.testing.assert_close(got, ref, **FWD_TOL)
    again = fs.forward(*args, c, kernel=kernel)
    assert all(torch.equal(a, b) for a, b in zip((y, fg, z), again))
    w_fg, wd, _, bd = args[1:]
    grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c, kernel=kernel)
    ref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    torch.cuda.synchronize()
    assert fs.backward.launches == b0 + 1
    assert fs.backward.launches_by[used] == bb0 + 1
    for name, got, want in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"),
                               grads, ref):
        torch.testing.assert_close(got, want, **GRAD_TOL, msg=name)
    # Fixed-order partial sums, no atomics: a second call is bitwise equal.
    again = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c, kernel=kernel)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_fused_stack_mma_matches_simt(setup):
    """The two kernels compute one map: "mma" against "simt" at W = 32,
    within the tolerances each holds against the plain versions."""
    c, args, (dy, dz) = _stack_inputs(32, _DIL10, 3, 1500, 3)
    outs = {k: fs.forward(*args, c, kernel=k) for k in ("mma", "simt")}
    for got, want in zip(outs["mma"], outs["simt"]):
        torch.testing.assert_close(got, want, **FWD_TOL)
    y, fg, _ = outs["simt"]
    w_fg, wd, _, bd = args[1:]
    grads = {k: fs.backward(y, dy, fg, dz, w_fg, wd, bd, c, kernel=k)
             for k in ("mma", "simt")}
    torch.cuda.synchronize()
    for name, got, want in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"),
                               grads["mma"], grads["simt"]):
        torch.testing.assert_close(got, want, **GRAD_TOL, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("W,kernel", [(16, "auto"), (32, "mma")])
def test_fused_stack_op_gradients(setup, W, kernel):
    """The autograd op on the card against autograd of the plain forward
    written out layer by layer."""
    c, args, (dy, dz) = _stack_inputs(W, (1, 2, 4, 8, 16, 32, 512), 2, 700,
                                      1)
    b0 = fs.backward.launches_by[fs.stack_kernel_plan(c)
                                 if kernel == "auto" else kernel]
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, z = fs.fused_stack3(*leaves, c, kernel=kernel)
    (y * dy).sum().add((z * dz).sum()).backward()
    got = [t.grad for t in leaves]
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    x, w_fg, wd, add, bd = ref_leaves
    D = c.dilation_channels
    zs = []
    for l, d in enumerate(c.dilations):
        past = torch.nn.functional.pad(x, (0, 0, d, 0))[:, :x.shape[1]]
        fg = torch.cat([past, x], -1) @ w_fg[l] + add[l][:, None]
        zz = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
        x = x + (zz @ wd[l] + bd[l])
        zs.append(zz)
    (x * dy).sum().add((torch.cat(zs, -1) * dz).sum()).backward()
    for g, r in zip(got, ref_leaves):
        torch.testing.assert_close(g, r.grad, **GRAD_TOL)
    assert fs.backward.launches_by[fs.stack_kernel_plan(c)
                                   if kernel == "auto" else kernel] == b0 + 1


@pytest.mark.gpu
def test_fused_stack_rejects_bad_inputs(setup):
    c, args, (dy, dz) = _stack_inputs(8, (1, 2), 2, 64)
    x, w_fg, wd, add, bd = args
    with pytest.raises(ValueError, match="x"):
        fs.forward(x.double(), w_fg, wd, add, bd, c)
    with pytest.raises(ValueError, match="contiguous"):
        fs.forward(x.transpose(0, 1).contiguous().transpose(0, 1), w_fg, wd,
                   add, bd, c)
    # R = 8, D = 16 routes to the tiled kernel, which checks the weights'
    # shapes against the config before a launch.
    wide = WaveNetConfig(dilations=(1, 2), residual_channels=8,
                         dilation_channels=16, skip_channels=16,
                         quantization_channels=32)
    with pytest.raises(ValueError, match="w_fg"):
        fs.forward(x, w_fg, wd, add, bd, wide)
    with pytest.raises(ValueError, match="kernel"):
        fs.forward(x, w_fg, wd, add, bd, c, kernel="wgmma")
    # The mma kernel is built for R == D in (32, 64) only; no quiet
    # switch.
    c16, args16, (dy16, dz16) = _stack_inputs(16, (1, 2), 2, 64)
    n = fs.forward.launches
    with pytest.raises(NotImplementedError, match="fused_stack_mma"):
        fs.forward(*args16, c16, kernel="mma")
    y16, fg16, _ = fs.fused_stack_forward_reference(*args16, c16)
    with pytest.raises(NotImplementedError, match="fused_stack_mma"):
        fs.backward(y16, dy16, fg16, dz16, args16[1], args16[2], args16[4],
                    c16, kernel="mma")
    assert fs.forward.launches == n
    # The pure plan's simt widths are those the library is built for.
    lib, _ = fs._lib("simt")
    assert tuple(W for W in (4, 8, 16, 32, 64)
                 if lib.fused_stack_supports_width(W, W)) == fs.SIMT_WIDTHS


# The mma kernel's bf16 mode against its plain bf16 version, in the working
# type, on the scale of bf16's own distance from float32 (the plain
# float32 version): another float32 summation order flips a few bf16
# roundings, and every later layer carries a flip on, so the two bf16
# results drift apart with depth. On the CPU, a float64-summed plain bf16
# stack lay 0.01-0.05 (10 layers) and 0.04-0.25 (30 layers) of the bf16
# gap from the float32-summed one on average, 0.02-0.64 at the worst
# point; an indexing or rounding fault lies O(1) of the values away.
BF16_MEAN_RATIO = 0.5
BF16_MAX_RATIO = 1.5


def _hold_bf16(got, ref, ref32, name):
    got, ref, ref32 = got.float(), ref.float(), ref32.float()
    err, gap = (got - ref).abs(), (ref - ref32).abs()
    assert torch.isfinite(got).all(), name
    assert err.mean() <= BF16_MEAN_RATIO * gap.mean(), (name, err.mean(),
                                                        gap.mean())
    assert err.max() <= BF16_MAX_RATIO * gap.max(), (name, err.max(),
                                                     gap.max())


def _bf16(c):
    import dataclasses
    return dataclasses.replace(c, compute_dtype="bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dilations,B,T", [
    (_DIL10, 2, 1500),
    ((512, 1, 100, 2), 3, 1000),
    ((1, 64, 2), 1, 70),
])
def test_fused_stack_bf16_matches_reference(setup, dilations, B, T):
    """The bf16 mode of fused_stack_mma against the plain bf16 versions:
    bf16 records, float32 y and gradients; ``launches_by`` counts
    "mma_bf16"; repeated calls are bitwise equal."""
    c32, args, (dy, dz) = _stack_inputs(32, dilations, B, T)
    c = _bf16(c32)
    assert fs.stack_kernel_plan(c) == "mma"
    f0, b0 = fs.forward.launches_by["mma_bf16"], fs.backward.launches_by[
        "mma_bf16"]
    y, fg, z = fs.forward(*args, c)
    ref = fs.fused_stack_forward_reference(*args, c)
    torch.cuda.synchronize()
    assert fs.forward.launches_by["mma_bf16"] == f0 + 1
    assert (y.dtype, fg.dtype, z.dtype) == (torch.float32, torch.bfloat16,
                                            torch.bfloat16)
    ref32 = fs.fused_stack_forward_reference(*args, c32)
    for name, got, want, want32 in zip(("y", "fg", "z"), (y, fg, z), ref,
                                       ref32):
        _hold_bf16(got, want, want32, name)
    again = fs.forward(*args, c)
    assert all(torch.equal(a, b) for a, b in zip((y, fg, z), again))
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = ref
    grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    assert fs.backward.launches_by["mma_bf16"] == b0 + 1
    for name, got, want, want32 in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"),
                                       grads, gref, gref32):
        assert got.dtype == torch.float32, name
        _hold_bf16(got, want, want32, name)
    again = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("W,dilations,B,T", [
    (8, (1, 2, 4, 8, 16), 2, 150),
    (16, (1, 64, 2, 512), 3, 700),
    (32, _DIL10, 2, 1500),
])
def test_fused_stack_simt_bf16_matches_reference(setup, W, dilations, B, T):
    """The bf16 mode of fused_stack.cu (pinned "simt"; the route at 8 and
    16) against the plain bf16 versions on bf16's gap: bf16 records,
    float32 y and gradients; ``launches_by`` counts "simt_bf16"; repeated
    calls are bitwise equal."""
    c32, args, (dy, dz) = _stack_inputs(W, dilations, B, T)
    c = _bf16(c32)
    if W < 32:
        assert fs.stack_kernel_plan(c) == "simt"
    f0, b0 = (fs.forward.launches_by["simt_bf16"],
              fs.backward.launches_by["simt_bf16"])
    y, fg, z = fs.forward(*args, c, kernel="simt")
    ref = fs.fused_stack_forward_reference(*args, c)
    ref32 = fs.fused_stack_forward_reference(*args, c32)
    torch.cuda.synchronize()
    assert fs.forward.launches_by["simt_bf16"] == f0 + 1
    assert (y.dtype, fg.dtype, z.dtype) == (torch.float32, torch.bfloat16,
                                            torch.bfloat16)
    for name, got, want, want32 in zip(("y", "fg", "z"), (y, fg, z), ref,
                                       ref32):
        _hold_bf16(got, want, want32, name)
    again = fs.forward(*args, c, kernel="simt")
    assert all(torch.equal(a, b) for a, b in zip((y, fg, z), again))
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = ref
    grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c, kernel="simt")
    gref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    assert fs.backward.launches_by["simt_bf16"] == b0 + 1
    for name, got, want, want32 in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"),
                                       grads, gref, gref32):
        assert got.dtype == torch.float32, name
        _hold_bf16(got, want, want32, name)
    again = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c, kernel="simt")
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_fused_stack_simt_bf16_matches_mma_bf16(setup):
    """The two kernels' bf16 modes compute one map: "simt" against "mma"
    at W = 32, on bf16's gap from the plain float32 versions."""
    c32, args, (dy, dz) = _stack_inputs(32, _DIL10, 3, 1500, 3)
    c = _bf16(c32)
    outs = {k: fs.forward(*args, c, kernel=k) for k in ("mma", "simt")}
    ref32 = fs.fused_stack_forward_reference(*args, c32)
    for name, got, want, want32 in zip(("y", "fg", "z"), outs["simt"],
                                       outs["mma"], ref32):
        _hold_bf16(got, want, want32, name)
    y, fg, _ = outs["mma"]
    w_fg, wd, _, bd = args[1:]
    grads = {k: fs.backward(y, dy, fg, dz, w_fg, wd, bd, c, kernel=k)
             for k in ("mma", "simt")}
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    for name, got, want, want32 in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"),
                                       grads["simt"], grads["mma"], gref32):
        _hold_bf16(got, want, want32, name)


# Width 64 in float32: the products sum 128 terms. With the W = 32 cases'
# weight scale, fg reaches ~20-40 over 6-10 layers and its float32 sums
# round by ~1e-4 (the kernel lies as far from the plain version as from
# the 3xTF32 plain version ``mma3_matmul``), so the weights shrink with the
# fan-in above W = 32 (``_stack_inputs``). Even so, a gradient element near
# 0, rebuilt by subtraction, misses the elementwise atol (1 of 114,688 at
# 1.4x). So the width-64 cases are held as chip_smoke.py's phase 5 holds
# its full-size ones: within rtol * max |ref| + atol of the tolerances
# above, and each batch row's (dx), layer's (weights) or (layer, row)'s
# (dadd) slice within WIDE_SLICE_RTOL of its own max |ref|, so a fault
# confined to one slice does not hide under the whole tensor's scale.
WIDE_SLICE_RTOL = 1e-4
_GRAD_LEADS = (1, 1, 1, 2, 1)


def _hold_scaled(got, want, tol, lead, name):
    err = (got - want).abs()
    assert torch.isfinite(got).all(), name
    assert err.max() <= tol["rtol"] * want.abs().max() + tol["atol"], (
        name, err.max().item(), want.abs().max().item())
    if lead:
        n = int(np.prod(want.shape[:lead]))
        rel = (err.reshape(n, -1).amax(1)
               / want.reshape(n, -1).abs().amax(1)).nan_to_num(nan=0.0)
        assert rel.max() <= WIDE_SLICE_RTOL, (name, rel.max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("gc", [False, True], ids=["no_gc", "gc"])
def test_fused_stack_mma_width64(setup, bf16, gc):
    """fused_stack_mma at R = D = 64 (the wide width: in f32 its weights
    stay float pairs split as each fragment loads, and (B) holds one
    stage) against the plain versions in both modes, with ``add`` per
    batch row (gc) or one for all rows (no gc), T not a multiple of the
    64-row tile, a dilation of a whole tile and one of several tiles, 10
    layers; ``launches_by`` counts the mode that ran; repeats are bitwise
    equal."""
    c32, args, (dy, dz) = _stack_inputs(64, (1, 64, 2, 33, 512, 7, 128, 4,
                                             256, 16), 2, 1100)
    if not gc:
        add = args[3]
        args = args[:3] + (add[:, :1].expand_as(add).contiguous(),) + args[4:]
    c = _bf16(c32) if bf16 else c32
    key = "mma_bf16" if bf16 else "mma"
    assert fs.stack_kernel_plan(c) == "mma"
    f0, b0 = fs.forward.launches_by[key], fs.backward.launches_by[key]
    out = fs.forward(*args, c)
    ref = fs.fused_stack_forward_reference(*args, c)
    ref32 = fs.fused_stack_forward_reference(*args, c32)
    torch.cuda.synchronize()
    assert fs.forward.launches_by[key] == f0 + 1
    for name, got, want, want32 in zip(("y", "fg", "z"), out, ref, ref32):
        assert got.dtype == want.dtype, name
        if bf16:
            _hold_bf16(got, want, want32, name)
        else:
            _hold_scaled(got, want, FWD_TOL, 0, name)
    again = fs.forward(*args, c)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = ref
    grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    assert fs.backward.launches_by[key] == b0 + 1
    for name, got, want, want32, lead in zip(
            ("dx", "dw_fg", "dwd", "dadd", "dbd"), grads, gref, gref32,
            _GRAD_LEADS):
        assert got.dtype == torch.float32, name
        if bf16:
            _hold_bf16(got, want, want32, name)
        else:
            _hold_scaled(got, want, GRAD_TOL, lead, name)
    again = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))

    # The autograd op at width 64 (the route the model takes) against the
    # wrappers it calls.
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, z = fs.fused_stack3(*leaves, c)
    (y * dy).sum().add((z.float() * dz).sum()).backward()
    want = fs.backward(y.detach(), dy, out[1], dz.to(z.dtype), w_fg, wd,
                       bd, c)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


def _zero_stack(R, D, L=2, B=2, T=64):
    x = torch.zeros(B, T, R, device="cuda")
    w = (torch.zeros(L, 2 * R, 2 * D, device="cuda"),
         torch.zeros(L, D, R, device="cuda"),
         torch.zeros(L, B, 2 * D, device="cuda"),
         torch.zeros(L, 1, R, device="cuda"))
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_stack_refuses_unbuilt_widths(setup, bf16):
    """No fallback at the widths a kernel lacks: "simt" pinned at 64,
    "mma" and "simt" pinned at 128 and at R != D (which the route sends to
    "tiled", and "tiled" runs), and every kernel at a D the TPU kernel's
    records do not pack, raise and launch nothing."""
    def cfg(R, D):
        c = WaveNetConfig(dilations=(1, 2), residual_channels=R,
                          dilation_channels=D, skip_channels=16,
                          quantization_channels=32)
        return _bf16(c) if bf16 else c

    c64, args, _ = _stack_inputs(64, (1, 2), 2, 64)
    n = (fs.forward.launches, fs.backward.launches)
    with pytest.raises(NotImplementedError, match="not built for R=64"):
        fs.forward(*args, cfg(64, 64), kernel="simt")
    x, w = _zero_stack(128, 128)
    for kernel in ("mma", "simt"):
        with pytest.raises(NotImplementedError, match="not built for R=128"):
            fs.forward(x, *w, cfg(128, 128), kernel=kernel)
    for R, D in ((128, 64), (64, 32), (16, 8)):
        c = cfg(R, D)
        x, w = _zero_stack(R, D)
        assert fs.stack_kernel_plan(c) == "tiled"
        for kernel in ("mma", "simt"):
            with pytest.raises(NotImplementedError,
                               match=f"not built for R={R}, D={D}"):
                fs.forward(x, *w, c, kernel=kernel)
    c = cfg(48, 48)
    x, w = _zero_stack(48, 48)
    with pytest.raises(NotImplementedError, match="TPU kernel's widths"):
        fs.stack_kernel_plan(c)
    for kernel in ("auto", "mma", "simt", "tiled"):
        with pytest.raises(NotImplementedError, match="TPU kernel's supports"):
            fs.forward(x, *w, c, kernel=kernel)
    assert (fs.forward.launches, fs.backward.launches) == n
    lib, _ = fs._lib("tiled")
    assert all(lib.fused_stack_tiled_supports_width(R, D)
               for R, D in ((1, 1), (6, 16), (128, 64), (3, 256)))
    assert not any(lib.fused_stack_tiled_supports_width(R, D)
                   for R, D in ((0, 8), (8, 0), (48, 48), (64, 192)))
    key = "tiled_bf16" if bf16 else "tiled"
    for R, D in ((128, 64), (64, 32), (16, 8)):
        t0 = fs.forward.launches_by[key]
        x, w = _zero_stack(R, D)
        y, _, _ = fs.forward(x, *w, cfg(R, D), kernel="auto")
        torch.cuda.synchronize()
        assert torch.equal(y, x)
        assert fs.forward.launches_by[key] == t0 + 1


@pytest.mark.gpu
def test_fused_stack_bf16_rejects_what_it_lacks(setup):
    """At bf16, R != D raises on the kernels that lack it ("mma",
    "simt"); R = D = 128 runs on "tiled_bf16", and "mma" or "simt" pinned
    there raise; a float32 fg record is refused."""
    c32, args, (dy, dz) = _stack_inputs(32, (1, 2), 2, 64)
    c = _bf16(c32)
    n = fs.forward.launches
    for R, D in ((128, 64), (16, 8)):
        cw = _bf16(WaveNetConfig(dilations=(1, 2), residual_channels=R,
                                 dilation_channels=D, skip_channels=16,
                                 quantization_channels=32))
        x, w = _zero_stack(R, D)
        for kernel in ("mma", "simt"):
            with pytest.raises(NotImplementedError, match="not built for"):
                fs.forward(x, *w, cw, kernel=kernel)
    c128 = _bf16(WaveNetConfig(dilations=(1, 2), residual_channels=128,
                               dilation_channels=128, skip_channels=16,
                               quantization_channels=32))
    x, w = _zero_stack(128, 128)
    for kernel in ("mma", "simt"):
        with pytest.raises(NotImplementedError, match="not built for R=128"):
            fs.forward(x, *w, c128, kernel=kernel)
    y, fg, _ = fs.fused_stack_forward_reference(*args, c)
    w_fg, wd, _, bd = args[1:]
    with pytest.raises(ValueError, match="fg"):   # a float32 fg record
        fs.backward(y, dy, fg.float(), dz, w_fg, wd, bd, c)
    assert fs.forward.launches == n
    t0 = fs.forward.launches_by["tiled_bf16"]
    _, fg128, _ = fs.forward(x, *w, c128)
    torch.cuda.synchronize()
    assert fg128.dtype == torch.bfloat16
    assert fs.forward.launches_by["tiled_bf16"] == t0 + 1


def _tiled_case(W, dilations, B, T, gc, bf16):
    c32, args, (dy, dz) = _stack_inputs(W, dilations, B, T)
    if not gc:
        add = args[3]
        args = args[:3] + (add[:, :1].expand_as(add).contiguous(),) + args[4:]
    return c32, (_bf16(c32) if bf16 else c32), args, dy, dz


def _hold_tiled(out, ref, ref32, grads, gref, gref32, bf16):
    for name, got, want, want32 in zip(("y", "fg", "z"), out, ref, ref32):
        assert got.dtype == want.dtype, name
        if bf16:
            _hold_bf16(got, want, want32, name)
        else:
            _hold_scaled(got, want, FWD_TOL, 0, name)
    for name, got, want, want32, lead in zip(
            ("dx", "dw_fg", "dwd", "dadd", "dbd"), grads, gref, gref32,
            _GRAD_LEADS):
        assert got.dtype == torch.float32, name
        if bf16:
            _hold_bf16(got, want, want32, name)
        else:
            _hold_scaled(got, want, GRAD_TOL, lead, name)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("W,dilations,B,T,gc", [
    (128, (1, 2, 64, 512, 7), 3, 700, True),
    (256, (1, 33, 4, 128), 1, 1100, False),
    (384, (1, 2, 4), 3, 150, True),
    ((16, 8), (1, 2, 4), 2, 150, True),
    ((6, 16), (1, 2, 4), 2, 150, False),      # R = 6: rows off 16 bytes
    ((48, 128), (1, 65, 2), 3, 700, True),
    ((128, 64), (1, 2, 64, 512, 7), 3, 700, True),
    ((64, 128), (1, 33, 4, 128), 1, 1100, False),
    ((1, 1), (1, 2, 4, 8), 3, 300, True),     # rows off 16 bytes
    ((2, 2), (1, 2, 4), 2, 150, False),
    ((4, 4), (1, 2, 4, 64), 2, 700, True),
    ((3, 256), (1, 2), 2, 150, False),
])
def test_fused_stack_tiled_matches_reference(setup, W, dilations, B, T, gc,
                                             bf16):
    """csrc/fused_stack_tiled.cu against the plain versions in both modes
    at R = D = 128, 256 (the sharded width) and 384, and at the widths
    whose tiles are ragged (W = (R, D): R != D, and R = D in 1, 2, 4, the
    route's "tiled" there; at a width that is not a multiple of 64 the
    kernel checks every edge and copies 4 bytes at a time, so the operand
    rows may start off 16 bytes, as at R = 6, 3 and R = D = 1, 2): T not
    a multiple of the 64-row tile, B 1 and 3 (row tiles that cross batch
    rows), a dilation of several tiles, ``add`` per batch row (gc) or one
    for all rows; forward, backward and the op, each output held as
    test_fused_stack_mma_width64 holds it; launches_by counts the mode
    that ran; repeats are bitwise equal."""
    c32, c, args, dy, dz = _tiled_case(W, dilations, B, T, gc, bf16)
    key = "tiled_bf16" if bf16 else "tiled"
    assert fs.stack_kernel_plan(c) == "tiled"
    f0, b0 = fs.forward.launches_by[key], fs.backward.launches_by[key]
    out = fs.forward(*args, c)
    ref = fs.fused_stack_forward_reference(*args, c)
    ref32 = fs.fused_stack_forward_reference(*args, c32)
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = ref
    grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    assert fs.forward.launches_by[key] == f0 + 1
    assert fs.backward.launches_by[key] == b0 + 1
    _hold_tiled(out, ref, ref32, grads, gref, gref32, bf16)
    again = fs.forward(*args, c)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    again = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))

    leaves = [a.clone().requires_grad_(True) for a in args]
    y, z = fs.fused_stack3(*leaves, c)
    (y * dy).sum().add((z.float() * dz).sum()).backward()
    want = fs.backward(y.detach(), dy, out[1], dz.to(z.dtype), w_fg, wd,
                       bd, c)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_stack_tiled_matches_mma_at_64(setup, bf16):
    """The tiled kernel pinned at R = D = 64, where fused_stack_mma (an
    independent design: weights resident, one launch a layer forward)
    computes the same stack: both within their tolerances of the plain
    versions and of each other."""
    c32, c, args, dy, dz = _tiled_case(64, (1, 64, 2, 33, 512, 7), 2, 1100,
                                       True, bf16)
    ref = fs.fused_stack_forward_reference(*args, c)
    ref32 = fs.fused_stack_forward_reference(*args, c32)
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = ref
    gref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    got = {}
    for k in ("tiled", "mma"):
        out = fs.forward(*args, c, kernel=k)
        grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c, kernel=k)
        torch.cuda.synchronize()
        _hold_tiled(out, ref, ref32, grads, gref, gref32, bf16)
        got[k] = list(out) + list(grads)
    if not bf16:
        for i, (a, b) in enumerate(zip(got["tiled"], got["mma"])):
            _hold_scaled(a, b, FWD_TOL if i < 3 else GRAD_TOL, 0,
                         "tiled vs mma")


@pytest.mark.gpu
@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "stack"])
def test_model_bf16_on_the_card_matches_the_cpu(setup, pallas):
    """The model at bf16 on the card (the plain route's cuBLAS bf16 GEMMs,
    or the stack kernel's bf16 mode) against the same model's plain bf16
    on the CPU: its mean distance is a small part of bf16's own distance
    from float32, and the logits come back float32."""
    import dataclasses
    from wavenet_torch.models import wavenet as tw
    c32 = WaveNetConfig(dilations=(1, 2, 4, 8, 16, 1, 2, 4, 8, 16),
                        residual_channels=32, dilation_channels=32,
                        skip_channels=64, quantization_channels=64,
                        gc_channels=4, gc_cardinality=4,
                        use_pallas_stack=pallas)
    c16 = dataclasses.replace(c32, compute_dtype="bfloat16")
    params = init_params(0, c32, device="cpu")
    rng = np.random.RandomState(0)
    codes = torch.as_tensor(rng.randint(0, 64, (2, 400)))
    ids = torch.as_tensor([1, 3])
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        for name, c in (("32", c32), ("16", c16)):
            with torch.no_grad(), tw.matmul_precision(c):
                out[dev + name] = tw.forward_codes(
                    p, c, codes.to(dev), tw.embed_gc(p, c, ids.to(dev))).cpu()
    assert out["cuda16"].dtype == torch.float32
    gap = (out["cpu16"] - out["cpu32"]).abs()
    err = (out["cuda16"] - out["cpu16"]).abs()
    assert err.mean() <= 0.25 * gap.mean(), (err.mean(), gap.mean())
    assert err.max() <= gap.max(), (err.max(), gap.max())


_GRADS =("dx", "dw", "dwd", "dadd", "dbd")


_CARRY_DIL = {8: (1, 2, 4, 8, 16, 512), 16: (1, 64, 2, 1024, 5),
              32: _DIL10}


@pytest.mark.gpu
@pytest.mark.parametrize("W,dilations,B,T,nchunk,ref64,bf16", [
    (8, _CARRY_DIL[8], 2, 1100, None, False, False),   # v1's limit, d = 512
    (16, _CARRY_DIL[16], 3, 1500, None, False, False),  # v2's, d = 1024
    (32, _CARRY_DIL[32], 2, 1500, None, False, False),
    # A deep wavefront: one row of 157 tiles spread over the card. Each
    # weight gradient sums 20,000 rows, and the float32 plain version's
    # own rounding error is then a sizeable part of GRAD_TOL at a
    # near-zero element: the reference is the plain version in float64.
    (32, _DIL10, 1, 20000, None, True, False),
    # More rows than resident blocks: one block a row (nchunk 1).
    (8, (1, 2, 4, 8, 16, 32), "over", 300, None, False, False),
    # A pinned plan: 3 blocks a row over 8 tiles (not a multiple of 3).
    (16, (1, 200, 3, 64, 7), 2, 946, 3, False, False),
    # The bf16 mode at each width (half a k-step at 8), held on bf16's
    # gap from float32 (_hold_bf16).
    (8, _CARRY_DIL[8], 2, 1100, None, False, True),
    (16, _CARRY_DIL[16], 3, 1500, None, False, True),
    (32, _CARRY_DIL[32], 2, 1500, None, False, True),
])
def test_carry_stack_matches_reference(setup, W, dilations, B, T, nchunk,
                                       ref64, bf16):
    """v1's and v2's wrappers of the carry kernel against the plain
    versions (T is not a multiple of the kernel's 128-step tile, and a
    dilation reaches the generation's ``supports`` limit), on the plan's
    grid or a pinned one; the backward is bitwise repeatable. In the bf16
    mode the records are bf16 and every output is held against the plain
    bf16 versions on the scale of their distance from the float32 ones,
    repeats bitwise, launches counted under "carry_bf16"."""
    if bf16:
        return _carry_bf16_matches_reference(W, dilations, B, T)
    if B == "over":
        c = _stack_inputs(W, dilations, 1, 1)[0]
        B = 1 + max(fs1.device_carry_plan(c, 1, bw)[0] for bw in (0, 1))
        assert all(fs1.device_carry_plan(c, B, bw)[1].nchunk == 1
                   for bw in (0, 1))
    c, args, (dy, dz) = _stack_inputs(W, dilations, B, T)
    dt = torch.float64 if ref64 else torch.float32
    plan = None if nchunk is None else fs1.CarryPlan(nchunk, (nchunk, B))
    counts = (fs1.fused_stack_forward.launches,
              fs2.fused_stack2_forward.launches,
              fs1.fused_stack_backward.launches,
              fs2.fused_stack2_backward.launches)
    y1, fg1 = fs1.fused_stack_forward(*args, c, _plan=plan)
    y2, fg2, z2 = fs2.fused_stack2_forward(*args, c, _plan=plan)
    yr, fgr, zr = fs2.fused_stack2_forward_reference(
        *[a.to(dt) for a in args], c)
    torch.cuda.synchronize()
    for got, ref in ((y1, yr), (fg1, fgr), (y2, yr), (fg2, fgr), (z2, zr)):
        torch.testing.assert_close(got.to(dt), ref, **FWD_TOL)
    w_fg, wd, _, bd = args[1:]
    yr, fgr = yr.float(), fgr.float()
    g1 = fs1.fused_stack_backward(yr, fgr, dz, dy, w_fg, wd, bd, c,
                                  _plan=plan)
    g2 = fs2.fused_stack2_backward(yr, dy, fgr, dz, w_fg, wd, bd, c,
                                   _plan=plan)
    ref = fs2.fused_stack2_backward_reference(
        *[t.to(dt) for t in (yr, dy, fgr, dz, w_fg, wd, bd)], c)
    torch.cuda.synchronize()
    for name, got, want in zip(_GRADS, g1, ref):
        torch.testing.assert_close(got.to(dt), want, **GRAD_TOL, msg=name)
    # One kernel behind both wrappers, fixed-order sums: bitwise equal.
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert torch.equal(y1, y2) and torch.equal(fg1, fg2)
    assert (fs1.fused_stack_forward.launches,
            fs2.fused_stack2_forward.launches,
            fs1.fused_stack_backward.launches,
            fs2.fused_stack2_backward.launches) == tuple(n + 1 for n in counts)


_CARRY_WRAPPERS = (fs1.fused_stack_forward, fs2.fused_stack2_forward,
                   fs1.fused_stack_backward, fs2.fused_stack2_backward)


def _carry_bf16_matches_reference(W, dilations, B, T):
    c32, args, (dy, dz) = _stack_inputs(W, dilations, B, T)
    c = _bf16(c32)
    counts = [w.launches_by["carry_bf16"] for w in _CARRY_WRAPPERS]
    y1, fg1 = fs1.fused_stack_forward(*args, c)
    y2, fg2, z2 = fs2.fused_stack2_forward(*args, c)
    again = fs2.fused_stack2_forward(*args, c)
    ref = fs2.fused_stack2_forward_reference(*args, c)
    ref32 = fs2.fused_stack2_forward_reference(*args, c32)
    torch.cuda.synchronize()
    assert (fg1.dtype, fg2.dtype, z2.dtype) == (torch.bfloat16,) * 3
    for name, got, want, want32 in zip(("y", "fg", "z"), (y2, fg2, z2), ref,
                                       ref32):
        _hold_bf16(got, want, want32, name)
    assert torch.equal(y1, y2) and torch.equal(fg1, fg2)
    assert all(torch.equal(a, b) for a, b in zip((y2, fg2, z2), again))
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = ref
    g1 = fs1.fused_stack_backward(yr, fgr, dz, dy, w_fg, wd, bd, c)
    g2 = fs2.fused_stack2_backward(yr, dy, fgr, dz.to(torch.bfloat16), w_fg,
                                   wd, bd, c)
    gref = fs2.fused_stack2_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd,
                                               c)
    gref32 = fs2.fused_stack2_backward_reference(ref32[0], dy, ref32[1], dz,
                                                 w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    for name, got, want, want32 in zip(_GRADS, g1, gref, gref32):
        assert got.dtype == torch.float32, name
        _hold_bf16(got, want, want32, name)
    # A float32 dz is read as its bf16 rounding; fixed-order sums.
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert [w.launches_by["carry_bf16"] for w in _CARRY_WRAPPERS] == [
        counts[0] + 1, counts[1] + 2, counts[2] + 1, counts[3] + 1]


@pytest.mark.gpu
def test_carry_plan_matches_library(setup):
    """``carry_plan`` (pure) against the library's own rule, on the
    library's resident counts of each direction, width and mode (which
    ``device_carry_plan`` reads), and
    ``carry_scratch_floats`` (the size the wrappers allocate) against the
    library's."""
    lib = fs1._lib()
    for W, backward, bf16 in itertools.product((8, 16, 32), (0, 1), (0, 1)):
        n = lib.fused_stack_carry_resident_blocks(backward, W, W, bf16)
        assert n >= 1, (W, backward, bf16, n)
        c = _stack_inputs(W, (1,), 1, 1)[0]
        assert fs1.device_carry_plan(_bf16(c) if bf16 else c, 1,
                                     backward)[0] == n
        for B in (1, 2, 8, 64, n - 1, n, n + 1, 3 * n):
            if B >= 1:
                nchunk = fs1.carry_plan(B, n).nchunk
                assert nchunk == lib.fused_stack_carry_nchunk(
                    backward, B, W, W, bf16), (W, B, bf16)
                for L, sum_d in ((1, 1), (10, 1023), (30, 3069)):
                    assert (fs1.carry_scratch_floats(
                        bool(backward), B, L, W, W, sum_d, nchunk)
                        == lib.fused_stack_carry_scratch_floats(
                            backward, B, L, W, W, sum_d, nchunk))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("W", [8, 32])
def test_carry_stack_across_plans(setup, W, bf16):
    """The same stack on grids of 1, 2, 3, 5 and 20 blocks a row (14
    tiles: 20 leaves blocks without a tile) and on the card's plan: y, fg,
    z and dx bitwise equal (a position's arithmetic does not depend on the
    block that computes it), the weight gradients within GRAD_TOL (summed
    by chunk, in a fixed order), and each grid's repeats bitwise equal; in
    both modes."""
    B, T = 2, 1700
    c, args, (dy, dz) = _stack_inputs(W, (1, 2, 4, 8, 130, 3, 700), B, T, 3)
    if bf16:
        c = _bf16(c)
    w_fg, wd, _, bd = args[1:]
    yr, fgr, _ = fs2.fused_stack2_forward_reference(*args, c)
    plans = [fs1.CarryPlan(n, (n, B)) for n in (1, 2, 3, 5, 20)] + [None]
    outs, grads = [], []
    for plan in plans:
        pair = [fs2.fused_stack2_forward(*args, c, _plan=plan)
                for _ in range(2)]
        gpair = [fs2.fused_stack2_backward(yr, dy, fgr, dz, w_fg, wd, bd, c,
                                           _plan=plan) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*pair)), plan
        assert all(torch.equal(a, b) for a, b in zip(*gpair)), plan
        outs.append(pair[0])
        grads.append(gpair[0])
    for out, g, plan in zip(outs[1:], grads[1:], plans[1:]):
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0])), plan
        assert torch.equal(g[0], grads[0][0]), plan
        for name, got, want in zip(_GRADS[1:], g[1:], grads[0][1:]):
            torch.testing.assert_close(got, want, **GRAD_TOL, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_carry_stack_ops_match_kernel5(setup, bf16):
    """The autograd ops of v1 and v2 against kernel 5's op (an independent
    kernel for the same map): outputs and every gradient. At bf16, v2's op
    (whose z is the bf16 record, as kernel 5's) against kernel 5's bf16
    mode (R = D = 32, its bf16 width) on the scale of bf16's gap from
    kernel 5's float32 op; v1's z is float32 from the bf16 fg record."""
    W = 32 if bf16 else 16
    c, args, (dy, dz) = _stack_inputs(W, (1, 2, 4, 8, 16, 32, 200), 2, 900,
                                      2)
    ops = (fs.fused_stack3, fs1.fused_stack, fs2.fused_stack2)
    results = []
    for op, cfg in [(op, c) for op in ops] + ([(fs.fused_stack3, _bf16(c)),
                                               (fs2.fused_stack2, _bf16(c)),
                                               (fs1.fused_stack, _bf16(c))]
                                              if bf16 else []):
        leaves = [a.clone().requires_grad_(True) for a in args]
        y, z = op(*leaves, cfg)
        (y * dy).sum().add((z.float() * dz).sum()).backward()
        results.append([y.detach(), z.detach()] + [t.grad for t in leaves])
    for got in results[1:3]:
        for want_t, got_t in zip(results[0], got):
            torch.testing.assert_close(got_t, want_t, **GRAD_TOL)
    if bf16:
        k5, v2, v1 = results[3:]
        assert v2[1].dtype == k5[1].dtype == torch.bfloat16
        assert v1[1].dtype == torch.float32
        for i, (got, want, want32) in enumerate(zip(v2, k5, results[0])):
            _hold_bf16(got, want, want32, i)
        for i, (got, want, want32) in enumerate(zip(v1, k5, results[0])):
            if i != 1:      # v1's z is another function of the records
                _hold_bf16(got, want, want32, i)


def _layer_inputs(W, B, T, seed=0):
    rng = np.random.RandomState(seed)

    def rn(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device="cuda")

    return ((rn(B, T, W, scale=0.5), rn(2, W, 2 * W, scale=0.3),
             rn(W, W, scale=0.3), rn(B, 2 * W, scale=0.1),
             rn(1, W, scale=0.1)), (rn(B, T, W), rn(B, T, W)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("W,d,B,T,ref64", [
    (8, 1, 2, 150, False), (16, 64, 3, 700, False),
    (32, 512, 2, 1500, False), (32, 2000, 1, 1000, False),   # d >= T
    (32, 5, 2, 100, False),      # T below one 128-step tile
    (32, 1, 3, 1000, False),     # d = 1, T not a multiple of the tile
    (16, 300, 2, 300, False),    # d = T: the past tap all zero padding
    (8, 129, 4, 129, False),     # one tile and one row
    # One long row: many tiles a chunk. Each weight gradient sums 150,000
    # rows, where the float32 plain version's own rounding is a sizeable
    # part of GRAD_TOL at a near-zero element: the reference is float64.
    (32, 100, 1, 150000, True),
])
def test_dilated_layer_matches_reference(setup, W, d, B, T, ref64, mode):
    """The layer kernel pair against the plain versions at the edges of
    its 128-step tile and of the dilation, in each mode (bf16 on bf16's gap
    from the plain float32 versions); the backward is bitwise
    repeatable."""
    (x, w, wd, add, bd), (dy, dz) = _layer_inputs(W, B, T)
    dt = torch.float64 if ref64 else torch.float32
    cd = {"f32": torch.float32, "bf16": torch.bfloat16}[mode]
    f0, b0 = dl.forward.launches, dl.backward.launches
    m0 = dl.forward.launches_by[mode], dl.backward.launches_by[mode]
    y, z = dl.forward(x, w, wd, add, bd, d, cd)
    yr, zr = dl.fused_dilated_layer_reference(
        *[t.to(dt) for t in (x, w, wd, add, bd)], d, compute_dtype=cd)
    got = dl.backward(x, w, wd, add, dy, dz, d, cd)
    again = dl.backward(x, w, wd, add, dy, dz, d, cd)
    ref = dl.fused_dilated_layer_backward_reference(
        *[t.to(dt) for t in (x, w, wd, add, dy, dz)], d, compute_dtype=cd)
    torch.cuda.synchronize()
    names = ("dx_local", "dpast", "dw", "dwd", "dadd", "dbd")
    if mode == "f32":
        torch.testing.assert_close(y.to(dt), yr, **FWD_TOL)
        torch.testing.assert_close(z.to(dt), zr, **FWD_TOL)
        for name, g, r in zip(names, got, ref):
            torch.testing.assert_close(g.to(dt), r, **GRAD_TOL, msg=name)
    else:
        assert y.dtype == z.dtype == torch.float32
        y32, z32 = dl.fused_dilated_layer_reference(
            *[t.to(dt) for t in (x, w, wd, add, bd)], d)
        ref32 = dl.fused_dilated_layer_backward_reference(
            *[t.to(dt) for t in (x, w, wd, add, dy, dz)], d)
        for name, g, r, r32 in zip(("y", "z") + names, (y, z) + tuple(got),
                                   (yr, zr) + tuple(ref),
                                   (y32, z32) + tuple(ref32)):
            assert g.dtype == torch.float32, name
            _hold_bf16(g.to(dt), r, r32, name)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (dl.forward.launches, dl.backward.launches) == (f0 + 1, b0 + 2)
    assert (dl.forward.launches_by[mode],
            dl.backward.launches_by[mode]) == (m0[0] + 1, m0[1] + 2)


@pytest.mark.gpu
def test_dilated_layer_refuses_misaligned(setup):
    """The kernel copies x, w, wd and dy by 16-byte cp.async: a view that
    starts off a 16-byte boundary raises instead of launching."""
    (x, w, wd, add, bd), (dy, dz) = _layer_inputs(8, 2, 150)
    flat = torch.zeros(x.numel() + 1, device="cuda")
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        dl.forward(shifted, w, wd, add, bd, 2)
    with pytest.raises(ValueError, match="16-byte"):
        dl.backward(x, w, wd, add, shifted, dz, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [0, 1], ids=["f32", "bf16"])
def test_dilated_layer_tiling_matches_library(setup, bf16):
    """``layer_tiling`` (pure) against the library's own grid, on the
    library's resident counts of each mode, direction and width, and the
    backward's scratch size against the grid it implies."""
    lib = dl._lib()
    cd = (torch.float32, torch.bfloat16)[bf16]
    for W in (8, 16, 32):
        for backward in (0, 1):
            n = lib.dilated_layer_resident_blocks(backward, W, W, bf16)
            assert n >= 1, (W, backward, n)
            assert dl.device_layer_tiling(bool(backward), 8, 19070, W, W,
                                          cd)[0] == n
            for B in (1, 2, 8, n - 1, n, n + 1, 3 * n):
                for T in (1, 100, 128, 129, 19070, 150000):
                    if B < 1:
                        continue
                    tl = dl.layer_tiling(B, T, n)
                    assert tl.nchunk == lib.dilated_layer_nchunk(
                        backward, B, T, W, W, bf16), (W, backward, B, T)
                    if backward:
                        assert lib.dilated_layer_bwd_scratch_floats(
                            B, T, W, W, bf16) == B * tl.nchunk * (
                                5 * W * W + 3 * W), (W, B, T)
    assert lib.dilated_layer_nchunk(0, 1, 100, 24, 24, bf16) < 0
    assert lib.dilated_layer_nchunk(0, 1, 0, 32, 32, bf16) < 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_dilated_layer_op_gradients(setup, mode):
    """``fused_dilated_layer`` on the card against autograd of the plain
    forward (the tap-0 gradient shift-added by the op); at bf16 against the
    op's plain bf16 versions on the CPU, on bf16's gap from the float32
    op there."""
    args, (dy, dz) = _layer_inputs(32, 2, 1000, 1)
    if mode == "f32":
        grads = []
        for fn in (dl.fused_dilated_layer, dl.fused_dilated_layer_reference):
            leaves = [a.clone().requires_grad_(True) for a in args]
            y, z = fn(*leaves, 100)
            (y * dy).sum().add((z * dz).sum()).backward()
            grads.append([t.grad for t in leaves])
        for name, g, r in zip(_GRADS, *grads):
            torch.testing.assert_close(g, r, **GRAD_TOL, msg=name)
        return
    grads = []
    for dev, cd in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                    ("cpu", torch.float32)):
        leaves = [a.to(dev).clone().requires_grad_(True) for a in args]
        y, z = dl.fused_dilated_layer(*leaves, 100, compute_dtype=cd)
        (y * dy.to(dev)).sum().add((z * dz.to(dev)).sum()).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for name, g, r, r32 in zip(_GRADS, *grads):
        _hold_bf16(g, r, r32, name)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["w", "x"])
@pytest.mark.parametrize("kernel", ["stack_mma", "carry", "layer_fwd",
                                    "layer_bwd"])
def test_tf32_kernels_keep_device_nan(setup, kernel, where):
    """A NaN made on the card (0 / 0, whose bits 0x7fffffff the TF32
    rounding's carry would wrap round to -0) in one weight or one x element
    of a 3xTF32 kernel: each output is non-finite exactly where the plain
    version's is, so a diverged weight is not hidden as a finite output."""
    nan = torch.zeros(1, device="cuda") / 0
    assert torch.isnan(nan).item()
    W = 32
    if kernel.startswith("layer"):
        d = 5
        (x, w, wd, add, bd), (dy, dz) = _layer_inputs(W, 2, 300)
        if where == "w":
            w[1, 3, 5] = nan[0]          # the current tap's weight
        else:
            x[0, 100, 3] = nan[0]
        if kernel == "layer_fwd":
            got = dl.forward(x, w, wd, add, bd, d)
            ref = dl.fused_dilated_layer_reference(x, w, wd, add, bd, d)
        else:
            got = dl.backward(x, w, wd, add, dy, dz, d)
            ref = dl.fused_dilated_layer_backward_reference(
                x, w, wd, add, dy, dz, d)
    else:
        c, (x, w_fg, wd, add, bd), _ = _stack_inputs(W, (1, 2, 4), 2, 300)
        if where == "w":
            w_fg[1, W + 3, 5] = nan[0]   # layer 1, the current tap's row
        else:
            x[0, 100, 3] = nan[0]
        args = (x, w_fg, wd, add, bd)
        if kernel == "stack_mma":
            got = fs.forward(*args, c, kernel="mma")
        else:
            got = fs1.carry_forward(*args, c, True)
        ref = fs.fused_stack_forward_reference(*args, c)
    torch.cuda.synchronize()
    bads = [~torch.isfinite(r) for r in ref]
    assert all(b.any() for b in bads[:3])    # dbd (sum of dy) stays finite
    for i, (g, bad) in enumerate(zip(got, bads)):
        assert torch.equal(~torch.isfinite(g), bad), i


def _bad_stack_calls(c, args, dy, dz):
    x, w_fg, wd, add, bd = args
    y, fg, _ = fs2.fused_stack2_forward_reference(*args, c)
    return {
        "v1_fwd": lambda x_: fs1.fused_stack_forward(x_, w_fg, wd, add, bd, c),
        "v2_fwd": lambda x_: fs2.fused_stack2_forward(x_, w_fg, wd, add, bd,
                                                      c),
        "v1_bwd": lambda y_: fs1.fused_stack_backward(y_, fg, dz, dy, w_fg,
                                                      wd, bd, c),
        "v2_bwd": lambda y_: fs2.fused_stack2_backward(y_, dy, fg, dz, w_fg,
                                                       wd, bd, c),
    }, x, y


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper", ["v1_fwd", "v2_fwd", "v1_bwd", "v2_bwd",
                                     "layer_fwd", "layer_bwd"])
def test_new_wrappers_reject_bad_inputs(setup, wrapper):
    if wrapper.startswith("layer"):
        (x, w, wd, add, bd), (dy, dz) = _layer_inputs(8, 2, 64)
        call = ((lambda x_: dl.forward(x_, w, wd, add, bd, 3))
                if wrapper == "layer_fwd" else
                (lambda x_: dl.backward(x_, w, wd, add, dy, dz, 3)))
        lead = x
        # R = 8, D = 16: the route runs it on the tiled layer entries.
        wide = lambda: dl.forward(x, torch.zeros((2, 8, 32), device="cuda"),
                                  torch.zeros((16, 8), device="cuda"),
                                  torch.zeros((2, 32), device="cuda"), bd, 3)
    else:
        c, args, (dy, dz) = _stack_inputs(8, (1, 2), 2, 64)
        calls, x, y = _bad_stack_calls(c, args, dy, dz)
        call = calls[wrapper]
        lead = x if wrapper.endswith("fwd") else y
        odd = WaveNetConfig(dilations=(1, 2), residual_channels=8,
                            dilation_channels=16, skip_channels=16,
                            quantization_channels=32)
        # v1's route runs R != D on kernel 5's kernels; the carry kernel
        # pinned refuses it.
        wide = lambda: fs1.fused_stack_forward(*args, odd, kernel="carry")
    with pytest.raises(ValueError, match="float32"):
        call(lead.double())
    with pytest.raises(ValueError, match="contiguous"):
        call(lead.transpose(0, 1).contiguous().transpose(0, 1))
    if wrapper.startswith("layer"):
        n = dl.forward.launches_by["tiled_f32"]
        y, z = wide()
        assert y.shape == x.shape and z.shape == x.shape[:2] + (16,)
        assert dl.forward.launches_by["tiled_f32"] == n + 1
    else:
        with pytest.raises(NotImplementedError, match="R == D"):
            wide()


# ---------------------------------------------------------------------------
# The probes (wavenet_torch.tools): TPU kernels 9 and 10
# ---------------------------------------------------------------------------

from wavenet_torch.tools import r2_fwd_bisect as r2  # noqa: E402
from wavenet_torch.tools import r2_fwd_bisect2 as r2b  # noqa: E402
from wavenet_torch.tools import r3_b1_bisect as r3  # noqa: E402
from wavenet_torch.tools import r4_matvec_probe as r4  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# bf16 operands: another summation order can flip a bf16 rounding (one bf16
# ulp, 2**-8 relative), which the following layers carry on.
PROBE_TOL = {"f32": 1e-4, "bf16": 2e-2}


def _close(got, ref, rtol, what):
    """|got - ref| <= rtol * max|ref| + rtol * 1e-2 everywhere."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), what
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= rtol * scale + rtol * 1e-2, f"{what}: {err} of {scale}"


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("variant", r2.VARIANTS)
def test_fwd_bisect_matches_reference(setup, variant, dt):
    """Every r2 variant at R = D = 16 over dilations on both sides of the
    64-row tile (the rolled tile's halo shorter and longer than the tile);
    T not a multiple of the tile."""
    c, args, _ = _stack_inputs(16, (1, 2, 63, 64, 100, 512), 2, 700)
    before = r2.fwd_bisect.launches
    got = r2.fwd_bisect(*args, c, variant, DTYPES[dt], kernel="simt")
    ref = r2.fwd_bisect_reference(*args, c, variant, DTYPES[dt],
                                  kernel="simt")
    torch.cuda.synchronize()
    assert r2.fwd_bisect.launches == before + 1
    for name, a, b in zip(("y", "fg", "z"), got, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            _close(a, b, PROBE_TOL[dt], f"{variant} {dt} {name}")


@pytest.mark.gpu
def test_fwd_bisect_full_f32_is_kernel5(setup):
    """At float32, ``full`` and ``rolled`` emit kernel 5's y, fg and z
    bitwise (the same instantiation; the same FMA order)."""
    c, args, _ = _stack_inputs(32, (1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
                               2, 1500)
    want = fs.forward(*args, c, kernel="simt")
    for variant in ("full", "rolled"):
        got = r2.fwd_bisect(*args, c, variant, kernel="simt")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), variant


def _r2b_args(seed, L=3, W=32):
    """r2b's inputs at R = D = 32: x [2, 300, W], w_fg, wd, wfat."""
    rng = np.random.RandomState(seed)

    def rn(*shape, scale):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device="cuda")

    return (rn(2, 300, W, scale=1.0), rn(L, 2 * W, 2 * W, scale=0.2),
            rn(L, W, W, scale=0.2), rn(L, 4 * W, 3 * W, scale=0.2))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tile", sorted(r2b.TILES))
@pytest.mark.parametrize("variant", r2b.VARIANTS)
def test_fwd_bisect2_matches_reference(setup, variant, tile, dt):
    """Every r2b variant at both tiles (R = D = 32, the width it is built
    for; 600 rows, not a multiple of the block)."""
    args = _r2b_args(4)
    before = r2b.fwd_bisect2.launches
    got = r2b.fwd_bisect2(*args, variant, tile, DTYPES[dt], kernel="simt")
    ref = r2b.fwd_bisect2_reference(*args, variant, tile, DTYPES[dt],
                                    kernel="simt")
    torch.cuda.synchronize()
    assert r2b.fwd_bisect2.launches == before + 1
    _close(got, ref, PROBE_TOL[dt], f"{variant} {tile} {dt}")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("variant", r2.VARIANTS)
def test_fwd_bisect_mma_matches_reference(setup, variant, W, dt):
    """Every r2 variant on the tensor cores (fused_stack_mma's forward with
    parts masked) at both widths, over dilations on both sides of the
    64-row tile (the rolled halo shorter and longer than the tile), T not
    a multiple of the tile: against its plain version, repeats bitwise,
    counted under "mma_<variant>_<dtype>"."""
    c, args, _ = _stack_inputs(W, (1, 2, 63, 64, 100, 512), 2, 700)
    key = f"mma_{variant}_{dt}"
    before = r2.fwd_bisect.launches_by[key]
    got = r2.fwd_bisect(*args, c, variant, DTYPES[dt], kernel="mma")
    again = r2.fwd_bisect(*args, c, variant, DTYPES[dt], kernel="mma")
    ref = r2.fwd_bisect_reference(*args, c, variant, DTYPES[dt],
                                  kernel="mma")
    torch.cuda.synchronize()
    assert r2.fwd_bisect.launches_by[key] == before + 2
    for name, a, a2, b in zip(("y", "fg", "z"), got, again, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            assert torch.equal(a, a2), f"{variant} {dt} {name}: repeats"
            _close(a, b, PROBE_TOL[dt], f"{variant} W{W} {dt} {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("W", [32, 64])
def test_fwd_bisect_mma_full_is_stack_mma(setup, W, dt):
    """On mma, ``full`` and ``rolled`` emit ``fused_stack.forward(kernel=
    "mma")``'s y, fg and z bitwise in the mode of the dtype (the same
    instantiation at the full mask; the same products in the same
    order)."""
    c, args, _ = _stack_inputs(W, _DIL10, 2, 1500)
    cm = c if dt == "f32" else dataclasses.replace(
        c, compute_dtype="bfloat16")
    want = fs.forward(*args, cm, kernel="mma")
    for variant in ("full", "rolled"):
        got = r2.fwd_bisect(*args, c, variant, DTYPES[dt], kernel="mma")
        torch.cuda.synchronize()
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want)), variant


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tile", sorted(r2b.TILES))
@pytest.mark.parametrize("variant", r2b.VARIANTS)
def test_fwd_bisect2_mma_matches_reference(setup, variant, tile, dt):
    """Every r2b variant on the tensor cores at both tiles (600 rows, not a
    multiple of the block): against its plain version, repeats bitwise,
    counted under "mma_<variant>_<tile>_<dtype>"."""
    args = _r2b_args(5)
    key = f"mma_{variant}_{tile}_{dt}"
    before = r2b.fwd_bisect2.launches_by[key]
    got = r2b.fwd_bisect2(*args, variant, tile, DTYPES[dt], kernel="mma")
    again = r2b.fwd_bisect2(*args, variant, tile, DTYPES[dt], kernel="mma")
    ref = r2b.fwd_bisect2_reference(*args, variant, tile, DTYPES[dt],
                                    kernel="mma")
    torch.cuda.synchronize()
    assert r2b.fwd_bisect2.launches_by[key] == before + 2
    assert torch.equal(got, again), f"{variant} {tile} {dt}: repeats"
    _close(got, ref, PROBE_TOL[dt], f"mma {variant} {tile} {dt}")


B1_SMALL = dict(dilations=(1, 2, 4, 8, 16, 1, 2, 4), residual_channels=16,
                dilation_channels=16, skip_channels=64,
                quantization_channels=64)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", r3.MODES)
def test_b1_bisect_matches_reference(setup, mode, dt):
    """Every r3 mode: the kernel's codes replayed by the plain version
    (teacher-forced logits plus the same Philox noise) agree, and at
    float32 ``full`` emits ``decode_sequential``'s codes."""
    c = WaveNetConfig(**B1_SMALL)
    packed = ks.pack_sampler_weights(_seeded_params(c), c, 1,
                                     weight_dtype=DTYPES[dt])
    n, seed, Q = 400, 9, c.quantization_channels
    before = r3.b1_bisect.launches
    codes = r3.b1_bisect(packed, c, mode, n, seed, kernel="decode")
    torch.cuda.synchronize()
    assert r3.b1_bisect.launches == before + 1
    assert codes.shape == (1, n) and 0 <= codes.min() and codes.max() < Q
    first = torch.full((1, 1), Q // 2, dtype=torch.int32, device="cuda")
    lg = r3.b1_bisect_logits(packed, c, mode,
                             torch.cat([first, codes[:, :-1]], dim=1))[0]
    if mode != "no_sample":
        lg = lg + ks.gumbel_noise(seed, 1, 0, n, Q, "cuda")[:, 0]
    match = (lg.argmax(dim=-1) == codes[0].long()).float().mean().item()
    assert match >= 0.995, match
    if mode == "full":
        want, _ = ks.decode_sequential(packed, c, first, n, seed,
                                       kernel="decode")
        assert torch.equal(codes, want)


# The cluster kernel's plans at B1_SMALL: the device's (one CTA there), and
# 2 and 4 CTAs, whose hand-offs, skip partials and head split the step.
B1_PLANS = [None, ks.ClusterPlan(2, 1, (0, 4, 8)),
            ks.ClusterPlan(4, 1, (0, 2, 4, 6, 8))]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", r3.MODES)
@pytest.mark.parametrize("plan", B1_PLANS,
                         ids=lambda p: "device" if p is None else f"cs{p.CS}")
def test_b1_bisect_cluster_matches_reference(setup, plan, mode, dt):
    """Every r3 mode on the cluster kernel: its codes replayed by the plain
    version in the cluster kernel's order (teacher-forced logits plus the
    same Philox noise) agree, and ``full`` emits the production launch's
    codes (``decode_sequential(kernel="cluster")`` on the device's plan)
    at both weight types."""
    c = WaveNetConfig(**B1_SMALL)
    packed = ks.pack_sampler_weights(_seeded_params(c), c, 1,
                                     weight_dtype=DTYPES[dt])
    n, seed, Q = 400, 9, c.quantization_channels
    key = f"cluster_{mode}_{dt}"
    before = r3.b1_bisect.launches_by[key]
    codes = r3.b1_bisect(packed, c, mode, n, seed, kernel="cluster",
                         plan=plan)
    torch.cuda.synchronize()
    assert r3.b1_bisect.launches_by[key] == before + 1
    assert codes.shape == (1, n) and 0 <= codes.min() and codes.max() < Q
    used = plan or ks.device_plan(c, 1)
    first = torch.full((1, 1), Q // 2, dtype=torch.int32, device="cuda")
    lg = r3.b1_bisect_logits(packed, c, mode,
                             torch.cat([first, codes[:, :-1]], dim=1),
                             kernel="cluster", plan=used)[0]
    if mode != "no_sample":
        lg = lg + ks.gumbel_noise(seed, 1, 0, n, Q, "cuda")[:, 0]
    match = (lg.argmax(dim=-1) == codes[0].long()).float().mean().item()
    assert match >= 0.995, match
    if mode == "full":
        ring, causal = ks.zero_state(c, 1, "cuda")
        want, _, name = ks._launch(packed, c, ring, causal, first, n, 0,
                                   seed, 1.0, False, route="sequential",
                                   kernel="cluster", plan=used)
        assert name.startswith("cluster") and torch.equal(codes, want)
        if plan is None:
            want, _ = ks.decode_sequential(packed, c, first, n, seed,
                                           kernel="cluster")
            assert torch.equal(codes, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_b1_bisect_cluster_phase_clock(setup, dt):
    """The phase clock at the paper widths on the device's plan (the
    compiled widths): each CTA's phases add up to its step loop within 5%,
    every CTA waits for its hand-off or runs the causal product, and a read
    zeroes the clock."""
    from wavenet_torch.models.config import paper_config
    c = paper_config()
    plan = ks.device_plan(c, 1)
    packed = ks.pack_sampler_weights(_seeded_params(c), c, 1,
                                     weight_dtype=DTYPES[dt])
    r3.b1_bisect_phase_cycles(plan.CS, DTYPES[dt])            # zero it
    n = 300
    r3.b1_bisect(packed, c, "full", n, kernel="cluster")
    phases, steps = r3.b1_bisect_phase_cycles(plan.CS, DTYPES[dt])
    assert phases.shape == (plan.CS, len(r3.PHASES))
    total = phases.astype(np.float64).sum(axis=1)
    assert (steps > 0).all()
    np.testing.assert_allclose(total, steps.astype(np.float64), rtol=0.05)
    ring_wait = phases[:, r3.PHASES.index("ring_wait")]
    assert (ring_wait > 0).all()
    again, steps2 = r3.b1_bisect_phase_cycles(plan.CS, DTYPES[dt])
    assert not again.any() and not steps2.any()


from wavenet_torch.tools import decode_turns  # noqa: E402

# decode_turns' digests of the tree before the ablation mask and the phase
# clock entered sampler_cluster.cuh (commit 0a6887c, on an H100 80GB HBM3):
# the production modes must compute the same codes and logits bit for bit.
PARENT_DIGESTS = {
    "paper_b1_f32": "ac112a206f322c99", "paper_b1_bf16": "3cb3b9d7494cbf59",
    "gc_b64_f32": "521c79637c03ff5f", "gc_b64_bf16": "3d49f35570c61e72",
    "wide_b1_f32": "2f33e4267389f3e3", "wide_b1_bf16": "656182c6574b76fd",
    "lc_b1_f32": "8da970ac2a18ac09"}


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(PARENT_DIGESTS))
def test_cluster_kernels_keep_their_digests(setup, key):
    name, dt = key.rsplit("_", 1)
    assert decode_turns.digest(name, dt) == PARENT_DIGESTS[key]


# decode_turns' digests of the LC modes on an H100 80GB HBM3: the float32
# one on sampler_decode is the tree's before the bf16 LC modes (commit
# e23ff56; its cluster twin, lc_b1_f32, is in PARENT_DIGESTS), the bf16 ones
# those of the first tree that had the bf16 LC modes.
LC_DIGESTS = {"lc_b256_f32": "1dd3e547ffe10554",
              "lc_b256_bf16": "f1e6bb62f5462938",
              "lc_b1_bf16": "2479e8a10ab0600a"}


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(LC_DIGESTS))
def test_lc_modes_keep_their_digests(setup, key):
    name, dt = key.rsplit("_", 1)
    kernel = ("decode" if name in dict(decode_turns.DECODE_CASES)
              else "cluster")
    assert decode_turns.digest(name, dt, kernel) == LC_DIGESTS[key]


# decode_turns' float32 tiles digests of the tree before the tiles kernel's
# body became a template of the weight type (commit 99adafc, on an H100 80GB
# HBM3): the float32 mode must compute the same codes and logits bit for bit.
PARENT_TILE_DIGESTS = {"gc_b128_f32": "d50e280f990acd8d",
                       "gc_b512_f32": "b7aaa7d36c69e944"}


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(PARENT_TILE_DIGESTS))
def test_tiles_f32_keeps_its_digests(setup, key):
    name, dt = key.rsplit("_", 1)
    kernel = dict(decode_turns.TILE_CASES)[name][dt]
    assert decode_turns.digest(name, dt, kernel) == PARENT_TILE_DIGESTS[key]


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [1, 4])
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("mode", r4.MODES)
def test_matvec_probe_cluster_matches_reference(setup, mode, C, cs):
    """The cluster form at both widths, on one CTA and on four (one pair
    each, four hand-offs a step)."""
    w = r4.orthogonal_weights(8, C, seed=2).cuda()
    wt = w.transpose(1, 2).contiguous()
    key = f"cluster_{mode}"
    before = r4.matvec_probe.launches_by[key]
    got = r4.matvec_probe(w, wt, mode, 20, kernel="cluster", cs=cs)
    ref = r4.matvec_probe_reference(w, wt, mode, 20)
    torch.cuda.synchronize()
    assert r4.matvec_probe.launches_by[key] == before + 1
    assert ref.abs().max().item() > 1e-3
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("mode", r4.MODES)
def test_matvec_probe_matches_reference(setup, mode, C):
    w = r4.orthogonal_weights(8, C, seed=2).cuda()
    wt = w.transpose(1, 2).contiguous()
    before = r4.matvec_probe.launches
    got = r4.matvec_probe(w, wt, mode, 20, kernel="decode")
    ref = r4.matvec_probe_reference(w, wt, mode, 20)
    torch.cuda.synchronize()
    assert r4.matvec_probe.launches == before + 1
    assert ref.abs().max().item() > 1e-3
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_probes_reject_bad_inputs(setup):
    c, args, _ = _stack_inputs(8, (1, 2), 2, 64)
    with pytest.raises(NotImplementedError, match="R == D in"):
        r2.fwd_bisect(*args, c, "full", kernel="simt")
    c16, args16, _ = _stack_inputs(16, (1, 2), 2, 64)
    with pytest.raises(ValueError, match="float32"):
        r2.fwd_bisect(args16[0].double(), *args16[1:], c16, "full",
                      kernel="simt")
    with pytest.raises(NotImplementedError, match="R == D == 32"):
        r2b.fwd_bisect2(args16[0], args16[1], args16[2],
                        torch.zeros((2, 64, 48), device="cuda"), "fat",
                        kernel="simt")
    w = r4.orthogonal_weights(4, 16).cuda()
    for kernel in r4.KERNELS:
        with pytest.raises(NotImplementedError, match="C in"):
            r4.matvec_probe(w, w, "mxu", 1, kernel=kernel)
    w = r4.orthogonal_weights(60, 64).cuda()
    with pytest.raises(ValueError, match="no cluster"):
        r4.matvec_probe(w, w, "mxu", 1, kernel="cluster", cs=2)
    cb = WaveNetConfig(**B1_SMALL)
    packed = ks.pack_sampler_weights(_seeded_params(cb), cb, 2)
    with pytest.raises(ValueError, match="layer_add"):
        r3.b1_bisect(packed, cb, "full", 4)
    packed = ks.pack_sampler_weights(_seeded_params(cb), cb, 1)
    with pytest.raises(ValueError, match="cover the L"):
        r3.b1_bisect(packed, cb, "full", 4, kernel="cluster",
                     plan=ks.ClusterPlan(2, 1, (0, 4, 6)))
    with pytest.raises(ValueError, match="a plan is the cluster"):
        r3.b1_bisect(packed, cb, "full", 4, kernel="decode",
                     plan=ks.ClusterPlan(2, 1, (0, 4, 8)))


# ---------------------------------------------------------------------------
# sampler_cluster: the decode with the layer chain's weights in the shared
# memory of a thread-block cluster
# ---------------------------------------------------------------------------

def _cluster_case(width, B, seed=0):
    """(config, params, packed, prefilled carry, teacher-forced inputs):
    mu-law with GC at the small or the paper widths, or scalar input at the
    wide widths."""
    from wavenet_torch.models.config import gc_config
    if width == "scalar_wide":
        c = WaveNetConfig(**WIDE_SMALL)
    elif width == "paper":
        c = gc_config(gc_cardinality=8)
    elif width == "paper_nogc":
        from wavenet_torch.models.config import paper_config
        c = paper_config()
    else:
        c = WaveNetConfig(**SMALL)
    params = _seeded_params(c, seed)
    rng = np.random.RandomState(seed + B)
    if c.scalar_input:
        x = torch.as_tensor(rng.uniform(-0.9, 0.9, (B, 100))
                            .astype(np.float32), device="cuda")
        gids = None
    else:
        x = torch.as_tensor(rng.randint(0, c.quantization_channels, (B, 100)),
                            dtype=torch.int32, device="cuda")
        gids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                                device="cuda") if c.gc_enabled else None)
    carry = ks.prefill_carry(params, c, x[:, :70], gids)
    packed = ks.pack_sampler_weights(
        params, c, B, None if gids is None else embed_gc(params, c, gids))
    return c, params, packed, carry, x[:, 69:].contiguous()


# Multi-CTA plans at the small widths, where the device's own plan takes
# one CTA a cluster: the hand-off, the split skip sum and the split head.
SMALL_PLANS = [ks.ClusterPlan(2, 1, (0, 4, 8)),
               ks.ClusterPlan(4, 2, (0, 2, 4, 6, 8)),
               ks.ClusterPlan(8, 4, tuple(range(9)))]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("width", ["small", "paper", "scalar_wide"])
def test_cluster_kernel_matches_reference_teacher_forced(setup, width, B):
    c, params, packed, carry, forced = _cluster_case(width, B)
    rk, ck = carry.ring.clone(), carry.causal.clone()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    before = ks.decode.launches_by["cluster"]
    kk, lk = ks.decode(packed, c, rk, ck, forced, 30, carry.t_abs, 3,
                       collect_logits=True, kernel="cluster")
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 30,
                                 carry.t_abs, 3, collect_logits=True)
    torch.cuda.synchronize()
    assert ks.decode.launches_by["cluster"] == before + 1
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=0)
    assert torch.equal(kk[:, :-1], kr[:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("plan", SMALL_PLANS, ids=lambda p: f"cs{p.CS}")
def test_cluster_kernel_multi_cta_plans(setup, plan):
    """Explicit plans at the small widths, with a window of logits and a
    sampled tail replayed by the plain version."""
    c, params, packed, carry, forced = _cluster_case("small", 5)
    rk, ck = carry.ring.clone(), carry.causal.clone()
    codes, lg, used = ks._launch(packed, c, rk, ck, forced[:, :4].contiguous(),
                                 40, carry.t_abs, 9, 1.0, 12, route="decode",
                                 kernel="cluster", plan=plan)
    torch.cuda.synchronize()
    assert used == "cluster" and lg.shape == (5, 12, c.quantization_channels)
    replay = torch.cat([forced[:, :4], codes[:, 3:-1]], dim=1).contiguous()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    kr, lr = ks.decode_reference(packed, c, rr, cr, replay, 40, carry.t_abs,
                                 9, collect_logits=12)
    torch.testing.assert_close(lg, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    assert torch.equal(codes[:, :-1], kr[:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [ks.ClusterPlan(1, 2, (0, 3)),
                                  ks.ClusterPlan(2, 1, (0, 2, 3))],
                         ids=lambda p: f"cs{p.CS}")
def test_cluster_kernel_head_columns_per_thread(setup, plan):
    """S = 512 and Q = 256 over one or two CTAs: a CTA's post1 and post2
    slices of >= 256 columns take the head's one-thread-per-column form."""
    c = WaveNetConfig(dilations=(1, 2, 4), residual_channels=8,
                      dilation_channels=8, skip_channels=512,
                      quantization_channels=256)
    params = _seeded_params(c)
    B = 3
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randint(0, 256, (B, 40)), dtype=torch.int32,
                        device="cuda")
    carry = ks.prefill_carry(params, c, x[:, :20])
    packed = ks.pack_sampler_weights(params, c, B)
    forced = x[:, 19:].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    codes, lg, used = ks._launch(packed, c, rk, ck, forced, 21, carry.t_abs,
                                 2, 1.0, True, route="decode",
                                 kernel="cluster", plan=plan)
    rr, cr = carry.ring.clone(), carry.causal.clone()
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 21, carry.t_abs,
                                 2, collect_logits=True)
    torch.cuda.synchronize()
    assert used == "cluster"
    torch.testing.assert_close(lg, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    assert torch.equal(codes[:, :-1], kr[:, :-1])


@pytest.mark.gpu
def test_cluster_kernel_logits_window_and_next_amp(setup):
    c, params, packed, carry, forced = _cluster_case("scalar_wide", 4)
    first = forced[:, :1].contiguous()
    outs = {}
    for kernel in ("cluster", "decode"):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        amp = torch.empty(4, device="cuda")
        codes, win = ks.decode(packed, c, ring, causal, first, 50,
                               carry.t_abs, 13, collect_logits=7,
                               next_amp=amp, kernel=kernel)
        ring2, causal2 = carry.ring.clone(), carry.causal.clone()
        again, full = ks.decode(packed, c, ring2, causal2, first, 50,
                                carry.t_abs, 13, collect_logits=True,
                                kernel=kernel)
        outs[kernel] = (codes, win, full, amp)
        torch.cuda.synchronize()
        assert torch.equal(codes, again)
        assert torch.equal(win, full[:, -7:])
        # The kernel's own decode of the last code (PyTorch's may differ in
        # the last bit: it divides by a scalar through its reciprocal).
        torch.testing.assert_close(
            amp, ks.decode_amp(codes[:, -1], c.quantization_channels),
            rtol=0, atol=1e-6)
    # The cluster kernel against the plain version on its own inputs.
    codes, _, full, _ = outs["cluster"]
    replay = torch.cat([first, ks.decode_amp(codes[:, :-1],
                                             c.quantization_channels)],
                       dim=1).contiguous()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    _, lr = ks.decode_reference(packed, c, rr, cr, replay, 50, carry.t_abs,
                                13, collect_logits=True)
    torch.testing.assert_close(full, lr, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["small", "paper"])
def test_cluster_kernel_is_deterministic_and_per_row(setup, width):
    """Same seed, same codes; row 0 of b64 (four rows a cluster) equals b1
    (one row a cluster) bit for bit."""
    c, params, packed, carry, _ = _cluster_case(width, 64)

    def run(n):
        ring = carry.ring[:, :n].clone(memory_format=torch.contiguous_format)
        causal = carry.causal[:n].clone()
        pk = packed._replace(layer_add=packed.layer_add[:, :n].contiguous())
        return ks.decode(pk, c, ring, causal,
                         carry.last[:n, None].contiguous(), 200,
                         carry.t_abs, 17, collect_logits=16,
                         kernel="cluster") + (ring,)

    a, la, ra = run(64)
    b, lb, rb = run(64)
    s, ls, rs = run(1)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(la, lb) and torch.equal(ra, rb)
    assert torch.equal(a[:1], s) and torch.equal(la[:1], ls)
    assert torch.equal(ra[:, :1], rs)
    assert len(torch.unique(a)) > 8


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
def test_cluster_scalar_resumable_segments_equal_one_run(setup, B):
    """At the wide widths, three segments resumed from the ring, the
    register and the kernel's own next amplitude equal one launch."""
    c, params, packed, carry, _ = _cluster_case("scalar_wide", B)
    first = carry.last[:, None].contiguous()
    ring, causal = carry.ring.clone(), carry.causal.clone()
    full, _ = ks.decode(packed, c, ring, causal, first, 600, carry.t_abs, 4,
                        kernel="cluster")
    ring, causal = carry.ring.clone(), carry.causal.clone()
    outs, x, t = [], first, carry.t_abs
    for n in (200, 150, 250):
        amp = torch.empty(B, device="cuda")
        seg, _ = ks.decode(packed, c, ring, causal, x, n, t, 4, next_amp=amp,
                           kernel="cluster")
        outs.append(seg)
        x, t = amp[:, None].contiguous(), t + n
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1), full)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["small", "paper", "scalar_wide"])
def test_cluster_teacher_forced_codes_equal_sampler_decode(setup, width):
    c, params, packed, carry, forced = _cluster_case(width, 4)
    got = {}
    for kernel in ("cluster", "decode"):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        got[kernel] = ks.decode(packed, c, ring, causal, forced, 30,
                                carry.t_abs, 3, collect_logits=True,
                                kernel=kernel)
    torch.cuda.synchronize()
    assert torch.equal(got["cluster"][0], got["decode"][0])
    torch.testing.assert_close(got["cluster"][1], got["decode"][1], **TOL)


@pytest.mark.gpu
def test_cluster_wrapper_rejects_bad_inputs(setup):
    c, params, packed, carry, forced = _cluster_case("small", 2)
    first = forced[:, :1].contiguous()
    with pytest.raises(ValueError, match="ring"):
        ks.decode(packed, c, carry.ring.double(), carry.causal, first, 4,
                  carry.t_abs, 0, kernel="cluster")
    with pytest.raises(ValueError, match="forced"):
        ks.decode(packed, c, carry.ring, carry.causal, first.long(), 4,
                  carry.t_abs, 0, kernel="cluster")
    with pytest.raises(ValueError, match="bad plan"):
        ks._launch(packed, c, carry.ring, carry.causal, first, 4,
                   carry.t_abs, 0, 1.0, False, route="decode",
                   kernel="cluster", plan=ks.ClusterPlan(2, 1, (0, 8, 8)))
    with pytest.raises(ValueError, match="bad plan"):
        # A CS that does not divide the skip channels.
        ks._launch(packed, c, carry.ring, carry.causal, first, 4,
                   carry.t_abs, 0, 1.0, False, route="decode",
                   kernel="cluster", plan=ks.ClusterPlan(3, 1, (0, 3, 6, 8)))
    sharded = WaveNetConfig(dilations=(1, 2), residual_channels=256,
                            dilation_channels=256, skip_channels=64,
                            quantization_channels=64)
    sp = _seeded_params(sharded)
    pk = ks.pack_sampler_weights(sp, sharded, 1)
    ring, causal = ks.zero_state(sharded, 1, "cuda")
    with pytest.raises(ValueError, match="no cluster plan"):
        ks.decode(pk, sharded, ring, causal,
                  torch.zeros((1, 1), dtype=torch.int32, device="cuda"), 2,
                  0, 0, kernel="cluster")


@pytest.mark.gpu
def test_decode_routes_by_the_plan(setup):
    """``kernel="auto"``: the cluster kernel at paper b1, the tiles kernel
    at b512 and sampler_decode at the wide config's b64, as ``cluster_plan``
    and ``tile_plan`` say on this device."""
    from wavenet_torch.models.config import paper_config, wide_config
    c = paper_config()
    params = _seeded_params(c)
    for B, want in ((1, "cluster"), (512, "tiles")):
        assert (ks.device_plan(c, B) is None) == (want == "tiles")
        assert (ks.device_tile_plan(c, B) is None) == (want == "cluster")
        before = dict(ks.decode.launches_by)
        codes = ks.generate_cuda(params, c, 8, seed=1, batch_size=B)
        torch.cuda.synchronize()
        after = dict(ks.decode.launches_by)
        for k in ("cluster", "tiles", "decode"):
            assert after.get(k, 0) == before.get(k, 0) + (k == want), k
        assert codes.shape == (B, 8)
    assert ks.device_plan(wide_config(), 64) is None
    assert ks.device_tile_plan(wide_config(), 64) is None


@pytest.mark.gpu
@pytest.mark.parametrize("B,RB", [(90, 6), (100, 7), (120, 8)])
def test_cluster_kernel_at_the_top_of_its_range(setup, B, RB):
    """Six to eight rows a cluster, 15 clusters of 8 CTAs at the gc widths:
    the plans an H100 takes for gc b76-b120."""
    c, params, packed, carry, forced = _cluster_case("paper", B)
    plan = ks.ClusterPlan(8, RB, ks.layer_split(c.num_layers, 8))
    rk, ck = carry.ring.clone(), carry.causal.clone()
    kk, lk, used = ks._launch(packed, c, rk, ck, forced, 30, carry.t_abs, 3,
                              1.0, True, route="decode", kernel="cluster",
                              plan=plan)
    rr, cr = carry.ring.clone(), carry.causal.clone()
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 30,
                                 carry.t_abs, 3, collect_logits=True)
    torch.cuda.synchronize()
    assert used == "cluster"
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=0)
    assert torch.equal(kk[:, :-1], kr[:, :-1])


@pytest.mark.gpu
def test_auto_route_rows_across_the_kernel_boundary(setup):
    """``kernel="auto"`` at the gc widths: b1 and the largest B the plan
    sends to the cluster kernel run it, the next B runs the tiles kernel.
    Within the cluster kernel's range row 0 is bitwise the same; across the
    boundary the two kernels' sums differ in the last bits, so row 0's
    logits agree within TOL up to the first code that differs, and that
    code is a near-tie of the perturbed logits."""
    from wavenet_torch.models.config import gc_config
    c = gc_config(gc_cardinality=8)
    hi = next(B for B in range(1, 1025) if ks.device_plan(c, B) is None)
    c, params, packed, carry, _ = _cluster_case("paper", hi)
    n, seed = 400, 23

    def run(b, want):
        ring = carry.ring[:, :b].clone(memory_format=torch.contiguous_format)
        pk = packed._replace(layer_add=packed.layer_add[:, :b].contiguous())
        before = ks.decode.launches_by[want]
        out = ks.decode(pk, c, ring, carry.causal[:b].clone(),
                        carry.last[:b, None].contiguous(), n, carry.t_abs,
                        seed, collect_logits=True)
        torch.cuda.synchronize()
        assert ks.decode.launches_by[want] == before + 1
        return out[0][0], out[1][0]

    s, ls = run(1, "cluster")
    lo, llo = run(hi - 1, "cluster")
    d, ld = run(hi, "tiles")
    assert torch.equal(s, lo) and torch.equal(ls, llo)
    differ = (s != d).nonzero()
    t = differ[0, 0].item() if len(differ) else n - 1
    torch.testing.assert_close(ls[:t + 1], ld[:t + 1], **TOL)
    if len(differ):
        noise = ks.gumbel_noise(seed, 1, carry.t_abs + t, 1,
                                c.quantization_channels, "cuda")[0, 0]
        score = ls[t] + noise
        margin = (score[s[t].long()] - score[d[t].long()]).abs().item()
        assert margin < 1e-4, (t, margin)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["small", "paper", "scalar_wide"])
def test_cluster_smem_bytes_match_the_kernel(setup, width):
    """The plan's copy of the kernel's shared-memory formula against the
    library's own, at every cluster size and row count."""
    import ctypes
    from wavenet_torch.kernels import _build
    c = _cluster_case(width, 1)[0]
    lib = _build.load("sampler_cluster")
    ks._bind_cluster(lib)
    for cs in ks.CLUSTER_SIZES:
        if cs > c.num_layers:
            continue
        for rb in ks.CLUSTER_ROWS:
            got = lib.sampler_cluster_smem_bytes(
                c.residual_channels, c.dilation_channels, c.skip_channels,
                c.quantization_channels, ks.causal_width(c), cs,
                -(-c.num_layers // cs), rb)
            assert got == ks.cluster_smem_bytes(c, cs, rb), (cs, rb)


# ---------------------------------------------------------------------------
# sampler_tiles: the decode for b121 and up at the paper/gc widths, the
# chain's weights in a cluster's shared memory, products register-tiled
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("width,B", [("paper", 128), ("paper", 240),
                                     ("paper", 256), ("paper", 480),
                                     ("paper", 512), ("paper_nogc", 512)],
                         ids=["gc_b128", "gc_b240", "gc_b256", "gc_b480",
                              "gc_b512", "paper_b512"])
def test_tiles_kernel_matches_reference_teacher_forced(setup, width, B):
    """gc b240 and b480 fill their clusters (16 and 32 rows, no padded
    rows); the others leave rows of the padded tile empty."""
    c, params, packed, carry, forced = _cluster_case(width, B)
    rk, ck = carry.ring.clone(), carry.causal.clone()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    before = ks.decode.launches_by["tiles"]
    kk, lk = ks.decode(packed, c, rk, ck, forced, 30, carry.t_abs, 3,
                       collect_logits=True, kernel="tiles")
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 30,
                                 carry.t_abs, 3, collect_logits=True)
    torch.cuda.synchronize()
    assert ks.decode.launches_by["tiles"] == before + 1
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=0)
    assert torch.equal(kk[:, :-1], kr[:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [128, 512])
def test_tiles_kernel_sampled_codes_replay(setup, B):
    """A free run from a short forced prefix, replayed by the plain version
    teacher-forced on the kernel's codes: the same logits, and the sampled
    codes are the argmax of the plain logits plus the same noise (a
    mismatch only at a near-tie)."""
    c, params, packed, carry, forced = _cluster_case("paper", B)
    rk, ck = carry.ring.clone(), carry.causal.clone()
    codes, lg = ks.decode(packed, c, rk, ck, forced[:, :3].contiguous(), 64,
                          carry.t_abs, 9, collect_logits=True, kernel="tiles")
    replay = torch.cat([forced[:, :3], codes[:, 2:-1]], dim=1).contiguous()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    _, lr = ks.decode_reference(packed, c, rr, cr, replay, 64, carry.t_abs,
                                9, collect_logits=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lg, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    assert torch.equal(ck, cr)
    noise = ks.gumbel_noise(9, B, carry.t_abs, 64, c.quantization_channels,
                            "cuda").transpose(0, 1)
    scores = (lr + noise)[:, 2:]
    drawn = codes[:, 2:].long()
    top = scores.max(dim=-1).values
    margin = top - scores.gather(-1, drawn[..., None])[..., 0]
    assert (margin < 1e-4).all(), margin.max().item()
    assert (margin == 0).float().mean().item() > 0.999
    assert len(torch.unique(codes)) > 8


@pytest.mark.gpu
def test_tiles_kernel_is_deterministic_and_per_row(setup):
    """Same seed, same codes; rows 0-127 of b512 (35 rows a cluster) equal
    b128 (9 rows a cluster) bit for bit."""
    c, params, packed, carry, _ = _cluster_case("paper", 512)

    def run(n):
        ring = carry.ring[:, :n].clone(memory_format=torch.contiguous_format)
        causal = carry.causal[:n].clone()
        pk = packed._replace(layer_add=packed.layer_add[:, :n].contiguous())
        return ks.decode(pk, c, ring, causal,
                         carry.last[:n, None].contiguous(), 200,
                         carry.t_abs, 17, collect_logits=16,
                         kernel="tiles") + (ring, causal)

    a, la, ra, ca = run(512)
    b, lb, rb, cb = run(512)
    s, ls, rs, cs = run(128)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(la, lb) and torch.equal(ra, rb)
    assert torch.equal(ca, cb)
    assert torch.equal(a[:128], s) and torch.equal(la[:128], ls)
    assert torch.equal(ra[:, :128], rs) and torch.equal(ca[:128], cs)
    assert len(torch.unique(a)) > 8


@pytest.mark.gpu
def test_tiles_segments_equal_one_run(setup):
    """Three segments resumed from the ring, the causal register, t0 and
    the last code (as ``--save_every`` runs them) equal one launch."""
    c, params, packed, carry, _ = _cluster_case("paper", 256)
    first = carry.last[:, None].contiguous()
    ring, causal = carry.ring.clone(), carry.causal.clone()
    full, _ = ks.decode(packed, c, ring, causal, first, 500, carry.t_abs, 4,
                        kernel="tiles")
    ring2, causal2 = carry.ring.clone(), carry.causal.clone()
    outs, x, t = [], first, carry.t_abs
    for n in (200, 150, 150):
        seg, _ = ks.decode(packed, c, ring2, causal2, x, n, t, 4,
                           kernel="tiles")
        outs.append(seg)
        x, t = seg[:, -1:].contiguous(), t + n
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1), full)
    assert torch.equal(ring2, ring) and torch.equal(causal2, causal)


@pytest.mark.gpu
def test_tiles_kernel_logits_window(setup):
    c, params, packed, carry, _ = _cluster_case("paper", 200)
    first = carry.last[:, None].contiguous()
    got = []
    for window in (7, True):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        got.append(ks.decode(packed, c, ring, causal, first, 50, carry.t_abs,
                             13, collect_logits=window, kernel="tiles"))
    torch.cuda.synchronize()
    (codes, win), (again, full) = got
    assert torch.equal(codes, again)
    assert win.shape == (200, 7, 256) and torch.equal(win, full[:, -7:])


@pytest.mark.gpu
def test_tiles_smem_bytes_match_the_kernel(setup):
    """The plan's copy of the kernel's shared-memory formula against the
    library's own, at every row count."""
    from wavenet_torch.kernels import _build
    lib = _build.load("sampler_tiles")
    ks._bind_tiles(lib)
    for rb in ks.TILE_ROWS:
        assert lib.sampler_tiles_smem_bytes(rb) == ks.tile_smem_bytes(rb), rb


@pytest.mark.gpu
def test_tiles_wrapper_rejects_bad_inputs(setup):
    c, params, packed, carry, forced = _cluster_case("paper", 130)
    first = forced[:, :1].contiguous()
    plan = ks.TilePlan(8, 9, ks.layer_split(30, 8))
    with pytest.raises(ValueError, match="ring"):
        ks.decode(packed, c, carry.ring.double(), carry.causal, first, 4,
                  carry.t_abs, 0, kernel="tiles")
    with pytest.raises(ValueError, match="forced"):
        ks.decode(packed, c, carry.ring, carry.causal, first.long(), 4,
                  carry.t_abs, 0, kernel="tiles")
    for bad in (ks.TilePlan(4, 9, (0, 8, 16, 24, 30)),
                ks.TilePlan(8, 36, plan.layer_begin),
                ks.TilePlan(8, 9, (0, 8, 8, 12, 16, 20, 24, 28, 30))):
        with pytest.raises(ValueError, match="bad plan"):
            ks._launch(packed, c, carry.ring, carry.causal, first, 4,
                       carry.t_abs, 0, 1.0, False, route="decode",
                       kernel="tiles", plan=bad)
    with pytest.raises(ValueError, match="another kernel"):
        ks._launch(packed, c, carry.ring, carry.causal, first, 4,
                   carry.t_abs, 0, 1.0, False, route="decode",
                   kernel="tiles", plan=ks.ClusterPlan(8, 8, plan.layer_begin))
    # A CTA of five layers (more than its shared memory holds): the kernel
    # itself refuses the launch.
    with pytest.raises(RuntimeError, match="sampler_tiles launch failed"):
        ks._launch(packed, c, carry.ring, carry.causal, first, 4,
                   carry.t_abs, 0, 1.0, 5, route="decode", kernel="tiles",
                   plan=ks.TilePlan(8, 9, (0, 5, 9, 13, 17, 21, 25, 29,
                                           30)))
    # Shapes outside the compiled one: no plan, and the kernel refuses them.
    small = WaveNetConfig(**SMALL)
    sp = _seeded_params(small)
    pk = ks.pack_sampler_weights(sp, small, 2)
    ring, causal = ks.zero_state(small, 2, "cuda")
    x = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="no tiles plan"):
        ks.decode(pk, small, ring, causal, x, 2, 0, 0, kernel="tiles")
    with pytest.raises(RuntimeError, match="sampler_tiles launch failed"):
        ks._launch(pk, small, ring, causal, x, 2, 0, 0, 1.0, False,
                   route="decode", kernel="tiles",
                   plan=ks.TilePlan(8, 2, tuple(range(9))))


# ---------------------------------------------------------------------------
# The bf16 modes of sampler_cluster, sampler_tiles and sampler_decode (the JAX
# kernels at weight_dtype=bfloat16): weights widened, activations rounded to
# bf16 where the JAX kernels round them, the layer chain not at B = 1
# ---------------------------------------------------------------------------

def _bf16_case(width, B, seed=0):
    """``_cluster_case`` with bf16 packed weights (what
    ``pack_sampler_weights(..., weight_dtype=torch.bfloat16)`` stores), and
    the float32 ones."""
    c, params, packed, carry, forced = _cluster_case(width, B, seed)
    pk16 = packed._replace(**{k: getattr(packed, k).to(torch.bfloat16)
                              for k in ks.WEIGHT_FIELDS})
    return c, params, pk16, packed, carry, forced


def _bf16_stepwise(where, c, pk16, pk32, ring, causal, forced, t0, seed,
                   round_chain, launch):
    """``bf16_hold.stepwise``, its logits and written ring values held by
    ``bf16_hold.hold``; returns the kernel's logits [B, n, Q]."""
    lg, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
        c, pk16, pk32, ring, causal, forced, t0, seed, round_chain, launch)
    torch.cuda.synchronize()
    bf16_hold.hold(where, lg, lg16, lg32)
    bf16_hold.hold(f"{where} ring", rk, r16, r32)
    return lg


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,width,B", [
    ("cluster", "small", 1), ("cluster", "small", 4),
    ("cluster", "paper", 1), ("cluster", "paper", 4),
    ("cluster", "paper", 64), ("cluster", "scalar_wide", 1),
    ("cluster", "scalar_wide", 4), ("decode", "small", 5),
    ("decode", "paper", 1), ("decode", "paper", 128),
    ("decode", "paper", 512), ("decode", "scalar_wide", 1),
    ("decode", "scalar_wide", 5), ("tiles", "paper", 121),
    ("tiles", "paper", 128), ("tiles", "paper", 512),
    ("tiles", "paper", 525), ("tiles", "paper_nogc", 512)])
def test_bf16_kernel_matches_reference_teacher_forced(setup, kernel, width,
                                                      B):
    """Each kernel's bf16 mode, pinned, teacher-forced from a prefilled
    state: the window in one launch (counted under ``"<kernel>_bf16"``)
    equals it one step a launch, and each step is held against bf16
    ``decode_reference`` from the kernel's own state (the chain rounded
    unless B == 1)."""
    c, params, pk16, pk32, carry, forced = _bf16_case(width, B)
    forced = forced[:, :20].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    key = f"{kernel}_bf16"
    before = ks.decode.launches_by[key]
    kk, lk = ks.decode(pk16, c, rk, ck, forced, 20, carry.t_abs, 3,
                       collect_logits=True, kernel=kernel)
    torch.cuda.synchronize()
    assert ks.decode.launches_by[key] == before + 1
    # Forced amplitudes come back as their mu-law codes.
    assert torch.equal(kk[:, :-1], ks.mu_law_encode_f(
        forced[:, 1:], c.quantization_channels) if c.scalar_input
        else forced[:, 1:])

    def step(ring, causal, x, t):
        return ks.decode(pk16, c, ring, causal, x, 1, t, 3,
                         collect_logits=True, kernel=kernel)[1]

    ring, causal = carry.ring.clone(), carry.causal.clone()
    lg = _bf16_stepwise(f"{kernel} {width} B={B}", c, pk16, pk32, ring,
                        causal, forced, carry.t_abs, 3,
                        ks.chain_rounded("decode", B), step)
    assert torch.equal(lg, lk) and torch.equal(ring, rk)
    assert torch.equal(causal, ck)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cluster", "decode"])
@pytest.mark.parametrize("width", ["paper", "scalar_wide"])
def test_bf16_kernel_is_deterministic_and_per_row(setup, kernel, width):
    """Same seed, same codes; for B >= 2 a row's codes and logits do not
    depend on B (both round the chain), where b1 (chain not rounded) is
    another computation. Teacher-forced, the last two rows of b64 (in the
    cluster kernel's partial last cluster) equal them run as b2."""
    c, params, pk16, _, carry, forced = _bf16_case(width, 64)

    def run(n):
        ring = carry.ring[:, :n].clone(memory_format=torch.contiguous_format)
        causal = carry.causal[:n].clone()
        pk = pk16._replace(layer_add=pk16.layer_add[:, :n].contiguous())
        return ks.decode(pk, c, ring, causal,
                         carry.last[:n, None].contiguous(), 150,
                         carry.t_abs, 17, collect_logits=16,
                         kernel=kernel) + (ring,)

    a, la, ra = run(64)
    b, lb, rb = run(64)
    s, ls, rs = run(2)
    one, l1, _ = run(1)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(la, lb) and torch.equal(ra, rb)
    assert torch.equal(a[:2], s) and torch.equal(la[:2], ls)
    assert torch.equal(ra[:, :2], rs)
    assert not torch.equal(la[:1], l1)
    assert len(torch.unique(a)) > 8

    def forced_run(lo, hi):
        ring = carry.ring[:, lo:hi].clone(
            memory_format=torch.contiguous_format)
        pk = pk16._replace(layer_add=pk16.layer_add[:, lo:hi].contiguous())
        lg = ks.decode(pk, c, ring, carry.causal[lo:hi].clone(),
                       forced[lo:hi, :20].contiguous(), 20, carry.t_abs, 17,
                       collect_logits=True, kernel=kernel)[1]
        return lg, ring

    lf, rf = forced_run(0, 64)
    lt, rt = forced_run(62, 64)
    torch.cuda.synchronize()
    assert torch.equal(lf[62:], lt) and torch.equal(rf[:, 62:], rt)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["paper", "scalar_wide"])
def test_bf16_sequential_route_matches_reference(setup, width):
    """Kernel 4's route at bf16 (``decode_sequential``: the chain rounded at
    every B, b1 included) on the routed kernel: the launch equals the
    kernel's inputs replayed one step a launch, each step held against the
    plain version from the kernel's own state."""
    c, params, _, _, _, _ = _bf16_case(width, 1)
    rng = np.random.RandomState(7)
    T = 16
    for B in (1, 3):
        if c.scalar_input:
            prefix = torch.as_tensor(rng.uniform(-0.9, 0.9, (
                B, T)).astype(np.float32), device="cuda")
            gids = None
        else:
            prefix = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                                 (B, T)),
                                     dtype=torch.int32, device="cuda")
            gids = torch.as_tensor([0, 3, 1][:B], device="cuda")
        emb = None if gids is None else embed_gc(params, c, gids)
        pk16 = ks.pack_sampler_weights(params, c, B, emb,
                                       weight_dtype=torch.bfloat16)
        pk32 = ks.pack_sampler_weights(params, c, B, emb)
        n_total = T - 1 + 30
        key = "cluster_bf16" if ks.device_plan(c, B) else "decode_bf16"
        before = ks.decode_sequential.launches_by[key]
        codes, lg = ks.decode_sequential(pk16, c, prefix, n_total, 5,
                                         collect_logits=True)
        again, _ = ks.decode_sequential(pk16, c, prefix, n_total, 5)
        torch.cuda.synchronize()
        assert ks.decode_sequential.launches_by[key] == before + 2
        assert torch.equal(codes, again)
        sampled = codes[:, T - 1:-1]
        nxt = (ks.decode_amp(sampled, c.quantization_channels)
               if c.scalar_input else sampled)
        forced = torch.cat([prefix, nxt.to(prefix.dtype)], 1).contiguous()

        def step(ring, causal, x, t):
            return ks._launch(pk16, c, ring, causal, x, 1, t, 5, 1.0, True,
                              route="sequential")[1]

        ring, causal = ks.zero_state(c, B, "cuda")
        steps = _bf16_stepwise(f"sequential {width} B={B}", c, pk16, pk32,
                               ring, causal, forced, 0, 5,
                               ks.chain_rounded("sequential", B), step)
        # In scalar mode a sampled code re-enters as the launch's own
        # amplitude, which PyTorch's decode_amp may miss by the last bit:
        # bitwise, the forced prefix's steps.
        n_same = T if c.scalar_input else n_total
        assert torch.equal(steps[:, :n_same], lg[:, :n_same])
        out = ks.generate_cuda(params, c, 30, seed=5, batch_size=B,
                               gc_ids=gids, seed_codes=prefix, prefill=False,
                               weight_dtype=torch.bfloat16)
        assert torch.equal(out, codes[:, T - 1:])


@pytest.mark.gpu
def test_bf16_tiles_kernel_is_deterministic_and_per_row(setup):
    """The tiles kernel's bf16 mode: same seed, same codes; rows 0-127 of
    b512 (35 rows a cluster) equal b128 (9 rows a cluster) bit for bit,
    ring and causal register included (both round the chain)."""
    c, params, pk16, _, carry, _ = _bf16_case("paper", 512)

    def run(n):
        ring = carry.ring[:, :n].clone(memory_format=torch.contiguous_format)
        causal = carry.causal[:n].clone()
        pk = pk16._replace(layer_add=pk16.layer_add[:, :n].contiguous())
        return ks.decode(pk, c, ring, causal,
                         carry.last[:n, None].contiguous(), 200,
                         carry.t_abs, 17, collect_logits=16,
                         kernel="tiles") + (ring, causal)

    before = ks.decode.launches_by["tiles_bf16"]
    a, la, ra, ca = run(512)
    b, lb, rb, cb = run(512)
    s, ls, rs, cs = run(128)
    torch.cuda.synchronize()
    assert ks.decode.launches_by["tiles_bf16"] == before + 3
    assert torch.equal(a, b) and torch.equal(la, lb) and torch.equal(ra, rb)
    assert torch.equal(ca, cb)
    assert torch.equal(a[:128], s) and torch.equal(la[:128], ls)
    assert torch.equal(ra[:, :128], rs) and torch.equal(ca[:128], cs)
    assert len(torch.unique(a)) > 8


@pytest.mark.gpu
@pytest.mark.parametrize("B", [128, 512])
def test_bf16_tiles_sampled_codes_replay(setup, B):
    """A free run of the tiles kernel's bf16 mode from a short forced
    prefix: each sampled code is the argmax of the launch's own logits plus
    the same noise (a mismatch only at a near-tie), and its inputs replayed
    one step a launch give the same logits, each step held against bf16
    ``decode_reference`` from the kernel's own state."""
    c, params, pk16, pk32, carry, forced = _bf16_case("paper", B)
    n = 40
    rk, ck = carry.ring.clone(), carry.causal.clone()
    codes, lg = ks.decode(pk16, c, rk, ck, forced[:, :3].contiguous(), n,
                          carry.t_abs, 9, collect_logits=True, kernel="tiles")
    noise = ks.gumbel_noise(9, B, carry.t_abs, n, c.quantization_channels,
                            "cuda").transpose(0, 1)
    scores = (lg + noise)[:, 2:]
    drawn = codes[:, 2:].long()
    top = scores.max(dim=-1).values
    margin = top - scores.gather(-1, drawn[..., None])[..., 0]
    assert (margin < 1e-4).all(), margin.max().item()
    assert (margin == 0).float().mean().item() > 0.999
    assert len(torch.unique(codes)) > 8
    replay = torch.cat([forced[:, :3], codes[:, 2:-1]], dim=1).contiguous()

    def step(ring, causal, x, t):
        return ks.decode(pk16, c, ring, causal, x, 1, t, 9,
                         collect_logits=True, kernel="tiles")[1]

    ring, causal = carry.ring.clone(), carry.causal.clone()
    steps = _bf16_stepwise(f"tiles replay B={B}", c, pk16, pk32, ring,
                           causal, replay, carry.t_abs, 9,
                           ks.chain_rounded("decode", B), step)
    assert torch.equal(steps, lg) and torch.equal(ring, rk)
    assert torch.equal(causal, ck)


@pytest.mark.gpu
def test_bf16_tiles_segments_equal_one_run(setup):
    """Three segments of the tiles kernel's bf16 mode resumed from the
    ring, the causal register, t0 and the last code (as ``--save_every``
    runs them) equal one launch."""
    c, params, pk16, _, carry, _ = _bf16_case("paper", 256)
    first = carry.last[:, None].contiguous()
    ring, causal = carry.ring.clone(), carry.causal.clone()
    full, _ = ks.decode(pk16, c, ring, causal, first, 500, carry.t_abs, 4,
                        kernel="tiles")
    ring2, causal2 = carry.ring.clone(), carry.causal.clone()
    outs, x, t = [], first, carry.t_abs
    for n in (200, 150, 150):
        seg, _ = ks.decode(pk16, c, ring2, causal2, x, n, t, 4,
                           kernel="tiles")
        outs.append(seg)
        x, t = seg[:, -1:].contiguous(), t + n
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1), full)
    assert torch.equal(ring2, ring) and torch.equal(causal2, causal)


@pytest.mark.gpu
def test_bf16_tiles_kernel_logits_window(setup):
    c, params, pk16, _, carry, _ = _bf16_case("paper", 200)
    first = carry.last[:, None].contiguous()
    got = []
    for window in (7, True):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        got.append(ks.decode(pk16, c, ring, causal, first, 50, carry.t_abs,
                             13, collect_logits=window, kernel="tiles"))
    torch.cuda.synchronize()
    (codes, win), (again, full) = got
    assert torch.equal(codes, again)
    assert win.shape == (200, 7, 256) and torch.equal(win, full[:, -7:])


@pytest.mark.gpu
def test_bf16_tiles_library_matches_the_plan(setup):
    """The bf16 library's shared memory and resident clusters at every row
    count are the float32 library's, which the plan takes."""
    import ctypes
    from wavenet_torch.kernels import _build
    libs = [_build.load(n) for n in ("sampler_tiles", "sampler_tiles_bf16")]
    for lib, bf16 in zip(libs, (False, True)):
        ks._bind_tiles(lib, bf16)
    for rb in ks.TILE_ROWS:
        counts = []
        for lib in libs:
            assert lib.sampler_tiles_smem_bytes(rb) == ks.tile_smem_bytes(rb)
            n = ctypes.c_int(0)
            assert lib.sampler_tiles_max_clusters(rb, ctypes.byref(n)) == 0
            counts.append(n.value)
        assert counts[0] == counts[1] > 0, (rb, counts)


@pytest.mark.gpu
def test_bf16_tiles_pinned_b1_plan_rounds_as_the_route_says(setup):
    """A pinned tiles plan at B = 1: on the decode route the layer chain
    stays float32 (the JAX prefill route's b1 rule), on the sequential
    route it is rounded; each held one step a launch against the plain
    version under its rule, and the two differ."""
    c, params, pk16, pk32, carry, forced = _bf16_case("paper", 1)
    plan = ks.TilePlan(8, 1, ks.layer_split(c.num_layers, 8))
    forced = forced[:, :20].contiguous()
    got = {}
    for route in ("decode", "sequential"):
        rk, ck = carry.ring.clone(), carry.causal.clone()
        _, lk, used = ks._launch(pk16, c, rk, ck, forced, 20, carry.t_abs,
                                 3, 1.0, True, route=route, kernel="tiles",
                                 plan=plan)
        assert used == "tiles_bf16"

        def step(ring, causal, x, t):
            return ks._launch(pk16, c, ring, causal, x, 1, t, 3, 1.0, True,
                              route=route, kernel="tiles", plan=plan)[1]

        ring, causal = carry.ring.clone(), carry.causal.clone()
        got[route] = _bf16_stepwise(
            f"tiles b1 {route}", c, pk16, pk32, ring, causal, forced,
            carry.t_abs, 3, ks.chain_rounded(route, 1), step)
        assert torch.equal(got[route], lk) and torch.equal(ring, rk)
    assert not ks.chain_rounded("decode", 1)
    assert not torch.equal(got["decode"], got["sequential"])


@pytest.mark.gpu
def test_bf16_route_and_refusals(setup):
    """``kernel="auto"`` at bf16: the cluster kernel at paper b1 and b64,
    the tiles kernel at b512 (``tile_plan`` gives the float32 plan),
    ``sampler_decode`` at b600 and at the wide config's b64 (above its
    cluster range); a pinned ``kernel="tiles"`` where the device has no
    tiles plan raises as at float32; bf16 weights go in all six or none."""
    from wavenet_torch.models.config import paper_config, wide_config
    c = paper_config()
    params = _seeded_params(c)
    wide = wide_config()
    cases = [(c, params, B, want) for B, want in (
        (1, "cluster_bf16"), (64, "cluster_bf16"), (512, "tiles_bf16"),
        (600, "decode_bf16"))]
    cases.append((wide, _seeded_params(wide), 64, "decode_bf16"))
    for cfg, p, B, want in cases:
        assert (ks.device_tile_plan(cfg, B, weight_dtype=torch.bfloat16)
                == ks.device_tile_plan(cfg, B))
        assert ((ks.device_tile_plan(cfg, B) is not None)
                == (want == "tiles_bf16"))
        before = dict(ks.decode.launches_by)
        codes = ks.generate_cuda(p, cfg, 8, seed=1, batch_size=B,
                                 weight_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        after = dict(ks.decode.launches_by)
        assert {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)} == {want: 1}
        assert codes.shape == (B, 8)
    pk = ks.pack_sampler_weights(params, c, 2, weight_dtype=torch.bfloat16)
    ring, causal = ks.zero_state(c, 2, "cuda")
    x = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="no tiles plan"):
        ks.decode(pk, c, ring, causal, x, 2, 0, 0, kernel="tiles")
    _, _, used = ks._launch(pk, c, ring, causal, x, 2, 0, 0, 1.0, False,
                            route="decode",
                            plan=ks.TilePlan(8, 9, ks.layer_split(30, 8)))
    assert used == "tiles_bf16"
    mixed = pk._replace(skip_w=pk.skip_w.float())
    with pytest.raises(ValueError, match="skip_w"):
        ks.decode(mixed, c, ring, causal, x, 2, 0, 0)


# ---------------------------------------------------------------------------
# Local conditioning: the LC modes of sampler_cluster and sampler_decode
# ---------------------------------------------------------------------------

def _lc_config(width):
    """An LC config: the small widths with GC (5 channels), the paper
    config with 80 (the JAX bench's ``lc`` row) or the scalar-input wide
    widths with 7."""
    from wavenet_torch.models.config import paper_config
    if width == "paper":
        return paper_config(lc_channels=80)
    if width == "scalar_wide":
        return WaveNetConfig(**WIDE_SMALL, lc_channels=7)
    return WaveNetConfig(**SMALL, lc_channels=5)


def _lc_case(width, B, seed=0, zero_lc_w=False):
    """(config, params, packed, prefilled carry, teacher-forced inputs, the
    decode's stream [30, B, C_lc]) of an LC config, the prefill conditioned
    on the stream's first 69 rows. ``zero_lc_w`` zeros the LC weights."""
    c = _lc_config(width)
    params = _seeded_params(c, seed)
    if zero_lc_w:
        params = dict(params, lc_filter=torch.zeros_like(params["lc_filter"]),
                      lc_gate=torch.zeros_like(params["lc_gate"]))
    rng = np.random.RandomState(seed + B)
    if c.scalar_input:
        x = torch.as_tensor(rng.uniform(-0.9, 0.9, (B, 100))
                            .astype(np.float32), device="cuda")
        gids = None
    else:
        x = torch.as_tensor(rng.randint(0, c.quantization_channels, (B, 100)),
                            dtype=torch.int32, device="cuda")
        gids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                                device="cuda") if c.gc_enabled else None)
    stream = torch.as_tensor(rng.uniform(-1, 1, (B, 99, c.lc_channels))
                             .astype(np.float32), device="cuda")
    carry = ks.prefill_carry(params, c, x[:, :70], gids, lc=stream[:, :69])
    packed = ks.pack_sampler_weights(
        params, c, B, None if gids is None else embed_gc(params, c, gids))
    lc = stream[:, 69:].transpose(0, 1).contiguous()
    return c, params, packed, carry, x[:, 69:].contiguous(), lc


def _lc_top_batch(c):
    """The largest batch that the device's cluster plan takes for ``c``."""
    top = max(B for B in range(1, 257) if ks.device_plan(c, B) is not None)
    assert ks.device_plan(c, top + 1) is None
    return top


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,width,B", [
    ("cluster", "small", 1), ("cluster", "small", 4),
    ("cluster", "paper", 1), ("cluster", "paper", 64),
    ("cluster", "scalar_wide", 5), ("decode", "small", 1),
    ("decode", "small", 300), ("decode", "paper", 64),
    ("decode", "scalar_wide", 1100)])
def test_lc_kernel_matches_reference_teacher_forced(setup, kernel, width, B):
    """Each kernel's LC mode against ``decode_reference(lc=)``, teacher-
    forced over 30 steps from an LC-prefilled state, counted under its
    ``_lc`` name."""
    c, params, packed, carry, forced, lc = _lc_case(width, B)
    rk, ck = carry.ring.clone(), carry.causal.clone()
    rr, cr = carry.ring.clone(), carry.causal.clone()
    before = ks.decode.launches_by[f"{kernel}_lc"]
    kk, lk = ks.decode(packed, c, rk, ck, forced, 30, carry.t_abs, 3,
                       collect_logits=True, kernel=kernel, lc=lc)
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 30,
                                 carry.t_abs, 3, collect_logits=True, lc=lc)
    torch.cuda.synchronize()
    assert ks.decode.launches_by[f"{kernel}_lc"] == before + 1
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=0)
    assert torch.equal(kk[:, :-1], kr[:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("plan", SMALL_PLANS, ids=lambda p: f"cs{p.CS}")
def test_lc_cluster_multi_cta_plans(setup, plan):
    """Explicit multi-CTA plans at the small widths with LC: CTA 0 computes
    the next step's LC terms after its hand-off, the others theirs while
    they wait for it."""
    c, params, packed, carry, forced, lc = _lc_case("small", plan.RB + 1)
    rk, ck = carry.ring.clone(), carry.causal.clone()
    kk, lk, used = ks._launch(packed, c, rk, ck, forced, 30, carry.t_abs, 3,
                              1.0, True, route="decode", kernel="cluster",
                              plan=plan, lc=lc)
    rr, cr = carry.ring.clone(), carry.causal.clone()
    kr, lr = ks.decode_reference(packed, c, rr, cr, forced, 30,
                                 carry.t_abs, 3, collect_logits=True, lc=lc)
    torch.cuda.synchronize()
    assert used == "cluster_lc"
    torch.testing.assert_close(lk, lr, **TOL)
    torch.testing.assert_close(rk, rr, **TOL)
    assert torch.equal(kk[:, :-1], kr[:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cluster", "decode"])
@pytest.mark.parametrize("where", ["b1", "top"])
def test_lc_with_zero_weights_is_the_no_lc_launch(setup, kernel, where):
    """An LC launch whose ``lc_w`` is all zero is bitwise the same kernel's
    launch without LC, at b1 and at the largest B of its range (the
    cluster plan's top at the paper widths; 1100 rows, eight to a block,
    for sampler_decode)."""
    c = _lc_config("paper")
    B = 1 if where == "b1" else (_lc_top_batch(c) if kernel == "cluster"
                                 else 1100)
    c, params, packed, carry, forced, lc = _lc_case("paper", B,
                                                    zero_lc_w=True)
    assert not packed.lc_w.any()
    c0 = dataclasses.replace(c, lc_channels=None)
    plan = ks.device_plan(c, B) if kernel == "cluster" else None
    runs = []
    for cfg, stream in ((c, lc), (c0, None)):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        kk, lk, used = ks._launch(packed, cfg, ring, causal, forced, 30,
                                  carry.t_abs, 3, 1.0, True, route="decode",
                                  kernel=kernel, plan=plan, lc=stream)
        runs.append((kk, lk, ring, causal))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["small", "paper", "scalar_wide"])
def test_cluster_lc_smem_bytes_match_the_kernel(setup, width):
    """The plan's count of an LC CTA's shared memory against the LC
    library's own, at every cluster size and row count."""
    from wavenet_torch.kernels import _build
    c = _lc_config(width)
    lib = _build.load("sampler_cluster_lc")
    ks._bind_cluster_lc(lib)
    for cs in ks.CLUSTER_SIZES:
        if cs > c.num_layers:
            continue
        for rb in ks.CLUSTER_ROWS:
            got = lib.sampler_cluster_lc_smem_bytes(
                c.residual_channels, c.dilation_channels, c.skip_channels,
                c.quantization_channels, ks.causal_width(c), cs,
                -(-c.num_layers // cs), rb, c.lc_channels)
            assert got == ks.cluster_smem_bytes(c, cs, rb), (cs, rb)


@pytest.mark.gpu
@pytest.mark.parametrize("width,B", [("paper", 1), ("small", 300)])
def test_lc_sequential_route_matches_reference(setup, width, B):
    """``generate_cuda(prefill=False)`` with LC: one launch from a zero ring
    over the forced prefix (conditioned by ``lc_prime``) and the sampled
    steps, held against the plain version on the kernel's own inputs."""
    c = _lc_config(width)
    params = _seeded_params(c)
    rng = np.random.RandomState(B)
    prefix = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                         (B, 40)),
                             dtype=torch.int32, device="cuda")
    n = 24
    lc = torch.as_tensor(rng.uniform(-1, 1, (B, n, c.lc_channels))
                         .astype(np.float32), device="cuda")
    lc_prime = torch.as_tensor(rng.uniform(-1, 1, (B, 39, c.lc_channels))
                               .astype(np.float32), device="cuda")
    gids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                            device="cuda") if c.gc_enabled else None)
    before = sum(ks.decode_sequential.launches_by.values())
    codes, logits = ks.generate_cuda(params, c, n, 9, batch_size=B,
                                     gc_ids=gids, seed_codes=prefix,
                                     collect_logits=True, prefill=False,
                                     lc=lc, lc_prime=lc_prime)
    torch.cuda.synchronize()
    assert sum(ks.decode_sequential.launches_by.values()) == before + 1
    packed = ks.pack_sampler_weights(
        params, c, B, None if gids is None else embed_gc(params, c, gids))
    forced = torch.cat([prefix, codes[:, :-1]], dim=1).contiguous()
    ring, causal = ks.zero_state(c, B, "cuda")
    stream = torch.cat([lc_prime, lc], dim=1).transpose(0, 1).contiguous()
    kr, lr = ks.decode_reference(packed, c, ring, causal, forced,
                                 39 + n, 0, 9, collect_logits=True,
                                 lc=stream)
    torch.testing.assert_close(logits, lr, **TOL)
    assert torch.equal(codes[:, :-1], kr[:, 39:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64, 200])
def test_lc_resumable_segments_equal_one_run(setup, B):
    """``generate_cuda_resumable`` with the stream sliced per segment equals
    one ``generate_cuda`` run, code for code (the cluster kernel at b1 and
    b64, sampler_decode at b200)."""
    c = _lc_config("paper")
    params = _seeded_params(c)
    rng = np.random.RandomState(B)
    lc = torch.as_tensor(rng.uniform(-1, 1, (B, 60, 80)).astype(np.float32),
                         device="cuda")
    full = ks.generate_cuda(params, c, 60, 4, batch_size=B, lc=lc)
    parts, carry = [], None
    for a, b in ((0, 17), (17, 60)):
        codes, carry = ks.generate_cuda_resumable(
            params, c, b - a, 4, batch_size=B, carry=carry, lc=lc[:, a:b])
        parts.append(codes)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), full)


@pytest.mark.gpu
def test_lc_route_and_refusals(setup):
    """``kernel="auto"`` with LC: the cluster kernel's LC mode at b1 and at
    the top of its range, ``sampler_decode``'s above it (``tile_plan``
    refuses LC); at bf16 weights the bf16 LC mode of the cluster kernel at
    b2 (``test_lc_bf16_route`` holds the rest of its route); a pinned tiles
    kernel raises."""
    c = _lc_config("paper")
    params = _seeded_params(c)
    top = _lc_top_batch(c)
    for B, want in ((1, "cluster_lc"), (top, "cluster_lc"),
                    (top + 1, "decode_lc")):
        assert ks.device_tile_plan(c, B) is None
        lc = torch.zeros((B, 8, 80), device="cuda")
        before = dict(ks.decode.launches_by)
        codes = ks.generate_cuda(params, c, 8, seed=1, batch_size=B, lc=lc)
        torch.cuda.synchronize()
        after = dict(ks.decode.launches_by)
        assert {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)} == {want: 1}
        assert codes.shape == (B, 8)
    lc = torch.zeros((2, 8, 80), device="cuda")
    before = ks.decode.launches_by["cluster_bf16_lc"]
    codes = ks.generate_cuda(params, c, 8, seed=1, batch_size=2, lc=lc,
                             weight_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert codes.shape == (2, 8)
    assert ks.decode.launches_by["cluster_bf16_lc"] == before + 1
    pk = ks.pack_sampler_weights(params, c, 2)
    ring, causal = ks.zero_state(c, 2, "cuda")
    x = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
    stream = torch.zeros((2, 2, 80), device="cuda")
    with pytest.raises(NotImplementedError, match="step 2c"):
        ks.decode(pk, c, ring, causal, x, 2, 0, 0, kernel="tiles", lc=stream)
    with pytest.raises(ValueError, match="lc"):
        ks.decode(pk, c, ring, causal, x, 2, 0, 0)


# ---------------------------------------------------------------------------
# Local conditioning at bf16 weights: the bf16 LC modes of sampler_cluster
# and sampler_decode (the LC row rounded to bf16 at every B)
# ---------------------------------------------------------------------------

def _lc_bf16_case(B, seed=0):
    """``_lc_case("paper", B)`` with bf16 packed weights (``lc_w`` too), and
    the float32 ones."""
    c, params, packed, carry, forced, lc = _lc_case("paper", B, seed)
    pk16 = packed._replace(**{k: getattr(packed, k).to(torch.bfloat16)
                              for k in ks.WEIGHT_FIELDS + ("lc_w",)})
    return c, params, pk16, packed, carry, forced, lc


def _lc_bf16_batch(c, where):
    top = _lc_top_batch(c)
    return {"top": top, "top+1": top + 1}.get(where, where)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,where", [
    ("cluster", 1), ("cluster", 64), ("cluster", "top"),
    ("decode", "top+1"), ("decode", 256)])
def test_lc_bf16_kernel_matches_reference_stepwise(setup, kernel, where):
    """Each kernel's bf16 LC mode, pinned, teacher-forced from an
    LC-prefilled state at paper-LC: the window in one launch (counted under
    ``"<kernel>_bf16_lc"``) equals it one step a launch, and each step is
    held against bf16 ``decode_reference(lc=)`` from the kernel's own state
    (``bf16_hold``'s limits; the chain rounded unless B == 1, the LC row
    always)."""
    B = _lc_bf16_batch(_lc_config("paper"), where)
    c, _, pk16, pk32, carry, forced, lc = _lc_bf16_case(B)
    n = 20
    forced, lc = forced[:, :n].contiguous(), lc[:n].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    key = f"{kernel}_bf16_lc"
    before = ks.decode.launches_by[key]
    kk, lk = ks.decode(pk16, c, rk, ck, forced, n, carry.t_abs, 3,
                       collect_logits=True, kernel=kernel, lc=lc)
    torch.cuda.synchronize()
    assert ks.decode.launches_by[key] == before + 1
    assert torch.equal(kk[:, :-1], forced[:, 1:])

    def step(ring, causal, x, t):
        i = t - carry.t_abs
        return ks.decode(pk16, c, ring, causal, x, 1, t, 3,
                         collect_logits=True, kernel=kernel,
                         lc=lc[i:i + 1].contiguous())[1]

    ring, causal = carry.ring.clone(), carry.causal.clone()
    lg, lg16, lg32, rkk, r16, r32 = bf16_hold.stepwise(
        c, pk16, pk32, ring, causal, forced, carry.t_abs, 3,
        ks.chain_rounded("decode", B, lc=True), step, lc=lc)
    torch.cuda.synchronize()
    bf16_hold.hold(f"{key} B={B}", lg, lg16, lg32)
    bf16_hold.hold(f"{key} B={B} ring", rkk, r16, r32)
    assert torch.equal(lg, lk) and torch.equal(ring, rk)
    assert torch.equal(causal, ck)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,B", [("cluster", 64), ("decode", 256)])
def test_lc_bf16_kernel_is_deterministic(setup, kernel, B):
    """Same seed, same codes, logits and ring, sampled from an LC-prefilled
    state over 40 steps; the bf16 LC logits are not the float32 ones."""
    c, _, pk16, pk32, carry, _, lc = _lc_bf16_case(B, seed=1)
    x = carry.last[:, None].contiguous()
    runs = []
    for pk in (pk16, pk16, pk32):
        ring, causal = carry.ring.clone(), carry.causal.clone()
        runs.append(ks.decode(pk, c, ring, causal, x, 30, carry.t_abs, 9,
                              collect_logits=True, kernel=kernel, lc=lc)
                    + (ring,))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][1], runs[2][1])
    assert len(torch.unique(runs[0][0])) > 8


@pytest.mark.gpu
def test_lc_bf16_route(setup):
    """``kernel="auto"`` with LC at bf16 weights: ``cluster_bf16_lc`` at b1
    and at the top of the cluster plan, ``decode_bf16_lc`` above it, on the
    prefill route and (b1, the chain not rounded) from a zero ring; the
    sequential b1 launch held step by step against the plain version."""
    c = _lc_config("paper")
    params = _seeded_params(c)
    top = _lc_top_batch(c)
    for B, want, prefill in ((1, "cluster_bf16_lc", True),
                             (top, "cluster_bf16_lc", True),
                             (top + 1, "decode_bf16_lc", True),
                             (1, "cluster_bf16_lc", False)):
        lc = torch.zeros((B, 8, 80), device="cuda")
        counter = ks.decode if prefill else ks.decode_sequential
        before = dict(counter.launches_by)
        codes = ks.generate_cuda(params, c, 8, seed=1, batch_size=B, lc=lc,
                                 weight_dtype=torch.bfloat16,
                                 prefill=prefill)
        torch.cuda.synchronize()
        after = dict(counter.launches_by)
        assert {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)} == {want: 1}
        assert codes.shape == (B, 8)
    _, _, pk16, pk32, _, _, _ = _lc_bf16_case(1)
    rng = np.random.RandomState(3)
    prefix = torch.as_tensor(rng.randint(0, 256, (1, 12)), dtype=torch.int32,
                             device="cuda")
    lc = torch.as_tensor(rng.uniform(-1, 1, (27, 1, 80)).astype(np.float32),
                         device="cuda")
    codes, lk = ks.decode_sequential(pk16, c, prefix, 27, 21,
                                     collect_logits=True, lc=lc)
    rule = ks.chain_rounded("sequential", 1, lc=True)
    assert not rule

    def step(ring, causal, x, t):
        return ks._launch(pk16, c, ring, causal, x, 1, t, 21, 1.0, True,
                          route="sequential", lc=lc[t:t + 1])[1]

    forced = torch.cat([prefix, codes[:, 11:-1]], dim=1).contiguous()
    ring, causal = ks.zero_state(c, 1, "cuda")
    lg, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
        c, pk16, pk32, ring, causal, forced, 0, 21, rule, step, lc=lc)
    torch.cuda.synchronize()
    assert torch.equal(lg, lk)
    bf16_hold.hold("sequential cluster_bf16_lc b1", lg, lg16, lg32)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["small", "paper", "scalar_wide"])
def test_cluster_lc_bf16_smem_bytes_match_the_kernel(setup, width):
    """The plan's count of an LC CTA's shared memory against the bf16 LC
    library's own, at every cluster size and row count: the float32 LC
    mode's, since the weights are widened into the same layout."""
    from wavenet_torch.kernels import _build
    c = _lc_config(width)
    lib = _build.load("sampler_cluster_lc_bf16")
    ks._bind_cluster_lc(lib, bf16=True)
    for cs in ks.CLUSTER_SIZES:
        if cs > c.num_layers:
            continue
        for rb in ks.CLUSTER_ROWS:
            got = lib.sampler_cluster_lc_bf16_smem_bytes(
                c.residual_channels, c.dilation_channels, c.skip_channels,
                c.quantization_channels, ks.causal_width(c), cs,
                -(-c.num_layers // cs), rb, c.lc_channels)
            assert got == ks.cluster_smem_bytes(c, cs, rb), (cs, rb)


# ---------------------------------------------------------------------------
# Scoring and speculative decoding on the card (plain PyTorch, and the
# fused stack's forward where the scored config has use_pallas_stack)
# ---------------------------------------------------------------------------

def _to_cpu(params):
    return {k: v.cpu() for k, v in params.items()}


@pytest.mark.gpu
def test_extend_state_on_card_matches_cpu(setup):
    """``sample.extend_state`` from a prefilled state on the card against
    the same call on the CPU, at v = 0, a partial v and k."""
    from wavenet_torch import sample as ts
    c, params, rng = setup
    pc = _to_cpu(params)
    B, k = 2, 16
    codes = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                        (B, c.receptive_field + k)),
                            dtype=torch.int32)
    gids = torch.tensor([1, 3])
    prefix, win = codes[:, :c.receptive_field], codes[:, c.receptive_field:]
    st_g = ts.prefill_state(params, c, prefix.cuda(),
                            embed_gc(params, c, gids.cuda()))
    st_c = ts.prefill_state(pc, c, prefix, embed_gc(pc, c, gids))
    for v in (0, 7, k):
        lg, sg = ts.extend_state(params, c, st_g, win.cuda(),
                                 embed_gc(params, c, gids.cuda()),
                                 valid_len=v)
        lc_, sc = ts.extend_state(pc, c, st_c, win, embed_gc(pc, c, gids),
                                  valid_len=v)
        assert lg.is_cuda and sg.layer_bufs.is_cuda and sg.t == sc.t
        np.testing.assert_allclose(lg.cpu().numpy(), lc_.numpy(), **TOL)
        np.testing.assert_allclose(sg.layer_bufs.cpu().numpy(),
                                   sc.layer_bufs.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(sg.causal_buf.cpu().numpy(),
                                   sc.causal_buf.numpy(), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["plain", "pallas_stack", "streaming"])
def test_log_likelihood_on_card_matches_cpu(setup, route):
    """``score.log_likelihood`` on the card (the plain forward, or the
    fused stack's forward at ``use_pallas_stack``, which must launch) and
    ``log_likelihood_streaming`` against the one-shot call on the CPU."""
    from wavenet_torch import score
    c, params, rng = setup
    pc = _to_cpu(params)
    B, T = 2, 3000
    audio = torch.as_tensor(rng.uniform(-1, 1, (B, T)).astype(np.float32))
    gids = torch.tensor([0, 2])
    ref = score.log_likelihood(pc, c, audio, gids)
    cg = dataclasses.replace(c, use_pallas_stack=route == "pallas_stack")
    before = fs.forward.launches
    if route == "streaming":
        got = score.log_likelihood_streaming(params, cg, audio.cuda(),
                                             gids.cuda(), chunk=512)
    else:
        got = score.log_likelihood(params, cg, audio.cuda(), gids.cuda())
        np.testing.assert_allclose(got["logp_per_sample"].cpu().numpy(),
                                   ref["logp_per_sample"].numpy(), rtol=0,
                                   atol=1e-4)
    assert (fs.forward.launches > before) == (route == "pallas_stack")
    np.testing.assert_allclose(got["total_logp"].cpu().numpy(),
                               ref["total_logp"].numpy(), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.gpu
def test_speculative_on_card_accepts_an_identical_draft(setup):
    """Speculative decoding on the card with the target as its own draft:
    every proposal accepted, no decode kernel launched, and the committed
    state equal to the CPU's prefill of the consumed stream."""
    from wavenet_torch import sample as ts
    from wavenet_torch.speculative import _speculative_loop
    c, params, rng = setup
    seed = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                       (1, c.receptive_field)),
                           dtype=torch.int32, device="cuda")
    gid = torch.tensor([1], device="cuda")
    emb = embed_gc(params, c, gid)
    st = ts.prefill_state(params, c, seed[:, :-1], emb)
    key = torch.Generator(device="cuda").manual_seed(5)
    before = ks.decode.launches
    codes, t_st, d_st, _, (n_seg, n_acc, n_out) = _speculative_loop(
        params, c, params, c, st, st, seed[:, -1], key, 200, 8, 1.0, emb,
        emb)
    assert ks.decode.launches == before
    assert n_acc == 8 * n_seg and codes.shape == (1, n_out)
    stream = torch.cat([seed[0], codes[0]])[:t_st.t].cpu()[None]
    pc = _to_cpu(params)
    ref = ts.prefill_state(pc, c, stream, embed_gc(pc, c, gid.cpu()))
    np.testing.assert_allclose(t_st.layer_bufs.cpu().numpy(),
                               ref.layer_bufs.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The retired v1 stack at every width (kernel 5's kernels behind it where
# the carry kernel is not built) and kernel 8 at every width (the tiled
# kernel's layer entries)
# ---------------------------------------------------------------------------

V1_WIDE_CASES = [
    (64, (1, 64, 2, 33, 512, 7), 2, 700, True, "mma"),
    (256, (1, 33, 4, 128), 1, 700, False, "tiled"),
    ((48, 128), (1, 65, 2), 3, 700, True, "tiled"),
    ((24, 48), (1, 2, 4), 2, 150, True, "tiled"),     # D 48: no TPU record
    ((5, 3), (1, 2, 4), 2, 150, False, "tiled"),      # odd, off 8 bytes
    ((16, 8), (1, 2, 4), 2, 150, True, "tiled"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("W,dilations,B,T,gc,kernel", V1_WIDE_CASES)
def test_v1_stack_matches_reference_at_every_width(setup, W, dilations, B, T,
                                                   gc, kernel, bf16):
    """v1's wrappers where the carry kernel is not built, routed by
    ``v1_kernel_plan`` to kernel 5's kernels (the tiled kernel's v1
    entries, with no z record, at every width, the D of 48 and 3 that its
    TPU records cannot pack included): y, fg and every gradient against
    the plain versions (bf16 on the gap from float32), counted under
    ``v1_<kernel>``; y and fg bitwise kernel 5's own launch where kernel 5
    takes the width; repeats bitwise equal; the op's gradients are the
    backward's."""
    c32, c, args, dy, dz = _tiled_case(W, dilations, B, T, gc, bf16)
    assert fs1.v1_kernel_plan(c) == kernel
    key = f"v1_{kernel}" + ("_bf16" if bf16 else "")
    f0 = fs1.fused_stack_forward.launches_by[key]
    b0 = fs1.fused_stack_backward.launches_by[key]
    k0 = (fs.forward.launches, fs.backward.launches)
    out = fs1.fused_stack_forward(*args, c)
    ref = fs1.fused_stack_forward_reference(*args, c)
    ref32 = fs1.fused_stack_forward_reference(*args, c32)
    w_fg, wd, _, bd = args[1:]
    yr, fgr = ref
    grads = fs1.fused_stack_backward(yr, fgr, dz, dy, w_fg, wd, bd, c)
    gref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    gref32 = fs.fused_stack_backward_reference(ref32[0], dy, ref32[1], dz,
                                               w_fg, wd, bd, c32)
    torch.cuda.synchronize()
    assert fs1.fused_stack_forward.launches_by[key] == f0 + 1
    assert fs1.fused_stack_backward.launches_by[key] == b0 + 1
    assert (fs.forward.launches, fs.backward.launches) == k0
    L, R = c.num_layers, c.residual_channels
    grads = (grads[0], grads[1].reshape(L, 2 * R, -1)) + tuple(grads[2:])
    _hold_tiled(out, ref, ref32, grads, gref, gref32, bf16)
    again = fs1.fused_stack_forward(*args, c)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    again = fs1.fused_stack_backward(yr, fgr, dz, dy, w_fg, wd, bd, c)
    assert torch.equal(again[1].reshape(L, 2 * R, -1), grads[1])
    assert all(torch.equal(a, b) for a, b in zip(
        (grads[0],) + grads[2:], (again[0],) + tuple(again[2:])))
    if fs._lane_alignable(c.dilation_channels) and fs._lane_alignable(
            2 * c.dilation_channels):
        y5, fg5, _ = fs.forward(*args, c, kernel=kernel)
        assert torch.equal(y5, out[0]) and torch.equal(fg5, out[1])

    leaves = [a.clone().requires_grad_(True) for a in args]
    y, z = fs1.fused_stack(*leaves, c)
    assert z.dtype == torch.float32
    (y * dy).sum().add((z * dz).sum()).backward()
    y1, fg1 = fs1.fused_stack_forward(*args, c)
    want = fs1.fused_stack_backward(y1, fg1, dz, dy, w_fg, wd, bd, c)
    want = (want[0], want[1].reshape(L, 2 * R, -1)) + tuple(want[2:])
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


@pytest.mark.gpu
def test_v1_stack_pins_and_refusals(setup):
    """A pinned kernel raises at a width it lacks, with nothing launched:
    ``kernel="carry"`` at R = D = 64 and at (24, 48); ``kernel="stack"``
    at R = D = 16 runs kernel 5's simt kernel, "auto" the carry kernel; a
    kernel name v1 lacks is refused."""
    n = (fs1.fused_stack_forward.launches, fs1.fused_stack_backward.launches)
    for W in (64, (24, 48)):
        c, args, (dy, dz) = _stack_inputs(W, (1, 2), 2, 64)
        with pytest.raises(NotImplementedError, match="fused_stack_carry"):
            fs1.fused_stack_forward(*args, c, kernel="carry")
        y, fg = fs1.fused_stack_forward_reference(*args, c)
        with pytest.raises(NotImplementedError, match="fused_stack_carry"):
            fs1.fused_stack_backward(y, fg, dz, dy, args[1], args[2],
                                     args[4], c, kernel="carry")
    with pytest.raises(ValueError, match="kernel"):
        fs1.fused_stack_forward(*args, c, kernel="mma")
    assert (fs1.fused_stack_forward.launches,
            fs1.fused_stack_backward.launches) == n
    c, args, _ = _stack_inputs(16, (1, 2), 2, 64)
    assert fs1.v1_kernel_plan(c) == "carry"
    assert fs1.v1_kernel_plan(c, "stack") == "simt"
    s0 = fs1.fused_stack_forward.launches_by["v1_simt"]
    c0 = fs1.fused_stack_forward.launches_by["carry"]
    a = fs1.fused_stack_forward(*args, c, kernel="stack")
    b = fs1.fused_stack_forward(*args, c)
    torch.cuda.synchronize()
    assert fs1.fused_stack_forward.launches_by["v1_simt"] == s0 + 1
    assert fs1.fused_stack_forward.launches_by["carry"] == c0 + 1
    for got, want in zip(a, b):
        torch.testing.assert_close(got, want, **FWD_TOL)


def _layer_inputs_rd(R, D, B, T, seed=0):
    """A layer's inputs and cotangents at widths R, D, the weights shrunk
    with the fan-in above 32 (as ``_stack_inputs``)."""
    rng = np.random.RandomState(seed)

    def rn(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device="cuda")

    def ws(fan):
        return 0.3 * min(1.0, (32 / fan) ** 0.5)

    return ((rn(B, T, R, scale=0.5), rn(2, R, 2 * D, scale=ws(R)),
             rn(D, R, scale=ws(D)), rn(B, 2 * D, scale=0.1),
             rn(1, R, scale=0.1)), (rn(B, T, R), rn(B, T, D)))


LAYER_WIDE_CASES = [
    ((64, 64), 4, 2, 700), ((64, 64), 1, 3, 150),
    ((48, 128), 4, 2, 300), ((16, 8), 1, 2, 150), ((5, 3), 4, 2, 150),
    ((256, 256), 4, 1, 500), ((256, 256), 300, 2, 300),   # d = T
]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("RD,d,B,T", LAYER_WIDE_CASES)
def test_dilated_layer_tiled_matches_reference(setup, RD, d, B, T, mode):
    """Kernel 8 on the tiled kernel's layer entries (every width the layer
    kernel lacks) against the plain versions in each mode (bf16 by the
    layer's rule: x, dy and dz rounded; held on the gap from float32),
    counted under ``tiled_<mode>``; the backward bitwise repeatable; the
    op's gradients are the backward's, dpast shift-added."""
    R, D = RD
    (x, w, wd, add, bd), (dy, dz) = _layer_inputs_rd(R, D, B, T)
    cd = {"f32": torch.float32, "bf16": torch.bfloat16}[mode]
    key = f"tiled_{mode}"
    assert dl.layer_kernel_plan(R, D) == "tiled"
    m0 = dl.forward.launches_by[key], dl.backward.launches_by[key]
    y, z = dl.forward(x, w, wd, add, bd, d, cd)
    got = dl.backward(x, w, wd, add, dy, dz, d, cd)
    again = dl.backward(x, w, wd, add, dy, dz, d, cd)
    yr, zr = dl.fused_dilated_layer_reference(x, w, wd, add, bd, d,
                                              compute_dtype=cd)
    ref = dl.fused_dilated_layer_backward_reference(x, w, wd, add, dy, dz, d,
                                                    compute_dtype=cd)
    torch.cuda.synchronize()
    assert (dl.forward.launches_by[key],
            dl.backward.launches_by[key]) == (m0[0] + 1, m0[1] + 2)
    names = ("y", "z", "dx_local", "dpast", "dw", "dwd", "dadd", "dbd")
    outs, refs = (y, z) + tuple(got), (yr, zr) + tuple(ref)
    if mode == "f32":
        for i, (name, g, r) in enumerate(zip(names, outs, refs)):
            _hold_scaled(g, r, FWD_TOL if i < 2 else GRAD_TOL, 0, name)
    else:
        ref32 = dl.fused_dilated_layer_reference(x, w, wd, add, bd, d) + \
            dl.fused_dilated_layer_backward_reference(x, w, wd, add, dy, dz,
                                                      d)
        for name, g, r, r32 in zip(names, outs, refs, ref32):
            assert g.dtype == torch.float32, name
            _hold_bf16(g, r, r32, name)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [a.clone().requires_grad_(True) for a in (x, w, wd, add, bd)]
    yo, zo = dl.fused_dilated_layer(*leaves, d, compute_dtype=cd)
    (yo * dy).sum().add((zo * dz).sum()).backward()
    assert torch.equal(yo.detach(), y) and torch.equal(zo.detach(), z)
    dx = dl._shift_left_add(got[0], got[1], d)
    for t, g in zip(leaves, (dx,) + tuple(got[2:])):
        assert torch.equal(t.grad, g)


@pytest.mark.gpu
def test_dilated_layer_route_takes_the_library_widths(setup):
    """``layer_kernel_plan`` sends to the layer kernel exactly the widths
    its library is built for (``dilated_layer_supports_width``), every
    other width to the tiled layer entries, whose library takes it."""
    lib = dl._lib()
    tiled = dl._tiled_lib()
    for R in (1, 3, 4, 8, 16, 24, 32, 48, 64, 128, 256):
        for D in (1, 3, 4, 8, 16, 32, 64, 128, 256):
            used = dl.layer_kernel_plan(R, D)
            assert bool(lib.dilated_layer_supports_width(R, D)) == (
                used == "layer"), (R, D)
            if used == "tiled":
                assert tiled.fused_stack_tiled_layer_scratch_floats(
                    0, 0, 2, 64, R, D) >= 0, (R, D)


# ---------------------------------------------------------------------------
# The bf16 ring (the JAX kernels at state_dtype=bfloat16): each layer's past
# row read widened, its input stored rounded to nearest even, on the three
# kernels at either weight type, with LC where the kernel has it
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# One step's logits at float32 weights: a ring row is stored after it is
# read, so the float32 tolerance holds whatever the ring's type.
RING16_TOL = dict(rtol=1e-4, atol=1e-5)


def _ring16_case(width, B, wdt, lc, seed=0):
    """(config, packed weights at ``wdt``, float32 packed weights, carry
    with its ring rounded to bf16, teacher-forced inputs, LC stream or
    None): ``_cluster_case`` or, with ``lc``, ``_lc_case``."""
    if lc:
        c, _, pk32, carry, forced, stream = _lc_case(width, B, seed)
    else:
        c, _, pk32, carry, forced = _cluster_case(width, B, seed)
        stream = None
    fields = ks.WEIGHT_FIELDS + (("lc_w",) if lc else ())
    pk = (pk32 if wdt == "f32" else
          pk32._replace(**{k: getattr(pk32, k).to(BF16) for k in fields}))
    carry = carry._replace(ring=carry.ring.to(BF16))
    return c, pk, pk32, carry, forced, stream


def _ring16_stepwise(where, c, pk, pk32, ring, causal, forced, t0, seed,
                     round_chain, launch, lc=None):
    """``bf16_hold.stepwise`` from a bf16 ring. At float32 weights each
    step's logits within RING16_TOL of the plain version's, and the rows
    each step writes bitwise the plain version's but for ``hold_ring16``'s
    flips (which a truncating store would exceed); at bf16 weights both on
    ``bf16_hold.hold``'s gap rule, since a flipped operand rounding moves
    the later layers' rows by more than an ulp (``bf16_hold``'s
    docstring). Returns (the kernel's logits [B, n, Q], the rows' hold)."""
    bf16 = ks.weight_dtype_of(pk) == BF16
    lg, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
        c, pk, pk32 if bf16 else pk, ring, causal, forced, t0, seed,
        round_chain, launch, lc=lc)
    torch.cuda.synchronize()
    if bf16:
        bf16_hold.hold(where, lg, lg16, lg32)
        return lg, bf16_hold.hold(f"{where} ring", rk, r16, r32)
    torch.testing.assert_close(lg, lg16, **RING16_TOL)
    return lg, bf16_hold.hold_ring16(f"{where} ring", rk, r16)


RING16_CASES = [("cluster", "paper", 1, False), ("cluster", "paper", 64, False),
                ("cluster", "scalar_wide", 4, False),
                ("cluster", "paper", 1, True), ("cluster", "small", 4, True),
                ("tiles", "paper", 128, False), ("tiles", "paper", 512, False),
                ("decode", "paper", 600, False),
                ("decode", "scalar_wide", 5, False),
                ("decode", "paper", 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("wdt", ["f32", "bf16"])
@pytest.mark.parametrize("kernel,width,B,lc", RING16_CASES)
def test_ring16_kernel_matches_reference_stepwise(setup, kernel, width, B, lc,
                                                  wdt):
    """Each kernel's bf16-ring mode, pinned, teacher-forced from a prefilled
    ring rounded to bf16: the window in one launch (counted under its
    ``_ring16`` name) equals it one step a launch, and each step is held
    against ``decode_reference`` from the kernel's own bf16 ring."""
    c, pk, pk32, carry, forced, stream = _ring16_case(width, B, wdt, lc)
    n = 16
    forced = forced[:, :n].contiguous()
    stream = None if stream is None else stream[:n].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    key = (kernel + ("_bf16" if wdt == "bf16" else "") + ("_lc" if lc else "")
           + "_ring16")
    before = ks.decode.launches_by[key]
    kk, lk = ks.decode(pk, c, rk, ck, forced, n, carry.t_abs, 3,
                       collect_logits=True, kernel=kernel, lc=stream)
    torch.cuda.synchronize()
    assert ks.decode.launches_by[key] == before + 1
    assert rk.dtype == BF16
    assert torch.equal(kk[:, :-1], ks.mu_law_encode_f(
        forced[:, 1:], c.quantization_channels) if c.scalar_input
        else forced[:, 1:])

    def step(ring, causal, x, t):
        i = t - carry.t_abs
        return ks.decode(pk, c, ring, causal, x, 1, t, 3, collect_logits=True,
                         kernel=kernel,
                         lc=None if stream is None else stream[i:i + 1])[1]

    ring, causal = carry.ring.clone(), carry.causal.clone()
    lg, _ = _ring16_stepwise(f"{key} {width} B={B}", c, pk, pk32, ring,
                             causal, forced, carry.t_abs, 3,
                             ks.chain_rounded("decode", B, lc), step,
                             lc=stream)
    assert torch.equal(lg, lk) and torch.equal(ring, rk)
    assert torch.equal(causal, ck)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,B", [("cluster", 4), ("tiles", 128),
                                      ("decode", 5)])
def test_ring16_window_holds_on_the_ring_gap(setup, kernel, B):
    """A teacher-forced window of 30 steps in one launch from a bf16 ring
    at float32 weights, held against the plain version from the same ring
    on the scale of the plain version's distance from itself at a float32
    ring (the same values, widened). A stored row's rounding flips where
    another sum order moves its input across a rounding boundary, and the
    flip carries on through the ring: over 30 steps at b128 the plain
    version in float64 read a row's median 0.34 of that row's median gap
    from itself in float32 (on the CPU), so the window is held as the
    plain version holds itself (``bf16_hold.hold_as_plain``, the plain
    version stepped on the CPU standing for another sum order). A kernel
    that stored the ring at float32 would read the whole gap, 1.
    (At bf16 weights the weights' flips carry on further than that gap:
    a bf16 window is held a step a launch.)"""
    c, pk, _, carry, forced, _ = _ring16_case("paper", B, "f32", False)
    n = 30
    forced = forced[:, :n].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    _, lk = ks.decode(pk, c, rk, ck, forced, n, carry.t_abs, 5,
                      collect_logits=True, kernel=kernel)
    ref = {}
    for dt in (BF16, torch.float32):
        ring, causal = carry.ring.to(dt, copy=True), carry.causal.clone()
        ref[dt] = ks.decode_reference(pk, c, ring, causal, forced, n,
                                      carry.t_abs, 5, collect_logits=True)[1]
    cpu = type(pk)(*[t.cpu() if isinstance(t, torch.Tensor) else t
                     for t in pk])
    plain = ks.decode_reference(cpu, c, carry.ring.cpu(), carry.causal.cpu(),
                                forced.cpu(), n, carry.t_abs, 5,
                                collect_logits=True)[1].cuda()
    torch.cuda.synchronize()
    assert not torch.equal(ref[BF16], ref[torch.float32])
    bf16_hold.hold_as_plain(
        f"{kernel} B={B} window",
        bf16_hold.ratios(lk, ref[BF16], ref[torch.float32]),
        bf16_hold.ratios(plain, ref[BF16], ref[torch.float32]))


@pytest.mark.gpu
@pytest.mark.parametrize("wdt", ["f32", "bf16"])
@pytest.mark.parametrize("kernel,B", [("cluster", 1), ("tiles", 200),
                                      ("decode", 3)])
def test_ring16_kernel_is_deterministic(setup, kernel, B, wdt):
    """Same seed, same codes, logits and bf16 ring, sampled over 40 steps
    from a prefilled ring. The bf16 ring's logits are not the float32
    ring's, but where bf16 weights round the chain (B > 1): there the fg
    product rounds each past row to bf16 as its operand anyway, and
    rounding twice to nearest even is rounding once, so the two rings
    compute the same bits."""
    c, pk, _, carry, _, _ = _ring16_case("paper", B, wdt, False, seed=1)
    x = carry.last[:, None].contiguous()
    runs = []
    for dt in (BF16, BF16, torch.float32):
        ring, causal = carry.ring.to(dt, copy=True), carry.causal.clone()
        runs.append(ks.decode(pk, c, ring, causal, x, 40, carry.t_abs, 9,
                              collect_logits=True, kernel=kernel) + (ring,))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    same = wdt == "bf16" and ks.chain_rounded("decode", B)
    assert torch.equal(runs[0][1], runs[2][1]) == same
    assert torch.equal(runs[0][0], runs[2][0]) or not same
    assert len(torch.unique(runs[0][0])) > 8


@pytest.mark.gpu
def test_ring16_generation_routes_as_float32(setup):
    """``generate_cuda(state_dtype=bfloat16)`` on both routes: each launch
    the float32 ring's kernel, named with "_ring16"; the prefill route
    from the prefilled ring rounded once, the sequential one from a zero
    bf16 ring; same seeds repeat bitwise."""
    from wavenet_torch.models.config import gc_config
    c = gc_config(gc_cardinality=8)
    params = _seeded_params(c)
    for B, kernel in ((1, "cluster"), (128, "tiles"), (600, "decode")):
        for prefill, counter in ((True, ks.decode),
                                 (False, ks.decode_sequential)):
            ids = torch.arange(B, device="cuda") % 8
            before = dict(counter.launches_by)
            runs = [ks.generate_cuda(params, c, 24, 3, B, gc_ids=ids,
                                     collect_logits=True, prefill=prefill,
                                     state_dtype=BF16) for _ in range(2)]
            torch.cuda.synchronize()
            ran = {k: v - before.get(k, 0)
                   for k, v in counter.launches_by.items()
                   if v != before.get(k, 0)}
            assert ran == {f"{kernel}_ring16": 2}, (B, prefill, ran)
            assert all(torch.equal(a, b) for a, b in zip(*runs))
    with pytest.raises(ValueError, match="state_dtype"):
        ks.generate_cuda(params, c, 4, 3, 1, gc_ids=torch.zeros(
            1, dtype=torch.int64, device="cuda"), state_dtype=torch.float16)


@pytest.mark.gpu
def test_ring16_without_its_library_raises(setup, monkeypatch):
    """A bf16-ring request whose library cannot be built raises: nothing
    stands in for it, neither the float32 ring nor the plain version."""
    from wavenet_torch.kernels import _build
    load = _build.load

    def no_ring16(name):
        if name.endswith("_ring16"):
            raise RuntimeError(f"nvcc failed to build {name}")
        return load(name)

    monkeypatch.setattr(_build, "load", no_ring16)
    for kernel in ("cluster", "tiles", "decode"):
        B = 128 if kernel == "tiles" else 1
        c, pk, _, carry, forced, _ = _ring16_case("paper", B, "f32", False)
        before = dict(ks.decode.launches_by)
        ring = carry.ring.clone()
        with pytest.raises(RuntimeError, match="_ring16"):
            ks.decode(pk, c, ring, carry.causal.clone(),
                      forced[:, :2].contiguous(), 2, carry.t_abs, 0,
                      kernel=kernel)
        assert dict(ks.decode.launches_by) == before
        assert torch.equal(ring, carry.ring)


@pytest.mark.gpu
def test_ring16_tiles_libraries_match_the_plan(setup):
    """The bf16-ring tiles libraries' shared memory and resident clusters
    at every row count are the float32 library's, which the plan takes."""
    import ctypes
    from wavenet_torch.kernels import _build
    libs = [_build.load(n) for n in ("sampler_tiles", "sampler_tiles_ring16",
                                     "sampler_tiles_bf16_ring16")]
    for lib in libs:
        lib.sampler_tiles_smem_bytes.argtypes = [ctypes.c_int]
        lib.sampler_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.sampler_tiles_max_clusters.argtypes = [ctypes.c_int,
                                                   ctypes.c_void_p]
        lib.sampler_tiles_max_clusters.restype = ctypes.c_int
    for rb in ks.TILE_ROWS:
        counts = []
        for lib in libs:
            assert lib.sampler_tiles_smem_bytes(rb) == ks.tile_smem_bytes(rb)
            n = ctypes.c_int(0)
            assert lib.sampler_tiles_max_clusters(rb, ctypes.byref(n)) == 0
            counts.append(n.value)
        assert counts[0] == counts[1] == counts[2] > 0, (rb, counts)


# ---------------------------------------------------------------------------
# Parallelism on the card (torch.distributed over NCCL at world size 1) and
# the server's scan sampler
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_group(setup, tmp_path):
    """A one-process NCCL group (file rendezvous), destroyed after."""
    import torch.distributed as dist
    from wavenet_torch.parallel import initialize_multihost
    assert initialize_multihost("file://" + str(tmp_path / "rendezvous"),
                                1, 0, device="cuda") is False
    try:
        yield dist
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_world_of_one_starts(nccl_group):
    from wavenet_torch.parallel import make_global_mesh
    dist = nccl_group
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    mesh = make_global_mesh()
    assert mesh.device_type == "cuda"
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                          "model": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "fused"])
def test_data_parallel_step_equals_plain_step_on_card(nccl_group, setup,
                                                      pallas):
    """The mesh's step (NCCL all-reduces of a world of one) is bitwise the
    one-process step: the mean of one is exact."""
    from wavenet_torch import train_lib as tl
    from wavenet_torch.parallel import make_global_mesh, shard_train_state
    c = dataclasses.replace(setup[0], use_pallas_stack=pallas)
    mesh = make_global_mesh()
    rng = np.random.RandomState(3)
    batches = [(torch.as_tensor(rng.uniform(-1, 1, (2, c.receptive_field
                                                    + 64)),
                                dtype=torch.float32, device="cuda"),
                torch.as_tensor(rng.randint(0, 4, 2), device="cuda"))
               for _ in range(2)]
    runs = []
    for m in (None, mesh):
        state = tl.train_state_from_params(
            init_params(0, c, device="cuda"), tl.make_optimizer("adam", 1e-3))
        state = shard_train_state(state, c, m)
        step = tl.make_train_step(c, 0.001, mesh=m)
        losses = [float(step(state, a, g)[1]["loss"]) for a, g in batches]
        runs.append((losses, state.params))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


@pytest.mark.gpu
def test_server_scan_sampler_on_card(setup, tmp_path):
    """--sampler scan serves the scan sampler on the card: its codes are
    sample.generate's there, and the reply names it."""
    import json
    from wavenet_torch.audio import mu_law_encode_np
    from wavenet_torch.params import save_npz
    from wavenet_torch.sample import generate
    from wavenet_torch.serve import GenerationService
    c, params, _ = setup
    npz = str(tmp_path / "m.npz")
    save_npz(npz, params)
    js = tmp_path / "m.json"
    js.write_text(json.dumps(c.to_json_dict()))
    svc = GenerationService(npz, str(js), c.gc_channels, c.gc_cardinality,
                            sampler="scan", warm_samples=0, device="cuda")
    wave, name = svc.generate(48, gc_id=1, seed=4, return_sampler=True)
    assert name == "scan" == svc.sampler_name
    ref = generate(params, c, GenerationService.bucket_samples(48),
                   torch.Generator(device="cuda").manual_seed(4),
                   gc_ids=torch.tensor([1], device="cuda"))[0, :48]
    np.testing.assert_array_equal(
        mu_law_encode_np(wave, c.quantization_channels), ref.cpu().numpy())
