"""The port's CUDA kernels (``sampler_decode``, ``fused_stack``) against
their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA GPU:
the kernels have no CPU mode. The file imports no JAX, so on a machine with
a GPU and without JAX it runs alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

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
                       collect_logits=True)
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
                            carry.t_abs, 11, collect_logits=8)
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


# Fused stack: another summation order; gradients also rebuild each
# layer's input by subtraction (the tolerances of the JAX kernel's tests).
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _stack_inputs(W, dilations, B, T, seed=0):
    c = WaveNetConfig(dilations=dilations, residual_channels=W,
                      dilation_channels=W, skip_channels=16,
                      quantization_channels=32)
    L = c.num_layers
    rng = np.random.RandomState(seed)

    def rn(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device="cuda")

    args = (rn(B, T, W, scale=0.5), rn(L, 2 * W, 2 * W, scale=0.2),
            rn(L, W, W, scale=0.2), rn(L, B, 2 * W, scale=0.1),
            rn(L, 1, W, scale=0.1))
    cot = (rn(B, T, W), rn(B, T, L * W))
    return c, args, cot


@pytest.mark.gpu
@pytest.mark.parametrize("W,dilations,B,T", [
    (8, (1, 2, 4, 8, 16), 2, 150),
    (16, (1, 64, 2, 512), 3, 700),
    (32, (1, 2, 4, 8, 16, 32, 64, 128, 256, 512), 2, 1500),
])
def test_fused_stack_matches_reference(setup, W, dilations, B, T):
    c, args, (dy, dz) = _stack_inputs(W, dilations, B, T)
    f0, b0 = fs.forward.launches, fs.backward.launches
    y, fg, z = fs.forward(*args, c)
    yr, fgr, zr = fs.fused_stack_forward_reference(*args, c)
    torch.cuda.synchronize()
    assert fs.forward.launches == f0 + 1
    for got, ref in ((y, yr), (fg, fgr), (z, zr)):
        torch.testing.assert_close(got, ref, **FWD_TOL)
    w_fg, wd, _, bd = args[1:]
    grads = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    ref = fs.fused_stack_backward_reference(yr, dy, fgr, dz, w_fg, wd, bd, c)
    torch.cuda.synchronize()
    assert fs.backward.launches == b0 + 1
    for name, got, want in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"),
                               grads, ref):
        torch.testing.assert_close(got, want, **GRAD_TOL, msg=name)
    # Fixed-order partial sums, no atomics: a second call is bitwise equal.
    again = fs.backward(yr, dy, fgr, dz, w_fg, wd, bd, c)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_fused_stack_op_gradients(setup):
    """The autograd op on the card against autograd of the plain forward
    written out layer by layer."""
    c, args, (dy, dz) = _stack_inputs(16, (1, 2, 4, 8, 16, 32), 2, 300, 1)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, z = fs.fused_stack3(*leaves, c)
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


@pytest.mark.gpu
def test_fused_stack_rejects_bad_inputs(setup):
    c, args, (dy, dz) = _stack_inputs(8, (1, 2), 2, 64)
    x, w_fg, wd, add, bd = args
    with pytest.raises(ValueError, match="x"):
        fs.forward(x.double(), w_fg, wd, add, bd, c)
    with pytest.raises(ValueError, match="contiguous"):
        fs.forward(x.transpose(0, 1).contiguous().transpose(0, 1), w_fg, wd,
                   add, bd, c)
    wide = WaveNetConfig(dilations=(1, 2), residual_channels=8,
                         dilation_channels=16, skip_channels=16,
                         quantization_channels=32)
    with pytest.raises(NotImplementedError, match="R == D"):
        fs.forward(x, w_fg, wd, add, bd, wide)
