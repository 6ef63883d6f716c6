"""The 3xTF32 stack kernel's route and arithmetic, on the CPU.

``csrc/fused_stack_mma.cu`` multiplies on the tensor cores: each float32
operand is split into hi = tf32(a) and lo = tf32(a - hi), and a product is
lo.hi + hi.lo + hi.hi. ``kernels.fused_stack.mma3_matmul`` repeats that
arithmetic in plain PyTorch (the split on the float32 words' bits), so
these tests show without a GPU that the split keeps float32 parity: the
whole stack forward and backward with every product through it is held
against ``wavenet_tpu.kernels.fused_stack3`` run in interpret mode, at the
tolerances of ``tests/test_torch_fused_stack.py``. The kernel itself is
held against the plain versions on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.kernels import fused_stack3 as jfs
from wavenet_tpu.models.wavenet import embed_gc as jembed_gc
from wavenet_tpu.models.wavenet import init_params as jinit_params
from wavenet_torch.kernels import fused_stack as tfs
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_fused_stack import small_cfg

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
B, T = 2, 150   # several 64-row tiles, the last one ragged


def _tcfg(jcfg):
    return TConfig(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def _width(W, **kw):
    R, D = W if isinstance(W, tuple) else (W, W)
    return TConfig(dilations=(1, 2), residual_channels=R,
                   dilation_channels=D, skip_channels=16,
                   quantization_channels=32, **kw)


@pytest.mark.parametrize("W,want", [(8, "simt"), (16, "simt"), (32, "mma"),
                                    (64, "mma"), (128, "tiled"),
                                    ((128, 64), "tiled"), (48, None)])
def test_stack_kernel_plan(W, want):
    c = _width(W)
    if want is None:
        with pytest.raises(NotImplementedError, match="TPU kernel's widths"):
            tfs.stack_kernel_plan(c)
    else:
        assert tfs.stack_kernel_plan(c) == want


def test_stack_kernel_plan_dtype_and_unequal_widths():
    # The plan is by width alone: both kernels take float32, and on the
    # card the wrappers refuse another dtype (tests/test_torch_gpu.py). On
    # the CPU a float64 stack runs the plain versions, even pinned to mma.
    c, args, _ = _small_args(32)
    assert tfs.stack_kernel_plan(c) == "mma"
    args = [a.double() for a in args]
    out = tfs.forward(*args, c, kernel="mma")
    want = tfs.fused_stack_forward_reference(*args, c)
    assert all(a.dtype == torch.float64 and torch.equal(a, b)
               for a, b in zip(out, want))
    c = TConfig(dilations=(1, 2), residual_channels=32, dilation_channels=16,
                skip_channels=16, quantization_channels=32)
    assert tfs.stack_kernel_plan(c) == "tiled"    # R != D: the tiled kernel


def _spread(n, seed):
    """float32 values over 12 decades, both signs, and a few edge cases."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n) * 10.0 ** rng.uniform(-6, 6, n)
    edge = [1.0, -1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, 3.0 * 2.0 ** -12,
            np.float32(np.pi), 6.5e4, 1e-30]
    return torch.as_tensor(np.concatenate([v, edge]).astype(np.float32))


def test_tf32_split_reconstructs():
    a = _spread(20000, 0)
    hi, lo = tfs.tf32_split(a)
    for part in (hi, lo):        # both are TF32: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - a.double()).abs()
           / a.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
    # One TF32 pass alone keeps ~11 bits: far outside that bound.
    assert ((hi.double() - a.double()).abs()
            / a.double().abs()).max().item() > 2.0 ** -13
    # Round to nearest, ties away from zero.
    assert tfs.tf32_split(torch.tensor([1.0 + 2.0 ** -11]))[0].item() \
        == 1.0 + 2.0 ** -10
    assert tfs.tf32_split(torch.tensor([-(1.0 + 2.0 ** -11)]))[0].item() \
        == -(1.0 + 2.0 ** -10)


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000,
                                  0x7F800001, 0x7F800000, 0xFF800000],
                         ids=["nan_all_ones", "neg_nan_all_ones", "nan_quiet",
                              "nan_low_bit", "inf", "neg_inf"])
def test_tf32_split_keeps_non_finite(bits):
    """A non-finite operand stays non-finite: a NaN's lo is NaN (its hi may
    not be: the rounding's carry wraps an all-ones mantissa round to
    zero), an infinity's hi is that infinity and its lo NaN, so a product
    that takes either is non-finite where the float32 product is."""
    a = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    hi, lo = tfs.tf32_split(a)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.isnan(lo).item()
    if not torch.isnan(a).item():
        assert hi.item() == a.item()
    m = torch.ones(2, 8)
    m[1, 3] = a[0]               # the bits as they are
    out = tfs.mma3_matmul(m, torch.ones(8, 8))
    assert torch.isfinite(out[0]).all()
    assert not torch.isfinite(out[1]).any()


def test_mma3_matmul_within_float32_bound():
    """A 64 x 64 x 64 product against float64: within the float32 sum's own
    bound, K * 2^-24 * (|a| @ |b|) = 2^-18 * (|a| @ |b|), which the split's
    ~2^-21 relative error per term adds little to; one TF32 pass is not."""
    rng = np.random.RandomState(1)
    a = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    b = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    exact = a.double() @ b.double()
    bound = 2.0 ** -18 * (a.double().abs() @ b.double().abs())
    got = tfs.mma3_matmul(a, b)
    assert ((got.double() - exact).abs() <= bound).all()
    # Within a few times float32's own matmul error.
    f32_err = ((a @ b).double() - exact).abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 4 * f32_err
    ah, _ = tfs.tf32_split(a)
    bh, _ = tfs.tf32_split(b)
    one_pass = (ah @ bh).double()
    assert not ((one_pass - exact).abs() <= bound).all()


def _setup(gc: bool, seed: int, **kw):
    jcfg = small_cfg(gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None, **kw)
    jp = {k: np.asarray(v)
          for k, v in jinit_params(jax.random.PRNGKey(seed), jcfg).items()}
    rng = np.random.RandomState(seed)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, jcfg.residual_channels) * 0.5).astype(np.float32)
    ids = np.array([0, 3]) if gc else None
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    jgc = None if ids is None else jembed_gc(jparams, jcfg, jnp.asarray(ids))
    jpack = jfs.pack_stack_weights(jparams, jcfg, jgc, B)
    tp = params_from_numpy(jp, "cpu")
    tgc = None if ids is None else tp["gc_embedding"][torch.as_tensor(ids)]
    tpack = tfs.pack_stack_weights(tp, _tcfg(jcfg), tgc, B)
    return jcfg, x, jpack, tpack, rng


# The JAX kernel tests' small config (5 layers, R = D = 8) and the kernel's
# own widths, R = D = 32 (paper, gc) and 64 (wide), with a tap of a whole
# 64-row tile.
WIDTHS = {"small": {}}
WIDTHS.update({f"w{W}": dict(dilations=(1, 64, 2, 33), residual_channels=W,
                             dilation_channels=W) for W in (32, 64)})


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_mma3_stack_forward_matches_jax_kernel(width):
    jcfg, x, jpack, tpack, _ = _setup(True, 0, **WIDTHS[width])
    c = _tcfg(jcfg)
    L, D = c.num_layers, c.dilation_channels
    y_j, fg_j, z_j = jfs.fused_stack3_forward(
        jnp.asarray(x), *jpack, jcfg, jnp.float32, jnp.float32, 64,
        uniform_add=False, interpret=True)
    y, fg, z = tfs.fused_stack_forward_reference(
        torch.from_numpy(x), *tpack, c, matmul=tfs.mma3_matmul)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(z_j)[:, :T, :L * D], **FWD_TOL)
    np.testing.assert_allclose(
        fg.numpy(), np.asarray(fg_j)[:, :T, :L * 2 * D], **FWD_TOL)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_mma3_stack_backward_matches_jax_grad(width):
    jcfg, x, jpack, tpack, rng = _setup(True, 1, **WIDTHS[width])
    c = _tcfg(jcfg)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    cy = rng.randn(B, T, R).astype(np.float32)
    cz = rng.randn(B, T, L * D).astype(np.float32)

    def loss(x, w_fg, wd, add, bd):
        y, z = jfs.fused_stack3(x, w_fg, wd, add, bd, jcfg, jnp.float32,
                                64, 64, False, True)
        return jnp.sum(y * cy) + jnp.sum(z[..., :L * D] * cz)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *jpack)
    mm = tfs.mma3_matmul
    y, fg, _ = tfs.fused_stack_forward_reference(torch.from_numpy(x), *tpack,
                                                 c, matmul=mm)
    w_fg, wd, _, bd = tpack
    got = tfs.fused_stack_backward_reference(
        y, torch.from_numpy(cy), fg, torch.from_numpy(cz), w_fg, wd, bd, c,
        matmul=mm)
    for name, g, w in zip(("dx", "dw_fg", "dwd", "dadd", "dbd"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def _small_args(W=8):
    c = _width(W)
    L = c.num_layers
    rng = np.random.RandomState(2)

    def rn(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * 0.3)

    return c, (rn(2, 70, W), rn(L, 2 * W, 2 * W), rn(L, W, W),
               rn(L, 2, 2 * W), rn(L, 1, W)), (rn(2, 70, W), rn(2, 70, L * W))


def test_kernel_argument_is_checked():
    c, args, (dy, dz) = _small_args()
    y, fg, _ = tfs.fused_stack_forward_reference(*args, c)
    with pytest.raises(ValueError, match="kernel"):
        tfs.forward(*args, c, kernel="tf32")
    with pytest.raises(ValueError, match="kernel"):
        tfs.backward(y, dy, fg, dz, args[1], args[2], args[4], c,
                     kernel="wgmma")
    with pytest.raises(ValueError, match="kernel"):
        tfs.fused_stack3(*args, c, kernel="")


@pytest.mark.parametrize("kernel", ["auto", "mma", "simt"])
@pytest.mark.parametrize("W", [8, 32])
def test_cpu_runs_the_plain_versions_whatever_kernel_says(kernel, W):
    """On CPU tensors every ``kernel=`` (even "mma" at a width it is not
    built for) runs the plain versions and launches nothing."""
    c, args, (dy, dz) = _small_args(W)
    counts = (tfs.forward.launches, tfs.backward.launches,
              dict(tfs.forward.launches_by), dict(tfs.backward.launches_by))
    out = tfs.forward(*args, c, kernel=kernel)
    want = tfs.fused_stack_forward_reference(*args, c)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    y, fg, _ = want
    grads = tfs.backward(y, dy, fg, dz, args[1], args[2], args[4], c,
                         kernel=kernel)
    ref = tfs.fused_stack_backward_reference(y, dy, fg, dz, args[1], args[2],
                                             args[4], c)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    leaves = [a.clone().requires_grad_(True) for a in args]
    yo, zo = tfs.fused_stack3(*leaves, c, kernel=kernel)
    ((yo * dy).sum() + (zo * dz).sum()).backward()
    assert torch.equal(leaves[0].grad, grads[0])
    assert counts == (tfs.forward.launches, tfs.backward.launches,
                      dict(tfs.forward.launches_by),
                      dict(tfs.backward.launches_by))


def test_stack_times_tool_refuses_the_cpu():
    """``python -m wavenet_torch.tools.stack_times`` times each checkout
    in a process of its own on the card; without one it fails rather than
    time anything else."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "wavenet_torch.tools.stack_times", "--trees",
         root, "--reps", "1"], capture_output=True, text=True, cwd=root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "needs a CUDA GPU" in proc.stderr
