"""The r2 probes' plain versions against the JAX package's TPU probe tools.

``wavenet_torch.tools.r2_fwd_bisect`` and ``r2_fwd_bisect2`` (the ports of
``tools/r2_fwd_bisect.py`` and ``tools/r2_fwd_bisect2.py``) are held
against those tools, loaded from their files with their module globals
set to a tiny size and run in interpret mode with zero-initialised
scratch: most variants read scratch they never write, and zeros make
every variant defined (the port's ablated operands are zeros too). The
tools return only sum(y): it must equal the port's within rtol 1e-5 at
float32 and 2e-3 at bf16. The tools run at bf16; their float32 run swaps
``jnp.bfloat16`` for float32 in the tool module. Both kernels' plain
versions are held: the FP32-core ("simt") probes at R = D = 16 and the
tensor-core ("mma") probes at R = D = 32, whose float32 products go
through ``mma3_matmul``. The CUDA kernels are held against these plain
versions on the card (tests/test_torch_gpu.py).
"""

import dataclasses
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch.kernels import fused_stack as tfs
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.tools import r2_fwd_bisect as r2
from wavenet_torch.tools import r2_fwd_bisect2 as r2b

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(dilations=(1, 4, 16, 2), residual_channels=16,
           dilation_channels=16, skip_channels=32, quantization_channels=64)
B, T_TILE = 2, 16
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# The mma probes' width (the paper's), a few hundred steps: two r2 tiles
# of 128 (one dilation equals the tile), one r2b tile.
CFG32 = dict(dilations=(1, 16, 128), residual_channels=32,
             dilation_channels=32, skip_channels=32, quantization_channels=64)
T_TILE32 = 128


def load_tool(name: str, dtype, **globals_):
    """A fresh instance of ``tools/<name>.py`` with ``globals_`` set; at
    float32 its ``jnp.bfloat16`` is float32."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in globals_.items():
        setattr(mod, k, v)
    if dtype == torch.float32:
        mod.jnp = _Float32Jnp("jnp")
    return mod


class _Float32Jnp(types.ModuleType):
    """``jax.numpy`` with float32 in place of bfloat16."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def interpret():
    return pltpu.force_tpu_interpret_mode(
        pltpu.InterpretParams(uninitialized_memory="zero"))


def _weights(seed: int, T: int, cfg=CFG):
    rng = np.random.RandomState(seed)
    L, R, D = len(cfg["dilations"]), cfg["residual_channels"], \
        cfg["dilation_channels"]
    x = (rng.randn(B, T, R) + 0.5).astype(np.float32)
    w_fg = (0.2 * rng.randn(L, 2 * R, 2 * D)).astype(np.float32)
    wd = (0.2 * rng.randn(L, D, R)).astype(np.float32)
    wfat = (0.2 * rng.randn(L, 2 * R + 2 * D, 2 * D + R)).astype(np.float32)
    return x, w_fg, wd, wfat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", r2.VARIANTS)
def test_fwd_bisect_matches_jax_tool(variant, dtype):
    """Every r2 variant over two tiles (the tap carry crosses a tile; one
    dilation equals the tile)."""
    x, w_fg, wd, _ = _weights(0, 2 * T_TILE)
    tool = load_tool("r2_fwd_bisect", dtype, B=B, T_TILE=T_TILE)
    with interpret():
        want = float(tool.build(JConfig(**CFG), variant)(
            jnp.asarray(x), jnp.asarray(w_fg), jnp.asarray(wd)))
    c = TConfig(**CFG)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    zeros = (torch.zeros((L, B, 2 * D)), torch.zeros((L, 1, R)))
    before = r2.fwd_bisect.launches
    y, fg, z = r2.fwd_bisect(torch.from_numpy(x), torch.from_numpy(w_fg),
                             torch.from_numpy(wd), *zeros, c, variant, dtype,
                             kernel="simt")
    assert r2.fwd_bisect.launches == before     # the CPU runs the plain one
    np.testing.assert_allclose(y.double().sum().item(), want,
                               rtol=RTOL[dtype])
    assert (fg is None) == (z is None) == (not r2.writes_records(variant))
    if fg is not None:
        assert fg.dtype == z.dtype == dtype
        assert fg.shape == (B, 2 * T_TILE, L * 2 * D)


def test_fwd_bisect_full_f32_is_kernel5_forward():
    """At float32 ``full`` is kernel 5's forward: its plain version equals
    ``kernels.fused_stack``'s bitwise, with biases; ``rolled`` computes
    the same values."""
    x, w_fg, wd, _ = _weights(1, 40)
    rng = np.random.RandomState(2)
    c = TConfig(**CFG)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    t = [torch.from_numpy(a) for a in (
        x, w_fg, wd, (0.1 * rng.randn(L, B, 2 * D)).astype(np.float32),
        (0.1 * rng.randn(L, 1, R)).astype(np.float32))]
    ref = tfs.fused_stack_forward_reference(*t, c)
    for variant in ("full", "rolled"):
        got = r2.fwd_bisect(*t, c, variant, kernel="simt")
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", sorted(r2b.TILES))
@pytest.mark.parametrize("variant", r2b.VARIANTS)
def test_fwd_bisect2_matches_jax_tool(variant, tile, dtype):
    """Every r2b variant at both TPU tiles (16 and 32 rows here, one tile:
    the TPU tool's fat tile carries the previous tile's z into the next,
    which the port's tile-independent launch does not)."""
    x, w_fg, wd, wfat = _weights(3, T_TILE)
    tool = load_tool("r2_fwd_bisect2", dtype, B=B,
                     T_TILE=T_TILE * tile // 1024)
    with interpret():
        want = float(tool.build(JConfig(**CFG), variant)(
            *(jnp.asarray(a) for a in (x, w_fg, wd, wfat))))
    before = r2b.fwd_bisect2.launches
    y = r2b.fwd_bisect2(*(torch.from_numpy(a) for a in (x, w_fg, wd, wfat)),
                        variant, tile, dtype, kernel="simt")
    assert r2b.fwd_bisect2.launches == before
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.double().sum().item(), want,
                               rtol=RTOL[dtype])


def test_probe_arguments_are_checked():
    c = TConfig(**CFG)
    x = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="variant"):
        r2.fwd_bisect(x, None, None, None, None, c, "nope")
    with pytest.raises(ValueError, match="dtype"):
        r2.fwd_bisect(x, None, None, None, None, c, "full", torch.float16)
    with pytest.raises(ValueError, match="tile"):
        r2b.fwd_bisect2(x, None, None, None, "fat", 512)
    with pytest.raises(ValueError, match="unsupported device"):
        r2b.fwd_bisect2(x.to("meta"), None, None, None, "fat", kernel="simt")


# ---------------------------------------------------------------------------
# The tensor-core ("mma") probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", r2.VARIANTS)
def test_fwd_bisect_mma_matches_jax_tool(variant, dtype):
    """Every r2 variant of the mma kernel's plain version at R = D = 32
    over two tiles of 128 steps (the tap carry crosses a tile; one
    dilation equals the tile)."""
    x, w_fg, wd, _ = _weights(5, 2 * T_TILE32, CFG32)
    tool = load_tool("r2_fwd_bisect", dtype, B=B, T_TILE=T_TILE32)
    with interpret():
        want = float(tool.build(JConfig(**CFG32), variant)(
            jnp.asarray(x), jnp.asarray(w_fg), jnp.asarray(wd)))
    c = TConfig(**CFG32)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    zeros = (torch.zeros((L, B, 2 * D)), torch.zeros((L, 1, R)))
    before = r2.fwd_bisect.launches
    y, fg, z = r2.fwd_bisect(torch.from_numpy(x), torch.from_numpy(w_fg),
                             torch.from_numpy(wd), *zeros, c, variant, dtype,
                             kernel="mma")
    assert r2.fwd_bisect.launches == before     # the CPU runs the plain one
    np.testing.assert_allclose(y.double().sum().item(), want,
                               rtol=RTOL[dtype])
    assert (fg is None) == (z is None) == (not r2.writes_records(variant))
    if fg is not None:
        assert fg.dtype == z.dtype == dtype
        assert fg.shape == (B, 2 * T_TILE32, L * 2 * D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fwd_bisect_mma_full_is_stack_mma_forward(dtype):
    """On mma, ``full`` and ``rolled`` emit the plain version of
    ``fused_stack_mma``'s forward in the mode of ``dtype`` bitwise, with
    biases: at float32 ``fused_stack_forward_reference`` through
    ``mma3_matmul``, at bf16 that of a bfloat16 config."""
    x, w_fg, wd, _ = _weights(6, 200, CFG32)
    rng = np.random.RandomState(7)
    c = TConfig(**CFG32)
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    t = [torch.from_numpy(a) for a in (
        x, w_fg, wd, (0.1 * rng.randn(L, B, 2 * D)).astype(np.float32),
        (0.1 * rng.randn(L, 1, R)).astype(np.float32))]
    if dtype == torch.float32:
        ref = tfs.fused_stack_forward_reference(*t, c,
                                                matmul=tfs.mma3_matmul)
    else:
        ref = tfs.fused_stack_forward_reference(
            *t, dataclasses.replace(c, compute_dtype="bfloat16"))
    for variant in ("full", "rolled"):
        got = r2.fwd_bisect(*t, c, variant, dtype, kernel="mma")
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b), variant


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", sorted(r2b.TILES))
@pytest.mark.parametrize("variant", r2b.VARIANTS)
def test_fwd_bisect2_mma_matches_jax_tool(variant, tile, dtype):
    """Every r2b variant of the mma kernel's plain version at both TPU
    tiles, R = D = 32, 256 steps (one tile, as above)."""
    T = 2 * T_TILE32
    x, w_fg, wd, wfat = _weights(8, T, CFG32)
    tool = load_tool("r2_fwd_bisect2", dtype, B=B, T_TILE=T * tile // 1024)
    with interpret():
        want = float(tool.build(JConfig(**CFG32), variant)(
            *(jnp.asarray(a) for a in (x, w_fg, wd, wfat))))
    before = r2b.fwd_bisect2.launches
    y = r2b.fwd_bisect2(*(torch.from_numpy(a) for a in (x, w_fg, wd, wfat)),
                        variant, tile, dtype, kernel="mma")
    assert r2b.fwd_bisect2.launches == before
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.double().sum().item(), want,
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("W", [16, 32, 64])
def test_fwd_bisect_auto_follows_the_stack_route(W):
    """"auto" runs the kernel that ``stack_kernel_plan`` routes the config
    to (simt at 16, mma at 32 and 64): its plain version, bitwise."""
    cfg = dict(CFG32, residual_channels=W, dilation_channels=W)
    c = TConfig(**cfg)
    x, w_fg, wd, _ = _weights(9, 40, cfg)
    L = c.num_layers
    t = [torch.from_numpy(a) for a in (x, w_fg, wd)] + [
        torch.zeros((L, B, 2 * W)), torch.zeros((L, 1, W))]
    plan = tfs.stack_kernel_plan(c)
    assert r2.probe_kernel(c) == plan == ("simt" if W == 16 else "mma")
    got = r2.fwd_bisect(*t, c, "full")
    want = r2.fwd_bisect_reference(*t, c, "full", kernel=plan)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_probe_kernel_argument_is_checked():
    """An unknown kernel, and a pinned kernel at a width it lacks (mma at
    16, simt at 64; r2b's mma at 16), raise on the CPU too."""
    c16, c64 = (TConfig(**dict(CFG32, residual_channels=W,
                               dilation_channels=W)) for W in (16, 64))
    x = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="kernel"):
        r2.fwd_bisect(x, None, None, None, None, c16, "full", kernel="tc")
    with pytest.raises(ValueError, match="kernel"):
        r2b.fwd_bisect2(x, None, None, None, "fat", kernel="auto")
    with pytest.raises(NotImplementedError, match=r"\(32, 64\)"):
        r2.fwd_bisect(x, None, None, None, None, c16, "full", kernel="mma")
    with pytest.raises(NotImplementedError, match=r"\(16, 32\)"):
        r2.fwd_bisect(x, None, None, None, None, c64, "full", kernel="simt")
    with pytest.raises(NotImplementedError, match="R == D == 32"):
        r2b.fwd_bisect2(x, None, torch.zeros((2, 16, 16)), None, "fat",
                        kernel="mma")
