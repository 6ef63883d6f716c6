"""The fused stack at the tiled kernel's widths R = D = 128 and 256
against the JAX package's TPU kernel pair (its ragged widths:
``test_torch_stack_ragged.py``, ``test_torch_stack_tiny.py``).

``stack_kernel_plan`` sends R == D a multiple of 128 (and R != D, and
R == D in 1, 2, 4) to ``csrc/fused_stack_tiled.cu`` on the card; on the CPU the same calls run
the plain versions (``fused_stack_forward_reference`` /
``fused_stack_backward_reference``), which are the kernel's plain version
there. Here they are held against ``wavenet_tpu.kernels.fused_stack3``
run in interpret mode, at 3 layers (dilations 1, 2, 4), B2 x T150, 64-row
tiles, gc on (R = D = 128) and off (256), with inputs made by numpy from a
seed: f32 at the fused-stack tests' tolerances, bf16 on the scale of
JAX's own bf16-to-float32 gap.

At these widths a product sums 256 or 512 terms, and the other float32
order flips a bf16 rounding in a small share of the records, which the
next layer carries on: so bf16 is held by ``test_torch_stack_bf16.py``'s
wide rule, its ``_hold`` (the mean error within a half of the mean gap,
the worst within 1.5 of the worst gap) and ``_hold_layers`` (each layer
on JAX's own input to it: records within 2**-5 of the layer's max |ref|
at the worst point and 1e-4 on average). A tenth of the gap, the small config's rule there, does not
hold: measured, the worst error is 0.25-0.87 of the worst gap (z the
highest, a flipped record) and the mean 0.004-0.17 of the mean gap. An
indexing or rounding fault lies O(1) of the values away.

Each JAX call is cached, so that the f32 and bf16 cases of one width run
the kernel once per dtype and direction (~10 JAX calls in all).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wavenet_tpu.kernels import fused_stack3 as jfs
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_tpu.models.wavenet import embed_gc as jembed_gc
from wavenet_tpu.models.wavenet import init_params as jinit_params
from wavenet_torch.kernels import fused_stack as tfs
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_fused_stack import small_cfg
from test_torch_stack_bf16 import _hold, _hold_layers

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
B, T = 2, 150   # several 64-row tiles of the JAX kernel, the last ragged
DILATIONS = (1, 2, 4)
LAYER_MAX_RTOL = 2.0 ** -5
NAMES = ("dx", "dw_fg", "dwd", "dadd", "dbd")
# (width, gc): gc at 128, one add for all rows at 256.
CASES = pytest.mark.parametrize("W,gc", [(128, True), (256, False)],
                                ids=["w128_gc", "w256"])
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


@functools.lru_cache(maxsize=None)
def _setup(W: int, gc: bool):
    jcfg = small_cfg(dilations=DILATIONS, residual_channels=W,
                     dilation_channels=W, gc_channels=4 if gc else None,
                     gc_cardinality=4 if gc else None)
    jp = {k: np.asarray(v)
          for k, v in jinit_params(jax.random.PRNGKey(W), jcfg).items()}
    rng = np.random.RandomState(W)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, W) * 0.5).astype(np.float32)
    cy = rng.randn(B, T, W).astype(np.float32)
    cz = rng.randn(B, T, len(DILATIONS) * W).astype(np.float32)
    ids = np.array([0, 3]) if gc else None
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    jgc = None if ids is None else jembed_gc(jparams, jcfg, jnp.asarray(ids))
    jpack = jfs.pack_stack_weights(jparams, jcfg, jgc, B)
    tp = params_from_numpy(jp, "cpu")
    tgc = None if ids is None else tp["gc_embedding"][torch.as_tensor(ids)]
    c = TConfig(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TConfig)})
    tpack = tfs.pack_stack_weights(tp, c, tgc, B)
    return jcfg, c, x, cy, cz, jpack, tpack


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_forward(W: int, gc: bool, dtype: str):
    jcfg, c, x, _, _, jpack, _ = _setup(W, gc)
    dt = _JDT[dtype]
    y, fg, z = jfs.fused_stack3_forward(
        jnp.asarray(x), *jpack, jcfg, dt, dt, 64, uniform_add=not gc,
        interpret=True)
    return (np.asarray(y), np.asarray(fg.astype(jnp.float32)),
            np.asarray(z.astype(jnp.float32)))


@functools.lru_cache(maxsize=None)
def _jax_grads(W: int, gc: bool, dtype: str):
    jcfg, c, x, cy, cz, jpack, _ = _setup(W, gc)
    L, dt = c.num_layers, _JDT[dtype]

    def loss(x, w_fg, wd, add, bd):
        y, z = jfs.fused_stack3(x, w_fg, wd, add, bd, jcfg, dt, 64, 64,
                                not gc, True)
        return (jnp.sum(y * cy)
                + jnp.sum(z[..., :L * W].astype(jnp.float32) * cz))

    return [np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *jpack)]


def _cfg(c, dtype):
    return dataclasses.replace(c, compute_dtype=dtype)


@CASES
@DTYPES
def test_forward_matches_jax_kernel(W, gc, dtype):
    _, c32, x, _, _, _, tpack = _setup(W, gc)
    c = _cfg(c32, dtype)
    L, D = c.num_layers, c.dilation_channels
    assert tfs.stack_kernel_plan(c) == "tiled"
    want = _jax_forward(W, gc, dtype)
    # At D >= 128 a record is one layer: no lanes of padding, so the
    # port's fg[..., 2D l:2D (l + 1)] is JAX's record l.
    assert want[1].shape[-1] == L * 2 * D and want[2].shape[-1] == L * D
    before = tfs.forward.launches
    y, fg, z = tfs.forward(torch.from_numpy(x), *tpack, c)
    assert tfs.forward.launches == before      # the CPU runs the plain one
    assert fg.dtype == z.dtype == tfs.record_dtype(c)
    assert fg.shape == (B, T, L * 2 * D) and z.shape == (B, T, L * D)
    got = [t.float().numpy() for t in (y, fg, z)]
    for l in range(L):
        np.testing.assert_allclose(
            got[1][..., 2 * D * l:2 * D * (l + 1)],
            want[1][:, :T, 2 * D * l:2 * D * (l + 1)],
            **(FWD_TOL if dtype == "float32" else dict(
                rtol=LAYER_MAX_RTOL, atol=LAYER_MAX_RTOL
                * np.abs(want[1]).max())), err_msg=f"fg record {l}")
    if dtype == "float32":
        for name, g, w in zip(("y", "fg", "z"), got, want):
            np.testing.assert_allclose(g, w[:, :T], **FWD_TOL, err_msg=name)
        return
    want32 = _jax_forward(W, gc, "float32")
    for name, g, w16, w32 in zip(("y", "fg", "z"), got, want, want32):
        _hold("wide", name, g, w16[:, :T], w32[:, :T])
    _hold_layers(c, x, tpack, *(w[:, :T] for w in want))


@CASES
@DTYPES
def test_backward_matches_jax_grad(W, gc, dtype):
    _, c32, x, cy, cz, _, tpack = _setup(W, gc)
    c = _cfg(c32, dtype)
    want = _jax_grads(W, gc, dtype)
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in tpack]
    before = tfs.backward.launches
    y, z = tfs.fused_stack3(*leaves, c)
    assert z.dtype == tfs.record_dtype(c)
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(z.float() * torch.from_numpy(cz))).backward()
    assert tfs.backward.launches == before
    want32 = _jax_grads(W, gc, "float32") if dtype == "bfloat16" else None
    for i, (name, leaf) in enumerate(zip(NAMES, leaves)):
        got = leaf.grad.numpy()
        assert leaf.grad.dtype == torch.float32, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want[i], **GRAD_TOL,
                                       err_msg=name)
        else:
            _hold("wide", name, got, want[i], want32[i])


@pytest.mark.parametrize("R,D,want", [
    (128, 128, "tiled"), (256, 256, "tiled"), (384, 384, "tiled"),
    (128, 64, "tiled"), (256, 128, "tiled"), (64, 128, "tiled"),
    (16, 8, "tiled"), (6, 16, "tiled"), (1, 1, "tiled"), (2, 2, "tiled"),
    (4, 4, "tiled"), (8, 8, "simt"), (32, 32, "mma"), (64, 48, None)])
@DTYPES
def test_stack_kernel_plan_routes_tiled(R, D, want, dtype):
    """Every width the TPU kernel takes routes to a kernel: R != D and
    R == D in 1, 2, 4 to the tiled one; a D its records cannot pack
    raises."""
    c = TConfig(dilations=(1, 2), residual_channels=R, dilation_channels=D,
                skip_channels=16, quantization_channels=32,
                compute_dtype=dtype)
    assert tfs.supports(c) is (want is not None)
    if want is None:
        with pytest.raises(NotImplementedError, match="TPU kernel's widths"):
            tfs.stack_kernel_plan(c)
        return
    assert tfs.stack_kernel_plan(c) == want
    assert tfs.launch_key(want, c) == (
        f"{want}_bf16" if dtype == "bfloat16" else want)


# The sharded config's shape (mu-law, R = D = 256, S = 512) cut to 3
# layers and R = D = S = 128: the width the route sends to the tiled
# kernel, through loss_fn with use_pallas_stack.
W128 = dict(dilations=DILATIONS, residual_channels=128,
            dilation_channels=128, skip_channels=128,
            quantization_channels=64, use_biases=True, gc_channels=4,
            gc_cardinality=4)


def test_loss_and_grads_match_jax_at_128():
    jcfg = JConfig(**W128, use_pallas_stack=True)
    tcfg = TConfig(**W128, use_pallas_stack=True)
    assert tfs.stack_kernel_plan(tcfg) == "tiled"
    w = {k: np.asarray(v) for k, v in
         jw.init_params(jax.random.PRNGKey(5), jcfg).items()}
    rng = np.random.RandomState(5)
    for k in sorted(w):
        if k.endswith("_bias"):
            w[k] = (0.1 * rng.randn(*w[k].shape)).astype(np.float32)
    audio = rng.uniform(-1, 1, (2, jcfg.receptive_field + 60)).astype(
        np.float32)
    ids = np.array([0, 3])
    grad_fn = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True),
                      static_argnums=(1, 4))
    with pltpu.force_tpu_interpret_mode():
        (l_j, _), g_j = grad_fn({k: jnp.asarray(v) for k, v in w.items()},
                                jcfg, jnp.asarray(audio), jnp.asarray(ids),
                                0.01)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(w, "cpu").items()}
    l_t, _ = tw.loss_fn(tp, tcfg, torch.from_numpy(audio),
                        torch.from_numpy(ids), 0.01)
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    assert set(g_j) == set(tp)
    for k in g_j:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_j[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


def test_train_cli_at_128_with_the_stack(tmp_path, capsys):
    """Two steps of the train CLI at a 3-layer R = D = 128 config with
    --use_pallas_stack on the CPU (the plain versions of the route the card
    runs on the tiled kernel)."""
    from scipy.io import wavfile
    from wavenet_torch.cli import train as cli
    data = tmp_path / "corpus"
    data.mkdir()
    sr = 2000
    t = np.arange(int(sr * 1.5)) / sr
    for spk, freq in [(1, 155.56), (2, 196.0)]:
        wavfile.write(str(data / f"p{spk}_000.wav"), sr,
                      (0.6 * np.sin(2 * np.pi * freq * t) * 32767).astype(
                          np.int16))
    pfile = tmp_path / "w128_params.json"
    pfile.write_text(json.dumps(
        {"filter_width": 2, "sample_rate": sr, "dilations": list(DILATIONS),
         "residual_channels": 128, "dilation_channels": 128,
         "skip_channels": 128, "quantization_channels": 64,
         "use_biases": True}))
    logdir = str(tmp_path / "logdir")
    assert cli.main(["--data_dir", str(data), "--wavenet_params", str(pfile),
                     "--logdir", logdir, "--batch_size", "2",
                     "--sample_size", "100", "--num_steps", "2",
                     "--checkpoint_every", "2", "--use_pallas_stack",
                     "--device", "cpu", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    losses = [float(ln.split("loss = ")[1].split(",")[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "ckpt-2" in os.listdir(logdir)
