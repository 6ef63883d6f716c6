"""bf16 training (``compute_dtype="bfloat16"``) of the port against the JAX
package.

The plain route of the port's model (``forward``, ``forward_codes``,
``loss_fn`` and its gradients) is held against the JAX package's bf16 XLA
route on the same numpy-seeded params and inputs, with and without global
conditioning; then the train CLI at ``--compute_dtype bfloat16`` (plain and
``--use_pallas_stack``), a short bf16-against-float32 loss curve (a
non-slow mirror of ``tests/test_bf16_drift.py``), the bytes the stack's
bound counts, the bf16 paths that still raise, the retired stacks (v1,
v2), which now run, and generation from a bf16 config, which runs at
float32 as in the JAX package.

Tolerance. Both packages round to bf16 at the same points (the weights,
biases, GC embedding and input; every product's output; the gate's
sigmoid as ``1 / (1 + exp(-x))`` op by op; the residual), so the port's bf16 is
held to a quarter of JAX's own bf16-against-float32 gap: max|port16 -
jax16| <= 0.25 * max|jax16 - jax32|. Measured on these inputs (no gc /
gc): logits equal (0.0 against gaps of 8.2e-3 / 1.1e-2 for
``forward_codes``, 6.5e-3 / 1.1e-2 for ``forward``); the loss 4.8e-7 /
4.8e-7 against 9.3e-5 / 2.2e-4; weight gradients at most 0.16 / 0.14 of
the gap (dense / gc_gate), 0.0 on the head's weights. The bias
gradients are the exception: each is a bf16 sum over B x T positions,
which XLA's CPU backend forms as a tree of windows with a bf16 rounding
after every add, while PyTorch adds in float32 and rounds once, so there
the two bf16 results can lie as far apart as bf16 from float32
(postprocess2_bias: 0.93 / 1.14 of the gap, the rest <= 0.38). They are
held to 1.5x the gap, and the port's to within 1.5x of that gap from
JAX's float32 (measured: at most 1.26, dense_bias; postprocess2_bias
0.16 / 0.14, closer to float32 than JAX's bf16 is).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import train_lib as tl
from wavenet_torch.kernels import fused_stack as fs
from wavenet_torch.kernels import sampler as ks
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy
from wavenet_torch.utils import flops as tflops

from test_torch_train import _corpus

torch.set_num_threads(1)

BASE = dict(dilations=(1, 2, 4, 8, 1, 2, 4, 8), residual_channels=16,
            dilation_channels=16, skip_channels=32, quantization_channels=64,
            use_biases=True)
GC = dict(gc_channels=4, gc_cardinality=3)
B, T = 2, 100
GAP_FRACTION = 0.25       # of JAX's own bf16-vs-float32 gap
BIAS_GAP_FRACTION = 1.5   # bf16 sums over positions (see the docstring)


def _cfgs(gc: bool, dtype: str, **kw):
    d = dict(BASE, compute_dtype=dtype, **(GC if gc else {}), **kw)
    return JConfig(**d), TConfig(**d)


def _run(gc: bool, dtype: str, jp, codes, ids, audio):
    """(forward_codes logits, forward logits, loss, grads) in both
    packages at ``dtype``."""
    jc, tc = _cfgs(gc, dtype)
    jpp = {k: jnp.asarray(v) for k, v in jp.items()}
    tp = params_from_numpy(jp, "cpu")
    jids = None if ids is None else jnp.asarray(ids)
    tids = None if ids is None else torch.as_tensor(ids)
    jg = None if ids is None else jw.embed_gc(jpp, jc, jids)
    tg = None if ids is None else tw.embed_gc(tp, tc, tids)
    Q = jc.quantization_channels
    onehot = np.eye(Q, dtype=np.float32)[codes]
    j = (np.asarray(jw.forward_codes(jpp, jc, jnp.asarray(codes), jg)),
         np.asarray(jw.forward(jpp, jc, jnp.asarray(onehot), jg)))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jw.loss_fn(p, jc, jnp.asarray(audio), jids),
        has_aux=True)(jpp)
    with torch.no_grad():
        t = (tw.forward_codes(tp, tc, torch.as_tensor(codes), tg),
             tw.forward(tp, tc, torch.from_numpy(onehot), tg))
    assert all(v.dtype == torch.float32 for v in t)   # float32 logits
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tloss, _ = tw.loss_fn(leaves, tc, torch.from_numpy(audio), tids)
    tloss.backward()
    assert all(v.grad.dtype == torch.float32 for v in leaves.values())
    return dict(
        jax=(j[0], j[1], float(jloss),
             {k: np.asarray(v) for k, v in jgrads.items()}),
        port=(t[0].numpy(), t[1].numpy(), float(tloss.detach()),
              {k: v.grad.numpy() for k, v in leaves.items()}))


@pytest.fixture(scope="module", params=[False, True], ids=["nogc", "gc"])
def runs(request):
    gc = request.param
    jc, _ = _cfgs(gc, "float32")
    jp = {k: np.asarray(v)
          for k, v in jw.init_params(jax.random.PRNGKey(0), jc).items()}
    rng = np.random.RandomState(0)
    for k in sorted(jp):            # init_params zeroes every bias
        if k.endswith("_bias"):
            jp[k] = (0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    codes = rng.randint(0, jc.quantization_channels, (B, T))
    ids = np.array([0, 2]) if gc else None
    n = T + jc.receptive_field
    audio = (0.5 * np.sin(np.arange(n)[None] * np.array([[0.05], [0.11]]))
             + 0.05 * rng.randn(B, n)).astype(np.float32)
    return {dt: _run(gc, dt, jp, codes, ids, audio)
            for dt in ("float32", "bfloat16")}


def _hold(got, j16, j32, fraction, what):
    gap = np.abs(j16 - j32).max()
    err = np.abs(got - j16).max()
    assert err <= fraction * gap, f"{what}: {err} against a gap of {gap}"


@pytest.mark.parametrize("which", [0, 1], ids=["forward_codes", "forward"])
def test_logits_match_jax_bf16(runs, which):
    j16, j32 = runs["bfloat16"]["jax"][which], runs["float32"]["jax"][which]
    assert np.abs(j16 - j32).max() > 1e-3     # bf16 is in play
    _hold(runs["bfloat16"]["port"][which], j16, j32, GAP_FRACTION, "logits")


def test_loss_matches_jax_bf16(runs):
    j16, j32 = runs["bfloat16"]["jax"][2], runs["float32"]["jax"][2]
    _hold(np.float32(runs["bfloat16"]["port"][2]), np.float32(j16),
          np.float32(j32), GAP_FRACTION, "loss")


def test_weight_gradients_match_jax_bf16(runs):
    g16, g32 = runs["bfloat16"]["jax"][3], runs["float32"]["jax"][3]
    port = runs["bfloat16"]["port"][3]
    for k in sorted(g32):
        if not k.endswith("_bias"):
            _hold(port[k], g16[k], g32[k], GAP_FRACTION, k)


def test_bias_gradients_match_jax_bf16(runs):
    g16, g32 = runs["bfloat16"]["jax"][3], runs["float32"]["jax"][3]
    port = runs["bfloat16"]["port"][3]
    for k in sorted(g32):
        if k.endswith("_bias"):
            _hold(port[k], g16[k], g32[k], BIAS_GAP_FRACTION, k)
            gap = np.abs(g16[k] - g32[k]).max()
            assert np.abs(port[k] - g32[k]).max() <= BIAS_GAP_FRACTION * gap


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "stack"])
def test_train_cli_bf16(tmp_path, capsys, pallas):
    """Two bf16 steps through the train CLI; the checkpoint's params and
    Adam moments are float32."""
    from wavenet_torch.cli import train as cli

    pfile = tmp_path / "params.json"
    pfile.write_text(json.dumps(
        {"filter_width": 2, "sample_rate": 2000, "dilations": [1, 2, 4, 8],
         "residual_channels": 8, "dilation_channels": 8, "skip_channels": 16,
         "quantization_channels": 32, "use_biases": True}))
    logdir = tmp_path / "logdir"
    argv = ["--data_dir", _corpus(tmp_path), "--wavenet_params", str(pfile),
            "--logdir", str(logdir), "--batch_size", "2", "--sample_size",
            "100", "--num_steps", "2", "--checkpoint_every", "2",
            "--gc_channels", "4", "--device", "cpu", "--seed", "1",
            "--silence_threshold", "0.02", "--steps_per_dispatch", "2",
            "--compute_dtype", "bfloat16"] + (
                ["--use_pallas_stack"] if pallas else [])
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    losses = [float(ln.split("loss = ")[1].split(",")[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    ckpt = logdir / "ckpt-2"
    with np.load(ckpt / "params.npz") as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}
    opt = torch.load(ckpt / "optimizer.pt", weights_only=True)
    moments = [v for s in opt["state"].values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(v.dtype == torch.float32 for v in moments)


def test_bf16_loss_curve_tracks_fp32():
    """A short non-slow mirror of ``tests/test_bf16_drift.py``: the same
    init, data and Adam at both dtypes; the bf16 curve stays within the
    drift test's band of the float32 one (measured: first losses 4.0e-5
    apart, the smoothed curves at most 2.0e-3 apart, both falling from
    4.854 to ~3.95 in 30 steps)."""
    kw = dict(dilations=(1, 2, 4, 8, 16, 32, 64, 128), residual_channels=16,
              dilation_channels=16, skip_channels=32,
              quantization_channels=128, use_biases=True)
    t = np.arange(1000) / 2000.0
    mixed = sum(0.3 * np.sin(2 * np.pi * f * t)
                for f in (155.56, 196.00, 233.08))
    audio = torch.from_numpy(np.tile(mixed.astype(np.float32), (3, 1)))
    curves = {}
    for dt in ("float32", "bfloat16"):
        c = TConfig(**kw, compute_dtype=dt)
        state = tl.create_train_state(0, c, tl.make_optimizer("adam", 2e-3),
                                      "cpu")
        step = tl.make_train_step(c)
        losses = []
        for _ in range(30):
            state, m = step(state, audio)
            losses.append(float(m["loss"]))
        assert all(v.dtype == torch.float32 for v in state.params.values())
        curves[dt] = np.asarray(losses)
    c32, c16 = curves["float32"], curves["bfloat16"]
    assert abs(c16[0] - c32[0]) < 0.05
    assert c32[-1] < c32[0] - 0.5 and c16[-1] < c16[0] - 0.5

    def smooth(x, k=5):
        return np.convolve(x, np.ones(k) / k, mode="valid")

    assert np.abs(smooth(c16) - smooth(c32)).max() < 0.35


def test_matmul_precision_turns_off_reduced_bf16_reductions():
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction
    try:
        m.allow_bf16_reduced_precision_reduction = True
        _, c16 = _cfgs(False, "bfloat16")
        with tw.matmul_precision(c16):
            assert m.allow_bf16_reduced_precision_reduction is False
        assert m.allow_bf16_reduced_precision_reduction is True
        with tw.matmul_precision(_cfgs(False, "float32")[1]):
            assert m.allow_bf16_reduced_precision_reduction is True
    finally:
        m.allow_bf16_reduced_precision_reduction = saved


def test_stack_cost_counts_bf16_records_at_two_bytes():
    _, c32 = _cfgs(False, "float32")
    _, c16 = _cfgs(False, "bfloat16")
    L, D = c32.num_layers, c32.dilation_channels
    rows = 8 * 1000
    for backward, recs in ((False, 3 * L * D), (True, 3 * L * D)):
        f32 = tflops.fused_stack_cost(c32, 8, 1000, backward)
        b16 = tflops.fused_stack_cost(c16, 8, 1000, backward)
        assert b16[0] == f32[0]
        assert f32[1] - b16[1] == 2.0 * rows * recs
    assert tflops.H100_BF16_FLOPS == 989e12


@pytest.mark.parametrize("W,want", [(32, "mma"), (16, "simt"), (64, "mma"),
                                    (128, "tiled"), (8, "simt"),
                                    ((256, 128), "tiled"), (96, None)])
def test_stack_kernel_plan_bf16(W, want):
    R, D = W if isinstance(W, tuple) else (W, W)
    c = TConfig(dilations=(1, 2), residual_channels=R, dilation_channels=D,
                skip_channels=16, quantization_channels=32,
                compute_dtype="bfloat16")
    if want is None:
        with pytest.raises(NotImplementedError, match="TPU kernel's widths"):
            fs.stack_kernel_plan(c)
    else:
        assert fs.stack_kernel_plan(c) == want
        assert fs.launch_key(want, c) == f"{want}_bf16"
        assert fs.record_dtype(c) == torch.bfloat16


def _bf16_paths():
    from wavenet_torch import sample
    from wavenet_torch.experiments import dilated_layer as dl
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.experiments import fused_stack2 as fs2

    _, c = _cfgs(False, "bfloat16")
    c32 = dataclasses.replace(c, compute_dtype="float32")
    p = tw.init_params(0, c, device="cpu")
    stack = fs.pack_stack_weights(p, c, None, 1)
    x = torch.zeros(1, 8, c.residual_channels)
    codes = torch.zeros(1, 8, dtype=torch.int32)
    # Generation runs at float32 whatever the config's compute_dtype, as in
    # the JAX package: each entry, at the bf16 and the float32 config.
    prefill = [lambda cfg=cfg: ks.prefill_carry(p, cfg, codes).ring
               for cfg in (c, c32)]
    generate = [lambda cfg=cfg: ks.generate_cuda(p, cfg, 4, 0)
                for cfg in (c, c32)]
    scan = [lambda cfg=cfg: sample.generate(
        p, cfg, 4, torch.Generator().manual_seed(0)) for cfg in (c, c32)]
    R, D = c.residual_channels, c.dilation_channels
    w_fg, wd, add, bd = stack
    layer = (x, w_fg[0].view(2, R, 2 * D), wd[0], add[0], bd[0], 1)
    return {
        # fused_stack.cu's bf16 mode (ROADMAP a3 step 3) and the layer op
        # at bf16 (a3 step 2) run: on the CPU the plain bf16 versions, a
        # float32 y and the bf16 z record, or the layer's float32 z.
        "simt_pinned": (lambda: fs.fused_stack3(x, *stack, c, kernel="simt"),
                        torch.bfloat16),
        # The retired stacks run at bf16 (ROADMAP a3 step 1), each with its
        # z: v1's float32 from the bf16 fg record, v2's the bf16 record.
        "stack_v1": (lambda: fs1.fused_stack(x, *stack, c), torch.float32),
        "stack_v2": (lambda: fs2.fused_stack2(x, *stack, c),
                     torch.bfloat16),
        "dilated_layer": (lambda: dl.fused_dilated_layer(
            *layer, compute_dtype=torch.bfloat16), torch.float32),
        "prefill": (prefill, None),
        "generate_cuda": (generate, None),
        "scan_sampler": (scan, None),
    }


@pytest.mark.parametrize("path", ["simt_pinned", "stack_v1", "stack_v2",
                                  "dilated_layer", "prefill",
                                  "generate_cuda", "scan_sampler"])
def test_bf16_paths_without_a_port_raise(path):
    """Each bf16 path the port lacks raises, naming its ROADMAP item; none
    falls back to float32. Generation (prefill, ``generate_cuda``, the
    scan sampler) is no such path: as in the JAX package it runs at
    float32 whatever ``compute_dtype`` says, so a bf16 config's result is
    the float32 config's, bitwise. The retired stacks v1 and v2, the simt
    stack kernel pinned and the one-layer op were such paths and now run
    on the CPU (the plain versions): a float32 y and each path's z
    (``tests/test_torch_stack_retired_bf16.py``,
    ``tests/test_torch_stack_bf16.py`` and
    ``tests/test_torch_dilated_layer_bf16.py`` hold them against JAX)."""
    fn, item = _bf16_paths()[path]
    if isinstance(item, torch.dtype):
        y, z = fn()
        assert y.dtype == torch.float32 and z.dtype == item
        assert torch.isfinite(y).all() and torch.isfinite(z.float()).all()
        return
    if item is None:
        got, ref = (f() for f in fn)
        assert got.dtype == ref.dtype and torch.equal(got, ref)
        return
    with pytest.raises(NotImplementedError, match=item):
        fn()
