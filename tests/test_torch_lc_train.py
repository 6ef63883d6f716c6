"""Training with local conditioning in the port against the JAX package
(CPU).

Mirrors tests/test_lc_device.py (the frame chunks and their upsampling in
the step, the reader's device mode against its host mode, the step on
chunks against the step on the stream) and the training cases of
tests/test_lc.py (loss and gradients with LC, the reader's lockstep with
the audio through trim, pad and chunking, the refiner's gradients), then
the train CLI's ``--lc_*`` flags.

Tolerances: ``upsample_chunk`` equals the host chain bit for bit in
``repeat`` mode and within test_lc_device.py's atol 1e-5 in ``linear``
(and equals ``upsample_chunk_jax`` bit for bit); the float32 loss within
rtol 1e-5 and the gradients within rtol 2e-4 / atol 1e-5 of JAX's
(tests/test_torch_train.py's); at bf16, test_torch_bf16.py's share of JAX's
own bf16-against-float32 gap.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavenet_tpu import lc as jlc
from wavenet_tpu.data.reader import AudioReader as JReader
from wavenet_tpu.models import wavenet as jw
from wavenet_tpu.models.config import WaveNetConfig as JConfig
from wavenet_torch import lc as tlc
from wavenet_torch import train_lib as tl
from wavenet_torch.data.reader import AudioReader
from wavenet_torch.models import wavenet as tw
from wavenet_torch.models.config import WaveNetConfig as TConfig
from wavenet_torch.params import params_from_numpy

from test_torch_bf16 import BIAS_GAP_FRACTION, GAP_FRACTION, _hold
from test_torch_lc import perturbed
from test_torch_train import _corpus

torch.set_num_threads(1)

# tests/test_lc.py's lc_cfg: 7 layers, biases, 3 LC channels.
CFG = dict(dilations=(1, 2, 4, 8, 1, 2, 4), residual_channels=16,
           dilation_channels=16, skip_channels=24, quantization_channels=64,
           use_biases=True, lc_channels=3)


def _pair(seed=5, **kw):
    """Both configs and seeded numpy weights (drawn by the port's
    ``init_params``, then perturbed), which both packages take."""
    d = dict(CFG, **kw)
    jc, tc = JConfig(**d), TConfig(**d)
    npp = perturbed({k: v.numpy() for k, v in
                     tw.init_params(seed, tc, "cpu").items()}, seed)
    return jc, tc, npp


def _batch(c, seed=1, B=2, extra=64):
    rng = np.random.RandomState(seed)
    T = c.receptive_field + extra
    return (rng.uniform(-0.8, 0.8, (B, T)).astype(np.float32),
            rng.randn(B, T, c.lc_channels).astype(np.float32))


_JAX_GRAD = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True),
                    static_argnums=(1, 4))


def _jax_loss_grads(jc, npp, audio, lc, l2=None):
    """JAX's loss and gradients, jitted. At bf16 the compile keeps no
    excess precision (XLA's fusions would otherwise skip roundings
    between bf16 ops), so every op rounds as it does op by op
    (tests/test_torch_bf16.py's reference), in a tenth of the time."""
    args = ({k: jnp.asarray(v) for k, v in npp.items()}, jc,
            jnp.asarray(audio), None, l2, jnp.asarray(lc))
    grad_fn = _JAX_GRAD
    if jc.compute_dtype == "bfloat16":
        grad_fn = _JAX_GRAD.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        args = args[:1] + args[2:4] + args[5:]
    (loss, _), grads = grad_fn(*args)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_grads(tc, npp, audio, lc, l2=None):
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(npp, "cpu").items()}
    loss, aux = tw.loss_fn(leaves, tc, torch.from_numpy(audio), None, l2,
                           torch.from_numpy(lc))
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy()
                                  for k, v in leaves.items()}, aux


# ---------------------------------------------------------------------------
# Frame chunks (tests/test_lc_device.py)
# ---------------------------------------------------------------------------

def _host_chunks(feats, hop, mode, n_audio, trim_start, rf, sample_size):
    """The reader's host chain, chunk by chunk, with each chunk's frame
    window: (stream piece, LCFrameChunk fields)."""
    host = tlc.fit_lc_to_length(tlc.upsample_lc(feats, hop, mode), n_audio)
    host = np.pad(host[trim_start:], [[rf, 0], [0, 0]])
    width = rf + sample_size
    Fw = tlc.frame_window_size(width, hop)
    k = 0
    while len(host) > rf:
        piece = host[:width]
        n_valid = len(piece)
        piece = np.pad(piece, [[0, width - n_valid], [0, 0]])
        orig_start = trim_start + k * sample_size - rf
        f0 = max(0, orig_start // hop - 1)
        win = np.pad(feats[f0:f0 + Fw],
                     [[0, Fw - len(feats[f0:f0 + Fw])], [0, 0]])
        yield piece, (win[None], np.int32([orig_start]), np.int32([f0]),
                      np.int32([len(feats)]), np.int32([n_valid]),
                      np.int32([trim_start]))
        host = host[sample_size:]
        k += 1


@pytest.mark.parametrize("mode", ["repeat", "linear"])
def test_upsample_chunk_matches_host_chain(mode, rng):
    """Every chunk of a trimmed, padded utterance (a tail that is not a
    hop multiple, so the edge hold counts) rebuilds the host's stream,
    and equals the JAX package's device upsample."""
    hop, C, rf, sample_size, F = 8, 3, 13, 40, 23
    feats = rng.randn(F, C).astype(np.float32)
    width = rf + sample_size
    n = 0
    for piece, fields in _host_chunks(feats, hop, mode, 171, 5, rf,
                                      sample_size):
        got = tlc.upsample_chunk(tlc.LCFrameChunk(*fields), hop, mode,
                                 width).numpy()[0]
        if mode == "repeat":
            np.testing.assert_array_equal(got, piece, err_msg=f"chunk {n}")
        else:
            np.testing.assert_allclose(got, piece, atol=1e-5,
                                       err_msg=f"chunk {n}")
        ref = np.asarray(jlc.upsample_chunk_jax(
            jlc.LCFrameChunk(*map(jnp.asarray, fields)), hop, mode,
            width))[0]
        np.testing.assert_array_equal(got, ref, err_msg=f"chunk {n}")
        n += 1
    assert n >= 3
    assert tlc.frame_window_size(width, hop) == jlc.frame_window_size(
        width, hop)


def test_upsample_chunk_rejects_an_unknown_mode():
    chunk = tlc.LCFrameChunk(np.zeros((1, 4, 2), np.float32),
                             *(np.int32([v]) for v in (0, 0, 4, 8, 0)))
    with pytest.raises(ValueError, match="unknown upsample mode"):
        tlc.upsample_chunk(chunk, 2, "cubic", 8)


def _sidecar_corpus(tmp_path, rng, sr=2000, hop=50, C=4):
    """Two utterances with seeded sidecars (test_lc_device.py's)."""
    for spk in (1, 2):
        n = 900 + 137 * spk
        x = 0.5 * np.sin(2 * np.pi * (150 + 80 * spk) * np.arange(n) / sr)
        wavfile.write(str(tmp_path / f"p{spk}_001.wav"), sr,
                      (x * 32767).astype(np.int16))
        np.save(str(tmp_path / f"p{spk}_001.lc.npy"),
                rng.randn(-(-n // hop), C).astype(np.float32))
    return str(tmp_path), sr, hop, C


@pytest.mark.parametrize("mode", ["repeat", "linear"])
def test_reader_device_mode_matches_host_mode(mode, tmp_path, rng):
    """Same-seeded readers: frame windows, upsampled in the step's way,
    give the host mode's stream; the host mode gives the JAX reader's
    audio and stream."""
    data, sr, hop, C = _sidecar_corpus(tmp_path, rng)
    kw = dict(gc_enabled=False, receptive_field=33, sample_size=256,
              silence_threshold=0.01, seed=7, lc_enabled=True,
              lc_channels=C, lc_hop=hop, lc_upsample=mode, use_native=False)
    host, dev = AudioReader(data, sr, **kw), AudioReader(
        data, sr, lc_device_upsample=True, **kw)
    ref = JReader(data, sr, **kw)
    with host, dev, ref:
        for _ in range(6):
            a_h, lc_h = host.dequeue(2), host.dequeue_lc(2)
            a_d, chunk = dev.dequeue(2), dev.dequeue_lc(2)
            a_j, lc_j = ref.dequeue(2), ref.dequeue_lc(2)
            np.testing.assert_array_equal(a_h, a_d)
            np.testing.assert_array_equal(a_h, a_j)
            np.testing.assert_array_equal(lc_h, lc_j)
            assert isinstance(chunk, tlc.LCFrameChunk)
            rec = tlc.upsample_chunk(chunk, hop, mode, a_h.shape[1]).numpy()
            if mode == "repeat":
                np.testing.assert_array_equal(rec, lc_h)
            else:
                np.testing.assert_allclose(rec, lc_h, atol=1e-5)


def test_reader_whole_utterance_frame_windows(tmp_path, rng):
    """Whole-utterance mode pads each batch to its longest rung; a frame
    window grows with zero rows that the upsample never reads."""
    data, sr, hop, C = _sidecar_corpus(tmp_path, rng)
    kw = dict(receptive_field=33, sample_size=None, bucket_size=512,
              seed=3, lc_enabled=True, lc_channels=C, lc_hop=hop)
    with AudioReader(data, sr, **kw) as host, \
            AudioReader(data, sr, lc_device_upsample=True, **kw) as dev:
        for _ in range(3):
            a_h, lc_h = host.dequeue(2), host.dequeue_lc(2)
            a_d, chunk = dev.dequeue(2), dev.dequeue_lc(2)
            np.testing.assert_array_equal(a_h, a_d)
            assert chunk.frames.shape[1] == tlc.frame_window_size(
                a_h.shape[1], hop)
            np.testing.assert_array_equal(
                tlc.upsample_chunk(chunk, hop, "repeat",
                                   a_h.shape[1]).numpy(), lc_h)


def test_reader_raises_a_missing_sidecar(tmp_path):
    """A worker's error reaches the dequeue instead of leaving it waiting."""
    data = _corpus(tmp_path)
    with AudioReader(data, 2000, receptive_field=10, sample_size=100,
                     lc_enabled=True, lc_channels=2, lc_hop=10) as reader:
        with pytest.raises(ValueError, match="no <stem>.lc.npy"):
            reader.dequeue(1)


def test_train_step_accepts_frame_chunks(rng):
    """The step on an ``LCFrameChunk`` gives the loss of the step on the
    equivalent upsampled stream; a chunk without lc_hop raises as in
    JAX."""
    hop, C = 16, 3
    d = dict(dilations=(1, 2, 4), residual_channels=4, dilation_channels=4,
             skip_channels=8, quantization_channels=32, lc_channels=C)
    tc = TConfig(**d)
    B, T = 2, tc.receptive_field + 64
    audio = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    F = T // hop + 2
    feats = rng.randn(B, F, C).astype(np.float32)
    Fw = tlc.frame_window_size(T, hop)
    win = np.pad(feats, [[0, 0], [0, max(0, Fw - F)], [0, 0]])[:, :Fw]
    chunk = tlc.LCFrameChunk(win, np.zeros(B, np.int32),
                             np.zeros(B, np.int32), np.full(B, F, np.int32),
                             np.full(B, T, np.int32), np.zeros(B, np.int32))
    stream = np.stack([tlc.fit_lc_to_length(
        tlc.upsample_lc(feats[b], hop, "repeat"), T) for b in range(B)])
    npp = {k: v.numpy() for k, v in tw.init_params(0, tc, "cpu").items()}
    losses = {}
    opt = tl.make_optimizer("adam", 1e-3)
    for tag, lc_in, kw in (("stream", torch.from_numpy(stream), {}),
                           ("chunk", chunk, dict(lc_hop=hop))):
        state = tl.train_state_from_params(params_from_numpy(npp, "cpu"),
                                           opt)
        step = tl.make_train_step(tc, None, **kw)
        _, metrics = step(state, torch.from_numpy(audio), None, lc_in)
        losses[tag] = float(metrics["loss"])
    assert losses["stream"] == pytest.approx(losses["chunk"], abs=1e-6)
    state = tl.train_state_from_params(params_from_numpy(npp, "cpu"), opt)
    with pytest.raises(ValueError, match="lc_hop"):
        tl.make_train_step(tc, None)(state, torch.from_numpy(audio), None,
                                     chunk)


def test_multistep_takes_stacked_frame_chunks(rng):
    """K = 2 steps on chunks with a leading K axis equal two single steps
    on each chunk."""
    hop, C, K, B = 8, 2, 2, 2
    c = TConfig(dilations=(1, 2, 4), residual_channels=4,
                dilation_channels=4, skip_channels=8,
                quantization_channels=32, lc_channels=C)
    T = c.receptive_field + 40
    Fw = tlc.frame_window_size(T, hop)
    audio = torch.from_numpy(rng.uniform(-1, 1, (K, B, T)).astype(
        np.float32))
    chunk = tlc.LCFrameChunk(
        rng.randn(K, B, Fw, C).astype(np.float32),
        np.full((K, B), -3, np.int32), np.zeros((K, B), np.int32),
        np.full((K, B), Fw - 2, np.int32), np.full((K, B), T - 5, np.int32),
        np.zeros((K, B), np.int32))
    opt = tl.make_optimizer("adam", 1e-3)
    multi = tl.create_train_state(0, c, opt, "cpu")
    _, m = tl.make_train_multistep(c, None, K, lc_hop=hop)(multi, audio,
                                                           None, chunk)
    single = tl.create_train_state(0, c, opt, "cpu")
    step = tl.make_train_step(c, None, lc_hop=hop)
    for k in range(K):
        _, mk = step(single, audio[k], None,
                     tlc.LCFrameChunk(*(f[k] for f in chunk)))
        assert float(m["loss"][k]) == float(mk["loss"])
    for a, b in zip(multi.params.values(), single.params.values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Loss and gradients (tests/test_lc.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refine", [0, 5], ids=["plain", "refine"])
def test_loss_and_grads_with_lc_match_jax(refine):
    jc, tc, npp = _pair(lc_refine_width=refine)
    audio, lc = _batch(jc)
    l_j, g_j = _jax_loss_grads(jc, npp, audio, lc, 0.01)
    l_t, g_t, aux = _port_loss_grads(tc, npp, audio, lc, 0.01)
    assert set(aux) == {"ce_loss", "l2_loss", "total_loss"}
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert set(g_t) == set(g_j)
    for k in sorted(g_j):
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("lc_filter", "lc_gate"):
        assert np.abs(g_t[k]).max() > 0, k


def test_lc_length_must_align_with_the_audio():
    _, tc, npp = _pair()
    audio, lc = _batch(tc)
    with pytest.raises(ValueError, match="align"):
        tw.loss_fn(params_from_numpy(npp, "cpu"), tc,
                   torch.from_numpy(audio), lc=torch.from_numpy(lc[:, :-1]))


def test_lc_training_takes_the_plain_stack_under_use_pallas_stack():
    """LC sends the stack to the plain route, as in JAX: the loss is the
    plain one, and no stack kernel (nor its plain version) runs."""
    from wavenet_torch.kernels import fused_stack as fs
    _, tc, npp = _pair()
    audio, lc = _batch(tc)
    tp = params_from_numpy(npp, "cpu")
    tcs = TConfig(**dict(CFG, use_pallas_stack=True))
    want, _ = tw.loss_fn(tp, tc, torch.from_numpy(audio),
                         lc=torch.from_numpy(lc))
    before = (fs.forward.launches, fs.backward.launches)
    got, _ = tw.loss_fn(tp, tcs, torch.from_numpy(audio),
                        lc=torch.from_numpy(lc))
    assert float(got) == float(want)
    assert (fs.forward.launches, fs.backward.launches) == before


def test_refine_gradients_flow():
    jc, tc, npp = _pair(lc_refine_width=9)
    audio, lc = _batch(jc, extra=40)
    _, grads, _ = _port_loss_grads(tc, npp, audio, lc)
    for k in ("lc_up_depth", "lc_up_point", "lc_up_bias"):
        assert np.abs(grads[k]).max() > 0.0, k


@pytest.fixture(scope="module", params=[0, 5], ids=["plain", "refine"])
def bf16_runs(request):
    """(loss, grads) of JAX at float32 and bf16, and of the port at bf16,
    with LC, on the same weights and batch."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc, npp = _pair(lc_refine_width=request.param,
                            compute_dtype=dtype)
        audio, lc = _batch(jc)
        out["jax", dtype] = _jax_loss_grads(jc, npp, audio, lc)
        if dtype == "bfloat16":
            out["port", dtype] = _port_loss_grads(tc, npp, audio, lc)[:2]
    return out


def test_loss_with_lc_matches_jax_bf16(bf16_runs):
    j16, j32 = bf16_runs["jax", "bfloat16"][0], bf16_runs["jax", "float32"][0]
    assert j16 != j32                        # bf16 is in play
    _hold(np.float32(bf16_runs["port", "bfloat16"][0]), np.float32(j16),
          np.float32(j32), GAP_FRACTION, "loss")


def test_weight_gradients_with_lc_match_jax_bf16(bf16_runs):
    g16, g32 = bf16_runs["jax", "bfloat16"][1], bf16_runs["jax", "float32"][1]
    port = bf16_runs["port", "bfloat16"][1]
    for k in sorted(g32):
        if not k.endswith("_bias"):
            _hold(port[k], g16[k], g32[k], GAP_FRACTION, k)


def test_bias_gradients_with_lc_match_jax_bf16(bf16_runs):
    g16, g32 = bf16_runs["jax", "bfloat16"][1], bf16_runs["jax", "float32"][1]
    port = bf16_runs["port", "bfloat16"][1]
    for k in sorted(g32):
        if k.endswith("_bias"):
            _hold(port[k], g16[k], g32[k], BIAS_GAP_FRACTION, k)


# ---------------------------------------------------------------------------
# The reader's lockstep (tests/test_lc.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_mode", [False, True], ids=["host", "device"])
def test_reader_lc_lockstep(tmp_path, device_mode):
    """Audio encodes the sample index (a ramp) and the sidecar the same
    index at hop 4: after padding and chunking every (audio, lc) pair
    agrees wherever the audio is not zero."""
    sr, n = 1000, 1200
    ramp = (np.arange(n, dtype=np.float32) + 1.0) / n
    wavfile.write(str(tmp_path / "p1_000.wav"), sr,
                  (ramp * 20000).astype(np.int16))
    feats = ((np.arange(n // 4, dtype=np.float32) * 4 + 1) / n)[:, None]
    np.save(str(tmp_path / "p1_000.lc.npy"), feats)
    rf, ss = 32, 256
    with AudioReader(str(tmp_path), sr, receptive_field=rf, sample_size=ss,
                     silence_threshold=None, lc_enabled=True, lc_channels=1,
                     lc_hop=4, seed=0,
                     lc_device_upsample=device_mode) as reader:
        audio = reader.dequeue(2)
        lc = reader.dequeue_lc(2)
    if device_mode:
        lc = tlc.upsample_chunk(lc, 4, "repeat", rf + ss).numpy()
    assert audio.shape == (2, rf + ss)
    assert lc.shape == (2, rf + ss, 1)
    live = np.abs(audio) > 1e-4
    assert live.any()
    err = np.abs(lc[..., 0] - audio * (32768.0 / 20000.0))[live]
    assert err.max() < 4.5 / n + 2e-3, err.max()
    assert np.allclose(audio[:, :rf][~live[:, :rf]], 0.0)
    assert np.allclose(lc[:, :rf, 0][~live[:, :rf]], 0.0)


@pytest.mark.parametrize("device_mode", [False, True], ids=["host", "device"])
def test_reader_lc_trim_lockstep(tmp_path, device_mode):
    """Leading silence is trimmed from both streams by the same indices:
    the sidecar marks the tone's samples with 1.0."""
    sr = 1000
    tone = 0.5 * np.sin(2 * np.pi * 50 * np.arange(3000) / sr)
    audio = np.concatenate([np.zeros(2000), tone]).astype(np.float32)
    wavfile.write(str(tmp_path / "p1_000.wav"), sr,
                  (audio * 20000).astype(np.int16))
    marker = (np.arange(len(audio)) >= 2000).astype(np.float32)
    np.save(str(tmp_path / "p1_000.lc.npy"), marker[::4][:, None])
    rf, ss = 16, 256
    with AudioReader(str(tmp_path), sr, receptive_field=rf, sample_size=ss,
                     silence_threshold=0.05, lc_enabled=True, lc_channels=1,
                     lc_hop=4, seed=0,
                     lc_device_upsample=device_mode) as reader:
        a = reader.dequeue(8)
        lc = reader.dequeue_lc(8)
    if device_mode:
        lc = tlc.upsample_chunk(lc, 4, "repeat", rf + ss).numpy()
    assert np.abs(a[:2, rf:]).max() > 0.05       # the trim fired
    loud = np.abs(a) > 0.05
    assert loud.any()
    assert lc[..., 0][loud].mean() > 0.98
    assert np.allclose(a[0, :4], 0.0)
    assert np.allclose(lc[0, :4, 0], 0.0)


# ---------------------------------------------------------------------------
# The train CLI's --lc_* flags
# ---------------------------------------------------------------------------

def test_train_cli_with_lc(tmp_path, capsys):
    """Three steps with log-mel sidecars (``wavenet_torch.features``): the
    device upsample (the default) and ``--lc_host_upsample`` train on the
    same batches to the same losses; ``--lc_refine_width`` with
    ``--lc_upsample linear`` trains the refiner too."""
    from wavenet_torch.cli import train as cli
    from wavenet_torch.features import write_sidecars

    data = _corpus(tmp_path)
    write_sidecars(data, 2000, n_mels=4, hop=50, n_fft=128, log=lambda _: 0)
    pfile = tmp_path / "params.json"
    pfile.write_text(json.dumps(
        {"filter_width": 2, "sample_rate": 2000, "dilations": [1, 2, 4, 8],
         "residual_channels": 8, "dilation_channels": 8, "skip_channels": 16,
         "quantization_channels": 32, "use_biases": True}))

    def run(name, *flags):
        logdir = str(tmp_path / name)
        rc = cli.main(["--data_dir", data, "--wavenet_params", str(pfile),
                       "--logdir", logdir, "--batch_size", "2",
                       "--sample_size", "100", "--num_steps", "3",
                       "--steps_per_dispatch", "2", "--device", "cpu",
                       "--seed", "1", "--lc_channels", "4", "--lc_hop", "50",
                       *flags])
        assert rc == 0
        losses = [float(ln.split("loss = ")[1].split(",")[0])
                  for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith("step ")]
        assert len(losses) == 3 and np.all(np.isfinite(losses)), losses
        return logdir, losses

    _, device_losses = run("device")
    _, host_losses = run("host", "--lc_host_upsample")
    np.testing.assert_allclose(device_losses, host_losses, atol=1e-5)
    logdir, _ = run("refine", "--lc_refine_width", "3", "--lc_upsample",
                    "linear")
    with np.load(os.path.join(logdir, "ckpt-3", "params.npz")) as z:
        assert {"lc_filter", "lc_gate", "lc_up_depth"} <= set(z.files)
