"""The port's native data path (``wavenet_torch.data.native``) against the
scipy/numpy implementations and against the JAX package's own binding of
the same C++ library, and the port's default reader against the JAX
reader's default on a corpus with a file that needs resampling."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavenet_torch.audio import (
    mu_law_decode_np, mu_law_encode_np, read_wav, resample as resample_py,
    trim_silence as trim_py, write_wav)
from wavenet_torch.data import native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mulaw_encode_exact(rng):
    x = rng.uniform(-1.5, 1.5, 10000).astype(np.float32)
    np.testing.assert_array_equal(native.mu_law_encode(x, 256),
                                  mu_law_encode_np(x, 256))
    np.testing.assert_array_equal(native.mu_law_encode(x, 64),
                                  mu_law_encode_np(x, 64))


def test_mulaw_decode_close(rng):
    codes = rng.randint(0, 256, 5000).astype(np.int32)
    np.testing.assert_allclose(native.mu_law_decode(codes, 256),
                               mu_law_decode_np(codes, 256),
                               rtol=1e-6, atol=1e-7)


def test_load_wav_pcm16_matches_scipy(tmp_path, rng):
    sr = 8000
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(
        np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, x, sr)
    nat = native.load_wav(path)
    assert nat is not None
    audio_n, sr_n = nat
    audio_p, sr_p = read_wav(path)
    assert sr_n == sr_p == sr
    np.testing.assert_allclose(audio_n, audio_p, atol=1e-7)


def test_load_wav_stereo_mix(tmp_path):
    sr = 4000
    left = np.linspace(-0.5, 0.5, sr).astype(np.float32)
    right = -left
    stereo = np.stack([left, right], axis=1)
    path = str(tmp_path / "st.wav")
    wavfile.write(path, sr, (stereo * 32767).astype(np.int16))
    audio_n, _ = native.load_wav(path)
    audio_p, _ = read_wav(path)
    np.testing.assert_allclose(audio_n, audio_p, atol=1e-6)


def test_resample_close_to_scipy(rng):
    sr_in, sr_out = 48000, 16000
    t = np.arange(sr_in) / sr_in
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)
    nat = native.resample(x, sr_in, sr_out)
    ref = resample_py(x, sr_in, sr_out)
    assert nat is not None
    assert abs(len(nat) - len(ref)) <= 1
    n = min(len(nat), len(ref))
    # Different filter designs; compare away from the edges.
    err = np.abs(nat[100:n - 100] - ref[100:n - 100])
    assert float(err.max()) < 0.01, float(err.max())


def test_resample_identity():
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    out = native.resample(x, 16000, 16000)
    np.testing.assert_array_equal(out, x)


def test_trim_silence_matches_python():
    sr = 4000
    silence = np.zeros(sr, np.float32)
    loud = (0.5 * np.sin(2 * np.pi * 200 * np.arange(sr) / sr)).astype(
        np.float32)
    audio = np.concatenate([silence, loud, silence])
    nat = native.trim_silence(audio, 0.05)
    ref = trim_py(audio, 0.05)
    assert nat is not None
    np.testing.assert_array_equal(nat, ref)


def test_trim_silence_all_quiet():
    audio = (1e-4 * np.random.RandomState(0).randn(5000)).astype(np.float32)
    assert native.trim_silence(audio, 0.05).size == 0


def test_reader_uses_native(tmp_path):
    sr = 4000
    x = (0.5 * np.sin(2 * np.pi * 200 * np.arange(sr) / sr)).astype(
        np.float32)
    wavfile.write(str(tmp_path / "p1_001.wav"), sr,
                  (x * 32767).astype(np.int16))
    from wavenet_torch.data.reader import AudioReader
    with AudioReader(str(tmp_path), sample_rate=sr, receptive_field=16,
                     sample_size=64, seed=0, use_native=True) as r:
        batch = r.dequeue(2)
    assert batch.shape == (2, 80)
    assert np.isfinite(batch).all()


def test_same_library_as_jax_package(rng, tmp_path):
    """The port's and the JAX package's bindings run the same C++: equal
    outputs, bit for bit."""
    from wavenet_tpu.data import native as jnative
    x = rng.uniform(-1.0, 1.0, 7001).astype(np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, x, 22050)
    np.testing.assert_array_equal(native.mu_law_encode(x),
                                  jnative.mu_law_encode(x))
    np.testing.assert_array_equal(native.resample(x, 22050, 16000),
                                  jnative.resample(x, 22050, 16000))
    np.testing.assert_array_equal(native.read_wav(path, 16000)[0],
                                  jnative.read_wav(path, 16000)[0])


def _corpus(root):
    """Six files: speakers 1 and 3 at 16 kHz, speaker 2 at 22,050 Hz."""
    rng = np.random.RandomState(5)
    for spk, sr in ((1, 16000), (2, 22050), (3, 16000)):
        for utt in range(2):
            n = int(sr * rng.uniform(0.15, 0.3))
            t = np.arange(n) / sr
            x = (0.6 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
                 + 0.05 * rng.randn(n)).clip(-0.99, 0.99)
            wavfile.write(os.path.join(root, f"p{spk}_{utt:03d}.wav"), sr,
                          (x * 32767).astype(np.int16))


@pytest.mark.parametrize("sample_size,n_batches", [(None, 4), (2000, 8)])
def test_default_reader_batches_equal_jax(tmp_path, sample_size, n_batches):
    """The port's default AudioReader and the JAX one (``use_native=True``,
    its default) give bitwise equal batches, also where a batch holds a
    resampled 22,050 Hz file (scipy's resampler differs from the C++ one
    there by ~1e-3)."""
    from wavenet_tpu.data.reader import AudioReader as JReader
    from wavenet_torch.data.reader import AudioReader as TReader
    _corpus(str(tmp_path))
    kw = dict(gc_enabled=True, receptive_field=64, seed=3,
              sample_size=sample_size, silence_threshold=0.01)
    batches = {}
    for name, cls in (("jax", JReader), ("torch", TReader)):
        with cls(str(tmp_path), 16000, **kw) as r:
            batches[name] = [(r.dequeue(2), r.dequeue_gc(2))
                             for _ in range(n_batches)]
    assert any(2 in ids for _, ids in batches["torch"])
    for (a, ia), (b, ib) in zip(batches["jax"], batches["torch"]):
        np.testing.assert_array_equal(ia, ib)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_build_writes_only_to_the_build_dir(tmp_path, monkeypatch):
    """A fresh build goes to the port's build directory under a hashed
    name, through a temporary file; ``native/`` is left as it was."""
    native_dir = os.path.join(REPO, "native")
    before = sorted(os.listdir(native_dir))
    build = tmp_path / "build"
    monkeypatch.setenv("WAVENET_TORCH_BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == str(build)
    assert os.listdir(build) == [os.path.basename(path)]
    assert os.path.basename(path).startswith("libwavenet_data-")
    assert sorted(os.listdir(native_dir)) == before
    x = np.linspace(-1, 1, 101).astype(np.float32)
    np.testing.assert_array_equal(native.mu_law_encode(x),
                                  mu_law_encode_np(x))
