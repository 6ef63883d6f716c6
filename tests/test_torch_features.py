"""wavenet_torch.features against wavenet_tpu.features (CPU).

Mirrors tests/test_features.py: the mel algebra, the STFT's frame
alignment, the log-mel frames, and the sidecar writer and its CLI, each
held against the JAX package's function on the same arrays or corpus.
"""

import os

import numpy as np
import pytest

from wavenet_torch import features as tf
from wavenet_tpu import features as jf


def _corpus(root, sr, amps=(0.5,), speakers=(1, 2)):
    from scipy.io import wavfile
    root.mkdir(exist_ok=True)
    t = np.arange(sr) / sr
    for spk in speakers:
        for amp in amps:
            x = amp * np.sin(2 * np.pi * (200 + 100 * spk) * t)
            wavfile.write(str(root / f"p{spk}_001.wav"), sr,
                          (x * 32767).astype(np.int16))
    return root


def test_mel_scale_matches_jax():
    f = np.array([0.0, 100.0, 440.0, 4000.0, 7999.0])
    np.testing.assert_array_equal(tf.hz_to_mel(f), jf.hz_to_mel(f))
    m = tf.hz_to_mel(f)
    np.testing.assert_array_equal(tf.mel_to_hz(m), jf.mel_to_hz(m))
    np.testing.assert_allclose(tf.mel_to_hz(m), f, rtol=1e-10)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 1024, 80, 0.0, None), (2000, 256, 8, 50.0, 900.0)])
def test_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax):
    got = tf.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    ref = jf.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tf.mel_filterbank(sr, n_fft, n_mels, fmin=sr, fmax=None)


@pytest.mark.parametrize("n", [1, 199, 200, 3001])
def test_stft_and_log_mel_match_jax(n, rng):
    audio = rng.uniform(-0.8, 0.8, n).astype(np.float32)
    np.testing.assert_array_equal(tf.stft_magnitude(audio, 256, 50),
                                  jf.stft_magnitude(audio, 256, 50))
    got = tf.log_mel_spectrogram(audio, 16000, n_mels=40, hop=200)
    ref = jf.log_mel_spectrogram(audio, 16000, n_mels=40, hop=200)
    assert got.shape == (-(-n // 200), 40)
    np.testing.assert_array_equal(got, ref)


def test_stft_frame_alignment_center():
    # An impulse at sample k*hop dominates frame k (center semantics).
    sr, hop, n_fft = 16000, 200, 1024
    audio = np.zeros(sr, np.float32)
    audio[10 * hop] = 1.0
    energy = (tf.stft_magnitude(audio, n_fft, hop) ** 2).sum(axis=1)
    assert int(np.argmax(energy)) == 10


def test_write_sidecars_match_jax(tmp_path):
    sr, hop, n_mels = 2000, 50, 8
    a = _corpus(tmp_path / "a", sr)
    b = _corpus(tmp_path / "b", sr)
    assert tf.write_sidecars(str(a), sr, n_mels, hop, n_fft=256,
                             log=lambda *_: None) == 2
    assert jf.write_sidecars(str(b), sr, n_mels, hop, n_fft=256,
                             log=lambda *_: None) == 2
    for spk in (1, 2):
        got = np.load(str(a / f"p{spk}_001.lc.npy"))
        ref = np.load(str(b / f"p{spk}_001.lc.npy"))
        assert got.shape == (sr // hop, n_mels)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    with np.load(str(a / "lc_stats.npz")) as za, \
            np.load(str(b / "lc_stats.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_allclose(za[k], zb[k], rtol=1e-5)
    # Standardized over the corpus.
    both = np.concatenate([np.load(str(a / f"p{s}_001.lc.npy"))
                           for s in (1, 2)])
    np.testing.assert_allclose(both.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(both.std(axis=0), 1.0, atol=1e-3)


def test_write_sidecars_with_external_stats(tmp_path):
    """A held-out split takes the training corpus's mean and std."""
    sr, hop, n_mels = 2000, 50, 8
    train = _corpus(tmp_path / "train", sr, speakers=(1,))
    held = _corpus(tmp_path / "held", sr, amps=(0.05,), speakers=(1,))
    tf.write_sidecars(str(train), sr, n_mels, hop, n_fft=256,
                      log=lambda *_: None)
    stats = str(train / "lc_stats.npz")
    tf.write_sidecars(str(held), sr, n_mels, hop, n_fft=256,
                      stats_path=stats, log=lambda *_: None)
    assert not os.path.exists(str(held / "lc_stats.npz"))
    side = np.load(str(held / "p1_001.lc.npy"))
    assert side.mean() < -0.5
    with pytest.raises(ValueError, match="was computed for"):
        tf.write_sidecars(str(held), sr, n_mels, hop * 2, n_fft=256,
                          stats_path=stats, log=lambda *_: None)
    with pytest.raises(FileNotFoundError):
        tf.write_sidecars(str(tmp_path / "none"), sr, n_mels, hop)


def test_cli_main(tmp_path, capsys):
    d = _corpus(tmp_path / "c", 2000, speakers=(1,))
    rc = tf.main([str(d), "--sample_rate", "2000", "--n_mels", "8",
                  "--hop", "50", "--n_fft", "256", "--no_normalize"])
    assert rc == 0
    assert "--lc_channels 8 --lc_hop 50" in capsys.readouterr().out
    side = np.load(str(d / "p1_001.lc.npy"))
    assert not os.path.exists(str(d / "lc_stats.npz"))
    from wavenet_torch.audio import read_wav
    audio, _ = read_wav(str(d / "p1_001.wav"), 2000)
    np.testing.assert_array_equal(
        side, tf.log_mel_spectrogram(audio, 2000, 8, 50, 256))
