"""wavenet_torch config, audio and params against the JAX package (CPU)."""

import json

import jax
import numpy as np
import pytest
import torch

from wavenet_tpu import audio as jaudio
from wavenet_tpu.kernels.sampler import chunk_seed as jchunk_seed
from wavenet_tpu.models import config as jconfig
from wavenet_tpu.models.wavenet import init_params as jinit_params
from wavenet_torch import audio as taudio
from wavenet_torch.kernels.sampler import chunk_seed
from wavenet_torch.models import config as tconfig
from wavenet_torch.models.wavenet import init_params
from wavenet_torch.params import (
    load_npz, params_from_numpy, params_to_numpy, save_npz)

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_configs_match_and_round_trip(name, tmp_path):
    jc = jconfig.CONFIGS[name]()
    tc = tconfig.CONFIGS[name]()
    assert tc.to_json_dict() == jc.to_json_dict()
    assert tc.receptive_field == jc.receptive_field
    assert (tc.gc_channels, tc.gc_cardinality) == (jc.gc_channels,
                                                   jc.gc_cardinality)
    path = tmp_path / "params.json"
    path.write_text(json.dumps(tc.to_json_dict()))
    # GC keys ride beside the JSON (CLI flags), as in the JAX package.
    assert tconfig.WaveNetConfig.from_json(
        str(path), gc_channels=tc.gc_channels,
        gc_cardinality=tc.gc_cardinality) == tc
    assert tconfig.WaveNetConfig._JSON_KEYS == jconfig.WaveNetConfig._JSON_KEYS


def test_config_validation_and_overrides():
    with pytest.raises(ValueError):
        tconfig.WaveNetConfig(gc_channels=4)
    with pytest.raises(ValueError):
        tconfig.WaveNetConfig(lc_channels=3, lc_refine_width=2)
    raw = tconfig.paper_config().to_json_dict()
    raw["unknown_key"] = 1
    c = tconfig.WaveNetConfig.from_json(raw, gc_channels=8, gc_cardinality=3)
    assert c.gc_enabled and c.gc_cardinality == 3


def test_mu_law_bitwise(rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4096),
                        [-1.0, -0.5, 0.0, 0.5, 1.0, 2.0]]).astype(np.float32)
    for q in (256, 32):
        ref = jaudio.mu_law_encode_np(x, q)
        np.testing.assert_array_equal(taudio.mu_law_encode_np(x, q), ref)
        np.testing.assert_array_equal(
            taudio.mu_law_encode(torch.from_numpy(x), q).numpy(), ref)
        codes = np.arange(q)
        np.testing.assert_array_equal(taudio.mu_law_decode_np(codes, q),
                                      jaudio.mu_law_decode_np(codes, q))
        np.testing.assert_allclose(
            taudio.mu_law_decode(torch.from_numpy(codes), q).numpy(),
            jaudio.mu_law_decode_np(codes, q), rtol=1e-6, atol=1e-7)


def test_wav_round_trip_and_trim(tmp_path, rng):
    x = (0.5 * np.sin(np.arange(4000) / 7.0)).astype(np.float32)
    x[:1000] = 0.0
    path = str(tmp_path / "a.wav")
    taudio.write_wav(path, x, 8000)
    y, sr = taudio.read_wav(path)
    assert sr == 8000 and y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=1e-4)
    assert (taudio.trim_silence_indices(y, 0.05)
            == jaudio.trim_silence_indices(y, 0.05))
    np.testing.assert_allclose(taudio.resample(y, 8000, 4000),
                               jaudio.resample(y, 8000, 4000))


@pytest.mark.parametrize("name", ["tiny", "gc"])
def test_params_keys_and_shapes_match_jax(name, tmp_path):
    jc = jconfig.CONFIGS[name]()
    tc = tconfig.CONFIGS[name]()
    jp = {k: np.asarray(v) for k, v in
          jinit_params(jax.random.PRNGKey(0), jc).items()}
    tp = params_from_numpy(jp, "cpu")
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    own = init_params(0, tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in jp.items()}
    if name == "gc":  # 109 speakers x 32 channels: Xavier, not identity
        assert not torch.equal(own["gc_embedding"][:32, :32], torch.eye(32))
    path = str(tmp_path / "p.npz")
    save_npz(path, own)
    back = load_npz(path, "cpu")
    assert all(torch.equal(back[k], own[k]) for k in own)
    assert all(np.array_equal(v, own[k].numpy())
               for k, v in params_to_numpy(own).items())


def test_identity_gc_embedding_and_seeded_init():
    c = tconfig.tiny_config(gc_channels=4, gc_cardinality=4)
    p = init_params(3, c, device="cpu")
    assert torch.equal(p["gc_embedding"], torch.eye(4))
    q = init_params(3, c, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    limit = (6.0 / (2 * 16 + 2 * 16)) ** 0.5
    assert p["filter"].abs().max().item() <= limit


def test_chunk_seed_matches_jax():
    for s in (0, 1, 7, 2 ** 31 - 1):
        for i in range(4):
            assert chunk_seed(s, i) == jchunk_seed(s, i)
