"""The port's sampler choice against the JAX ladder's (``wavenet_tpu/
sampler_select.py``).

The JAX package offers a Pallas rung only where one of its VMEM
estimators is under ``GENEROUS_VMEM``, and otherwise runs its scan
sampler. ``wavenet_torch.sampler_select`` keeps its own copies of those
estimators (plain arithmetic on the config), offers a decode kernel where
JAX offers a rung and the scan sampler elsewhere (the sharded config at
every batch), and the CLI and the server go through that choice. Here the
copies are held equal to JAX's, the choice to JAX's ladder (its platform
check patched to a TPU's), and the CLI and the server on the CPU to the
choice (a budget patched small, so that a tiny config finds no rung).
"""

import json
import types

import numpy as np
import pytest
import torch

from wavenet_tpu import sampler_select as jsel
from wavenet_tpu.kernels import sampler as jks
from wavenet_tpu.models import config as jconfig
from wavenet_torch import sampler_select as tsel
from wavenet_torch.models import config as tconfig
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import init_params
from wavenet_torch.params import save_npz

torch.set_num_threads(1)

CONFIGS = ("tiny_config", "paper_config", "gc_config", "wide_config",
           "sharded_config")
BATCHES = (1, 64, 512, 600, 2048)
GEN_SAMPLES = 16000


def _pair(name, **kw):
    return getattr(jconfig, name)(**kw), getattr(tconfig, name)(**kw)


@pytest.mark.parametrize("name", CONFIGS)
def test_estimators_equal_jax(name):
    jc, tc = _pair(name)
    n = tc.receptive_field + GEN_SAMPLES
    for B in BATCHES:
        assert tsel.sampler_vmem_bytes(tc, B, n) == jks.sampler_vmem_bytes(
            jc, B, n), B
        assert (tsel.sampler_vmem_bytes(tc, B, n, state_bytes=2)
                == jks.sampler_vmem_bytes(jc, B, n, state_bytes=2)), B
        assert (tsel.hbm_sampler_vmem_bytes(tc, B, n)
                == jks.hbm_sampler_vmem_bytes(jc, B, n)), B
        assert (tsel.stream_hbm_sampler_vmem_bytes(tc, B)
                == jks.stream_hbm_sampler_vmem_bytes(jc, B)), B


def test_estimators_equal_jax_with_lc():
    jc, tc = _pair("paper_config", lc_channels=80)
    for B in (1, 64, 600):
        n = tc.receptive_field + 4000
        assert tsel.sampler_vmem_bytes(tc, B, n) == jks.sampler_vmem_bytes(
            jc, B, n)
        assert (tsel.stream_hbm_sampler_vmem_bytes(tc, B)
                == jks.stream_hbm_sampler_vmem_bytes(jc, B))
    assert tsel.GENEROUS_VMEM == jsel.GENEROUS_VMEM


@pytest.mark.parametrize("name", CONFIGS)
def test_attempts_follow_the_jax_ladder(name, monkeypatch):
    """A kernel where the JAX ladder (as on a TPU) offers any rung, the
    scan sampler where it offers none: only the sharded config, at every
    batch."""
    monkeypatch.setattr(jsel.jax, "devices",
                        lambda: [types.SimpleNamespace(platform="tpu")])
    jc, tc = _pair(name)
    n = tc.receptive_field + GEN_SAMPLES
    for B in BATCHES:
        want = bool(jsel.sampler_attempts(jc, B, n))
        got = tsel.sampler_attempts(tc, batch_size=B, n_total=n)
        assert bool(got) == want == (name != "sharded_config"), B
    assert bool(tsel.sampler_attempts(tc)) == (name != "sharded_config")


TINY = dict(dilations=(1, 2, 4), residual_channels=4, dilation_channels=4,
            skip_channels=8, quantization_channels=32)


def _model(tmp):
    c = WaveNetConfig(**TINY)
    pfile = tmp / "tiny.json"
    pfile.write_text(json.dumps(dict(c.to_json_dict(), sample_rate=2000)))
    params = init_params(0, c, device="cpu")
    npz = tmp / "tiny.npz"
    save_npz(str(npz), params)
    return c, params, str(npz), str(pfile)


def test_no_rung_runs_scan_in_the_server_and_the_cli(tmp_path, monkeypatch,
                                                     capsys):
    """With a budget no estimate meets, ``generate_with_fallback``, the
    server and the CLI (both of its fast paths) run the scan sampler, as
    the sharded config does on the card; with the budget restored, the
    kernel route."""
    from wavenet_torch import serve
    from wavenet_torch import train_lib as tl
    from wavenet_torch.cli import generate as cli

    c, params, npz, pfile = _model(tmp_path)
    monkeypatch.setattr(tsel, "GENEROUS_VMEM", 0)
    assert tsel.sampler_attempts(c) == []
    logs = []
    codes, name, kw = tsel.generate_with_fallback(
        params, c, 12, seed=2, batch_size=2, log=logs.append)
    assert codes.shape == (2, 12) and (name, kw) == ("scan", None)
    assert logs == ["Using scan sampler."]
    service = serve.GenerationService(npz, pfile, warm_samples=0,
                                      device="cpu")
    assert service.sampler_name == "scan"
    assert service.generate(20, seed=1).shape == (20,)
    assert service.sampler_name == "scan"
    logdir = str(tmp_path / "logdir")
    tl.save_checkpoint(logdir, tl.train_state_from_params(
        params, tl.make_optimizer("adam", 1e-3)))
    for extra, line in (([], "Using scan sampler."),
                        (["--save_every", "10"],
                         "Using scan sampler, resumable.")):
        assert cli.main([logdir, "--wavenet_params", pfile, "--samples",
                         "20", "--wav_out_path", str(tmp_path / "o.wav"),
                         "--device", "cpu"] + extra) == 0
        assert line in capsys.readouterr().out

    monkeypatch.setattr(tsel, "GENEROUS_VMEM", jsel.GENEROUS_VMEM)
    service = serve.GenerationService(npz, pfile, warm_samples=0,
                                      device="cpu")
    assert "decode_reference" in service.sampler_name
    wave = service.generate(20, seed=1)
    assert np.isfinite(wave).all() and "decode_reference" in (
        service.sampler_name)
