"""wavenet_torch stands alone: it imports neither jax nor wavenet_tpu, and
its entry points do not fall back from CUDA to the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import wavenet_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "wavenet_torch")
FORBIDDEN = ("jax", "jaxlib", "wavenet_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        wavenet_torch.__path__, "wavenet_torch."))


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "wavenet_torch.kernels.sampler" in mods
    assert "wavenet_torch.serve" in mods
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("rel", ["wavenet_torch", "chip_smoke.py"])
def test_no_source_imports_jax(rel):
    path = os.path.join(ROOT, rel)
    files = ([path] if path.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(path)
              for f in fs if f.endswith(".py")])
    assert files
    for f in files:
        bad = set(_imported_roots(f)) & set(FORBIDDEN)
        assert not bad, f"{f} imports {sorted(bad)}"


def test_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    from wavenet_torch import resolve_device
    from wavenet_torch.models.config import tiny_config
    from wavenet_torch.models.wavenet import init_params
    from wavenet_torch.serve import GenerationService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(RuntimeError):
        init_params(0, tiny_config())
    js = tmp_path / "m.json"
    js.write_text('{"sample_rate": 16000, "dilations": [1, 2]}')
    with pytest.raises(RuntimeError):
        GenerationService(str(tmp_path / "none.npz"), str(js),
                          warm_samples=0)


def test_decode_on_an_unsupported_device_raises():
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.config import WaveNetConfig

    c = WaveNetConfig(dilations=(1, 2), residual_channels=2,
                      dilation_channels=2, skip_channels=4,
                      quantization_channels=8)
    ring = torch.empty((3, 1, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ks.decode(None, c, ring, None, None, 1, 0, 0)
