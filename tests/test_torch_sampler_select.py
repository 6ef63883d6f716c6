"""The port's sampler choice (``wavenet_torch/sampler_select.py``) against
the JAX ladder's (``wavenet_tpu/sampler_select.py``) and its own decode
route (``wavenet_torch/kernels/sampler.py`` ``route_plan``).

The JAX package offers a Pallas rung only where one of its estimates of a
TPU core's VMEM fits, and otherwise runs its scan sampler. The port keeps
the ladder's refusal for a reason of the model (``filter_width != 2``)
and routes the rest by what its CUDA kernels hold: a decode kernel
wherever one can launch (the sharded config too, on ``sampler_decode``).
On the CPU the choice takes an H100's opt-in shared memory. Here the
choice is held to the route, the route to ``cluster_plan`` and
``tile_plan``, and the CLI and the server on the CPU to the choice (the
opt-in patched to 0, so that no kernel can launch).
"""

import json
import types

import numpy as np
import pytest
import torch

from wavenet_tpu import sampler_select as jsel
from wavenet_tpu.models import config as jconfig
from wavenet_torch import sampler_select as tsel
from wavenet_torch.kernels import sampler as ks
from wavenet_torch.models import config as tconfig
from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import init_params
from wavenet_torch.params import save_npz

torch.set_num_threads(1)

CONFIGS = ("tiny_config", "paper_config", "gc_config", "wide_config",
           "sharded_config")
BATCHES = (1, 64, 512, 600, 2048)
GEN_SAMPLES = 16000
# An H100 SXM's clusters resident at once: 15 of 8 CTAs and 7 of 16 as
# cudaOccupancyMaxActiveClusters reads them on the card (as
# tests/test_torch_sampler_cluster.py takes them); the smaller sizes, which
# only the tiny config reaches, at one CTA an SM.
H100_CLUSTERS = {8: 15, 16: 7}


def h100_resident(cs, rb, nbytes):
    return H100_CLUSTERS.get(cs, 132 // cs)


H100 = dict(cluster_resident=h100_resident, tile_resident=h100_resident)


def _pair(name, **kw):
    return getattr(jconfig, name)(**kw), getattr(tconfig, name)(**kw)


def _plans(c, B, optin=ks.H100_SMEM_OPTIN):
    """What the route should name, from the two plans and one row of
    ``sampler_decode``."""
    if ks.cluster_plan(c, B, optin, h100_resident) is not None:
        return "cluster"
    if ks.tile_plan(c, B, optin, h100_resident, h100_resident) is not None:
        return "tiles"
    return "decode" if ks.decode_smem_bytes(c, 1) <= optin else None


@pytest.mark.parametrize("name", CONFIGS)
def test_attempts_follow_the_jax_ladder(name, monkeypatch):
    """Where the JAX ladder refuses for a reason of the model (filter
    width 3) the port runs the scan sampler too; elsewhere it offers a
    decode kernel wherever ``decode_route`` names one: every config at
    every batch, the sharded config (which the ladder's TPU VMEM budget
    sends to its scan sampler) included."""
    monkeypatch.setattr(jsel.jax, "devices",
                        lambda: [types.SimpleNamespace(platform="tpu")])
    jc, tc = _pair(name)
    for B in BATCHES:
        assert ks.decode_route(tc, B, ks.H100_SMEM_OPTIN, **H100), B
        assert tsel.decode_offered(tc, B, "cpu"), B
        got = tsel.sampler_attempts(tc, batch_size=B)
        assert len(got) == 1 and got[0][1] == {"prefill": True}, B
    assert tsel.sampler_attempts(tc)
    jc3, tc3 = _pair(name, filter_width=3)
    n = tc3.receptive_field + GEN_SAMPLES
    assert jsel.sampler_attempts(jc3, 1, n) == []
    assert tsel.sampler_attempts(tc3) == []
    assert ks.decode_route(tc3, 1, ks.H100_SMEM_OPTIN, **H100) is None
    assert not tsel.decode_offered(tc3, 1, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_route_follows_the_plans(name):
    """``decode_route`` at an H100's opt-in names the cluster kernel where
    ``cluster_plan`` finds a launch, the tiles kernel where ``tile_plan``
    does, and ``sampler_decode`` elsewhere, each with the plan it finds
    (``route_plan``, which ``decode`` launches by); the sharded config
    runs ``sampler_decode`` at every batch, the paper and gc configs reach
    all three kernels."""
    c = getattr(tconfig, name)()
    routes = {B: ks.decode_route(c, B, ks.H100_SMEM_OPTIN, **H100)
              for B in BATCHES + (120, 121, 525, 526)}
    assert routes == {B: _plans(c, B) for B in routes}
    for B, route in routes.items():
        used, plan = ks.route_plan(c, B, ks.H100_SMEM_OPTIN, **H100)
        assert used == route and isinstance(plan, {
            "cluster": ks.ClusterPlan, "tiles": ks.TilePlan,
            "decode": type(None)}[route]), B
        pinned = ks.route_plan(c, B, ks.H100_SMEM_OPTIN, **H100,
                               kernel=route)
        assert pinned == (used, plan), B
    if name == "sharded_config":
        assert set(routes.values()) == {"decode"}
        assert ks.decode_smem_bytes(c, 1) < 20_000
    if name in ("paper_config", "gc_config"):
        assert (routes[1], routes[120], routes[121], routes[525],
                routes[526]) == ("cluster", "cluster", "tiles", "tiles",
                                 "decode")


def test_decode_route_is_none_where_no_row_fits():
    """An opt-in below one row of ``sampler_decode`` (and so below every
    cluster CTA) leaves no kernel: the route is None and the choice the
    scan sampler."""
    for name in CONFIGS:
        c = getattr(tconfig, name)()
        row = ks.decode_smem_bytes(c, 1)
        assert ks.decode_route(c, 1, row, **H100) is not None, name
        assert ks.decode_route(c, 1, row - 1, **H100) is None, name
        assert ks.decode_route(c, 600, 0, **H100) is None, name
        assert ks.can_decode(c, row) and not ks.can_decode(c, row - 1)


@pytest.mark.parametrize("name", ("paper_config", "wide_config"))
def test_decode_route_with_lc(name):
    """An LC config never takes the tiles kernel (it has no LC mode): the
    cluster kernel where it holds the LC terms, else ``sampler_decode``,
    whose row holds the layers' LC terms and the feature row."""
    c = getattr(tconfig, name)(lc_channels=80)
    plain = getattr(tconfig, name)()
    assert (ks.decode_smem_bytes(c, 1) - ks.decode_smem_bytes(plain, 1)
            == 4 * (80 + 2 * c.num_layers * c.dilation_channels))
    for B in BATCHES + (121, 525):
        route = ks.decode_route(c, B, ks.H100_SMEM_OPTIN, **H100)
        assert route in ("cluster", "decode") and route == _plans(c, B), B


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
    """With an opt-in shared memory no decode kernel fits in,
    ``generate_with_fallback``, the server and the CLI (both of its fast
    paths) run the scan sampler; with the H100's restored, the kernel
    route."""
    from wavenet_torch import serve
    from wavenet_torch import train_lib as tl
    from wavenet_torch.cli import generate as cli

    c, params, npz, pfile = _model(tmp_path)
    monkeypatch.setattr(ks, "H100_SMEM_OPTIN", 0)
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

    monkeypatch.undo()
    service = serve.GenerationService(npz, pfile, warm_samples=0,
                                      device="cpu")
    assert "decode_reference" in service.sampler_name
    wave = service.generate(20, seed=1)
    assert np.isfinite(wave).all() and "decode_reference" in (
        service.sampler_name)
