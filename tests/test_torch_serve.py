"""wavenet_torch serving on the CPU: the real HTTP server over a tiny npz.

Mirrors the cases of tests/test_serve.py that the port supports. On the
CPU the service decodes with ``decode_reference`` (the kernel's plain
version), because the tensors lie there; on a GPU the same calls launch
the ``sampler_decode`` kernel.
"""

import base64
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import init_params
from wavenet_torch.params import save_npz
from wavenet_torch.serve import GenerationService, make_handler

# One intra-op thread: pytest-xdist runs several workers side by side, and
# each would otherwise start a thread per core whose spin-waits starve
# the other workers.
torch.set_num_threads(1)

TINY = dict(dilations=(1, 2, 4), residual_channels=4, dilation_channels=4,
            skip_channels=8, quantization_channels=32, sample_rate=2000)


def _write(tmp, cfg, name="m"):
    params_path = tmp / f"{name}.json"
    params_path.write_text(json.dumps(cfg.to_json_dict()))
    npz = tmp / f"{name}.npz"
    # Seeded non-zero biases, as a trained checkpoint has.
    params = init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for k in sorted(params):
        if k.endswith("_bias"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    save_npz(str(npz), params)
    return str(npz), str(params_path)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    npz, js = _write(tmp, WaveNetConfig(**TINY))
    return GenerationService(npz, js, warm_samples=8, device="cpu")


@pytest.fixture(scope="module")
def server(service):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=60)
        return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert "decode_reference" in body["sampler"]
    assert body["sample_rate"] == 2000
    assert body["config"] == WaveNetConfig(**TINY).to_json_dict()


def test_generate_wav(server):
    status, ctype, body = _post(server + "/generate",
                                {"samples": 64, "seed": 3})
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF"
    assert len(body) == 44 + 128          # 44-byte header + 64 int16


def test_generate_codes_deterministic(server):
    s1, _, b1 = _post(server + "/generate",
                      {"samples": 32, "seed": 5, "format": "codes"})
    s2, _, b2 = _post(server + "/generate",
                      {"samples": 32, "seed": 5, "format": "codes"})
    s3, _, b3 = _post(server + "/generate",
                      {"samples": 32, "seed": 6, "format": "codes"})
    assert s1 == s2 == s3 == 200
    c1, c2 = json.loads(b1)["codes"], json.loads(b2)["codes"]
    assert c1 == c2 and len(c1) == 32
    assert c1 != json.loads(b3)["codes"]
    assert all(0 <= c < 32 for c in c1)


def test_generate_bad_request(server):
    status, _, body = _post(server + "/generate", {"samples": -5})
    assert status == 400 and "error" in json.loads(body)
    status, _, body = _post(server + "/generate",
                            {"samples": 16, "lc": [[0.0]]})
    assert status == 400
    assert "not trained with local" in json.loads(body)["error"]
    for path in ("/generate", "/generate_batch"):
        status, _, body = _post(server + path, {"samples": 16, "batch": 1,
                                                "temperature": 0})
        assert status == 400 and "temperature" in json.loads(body)["error"]
    status, _, _ = _post(server + "/nope", {})
    assert status == 404


def test_generate_batch_codes_and_determinism(server):
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16, "batch": 3, "seed": 5})
    assert status == 200
    codes = json.loads(body)["codes"]
    assert len(codes) == 3 and all(len(c) == 16 for c in codes)
    status2, _, body2 = _post(server + "/generate_batch",
                              {"samples": 16, "batch": 3, "seed": 5})
    assert status2 == 200 and json.loads(body2)["codes"] == codes


def test_generate_batch_rows_match_single_stream(service):
    """Philox keyed per row: row 0 of a batch is the b1 stream of the same
    seed (the seed codes' random first code is drawn per row too)."""
    one = service.generate(20, seed=9)
    batch = service.generate_batch(20, batch=3, seed=9)
    np.testing.assert_array_equal(batch[0], one)


def test_generate_batch_wav_b64(server):
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16, "batch": 2,
                             "format": "wav_b64"})
    assert status == 200
    wavs = json.loads(body)["wavs_b64"]
    assert len(wavs) == 2
    raw = base64.b64decode(wavs[0])
    assert raw[:4] == b"RIFF" and len(raw) == 44 + 2 * 16


def test_generate_batch_bad_requests(server):
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16, "gc_ids": [1, 2]})
    assert status == 400
    assert "global conditioning" in json.loads(body)["error"]
    status, _, _ = _post(server + "/generate_batch", {"samples": 16})
    assert status == 400
    status, _, _ = _post(server + "/generate_batch",
                         {"samples": 16, "batch": 3, "gc_ids": [1]})
    assert status == 400


def test_generate_batch_bounds(server):
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16, "batch": 100000})
    assert status == 400 and "max_batch" in json.loads(body)["error"]
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16, "batch": "2"})
    assert status == 200 and len(json.loads(body)["codes"]) == 2
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16000, "batch": 300})
    assert status == 400 and "wav_b64" in json.loads(body)["error"]


def test_bucket_samples():
    assert [GenerationService.bucket_samples(n)
            for n in (1, 1024, 1025, 16000)] == [1024, 1024, 2048, 16384]


def test_gc_service_steers_output(tmp_path):
    cfg = WaveNetConfig(**TINY, gc_channels=4, gc_cardinality=3)
    npz, js = _write(tmp_path, cfg)
    svc = GenerationService(npz, js, gc_channels=4, gc_cardinality=3,
                            warm_samples=0, device="cpu")
    # Both rows draw the same Philox noise; the small GC term changes an
    # argmax only now and then (first at sample 30 with these weights).
    a = svc.generate(256, gc_id=0, seed=1)
    b = svc.generate(256, gc_id=2, seed=1)
    assert a.shape == (256,) and np.all(np.abs(a) <= 1.0)
    assert not np.array_equal(a, b)
    rows = svc.generate_batch(256, gc_ids=[0, 2], seed=1)
    np.testing.assert_array_equal(rows[0], a)


def test_scalar_service_serves(tmp_path):
    """A scalar-input model: the seed is silence amplitudes, the decode
    feeds back decoded amplitudes, the output is mu-law codes."""
    cfg = WaveNetConfig(**TINY, scalar_input=True, initial_filter_width=4)
    npz, js = _write(tmp_path, cfg)
    svc = GenerationService(npz, js, warm_samples=8, device="cpu")
    a = svc.generate(64, seed=3)
    assert a.shape == (64,) and np.all(np.abs(a) <= 1.0)
    assert len(np.unique(a)) > 4
    np.testing.assert_array_equal(svc.generate(64, seed=3), a)
    rows = svc.generate_batch(64, batch=3, seed=3)
    assert rows.shape == (3, 64)
    np.testing.assert_array_equal(rows[0], a)


# A draft model: the JAX server's errors, with its exception types (LC is
# refused before the draft is read, as there).
@pytest.mark.parametrize("extra,exc", [
    ({"lc_channels": 2}, ValueError),
    ({"scalar_input": True, "lc_channels": 2}, ValueError),
    ({"scalar_input": True, "initial_filter_width": 4}, NotImplementedError)])
def test_draft_refusals_match_jax(tmp_path, extra, exc):
    npz, js = _write(tmp_path, WaveNetConfig(**{**TINY, **extra}))
    with pytest.raises(exc, match="speculative"):
        GenerationService(npz, js, warm_samples=0, device="cpu",
                          draft_params_npz=npz)


def test_speculative_service(tmp_path):
    """A draft npz (draft == target) turns /generate into speculative
    decoding: well-formed wav and codes, deterministic per seed;
    /generate_batch refuses a draft model."""
    npz, js = _write(tmp_path, WaveNetConfig(**TINY))
    svc = GenerationService(npz, js, warm_samples=8, device="cpu",
                            draft_params_npz=npz, speculative_k=3)
    assert svc.sampler_name == "speculative (k=3)"
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["sampler"] == "speculative (k=3)"
        status, ctype, body = _post(url + "/generate",
                                    {"samples": 20, "seed": 4})
        assert status == 200 and ctype == "audio/wav"
        assert len(body) == 44 + 2 * 20
        s1, _, b1 = _post(url + "/generate",
                          {"samples": 24, "seed": 4, "format": "codes"})
        s2, _, b2 = _post(url + "/generate",
                          {"samples": 24, "seed": 4, "format": "codes"})
        assert s1 == s2 == 200
        codes = json.loads(b1)["codes"]
        assert codes == json.loads(b2)["codes"] and len(codes) == 24
        assert all(0 <= c < 32 for c in codes)
        status, _, body = _post(url + "/generate_batch",
                                {"samples": 16, "batch": 2})
        assert status == 400
        assert "speculative" in json.loads(body)["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# --checkpoint, --sampler and --draft_checkpoint (tests/test_serve.py's
# service from a saved checkpoint on the scan sampler)
# ---------------------------------------------------------------------------

def _checkpoint(tmp, cfg, name="ckpt", step=2):
    """A train-CLI checkpoint directory (``ckpt-<step>/``) of the seeded
    weights ``_write`` saves, and the params JSON."""
    from wavenet_torch import train_lib as tl
    from wavenet_torch.params import load_npz

    npz, js = _write(tmp, cfg, name)
    state = tl.train_state_from_params(load_npz(npz, "cpu"),
                                       tl.make_optimizer("adam", 1e-3),
                                       step=step)
    tl.save_checkpoint(str(tmp / name), state)
    return str(tmp / name), js, npz


@pytest.fixture(scope="module")
def scan_server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve_ckpt")
    ckpt, js, npz = _checkpoint(tmp, WaveNetConfig(**TINY))
    svc = GenerationService(None, js, checkpoint=ckpt, sampler="scan",
                            warm_samples=8, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}", npz
    httpd.shutdown()
    httpd.server_close()


def test_checkpoint_scan_healthz_and_replies(scan_server):
    svc, url, _ = scan_server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["sampler"] == "scan"
    status, _, body = _post(url + "/generate",
                            {"samples": 24, "seed": 5, "format": "codes"})
    assert status == 200
    reply = json.loads(body)
    assert reply["sampler"] == "scan" and len(reply["codes"]) == 24
    status, _, body = _post(url + "/generate_batch",
                            {"samples": 16, "batch": 2, "seed": 5})
    assert status == 200 and json.loads(body)["sampler"] == "scan"
    req = urllib.request.Request(
        url + "/generate", data=json.dumps({"samples": 16}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers.get("X-Sampler") == "scan"
        assert resp.read()[:4] == b"RIFF"


def test_checkpoint_scan_is_the_scan_sampler_on_the_saved_weights(
        scan_server):
    """The served codes are ``sample.generate``'s on the checkpoint's
    weights with the seed's generator (over the bucket, then trimmed)."""
    from wavenet_torch.audio import mu_law_encode_np
    from wavenet_torch.params import load_npz
    from wavenet_torch.sample import generate

    svc, _, npz = scan_server
    wave, name = svc.generate(40, seed=7, return_sampler=True)
    assert name == "scan"
    cfg = WaveNetConfig(**TINY)
    ref = generate(load_npz(npz, "cpu"), cfg,
                   GenerationService.bucket_samples(40),
                   torch.Generator().manual_seed(7))[0, :40].numpy()
    np.testing.assert_array_equal(mu_law_encode_np(wave, 32), ref)


def test_reply_names_the_routed_sampler(server, service):
    status, _, body = _post(server + "/generate",
                            {"samples": 16, "seed": 1, "format": "codes"})
    assert status == 200
    assert "decode_reference" in json.loads(body)["sampler"]
    status, _, body = _post(server + "/generate_batch",
                            {"samples": 16, "batch": 2,
                             "format": "wav_b64"})
    assert status == 200
    assert json.loads(body)["sampler"] == service.sampler_name


@pytest.mark.parametrize("sampler", ["auto", "pallas"])
def test_checkpoint_kernel_samplers_equal_the_npz_service(tmp_path, sampler,
                                                          service):
    """auto and pallas route to the decode kernel (its plain version on
    the CPU) and serve the npz service's codes from the same weights."""
    ckpt, js, _ = _checkpoint(tmp_path, WaveNetConfig(**TINY))
    svc = GenerationService(None, js, checkpoint=ckpt, sampler=sampler,
                            warm_samples=0, device="cpu")
    wave, name = svc.generate(32, seed=5, return_sampler=True)
    assert name == service.sampler_name and "decode_reference" in name
    np.testing.assert_array_equal(wave, service.generate(32, seed=5))


def test_missing_checkpoint_refused(tmp_path):
    _, js = _write(tmp_path, WaveNetConfig(**TINY))
    with pytest.raises(FileNotFoundError, match="no checkpoint in"):
        GenerationService(None, js, checkpoint=str(tmp_path / "empty"),
                          warm_samples=0, device="cpu")


def test_weights_from_exactly_one_source(tmp_path):
    ckpt, js, npz = _checkpoint(tmp_path, WaveNetConfig(**TINY))
    with pytest.raises(ValueError, match="exactly one"):
        GenerationService(npz, js, checkpoint=ckpt, warm_samples=0,
                          device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        GenerationService(None, js, warm_samples=0, device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        GenerationService(npz, js, sampler="fast", warm_samples=0,
                          device="cpu")


def test_main_requires_one_weight_flag(tmp_path):
    from wavenet_torch.serve import main

    ckpt, js, npz = _checkpoint(tmp_path, WaveNetConfig(**TINY))
    with pytest.raises(SystemExit):
        main(["--wavenet_params", js, "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--checkpoint", ckpt, "--params_npz", npz,
              "--wavenet_params", js, "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--checkpoint", ckpt, "--sampler", "fast",
              "--wavenet_params", js, "--device", "cpu"])


def test_draft_checkpoint_serves_speculative(tmp_path):
    """--draft_checkpoint is the draft's counterpart of --checkpoint: the
    same speculative service as a draft npz of the same weights."""
    ckpt, js, npz = _checkpoint(tmp_path, WaveNetConfig(**TINY))
    svc = GenerationService(None, js, checkpoint=ckpt,
                            draft_checkpoint=ckpt, speculative_k=3,
                            warm_samples=0, device="cpu")
    wave, name = svc.generate(24, seed=4, return_sampler=True)
    assert name == "speculative (k=3)"
    ref = GenerationService(npz, js, draft_params_npz=npz, speculative_k=3,
                            warm_samples=0, device="cpu")
    np.testing.assert_array_equal(wave, ref.generate(24, seed=4))
    with pytest.raises(FileNotFoundError, match="no draft checkpoint in"):
        GenerationService(None, js, checkpoint=ckpt,
                          draft_checkpoint=str(tmp_path / "none"),
                          warm_samples=0, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        GenerationService(None, js, checkpoint=ckpt, draft_checkpoint=ckpt,
                          draft_params_npz=npz, warm_samples=0,
                          device="cpu")


def test_draft_checkpoint_refused_for_lc(tmp_path):
    """An LC model with a draft checkpoint: the JAX server's ValueError,
    before the draft is read."""
    ckpt, js, _ = _checkpoint(tmp_path, WaveNetConfig(**TINY, lc_channels=2))
    with pytest.raises(ValueError, match="speculative"):
        GenerationService(None, js, checkpoint=ckpt,
                          draft_checkpoint=str(tmp_path / "none"),
                          warm_samples=0, device="cpu")
