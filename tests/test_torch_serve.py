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


@pytest.mark.parametrize("extra", [{"lc_channels": 2},
                                   {"scalar_input": True}])
def test_unported_models_raise(tmp_path, extra):
    cfg = WaveNetConfig(**{**TINY, **extra})
    js = tmp_path / "m.json"
    js.write_text(json.dumps(cfg.to_json_dict()))
    npz = tmp_path / "m.npz"
    np.savez(str(npz), dummy=np.zeros(1, np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationService(str(npz), str(js), warm_samples=0, device="cpu")


def test_speculative_is_not_ported(tmp_path):
    npz, js = _write(tmp_path, WaveNetConfig(**TINY))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationService(npz, js, warm_samples=0, device="cpu",
                          draft_params_npz=npz)
