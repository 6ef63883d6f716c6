"""HTTP generation server on the port (counterpart of ``wavenet_tpu/serve.py``).

Loads weights once, warms the decode kernel, then serves generation
requests with the device serialized behind a lock.

    python -m wavenet_torch.serve --params_npz params.npz \
        --wavenet_params wavenet_params.json [--port 8765] \
        [--gc_channels 32 --gc_cardinality 109]

Weights are an npz of the flat parameter dict (``wavenet_torch.params``;
the JAX package's params saved with ``np.savez`` load unchanged).

API (stdlib-only server, JSON in / WAV or JSON out):
  GET  /healthz         -> {"status": "ok", "sampler", "sample_rate", "config"}
  POST /generate        {"samples": 16000, "gc_id": 3, "temperature": 0.9,
                         "seed": 7, "format": "wav" | "codes"}
  POST /generate_batch  {"samples": 16000, "batch": 64 | "gc_ids": [...],
                         "temperature": 0.9, "seed": 7,
                         "format": "codes" | "wav_b64"}
      B streams from one decode launch. Bounds: batch <= --max_batch
      (default 1024); "codes" responses are capped at CODES_RESPONSE_CAP
      total ints.

Local conditioning, speculative decoding and scalar-input models are not
ported yet (ROADMAP.md) and raise NotImplementedError at start-up.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch


class GenerationService:
    """Weights + warm decode kernel + device lock."""

    #: /generate_batch JSON "codes" responses are capped at this many
    #: total ints (batch * samples); larger results must use "wav_b64".
    CODES_RESPONSE_CAP = 4 * 1024 * 1024

    def __init__(self, params_npz: str, wavenet_params: str,
                 gc_channels: Optional[int] = None,
                 gc_cardinality: Optional[int] = None,
                 warm_samples: int = 256, max_batch: int = 1024,
                 draft_params_npz: Optional[str] = None, device=None):
        from wavenet_torch import resolve_device
        from wavenet_torch.models.config import WaveNetConfig
        from wavenet_torch.params import load_npz
        from wavenet_torch.sampler_select import sampler_name

        self.device = resolve_device(device)
        with open(wavenet_params) as f:
            raw = json.load(f)
        self.sample_rate = raw["sample_rate"]
        self.config = WaveNetConfig.from_json(
            raw, gc_channels=gc_channels, gc_cardinality=gc_cardinality)
        if self.config.lc_enabled:
            raise NotImplementedError(
                "local conditioning is not ported yet (ROADMAP.md, 'LC in "
                "sampler_decode')")
        if self.config.scalar_input:
            raise NotImplementedError(
                "scalar-input models are not ported yet (ROADMAP.md, "
                "'scalar input in sampler_decode')")
        if draft_params_npz:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md queue "
                "1, item 7)")
        self.params = load_npz(params_npz, self.device)
        self.max_batch = max_batch
        self.sampler_name = sampler_name(self.device)
        self._lock = threading.Lock()
        if warm_samples:
            self.generate(warm_samples,
                          gc_id=0 if self.config.gc_enabled else None)

    @staticmethod
    def bucket_samples(n: int) -> int:
        """Round the request up to the next power-of-two bucket (min 1024);
        the surplus is trimmed after generation."""
        b = 1024
        while b < n:
            b *= 2
        return b

    def _decode(self, n_samples: int, batch: int, gc_ids, temperature,
                seed) -> np.ndarray:
        from wavenet_torch.audio import mu_law_decode_np
        from wavenet_torch.kernels.sampler import generate_cuda

        if not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        n_bucket = self.bucket_samples(n_samples)
        with self._lock:
            codes = generate_cuda(
                self.params, self.config, n_bucket, seed=seed,
                batch_size=batch, gc_ids=gc_ids, temperature=temperature,
                prefill=True)
            codes = codes[:, :n_samples].cpu().numpy()
        return mu_law_decode_np(codes, self.config.quantization_channels)

    def generate(self, n_samples: int, gc_id: Optional[int] = None,
                 temperature: float = 1.0, seed: int = 0,
                 lc: Optional[np.ndarray] = None) -> np.ndarray:
        """-> float waveform [n_samples] in [-1, 1]."""
        if lc is not None:
            raise ValueError("this model was not trained with local "
                             "conditioning (no lc_channels in config)")
        gc_ids = None
        if gc_id is not None and self.config.gc_enabled:
            gc_ids = torch.tensor([int(gc_id)], dtype=torch.int64)
        return self._decode(n_samples, 1, gc_ids, temperature, seed)[0]

    def generate_batch(self, n_samples: int, batch: Optional[int] = None,
                       gc_ids: Optional[list] = None,
                       temperature: float = 1.0,
                       seed: int = 0) -> np.ndarray:
        """-> float waveforms [B, n_samples] in [-1, 1] from one decode
        launch. ``batch`` or ``len(gc_ids)`` sets B; one ``seed`` covers
        the launch and rows draw independent Philox streams."""
        if batch is not None:
            batch = int(batch)
        if gc_ids is not None:
            if not self.config.gc_enabled:
                raise ValueError("this model was not trained with global "
                                 "conditioning (no gc_channels in config)")
            if batch is not None and batch != len(gc_ids):
                raise ValueError(f"batch {batch} != len(gc_ids) "
                                 f"{len(gc_ids)}")
            batch = len(gc_ids)
        if batch is None or batch < 1:
            raise ValueError("generate_batch needs batch >= 1 or gc_ids")
        if batch > self.max_batch:
            raise ValueError(f"batch {batch} exceeds the server's "
                             f"--max_batch {self.max_batch}")
        gc = (torch.tensor([int(g) for g in gc_ids], dtype=torch.int64)
              if gc_ids is not None else None)
        return self._decode(n_samples, batch, gc, temperature, seed)


def _wav_bytes(waveform: np.ndarray, sample_rate: int) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sample_rate,
                  (np.clip(waveform, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def make_handler(service: GenerationService):
    from wavenet_torch.audio import mu_law_encode_np

    Q = service.config.quantization_channels

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _request(self):
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            n = int(req.get("samples", service.sample_rate))
            if not 1 <= n <= 10 * 60 * service.sample_rate:
                raise ValueError(f"samples out of range: {n}")
            return req, n

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "sampler": service.sampler_name,
                    "sample_rate": service.sample_rate,
                    "config": service.config.to_json_dict(),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/generate_batch":
                self._generate_batch()
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                req, n = self._request()
                wave = service.generate(
                    n, gc_id=req.get("gc_id"),
                    temperature=float(req.get("temperature", 1.0)),
                    seed=int(req.get("seed", 0)), lc=req.get("lc"))
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if req.get("format", "wav") == "codes":
                self._json(200, {"codes": mu_law_encode_np(wave, Q).tolist()})
                return
            body = _wav_bytes(wave, service.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _generate_batch(self):
            try:
                req, n = self._request()
                batch = req.get("batch")
                if batch is not None:
                    batch = int(batch)
                gc_ids = req.get("gc_ids")
                # Response-size cap, checked before generating.
                b_eff = len(gc_ids) if gc_ids is not None else (batch or 1)
                if (req.get("format", "codes") == "codes"
                        and b_eff * n > service.CODES_RESPONSE_CAP):
                    raise ValueError(
                        f"codes response would carry {b_eff * n} ints "
                        f"(cap {service.CODES_RESPONSE_CAP}); use "
                        '"format": "wav_b64" or request fewer '
                        "samples/streams")
                waves = service.generate_batch(
                    n, batch=batch, gc_ids=gc_ids,
                    temperature=float(req.get("temperature", 1.0)),
                    seed=int(req.get("seed", 0)))
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if req.get("format", "codes") == "wav_b64":
                self._json(200, {"wavs_b64": [
                    base64.b64encode(
                        _wav_bytes(w, service.sample_rate)).decode()
                    for w in waves]})
                return
            self._json(200, {"codes": mu_law_encode_np(waves, Q).tolist()})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description="WaveNet generation server "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--params_npz", required=True,
                    help="npz of the flat parameter dict")
    ap.add_argument("--wavenet_params", default="./wavenet_params.json")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--gc_channels", type=int, default=None)
    ap.add_argument("--gc_cardinality", type=int, default=None)
    ap.add_argument("--max_batch", type=int, default=1024,
                    help="Largest /generate_batch batch accepted "
                         "(requests past it get a 400).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch decode)")
    args = ap.parse_args(argv)

    print("Loading + warming model...")
    service = GenerationService(args.params_npz, args.wavenet_params,
                                args.gc_channels, args.gc_cardinality,
                                max_batch=args.max_batch, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    print(f"Serving on http://{args.host}:{args.port} "
          f"({service.sampler_name} sampler)")
    server.serve_forever()


if __name__ == "__main__":
    main()
