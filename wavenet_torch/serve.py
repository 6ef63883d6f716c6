"""HTTP generation server on the port (counterpart of ``wavenet_tpu/serve.py``).

Loads weights once, warms the sampler, then serves generation requests
with the device serialized behind a lock. The sampler is
``sampler_select.generate_with_fallback``'s, as in the JAX server: with
``--sampler auto`` (or ``pallas``) the decode kernel that the route names,
with ``--sampler scan`` the scan sampler (on the card too); /healthz names
the last one that ran, and every reply names the one that ran for it (a
``"sampler"`` field in JSON, an ``X-Sampler`` header on a wav).

    python -m wavenet_torch.serve --checkpoint LOGDIR \
        --wavenet_params wavenet_params.json [--port 8765] \
        [--sampler auto|pallas|scan] \
        [--gc_channels 32 --gc_cardinality 109] \
        [--draft_checkpoint DRAFT_LOGDIR --speculative_k 8]

Weights come from exactly one of ``--checkpoint`` (a directory of the
train CLI's ``ckpt-STEP/`` checkpoints, the newest restored through
``train_lib.restore_params_only``; none there is a FileNotFoundError, as
in the JAX server) and ``--params_npz`` (an npz of the flat parameter
dict, ``wavenet_torch.params``; the JAX package's params saved with
``np.savez`` load unchanged).

API (stdlib-only server, JSON in / WAV or JSON out):
  GET  /healthz         -> {"status": "ok", "sampler", "sample_rate", "config"}
  POST /generate        {"samples": 16000, "gc_id": 3, "temperature": 0.9,
                         "seed": 7, "lc": [[...], ...], "lc_hop": 200,
                         "lc_upsample": "repeat" | "linear",
                         "format": "wav" | "codes"}
      -> audio/wav, or {"codes": [...], "sampler": ...}
  POST /generate_batch  {"samples": 16000, "batch": 64 | "gc_ids": [...],
                         "temperature": 0.9, "seed": 7,
                         "format": "codes" | "wav_b64"}
      -> {"codes" | "wavs_b64": [...], "sampler": ...}
      B streams from one decode launch. Bounds: batch <= --max_batch
      (default 1024); "codes" responses are capped at CODES_RESPONSE_CAP
      total ints. No "lc" here, as in the JAX server.

Local conditioning (a params file with ``lc_channels``): ``lc`` is a
[frames, lc_channels] array. With ``lc_hop`` the frames are upsampled to
sample rate first (``wavenet_torch.lc.upsample_lc``); without it they must
already be at sample rate. The stream is cropped or edge-extended to the
request, then to its bucket, and decoded by the LC modes of
``sampler_cluster`` and ``sampler_decode``.

Speculative decoding (``--draft_checkpoint``, a directory of the draft's
checkpoints, or ``--draft_params_npz``, an npz of its weights, with ``--draft_wavenet_params`` for its config, default the
target's, and ``--speculative_k``): every /generate runs
``speculative.generate_speculative`` (the draft proposes k codes a
segment, the target verifies them in one window pass; the codes are
distributed as the target's), in plain PyTorch and with no decode kernel,
as the JAX server runs it. An LC model with a draft raises ValueError at
start-up, a scalar-input one NotImplementedError, and /generate_batch
with a draft is a 400, as in the JAX server.
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
    """Weights + warm sampler + device lock."""

    #: /generate_batch JSON "codes" responses are capped at this many
    #: total ints (batch * samples); larger results must use "wav_b64".
    CODES_RESPONSE_CAP = 4 * 1024 * 1024

    def __init__(self, params_npz: Optional[str], wavenet_params: str,
                 gc_channels: Optional[int] = None,
                 gc_cardinality: Optional[int] = None,
                 warm_samples: int = 256, max_batch: int = 1024,
                 draft_params_npz: Optional[str] = None, device=None,
                 draft_wavenet_params: Optional[str] = None,
                 speculative_k: int = 8, checkpoint: Optional[str] = None,
                 sampler: str = "auto",
                 draft_checkpoint: Optional[str] = None):
        from wavenet_torch import resolve_device
        from wavenet_torch.models.config import WaveNetConfig
        from wavenet_torch.sampler_select import sampler_attempts

        if sampler not in SAMPLERS:
            raise ValueError(f"sampler {sampler!r}: one of {SAMPLERS}")
        self.device = resolve_device(device)
        with open(wavenet_params) as f:
            raw = json.load(f)
        self.sample_rate = raw["sample_rate"]
        self.config = WaveNetConfig.from_json(
            raw, gc_channels=gc_channels, gc_cardinality=gc_cardinality)
        self.params = _load_weights(params_npz, checkpoint, self.device,
                                    "")
        self.max_batch = max_batch
        self.sampler = sampler
        # What a b1 request runs; every request then names the sampler it
        # ran.
        first = sampler_attempts(self.config, sampler, device=self.device,
                                 lc=self.config.lc_enabled)
        self.sampler_name = first[0][0] if first else "scan"
        self._lock = threading.Lock()
        # Optional speculative decoding: a draft turns every /generate
        # into draft-propose / target-verify (``speculative.py``).
        self.draft_params = None
        self.draft_config = None
        self.speculative_k = speculative_k
        if draft_params_npz or draft_checkpoint:
            from wavenet_torch.speculative import check_models
            if self.config.lc_enabled:
                raise ValueError(
                    "speculative serving does not support lc-trained "
                    "models (speculative.py carries no feature stream); "
                    "serve without --draft_checkpoint/--draft_params_npz")
            with open(draft_wavenet_params or wavenet_params) as f:
                draw = json.load(f)
            self.draft_config = WaveNetConfig.from_json(
                draw, gc_channels=gc_channels,
                gc_cardinality=gc_cardinality)
            check_models(self.config, self.draft_config)
            self.draft_params = _load_weights(
                draft_params_npz, draft_checkpoint, self.device, "draft ")
            self.sampler_name = f"speculative (k={speculative_k})"
        if warm_samples:
            # An LC model warms on a zero stream.
            warm_lc = (np.zeros((warm_samples, self.config.lc_channels),
                                np.float32)
                       if self.config.lc_enabled else None)
            self.generate(warm_samples,
                          gc_id=0 if self.config.gc_enabled else None,
                          lc=warm_lc)

    @staticmethod
    def bucket_samples(n: int) -> int:
        """Round the request up to the next power-of-two bucket (min 1024);
        the surplus is trimmed after generation."""
        b = 1024
        while b < n:
            b *= 2
        return b

    def _decode(self, n_samples: int, batch: int, gc_ids, temperature,
                seed, lc=None):
        """-> (waveforms [batch, n_samples], the sampler that ran)."""
        from wavenet_torch.audio import mu_law_decode_np
        from wavenet_torch.sampler_select import generate_with_fallback

        if not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        n_bucket = self.bucket_samples(n_samples)
        if self.draft_params is not None:
            return self._decode_speculative(n_samples, n_bucket, gc_ids,
                                            temperature, seed)
        if gc_ids is not None:
            gc_ids = gc_ids.to(self.device)
        with self._lock:
            codes, name, _ = generate_with_fallback(
                self.params, self.config, n_bucket, seed=seed,
                batch_size=batch, gc_ids=gc_ids, temperature=temperature,
                lc=lc, sampler=self.sampler, log=lambda msg: None)
            self.sampler_name = name
            codes = codes[:, :n_samples].cpu().numpy()
        return (mu_law_decode_np(codes, self.config.quantization_channels),
                name)

    def _decode_speculative(self, n_samples: int, n_bucket: int, gc_ids,
                            temperature, seed):
        from wavenet_torch.audio import mu_law_decode_np
        from wavenet_torch.speculative import generate_speculative

        key = torch.Generator(device=self.device).manual_seed(int(seed))
        if gc_ids is not None:
            gc_ids = gc_ids.to(self.device)
        with self._lock:
            codes = generate_speculative(
                self.params, self.config, self.draft_params,
                self.draft_config, n_bucket, key, k=self.speculative_k,
                temperature=temperature, gc_ids=gc_ids,
                draft_gc_ids=gc_ids)
            codes = codes[:, :n_samples].cpu().numpy()
        return (mu_law_decode_np(codes, self.config.quantization_channels),
                self.sampler_name)

    def generate(self, n_samples: int, gc_id: Optional[int] = None,
                 temperature: float = 1.0, seed: int = 0,
                 lc: Optional[np.ndarray] = None,
                 return_sampler: bool = False):
        """-> float waveform [n_samples] in [-1, 1] (with
        ``return_sampler``, also the name of the sampler that ran).

        ``lc``: sample-rate conditioning [n_samples, lc_channels] (the
        handler upsamples frames), required by an LC model; it is
        edge-extended to the bucket, as the request is.
        """
        from wavenet_torch.kernels.sampler import check_lc
        from wavenet_torch.lc import fit_lc_to_length

        c = self.config
        check_lc(c, lc)
        if lc is not None:
            lc = np.asarray(lc, np.float32)
            if lc.ndim != 2 or lc.shape != (n_samples, c.lc_channels):
                raise ValueError(f"lc must be [{n_samples}, "
                                 f"{c.lc_channels}], got {lc.shape}")
            lc = torch.as_tensor(fit_lc_to_length(
                lc, self.bucket_samples(n_samples)))[None]
        gc_ids = None
        if gc_id is not None and c.gc_enabled:
            gc_ids = torch.tensor([int(gc_id)], dtype=torch.int64)
        waves, name = self._decode(n_samples, 1, gc_ids, temperature, seed,
                                   lc)
        return (waves[0], name) if return_sampler else waves[0]

    def generate_batch(self, n_samples: int, batch: Optional[int] = None,
                       gc_ids: Optional[list] = None,
                       temperature: float = 1.0,
                       seed: int = 0, return_sampler: bool = False):
        """-> float waveforms [B, n_samples] in [-1, 1] from one decode
        launch (with ``return_sampler``, also the name of the sampler that
        ran). ``batch`` or ``len(gc_ids)`` sets B; one ``seed`` covers
        the launch and rows draw independent Philox streams. Local
        conditioning is a single-stream feature, refused here as in the
        JAX server, and so is a draft model."""
        if self.draft_params is not None:
            raise ValueError("speculative serving does not support "
                             "batched generation")
        if self.config.lc_enabled:
            raise ValueError("/generate_batch takes no local conditioning; "
                             "send LC requests to /generate")
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
        waves, name = self._decode(n_samples, batch, gc, temperature, seed)
        return (waves, name) if return_sampler else waves


#: The server's ``--sampler`` choices (the JAX server's).
SAMPLERS = ("auto", "pallas", "scan")


def _load_weights(params_npz: Optional[str], checkpoint: Optional[str],
                  device, what: str):
    """The flat params of exactly one of an npz and a checkpoint
    directory (its newest ``ckpt-STEP/``); ``what`` names the model in
    the errors ("" or "draft ")."""
    from wavenet_torch.params import load_npz
    from wavenet_torch.train_lib import restore_params_only

    if (params_npz is None) == (checkpoint is None):
        raise ValueError(f"give exactly one of the {what}checkpoint and "
                         f"the {what}params npz")
    if params_npz is not None:
        return load_npz(params_npz, device)
    params = restore_params_only(checkpoint, device=device)
    if params is None:
        raise FileNotFoundError(f"no {what}checkpoint in {checkpoint}")
    return params


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
                lc = None
                if req.get("lc") is not None:
                    from wavenet_torch.lc import fit_lc_to_length, upsample_lc

                    lc = np.asarray(req["lc"], np.float32)
                    if lc.ndim == 1:
                        lc = lc[:, None]
                    if lc.ndim != 2:
                        raise ValueError(
                            f"lc must be [frames, channels], got shape "
                            f"{lc.shape}")
                    hop = req.get("lc_hop")
                    if hop is not None:
                        lc = upsample_lc(
                            lc, int(hop),
                            mode=req.get("lc_upsample", "repeat"))
                    lc = fit_lc_to_length(lc, n)
                wave, sampler = service.generate(
                    n, gc_id=req.get("gc_id"),
                    temperature=float(req.get("temperature", 1.0)),
                    seed=int(req.get("seed", 0)), lc=lc,
                    return_sampler=True)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if req.get("format", "wav") == "codes":
                self._json(200, {"codes": mu_law_encode_np(wave, Q).tolist(),
                                 "sampler": sampler})
                return
            body = _wav_bytes(wave, service.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Sampler", sampler)
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
                waves, sampler = service.generate_batch(
                    n, batch=batch, gc_ids=gc_ids,
                    temperature=float(req.get("temperature", 1.0)),
                    seed=int(req.get("seed", 0)), return_sampler=True)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if req.get("format", "codes") == "wav_b64":
                self._json(200, {"wavs_b64": [
                    base64.b64encode(
                        _wav_bytes(w, service.sample_rate)).decode()
                    for w in waves], "sampler": sampler})
                return
            self._json(200, {"codes": mu_law_encode_np(waves, Q).tolist(),
                             "sampler": sampler})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description="WaveNet generation server "
                                             "(PyTorch/CUDA port)")
    weights = ap.add_mutually_exclusive_group(required=True)
    weights.add_argument("--checkpoint", default=None,
                         help="Directory of the train CLI's ckpt-STEP "
                              "checkpoints (the newest is served).")
    weights.add_argument("--params_npz", default=None,
                         help="npz of the flat parameter dict")
    ap.add_argument("--wavenet_params", default="./wavenet_params.json")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--gc_channels", type=int, default=None)
    ap.add_argument("--gc_cardinality", type=int, default=None)
    ap.add_argument("--sampler", default="auto", choices=SAMPLERS,
                    help="auto/pallas: the decode kernel the route names "
                         "(the scan sampler where it names none); scan: "
                         "the scan sampler.")
    ap.add_argument("--max_batch", type=int, default=1024,
                    help="Largest /generate_batch batch accepted "
                         "(requests past it get a 400).")
    draft = ap.add_mutually_exclusive_group()
    draft.add_argument("--draft_checkpoint", default=None,
                       help="Directory of a draft model's checkpoints: "
                            "serve with speculative decoding "
                            "(target-exact distribution).")
    draft.add_argument("--draft_params_npz", default=None,
                       help="npz of a draft model's weights, in place of "
                            "--draft_checkpoint.")
    ap.add_argument("--draft_wavenet_params", default=None,
                    help="Model params JSON of the draft (defaults to "
                         "--wavenet_params).")
    ap.add_argument("--speculative_k", type=int, default=8,
                    help="Draft proposals per verify pass.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch decode)")
    args = ap.parse_args(argv)

    print("Loading + warming model...")
    service = GenerationService(
        args.params_npz, args.wavenet_params, args.gc_channels,
        args.gc_cardinality, max_batch=args.max_batch, device=args.device,
        draft_params_npz=args.draft_params_npz,
        draft_wavenet_params=args.draft_wavenet_params,
        speculative_k=args.speculative_k, checkpoint=args.checkpoint,
        sampler=args.sampler, draft_checkpoint=args.draft_checkpoint)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    print(f"Serving on http://{args.host}:{args.port} "
          f"({service.sampler_name} sampler)")
    server.serve_forever()


if __name__ == "__main__":
    main()
