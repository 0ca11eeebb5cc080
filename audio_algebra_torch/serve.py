"""MIRAGE serving: a dependency-free HTTP endpoint around the port's CLAPDAE.

    python -m audio_algebra_torch.serve [--host 127.0.0.1] [--port 8950]
        [--model 22s|66s] [--no-half] [--max-batch 8]

Port of the embedding path of audio_algebra_tpu/serve.py: a stdlib
ThreadingHTTPServer wrapping one warm CLAPDAE on the card, with requests
serialised onto it by a lock.

Endpoints:
  GET  /health    -> {"ok": true, "model": "22s", "sample_size": N, ...}
  POST /generate  -> JSON spec -> 16-bit PCM WAV bytes (48 kHz stereo)
  POST /embed     -> 501: CLAP is not ported yet

Generate spec (at least one embedding):
  {"embeddings": [[...512 floats]],    # precomputed unit CLAP embeddings
   "weights": [1.0, -0.5],             # algebra weights (with "algebra")
   "algebra": false,                   # weighted sum vs slerp combine
   "interp": 0.5,                      # slerp t between prompts
   "cfg_scale": 4.0, "steps": 150, "outer_steps": 100,
   "batch_size": 1, "seed": -1,
   "init_audio_b64": "<base64 WAV/MP3>",   # img2img init (loop-repeated)
   "init_strength": 0.4}

A `text` prompt, like POST /embed, is answered 501 with the message that
CLAP is not ported yet (ROADMAP.md section A, item 12). The request
micro-batcher, the HTML GUI, basic auth and the multi-chip mesh of the JAX
service are not ported.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .embedding_math import interp_embeddings, weighted_algebra
from .given_models import CLAP_NOT_PORTED, CLAPDAE
from .utils.audio_io import crossfade_flatten, load_audio

__all__ = ["MirageService", "encode_wav", "make_server", "main"]

SAMPLE_RATE = 48000


def encode_wav(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    """(C, N) float audio -> 16-bit PCM WAV bytes."""
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[None]
    pcm = (np.clip(a, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())           # interleave channels
    return buf.getvalue()


def _decode_audio_bytes(data: bytes) -> np.ndarray:
    """Posted WAV or MP3 bytes -> (C, N) float32 at 48 kHz."""
    suffix = ".wav" if data[:4] == b"RIFF" else ".mp3"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(data)
        path = f.name
    try:
        return load_audio(path, sr=SAMPLE_RATE)
    finally:
        os.unlink(path)


class MirageService:
    """One warm model and a lock. `model` is injectable (any object with
    .generate, .encode_audio_latents, .generator and .sample_size); by
    default a CLAPDAE with seeded random weights, set up for
    `model_choice` and cast to bf16 unless `half` is False."""

    def __init__(self, model=None, model_choice: str = "22s", half: bool = True,
                 verbose: bool = True, max_batch: int = 8,
                 device: str | torch.device = "cuda"):
        if model is None:
            model = CLAPDAE(device=device).setup(model_choice)
            if half:
                model.half()
        self.model = model
        self.model_choice = model_choice
        self.verbose = verbose
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.requests_served = 0

    def _init_latents_from_bytes(self, data: bytes):
        """Decode audio bytes, loop-repeat to sample_size, encode to
        stage-2 latents."""
        audio = _decode_audio_bytes(data)
        if audio.shape[0] == 1:
            audio = np.concatenate([audio, audio], axis=0)
        need = int(self.model.sample_size)
        looped = np.tile(audio, (1, int(np.ceil(need / audio.shape[-1]))))[:, :need]
        with self.lock:
            return self.model.encode_audio_latents(looped[None])

    def generate_wav(self, spec: dict) -> tuple[bytes, dict]:
        """Combine the embeddings, generate, crossfade; returns
        (wav_bytes, info). Raises ValueError on a bad spec and
        NotImplementedError on a text prompt."""
        texts = spec.get("text") or []
        if isinstance(texts, str):
            texts = [texts]
        if any(texts):
            raise NotImplementedError(CLAP_NOT_PORTED)
        embeddings = [np.asarray(e, np.float32).reshape(1, 1, -1)
                      for e in spec.get("embeddings") or []]
        if not embeddings:
            raise ValueError("no prompt: supply 'embeddings'")
        if len(embeddings) == 1:
            emb = torch.from_numpy(embeddings[0])
        elif spec.get("algebra"):
            emb = weighted_algebra(embeddings, spec.get("weights") or [1.0] * len(embeddings))
        else:
            t = float(spec.get("interp", 0.5))
            emb = interp_embeddings(embeddings[0], embeddings[1], t)
            for extra in embeddings[2:]:
                emb = interp_embeddings(emb, extra, t)

        # the ranges of the JAX service (reference GUI sliders, with headroom)
        seed = int(spec.get("seed", -1))
        steps = int(spec.get("steps", 150))
        outer_steps = int(spec.get("outer_steps", 100))
        cfg_scale = float(spec.get("cfg_scale", 4.0))
        batch_size = int(spec.get("batch_size", 1))
        if not 1 <= steps <= 500:
            raise ValueError(f"steps={steps} out of range [1, 500]")
        if not 1 <= outer_steps <= 500:
            raise ValueError(f"outer_steps={outer_steps} out of range [1, 500]")
        if not 1 <= batch_size <= self.max_batch:
            raise ValueError(f"batch_size={batch_size} out of range [1, {self.max_batch}]")
        if not (np.isfinite(cfg_scale) and -100.0 <= cfg_scale <= 100.0):
            raise ValueError(f"cfg_scale={cfg_scale} out of range")

        init_latents = None
        if spec.get("init_audio_b64"):
            init_latents = self._init_latents_from_bytes(
                base64.b64decode(spec["init_audio_b64"]))
        with self.lock:
            if seed >= 0:
                self.model.generator.manual_seed(seed)
            fakes, _ = self.model.generate(
                emb, cfg_scales=cfg_scale, demo_steps=steps, outer_steps=outer_steps,
                batch_size=batch_size, init_audio_latents=init_latents,
                init_strength=float(spec.get("init_strength", 0.4)), flatten=False)
            fakes = fakes.float().cpu().numpy()
        with self._stats_lock:
            self.requests_served += 1
        out = crossfade_flatten(fakes, sr=SAMPLE_RATE)
        info = {"batch_size": batch_size, "samples": int(out.shape[-1]),
                "sample_rate": SAMPLE_RATE}
        return encode_wav(out, SAMPLE_RATE), info

    def health(self) -> dict:
        return {"ok": True, "model": self.model_choice,
                "sample_size": int(getattr(self.model, "sample_size", 0)),
                "requests_served": self.requests_served,
                "device": str(getattr(self.model, "device", "")),
                "text_prompts": CLAP_NOT_PORTED}


def _make_handler(service: MirageService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            if service.verbose:
                super().log_message(fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path.rstrip("/") == "/health":
                self._send_json(200, service.health())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            data = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            try:
                if self.path == "/embed":
                    raise NotImplementedError(CLAP_NOT_PORTED)
                if self.path != "/generate":
                    self._send_json(404, {"error": f"no route {self.path}"})
                    return
                wav, info = service.generate_wav(json.loads(data or b"{}"))
                self._send(200, wav, "audio/wav",
                           [("X-Generate-Info", json.dumps(info))])
            except NotImplementedError as e:
                self._send_json(501, {"error": "not_ported", "detail": str(e)})
            except (ValueError, KeyError) as e:
                self._send_json(400, {"error": str(e)})
            except Exception as e:             # keep serving; report the fault
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(service: MirageService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = an ephemeral one); the caller runs .serve_forever()."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description="MIRAGE HTTP serving endpoint (PyTorch port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8950)
    p.add_argument("--model", choices=["22s", "66s"], default="22s")
    p.add_argument("--no-half", action="store_true", help="serve in f32 (default bf16)")
    p.add_argument("--max-batch", type=int, default=8)
    args = p.parse_args(argv)
    service = MirageService(model_choice=args.model, half=not args.no_half,
                            max_batch=args.max_batch)
    server = make_server(service, args.host, args.port)
    print(f"serve: MIRAGE ({args.model}) listening on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
