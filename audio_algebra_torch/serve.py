"""MIRAGE serving: a dependency-free HTTP endpoint around the port's CLAPDAE.

    python -m audio_algebra_torch.serve [--host 127.0.0.1] [--port 8950]
        [--model 22s|66s] [--no-half] [--batch-window 0.05] [--max-batch 8]
        [--warmup] [--strict-text] [--turbo] [--mesh seq=N] [--device cuda]

Port of audio_algebra_tpu/serve.py: a stdlib ThreadingHTTPServer wrapping
one warm CLAPDAE on the card (embedding_math.get_model_ready's), with
requests serialised onto it by a lock. Concurrent single-variation
requests whose (steps, outer_steps, cfg_scale) agree are coalesced into one
generate call by a micro-batcher (`--batch-window` seconds; 0 turns it
off). With MIRAGE_USERNAME and MIRAGE_PASSWORD set, every route but
/health asks for basic auth (401 without it). `--turbo` serves the
turbo CLAPDAE (`MirageService(turbo=True)`; JAX's flag sets
AA_TURBO_INT8=1). Every generate's outer stage and AE decode run in
micro-batches of AA_MIRAGE_DECODE_BATCH rows when it is set, as JAX's
service does (`CLAPDAE(decode_batch=)`, default 4), whatever --max-batch
coalesces; under `--turbo` a micro-batch of 16 or more takes the amax
carry, a smaller one int8 inside the fold. A service is all-turbo or
all-bf16, as JAX's; `--turbo` with `--mesh` is refused.

`--mesh seq=N` runs each generate's outer stage sequence-parallel over N
processes, one a card (`CLAPDAE.generate_seqpar`):

    torchrun --nproc_per_node N -m audio_algebra_torch.serve --mesh seq=N ...

JAX serves the mesh from one process; torch runs N. Rank 0 serves HTTP;
ranks above 0 run a follower loop (`MirageService.follow`): for each
generate, rank 0 broadcasts its arguments and the inner stage's noise
(`_SeqparChannel`), every rank calls generate_seqpar, and a stop message
ends the loop when rank 0 closes. The micro-batcher's coalesced generates
go through the same channel; init-audio requests take rank 0's
single-program generate, as JAX's do.

Endpoints:
  GET  /          -> the HTML GUI (prompts, slerp / algebra, init audio)
  GET  /health    -> {"ok": true, "model": "22s", "sample_size": N, ...}; with
                     the micro-batcher on, its batched_runs, coalesced_requests
                     and queue_wait_s (a request's mean wait in the queue is
                     queue_wait_s / coalesced_requests)
  POST /generate  -> JSON spec -> 16-bit PCM WAV bytes (48 kHz stereo)
  POST /embed     -> {"embedding": [[...512 floats]]} for a JSON
                     {"text": "..."} or for posted WAV / FLAC / OGG / MP3
                     bytes (the format from their magic bytes)

Generate spec (at least one prompt):
  {"text": ["a prompt", ...],          # CLAP text prompts
   "embeddings": [[...512 floats]],    # precomputed unit CLAP embeddings
   "weights": [1.0, -0.5],             # algebra weights (with "algebra")
   "algebra": false,                   # weighted sum vs slerp combine
   "interp": 0.5,                      # slerp t between prompts
   "cfg_scale": 4.0, "steps": 150, "outer_steps": 100,
   "batch_size": 1, "seed": -1,
   "init_audio_b64": "<base64 audio>",     # img2img init (loop-repeated)
   "init_strength": 0.4}

Without RoBERTa's tokenizer files (models/clap.tokenize) text prompts use
byte-level fallback ids: the answers then carry a `tokenizer_warning`,
and with --strict-text text prompts are refused with 409 before any work
on the card.
"""
from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import os
import tempfile
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from . import tracing
from .embedding_math import (TURBO_SEQPAR_REFUSAL, decode_batch_from_env, get_model_ready,
                             interp_embeddings, weighted_algebra)
from .utils.audio_io import crossfade_flatten, load_audio

__all__ = ["MirageService", "TokenizerUnavailable", "encode_wav", "make_server", "main"]

SAMPLE_RATE = 48000


class TokenizerUnavailable(RuntimeError):
    """A text prompt refused in strict-text mode: no RoBERTa tokenizer, so
    the embedding would come from byte-level fallback ids. HTTP 409."""


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


def _sniff_suffix(data: bytes) -> str:
    """The loader's extension from the magic bytes: RIFF -> .wav, fLaC ->
    .flac, OggS -> .ogg, anything else (an ID3 tag or a bare MPEG sync)
    -> .mp3."""
    magic = data[:4]
    if magic == b"RIFF":
        return ".wav"
    if magic == b"fLaC":
        return ".flac"
    if magic == b"OggS":
        return ".ogg"
    return ".mp3"


def _decode_audio_bytes(data: bytes) -> np.ndarray:
    """Posted audio bytes -> (C, N) float32 at 48 kHz through
    utils/audio_io.load_audio, the format from the magic bytes."""
    with tempfile.NamedTemporaryFile(suffix=_sniff_suffix(data), delete=False) as f:
        f.write(data)
        path = f.name
    try:
        return load_audio(path, sr=SAMPLE_RATE)
    finally:
        os.unlink(path)


_GUI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>MIRAGE</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:680px;margin:2rem auto;
      padding:0 1rem;color:#222}
 h1{font-weight:600} fieldset{border:1px solid #ccc;border-radius:8px;
      margin:0 0 1rem;padding:.75rem 1rem}
 label{display:block;margin:.4rem 0 .15rem;font-size:.85rem;color:#555}
 input[type=text],input[type=number]{width:100%;box-sizing:border-box;
      padding:.4rem;border:1px solid #bbb;border-radius:6px}
 .row{display:flex;gap:.75rem}.row>div{flex:1}
 button{padding:.55rem 1.4rem;border:0;border-radius:8px;background:#333;
      color:#fff;font-size:1rem;cursor:pointer}
 button:disabled{background:#999}
 audio{width:100%;margin-top:1rem}
 #status{margin-left:1rem;color:#777;font-size:.9rem}
</style></head><body>
<h1>MIRAGE &mdash; text-to-audio algebra</h1>
<p>Browser front-end for the <code>/generate</code> endpoint (the
reference app's Gradio GUI, rebuilt dependency-free).</p>
<fieldset><legend>Prompts</legend>
 <label>Prompt A</label><input type="text" id="pa" value="low brass">
 <label>Prompt B (optional; slerp or algebra)</label>
 <input type="text" id="pb" value="">
 <div class="row">
  <div><label>Interp t (slerp)</label>
   <input type="number" id="interp" value="0.5" step="0.05" min="0" max="1"></div>
  <div><label><input type="checkbox" id="algebra"> weighted algebra</label>
   <label>Weights (comma-sep)</label>
   <input type="text" id="weights" value="1.0, -0.5"></div>
 </div>
</fieldset>
<fieldset><legend>Sampler</legend>
 <div class="row">
  <div><label>Inner steps</label><input type="number" id="steps" value="150"></div>
  <div><label>Outer steps</label><input type="number" id="outer" value="100"></div>
  <div><label>CFG scale</label><input type="number" id="cfg" value="4.0" step="0.5"></div>
  <div><label>Variations</label><input type="number" id="bs" value="1" min="1" max="8"></div>
 </div>
 <label>Init audio (optional, img2img)</label>
 <input type="file" id="init" accept="audio/*">
 <label>Init strength</label>
 <input type="number" id="strength" value="0.4" step="0.05" min="0" max="1">
</fieldset>
<button id="go">Generate</button><span id="status"></span>
<audio id="out" controls></audio>
<script>
const $=id=>document.getElementById(id);
$('go').onclick=async()=>{
 const spec={text:[$('pa').value], steps:+$('steps').value,
   outer_steps:+$('outer').value, cfg_scale:+$('cfg').value,
   batch_size:+$('bs').value, interp:+$('interp').value};
 if($('pb').value) spec.text.push($('pb').value);
 if($('algebra').checked){spec.algebra=true;
   spec.weights=$('weights').value.split(',').map(Number);}
 const f=$('init').files[0];
 if(f){const u=new Uint8Array(await f.arrayBuffer());let s='';
   for(let i=0;i<u.length;i+=0x8000)
     s+=String.fromCharCode.apply(null,u.subarray(i,i+0x8000));
   spec.init_audio_b64=btoa(s);
   spec.init_strength=+$('strength').value;}
 $('go').disabled=true;$('status').textContent='generating\\u2026';
 try{
  const r=await fetch('/generate',{method:'POST',body:JSON.stringify(spec)});
  if(!r.ok){throw new Error((await r.json()).error)}
  $('out').src=URL.createObjectURL(await r.blob());$('out').play();
  $('status').textContent='done ('+(r.headers.get('X-Generate-Info')||'')+')';
 }catch(e){$('status').textContent='error: '+e.message}
 $('go').disabled=false;
};
</script></body></html>"""


class _Pending:
    """One queued generate request waiting for its micro-batch: its request
    id and the host time it was queued at (ns)."""

    __slots__ = ("emb", "key", "rid", "t_queued", "event", "result", "error")

    def __init__(self, emb, key, rid):
        self.emb = emb
        self.key = key
        self.rid = rid
        self.t_queued = time.time_ns()
        self.event = threading.Event()
        self.result = None
        self.error = None


class _MicroBatcher:
    """Coalesce concurrent single-variation /generate requests into one
    generate call. Requests arriving within `window_s` of the first whose
    (steps, outer_steps, cfg_scale) agree run together, up to `max_batch`;
    each slot draws its own noise inside generate, so the requests get
    independent samples. The group runs at its own size: JAX pads it to a
    power of two only to bound its jit programs, a TPU trick that eager
    torch does not need. `queue_wait_s` sums each request's wait from
    `submit` to the group that takes it (its `serve.queue` span)."""

    def __init__(self, service: "MirageService", window_s: float = 0.05, max_batch: int = 8):
        self.service = service
        self.window_s = window_s
        self.max_batch = max_batch
        self.queue: "list[_Pending]" = []
        self.cv = threading.Condition()
        self.batched_runs = 0
        self.coalesced_requests = 0
        self.queue_wait_s = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, emb, key: tuple, rid: int) -> np.ndarray:
        """Queue one embedding (1, 1, 512) of request `rid`; returns its
        (2, N) audio."""
        emb = emb.float().cpu().numpy() if isinstance(emb, torch.Tensor) else emb
        p = _Pending(np.asarray(emb, np.float32).reshape(1, 1, -1), key, rid)
        with self.cv:
            self.queue.append(p)
            self.cv.notify()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _take_group(self) -> "list[_Pending]":
        """Block for work, linger `window_s` for arrivals that can join it,
        then take the first request's key's group."""
        with self.cv:
            while not self.queue:
                self.cv.wait()
            deadline = time.monotonic() + self.window_s
            while len(self.queue) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.cv.wait(timeout=remaining):
                    break
            key = self.queue[0].key
            group = [p for p in self.queue if p.key == key][: self.max_batch]
            now = time.time_ns()
            for p in group:
                self.queue.remove(p)
                self.queue_wait_s += (now - p.t_queued) * 1e-9
                tracing.record("serve.queue", p.t_queued, now, requests=(p.rid,))
            return group

    def _loop(self):
        while True:
            group = self._take_group()
            steps, outer_steps, cfg_scale = group[0].key
            try:
                with self.service.lock, tracing.request([p.rid for p in group]), \
                        tracing.span("serve.batch", getattr(self.service.model, "device", None)):
                    fakes, _ = self.service._model_generate(
                        np.concatenate([p.emb for p in group], axis=0), cfg_scales=cfg_scale,
                        demo_steps=steps, outer_steps=outer_steps, batch_size=len(group),
                        flatten=False)
                    fakes = fakes.float().cpu().numpy()
                    self.batched_runs += 1
                    self.coalesced_requests += len(group)
                for i, p in enumerate(group):
                    p.result = fakes[i]
            except Exception as e:             # handed to each waiting request
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()


class _SeqparChannel:
    """Rank 0's generate calls, run by every rank of a `seq` world: rank 0
    broadcasts each call's arguments and its inner-stage noise (drawn from
    rank 0's generator, in `generate`'s order), then every rank calls
    `generate_seqpar`; ranks above 0 loop in `follow` until `stop`."""

    def __init__(self, world, model):
        self.world, self.model = world, model

    def _broadcast(self, msg=None):
        return self.world.broadcast_object(msg)

    def generate(self, emb, batch_size: int = 1, **kw):
        """On rank 0: one generate_seqpar on every rank."""
        emb = emb.float().cpu().numpy() if isinstance(emb, torch.Tensor) else np.asarray(emb)
        m = self.model
        noise = m._noise((batch_size, m.latent_dim, m.demo_samples // m.downsampling_ratio),
                         None).float().cpu().numpy()
        self._broadcast({"op": "generate", "emb": emb, "latent_noise": noise,
                         "batch_size": batch_size, "kw": kw})
        return m.generate_seqpar(emb, self.world, batch_size=batch_size, latent_noise=noise,
                                 **kw)

    def stop(self) -> None:
        self._broadcast({"op": "stop"})

    def follow(self) -> int:
        """On ranks above 0: run rank 0's generates until it stops; returns
        how many ran."""
        served = 0
        while True:
            msg = self._broadcast()
            if msg["op"] == "stop":
                return served
            self.model.generate_seqpar(msg["emb"], self.world, batch_size=msg["batch_size"],
                                       latent_noise=msg["latent_noise"], **msg["kw"])
            served += 1


class MirageService:
    """One warm model and a lock. `model` is injectable (any object with
    .generate, .embed, .encode_audio_latents, .clap_module, .generator and
    .sample_size); by default get_model_ready's CLAPDAE for `model_choice`
    on `device` (bf16 unless `half` is False; CLAP stays f32).
    `batch_window_s` > 0 turns the micro-batcher on. `strict_text` refuses
    text prompts while the tokenizer falls back to byte ids. Basic auth is
    asked for when MIRAGE_USERNAME and MIRAGE_PASSWORD are both set.
    `mesh_spec` 'seq=N' (in a group of N processes) runs the outer stage
    sequence-parallel: rank 0 serves, the other ranks `follow`, each on
    its rank's card. `turbo` builds the default model on its int8 routes
    (generate_seqpar refuses it, so not with a mesh); AA_MIRAGE_DECODE_BATCH,
    when set, is the default model's outer micro-batch."""

    def __init__(self, model=None, model_choice: str = "22s", half: bool = True,
                 verbose: bool = True, max_batch: int = 8,
                 device: str | torch.device = "cuda", strict_text: bool = False,
                 batch_window_s: float = 0.0, mesh_spec: Optional[str] = None,
                 turbo: bool = False):
        self.world = None
        if mesh_spec:
            from .parallel.mesh import mesh_from_spec
            self.world = mesh_from_spec(mesh_spec, device=device, module="serve")
            if self.world.axis != "seq":
                raise ValueError(f"--mesh {mesh_spec!r}: serving shards over a 'seq' axis "
                                 "(e.g. seq=4)")
            device = self.world.device
        if model is None:
            model = get_model_ready(model_choice, device=device, verbose=verbose, half=half,
                                    turbo=turbo, **decode_batch_from_env())
        self.model = model
        self.model_choice = model_choice
        self.verbose = verbose
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self._request_ids = itertools.count(1)
        user = os.environ.get("MIRAGE_USERNAME", "")
        password = os.environ.get("MIRAGE_PASSWORD", "")
        self.auth: Optional[tuple] = (user, password) if user and password else None
        self.channel = _SeqparChannel(self.world, model) if self.world is not None else None
        follower = self.world is not None and self.world.rank != 0
        self.batcher = (_MicroBatcher(self, batch_window_s, max_batch)
                        if batch_window_s > 0 and not follower else None)
        self.strict_text = strict_text
        self.tokenizer_backend, self._tok_reason = model.clap_module.tokenizer_backend()
        if self.tokenizer_backend == "byte-fallback" and verbose:
            print("serve: WARNING: no RoBERTa tokenizer files; text prompts use "
                  "byte-level fallback ids (degraded embeddings)"
                  + (" [strict: text prompts are refused with 409]" if strict_text else ""))

    def _model_generate(self, emb, **kw):
        """One generate call (the caller holds self.lock): through every
        rank's generate_seqpar when a mesh is set, except for init-audio
        requests, which stay single-program on rank 0."""
        if self.channel is not None and kw.get("init_audio_latents") is None:
            kw.pop("init_audio_latents", None)
            kw.pop("init_strength", None)
            return self.channel.generate(emb, **kw)
        return self.model.generate(emb, **kw)

    def follow(self) -> int:
        """Ranks above 0 of a mesh: run rank 0's generates until it closes."""
        return self.channel.follow()

    def close(self) -> None:
        """Rank 0 of a mesh: end the followers' loops."""
        if self.channel is not None and self.world.rank == 0:
            with self.lock:
                self.channel.stop()

    def text_tokenizer_warning(self) -> Optional[str]:
        """None when text tokenization is exact; else the notice carried in
        the answer. Raises TokenizerUnavailable in strict-text mode."""
        if self.tokenizer_backend != "byte-fallback":
            return None
        msg = ("text tokenizer unavailable: byte-level fallback ids in use (text "
               "embeddings are semantically degraded). Put RoBERTa's vocab.json and "
               "merges.txt in the CLAP module's asset directory "
               f"({self._tok_reason}).")
        if self.strict_text:
            raise TokenizerUnavailable(msg)
        return msg

    def embed_text(self, text: str) -> np.ndarray:
        with self.lock:
            return self.model.embed(text).float().cpu().numpy()

    def embed_audio_bytes(self, data: bytes) -> np.ndarray:
        audio = _decode_audio_bytes(data)
        with self.lock:
            return self.model.embed(audio).float().cpu().numpy()

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
        """Embed the text prompts, combine them with the given embeddings,
        generate, crossfade; returns (wav_bytes, info). Raises ValueError on
        a bad spec and TokenizerUnavailable on a text prompt in strict-text
        mode. The request takes the next id of the service; its spans
        (`serve.request` and those under it) carry it."""
        rid = next(self._request_ids)
        with tracing.request(rid), tracing.span("serve.request"):
            return self._generate_wav(spec, rid)

    def _generate_wav(self, spec: dict, rid: int) -> tuple[bytes, dict]:
        texts = spec.get("text") or []
        if isinstance(texts, str):
            texts = [texts]
        # strict mode refuses before any work on the card
        tok_warning = self.text_tokenizer_warning() if any(texts) else None
        embeddings = [np.asarray(e, np.float32).reshape(1, 1, -1)
                      for e in spec.get("embeddings") or []]
        with self.lock:
            for t in texts:
                if t:
                    embeddings.append(self.model.embed(t).float().cpu().numpy())
        if not embeddings:
            raise ValueError("no prompt: supply 'text' and/or 'embeddings'")
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
        if (self.batcher is not None and batch_size == 1 and seed < 0
                and init_latents is None):
            # one variation and no pinned seed: it may share a generate call
            fakes = self.batcher.submit(emb, (steps, outer_steps, cfg_scale), rid)[None]
        else:
            with self.lock:
                if seed >= 0:
                    self.model.generator.manual_seed(seed)
                fakes, _ = self._model_generate(
                    emb, cfg_scales=cfg_scale, demo_steps=steps, outer_steps=outer_steps,
                    batch_size=batch_size, init_audio_latents=init_latents,
                    init_strength=float(spec.get("init_strength", 0.4)), flatten=False)
                fakes = fakes.float().cpu().numpy()
        with self._stats_lock:
            self.requests_served += 1
        with tracing.span("serve.wav"):
            out = crossfade_flatten(fakes, sr=SAMPLE_RATE)
            wav = encode_wav(out, SAMPLE_RATE)
        info = {"batch_size": batch_size, "samples": int(out.shape[-1]),
                "sample_rate": SAMPLE_RATE}
        if tok_warning:
            info["tokenizer_warning"] = tok_warning
        return wav, info

    def health(self) -> dict:
        h = {"ok": True, "model": self.model_choice,
             "sample_size": int(getattr(self.model, "sample_size", 0)),
             "requests_served": self.requests_served,
             "device": str(getattr(self.model, "device", "")),
             "text_tokenizer": self.tokenizer_backend,
             "strict_text": self.strict_text}
        if self.batcher is not None:
            h["batched_runs"] = self.batcher.batched_runs
            h["coalesced_requests"] = self.batcher.coalesced_requests
            h["queue_wait_s"] = self.batcher.queue_wait_s
        if self.world is not None:
            h["mesh"] = {self.world.axis: self.world.size}
        return h


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

        def _authorized(self) -> bool:
            """Basic auth when the service has credentials; /health stays
            open for probes. Answers 401 itself when refused."""
            if service.auth is None or self.path.rstrip("/") == "/health":
                return True
            header = self.headers.get("Authorization") or ""
            if header.startswith("Basic "):
                try:
                    user, _, password = base64.b64decode(header[6:]).decode().partition(":")
                except ValueError:
                    user = password = None
                if (user, password) == service.auth:
                    return True
            self._send(401, b'{"error": "unauthorized"}', "application/json",
                       [("WWW-Authenticate", 'Basic realm="MIRAGE"')])
            return False

        def do_GET(self):
            if not self._authorized():
                return
            if self.path.rstrip("/") == "":
                self._send(200, _GUI_HTML.encode(), "text/html; charset=utf-8")
            elif self.path.rstrip("/") == "/health":
                self._send_json(200, service.health())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if not self._authorized():
                return
            data = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            ctype = (self.headers.get("Content-Type") or "").lower()
            try:
                if self.path == "/embed":
                    # audio/* or, unless declared JSON, bytes whose magic is
                    # WAV, FLAC, OGG or an ID3-tagged MP3; the decoder is
                    # picked from the magic bytes
                    has_magic = data[:4] in (b"RIFF", b"fLaC", b"OggS") or data[:3] == b"ID3"
                    is_audio = ctype.startswith("audio/") or (
                        not ctype.startswith("application/json") and has_magic)
                    if is_audio:
                        body = {"embedding": service.embed_audio_bytes(data).tolist()}
                    else:
                        spec = json.loads(data or b"{}")
                        warn = service.text_tokenizer_warning()       # may 409
                        body = {"embedding": service.embed_text(str(spec["text"])).tolist()}
                        if warn:
                            body["tokenizer_warning"] = warn
                    self._send_json(200, body)
                    return
                if self.path != "/generate":
                    self._send_json(404, {"error": f"no route {self.path}"})
                    return
                wav, info = service.generate_wav(json.loads(data or b"{}"))
                self._send(200, wav, "audio/wav",
                           [("X-Generate-Info", json.dumps(info))])
            except TokenizerUnavailable as e:
                self._send_json(409, {
                    "error": "text_tokenizer_unavailable", "detail": str(e),
                    "fix": "put RoBERTa's vocab.json and merges.txt in the asset "
                           "directory, or serve without --strict-text to accept "
                           "degraded byte-fallback embeddings"})
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
    p.add_argument("--batch-window", type=float, default=0.05,
                   help="micro-batching window in seconds (0 turns it off): concurrent "
                        "requests of one sampler config run as one generate")
    p.add_argument("--max-batch", type=int, default=8,
                   help="the largest micro-batch and batch_size")
    p.add_argument("--warmup", action="store_true",
                   help="run one default-config generate before binding")
    p.add_argument("--strict-text", action="store_true",
                   help="refuse text prompts (409) while the tokenizer falls back to "
                        "byte-level ids")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; under torchrun, the rank's card) or 'cpu'")
    p.add_argument("--turbo", action="store_true",
                   help="int8 outer stage (JAX's AA_TURBO_INT8=1): each micro-batch of "
                        "4 runs its outer levels' convs int8 (the int8-in-fold route)")
    p.add_argument("--mesh", type=str, default=None, metavar="seq=N",
                   help="run each generate's outer stage sequence-parallel over N "
                        "processes, one a card: torchrun --nproc_per_node N -m "
                        "audio_algebra_torch.serve --mesh seq=N ...")
    args = p.parse_args(argv)
    if args.turbo and args.mesh:
        p.error(f"--turbo with --mesh: {TURBO_SEQPAR_REFUSAL}; drop one flag")
    service = MirageService(model_choice=args.model, half=not args.no_half,
                            batch_window_s=args.batch_window, max_batch=args.max_batch,
                            strict_text=args.strict_text, mesh_spec=args.mesh,
                            device=args.device, turbo=args.turbo)
    if service.world is not None and service.world.rank != 0:
        print(f"serve: rank {service.world.rank} following rank 0's generates", flush=True)
        service.follow()
        return
    if args.warmup:
        print("serve: warmup generate...", flush=True)
        service.generate_wav({"embeddings": [[1.0] + [0.0] * 511], "steps": 150,
                              "outer_steps": 100, "batch_size": 1, "seed": 0})
    server = make_server(service, args.host, args.port)
    if service.auth is None and args.host not in ("127.0.0.1", "localhost", "::1"):
        print("serve: WARNING: listening on a non-loopback interface with no auth; set "
              "MIRAGE_USERNAME and MIRAGE_PASSWORD to require basic auth", flush=True)
    print(f"serve: MIRAGE ({args.model}) listening on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
