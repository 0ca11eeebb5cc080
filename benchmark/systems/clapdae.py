"""MIRAGE requests through the service (`serve.MirageService.generate_wav`)
over the CLAPDAE model (`given_models.CLAPDAE`).

A request is one seeded unit 512-d embedding with the mix's steps, outer
steps and CFG scale and seed -1, so concurrent requests share a generate
through the service's micro-batcher. The service is handed a thin view of
the model (the service takes any model object) whose `generate` passes
each row's latent and stage-1 noises, drawn on the card from that
request's seed, to `CLAPDAE.generate`; in a traced run it asks for the
program's own stage times too. The check runs sampled requests again with
the plain f32 reference: the inner DPM++(2M) over the CFG UNet, the outer
v-DDIM, the AE decode and the WAV's 16-bit conversion, and compares the
inner latents and the audio.
"""
from __future__ import annotations

import io
import random
import sys
import threading
import time
import wave

import numpy as np
import torch

from .. import weights
from ..counts import soundstream as ss_counts
from ..counts import unet1d as unet_counts
from ..counts import unet_cfg1d as cfg_counts
from .common import (BranchRecorder, HostSpans, branch_ref, reference_mode, rel_rms,
                     unit_embeddings)

SAMPLE_RATE = 48000


class _ServedModel:
    """The CLAPDAE as the service sees it, each row's noises handed in."""

    def __init__(self, model, system):
        self._model, self._system = model, system

    def __getattr__(self, name):
        return getattr(self._model, name)

    def generate(self, audio_embeddings, **kw):
        return self._system._generate(self._model, audio_embeddings, **kw)


class System:
    def __init__(self, config: dict, mix: dict, seed: int, trace: bool, device,
                 variant: str | None = None):
        self.cfg, self.mix, self.seed, self.trace = config, mix, seed, trace
        self.device = torch.device(device)
        self.variant = variant
        self.dtype = getattr(torch, config["dtype"])
        self.requests: dict = {}           # embedding bytes -> request seed
        self.latents: dict = {}            # request seed -> the generate's inner latents
        self.generates: list = []          # (t0, t1, rows, stage times, steps) a generate
        self.branches: dict = {}           # request seed -> (input, branch, step) recorded
        self._lock = threading.Lock()
        self.service = self.model = None
        self.spans = HostSpans()
        self.branch = None

    # -- set-up --
    def _model_kwargs(self):
        c = self.cfg
        inner = c["inner"]
        return {"factors": tuple(c["latent_factors"]), "latent_channels": c["latent_channels"],
                "latent_multipliers": tuple(c["latent_multipliers"]),
                "latent_num_blocks": tuple(c["latent_num_blocks"]),
                "diffusion_c_mults": tuple(c["outer"]["c_mults"]),
                "diffusion_depth": c["outer"]["depth"],
                "factors2": tuple(inner["factors"]), "channels": inner["channels"],
                "multipliers": tuple(inner["multipliers"]),
                "num_blocks": tuple(inner["num_blocks"]),
                "attentions": tuple(inner["attentions"]),
                "resnet_groups": inner["resnet_groups"],
                "attention_heads": inner["attention_heads"],
                "attention_features": inner["attention_features"],
                "attention_multiplier": inner["attention_multiplier"],
                "attention_rel_pos_max_distance": inner["attention_rel_pos_max_distance"],
                "attention_rel_pos_num_buckets": inner["attention_rel_pos_num_buckets"],
                "embedding_features": inner["context_embedding_features"],
                "embedding_max_len": inner["context_embedding_max_length"]}

    def n_latent(self) -> int:
        c = self.cfg
        ratio = int(np.prod(c["first_stage"]["strides"])) * int(np.prod(c["latent_factors"]))
        return c["sample_size"] // ratio

    def setup(self):
        if self.device.type == "cuda":
            from audio_algebra_torch.ops import _build
            _build.build(list(self.cfg["kernels"]))
        from audio_algebra_torch.given_models import CLAPDAE
        from audio_algebra_torch.serve import MirageService
        c = self.cfg
        with torch.device(self.device):
            m = CLAPDAE(first_stage_config=dict(c["first_stage"]), sample_size=c["sample_size"],
                        model_kwargs=self._model_kwargs(), device=self.device,
                        decode_batch=c["decode_batch"], turbo=self.variant == "control",
                        debug=False)
        m._loaded = True             # the weights below stand; no host init
        m.half(self.dtype)
        self.shapes = {"la": weights.shapes_of(m.latent_diffae),
                       "ldm": weights.shapes_of(m.latent_diffusion_model)}
        weights.load_(m.latent_diffae, weights.draw(
            self.shapes["la"], weights.seed_of(self.seed, 1), self.device, self.dtype))
        weights.load_(m.latent_diffusion_model, weights.draw(
            self.shapes["ldm"], weights.seed_of(self.seed, 3), self.device, self.dtype))
        self.model = m
        self.branch = BranchRecorder(
            m.latent_diffae.diffusion.get_submodule(c["check"]["block"]))
        svc = c["service"]
        self.service = MirageService(model=_ServedModel(m, self), verbose=False,
                                     max_batch=svc["max_batch"], device=self.device,
                                     batch_window_s=svc["batch_window_s"])
        # warm-up at this cell's batch, through the service and its batcher
        # thread: each client one request of one inner and one outer step
        # at once, so they share one generate as the window's do
        warm = dict(self.mix["request"], steps=1, outer_steps=1)
        clients = [threading.Thread(target=self.call,
                                    args=(warm, weights.seed_of(self.seed, 4, c), c))
                   for c in range(1, int(self.mix["clients"]))]
        for th in clients:
            th.start()
        self.call(warm, weights.seed_of(self.seed, 4, 0), 0)
        for th in clients:
            th.join()
        self.latents.clear()
        self.branches.clear()
        self.generates.clear()
        self.spans.rows.clear()

    # -- the window --
    def _noises(self, seed: int):
        n = self.n_latent()
        g = torch.Generator(self.device).manual_seed(weights.seed_of(seed, 6))
        lat = torch.randn((1, self.cfg["inner"]["in_channels"], n), generator=g,
                          device=self.device)
        s1 = torch.randn((1, self.cfg["first_stage"]["latent_dim"],
                          n * int(np.prod(self.cfg["latent_factors"]))), generator=g,
                         device=self.device)
        return lat, s1

    def _generate(self, model, audio_embeddings, **kw):
        emb = np.asarray(audio_embeddings, np.float32)
        seeds = [self.requests[row.tobytes()] for row in emb.reshape(emb.shape[0], -1)]
        noises = [self._noises(s) for s in seeds]
        pick = random.Random(weights.seed_of(seeds[0], 8))
        row = pick.randrange(min(len(seeds), self.cfg["decode_batch"]))
        self.branch.arm(pick.randrange(kw["outer_steps"]), row)
        t0 = time.perf_counter()
        with self.spans("generate"):
            out = model.generate(emb, latent_noise=torch.cat([a for a, _ in noises]),
                                 s1_noise=torch.cat([b for _, b in noises]),
                                 stage_times=self.trace, **kw)
            branch = self.branch.take()
        with self._lock:
            for i, s in enumerate(seeds):
                self.latents[s] = out[1][i].detach().clone()
            if branch is not None:
                self.branches[seeds[row]] = branch
            self.generates.append((t0, time.perf_counter(), len(seeds),
                                   dict(model.last_stage_times),
                                   {"demo_steps": kw["demo_steps"],
                                    "outer_steps": kw["outer_steps"]}))
        return out

    def call(self, params: dict, seed: int, client: int) -> dict:
        emb = unit_embeddings(weights.seed_of(seed, 5), 1, 512).numpy()
        self.requests[emb.reshape(-1).tobytes()] = seed
        spec = {"embeddings": [emb.reshape(-1).tolist()], "steps": params["steps"],
                "outer_steps": params["outer_steps"], "cfg_scale": params["cfg_scale"],
                "seed": params["seed"], "batch_size": 1}
        with self.spans("request"):
            wav, info = self.service.generate_wav(spec)
        return {"wav": wav, "audio_s": info["samples"] / info["sample_rate"],
                "embedding": emb, "steps": params["steps"],
                "outer_steps": params["outer_steps"], "cfg_scale": params["cfg_scale"]}

    def counters(self) -> dict:
        from audio_algebra_torch.ops import flash_attention, groupnorm, groupnorm_grouped
        b = self.service.batcher
        return {"k1_launches": groupnorm.launches, "k3_launches": flash_attention.launches,
                "k5_launches": groupnorm_grouped.launches,
                "k5_two_pass_launches": groupnorm_grouped.two_pass_launches,
                "batched_runs": b.batched_runs if b else 0,
                "coalesced_requests": b.coalesced_requests if b else 0}

    def work(self, out: dict) -> dict:
        """Operations of one request (the CFG core runs two rows for it)."""
        c, n = self.cfg, self.n_latent()
        t1 = n * int(np.prod(c["latent_factors"]))
        fs = c["first_stage"]
        flops = out["steps"] * cfg_counts.core_flops(c["inner"], 2, n) \
            + out["outer_steps"] * unet_counts.flops(1, t1, fs["latent_dim"], fs["latent_dim"],
                                                     c["outer"]["c_mults"], 0) \
            + ss_counts.decoder_flops(1, t1, 2, fs["capacity"], fs["c_mults"], fs["strides"],
                                      fs["latent_dim"])
        return {"flops": flops, "steps": out["steps"], "outer_steps": out["outer_steps"]}

    def k5_launches(self, batch: int, steps: int):
        """K5 launches of one generate of `batch` rows (CFG doubles them)."""
        return cfg_counts.k5_launches(self.cfg["inner"], 2 * batch, self.n_latent()) * steps

    def release(self):
        for m in (self.model.latent_diffae, self.model.latent_diffusion_model):
            m.to("meta")

    # -- the check --
    @staticmethod
    def _pcm(wav: bytes) -> np.ndarray:
        with wave.open(io.BytesIO(wav), "rb") as f:
            ch = f.getnchannels()
            frames = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
        return frames.reshape(-1, ch).T

    @torch.inference_mode()
    def check(self, records, seed: int) -> dict:
        """Three numbers over sampled requests, each against the f32
        reference: the inner stage's latents (DPM++(2M) over the CFG UNet
        from the request's embedding and noise), the audio from the outer
        v-DDIM, the AE decode and the WAV's samples run on the program's own
        latents (the stage boundary; the inner stage is checked by itself),
        and the conv branch of one ResConvBlock of the outer UNet run on the
        program's own input at a sampled step and row (the number the int8
        control fails)."""
        from ..reference import soundstream, unet1d, unet_cfg1d
        from ..reference.audio import crossfade_flatten, pcm16
        from ..reference.samplers import dpmpp_2m_sample, vddim_sample
        reference_mode()
        t_check = time.perf_counter()
        c, chk = self.cfg, self.cfg["check"]
        done = [r for r in records if r.out is not None]
        rng = random.Random(weights.seed_of(seed, 11))
        picks = rng.sample(done, min(chk["requests"], len(done)))
        watched = [r for r in done if r.seed in self.branches]
        block_picks = rng.sample(watched, min(chk["requests"], len(watched)))
        fs = c["first_stage"]
        worst = {"latents_rel_rms": 0.0, "audio_rel_rms": 0.0, "branch_rel_rms": 0.0}
        P = weights.draw(self.shapes["ldm"], weights.seed_of(self.seed, 3), self.device,
                         self.dtype, out_dtype=torch.float32)
        buckets = {}
        for r in picks:
            emb = torch.from_numpy(r.out["embedding"]).to(self.device)
            lat_noise, _ = self._noises(r.seed)

            def inner_fn(x, t, scale=float(r.out["cfg_scale"]), emb=emb):
                return unet_cfg1d.cfg_forward(P, "diffusion", x, t, emb, scale, c["inner"],
                                              buckets)

            ref = torch.clamp(dpmpp_2m_sample(inner_fn, lat_noise, r.out["steps"]), -1, 1)
            worst["latents_rel_rms"] = max(worst["latents_rel_rms"],
                                           rel_rms(self.latents[r.seed].float()[None], ref))
        t_inner = time.perf_counter()
        del P
        P = weights.draw(self.shapes["la"], weights.seed_of(self.seed, 1), self.device,
                         self.dtype, out_dtype=torch.float32)

        def outer_fn(x, t, cond):
            return unet1d.unet_forward(P, "diffusion", x, t, cond, c["outer"]["depth"], 0)

        for r in picks:
            _, s1 = self._noises(r.seed)
            lat = self.latents[r.seed].float()[None]
            first = torch.clamp(vddim_sample(outer_fn, s1, r.out["outer_steps"], lat), -1, 1)
            audio = soundstream.decoder(P, "autoencoder.decoder", first, fs["strides"])
            ref = pcm16(crossfade_flatten(audio.cpu().numpy(), sr=SAMPLE_RATE))
            prog = torch.from_numpy(self._pcm(r.out["wav"]).astype(np.float64))
            worst["audio_rel_rms"] = max(worst["audio_rel_rms"],
                                         rel_rms(prog, torch.from_numpy(ref.astype(np.float64))))
        for r in block_picks:
            x_in, h_out, _ = self.branches[r.seed]
            h_ref = branch_ref(P, f"diffusion.{chk['block']}", x_in.to(self.device).float())
            worst["branch_rel_rms"] = max(worst["branch_rel_rms"],
                                          rel_rms(h_out.to(self.device).float(), h_ref))
        print(f"check: inner stage {t_inner - t_check:.1f} s, outer stage, AE and branch "
              f"{time.perf_counter() - t_inner:.1f} s", file=sys.stderr)
        return {k: (v, chk["limits"][k]) for k, v in worst.items()}
