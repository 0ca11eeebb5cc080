"""Destructo jobs on the DiffusionDVAE (`given_models.DVAEWrapper`).

A job is what `destructo.main` does to a batch of chunks: `encode`, a
latent op (`destructo.mathemangle`), `decode(demo_steps=...)`, then the
audio to the host. The chunks are made on the card from the request's
seed, as is the decode noise, which the harness hands to the wrapper
through its documented `noise` attribute. The check decodes sampled rows
of sampled jobs again with the plain f32 reference (benchmark/reference)
from the same audio, noise and weights, and compares the latents and the
audio.
"""
from __future__ import annotations

import random

import torch

from .. import weights
from ..counts import soundstream as ss_counts
from ..counts import unet1d as unet_counts
from .common import (BranchRecorder, HostSpans, branch_ref, make_audio, reference_mode,
                     rel_rms)

SAMPLE_RATE = 48000


class System:
    def __init__(self, config: dict, mix: dict, seed: int, trace: bool, device,
                 variant: str | None = None):
        self.cfg, self.mix, self.seed, self.trace = config, mix, seed, trace
        self.device = torch.device(device)
        self.variant = variant
        self.dtype = getattr(torch, config["dtype"])
        self.w = None
        self.shapes = None
        self.spans = HostSpans()
        self.branch = None

    # -- set-up --
    def _model_kwargs(self):
        c = self.cfg
        return {"capacity": c["capacity"], "c_mults": tuple(c["c_mults"]),
                "strides": tuple(c["strides"]), "n_attn_layers": c["n_attn_layers"],
                "diffusion_c_mults": tuple(c["diffusion_c_mults"])}

    def setup(self):
        if self.device.type == "cuda":
            from audio_algebra_torch.ops import _build
            _build.build(list(self.cfg["kernels"]))
        from audio_algebra_torch.given_models import DVAEWrapper
        c = self.cfg
        turbo = self.variant == "control"
        with torch.device(self.device):
            w = DVAEWrapper(args_dict={"demo_steps": c["demo_steps"],
                                       "sample_size": c["sample_size"],
                                       "latent_dim": c["latent_dim"], "pqmf_bands": 1,
                                       "num_quantizers": 0},
                            model_kwargs=self._model_kwargs(), device=self.device,
                            dtype=self.dtype, turbo=turbo)
        w.model.to(self.device, self.dtype)
        self.shapes = weights.shapes_of(w.model)
        weights.load_(w.model, weights.draw(self.shapes, weights.seed_of(self.seed, 1),
                                            self.device, self.dtype))
        w._loaded = True             # the weights above stand; no host init
        self.w = w
        self.branch = BranchRecorder(w.model.diffusion.get_submodule(c["check"]["block"]))
        # warm-up at this cell's shapes: one encode, a decode of two steps
        p = self.mix["request"]
        audio = make_audio(weights.seed_of(self.seed, 2), p["chunks"], 2, c["sample_size"],
                           self.device)
        from audio_algebra_torch.destructo import mathemangle
        z = mathemangle(w.encode(audio), p["op"])
        w.decode(z, demo_steps=2).float().cpu()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window --
    def call(self, params: dict, seed: int, client: int) -> dict:
        from audio_algebra_torch.destructo import mathemangle
        w, rec = self.w, {}
        audio = make_audio(seed, params["chunks"], 2, self.cfg["sample_size"], self.device)
        with self.spans("encode", rec, self.trace):
            z = w.encode(audio)
        noise = torch.randn(audio.shape, generator=torch.Generator(self.device).manual_seed(
            weights.seed_of(seed, 7)), device=self.device)
        w.noise = noise
        pick = random.Random(weights.seed_of(seed, 8))
        self.branch.arm(pick.randrange(params["steps"]), pick.randrange(audio.shape[0]))
        with self.spans("decode", rec, self.trace):
            out = w.decode(mathemangle(z, params["op"]), demo_steps=params["steps"])
            out = out.float().cpu()
        rec.update(latents=z, audio=out, audio_s=audio.shape[0] * audio.shape[-1] / SAMPLE_RATE,
                   steps=params["steps"], chunks=audio.shape[0], branch=self.branch.take())
        return rec

    def counters(self) -> dict:
        from audio_algebra_torch.ops import groupnorm, groupnorm_grouped
        return {"k1_launches": groupnorm.launches, "k5_launches": groupnorm_grouped.launches}

    def work(self, out: dict) -> dict:
        """Operations of a job and its K1 launches."""
        c, b = self.cfg, out["chunks"]
        t = c["sample_size"]
        unet = (2, c["latent_dim"], c["diffusion_c_mults"], c["n_attn_layers"])
        flops = ss_counts.encoder_flops(b, t, 2, c["capacity"], c["c_mults"], c["strides"],
                                        c["latent_dim"]) \
            + out["steps"] * unet_counts.flops(b, t, *unet)
        k1 = unet_counts.k1_launches(b, t, *unet) * out["steps"]
        return {"flops": flops, "k1": k1, "steps": out["steps"], "dtype": self.dtype}

    def release(self):
        self.w.model.to("meta")
        self.w = None

    # -- the check --
    @torch.inference_mode()
    def check(self, records, seed: int) -> dict:
        """Three numbers over sampled jobs, each against the f32 reference:
        the encoder's latents (every row), the decode's audio from the
        program's own latents under the op (sampled rows), and the conv
        branch of one ResConvBlock of the UNet run on the program's own
        input at a
        sampled step and row (the number the int8 control fails)."""
        from ..reference import soundstream, unet1d
        from ..reference.samplers import vddim_sample
        reference_mode()
        c, chk = self.cfg, self.cfg["check"]
        p = self.mix["request"]
        if p["op"] not in ("destructo", "none"):
            raise ValueError(f"the reference takes the ops destructo and none, not {p['op']}")
        done = [r for r in records if r.out is not None]
        rng = random.Random(weights.seed_of(seed, 11))
        jobs = rng.sample(done, min(chk["jobs"], len(done)))
        P = weights.draw(self.shapes, weights.seed_of(self.seed, 1), self.device, self.dtype,
                         out_dtype=torch.float32)
        t = c["sample_size"]
        worst = {"latents_rel_rms": 0.0, "audio_rel_rms": 0.0, "branch_rel_rms": 0.0}

        def model_fn(x, tt, cond):
            return unet1d.unet_forward(P, "diffusion", x, tt, cond,
                                       len(c["diffusion_c_mults"]), c["n_attn_layers"])

        for r in jobs:
            audio = make_audio(r.seed, p["chunks"], 2, t, self.device)
            lat = torch.cat([torch.tanh(soundstream.encoder(P, "encoder", audio[i:i + 4],
                                                            c["strides"]))
                             for i in range(0, audio.shape[0], 4)])
            prog_lat = r.out["latents"].float()
            worst["latents_rel_rms"] = max(worst["latents_rel_rms"], rel_rms(prog_lat, lat))
            noise = torch.randn(audio.shape, generator=torch.Generator(self.device).manual_seed(
                weights.seed_of(r.seed, 7)), device=self.device)
            rows = sorted(rng.sample(range(audio.shape[0]), min(chk["rows"], audio.shape[0])))
            cond = -prog_lat[rows] if p["op"] == "destructo" else prog_lat[rows]
            ref = vddim_sample(model_fn, noise[rows], r.out["steps"], cond)
            prog = r.out["audio"].reshape(2, -1, t).transpose(0, 1)[rows].to(self.device)
            for i in range(len(rows)):
                worst["audio_rel_rms"] = max(worst["audio_rel_rms"], rel_rms(prog[i], ref[i]))
            x_in, h_out, _ = r.out["branch"]
            h_ref = branch_ref(P, f"diffusion.{chk['block']}", x_in.to(self.device).float())
            worst["branch_rel_rms"] = max(worst["branch_rel_rms"],
                                          rel_rms(h_out.to(self.device).float(), h_ref))
        return {k: (v, chk["limits"][k]) for k, v in worst.items()}
