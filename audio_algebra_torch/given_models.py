"""given_models — the DVAE wrapper of the Destructo path and the MIRAGE
generator CLAPDAE.

Port of audio_algebra_tpu/given_models.py:DVAEWrapper and CLAPDAE.

DVAEWrapper. encode: encoder ->
tanh, and a fresh decode noise is drawn (as the reference does); decode:
v-DDIM `sample` from that noise conditioned on the latents, then the
'b d n -> d (b n)' flatten. `turbo=True` decodes through the UNet's int8
route with the amax carry (JAX: AA_TURBO_INT8=1), which engages at batch
>= `turbo_min_b` (16, JAX's AA_TURBO_MIN_B default); below it the decode
is the float one. The noise is an attribute the caller may set
(`w.noise = ...`, shape (B, 2, sample_size)).

The wrapper holds one set of weights, the ones inference uses (the JAX
wrapper's `params_ema`). Without a checkpoint they are the seeded random
weights of utils/params.random_init_; `load_flax_params(tree)` loads a
flax params tree instead.

CLAPDAE. `generate` runs the MIRAGE stack from (B, 1, 512) CLAP
embeddings: a DPM++(2M) with classifier-free guidance over the
CLAP-conditioned UNetCFG1d (kernels K3 and K5), a v-DDIM over the outer
DiffusionAttnUnet1D (kernel K1), then the AudioAutoencoder decode. The CLAP
embedder itself is not ported yet (ROADMAP.md section A, item 12): `embed`
and `encode` raise, and callers hand in precomputed embeddings. The other
given models come with later slices.
"""
from __future__ import annotations

import inspect
import time
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models.blocks import TURBO_MIN_B
from .models.dvae import DiffusionDVAE
from .models.stacked import LatentAudioDiffusionAutoencoder, StackedAELatentDiffusionCond
from .models.unet_cfg1d import precompute_rel_biases
from .samplers.kdiff import kdiff_sample
from .samplers.vddim import resample_diffusion
from .samplers.vddim import sample as vddim_sample
from .utils import params as params_mod

__all__ = ["DVAEWrapper", "CLAPDAE", "CLAP_NOT_PORTED"]

CLAP_NOT_PORTED = ("CLAP (text and audio embeddings) is not ported to the PyTorch "
                   "port yet: ROADMAP.md section A, item 12. Pass precomputed unit "
                   "CLAP embeddings instead.")


class DVAEWrapper:
    DEFAULT_ARGS = {"num_quantizers": 0, "sample_size": 65536, "demo_steps": 50,
                    "sample_rate": 48000, "latent_dim": 64, "pqmf_bands": 1}

    def __init__(self, args_dict: Optional[dict] = None,
                 model_kwargs: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, turbo: bool = False,
                 turbo_min_b: int = TURBO_MIN_B):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.turbo, self.turbo_min_b = turbo, turbo_min_b
        args = dict(self.DEFAULT_ARGS)
        args.update(args_dict or {})
        self.seed = seed
        self.model = DiffusionDVAE(
            latent_dim=args["latent_dim"], pqmf_bands=args["pqmf_bands"],
            num_quantizers=args["num_quantizers"], **(model_kwargs or {}))
        self.model.eval()
        self._loaded = False
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise: Optional[torch.Tensor] = None
        self.demo_steps = args["demo_steps"]
        self.demo_samples = args["sample_size"]

    def load_flax_params(self, tree: dict) -> None:
        """Load a flax params tree (e.g. the JAX wrapper's params_ema)."""
        params_mod.load_flax_params(self.model, tree)
        self.model.to(self.device, self.dtype)
        self._loaded = True

    def ensure_params(self) -> None:
        """Random-initialise the weights (seeded) unless some were loaded."""
        if not self._loaded:
            params_mod.random_init_(self.model, self.seed)
            self.model.to(self.device, self.dtype)
            self._loaded = True

    def _as_input(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, self.dtype)

    def _draw_noise(self, batch: int) -> torch.Tensor:
        return torch.randn((batch, 2, self.demo_samples), generator=self.generator,
                           device=self.device, dtype=torch.float32).to(self.dtype)

    @torch.inference_mode()
    def encode(self, waveform) -> torch.Tensor:
        """(B, 2, T) audio -> (B, latent_dim, T/128) tanh latents."""
        waveform = self._as_input(waveform)
        self.demo_samples = waveform.shape[-1]
        self.ensure_params()
        reps = self.model.encode_it(waveform)
        self.noise = self._draw_noise(waveform.shape[0])
        return reps

    @torch.inference_mode()
    def decode(self, reps, demo_steps: Optional[int] = None) -> torch.Tensor:
        """Latents (B, latent_dim, n) -> audio (2, B * sample_size)."""
        if demo_steps is None:
            demo_steps = self.demo_steps
        self.ensure_params()
        reps = self._as_input(reps)
        noise = self.noise
        if noise is None or noise.shape[0] != reps.shape[0]:
            noise = self._draw_noise(reps.shape[0])
        if self.turbo:
            # the amax carry: each step quantises on the previous step's grids
            def model_fn(x, t, aux, cond):
                return self.model.decode_v_aux(x, t, cond, q_aux=aux,
                                               turbo_min_b=self.turbo_min_b)
            fakes = vddim_sample(model_fn, self._as_input(noise), demo_steps, 0, reps,
                                 aux_mode=True)
        else:
            fakes = vddim_sample(self.model.decode_v, self._as_input(noise),
                                 demo_steps, 0, reps)
        b, d, n = fakes.shape                     # 'b d n -> d (b n)'
        return fakes.transpose(0, 1).reshape(d, b * n)


def _kwargs_of(cls, exclude=()) -> set:
    return {n for n in inspect.signature(cls.__init__).parameters
            if n not in ("self", *exclude)}


class CLAPDAE:
    """The MIRAGE model: CLAP-conditioned stacked latent diffusion.

    `latent_diffae` (LatentAudioDiffusionAutoencoder) and
    `latent_diffusion_model` (StackedAELatentDiffusionCond) are built from
    `first_stage_config` and `model_kwargs` as in JAX (`factors2` names
    the inner UNet's factors). Without a checkpoint the weights are seeded
    random ones (utils/params.random_init_ with `seed` and `seed + 1`);
    `load_flax_params(diffae_tree, ldm_tree)` loads flax trees instead.
    Noise is drawn from `generator` unless the caller passes it."""

    DEFAULT_FIRST_STAGE = {"capacity": 64, "c_mults": [2, 4, 8, 16, 32],
                           "strides": [2, 2, 2, 2, 2], "latent_dim": 32}
    SAMPLES_22S = 1048576
    DECODE_BATCH = 4         # outer stage + AE decode in micro-batches: memory

    def __init__(self, first_stage_config: Optional[dict] = None,
                 sample_size: int = SAMPLES_22S, model_kwargs: Optional[dict] = None,
                 seed: int = 0, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.seed = seed
        self.sample_size = self.demo_samples = sample_size
        self._explicit_sample_size = sample_size != self.SAMPLES_22S
        fsc = first_stage_config or self.DEFAULT_FIRST_STAGE
        mk = dict(model_kwargs or {})
        if "factors2" in mk:            # the inner UNet's factors vs the AE's
            mk["ldm_factors"] = mk.pop("factors2")
        diffae_fields = _kwargs_of(LatentAudioDiffusionAutoencoder)
        ldm_fields = _kwargs_of(StackedAELatentDiffusionCond, ("latent_dim", "factors"))
        ldm_kwargs = {k: v for k, v in mk.items() if k in ldm_fields}
        if "ldm_factors" in mk:
            ldm_kwargs["factors"] = mk["ldm_factors"]
        self.latent_diffae = LatentAudioDiffusionAutoencoder(
            latent_dim=fsc["latent_dim"], ae_capacity=fsc["capacity"],
            ae_c_mults=tuple(fsc["c_mults"]), ae_strides=tuple(fsc["strides"]),
            **{k: v for k, v in mk.items() if k in diffae_fields})
        self.latent_diffusion_model = StackedAELatentDiffusionCond(
            latent_dim=self.latent_diffae.second_stage_latent_dim, **ldm_kwargs)
        self.latent_dim = self.latent_diffae.second_stage_latent_dim
        self.downsampling_ratio = self.latent_diffae.downsampling_ratio
        for m in (self.latent_diffae, self.latent_diffusion_model):
            m.eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.last_stage_times: dict = {}
        self._loaded = False

    # -- weights --
    def _place(self) -> None:
        for m in (self.latent_diffae, self.latent_diffusion_model):
            m.to(self.device, self.dtype)
        self._loaded = True

    def load_flax_params(self, diffae_tree: dict, ldm_tree: dict) -> None:
        """Load flax params trees (the JAX wrapper's diffae_params and
        ldm_params)."""
        params_mod.load_flax_params(self.latent_diffae, diffae_tree)
        params_mod.load_flax_params(self.latent_diffusion_model, ldm_tree)
        self._place()

    def ensure_params(self) -> None:
        """Random-initialise the weights (seeded) unless some were loaded."""
        if not self._loaded:
            params_mod.random_init_(self.latent_diffae, self.seed)
            params_mod.random_init_(self.latent_diffusion_model, self.seed + 1)
            self._place()

    def half(self, dtype: torch.dtype = torch.bfloat16) -> "CLAPDAE":
        """Cast both diffusion stages (and the AE) to bf16, the reference
        app's default. Returns self."""
        self.ensure_params()
        self.dtype = dtype
        self._place()
        return self

    def setup(self, model_len: str = "22s") -> "CLAPDAE":
        """Set the sample size of a model length: 22 s = 1,048,576 samples,
        66 s = 3x (unless an explicit sample_size was given). Checkpoints
        are not read; the weights stay the seeded random ones."""
        if model_len not in ("22s", "66s"):
            raise ValueError(f"model_len must be '22s' or '66s', got {model_len!r}")
        if not self._explicit_sample_size:
            self.sample_size = self.SAMPLES_22S * (3 if model_len == "66s" else 1)
        self.demo_samples = self.sample_size
        return self

    # -- CLAP --
    def embed(self, x, *args, **kwargs):
        raise NotImplementedError(CLAP_NOT_PORTED)

    def encode(self, x, *args, **kwargs):
        raise NotImplementedError(CLAP_NOT_PORTED)

    # -- generation --
    def _as_input(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return torch.as_tensor(a).to(self.device, self.dtype)

    def _noise(self, shape, given) -> torch.Tensor:
        if given is not None:
            return self._as_input(given)
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32).to(self.dtype)

    @torch.inference_mode()
    def encode_audio_latents(self, audio) -> torch.Tensor:
        """The init-audio path: (B, 2, T) audio -> stage-2 latents."""
        self.ensure_params()
        return self.latent_diffae.encode(self._as_input(audio))

    def _stage(self, name: str, t0: float, timed: bool) -> float:
        if not timed:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.last_stage_times[name] = self.last_stage_times.get(name, 0.0) + now - t0
        return now

    @torch.inference_mode()
    def generate(self, audio_embeddings, cfg_scales=4, demo_steps: int = 150,
                 outer_steps: int = 100, init_audio_latents=None,
                 init_strength: float = 0.4, batch_size: int = 1, flatten: bool = True,
                 latent_noise=None, s1_noise=None, init_noise=None,
                 stage_times: bool = False):
        """CFG latent diffusion -> outer v-diffusion -> AE decode.

        audio_embeddings: (1 or B, 1, 512) unit CLAP embeddings. Returns
        (audio, stage-2 latents): audio (2, B * sample_size) when
        `flatten`, else (B, 2, sample_size). The noises (latent_noise
        (B, 32, n), s1_noise (B, 32, 16 n), init_noise like the init
        latents) are drawn from `generator` unless given. With
        `stage_times`, the inner, outer and AE-decode seconds land in
        `last_stage_times` (the card is synchronised at each stage)."""
        self.ensure_params()
        emb = self._as_input(audio_embeddings)
        while emb.dim() < 3:
            emb = emb[None]
        cfg_scale = float(cfg_scales[0] if isinstance(cfg_scales, (list, tuple))
                          else cfg_scales)
        unet = self.latent_diffusion_model.diffusion
        self.last_stage_times = {}
        if stage_times and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()

        def ldm_fn(t_len: int):
            rb = precompute_rel_biases(unet, t_len)     # once per generate
            return lambda x, t, embedding: unet(x, t, embedding=embedding,
                                                embedding_scale=cfg_scale, rel_biases=rb)

        if init_audio_latents is not None:
            lat = self._as_input(init_audio_latents)
            noise = None if init_noise is None else self._as_input(init_noise)
            fake_latents = torch.clamp(resample_diffusion(
                ldm_fn(lat.shape[-1]), lat, steps=demo_steps,
                noise_level=1.0 - init_strength, generator=self.generator, noise=noise,
                embedding=emb), -1, 1)
        else:
            n_latent = self.demo_samples // self.downsampling_ratio
            noise = self._noise((batch_size, self.latent_dim, n_latent), latent_noise)
            fake_latents = torch.clamp(
                kdiff_sample(ldm_fn(n_latent), noise, demo_steps, embedding=emb), -1, 1)
        t0 = self._stage("inner_s", t0, stage_times)

        la = self.latent_diffae
        b = fake_latents.shape[0]
        s1 = self._noise((b, la.latent_dim,
                          fake_latents.shape[2] * la.latent_downsampling_ratio), s1_noise)
        parts = []
        for i in range(0, b, self.DECODE_BATCH):
            sl = slice(i, min(i + self.DECODE_BATCH, b))
            first = torch.clamp(vddim_sample(la.diffusion_v, s1[sl], outer_steps, 0,
                                             fake_latents[sl]), -1, 1)
            t0 = self._stage("outer_s", t0, stage_times)
            parts.append(la.decode_first_stage(first))
            t0 = self._stage("decode_s", t0, stage_times)
        fakes = torch.cat(parts)
        if flatten:                                 # 'b d n -> d (b n)'
            bb, d, n = fakes.shape
            fakes = fakes.transpose(0, 1).reshape(d, bb * n)
        return fakes, fake_latents
