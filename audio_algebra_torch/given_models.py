"""given_models — the spectrogram autoencoders, the DVAE wrapper of the
Destructo path and the MIRAGE model CLAPDAE.

Port of audio_algebra_tpu/given_models.py: GivenModelClass (forward and
`model(x)`, setup, match_sizes, zero_pad_po2, next_power_of_2) and its
subclasses SpectrogramAE, MagSpectrogramAE, MagDPhaseSpectrogramAE,
MelSpectrogramAE, DVAEWrapper and CLAPDAE, with JAX's `setup` signatures;
`setup` reads no checkpoint yet and keeps the seeded weights. Each takes
an explicit `device` (default "cuda") and draws its random numbers from
its own torch.Generator unless the caller hands them in.

The spectrogram models run on the port's STFT front end (ops/stft.py,
ops/mel.py, ops/phase.py), whose forward STFT is kernel K6 on the card:
SpectrogramAE is the exact complex round trip, MagSpectrogramAE and
MelSpectrogramAE decode with Griffin-Lim (`init_angle` optional),
MagDPhaseSpectrogramAE codes magnitude and phase increments.

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

CLAPDAE. `embed` turns a text prompt or a clip into a (1, 1, 512) CLAP
embedding (models/clap.py: the HTSAT audio tower on the mel front end,
the RoBERTa text tower), kept in f32 under `half()`. `generate` runs the
MIRAGE stack from (B, 1, 512) embeddings: a DPM++(2M) with
classifier-free guidance over the CLAP-conditioned UNetCFG1d (kernels K3
and K5), a v-DDIM over the outer DiffusionAttnUnet1D (kernel K1), then
the AudioAutoencoder decode.
"""
from __future__ import annotations

import inspect
import time
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models.blocks import TURBO_MIN_B
from .models.clap import CLAPModule
from .models.dvae import DiffusionDVAE
from .models.stacked import LatentAudioDiffusionAutoencoder, StackedAELatentDiffusionCond
from .models.unet_cfg1d import precompute_rel_biases
from .samplers.kdiff import kdiff_sample
from .samplers.vddim import resample_diffusion
from .samplers.vddim import sample as vddim_sample
from .ops.mel import inverse_mel_scale, melspectrogram
from .ops.phase import mag_dphase_decode, mag_dphase_encode
from .ops.stft import griffin_lim, inverse_spectrogram, spectrogram
from .utils import params as params_mod

__all__ = ["GivenModelClass", "SpectrogramAE", "MagSpectrogramAE",
           "MagDPhaseSpectrogramAE", "MelSpectrogramAE", "DVAEWrapper", "CLAPDAE"]


class GivenModelClass:
    """The shared surface of the given models (JAX given_models.py:48-186):
    waveform in, representation out, and back, with optional zero padding
    to a power of two and the decode cropped or padded to the input's
    length."""

    def __init__(self, zero_pad: bool = True, make_sizes_match: bool = True,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.zero_pad, self.make_sizes_match = zero_pad, make_sizes_match
        self.orig_shape = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _as_input(self, a) -> torch.Tensor:
        """numpy or torch -> a tensor on the model's device (float32 unless
        complex)."""
        t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a)
        return t.to(self.device, None if t.is_complex() else torch.float32)

    def _waveform(self, waveform) -> torch.Tensor:
        x = self._as_input(waveform)
        self.orig_shape = tuple(x.shape)
        return self.zero_pad_po2(x) if self.zero_pad else x

    def setup(self, gdrive: bool = True):
        """JAX's hook for fetching and loading checkpoints. The port reads
        no checkpoint yet: the weights stay the seeded random ones."""
        return self

    def forward(self, waveform):
        """encode then decode; returns (reps, recons)."""
        reps = self.encode(waveform)
        return reps, self.decode(reps)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def match_sizes(self, recon: torch.Tensor) -> torch.Tensor:
        """Crop or zero-pad the decode's last axis to the input's length."""
        if self.make_sizes_match and self.orig_shape is not None \
                and tuple(recon.shape) != tuple(self.orig_shape):
            target = self.orig_shape[-1]
            if recon.shape[-1] > target:
                recon = recon[..., :target]
            else:
                recon = torch.nn.functional.pad(recon, (0, target - recon.shape[-1]))
        return recon

    @staticmethod
    def next_power_of_2(x: int) -> int:
        return 1 if x == 0 else 2 ** (x - 1).bit_length()

    def zero_pad_po2(self, x: torch.Tensor) -> torch.Tensor:
        new_len = self.next_power_of_2(x.shape[-1])
        return torch.nn.functional.pad(x, (0, new_len - x.shape[-1]))


class SpectrogramAE(GivenModelClass):
    """The complex spectrogram and its exact inverse."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256, center: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.n_fft, self.hop_length, self.center = n_fft, hop_length, center

    @torch.inference_mode()
    def encode(self, waveform, **kwargs) -> torch.Tensor:
        return spectrogram(self._waveform(waveform), self.n_fft, self.hop_length,
                           power=None, center=self.center)

    @torch.inference_mode()
    def decode(self, reps, **kwargs) -> torch.Tensor:
        return self.match_sizes(inverse_spectrogram(
            self._as_input(reps), self.n_fft, self.hop_length, center=self.center))


class MagSpectrogramAE(GivenModelClass):
    """The power spectrogram; Griffin-Lim decodes it."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256, center: bool = True,
                 n_iter: int = 32, **kwargs):
        super().__init__(**kwargs)
        self.n_fft, self.hop_length, self.center, self.n_iter = \
            n_fft, hop_length, center, n_iter

    @torch.inference_mode()
    def encode(self, waveform, **kwargs) -> torch.Tensor:
        return spectrogram(self._waveform(waveform), self.n_fft, self.hop_length,
                           power=2, center=self.center)

    @torch.inference_mode()
    def decode(self, reps, init_angle=None, **kwargs) -> torch.Tensor:
        """Griffin-Lim from `init_angle` (radians, reps' shape) or from
        angles drawn from the model's generator."""
        return self.match_sizes(griffin_lim(
            self._as_input(reps), self.n_fft, self.hop_length, power=2.0,
            n_iter=self.n_iter, init_angle=init_angle, generator=self.generator))


class MagDPhaseSpectrogramAE(GivenModelClass):
    """Magnitude + phase-increment coding with an exact decoder (init
    'true'); init 'rand' starts the phase at explicit or drawn noise."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256, center: bool = True,
                 init: str = "true", use_cos: bool = False, debug: bool = False,
                 cheat: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.n_fft, self.hop_length, self.center = n_fft, hop_length, center
        self.init, self.use_cos, self.debug, self.cheat = init, use_cos, debug, cheat
        self.theta = None

    @torch.inference_mode()
    def encode(self, waveform, **kwargs) -> torch.Tensor:
        spec = spectrogram(self._waveform(waveform), self.n_fft, self.hop_length,
                           power=None, center=self.center)
        if self.cheat:
            self.spec_orig, self.mag_orig = spec, torch.abs(spec)
            self.theta = torch.angle(spec)
        return mag_dphase_encode(spec, use_cos=self.use_cos)

    @torch.inference_mode()
    def decode(self, reps, noise=None, **kwargs) -> torch.Tensor:
        """`noise`: uniform [0, 1) phase origins for init 'rand'."""
        reps = self._as_input(reps)
        if self.cheat and self.theta is not None:
            mag = reps[..., :reps.shape[-3] // 2, :, :]
            spec = torch.complex(mag * torch.cos(self.theta), mag * torch.sin(self.theta))
        else:
            spec = mag_dphase_decode(reps, self.init, noise, self.generator)
        if self.debug:
            self.spec_new, self.mag_new = spec, torch.abs(spec)
        return self.match_sizes(inverse_spectrogram(spec, self.n_fft, self.hop_length,
                                                    center=self.center))


class MelSpectrogramAE(GivenModelClass):
    """The mel power spectrogram; the regularised inverse mel scale and
    Griffin-Lim decode it."""

    def __init__(self, sample_rate: int = 48000, n_fft: int = 1024, hop_length: int = 256,
                 center: bool = True, n_mels: int = 128, n_iter: int = 32, **kwargs):
        super().__init__(**kwargs)
        self.sample_rate, self.n_fft, self.hop_length = sample_rate, n_fft, hop_length
        self.center, self.n_mels, self.n_iter = center, n_mels, n_iter

    @torch.inference_mode()
    def encode(self, waveform, **kwargs) -> torch.Tensor:
        return melspectrogram(self._waveform(waveform), self.sample_rate, self.n_fft,
                              self.hop_length, n_mels=self.n_mels, center=self.center)

    @torch.inference_mode()
    def decode(self, melspec, init_angle=None, **kwargs) -> torch.Tensor:
        spec = inverse_mel_scale(self._as_input(melspec), self.n_fft // 2 + 1,
                                 self.sample_rate, self.n_mels)
        return self.match_sizes(griffin_lim(
            spec, self.n_fft, self.hop_length, power=2.0, n_iter=self.n_iter,
            init_angle=init_angle, generator=self.generator))


class DVAEWrapper(GivenModelClass):
    DEFAULT_ARGS = {"num_quantizers": 0, "sample_size": 65536, "demo_steps": 50,
                    "sample_rate": 48000, "latent_dim": 64, "pqmf_bands": 1}

    def __init__(self, args_dict: Optional[dict] = None,
                 model_kwargs: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, turbo: bool = False,
                 turbo_min_b: int = TURBO_MIN_B, **kwargs):
        super().__init__(seed=seed, device=device, **kwargs)
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

    def setup(self, gdrive: bool = True) -> "DVAEWrapper":
        """JAX's checkpoint hook. The port reads no checkpoint yet: it says
        so and keeps the seeded random weights, as JAX does without a
        file."""
        print("DVAEWrapper: no checkpoint is read; going with random weights")
        self.ensure_params()
        return self

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
        self.orig_shape = tuple(waveform.shape)
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


class CLAPDAE(GivenModelClass):
    """The MIRAGE model: CLAP-conditioned stacked latent diffusion.

    `clap_module` (models/clap.CLAPModule: HTSAT with fusion by default,
    and RoBERTa; `clap_kwargs` passes its configs and asset directory)
    embeds text and audio prompts, in f32, with seeded random weights
    (seed + 2, + 3) unless a flax tree is poured in. `latent_diffae` (LatentAudioDiffusionAutoencoder) and
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

    def __init__(self, clap_fusion: bool = True, clap_amodel: str = "HTSAT-base",
                 first_stage_config: Optional[dict] = None,
                 sample_size: int = SAMPLES_22S, model_kwargs: Optional[dict] = None,
                 clap_kwargs: Optional[dict] = None,
                 seed: int = 0, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(seed=seed, device=device, **kwargs)
        self.clap_module = CLAPModule(enable_fusion=clap_fusion, amodel=clap_amodel,
                                      seed=seed + 2, device=self.device,
                                      **(clap_kwargs or {}))
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

    def freeze_for_training(self) -> "CLAPDAE":
        """What the trainer reads: the stage-1 stack and CLAP frozen
        (requires_grad off, eval), the latent diffusion model in f32 with
        requires_grad on. Returns self."""
        self.ensure_params()
        self.clap_module.ensure_params()
        frozen = (self.latent_diffae, self.clap_module.audio_model,
                  self.clap_module.text_model)
        for m in frozen:
            m.requires_grad_(False).eval()
        self.latent_diffusion_model.to(self.device, torch.float32).requires_grad_(True)
        return self

    @property
    def ldm_params(self) -> dict:
        """The trainable parameters, name -> Parameter (JAX's `ldm_params`)."""
        return dict(self.latent_diffusion_model.named_parameters())

    def half(self, dtype: torch.dtype = torch.bfloat16) -> "CLAPDAE":
        """Cast both diffusion stages (and the AE) to bf16, the reference
        app's default; CLAP stays f32. Returns self."""
        self.ensure_params()
        self.dtype = dtype
        self._place()
        return self

    def setup(self, gdrive: bool = True, model_len: str = "22s") -> "CLAPDAE":
        """Set the sample size of a model length: 22 s = 1,048,576 samples,
        66 s = 3x (unless an explicit sample_size was given). Checkpoints
        are not read yet (JAX reads them from environment variables): the
        weights stay the seeded random ones."""
        if model_len not in ("22s", "66s"):
            raise ValueError(f"model_len must be '22s' or '66s', got {model_len!r}")
        if not self._explicit_sample_size:
            self.sample_size = self.SAMPLES_22S * (3 if model_len == "66s" else 1)
        self.demo_samples = self.sample_size
        print("CLAPDAE: no checkpoint is read; going with random weights")
        return self

    # -- CLAP --
    def embed(self, x, *args, **kwargs) -> torch.Tensor:
        """A text prompt, or audio (T,), (C, T) or (B, C, T) at 48 kHz
        (averaged to mono) -> (B, 1, 512) unit CLAP embeddings, f32. A text
        is embedded beside the empty prompt and the first row kept. The
        result is an ordinary tensor without a graph (CLAP runs under
        no_grad), so a trainer may feed it to a model."""
        if isinstance(x, str):
            emb = self.clap_module.get_text_embedding([x, ""])[:1]
        else:
            audio = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                                    else x).float()
            while audio.dim() < 3:
                audio = audio[None]
            emb = self.clap_module.get_audio_embedding_from_data(audio.mean(dim=1))
        return emb[:, None, :]

    def encode(self, x, *args, **kwargs) -> torch.Tensor:
        return self.embed(x, *args, **kwargs)

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

    @torch.no_grad()
    def encode_audio_latents(self, audio) -> torch.Tensor:
        """The init-audio path, and the trainer's frozen encoder: (B, 2, T)
        audio -> stage-2 latents. Under no_grad, not inference_mode: the
        trainer feeds the latents into a graph."""
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

    def decode(self, *args, **kwargs):
        """`generate` (JAX's alias)."""
        return self.generate(*args, **kwargs)

    def forward(self, waveform_in, *args, **kwargs):
        """Embed a prompt and generate from it, as JAX's CLAPDAE.forward:
        returns `generate`'s (audio, stage-2 latents)."""
        return self.decode(self.encode(waveform_in, *args), **kwargs)
