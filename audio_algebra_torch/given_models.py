"""given_models — the spectrogram autoencoders, the DVAE wrapper of the
Destructo path, the stacked diffusion AE, DMAE, RAVE and the MIRAGE
model CLAPDAE.

Port of audio_algebra_tpu/given_models.py: GivenModelClass (forward and
`model(x)`, setup, get_checkpoint, match_sizes, zero_pad_po2,
next_power_of_2) and its subclasses SpectrogramAE, MagSpectrogramAE,
MagDPhaseSpectrogramAE, MelSpectrogramAE, DVAEWrapper,
StackedDiffAEWrapper, DMAE1d, RAVEWrapper and CLAPDAE, with JAX's
`setup` signatures. Each takes an explicit `device` (default "cuda") and
draws its random numbers from its own torch.Generator unless the caller
hands them in.

Checkpoints. `setup` reads the reference's torch file named by
`ckpt_info['ckpt_path']` (CLAPDAE: the environment variables
LATENT_DIFFAE_CKPT, CLAP_CKPT and CLAPDAE_CKPT_{22s,66s}) and pours it
into the model through convert.py, printing the hit and miss counts;
without a file, or when it does not load, the weights stay the seeded
random ones, with JAX's messages. `get_checkpoint` checks a file's
SHA-256 against `ckpt_info['ckpt_hash']` and raises RuntimeError on a
mismatch. It downloads (curl) only when the caller puts a URL in
`ckpt_info['ckpt_url']`: the port's wrappers carry none by default (the
JAX package's DVAE and DMAE URLs are Google Drive share pages, which a
plain fetch does not serve), so no run of the port reaches the network
unless asked to.

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
wrapper's `params_ema`; a checkpoint's EMA copy). Without a checkpoint
they are the seeded random weights of utils/params.random_init_;
`load_flax_params(tree)` loads a flax params tree instead.

StackedDiffAEWrapper (the two-stage LatentAudioDiffusionAutoencoder):
encode to stage-2 latents; decode_stage1to2 samples the stage-1 latents
by v-DDIM over `diffusion_v` (kernel K1 on the card), or with `turbo=True`
over `diffusion_v_aux` with the amax carry (K1, K2a/b/c) at batch >=
`turbo_min_b`; decode_stage2 is the AE decode. DMAE1d: archinet's
DiffusionAE around 48 <-> 44.1 kHz resampling; its mel front end is K6 at
center=False, its decode a 50-step v-DDIM. RAVEWrapper: RAVE v2 on PQMF
bands, with an export's latent PCA applied when its checkpoint carries
one.

CLAPDAE. `embed` turns a text prompt or a clip into a (1, 1, 512) CLAP
embedding (models/clap.py: the HTSAT audio tower on the mel front end,
the RoBERTa text tower), kept in f32 under `half()`. `generate` runs the
MIRAGE stack from (B, 1, 512) embeddings: a DPM++(2M) with
classifier-free guidance over the CLAP-conditioned UNetCFG1d (kernels K3
and K5), a v-DDIM over the outer DiffusionAttnUnet1D (kernel K1), then
the AudioAutoencoder decode. The outer v-DDIM and the AE decode run in
micro-batches of `decode_batch` rows (default 4; JAX's
AA_MIRAGE_DECODE_BATCH, which only the mirage and serve entry points read).
`turbo=True` (JAX: AA_TURBO_INT8=1) takes JAX's turbo routes of the outer
stage, one per micro-batch: at a micro-batch >= `turbo_min_b` the amax
carry of the stacked AE's; below it, int8 inside the fold
(parallel/fold.decode_unet_seqfold, `quantized=True`: the folded levels'
conv5s on a dynamic amax, K1 for every GroupNorm). So `decode_batch`
chooses the route too: at the default 4 and turbo_min_b 16 every
micro-batch takes the fold.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .checkpoint import load_torch_checkpoint
from .convert import (convert_dmae_state_dict, convert_ldm_state_dict,
                      convert_rave_state_dict, convert_stacked_state_dict,
                      extract_rave_latent_transform, load_torchscript_state_dict, pour)
from .convert_dvae import convert_dvae_state_dict
from . import tracing
from .device import resolve_device
from .models.blocks import TURBO_MIN_B, turbo_batch_ok
from .models.clap import CLAPModule
from .models.dmae import DiffusionAE1d
from .models.dvae import DiffusionDVAE
from .models.rave import RAVE
from .models.stacked import LatentAudioDiffusionAutoencoder, StackedAELatentDiffusionCond
from .models.unet_cfg1d import precompute_rel_biases
from .samplers.kdiff import kdiff_sample
from .samplers.vddim import resample_diffusion
from .samplers.vddim import sample as vddim_sample
from .ops.mel import inverse_mel_scale, melspectrogram
from .ops.phase import mag_dphase_decode, mag_dphase_encode
from .ops.resample import resample
from .ops.stft import griffin_lim, inverse_spectrogram, spectrogram
from .utils import params as params_mod

__all__ = ["GivenModelClass", "SpectrogramAE", "MagSpectrogramAE",
           "MagDPhaseSpectrogramAE", "MelSpectrogramAE", "DVAEWrapper",
           "StackedDiffAEWrapper", "DMAE1d", "RAVEWrapper", "CLAPDAE"]

NO_CKPT = {"ckpt_path": "", "ckpt_url": "", "ckpt_hash": "", "gdrive_path": ""}


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()


class GivenModelClass:
    """The shared surface of the given models (JAX given_models.py:48-186):
    waveform in, representation out, and back, with optional zero padding
    to a power of two and the decode cropped or padded to the input's
    length."""

    def __init__(self, zero_pad: bool = True, make_sizes_match: bool = True,
                 ckpt_info: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.zero_pad, self.make_sizes_match = zero_pad, make_sizes_match
        self.orig_shape = None
        self.ckpt_info = dict(ckpt_info or NO_CKPT)
        self.ckpt_dir = os.path.expanduser("~/checkpoints")
        self.name = type(self).__name__
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
        """Fetch and load checkpoints; the spectrogram models have none."""
        return self

    def get_checkpoint(self, gdrive: bool = True):
        """Make sure the checkpoint file is there (JAX given_models.py:120-160).
        A present file is checked against `ckpt_info['ckpt_hash']` when one
        is given: a mismatch raises RuntimeError. A missing file is fetched
        with curl only when `ckpt_info['ckpt_url']` is set, and removed if
        it fails its hash; with no URL nothing happens and setup goes on
        with random weights."""
        info = self.ckpt_info
        if not info or all(v == "" for v in info.values()):
            print("No checkpoint info available.")
            return
        ckpt_file = os.path.expanduser(info.get("ckpt_path", ""))
        if ckpt_file and os.path.exists(ckpt_file):
            print("Checkpoint found!")
            if info.get("ckpt_hash"):
                # a raise, not an assert: `python -O` strips asserts
                if _sha256(ckpt_file) != info["ckpt_hash"]:
                    raise RuntimeError("Hashes don't match. STOP. DO NOT EXECUTE.")
                print("Checkpoint hash checks out.")
            return
        url = info.get("ckpt_url", "")
        if url and ckpt_file:
            print(f"Downloading to {ckpt_file}")
            try:
                os.makedirs(os.path.dirname(ckpt_file) or ".", exist_ok=True)
                # an argv, not a shell string; --fail keeps an HTTP error
                # page from being saved as the checkpoint
                subprocess.run(["curl", "-L", "--fail", "--connect-timeout", "5",
                                "--max-time", "300", url, "-o", ckpt_file],
                               check=True, timeout=330)
                if info.get("ckpt_hash") and _sha256(ckpt_file) != info["ckpt_hash"]:
                    os.remove(ckpt_file)
                    print("Downloaded file failed its SHA-256 check; "
                          "removed. Continuing without checkpoint")
            except Exception as e:
                print(f"Download failed ({e}); continuing without checkpoint")

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


class _TorchWrapper(GivenModelClass):
    """A given model around one torch module, held on `device` in `dtype`,
    with the seeded random weights until a checkpoint or a flax tree is
    loaded."""

    def __init__(self, model: torch.nn.Module, seed: int = 0,
                 device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(seed=seed, device=device, **kwargs)
        self.seed, self.dtype = seed, dtype
        self.model = model.eval()
        self._loaded = False

    def load_flax_params(self, tree: dict) -> None:
        """Load a flax params tree (the JAX wrapper's `params`)."""
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
            a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return torch.as_tensor(a).to(self.device, self.dtype)

    def _noise(self, shape, given) -> torch.Tensor:
        if given is not None:
            return self._as_input(given)
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32).to(self.dtype)

    def _pour(self, converter, sd) -> tuple[int, list]:
        """Pour `sd` into the model (convert.pour), then put it on its
        device and dtype. Before any weights are loaded the leaves the pour
        leaves unreached take the seeded random init: the weights of
        ensure_params() and a pour, without drawing what the pour
        overwrites."""
        init = None if self._loaded else (lambda: params_mod.random_init_(self.model, self.seed))
        out = pour(self.model, converter, sd, init=init)
        self.model.to(self.device, self.dtype)
        self._loaded = True
        return out

    def _pour_file(self, converter) -> None:
        """Pour the torch file at ckpt_info['ckpt_path'] through
        `converter`, or keep the random weights with JAX's message."""
        try:
            sd = load_torch_checkpoint(os.path.expanduser(self.ckpt_info["ckpt_path"]))
            print(f"{self.name}: loaded torch state dict ({len(sd)} tensors)")
            self._pour(converter, sd)
        except Exception as e:
            print(f"Sorry, exception = {e}. Going with random weights")
        self.ensure_params()


class DVAEWrapper(_TorchWrapper):
    """The DiffusionDVAE of the Destructo path: encode to tanh latents,
    decode by v-DDIM. `setup` pours the reference's checkpoint (its EMA
    copy)."""

    DEFAULT_ARGS = {"num_quantizers": 0, "sample_size": 65536, "demo_steps": 50,
                    "sample_rate": 48000, "latent_dim": 64, "pqmf_bands": 1}

    def __init__(self, args_dict: Optional[dict] = None,
                 model_kwargs: Optional[dict] = None, turbo: bool = False,
                 turbo_min_b: int = TURBO_MIN_B, **kwargs):
        args = dict(self.DEFAULT_ARGS)
        args.update(args_dict or {})
        super().__init__(DiffusionDVAE(
            latent_dim=args["latent_dim"], pqmf_bands=args["pqmf_bands"],
            num_quantizers=args["num_quantizers"], **(model_kwargs or {})), **kwargs)
        self.turbo, self.turbo_min_b = turbo, turbo_min_b
        self.noise: Optional[torch.Tensor] = None
        self.demo_steps = args["demo_steps"]
        self.demo_samples = args["sample_size"]
        # the reference checkpoint's path and hash; no URL (see the module
        # docstring): set ckpt_info["ckpt_url"] to fetch it
        self.ckpt_info = {"ckpt_url": "", "gdrive_path": "MyDrive/AI/checkpoints/DiffusionDVAE.ckpt",
                          "ckpt_hash": "6a304c3e89ea3f7ca023f4c9accc5df8de0504595db41961cc7e8b0d07876ef5",
                          "ckpt_path": "~/checkpoints/dvae_checkpoint.ckpt"}

    def setup(self, gdrive: bool = True) -> "DVAEWrapper":
        """Pour the torch checkpoint at ckpt_info['ckpt_path'] (its EMA
        copy, convert_dvae.py); without one the seeded random weights
        stay."""
        ckpt_file = os.path.expanduser(self.ckpt_info["ckpt_path"])
        print(f"DVAE: attempting to load checkpoint {ckpt_file}")
        self.get_checkpoint(gdrive=gdrive)
        try:
            hits, misses = self._pour(convert_dvae_state_dict, load_torch_checkpoint(ckpt_file))
            print(f"DVAE: converted torch checkpoint — {hits} tensors mapped, "
                  f"{len(misses)} unmapped (kept random)")
        except Exception as e:
            print(f"Sorry, exception = {e}. Going with random weights")
        self.ensure_params()
        return self

    def _draw_noise(self, batch: int) -> torch.Tensor:
        return self._noise((batch, 2, self.demo_samples), None)

    @torch.inference_mode()
    def encode(self, waveform) -> torch.Tensor:
        """(B, 2, T) audio -> (B, latent_dim, T/128) tanh latents."""
        with tracing.span("dvae.encode", self.device):
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
        with tracing.span("dvae.decode", self.device):
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

    @torch.inference_mode()
    def decode_seqpar(self, reps, world, demo_steps: Optional[int] = None,
                      sharded_levels: Optional[int] = None) -> torch.Tensor:
        """`decode` with the diffusion UNet sequence-parallel over the ranks
        of `world` (a `seq` parallel.World; parallel/infer.py): the same
        sampler, crash schedule and stored noise. Every rank takes rank 0's
        whole noise and samples its time slab; the slabs are gathered, so
        every rank returns the (2, B * sample_size) audio. The float route
        only (JAX's sequence-parallel path is bf16 / f32)."""
        from .parallel.infer import decode_unet_seqpar
        if self.turbo:
            raise ValueError("decode_seqpar runs the float route: build the wrapper with "
                             "turbo=False")
        if demo_steps is None:
            demo_steps = self.demo_steps
        self.ensure_params()
        reps = self._as_input(reps)
        noise = self.noise
        if noise is None or noise.shape[0] != reps.shape[0]:
            noise = self._draw_noise(reps.shape[0])
        noise = self._as_input(noise).contiguous()
        world.broadcast_([noise])

        def model_fn(x, t, cond):
            return decode_unet_seqpar(self.model.diffusion, x, t, cond, world, sharded_levels)

        local = vddim_sample(model_fn, noise[..., world.slab(noise.shape[-1])].contiguous(),
                             demo_steps, 0, reps)
        fakes = world.all_gather_time(local)
        b, d, n = fakes.shape                     # 'b d n -> d (b n)'
        return fakes.transpose(0, 1).reshape(d, b * n)


class StackedDiffAEWrapper(_TorchWrapper):
    """The two-stage LatentAudioDiffusionAutoencoder (JAX
    given_models.py:475): `encode` to stage-2 latents, `decode_stage1to2`
    samples the stage-1 latents by v-DDIM, `decode_stage2` decodes them to
    audio. `turbo=True` samples the stage-1 latents on the UNet's int8
    route with the amax carry (JAX: AA_TURBO_INT8=1), which engages at
    batch >= `turbo_min_b` (JAX's AA_TURBO_MIN_B)."""

    DEFAULT_FIRST_STAGE = {"capacity": 64, "c_mults": [2, 4, 8, 16, 32],
                           "strides": [2, 2, 2, 2, 2], "latent_dim": 32}

    def __init__(self, debug: bool = True, first_stage_config: Optional[dict] = None,
                 ckpt_info: Optional[dict] = None, model_kwargs: Optional[dict] = None,
                 turbo: bool = False, turbo_min_b: int = TURBO_MIN_B, **kwargs):
        self.first_stage_config = fsc = first_stage_config or self.DEFAULT_FIRST_STAGE
        super().__init__(LatentAudioDiffusionAutoencoder(
            latent_dim=fsc["latent_dim"], ae_capacity=fsc["capacity"],
            ae_c_mults=tuple(fsc["c_mults"]), ae_strides=tuple(fsc["strides"]),
            **(model_kwargs or {})), **kwargs)
        self.debug = debug
        self.turbo, self.turbo_min_b = turbo, turbo_min_b
        self.latent_dim = self.model.latent_dim
        self.latent_downsampling_ratio = self.model.latent_downsampling_ratio
        self.ckpt_info = ckpt_info or {
            "ckpt_path": "~/checkpoints/stacked-diffae-more-310k.ckpt",
            "ckpt_hash": "91f33839ecb6e3c41b1e89e1a9e0de0dac2ebe1795efa034797429c202600a58",
            "ckpt_url": "", "gdrive_path": ""}

    @torch.inference_mode()
    def encode(self, reals) -> torch.Tensor:
        """(B, 2, T) audio -> (B, 32, T / 512) stage-2 latents."""
        self.ensure_params()
        return self.model.encode(self._as_input(reals))

    @torch.inference_mode()
    def decode_stage1to2(self, small_reps, steps: int = 100, noise=None) -> torch.Tensor:
        """Stage-2 latents (B, C, n) -> stage-1 latents (B, 32, n * 16) by
        v-DDIM from `noise` (drawn from `generator` unless given)."""
        self.ensure_params()
        small = self._as_input(small_reps)
        noise = self._noise((small.shape[0], self.latent_dim,
                             small.shape[2] * self.latent_downsampling_ratio), noise)
        if self.turbo:
            def model_fn(x, t, aux, cond):
                return self.model.diffusion_v_aux(x, t, cond, q_aux=aux,
                                                  turbo_min_b=self.turbo_min_b)
            return vddim_sample(model_fn, noise, steps, 0, small, aux_mode=True)
        return vddim_sample(self.model.diffusion_v, noise, steps, 0, small)

    @torch.inference_mode()
    def decode_stage2(self, first_stage_sampled, steps: int = 100) -> torch.Tensor:
        """Stage-1 latents -> audio: the AE decode of the clamped latents.
        `steps` is unused, as in the reference (no sampling here)."""
        self.ensure_params()
        return self.model.decode_first_stage(
            torch.clamp(self._as_input(first_stage_sampled), -1, 1))

    def decode(self, reps, steps: int = 100, noise=None) -> torch.Tensor:
        return self.decode_stage2(self.decode_stage1to2(reps, steps=steps, noise=noise),
                                  steps=steps)

    def setup(self, gdrive: bool = True) -> "StackedDiffAEWrapper":
        """Pour the torch checkpoint at ckpt_info['ckpt_path'] with the EMA
        swap (convert_stacked_state_dict)."""
        print(f"{self.name}: attempting to load checkpoint {self.ckpt_info['ckpt_path']}")
        self.get_checkpoint(gdrive=gdrive)
        self._pour_file(convert_stacked_state_dict)
        print(f"{self.name}: Setup completed.")
        return self


class DMAE1d(_TorchWrapper):
    """archinet's DiffusionAE (JAX given_models.py:573): 48 kHz audio is
    resampled to 44.1 kHz and zero-padded to a power of two, encoded by
    the mel encoder (K6 at center=False on the card); decode is a 50-step
    v-DDIM, resampled back to 48 kHz."""

    def __init__(self, debug: bool = False, model_kwargs: Optional[dict] = None, **kwargs):
        super().__init__(DiffusionAE1d(**(model_kwargs or {})), **kwargs)
        self.debug = debug
        self.ckpt_info = {
            "ckpt_url": "", "ckpt_path": "~/checkpoints/dmae1d_checkpoint.ckpt",
            "ckpt_hash": "a11a9c68e5962830b142202e25b3080f553a3a73cd944225b3c7d21fe8c631e9"}
        self._cfg = {"downsample": self.model.downsampling_ratio}
        self.num_steps = 50

    def _pre(self, waveform_in) -> torch.Tensor:
        w = self._as_input(waveform_in)
        self.orig_shape = tuple(w.shape)
        return self.zero_pad_po2(resample(w, 48000, 44100))

    @torch.inference_mode()
    def encode(self, waveform_in, *args, **kwargs) -> torch.Tensor:
        """(B, 2, T) at 48 kHz -> (B, 32, T' / 1024) latents in [-1, 1]."""
        self.ensure_params()
        return self.model.encode(self._pre(waveform_in))

    @torch.inference_mode()
    def decode(self, latents, *args, num_steps: Optional[int] = None, noise=None,
               **kwargs) -> torch.Tensor:
        """Latents -> 48 kHz audio matched to the encoded input's length,
        by v-DDIM from `noise` (B, 2, n * 1024) (drawn unless given)."""
        self.ensure_params()
        z = self._as_input(latents)
        noise = self._noise((z.shape[0], 2, z.shape[-1] * self._cfg["downsample"]), noise)
        out = vddim_sample(lambda x, t, cond: self.model.decode_v(x, t, cond), noise,
                           num_steps or self.num_steps, 0, z)
        return self.match_sizes(resample(out, 44100, 48000))

    def forward(self, waveform_in, *args, **kwargs):
        return self.decode(self.encode(waveform_in))

    def setup(self, gdrive: bool = True) -> "DMAE1d":
        """Pour the `model_state_dict` checkpoint (convert_dmae_state_dict)."""
        print(f"{self.name}: attempting to load checkpoint "
              f"{os.path.expanduser(self.ckpt_info['ckpt_path'])}")
        self.get_checkpoint(gdrive=gdrive)
        self._pour_file(convert_dmae_state_dict)
        return self


class RAVEWrapper(_TorchWrapper):
    """RAVE v2 (JAX given_models.py:659) on mono audio: encode to the
    posterior mean, decode with the noise head's uniform noise drawn from
    `generator` (or given). `setup` reads a TorchScript export (.ts) or a
    Lightning .ckpt; an export's latent PCA rotates the latents."""

    latent_pca = None
    latent_mean = None

    def __init__(self, pretrained_name: str = "", checkpoint_file: str = "percussion",
                 config_path: str = "./v2.gin", debug: bool = True,
                 latent_dim: int = 128, n_bands: int = 16, **model_kwargs):
        kwargs = {k: model_kwargs.pop(k) for k in
                  ("zero_pad", "make_sizes_match", "ckpt_info", "seed", "device", "dtype")
                  if k in model_kwargs}
        super().__init__(RAVE(latent_dim=latent_dim, n_bands=n_bands, **model_kwargs),
                         **kwargs)
        self.config_path, self.debug = config_path, debug
        if Path(checkpoint_file).suffix == "":
            checkpoint_file += ".ts"
        self.ckpt_info = {"ckpt_url": "", "ckpt_hash": "", "gdrive_path": "",
                          "ckpt_path": f"{self.ckpt_dir}/{checkpoint_file}"}

    def setup(self, gdrive: bool = False) -> "RAVEWrapper":
        """A TorchScript archive (.ts) through torch.jit.load, a .ckpt
        through its state dict; both pour by shape signature after the
        weight-norm fusion."""
        self.get_checkpoint(gdrive=gdrive)
        path = os.path.expanduser(self.ckpt_info["ckpt_path"])
        ext = Path(path).suffix
        if self.debug:
            print("extension =", ext)
        sd = None
        try:
            if ext in (".ts", "") and os.path.exists(path):
                sd = load_torchscript_state_dict(path)
            elif ext == ".ckpt" and os.path.exists(path):
                sd = load_torch_checkpoint(path)
            elif os.path.exists(path):
                print(f"Sorry, we don't know how to load {ext} checkpoint "
                      "files. Weights will be uninitialized.")
        except Exception as e:
            print(f"Sorry, exception = {e}. Going with random weights")
        if sd:
            print(f"{self.name}: loaded state dict ({len(sd)} tensors)")
            self._pour(convert_rave_state_dict, sd)
            pca, mean = extract_rave_latent_transform(sd)
            if pca is not None and mean is not None and pca.shape[-1] == self.model.latent_dim:
                self.latent_pca = torch.from_numpy(pca).to(self.device, self.dtype)
                self.latent_mean = torch.from_numpy(mean).to(self.device, self.dtype)
                print(f"{self.name}: applying exported latent PCA "
                      f"({pca.shape[0]} of {pca.shape[1]} dims)")
        self.ensure_params()
        return self

    @torch.inference_mode()
    def encode(self, waveform, **kwargs) -> torch.Tensor:
        """(B, 1, T) or (1, T) mono -> (B, latent_dim (or the PCA's rows),
        T / 2048)."""
        self.ensure_params()
        x = self._as_input(waveform)
        if x.dim() == 2:
            x = x[None]
        z = self.model.encode(x)
        if self.latent_pca is not None:
            z = torch.einsum("ij,bjt->bit", self.latent_pca, z - self.latent_mean[None, :, None])
        return z

    @torch.inference_mode()
    def decode(self, reps, noise=None, **kwargs) -> torch.Tensor:
        """Latents -> (B, 1, T) audio. The PCA's rows are orthonormal, so
        its inverse is the transpose plus the mean; a cropped export's
        missing dims come back as zeros."""
        self.ensure_params()
        z = self._as_input(reps)
        if self.latent_pca is not None:
            z = torch.einsum("ji,bjt->bit", self.latent_pca, z) + self.latent_mean[None, :, None]
        return self.model.decode(z, noise=None if noise is None else self._as_input(noise),
                                 generator=self.generator)


def _kwargs_of(cls, exclude=()) -> set:
    return {n for n in inspect.signature(cls.__init__).parameters
            if n not in ("self", *exclude)}


_STAGE_KEYS = {"clapdae.inner": "inner_s", "clapdae.outer": "outer_s",
               "clapdae.ae_decode": "decode_s"}   # `last_stage_times`' keys


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
    `setup` pours the checkpoints the environment names, and
    `load_flax_params(diffae_tree, ldm_tree)` loads flax trees instead.
    Noise is drawn from `generator` unless the caller passes it.
    `decode_batch` (JAX's AA_MIRAGE_DECODE_BATCH, default 4; below 1 taken
    as 1) is the micro-batch of the outer v-DDIM and the AE decode, which
    bounds their memory; under `turbo` it also picks the outer stage's int8
    route (`_outer`): the amax carry where a micro-batch has at least
    `turbo_min_b` rows, else int8 in the fold."""

    DEFAULT_FIRST_STAGE = {"capacity": 64, "c_mults": [2, 4, 8, 16, 32],
                           "strides": [2, 2, 2, 2, 2], "latent_dim": 32}
    SAMPLES_22S = 1048576
    DECODE_BATCH = 4         # the default micro-batch of the outer stage + AE decode

    def __init__(self, clap_fusion: bool = True, clap_amodel: str = "HTSAT-base",
                 first_stage_config: Optional[dict] = None,
                 sample_size: int = SAMPLES_22S, model_kwargs: Optional[dict] = None,
                 clap_kwargs: Optional[dict] = None, debug: bool = True,
                 seed: int = 0, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, turbo: bool = False,
                 turbo_min_b: int = TURBO_MIN_B, decode_batch: int = DECODE_BATCH,
                 **kwargs):
        super().__init__(seed=seed, device=device, **kwargs)
        self.debug = debug
        self.turbo, self.turbo_min_b = turbo, turbo_min_b
        self.decode_batch = max(int(decode_batch), 1)
        self.latent_diffae_setup = self.clap_setup = False
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
        """Pour the three checkpoints the environment names (JAX
        given_models.py:1135-1187): LATENT_DIFFAE_CKPT (the stage-1 stack),
        CLAP_CKPT (CLAPModule.load_ckpt) and CLAPDAE_CKPT_{model_len} (the
        generator, whose `latent_ae.*` stage-1 stack is poured too); random
        weights where a variable is unset or its file absent. Sets the
        sample size of the model length: 22 s = 1,048,576 samples, 66 s =
        3x (unless an explicit sample_size was given)."""
        if model_len not in ("22s", "66s"):
            raise ValueError(f"model_len must be '22s' or '66s', got {model_len!r}")
        print("\n ====== Setting up StackedAELatentCond ======")
        # before any weights are loaded a stage's first pour runs on the host,
        # the leaves it leaves unreached taking the stage's seeded random init
        # (convert.pour's `init`); a stage no pour reached takes it whole
        seeds = {} if self._loaded else {self.latent_diffae: self.seed,
                                         self.latent_diffusion_model: self.seed + 1}

        def pour_into(stage, converter, sd):
            seed = seeds.get(stage)
            pour(stage, converter, sd,
                 init=None if seed is None else lambda: params_mod.random_init_(stage, seed))
            seeds.pop(stage, None)

        if not self.latent_diffae_setup:
            path = os.environ.get("LATENT_DIFFAE_CKPT", "")
            if path and os.path.exists(os.path.expanduser(path)):
                try:
                    sd = load_torch_checkpoint(path)
                    print(f"Loaded Latent DiffAE state dict ({len(sd)} tensors)")
                    pour_into(self.latent_diffae, convert_stacked_state_dict, sd)
                except Exception as e:
                    print(f"Sorry, exception = {e}. Going with random weights")
            self.latent_diffae_setup = True
        if not self.clap_setup:
            clap_path = os.environ.get("CLAP_CKPT", "")
            if clap_path:
                self.clap_module.load_ckpt(ckpt=clap_path, verbose=self.debug)
            self.clap_setup = True
        ckpt_path = os.environ.get(f"CLAPDAE_CKPT_{model_len}", "")
        if not self._explicit_sample_size:
            self.sample_size = self.SAMPLES_22S * (3 if model_len == "66s" else 1)
        self.demo_samples = self.sample_size
        if ckpt_path and os.path.exists(os.path.expanduser(ckpt_path)):
            try:
                sd = load_torch_checkpoint(ckpt_path)
                print(f"Loaded StackedAELatentDiffusionCond state dict ({len(sd)} tensors)")
                pour_into(self.latent_diffusion_model, convert_ldm_state_dict, sd)
                # the generator checkpoint carries the stage-1 stack under
                # latent_ae.* too: one file restores the whole generate()
                latent_ae_sd = {k[len("latent_ae."):]: v for k, v in sd.items()
                                if k.startswith("latent_ae.")}
                if latent_ae_sd:
                    pour_into(self.latent_diffae, convert_stacked_state_dict, latent_ae_sd)
            except Exception as e:
                print(f"Sorry, exception = {e}. Going with random weights")
        else:
            print("StackedAELatentDiffusionCond: starting from scratch!")
        if not self._loaded:
            for stage, seed in seeds.items():
                params_mod.random_init_(stage, seed)
            self._place()
        print(f"Success! {self.name} is ready to go.")
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

    def _keep_stage_times(self, rows) -> None:
        """`last_stage_times` from the stage spans' device intervals (host
        intervals off a card), summed over micro-batches, after the one
        synchronise of a timed generate."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for row in rows:
            key = _STAGE_KEYS[row.name]
            self.last_stage_times[key] = self.last_stage_times.get(key, 0.0) + row.seconds()

    def _outer(self, noise, lat, steps: int) -> torch.Tensor:
        """The outer v-DDIM of one micro-batch (JAX given_models.py:984-1022):
        under turbo, the amax carry at batch >= turbo_min_b, else int8 in
        the fold; without turbo the float route (JAX's bf16 fold at batch
        <= 2 is layout only: parallel/fold.py)."""
        la = self.latent_diffae
        if self.turbo and turbo_batch_ok(noise.shape[0], self.turbo_min_b):
            def carry_fn(x, t, aux, cond):
                return la.diffusion_v_aux(x, t, cond, q_aux=aux, turbo_min_b=self.turbo_min_b)
            return vddim_sample(carry_fn, noise, steps, 0, lat, aux_mode=True)
        if self.turbo:
            from .parallel.fold import decode_unet_seqfold

            def fold_fn(x, t, cond):
                return decode_unet_seqfold(la.diffusion, x, t, cond, quantized=True)
            return vddim_sample(fold_fn, noise, steps, 0, lat)
        return vddim_sample(la.diffusion_v, noise, steps, 0, lat)

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
        `last_stage_times`: the device intervals of the `clapdae.inner`,
        `clapdae.outer` and `clapdae.ae_decode` spans, read after one
        synchronise at the end."""
        self.ensure_params()
        self.last_stage_times = {}
        stages = [] if stage_times else None
        with tracing.span("clapdae.generate", self.device):
            emb = self._as_input(audio_embeddings)
            while emb.dim() < 3:
                emb = emb[None]
            cfg_scale = float(cfg_scales[0] if isinstance(cfg_scales, (list, tuple))
                              else cfg_scales)
            unet = self.latent_diffusion_model.diffusion

            def ldm_fn(t_len: int):
                rb = precompute_rel_biases(unet, t_len)     # once per generate
                return lambda x, t, embedding: unet(x, t, embedding=embedding,
                                                    embedding_scale=cfg_scale, rel_biases=rb)

            with tracing.span("clapdae.inner", self.device, into=stages):
                if init_audio_latents is not None:
                    lat = self._as_input(init_audio_latents)
                    noise = None if init_noise is None else self._as_input(init_noise)
                    fake_latents = torch.clamp(resample_diffusion(
                        ldm_fn(lat.shape[-1]), lat, steps=demo_steps,
                        noise_level=1.0 - init_strength, generator=self.generator,
                        noise=noise, embedding=emb), -1, 1)
                else:
                    n_latent = self.demo_samples // self.downsampling_ratio
                    noise = self._noise((batch_size, self.latent_dim, n_latent), latent_noise)
                    fake_latents = torch.clamp(
                        kdiff_sample(ldm_fn(n_latent), noise, demo_steps, embedding=emb), -1, 1)

            la = self.latent_diffae
            b = fake_latents.shape[0]
            s1 = self._noise((b, la.latent_dim,
                              fake_latents.shape[2] * la.latent_downsampling_ratio), s1_noise)
            parts = []
            for i in range(0, b, self.decode_batch):
                sl = slice(i, min(i + self.decode_batch, b))
                with tracing.span("clapdae.outer", self.device, into=stages):
                    first = torch.clamp(self._outer(s1[sl], fake_latents[sl], outer_steps),
                                        -1, 1)
                with tracing.span("clapdae.ae_decode", self.device, into=stages):
                    parts.append(la.decode_first_stage(first))
            fakes = torch.cat(parts)
            if flatten:                                 # 'b d n -> d (b n)'
                bb, d, n = fakes.shape
                fakes = fakes.transpose(0, 1).reshape(d, bb * n)
        if stage_times:
            self._keep_stage_times(stages)
        return fakes, fake_latents

    @torch.inference_mode()
    def generate_seqpar(self, audio_embeddings, world, cfg_scales=4, demo_steps: int = 150,
                        outer_steps: int = 100, batch_size: int = 1, flatten: bool = True,
                        sharded_levels: Optional[int] = None, latent_noise=None,
                        s1_noise=None, stage_times: bool = False):
        """`generate` with the outer stage sequence-parallel over the ranks
        of `world` (a `seq` parallel.World): the inner CFG stage (K3, K5)
        runs whole on every rank; rank 0's latents and stage-1 noise are
        broadcast, so every rank's outer stage starts from the same bits;
        the outer v-DDIM runs the stage-1 UNet (no attention: every level
        but the bottleneck can shard) through parallel.infer on time slabs;
        the slabs are gathered and the AE decode runs on the whole
        first-stage latents, in micro-batches of `decode_batch` as
        `generate`'s. The noises are taken and drawn in `generate`'s order,
        so the same generator gives the same audio. Returns `generate`'s
        (audio, stage-2 latents) on every rank. No init audio: the img2img
        resample is single-program, as in JAX. The float route only: a
        turbo model raises ValueError (JAX's seqpar ignores its turbo flag)."""
        from .embedding_math import TURBO_SEQPAR_REFUSAL
        from .parallel.infer import decode_unet_seqpar
        if self.turbo:
            raise ValueError(f"generate_seqpar on a turbo model: {TURBO_SEQPAR_REFUSAL}; "
                             "build it with turbo=False")
        self.ensure_params()
        emb = self._as_input(audio_embeddings)
        while emb.dim() < 3:
            emb = emb[None]
        cfg_scale = float(cfg_scales[0] if isinstance(cfg_scales, (list, tuple))
                          else cfg_scales)
        unet = self.latent_diffusion_model.diffusion
        self.last_stage_times = {}
        stages = [] if stage_times else None

        n_latent = self.demo_samples // self.downsampling_ratio
        with tracing.span("clapdae.inner", self.device, into=stages):
            noise = self._noise((batch_size, self.latent_dim, n_latent), latent_noise)
            rb = precompute_rel_biases(unet, n_latent)
            fake_latents = torch.clamp(kdiff_sample(
                lambda x, t, embedding: unet(x, t, embedding=embedding,
                                             embedding_scale=cfg_scale, rel_biases=rb),
                noise, demo_steps, embedding=emb), -1, 1).contiguous()
            world.broadcast_([fake_latents])

        la = self.latent_diffae
        b = fake_latents.shape[0]
        s1 = self._noise((b, la.latent_dim,
                          fake_latents.shape[2] * la.latent_downsampling_ratio),
                         s1_noise).contiguous()
        world.broadcast_([s1])
        slab = world.slab(s1.shape[-1])

        def model_fn(x, t, cond):
            return decode_unet_seqpar(la.diffusion, x, t, cond, world, sharded_levels)

        parts = []
        for i in range(0, b, self.decode_batch):
            sl = slice(i, min(i + self.decode_batch, b))
            with tracing.span("clapdae.outer", self.device, into=stages):
                local = torch.clamp(vddim_sample(model_fn, s1[sl][..., slab].contiguous(),
                                                 outer_steps, 0, fake_latents[sl]), -1, 1)
                first = world.all_gather_time(local)
            with tracing.span("clapdae.ae_decode", self.device, into=stages):
                parts.append(la.decode_first_stage(first))
        fakes = torch.cat(parts)
        if flatten:                                 # 'b d n -> d (b n)'
            bb, d, n = fakes.shape
            fakes = fakes.transpose(0, 1).reshape(d, bb * n)
        if stage_times:
            self._keep_stage_times(stages)
        return fakes, fake_latents

    def decode(self, *args, **kwargs):
        """`generate` (JAX's alias)."""
        return self.generate(*args, **kwargs)

    def forward(self, waveform_in, *args, **kwargs):
        """Embed a prompt and generate from it, as JAX's CLAPDAE.forward:
        returns `generate`'s (audio, stage-2 latents)."""
        return self.decode(self.encode(waveform_in, *args), **kwargs)
