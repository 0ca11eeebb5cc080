"""aa_mixer — the mixer-algebra task: losses, mixing and training.

Port of audio_algebra_tpu/aa_mixer.py. The trainable AudioAlgebra map h is
trained so that encode-then-sum equals sum-then-encode (zsum ≈ zmix),
with VICReg variance / covariance regularisers and an inversion (recon)
loss, while the given model's encoder stays frozen.

  * `vicreg_cov_loss` keeps JAX's Gram identity: the scalar comes from a
    (b, b) product and never forms the (c·t, c·t) covariance.
  * `get_stems_faders` runs on the host in numpy and draws what JAX's
    draws from the same `default_rng`.
  * the loss of a step is two stages: `encode_mixer_inputs` (one batched
    encode of the S·B faded stems and the mix, then one of the raw batch,
    frozen under `torch.no_grad()`) and `mixer_loss` on those latents.
    `make_mixer_loss_fn` composes them as JAX's loss function; the encode
    runs in f32, or in bf16 on bf16 copies of the encoder's weights
    (`mixed_encode_fn`, JAX's bf16 training tool).
  * `OneCycleAdam` is optax.adam over optax.cosine_onecycle_schedule,
    wrapped in optax.MultiSteps when gradients accumulate.

The algebra model is called with `train=False` inside the losses, as JAX's
`aa_module.apply(aa_params, y)` is: with `use_bn`, BatchNorm reads its
running statistics in training too.
"""
from __future__ import annotations

import inspect
from types import SimpleNamespace
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .device import call_with, cast_params, resolve_device
from .models.aa import AudioAlgebra, EmbedBlock  # noqa: F401 (the JAX module's surface)
from .parallel.train import MultiSteps
from .train_clapdae import onecycle_lr
from .utils.params import random_init_

__all__ = ['mseloss', 'EmbedBlock', 'AudioAlgebra', 'AABundle', 'OneCycleAdam',
           'get_stems_faders', 'do_mixing', 'aa_demo', 'vicreg_var_loss',
           'off_diagonal', 'vicreg_cov_loss', 'encode_mixer_inputs', 'mixer_loss',
           'make_mixer_loss_fn', 'train_aa_model', 'given_model_encode_fn',
           'mixed_encode_fn']


# ------------------------------------------------------------------ losses ---

def mseloss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).square().mean()


def vicreg_var_loss(z: torch.Tensor, gamma: float = 1.0, eps: float = 1e-4) -> torch.Tensor:
    """Hinge on each feature's standard deviation across the batch (the
    population variance, as jnp.var)."""
    std_z = torch.sqrt(z.var(dim=0, correction=0) + eps)
    return F.relu(gamma - std_z).mean()


def off_diagonal(x: torch.Tensor) -> torch.Tensor:
    """The off-diagonal elements of a square matrix, flattened."""
    n, m = x.shape
    if n != m:
        raise ValueError(f"off_diagonal needs a square matrix, got {tuple(x.shape)}")
    return x.flatten()[:-1].view(n - 1, n + 1)[:, 1:].flatten()


def vicreg_cov_loss(z: torch.Tensor) -> torch.Tensor:
    """Sum of squared off-diagonal covariance entries / num_features,
    through the Gram identity:

        C = Z_c^T Z_c / (b-1),  ||C||_F^2 = ||Z_c Z_c^T||_F^2 / (b-1)^2
        off_diag_sq = ||C||_F^2 - sum_i C_ii^2,  C_ii = row_sq_i / (b-1)
    """
    b = z.shape[0]
    num_features = z.shape[1] * z.shape[2]
    flat = z.reshape(b, -1)
    zc = flat - flat.mean(dim=0)                       # (b, f) centred
    gram = zc @ zc.T                                   # (b, b)
    denom = (b - 1) ** 2
    fro2 = gram.square().sum() / denom
    row_sq = (zc * zc).sum(dim=0)                      # per feature ||.||^2
    diag2 = row_sq.square().sum() / denom
    return (fro2 - diag2) / num_features


# ------------------------------------------------------------------ mixing ---

def get_stems_faders(batch, dl_iter: Iterator, dl, maxstems: int = 2,
                     unity_gain: bool = False, rng: Optional[np.random.Generator] = None,
                     debug: bool = False):
    """Draw extra stems from the dataloader and random faders. Host-side;
    returns (stems [S, B, C, T], faders [S], dl_iter). Faders are
    sign(u) * (1 + 0.5 tanh(2v)), in ±[0.5, 1.5]."""
    rng = rng or np.random.default_rng()
    nstems = int(rng.integers(2, maxstems + 1))
    if debug:
        print("maxstems, nstems =", maxstems, nstems)
    faders = np.sign(2 * rng.random(nstems) - 1)
    if not unity_gain:
        faders += 0.5 * np.tanh(2 * (2 * rng.random(nstems) - 1))
    stems = [np.asarray(batch)]
    for _ in range(nstems - 1):
        try:
            nxt = next(dl_iter)
        except StopIteration:
            dl_iter = iter(dl)
            nxt = next(dl_iter)
        stems.append(np.asarray(nxt))
    return np.stack(stems), faders.astype(np.float32), dl_iter


class AABundle:
    """An AudioAlgebra module and its weights on an explicit device, with
    JAX's object surface: `aa_model(y) -> (z, y_recon)`, `.encode`,
    `.decode` (all without gradients, BatchNorm on running statistics).
    The weights are utils.params.random_init_'s for `seed`."""

    def __init__(self, dims: int = 64, hidden_dims: int = 64, use_bn: bool = False,
                 resid: bool = True, trivial: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.module = random_init_(
            AudioAlgebra(dims=dims, hidden_dims=hidden_dims, use_bn=use_bn, resid=resid,
                         trivial=trivial), seed).to(self.device)

    def _as_input(self, y) -> torch.Tensor:
        return torch.as_tensor(y, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def __call__(self, y):
        return self.module(self._as_input(y))

    @torch.no_grad()
    def encode(self, y) -> torch.Tensor:
        return self.module.encode(self._as_input(y))

    @torch.no_grad()
    def decode(self, z) -> torch.Tensor:
        return self.module.decode(self._as_input(z))


def do_mixing(stems, faders, given_model, aa_model: AABundle, device=None, debug=False,
              **kwargs):
    """Mix stems, encode, re-embed; returns (zsum, zmix, archive). The
    object-level variant over a given model and a bundle; training goes
    through `make_mixer_loss_fn`."""
    stems = aa_model._as_input(stems)                        # (S, B, C, T)
    faders = aa_model._as_input(faders)
    fadedstems = stems * faders[:, None, None, None]
    s = fadedstems.shape[0]

    ys = [given_model.encode(fadedstems[i]) for i in range(s)]
    zs, yrecons = [], []
    zsum = None
    for y in ys:
        z, y_recon = aa_model(y)
        zsum = z if zsum is None else zsum + z
        zs.append(z)
        yrecons.append(y_recon)
    mix = fadedstems.sum(dim=0)
    ymix = given_model.encode(mix)
    zmix, ymix_recon = aa_model(ymix)
    ysum = sum(ys[1:], ys[0])
    archive = {'zs': zs, 'mix': mix, 'ys': ys, 'ymix': ymix,
               'ymix_recon': ymix_recon,
               'fadedstems': [fadedstems[i] for i in range(s)],
               'yrecons': yrecons, 'ysum': ysum}
    return zsum, zmix, archive


def encode_mixer_inputs(encode_fn: Callable, stems: torch.Tensor, faders: torch.Tensor,
                        batch: torch.Tensor):
    """The frozen encodes of a mixer step: (y_all, y_batch), y_all the
    latents of the S·B faded stems followed by those of their B mixes."""
    s, b = stems.shape[:2]
    faded = stems * faders[:, None, None, None]
    mix = faded.sum(dim=0)
    y_all = encode_fn(torch.cat([faded.reshape(s * b, *faded.shape[2:]), mix]))
    return y_all, encode_fn(batch)


def mixer_loss(aa_module: AudioAlgebra, y_all: torch.Tensor, y_batch: torch.Tensor,
               nstems: int, gather: Optional[Callable] = None):
    """(loss, logs) of a mixer step from its frozen latents: zsum / zmix
    VICReg and recon losses. `gather` (parallel.World.gather) makes this
    rank's rows the global batch's before any batch statistic, so that the
    loss is the global batch's (parallel.train)."""
    b = y_all.shape[0] // (nstems + 1)
    d, n = y_all.shape[-2], y_all.shape[-1]
    z_all, yrec_all = aa_module(y_all)
    _, yrecon = aa_module(y_batch)
    zsum = z_all[: nstems * b].reshape(nstems, b, d, n).sum(dim=0)
    zmix = z_all[nstems * b:]
    ymix, ymix_recon = y_all[nstems * b:], yrec_all[nstems * b:]
    if gather is not None:
        zsum, zmix, ymix, ymix_recon, y_batch, yrecon = map(
            gather, (zsum, zmix, ymix, ymix_recon, y_batch, yrecon))

    mix_loss = mseloss(zsum, zmix)
    var_loss = (vicreg_var_loss(zsum) + vicreg_var_loss(zmix)) / 2
    cov_loss = (vicreg_cov_loss(zsum) + vicreg_cov_loss(zmix)) / 2
    aa_recon_loss = mseloss(y_batch, yrecon) + mseloss(ymix, ymix_recon)

    loss = mix_loss + var_loss + cov_loss + aa_recon_loss
    logs = {'train_loss': loss, 'mix_loss': mix_loss, 'var_loss': var_loss,
            'cov_loss': cov_loss, 'aa_recon_loss': aa_recon_loss}
    return loss, {k: v.detach() for k, v in logs.items()}


def make_mixer_loss_fn(aa_module: AudioAlgebra, encode_fn: Callable):
    """loss_fn(stems (S, B, C, T), faders (S,), batch (B, C, T), gather=None)
    -> (loss, logs): the whole training step's loss, gradients reaching the
    algebra model only (`gather` as in mixer_loss)."""

    def loss_fn(stems, faders, batch, gather=None):
        y_all, y_batch = encode_mixer_inputs(encode_fn, stems, faders, batch)
        return mixer_loss(aa_module, y_all, y_batch, stems.shape[0], gather)

    return loss_fn


def aa_demo(given_model, aa_model, log_dict, zsum, zmix, step: int,
            demo_steps: int = 35, sr: int = 48000, out_dir: str = "."):
    """Decode zsum / zmix back to audio files for logging."""
    from .utils.audio_io import save_audio

    # the wrappers' step-count keyword differs (demo_steps / steps /
    # num_steps; the DSP AEs take none): pass it where one exists
    sig = inspect.signature(type(given_model).decode)
    step_kw = next((
        {nm: demo_steps} for nm in ("demo_steps", "steps", "num_steps")
        if nm in sig.parameters), {})
    for var, name in zip([zsum, zmix], ['zsum', 'zmix']):
        y = aa_model.decode(var)
        fake_audio = given_model.decode(y, **step_kw)
        filename = f'{out_dir}/{name}_{step:08}.wav'
        save_audio(filename, np.clip(fake_audio.float().cpu().numpy(), -1, 1), sr)
        log_dict[name] = filename
    return log_dict


# --------------------------------------------------------------- optimiser ---

class OneCycleAdam:
    """optax.adam(optax.cosine_onecycle_schedule(total_steps, max_lr)) over
    `module`'s parameters, in optax.MultiSteps(every_k_schedule=accum) when
    accum > 1 (parallel.train.MultiSteps: gradients averaged over `accum`
    calls of `step`, Adam stepping once for them). The schedule counts
    Adam's updates. torch.optim.Adam is optax's (eps outside the square
    root, eps_root 0)."""

    def __init__(self, module: torch.nn.Module, total_steps: int, max_lr: float = 1e-3,
                 accum: int = 1):
        self.params = list(module.parameters())
        self.total_steps, self.max_lr, self.accum = int(total_steps), float(max_lr), \
            max(int(accum), 1)
        self.opt = torch.optim.Adam(self.params, lr=self.max_lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.0)
        self.updates = 0           # optax's inner count: the schedule's clock
        self.multi = MultiSteps(SimpleNamespace(params=self.params, step=self._update),
                                self.accum) if self.accum > 1 else None

    def lr(self, count: Optional[int] = None) -> float:
        """The learning rate of update `count` (the next one by default)."""
        return onecycle_lr(self.updates if count is None else count, self.total_steps,
                           self.max_lr)

    @property
    def mini_step(self) -> int:
        """MultiSteps' position in its window (0 without accumulation)."""
        return 0 if self.multi is None else self.multi.mini_step

    def _update(self) -> bool:
        for group in self.opt.param_groups:
            group["lr"] = self.lr()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def step(self) -> bool:
        """Take the gradients of the last backward() and clear them; returns
        whether Adam stepped."""
        return self.multi.step() if self.multi is not None else self._update()

    def state_dict(self) -> dict:
        return {"adam": self.opt.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step,
                "acc_grads": None if self.multi is None else [a.clone() for a in self.multi.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adam"])
        self.updates = int(state["updates"])
        if self.multi is not None and state["acc_grads"] is not None:
            self.multi.mini_step = int(state["mini_step"])
            with torch.no_grad():
                for a, saved in zip(self.multi.acc, state["acc_grads"]):
                    a.copy_(saved)


# ---------------------------------------------------------------- training ---

def as_tensors(device, *arrays) -> list:
    """Host arrays as f32 tensors on `device`."""
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


def train_aa_model(given_model, train_dl, args, aa_model: Optional[AABundle] = None,
                   logger=None, debug: bool = False):
    """Train the algebra model: Adam on the one-cycle schedule (max_lr
    1e-3), loss = mix + var + cov + recon. `steps_per_epoch` caps the
    batches an epoch takes, which keeps the loop on the schedule's clock.
    Returns (aa_model, history)."""
    max_epochs = getattr(args, 'max_epochs', 40)
    steps_per_epoch = getattr(args, 'steps_per_epoch', None) or len(train_dl)
    seed = getattr(args, 'seed', 42)
    if aa_model is None:
        aa_model = AABundle(dims=args.latent_dim,
                            hidden_dims=getattr(args, 'hidden_dims', 64),
                            seed=seed, device=given_model.device)
    opt = OneCycleAdam(aa_model.module, steps_per_epoch * max_epochs,
                       getattr(args, 'max_lr', 1e-3))
    loss_fn = make_mixer_loss_fn(aa_model.module, given_model_encode_fn(given_model))

    rng = np.random.default_rng(seed)
    step = 0
    history = []
    for epoch in range(max_epochs):
        train_iter = iter(train_dl)
        for batch_i, batch in enumerate(train_dl):
            if batch_i >= steps_per_epoch:
                break
            batch = np.asarray(batch)
            stems, faders, train_iter = get_stems_faders(
                batch, train_iter, train_dl, maxstems=getattr(args, 'maxstems', 2),
                rng=rng)
            lr = opt.lr()
            loss, logs = loss_fn(*as_tensors(aa_model.device, stems, faders, batch))
            loss.backward()
            opt.step()
            logs = {k: float(v) for k, v in logs.items()}
            logs.update(epoch=epoch, step=step, learning_rate=lr)
            if logger is not None:
                logger.log(logs)
            history.append(logs)
            step += 1
    return aa_model, history


def mixed_encode_fn(module: torch.nn.Module, method: str = "encode_it") -> Callable:
    """The frozen encode in bf16, as JAX's bf16 training tool runs it
    (tools/bench_train.py:158-167, :224-231): fn(x) -> module.<method> on
    bf16 copies of the encoder's parameters and a bf16 input, the latents
    returned in f32, with no graph behind them. The copies are of `module.ENCODER_PARTS` only (the submodules the
    encode reads) and are made once, here, as the tool casts its frozen tree
    once: later changes to the module's weights do not reach fn."""
    with torch.no_grad():
        params = cast_params(module, torch.bfloat16, module.ENCODER_PARTS)

    def fn(x):
        with torch.no_grad():
            return call_with(module, params, x.to(torch.bfloat16), method=method).float()
    return fn


def given_model_encode_fn(given_model) -> Callable:
    """The frozen encode of a given model: fn(x) -> latents in f32, with
    no graph behind them. A model wrapper (DVAEWrapper) encodes through its
    module's `encode_it` (else `encode`) under torch.no_grad(); a DSP
    encoder (the spectrogram AEs, on K6) through its own `encode`, whose
    inference-mode output is cloned into a tensor a graph can take."""
    model = getattr(given_model, "model", None)
    if model is not None:
        given_model.ensure_params()
        enc = model.encode_it if hasattr(model, "encode_it") else model.encode

        def fn(x):
            with torch.no_grad():
                return enc(given_model._as_input(x)).float()
        return fn

    def fn(x):
        return given_model.encode(x).clone()
    return fn
