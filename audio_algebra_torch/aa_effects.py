"""aa_effects — the effects-algebra ("king - man + woman") task.

Port of audio_algebra_tpu/aa_effects.py: two clips (a, b) under two
effects (e1, e2); h is trained so that za2 ≈ za1 + (zb2 - zb1), the
effect's direction carried from one clip to the other, with the mixer
task's VICReg regularisers and inversion loss. The model, the losses, the
optimiser and the frozen encode are aa_mixer's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .aa_mixer import (  # noqa: F401 (the JAX module's surface)
    AABundle, AudioAlgebra, EmbedBlock, OneCycleAdam, aa_demo,
    as_tensors, given_model_encode_fn, mseloss, off_diagonal, vicreg_cov_loss,
    vicreg_var_loss)

__all__ = ['mseloss', 'EmbedBlock', 'AudioAlgebra', 'do_mixing', 'aa_demo',
           'vicreg_var_loss', 'off_diagonal', 'vicreg_cov_loss', 'effects_loss',
           'make_effects_loss_fn', 'train_aa_model']

CLIP_KEYS = ("a1", "b1", "a2", "b2")


def do_mixing(batch: dict, given_model, aa_model: AABundle, device=None, debug=False):
    """Encode the (a1, b1, a2, b2) clips through the given model, then h;
    returns {'ys', 'zs', 'yrecons'}."""
    ys = [given_model.encode(aa_model._as_input(batch[k])) for k in CLIP_KEYS]
    zs = [aa_model.encode(y) for y in ys]
    yrecons = [aa_model.decode(z) for z in zs]
    return {'ys': ys, 'zs': zs, 'yrecons': yrecons}


def effects_loss(aa_module: AudioAlgebra, y_all: torch.Tensor,
                 gather: Optional[Callable] = None):
    """(loss, logs) of an effects step from the frozen latents of the
    stacked (a1, b1, a2, b2) clips: the two algebra guesses, VICReg and the
    four-way recon. `gather` as in aa_mixer.mixer_loss: each of the four
    blocks becomes the global batch's."""
    z_all, yrec_all = aa_module(y_all)
    if gather is not None:
        z_all, yrec_all, y_all = (torch.cat([gather(c) for c in torch.chunk(t, 4, dim=0)])
                                  for t in (z_all, yrec_all, y_all))
    za1, zb1, za2, zb2 = torch.chunk(z_all, 4, dim=0)

    za2_guess = za1 + (zb2 - zb1)
    zb2_guess = zb1 + (za2 - za1)
    mix_loss = mseloss(za2_guess, za2) + mseloss(zb2_guess, zb2)
    var_loss = (vicreg_var_loss(za2_guess) + vicreg_var_loss(zb2_guess)) / 2
    cov_loss = (vicreg_cov_loss(za2_guess) + vicreg_cov_loss(zb2_guess)) / 2
    aa_recon_loss = mseloss(yrec_all, y_all) * 4.0       # the sum of 4 means

    loss = mix_loss + var_loss + cov_loss + aa_recon_loss
    logs = {'train_loss': loss, 'mix_loss': mix_loss, 'var_loss': var_loss,
            'cov_loss': cov_loss, 'aa_recon_loss': aa_recon_loss}
    return loss, {k: v.detach() for k, v in logs.items()}


def make_effects_loss_fn(aa_module: AudioAlgebra, encode_fn: Callable):
    """loss_fn(a1, b1, a2, b2) -> (loss, logs): one frozen encode of the
    four clips stacked, then `effects_loss`."""

    def loss_fn(a1, b1, a2, b2, gather=None):
        return effects_loss(aa_module, encode_fn(torch.cat([a1, b1, a2, b2], dim=0)), gather)

    return loss_fn


def train_aa_model(given_model, train_dl, args, aa_model: Optional[AABundle] = None,
                   logger=None, debug: bool = False):
    """The effects task's training loop: Adam on the one-cycle schedule,
    `steps_per_epoch` capping an epoch as in aa_mixer.train_aa_model.
    Returns (aa_model, history)."""
    max_epochs = getattr(args, 'max_epochs', 40)
    steps_per_epoch = getattr(args, 'steps_per_epoch', None) or len(train_dl)
    if aa_model is None:
        aa_model = AABundle(dims=args.latent_dim,
                            hidden_dims=getattr(args, 'hidden_dims', 64),
                            seed=getattr(args, 'seed', 42), device=given_model.device)
    opt = OneCycleAdam(aa_model.module, steps_per_epoch * max_epochs,
                       getattr(args, 'max_lr', 1e-3))
    loss_fn = make_effects_loss_fn(aa_model.module, given_model_encode_fn(given_model))

    step = 0
    history = []
    for epoch in range(max_epochs):
        for batch_i, batch in enumerate(train_dl):
            if batch_i >= steps_per_epoch:
                break
            lr = opt.lr()
            loss, logs = loss_fn(*as_tensors(aa_model.device, *(batch[k] for k in CLIP_KEYS)))
            loss.backward()
            opt.step()
            logs = {k: float(v) for k, v in logs.items()}
            logs.update(epoch=epoch, step=step, learning_rate=lr)
            if logger is not None:
                logger.log(logs)
            history.append(logs)
            step += 1
    return aa_model, history
