"""The DiffusionDVAE's torch checkpoint, poured into the port's module.

The port's copy of audio_algebra_tpu/convert_dvae.py. The reference's
pretrained DVAE (DVAEWrapper's ckpt_info) is a Lightning state dict of
the torch DiffusionDVAE:

  encoder{,_ema}.layers.<i>...            SoundStream-XL encoder stack
  diffusion{,_ema}.net.<SkipBlock nest>   DiffusionAttnUnet1D
  quantizer{,_ema}...                     Memcodes

and the flax-layout tree of the port's models/dvae.DiffusionDVAE is
{encoder/{Conv1d_k, EncoderBlock_i/...}, diffusion/{stack_NNN/...,
timestep_embed}, quantizer/codes}. The flax UNet is block-isomorphic with
the torch SkipBlock nest and its modules are named in forward order, so
the tensors pair by ordered (kind, shape) signature inside each bucket
(convert._pour_by_predicate).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .checkpoint import remap_ema_weights
from .convert import _n_params, convert_by_shape, report


def convert_dvae_state_dict(sd: Dict[str, np.ndarray], params_template):
    """Pour a torch DiffusionDVAE state dict into a flax params tree: the
    EMA tensors overwrite their main twins (inference uses the EMA copy),
    then the tensors of each top-level module (encoder, diffusion,
    quantizer) pair with that module's flax params. Returns (new_params,
    hits, misses)."""
    sd = remap_ema_weights(sd)
    new, hits, misses = convert_by_shape(
        sd, params_template,
        buckets={"encoder": ("encoder.",),
                 "diffusion": ("diffusion.",),
                 "quantizer": ("quantizer.",)})
    report("DiffusionDVAE", hits, misses, _n_params(params_template))
    return new, hits, misses
