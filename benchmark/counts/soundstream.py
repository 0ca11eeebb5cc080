"""SoundStream-XL encoder (the DVAE's) and decoder (the first-stage
AudioAutoencoder's): the operations of one call. A residual unit is a
dilated conv7 and a conv1 at its width; an encoder stage ends in a strided
conv of kernel 2 * stride, a decoder stage starts with a transposed conv of
kernel 2 * stride (every input sample meets every tap)."""
from __future__ import annotations


def _res_unit(batch, c, t):
    return 2 * batch * t * (c * c * 7 + c * c)


def encoder_flops(batch, t_len, in_ch, capacity, c_mults, strides, latent_dim) -> float:
    total = 2 * batch * t_len * in_ch * capacity * 7
    c, t = capacity, t_len
    for mult, s in zip(c_mults, strides):
        total += 3 * _res_unit(batch, c, t)
        t //= s
        total += 2 * batch * t * c * capacity * mult * 2 * s
        c = capacity * mult
    return total + 2 * batch * t * c * latent_dim * 3


def decoder_flops(batch, t_lat, out_ch, capacity, c_mults, strides, latent_dim) -> float:
    c = capacity * c_mults[-1]
    total = 2 * batch * t_lat * latent_dim * c * 7
    t = t_lat
    for mult, s in zip(list(c_mults[-2::-1]) + [1], list(strides)[::-1]):
        feat = capacity * mult
        total += 2 * batch * t * c * feat * 2 * s
        t *= s
        total += 3 * _res_unit(batch, feat, t)
        c = feat
    return total + 2 * batch * t * c * out_ch * 7
