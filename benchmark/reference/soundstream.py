"""Plain reference of the SoundStream-XL encoder (the DVAE's) and decoder
(the first-stage AudioAutoencoder's). Encoder: conv7, then per stage three
dilated residual units (1, 3, 9), ELU and a strided conv of kernel
2 * stride, then ELU and conv3. Decoder: conv7, then per stage ELU, a
SAME transposed conv of kernel 2 * stride and three residual units, then
ELU and conv7. Module names `l000`, `l001.u0.Conv1d_0`, ..."""
from __future__ import annotations

import torch.nn.functional as F

from .nn import conv1d, conv_transpose1d


def residual_unit(P, name, x, dilation: int):
    h = conv1d(P, f"{name}.Conv1d_0", F.elu(x), dilation=dilation)
    return x + conv1d(P, f"{name}.Conv1d_1", F.elu(h))


def encoder(P, prefix, audio, strides):
    x = conv1d(P, f"{prefix}.l000", audio)
    for i, stride in enumerate(strides):
        name = f"{prefix}.l{i + 1:03d}"
        for j, d in enumerate((1, 3, 9)):
            x = residual_unit(P, f"{name}.u{j}", x, d)
        x = conv1d(P, f"{name}.u3", F.elu(x), stride=stride)
    return conv1d(P, f"{prefix}.l{len(strides) + 1:03d}", F.elu(x))


def decoder(P, prefix, latents, strides):
    x = conv1d(P, f"{prefix}.l000", latents)
    for i, stride in enumerate(list(strides)[::-1]):
        name = f"{prefix}.l{i + 1:03d}"
        x = conv_transpose1d(P, f"{name}.u0", F.elu(x), stride)
        for j, d in enumerate((1, 3, 9)):
            x = residual_unit(P, f"{name}.u{j + 1}", x, d)
    return conv1d(P, f"{prefix}.l{len(strides) + 1:03d}", F.elu(x))
