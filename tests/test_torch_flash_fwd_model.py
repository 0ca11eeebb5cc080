"""A model of kernel K3's bf16 serving arithmetic on the CPU, against the
JAX flash attention.

The card's kernel (csrc/flash_attention.cu, flash_serve_bf16) gives a
block one (head, 64-query tile) and every batch row: each 64 x 64 tile of
the transposed bias is read once and added to the scores of all the rows.
Its softmax runs online over 64-key tiles in base 2: log2 e is folded into
sm_scale and into the bias as it is read, the running max and the
normaliser are f32, the probabilities are rounded to bf16 before P.V,
which accumulates in f32, and the output is divided by the normaliser
and rounded to bf16. The model below does the same in torch, and is held
against JAX's `flash_attention_relpos` (its Pallas kernel in interpret
mode, natural-base softmax) within the bf16 tolerance the card holds the
kernel to (atol 1e-2 + rtol 2^-7), at B = 1, 2 and 3.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_algebra_tpu.ops.pallas import flash_attention as jflash
from audio_algebra_torch.ops import flash_attention as tflash

LOG2E = 1.4426950408889634
ATOL, RTOL = 1e-2, 2 ** -7
TILE = 64


def _bf16(a):
    return a.to(torch.bfloat16).float()


def serve_model(q, k, v, bias_t, sm_scale):
    """K3's arithmetic: q, k, v (B, H, T, D) and bias_t (H, S, T) hold bf16
    values; returns (B, H, T, D) bf16 values as f32."""
    b, h, t, _ = q.shape
    scale2 = sm_scale * LOG2E
    o = torch.empty_like(q)
    for hh in range(h):
        for t0 in range(0, t, TILE):
            m = torch.full((b, TILE), -1e30)
            l = torch.zeros((b, TILE))
            acc = torch.zeros((b, TILE, q.shape[-1]))
            qt = q[:, hh, t0:t0 + TILE]
            for s0 in range(0, t, TILE):
                bias2 = bias_t[hh, s0:s0 + TILE, t0:t0 + TILE].T * LOG2E   # read once
                for bi in range(b):                                      # for every row
                    s = (qt[bi] @ k[bi, hh, s0:s0 + TILE].T) * scale2 + bias2
                    mn = torch.maximum(m[bi], s.amax(dim=1))
                    alpha = torch.exp2(m[bi] - mn)
                    p = torch.exp2(s - mn[:, None])
                    l[bi] = l[bi] * alpha + p.sum(dim=1)
                    acc[bi] = acc[bi] * alpha[:, None] + _bf16(p) @ v[bi, hh, s0:s0 + TILE]
                    m[bi] = mn
            o[:, hh, t0:t0 + TILE] = _bf16(acc / l[..., None])
    return o


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_serve_model_matches_jax_flash(batch):
    h, t, d = 2, 1024, 16
    rng = np.random.default_rng(batch)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal((batch, h, t, d)).astype(np.float32)))
               for _ in range(3))
    bias_t = _bf16(torch.from_numpy(rng.standard_normal((h, t, t)).astype(np.float32) * 0.5))
    scale = 1 / math.sqrt(d)
    got = serve_model(q, k, v, bias_t, scale)
    j = (lambda a: jnp.asarray(a.numpy()).astype(jnp.bfloat16))
    want = jflash.flash_attention_relpos(j(q), j(k), j(v), j(bias_t), sm_scale=scale,
                                         interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    # and the port's twin, the function's definition on the card
    twin = tflash.flash_attention_relpos_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                             bias_t.bfloat16(), scale).float()
    torch.testing.assert_close(got, twin, atol=ATOL, rtol=RTOL)
