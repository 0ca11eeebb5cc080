"""K2a's host-side planner and its GELU, on the CPU.

`groupnorm.quant_plan` chooses the row groups of K2a's one cooperative
launch (x of a group fits in L2, so the apply pass re-reads it from there)
and the most slices a row may be cut into (the partials' room). The kernel computes GELU in its sigmoid
form, y / (1 + exp(-2 u)) = y / (1 + 2^(y (k1 + k2 y^2))), instead of
0.5 y (1 + tanh(u)), with rstd folded into the channel's scale: a numpy
model of that arithmetic in f32, quantised, must stay within 1 LSB of the
twin on at most 0.1 % of elements, the tolerance the card tests hold the
kernel to.
"""
import numpy as np
import pytest
import torch

from audio_algebra_torch.ops import groupnorm as gn

# the turbo decode's GN_0 shapes at B = 16 (levels 0-3), a B = 1 row, the
# ragged card-test shapes and a batch the group size does not divide
SHAPES = [(16, 256, 65536), (16, 512, 16384), (16, 1024, 4096), (16, 512, 32768),
          (1, 256, 65536), (5, 512, 16384), (17, 1024, 4096), (4, 128, 1001),
          (2, 3, 1001), (16, 512, 8), (300, 16, 64)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_plan_fits_l2_and_the_kernel(shape, dtype):
    b, c, t = shape
    n, esize = c * t, torch.empty((), dtype=dtype).element_size()
    vec = 16 // esize
    max_split, group_rows = gn.quant_plan(b, n, esize, vec)
    assert 1 <= group_rows <= min(b, gn.MAX_GROUP_ROWS)
    # a group's x fits the L2 budget, unless one row alone exceeds it
    assert group_rows * n * esize <= gn.L2_GROUP_BYTES or group_rows == 1
    # every group but the last is full; the groups cover the batch
    n_groups = -(-b // group_rows)
    assert (n_groups - 1) * group_rows < b <= n_groups * group_rows
    # a slice holds at least one vector a thread, and a group's slices fit the grid
    assert 1 <= max_split <= max(1, -(-n // (256 * vec)))
    assert max_split * group_rows <= gn.MAX_QUANT_BLOCKS


def test_quant_plan_takes_a_whole_row_of_level_0_per_group():
    """(16, 256, 65536) bf16: a row is 32 MiB, one a group, 16 groups;
    (16, 512, 16384): two rows a group."""
    assert gn.quant_plan(16, 256 * 65536, 2, 8) == (gn.MAX_QUANT_BLOCKS, 1)
    assert gn.quant_plan(16, 512 * 16384, 2, 8) == (gn.MAX_QUANT_BLOCKS // 2, 2)


@pytest.mark.parametrize("shape", [(4, 256, 4096), (2, 128, 1001)])
@pytest.mark.parametrize("gelu", [True, False])
def test_sigmoid_gelu_quantises_like_the_twin(shape, gelu):
    g = torch.Generator().manual_seed(sum(shape))
    c = shape[1]
    x = torch.randn(shape, generator=g) * 1.5 + 0.2
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.rand(c, generator=g) - 0.5
    grid = torch.rand(c, generator=g) * 0.06 + 0.02
    want = gn.groupnorm1_gelu_quant_ref(x, scale, bias, grid, gelu).numpy()
    # the kernel's arithmetic in f32: (x - mu) * (rstd * scale) + bias, GELU
    # as y / (1 + 2^(y (k1 + k2 y^2))), times qinv, round half to even, clip
    x32 = x.numpy()
    mu = x32.mean(axis=(1, 2), keepdims=True, dtype=np.float32)
    var = np.maximum((x32 * x32).mean(axis=(1, 2), keepdims=True, dtype=np.float32) - mu * mu,
                     np.float32(0))
    rstd = np.float32(1) / np.sqrt(var + np.float32(1e-6))
    y = (x32 - mu) * (rstd * scale.numpy()[None, :, None]) + bias.numpy()[None, :, None]
    if gelu:
        k1 = np.float32(-2.0 * np.log2(np.e) * gn.GELU_C)
        k2 = np.float32(k1 * np.float32(0.044715))
        y = y / (np.float32(1) + np.exp2(y * (k2 * y * y + k1)))
    qinv = gn.quant_inverse(grid).numpy()[None, :, None]
    got = np.clip(np.rint(y * qinv), -127, 127).astype(np.int8)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert y.dtype == np.float32
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
