"""Kernel K1 of the PyTorch port on the card: the CUDA kernel against its
plain PyTorch twin, at the UNet's shapes and a ragged one. These tests
need a CUDA device (marker `cuda`) and skip without one. The file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from audio_algebra_torch.ops import groupnorm as gn

F32_TOL = 1e-4          # f32: only the order of the statistics' sums differs
BF16_TOL = 2e-2         # bf16: a one-ulp rounding flip at |y| < 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 4096), (4, 512, 8), (2, 128, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu,residual", [(True, False), (True, True), (False, False)])
def test_kernel_matches_twin_on_card(cuda_device, shape, dtype, gelu, residual):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    res = torch.randn(shape, generator=g, device=cuda_device).to(dtype) if residual else None
    scale = torch.rand(shape[1], generator=g, device=cuda_device).to(dtype) + 0.5
    bias = torch.rand(shape[1], generator=g, device=cuda_device).to(dtype) - 0.5
    before = gn.launches
    got = gn.groupnorm1_gelu(x, scale, bias, gelu, res)
    torch.cuda.synchronize()
    assert gn.launches == before + 1
    want = gn.groupnorm1_gelu_ref(x, scale, bias, gelu, res)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
