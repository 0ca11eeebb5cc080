"""Kernels of the PyTorch port on the card, each CUDA kernel against its
plain PyTorch twin: K1 (GroupNorm(1) + GELU + residual) at the UNet's
shapes and a ragged one, K3 (rel-pos flash attention) and K5 (grouped
GroupNorm + FiLM + SiLU) at the MIRAGE UNet's shapes. These tests need a
CUDA device (marker `cuda`) and skip without one. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from audio_algebra_torch.ops import flash_attention as fa
from audio_algebra_torch.ops import groupnorm as gn
from audio_algebra_torch.ops import groupnorm_grouped as ggn

F32_TOL = 1e-4          # f32: only the order of the statistics' sums differs
BF16_TOL = 2e-2         # bf16: a one-ulp rounding flip at |y| < 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 1024, 64), (1, 2, 128, 16), (1, 4, 256, 128)])
@pytest.mark.parametrize("dtype,bias_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.float32),
                                              (torch.float32, torch.bfloat16)])
def test_flash_attention_matches_twin_on_card(cuda_device, shape, dtype, bias_dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    h, t = shape[1], shape[2]
    bias_t = (torch.randn((h, t, t), generator=g, device=cuda_device) * 0.5).to(bias_dtype)
    scale = shape[3] ** -0.5
    before = fa.launches
    got = fa.flash_attention_relpos(q, k, v, bias_t, scale)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_relpos_ref(q, k, v, bias_t, scale)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,film", [((2, 512, 2048), True), ((2, 1536, 2048), False),
                                        ((2, 1024, 32), True), ((2, 128, 1000), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gn_matches_twin_on_card(cuda_device, shape, film, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, c, _ = shape
    x = (torch.randn(shape, generator=g, device=cuda_device) * 1.5 + 0.3).to(dtype)
    scale = (torch.rand(c, generator=g, device=cuda_device) + 0.5).to(dtype)
    bias = (torch.rand(c, generator=g, device=cuda_device) - 0.5).to(dtype)
    ts = (torch.randn((b, 2 * c), generator=g, device=cuda_device) * 0.3).to(dtype)
    fs, sh = ts.chunk(2, dim=1) if film else (None, None)
    before = ggn.launches
    got = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh, silu=True)
    torch.cuda.synchronize()
    assert ggn.launches == before + 1
    want = ggn.grouped_gn_film_silu_ref(x, scale, bias, 8, fs, sh, silu=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
