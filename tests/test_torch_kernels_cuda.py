"""Kernels of the PyTorch port on the card, each CUDA kernel against its
plain PyTorch twin: K1 (GroupNorm(1) + GELU + residual) and K2 (its turbo
int8 modes) at the UNet's shapes and a ragged one, K3 (rel-pos flash
attention) and K5 (grouped GroupNorm + FiLM + SiLU) at the MIRAGE UNet's
shapes; and the turbo int8 conv (int8 tensor cores) against the same
integer arithmetic on the CPU. These tests need a
CUDA device (marker `cuda`) and skip without one. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from audio_algebra_torch.models import blocks as tb
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


def _int8_close(got, want):
    """int8 equal but for rounding ties (the kernel may contract a multiply
    and add that the twin rounds twice): <= 1 LSB on <= 0.1 % of values."""
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 4096), (16, 512, 8), (2, 128, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["quant", "res_amax", "res_amax_q"])
def test_turbo_gn_matches_twin_on_card(cuda_device, shape, dtype, mode):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=cuda_device) * 1.5 + 0.2).to(dtype)
    res = (torch.randn(shape, generator=g, device=cuda_device) * 2.0).to(dtype)
    scale = (torch.rand(c, generator=g, device=cuda_device) + 0.5).to(dtype)
    bias = (torch.rand(c, generator=g, device=cuda_device) - 0.5).to(dtype)
    grid = torch.rand(c, generator=g, device=cuda_device) * 0.06 + 0.02
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if mode == "quant":
        before = gn.quant_launches
        got = gn.groupnorm1_gelu_quant(x, scale, bias, grid)
        torch.cuda.synchronize()
        assert gn.quant_launches == before + 1 and got.dtype == torch.int8
        _int8_close(got, gn.groupnorm1_gelu_quant_ref(x, scale, bias, grid))
        return
    q = grid if mode == "res_amax_q" else None
    counter = "amax_q_launches" if q is not None else "amax_launches"
    before = getattr(gn, counter)
    got = gn.groupnorm1_gelu_res_amax(x, scale, bias, res, q_emit_scale=q)
    torch.cuda.synchronize()
    assert getattr(gn, counter) == before + 1
    want = gn.groupnorm1_gelu_res_amax_ref(x, scale, bias, res, q_emit_scale=q)
    assert len(got) == len(want)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    # the kernel's f32 sum may differ from the twin's by a rounding; the max
    # of |out| moves no more than the largest such difference
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-5)
    if q is not None:
        _int8_close(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,t", [(256, 2, 4096), (256, 256, 1024)])
def test_int8_conv_on_card_matches_the_integers(cuda_device, c_in, c_out, t):
    """torch._int_mm on the card (cuBLASLt, int8 tensor cores) gives the
    exact int32 sums of the CPU, the 2-channel io head included."""
    g = torch.Generator().manual_seed(4)
    x8 = torch.randint(-127, 128, (16, c_in, t), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (c_out, c_in, 5), generator=g, dtype=torch.int8)
    want = tb._int8_conv_acc(x8, w8)
    got = tb._int8_conv_acc(x8.to(cuda_device), w8.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    s = torch.rand(c_in, generator=g) * 0.02 + 0.005
    w = torch.randn((c_out, c_in, 5), generator=g) * 0.05
    bias = torch.randn(c_out, generator=g) * 0.1
    y = tb.conv1d_int8(x8.to(cuda_device), s.to(cuda_device), w.to(cuda_device),
                       bias.to(cuda_device), torch.bfloat16)
    ref = tb.conv1d_int8(x8, s, w, bias, torch.bfloat16)
    torch.testing.assert_close(y.cpu().float(), ref.float(), atol=BF16_TOL, rtol=BF16_TOL)
