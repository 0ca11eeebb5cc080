"""Kernels of the PyTorch port on the card, each CUDA kernel against its
plain PyTorch twin: K1 (GroupNorm(1) + GELU + residual) and K2 (its turbo
int8 modes) at the UNet's shapes and a ragged one, K3 (rel-pos flash
attention) and K5 (grouped GroupNorm + FiLM + SiLU) at the MIRAGE UNet's
shapes, K2a also over its L2 row groups (a short last group, a row
above the group's budget, channels changing inside a vector); K4 (the
differentiable flash attention: forward with residuals, dK/dV, dQ and
d-bias) at the trainer's shapes and batch sizes 1 to 16, K4b and K4c each
alone with a same-bits check of two launches; the
autograd Functions around K1, K5 and K6 against autograd of their twins,
and the refusal of K2 and K3 to take inputs that require grad; K6 (the
fused STFT) on both routes, the FFT at n_fft 16 to 4096 and the DFT product
at other n_fft, against its twin and float64; the attention site of a
training UNet at T = 1024 without the training kernels; and the turbo int8 conv (int8 tensor cores) against the
same integer arithmetic on the CPU. These tests need a
CUDA device (marker `cuda`) and skip without one. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from audio_algebra_torch.models import blocks as tb
from audio_algebra_torch.models import unet_cfg1d as tunet
from audio_algebra_torch.models.stacked import v_objective_loss
from audio_algebra_torch.ops import flash_attention as fa
from audio_algebra_torch.ops import groupnorm as gn
from audio_algebra_torch.ops import groupnorm_grouped as ggn
from audio_algebra_torch.ops import stft as st
from audio_algebra_torch.ops import stft_kernel as stk
from audio_algebra_torch.utils.params import random_init_

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
@pytest.mark.parametrize("shape,dtype", [
    ((1, 256, 65536), torch.bfloat16),      # the decode's level 0 at B = 1: one group
    ((16, 256, 65536), torch.bfloat16),     # level 0 at B = 16: 16 groups of one row
    ((5, 512, 16384), torch.bfloat16),      # groups of 2 rows, 5 rows: a short last group
    ((17, 1024, 4096), torch.bfloat16),     # groups of 4 rows, 17 rows
    ((3, 256, 65536), torch.float32),       # a row larger than a group's L2 budget
    ((4, 128, 1001), torch.bfloat16),       # t_len % 8 != 0: channels change inside a vector
    ((3, 64, 4100), torch.float32),         # t_len % 4 == 0 but % 8 != 0
    ((2, 3, 1001), torch.bfloat16),         # n % 8 != 0: the element path
])
@pytest.mark.parametrize("gelu", [True, False])
def test_turbo_quant_matches_twin_on_card(cuda_device, shape, dtype, gelu):
    """K2a's one cooperative launch over L2 row groups against its twin:
    int8 within 1 LSB on at most 0.1 % of elements; and the same bits on a
    second launch (the statistics are summed in a fixed order)."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=cuda_device) * 1.5 + 0.2).to(dtype)
    scale = (torch.rand(c, generator=g, device=cuda_device) + 0.5).to(dtype)
    bias = (torch.rand(c, generator=g, device=cuda_device) - 0.5).to(dtype)
    grid = torch.rand(c, generator=g, device=cuda_device) * 0.06 + 0.02
    before = gn.quant_launches
    got = gn.groupnorm1_gelu_quant(x, scale, bias, grid, gelu)
    again = gn.groupnorm1_gelu_quant(x, scale, bias, grid, gelu)
    torch.cuda.synchronize()
    assert gn.quant_launches == before + 2 and got.dtype == torch.int8
    _int8_close(got, gn.groupnorm1_gelu_quant_ref(x, scale, bias, grid, gelu))
    assert torch.equal(got, again)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_fft,hop,center", [
    ((32, 65536), 1024, 256, True), ((1, 1048576), 1024, 480, True),
    ((2, 3, 4000), 512, 128, False), ((3, 5000), 256, 64, True), ((1, 9000), 1024, 1000, True)])
def test_stft_kernel_matches_twin_on_card(cuda_device, shape, n_fft, hop, center):
    """K6 against its twin at the JAX package's own kernel tolerance
    (atol 5e-4, rtol 1e-4); `stft` takes K6 for the default window only."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda_device) * 0.5
    before = stk.launches
    got = st.stft(x, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert stk.launches == before + 1 and got.dtype == torch.complex64
    want = stk.stft_ref(x, n_fft, hop, center)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    st.stft(x, n_fft, hop, window=st.hann_window(n_fft, device=cuda_device), center=center)
    assert stk.launches == before + 1


def _stft_vs_exact(x, n_fft, hop, center):
    """(kernel, twin, max |kernel - f64|, max |twin - f64|)."""
    got = stk.stft_fused(x, n_fft, hop, center)
    torch.cuda.synchronize()
    want = stk.stft_ref(x, n_fft, hop, center)
    win = torch.hann_window(n_fft, dtype=torch.float64, device=x.device)
    exact = torch.stft(x.double().reshape(-1, x.shape[-1]), n_fft, hop, window=win,
                       center=center, pad_mode="reflect", return_complex=True)
    exact = exact.reshape(want.shape)
    return got, want, float((got - exact).abs().max()), float((want - exact).abs().max())


# rows by hop: hop 1 gives a frame per sample, so one row
@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [16, 64, 256, 1024, 4096])
@pytest.mark.parametrize("hop", [1, 480, "quarter"])
@pytest.mark.parametrize("center", [True, False])
def test_stft_fft_route_matches_twin_and_f64_on_card(cuda_device, n_fft, hop, center):
    """The FFT route at every power-of-two n_fft the port takes it for:
    within the JAX kernel's tolerance of the twin, and no further from an
    exact (float64) STFT than the twin; a length that leaves the last
    frame tile partial."""
    hop = n_fft // 4 if hop == "quarter" else hop
    rows = {1: (1,), 480: (40,)}.get(hop, (3,))
    t_len = 3 * n_fft + 333 + (480 * 7 if hop == 480 else 0)
    g = torch.Generator(device=cuda_device).manual_seed(n_fft + hop)
    x = torch.randn((*rows, t_len), generator=g, device=cuda_device) * 0.5
    before = (stk.launches, stk.fft_launches, stk.dft_launches)
    got, want, k_err, t_err = _stft_vs_exact(x, n_fft, hop, center)
    assert (stk.launches, stk.fft_launches, stk.dft_launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert got.shape == want.shape and got.dtype == torch.complex64
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    # at 16 and 64 points both are a few f32 ulps of the peak, and the real
    # FFT's split adds a rounding that a 16-term dot product does not have
    assert k_err <= (t_err if n_fft >= 256 else 2 * t_err), (k_err, t_err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_fft,hop,center", [
    ((32, 65536), 1000, 250, True), ((3, 5000), 400, 160, False), ((1, 9000), 1536, 480, True)])
def test_stft_dft_route_matches_twin_on_card(cuda_device, shape, n_fft, hop, center):
    """Any n_fft that is not a power of two takes the DFT product."""
    g = torch.Generator(device=cuda_device).manual_seed(n_fft)
    x = torch.randn(shape, generator=g, device=cuda_device) * 0.5
    assert not stk.uses_fft(n_fft)
    before = (stk.launches, stk.fft_launches, stk.dft_launches)
    got, want, _, _ = _stft_vs_exact(x, n_fft, hop, center)
    assert (stk.launches, stk.fft_launches, stk.dft_launches) == \
        (before[0] + 1, before[1], before[2] + 1)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (1024, 480), (1000, 250)])
def test_stft_gradient_through_the_kernel_on_card(cuda_device, n_fft, hop):
    """K6 under grad launches inside its autograd.Function; the gradient of
    sum(|X|^2 w) equals the one through the twin."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = (torch.randn((2, 16384), generator=g, device=cuda_device) * 0.5).requires_grad_()
    before = stk.launches
    spec = stk.stft_fused(x, n_fft, hop)
    assert spec.grad_fn is not None and stk.launches == before + 1
    w = torch.rand(spec.shape, generator=g, device=cuda_device)
    got, = torch.autograd.grad((spec.abs().square() * w).sum(), x)
    want, = torch.autograd.grad((stk.stft_ref(x, n_fft, hop).abs().square() * w).sum(), x)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)


def _flash_inputs(device, shape, dtype, bias_dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=device).to(dtype)
                   for _ in range(4))
    h, t = shape[1], shape[2]
    bias_t = (torch.randn((h, t, t), generator=g, device=device) * 0.5).to(bias_dtype)
    return q, k, v, do, bias_t


# f32: JAX's own tolerance for its training kernels (tests/test_flash_attention.py);
# bf16: a rounding flip of p or ds before a product, summed over T terms
K4_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 512, 64), (2, 16, 1024, 64), (3, 2, 512, 32),
                                   (8, 4, 512, 64), (16, 2, 512, 16), (2, 2, 512, 128)])
@pytest.mark.parametrize("dtype,bias_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_flash_train_kernels_match_twins_on_card(cuda_device, shape, dtype, bias_dtype):
    """K4a's (o, l, m), K4b's (dk, dv) and K4c's (dq, dbT) against the twins;
    the batch sum of dbT at B = 1, 2, 3, 8, 16."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, dtype, bias_dtype, 6)
    scale = shape[3] ** -0.5
    before = (fa.launches, fa.train_fwd_launches, fa.dkv_launches, fa.dq_launches)
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
    grads = fa.flash_attention_relpos_bwd(q, k, v, bias_t, o, l, m, do, scale)
    torch.cuda.synchronize()
    assert (fa.launches, fa.train_fwd_launches, fa.dkv_launches, fa.dq_launches) == \
        (before[0], before[1] + 1, before[2] + 1, before[3] + 1)
    o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale)
    tol = K4_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), **tol)
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-3 if dtype == torch.bfloat16 else 1e-4)
    # the twin from the kernel's own residuals: what the kernels were given
    want = fa.flash_attention_relpos_bwd_ref(q, k, v, bias_t, o, l, m, do, scale)
    for name, a, b in zip(("dq", "dk", "dv", "dbT"), grads, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        btol = tol if name != "dbT" or bias_dtype == torch.float32 else K4_TOL[torch.bfloat16]
        torch.testing.assert_close(a.float(), b.float(), msg=lambda s: f"{name}: {s}", **btol)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 8, 17])
@pytest.mark.parametrize("t", [512, 1024, 2048])
@pytest.mark.parametrize("dtype,bias_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_flash_dq_kernel_matches_twin_on_card(cuda_device, batch, t, dtype, bias_dtype):
    """K4c alone, (dq, dbT) against the twin from the same residuals: B = 17
    is above one batch chunk of the kernel (8 in bf16, 4 in f32 at D = 64),
    so the d(biasT) strip's read-add-write across chunks is exercised."""
    shape = (batch, 2, t, 64)
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, dtype, bias_dtype, batch + t)
    scale = shape[3] ** -0.5
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
    delta = fa.flash_delta(o, do)
    before = fa.dq_launches
    dq, dbt = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, scale)
    torch.cuda.synchronize()
    assert fa.dq_launches == before + 1
    want_dq, _, _, want_dbt = fa.flash_attention_relpos_bwd_ref(q, k, v, bias_t, o, l, m, do,
                                                                scale)
    assert dq.dtype == want_dq.dtype and dbt.dtype == want_dbt.dtype
    torch.testing.assert_close(dq.float(), want_dq.float(), **K4_TOL[dtype])
    torch.testing.assert_close(dbt.float(), want_dbt.float(), **K4_TOL[bias_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dq_kernel_gives_the_same_bits_every_run(cuda_device, dtype):
    """K4c sums in a fixed order (no atomics): two launches, equal bits."""
    shape = (17, 2, 1024, 64)
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, dtype, dtype, 14)
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
    delta = fa.flash_delta(o, do)
    first = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, 0.125)
    second = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 1024, 64), (8, 16, 512, 64), (16, 16, 1024, 64),
                                   (1, 16, 1024, 64), (2, 2, 64, 64), (3, 5, 512, 64),
                                   (7, 3, 256, 32), (16, 2, 512, 16), (2, 2, 512, 128)])
@pytest.mark.parametrize("dtype,bias_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_flash_dkv_kernel_matches_twin_on_card(cuda_device, shape, dtype, bias_dtype):
    """K4b alone, (dk, dv) against the twin from the same residuals: the
    trainer's shapes (the kernels_k4 phase of chip_smoke.py), T = 64 (one
    query tile), B.H = 15 and 21 (not multiples of the 132 SMs), and every
    head dim (one cp.async stage at D = 128 in f32, two below)."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, dtype, bias_dtype, 40 + shape[2])
    scale = shape[3] ** -0.5
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
    delta = fa.flash_delta(o, do)
    before = fa.dkv_launches
    dk, dv = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, scale)
    torch.cuda.synchronize()
    assert fa.dkv_launches == before + 1
    _, want_dk, want_dv, _ = fa.flash_attention_relpos_bwd_ref(q, k, v, bias_t, o, l, m, do,
                                                               scale)
    assert dk.dtype == want_dk.dtype and dv.dtype == want_dv.dtype
    torch.testing.assert_close(dk.float(), want_dk.float(), **K4_TOL[dtype])
    torch.testing.assert_close(dv.float(), want_dv.float(), **K4_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bias_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_flash_dkv_kernel_gives_the_same_bits_every_run(cuda_device, dtype, bias_dtype):
    """K4b sums in a fixed order (no atomics; the query halves of a key
    tile add in one order): two launches, equal bits."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, (5, 3, 1024, 64), dtype, bias_dtype, 15)
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
    delta = fa.flash_delta(o, do)
    first = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, 0.125)
    second = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_train_residuals_survive_a_late_row_max(cuda_device):
    """The row max sits in the last key tile: the running max is rescaled
    on the way and the saved (l, m) are the final ones."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, (1, 2, 512, 64), torch.float32,
                                        torch.float32, 7)
    k[:, :, -3:] *= 30.0
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
    o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, 0.125)
    assert bool(torch.isfinite(o).all())
    torch.testing.assert_close(o, o_ref, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(m, m_ref, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-3)
    got = fa.flash_attention_relpos_bwd(q, k, v, bias_t, o, l, m, do, 0.125)
    want = fa.flash_attention_relpos_bwd_ref(q, k, v, bias_t, o, l, m, do, 0.125)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_flash_train_function_has_a_graph_on_card(cuda_device):
    q, k, v, do, bias_t = _flash_inputs(cuda_device, (2, 2, 512, 64), torch.float32,
                                        torch.float32, 8)
    leaves = [t.requires_grad_() for t in (q, k, v, bias_t)]
    o = fa.flash_attention_relpos_train(*leaves, 0.125)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    o_plain = torch.matmul(torch.softmax(
        torch.matmul(q, k.transpose(-1, -2)) * 0.125 + bias_t.transpose(-1, -2)[None], -1), v)
    want = torch.autograd.grad(o_plain, leaves, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
    assert torch.equal(fa.flash_attention_relpos_bwd(q, k, v, bias_t, *fa.flash_attention_relpos_fwd(
        q.detach(), k.detach(), v.detach(), bias_t.detach(), 0.125), do, 0.125)[3], got[3]), \
        "dbT is summed in a fixed order: the same bits every run"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu,residual", [(True, True), (True, False), (False, False)])
def test_groupnorm1_function_grads_on_card(cuda_device, dtype, gelu, residual):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    shape = (2, 128, 1000)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype).requires_grad_()
    res = torch.randn(shape, generator=g, device=cuda_device).to(dtype).requires_grad_() \
        if residual else None
    scale = (torch.rand(128, generator=g, device=cuda_device) + 0.5).to(dtype).requires_grad_()
    bias = (torch.rand(128, generator=g, device=cuda_device) - 0.5).to(dtype).requires_grad_()
    dout = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    leaves = [x, scale, bias] + ([res] if residual else [])
    before = gn.launches
    y = gn.groupnorm1_gelu(x, scale, bias, gelu, res)
    assert y.grad_fn is not None and gn.launches == before + 1
    got = torch.autograd.grad(y, leaves, dout)
    want = torch.autograd.grad(gn.groupnorm1_gelu_ref(x, scale, bias, gelu, res), leaves, dout)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, want):
        scale_ = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=tol * scale_, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [True, False])
def test_grouped_gn_function_grads_on_card(cuda_device, dtype, film):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    b, c, t = 2, 128, 1000
    x = (torch.randn((b, c, t), generator=g, device=cuda_device) * 1.5).to(dtype).requires_grad_()
    scale = (torch.rand(c, generator=g, device=cuda_device) + 0.5).to(dtype).requires_grad_()
    bias = (torch.rand(c, generator=g, device=cuda_device) - 0.5).to(dtype).requires_grad_()
    ts = (torch.randn((b, 2 * c), generator=g, device=cuda_device) * 0.3).to(dtype).requires_grad_()
    fs, sh = ts.chunk(2, dim=1) if film else (None, None)
    dout = torch.randn((b, c, t), generator=g, device=cuda_device).to(dtype)
    leaves = [x, scale, bias] + ([ts] if film else [])
    before = ggn.launches
    y = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
    assert y.grad_fn is not None and ggn.launches == before + 1
    got = torch.autograd.grad(y, leaves, dout)
    want = torch.autograd.grad(ggn.grouped_gn_film_silu_ref(x, scale, bias, 8, fs, sh),
                               leaves, dout)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b_ in zip(got, want):
        scale_ = float(b_.float().abs().max())
        torch.testing.assert_close(a.float(), b_.float(), atol=tol * scale_, rtol=tol)


@pytest.mark.cuda
def test_inference_only_kernels_refuse_grad_on_card(cuda_device):
    """K2 and K3 have no backward: with an input that requires grad they
    raise rather than return a tensor cut off from the graph."""
    x = torch.randn((2, 128, 256), device=cuda_device).requires_grad_()
    scale, bias = torch.ones(128, device=cuda_device), torch.zeros(128, device=cuda_device)
    grid = torch.full((128,), 0.05, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        gn.groupnorm1_gelu_quant(x, scale, bias, grid)
    with pytest.raises(RuntimeError, match="no backward"):
        gn.groupnorm1_gelu_res_amax(x, scale, bias, x.detach())
    q = torch.randn((1, 2, 128, 16), device=cuda_device).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_relpos(q, q, q, torch.zeros((2, 128, 128), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_small_unet_trains_through_the_kernels_on_card(cuda_device, remat):
    """A small UNetCFG1d with one attention level at T = 512: loss and every
    parameter gradient through K4 and K5 against the same through their
    twins; with remat each block's kernels launch twice."""
    cfg = dict(in_channels=4, channels=32, multipliers=(1, 2), factors=(2,), num_blocks=(1,),
               attentions=(0, 1), attention_heads=2, attention_features=32, resnet_groups=4)
    model = random_init_(tunet.UNetCFG1d(remat=remat, **cfg), 0).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    latents = torch.tanh(torch.randn((3, 4, 1024), generator=g, device=cuda_device))
    noise = torch.randn((3, 4, 1024), generator=g, device=cuda_device)
    emb = torch.randn((3, 1, 512), generator=g, device=cuda_device)
    t = torch.rand((3,), generator=g, device=cuda_device)
    keep = torch.tensor([True, False, True], device=cuda_device)

    def run():
        model.zero_grad(set_to_none=True)
        loss = v_objective_loss(model, latents, emb, t, noise, keep=keep)
        loss.backward()
        return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    before = (fa.launches, fa.train_fwd_launches, fa.dkv_launches, fa.dq_launches, ggn.launches)
    loss, grads = run()
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip((fa.launches, fa.train_fwd_launches, fa.dkv_launches,
                                          fa.dq_launches, ggn.launches), before))
    n_gn = 3 * 2 + 1                           # three ResnetBlocks x 2 norms, and out_norm
    assert counts == (0, 2 if remat else 1, 1, 1, 2 * n_gn - 1 if remat else n_gn)
    tunet.flash_attention_relpos_train = fa.flash_attention_relpos_train_ref
    tb.grouped_gn_film_silu = ggn.grouped_gn_film_silu_ref
    try:
        want_loss, want = run()
    finally:
        tunet.flash_attention_relpos_train = fa.flash_attention_relpos_train
        tb.grouped_gn_film_silu = ggn.grouped_gn_film_silu
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for name, w in want.items():
        err = float((grads[name] - w).abs().max() / w.abs().max().clamp_min(1e-12))
        assert err < 1e-3, f"{name}: {err}"
        assert bool(grads[name].any()) == bool(w.any()), name


@pytest.mark.cuda
def test_untrained_attention_site_backward_at_t1024_on_card(cuda_device):
    """The training UNet's attention at T = 1024 with train_flash off: under
    grad it takes the plain route (K3 would refuse), and a backward step
    gives finite gradients."""
    mod = random_init_(tunet.RelPosSelfAttention(128, 4, 32, train_flash=False), 0).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn((2, 1024, 128), generator=g, device=cuda_device).requires_grad_()
    before = (fa.launches, fa.train_fwd_launches)
    y = mod(x)
    y.square().mean().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.train_fwd_launches) == before
    grads = [x.grad] + [p.grad for p in mod.parameters()]
    assert all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads)
    assert bool(mod.rel_pos_bias.grad.any())
