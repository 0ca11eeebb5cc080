"""Kernels of the PyTorch port on the card, each CUDA kernel against its
plain PyTorch twin: K1 (GroupNorm(1) + GELU + residual) and K2 (its turbo
int8 modes) at the UNet's shapes and a ragged one, K3 (rel-pos flash
attention) and K5 (grouped GroupNorm + FiLM + SiLU) at the MIRAGE UNet's
shapes, K5 on both its routes with a same-bits check, K3's bf16 serving
kernel at B = 1 to 4 and T = 1024 to 3072 with both bias dtypes, K2a also over its L2 row groups (a short last group, a row
above the group's budget, channels changing inside a vector); K4 (the
differentiable flash attention: forward with residuals, dK/dV, dQ and
d-bias) at the trainer's shapes and batch sizes 1 to 16, K4a's 3xTF32 f32
route at every head dim, B = 1, 3, 8, T = 64 to 1024, both bias dtypes and
each block it can take, K4a's and K4b's bf16 routes at D = 32 to 128, B =
1 to 16, both bias dtypes and each block they can take, K4a, K4b and K4c
each alone with a same-bits check of two launches (K4c at every head
dim, B = 1 to 17 and both bias dtypes); the
autograd Functions around K1, K5 and K6 against autograd of their twins,
and the refusal of K2 and K3 to take inputs that require grad; K6 (the
fused STFT) on its routes, the mixed-radix FFT at powers of two from 16 to
8192 and at n_fft with odd radices 3 to 13, the chirp-z route (even n_fft
whose half has a prime factor above 13, odd n_fft) within one block, the
cluster route for frames of more than 4096 points, and the DFT product
below 16, against its twin and float64, at frame spans past shared memory
and rows past 65,535, and at clips no longer than its reflect padding on
each route; the attention site of a
training UNet at T = 1024 without the training kernels; the turbo int8 conv (int8 tensor cores) against the
same integer arithmetic on the CPU; and the effects bank's recurrences R1
(the biquad cascade, 1-12 sections, per-row or shared coefficients, ragged
lengths, its chunked scan with short last chunks, a row too short to
cut and 8 or 9 sections), R2 (the compressor's envelope) and R3 (Freeverb's impulse
responses, both spreads, at 48 and 44.1 kHz) against their twins and
float64, with the effects that run on them. These tests need a
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
from audio_algebra_torch.ops import recurrence as rec
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


# K5's main-path shapes (chip_smoke.py kernels_k5 and the trainer's widest
# f32 level), a row of 2 MB in f32 (16 CTAs a cluster) and one too long for
# any cluster (4 MB in f32: the two-pass route); channels that change inside
# a vector, and rows that are no whole number of vectors
K5_ROUTE_CASES = [((2, 512, 2048), torch.bfloat16, True, "cluster"),
                  ((2, 1536, 2048), torch.bfloat16, False, "cluster"),
                  ((2, 1024, 32), torch.bfloat16, True, "cluster"),
                  ((2, 512, 2048), torch.float32, True, "cluster"),
                  ((8, 512, 2048), torch.float32, True, "cluster"),
                  ((2, 128, 32768), torch.float32, True, "cluster"),
                  ((1, 64, 131072), torch.float32, True, "two_pass"),
                  ((2, 128, 1001), torch.bfloat16, True, "cluster"),
                  ((2, 16, 1001), torch.bfloat16, False, "cluster")]


def _ggn_inputs(device, shape, dtype, film, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b, c, _ = shape
    x = (torch.randn(shape, generator=g, device=device) * 1.5 + 0.3).to(dtype)
    scale = (torch.rand(c, generator=g, device=device) + 0.5).to(dtype)
    bias = (torch.rand(c, generator=g, device=device) - 0.5).to(dtype)
    ts = (torch.randn((b, 2 * c), generator=g, device=device) * 0.3).to(dtype)
    fs, sh = ts.chunk(2, dim=1) if film else (None, None)
    return x, scale, bias, fs, sh


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,film,route", K5_ROUTE_CASES)
def test_grouped_gn_routes_match_twin_on_card(cuda_device, shape, dtype, film, route):
    """Each route against the twin, counted in its own counter; the cluster
    route takes one launch and no scratch tensor."""
    x, scale, bias, fs, sh = _ggn_inputs(cuda_device, shape, dtype, film, 12)
    assert ggn.ggn_plan(*shape, 8, x.element_size()).route == route
    before = (ggn.launches, ggn.cluster_launches, ggn.two_pass_launches)
    got = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
    torch.cuda.synchronize()
    one = int(route == "cluster")
    assert (ggn.launches, ggn.cluster_launches, ggn.two_pass_launches) == \
        (before[0] + 1, before[1] + one, before[2] + 1 - one)
    want = ggn.grouped_gn_film_silu_ref(x, scale, bias, 8, fs, sh)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,film,route", K5_ROUTE_CASES[:6:2] + K5_ROUTE_CASES[5:7])
def test_grouped_gn_gives_the_same_bits_every_run(cuda_device, shape, dtype, film, route):
    """The partials are folded in a fixed order (rank order across a
    cluster): two launches give the same bits."""
    x, scale, bias, fs, sh = _ggn_inputs(cuda_device, shape, dtype, film, 13)
    a = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
    b = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 3, 4])
@pytest.mark.parametrize("t", [1024, 1536, 3072])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_serve_matches_twin_on_card(cuda_device, batch, t, bias_dtype):
    """K3's bf16 serving kernel (a block serves every batch row of its
    (head, query tile)) at the MIRAGE inner UNet's lengths, 16 heads of 64."""
    g = torch.Generator(device=cuda_device).manual_seed(batch * 7 + t)
    shape = (batch, 16, t, 64)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    bias_t = (torch.randn((16, t, t), generator=g, device=cuda_device) * 0.5).to(bias_dtype)
    before = fa.launches
    got = fa.flash_attention_relpos(q, k, v, bias_t, 0.125)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_relpos_ref(q, k, v, bias_t, 0.125)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("t", [1024, 1536])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_serve_query_tiles_match_twin_on_card(cuda_device, bq, batch, t, bias_dtype):
    """Both query tiles of the serving kernel: 64 rows (one m-tile a warp)
    and 128 (two), at D = 64."""
    g = torch.Generator(device=cuda_device).manual_seed(bq + batch + t)
    shape = (batch, 16, t, 64)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    bias_t = (torch.randn((16, t, t), generator=g, device=cuda_device) * 0.5).to(bias_dtype)
    got = fa._serve_cuda(q, k, v, bias_t, 0.125, bq)
    torch.cuda.synchronize()
    want = fa.flash_attention_relpos_ref(q, k, v, bias_t, 0.125)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)


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
    ((2, 3, 4000), 512, 128, False), ((3, 5000), 256, 64, True), ((1, 9000), 1024, 1000, True),
    ((3, 5000), 400, 160, False)])
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
    got, want, exact = _stft_kernel_twin_exact(x, n_fft, hop, center)
    return got, want, float((got - exact).abs().max()), float((want - exact).abs().max())


def _stft_kernel_twin_exact(x, n_fft, hop, center):
    """K6, its twin and a float64 torch.stft of x."""
    got = stk.stft_fused(x, n_fft, hop, center)
    torch.cuda.synchronize()
    want = stk.stft_ref(x, n_fft, hop, center)
    win = torch.hann_window(n_fft, dtype=torch.float64, device=x.device)
    exact = torch.stft(x.double().reshape(-1, x.shape[-1]), n_fft, hop, window=win,
                       center=center, pad_mode="reflect", return_complex=True)
    return got, want, exact.reshape(want.shape)


ROUTES = ("fft", "chirp", "cluster", "dft")


def _route_launches() -> dict:
    return {route: getattr(stk, f"{route}_launches") for route in ROUTES}


def _took(before: dict) -> dict:
    """K6's launches by route since `before`."""
    return {route: n - before[route] for route, n in _route_launches().items()}


# rows by hop: hop 1 gives a frame per sample, so one row
@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [16, 64, 256, 1024, 4096, 8192,
                                   26, 384, 400, 750, 1000, 1408, 1536, 1920])
@pytest.mark.parametrize("hop", [1, 480, "quarter"])
@pytest.mark.parametrize("center", [True, False])
def test_stft_fft_route_matches_twin_and_f64_on_card(cuda_device, n_fft, hop, center):
    """The FFT route at powers of two from 16 to 4096 (8192: the same
    radix-8 stages on the cluster route, one CTA a frame) and at n_fft whose
    plans hold odd radices (26: 13 alone; 384: 8, 8, 3; 400: 8, 5, 5, 25 ms
    at 16 kHz; 750: 3, 5, 5, 5, an odd half; 1000: 4, 5, 5, 5; 1408: 8, 8,
    11; 1536: 4, 8, 8, 3; 1920: 8, 8, 3, 5): within the JAX kernel's tolerance of the twin, and no further
    from an exact (float64) STFT than the twin; a length that leaves the
    last frame tile partial."""
    route = "cluster" if n_fft == 8192 else "fft"
    assert stk.plan(n_fft).route == route
    hop = n_fft // 4 if hop == "quarter" else hop
    rows = {1: (1,), 480: (40,)}.get(hop, (3,))
    t_len = 3 * n_fft + 333 + (480 * 7 if hop == 480 else 0)
    g = torch.Generator(device=cuda_device).manual_seed(n_fft + hop)
    x = torch.randn((*rows, t_len), generator=g, device=cuda_device) * 0.5
    before, launches = _route_launches(), stk.launches
    got, want, k_err, t_err = _stft_vs_exact(x, n_fft, hop, center)
    assert stk.launches == launches + 1 and _took(before) == {r: int(r == route) for r in ROUTES}
    assert got.shape == want.shape and got.dtype == torch.complex64
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    # at 16 and 64 points both are a few f32 ulps of the peak, and the real
    # FFT's split adds a rounding that a 16-term dot product does not have
    assert k_err <= (t_err if n_fft >= 256 else 2 * t_err), (k_err, t_err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_fft,hop,center", [
    ((32, 65536), 1018, 250, True), ((3, 5000), 999, 160, False), ((1, 9000), 1538, 480, True),
    ((2, 30000), 10000, 2500, True), ((4, 262144), 8192, 2048, True),
    ((4, 262144), 16384, 4096, True), ((2, 40000), 4097, 1000, True),
    ((2, 70000), 20001, 5000, False), ((3, 9000), 1102, 441, True), ((5, 3000), 14, 7, True),
    ((2, 60000), 24000, 6000, True), ((2, 40000), 8194, 2048, True)])
def test_stft_dft_route_matches_twin_on_card(cuda_device, shape, n_fft, hop, center):
    """The n_fft that took the DFT product before the chirp-z and cluster
    routes, on the route `plan` gives them now: an odd n_fft (999; 4097 and
    20001 on clusters of 4 and 16 CTAs), a prime factor of the half above
    13 (509, 769, 551 = 19 x 29) on the chirp route, above 8192 on the
    cluster route (16384 on 2 CTAs; 10000 and 24000 on 2 and 4 mixed-radix
    parts; 8194 by chirp-z on 4 CTAs), 8192 on the cluster route (a CTA a
    frame; on the FFT route before), and n_fft 14 on the DFT product. One
    launch on the planned route, within the JAX kernel's tolerance of the
    twin and of a float64 STFT."""
    g = torch.Generator(device=cuda_device).manual_seed(n_fft)
    x = torch.randn(shape, generator=g, device=cuda_device) * 0.5
    route = stk.plan(n_fft).route
    assert route == {14: "dft"}.get(
        n_fft, "chirp" if n_fft in (1018, 999, 1538, 1102) else "cluster")
    before, launches = _route_launches(), stk.launches
    got, want, exact = _stft_kernel_twin_exact(x, n_fft, hop, center)
    assert stk.launches == launches + 1 and _took(before) == {r: int(r == route) for r in ROUTES}
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    torch.testing.assert_close(got.to(exact.dtype), exact, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_fft,hop", [
    ((4, 262144), 8192, 2048), ((8, 48000), 2000, 2000), ((2, 40000), 6144, 1536),
    ((8, 48000), 2018, 2018), ((70000, 64), 16, 16), ((70000, 64), 34, 34),
    ((70000, 64), 33, 33), ((66000, 8), 2049, 2049)])
def test_stft_long_spans_and_many_rows_on_card(cuda_device, shape, n_fft, hop):
    """Shapes the JAX package computes whose 32-frame span passes a block's
    shared memory (2000 / 2000, 6144 / 1536 on the FFT, 8192 / 2048 on the
    cluster route, 2018 / 2018 on the chirp-z route) and more than 65,535 rows on the FFT, chirp
    (34 even, 33 odd) and cluster routes (2049 odd, on 2 CTAs, rows shorter
    than the pad): one launch each, on the planned route, within the JAX
    kernel's tolerance of the twin."""
    g = torch.Generator(device=cuda_device).manual_seed(n_fft + hop)
    x = torch.randn(shape, generator=g, device=cuda_device) * 0.5
    route = stk.plan(n_fft).route
    before = _route_launches()
    got = stk.stft_fused(x, n_fft, hop)
    torch.cuda.synchronize()
    assert _took(before) == {r: int(r == route) for r in ROUTES}
    want = stk.stft_ref(x, n_fft, hop)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (1000, 250), (1018, 250), (2048, 512),
                                       (64, 16), (999, 250), (2049, 512)])
@pytest.mark.parametrize("length", ["1", "2", "quarter", "half", "half+1"])
def test_stft_short_clips_match_twin_and_f64_on_card(cuda_device, n_fft, hop, length):
    """Clips no longer than the pad n_fft / 2, or one sample longer, on
    each route (1024 / 256 and 2048 / 512 PitchShift's the power-of-two
    FFT, 1000 / 250 the mixed radices, 1018 / 250 and 999 / 250 the
    chirp-z route, 2049 / 512 the cluster route on 2 CTAs): the
    reflect padding folds as numpy's does, as often as it needs. Within the
    JAX kernel's tolerance of the twin and of a float64 STFT of numpy's
    reflect-padded clip, 2-4 rows."""
    import numpy as np

    half = n_fft // 2
    t_len = {"1": 1, "2": 2, "quarter": n_fft // 4, "half": half, "half+1": half + 1}[length]
    rows = 2 + t_len % 3
    g = torch.Generator(device=cuda_device).manual_seed(n_fft + t_len)
    x = torch.randn((rows, t_len), generator=g, device=cuda_device) * 0.5
    route = stk.plan(n_fft).route
    before = _route_launches()
    got = stk.stft_fused(x, n_fft, hop)
    torch.cuda.synchronize()
    assert _took(before) == {r: int(r == route) for r in ROUTES}
    want = stk.stft_ref(x, n_fft, hop)
    assert got.shape == want.shape == (rows, half + 1, 1 + (t_len + 2 * half - n_fft) // hop)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    padded = np.pad(x.double().cpu().numpy(), ((0, 0), (half, half)), mode="reflect")
    exact = torch.stft(torch.from_numpy(padded).to(cuda_device), n_fft, hop,
                       window=torch.hann_window(n_fft, dtype=torch.float64, device=cuda_device),
                       center=False, return_complex=True)
    torch.testing.assert_close(got.to(torch.complex128), exact, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (1024, 480), (1000, 250), (1018, 250),
                                       (999, 250)])
def test_stft_gradient_through_the_kernel_on_card(cuda_device, n_fft, hop):
    """K6 under grad launches inside its autograd.Function (the FFT and the
    chirp-z routes); the gradient of sum(|X|^2 w) equals the one through
    the twin."""
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


# K4b's shapes (the trainer's, T = 64, B.H not a multiple of the 132 SMs, every head dim)
K4_SHAPES = [(8, 16, 1024, 64), (8, 16, 512, 64), (16, 16, 1024, 64), (1, 16, 1024, 64),
             (2, 2, 64, 64), (3, 5, 512, 64), (7, 3, 256, 32), (16, 2, 512, 16), (2, 2, 512, 128)]
K4_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(batch, 2, t, 64) for batch in (1, 3, 8, 17)
                                   for t in (512, 1024, 2048)] + K4_SHAPES)
@pytest.mark.parametrize("dtype,bias_dtype", K4_DTYPES)
def test_flash_dq_kernel_matches_twin_on_card(cuda_device, shape, dtype, bias_dtype):
    """K4c alone, (dq, dbT) against the twin from the same residuals: B up
    to 17, above one batch chunk of either route (bf16: 128 / D rows a warp
    in two slots, 4 rows at D = 64; f32: 4 at D = 64), so the d(biasT)
    strip's read-add-write across chunks is exercised; and K4b's shapes:
    the trainer's, T = 64 (one query tile), B.H = 15 and 21, and every head
    dim (wgmma at D = 64 in bf16, mma.sync at 16, 32 and 128)."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, dtype, bias_dtype,
                                        shape[0] + shape[2])
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
    # d(biasT) sums ds over the batch in f32: bf16's tolerance where q or the bias is bf16
    btol = K4_TOL[torch.float32 if dtype == bias_dtype == torch.float32 else torch.bfloat16]
    torch.testing.assert_close(dbt.float(), want_dbt.float(), **btol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,batch", [(torch.float32, 17), (torch.bfloat16, 1),
                                         (torch.bfloat16, 8), (torch.bfloat16, 16),
                                         (torch.bfloat16, 17)])
def test_flash_dq_kernel_gives_the_same_bits_every_run(cuda_device, dtype, batch):
    """K4c sums in a fixed order (no atomics): two launches, equal bits."""
    shape = (batch, 2, 1024, 64)
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, dtype, dtype, 14)
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
    delta = fa.flash_delta(o, do)
    first = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, 0.125)
    second = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("dtype,bias_dtype", K4_DTYPES[:3])
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
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("batch", [1, 2, 8, 16])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_bf16_fwd_and_dkv_match_twins_on_card(cuda_device, d, batch, bias_dtype):
    """K4a's bf16 route (the serving kernel writing l and m) and K4b's bf16
    route (a block serving a group of batch rows of a key tile) at each head
    dim, B = 1 to 16, with a bf16 and an f32 bias, against the twins."""
    shape = (batch, 4, 512, d)
    q, k, v, do, bias_t = _flash_inputs(cuda_device, shape, torch.bfloat16, bias_dtype,
                                        80 + batch + d)
    scale = d ** -0.5
    before = (fa.launches, fa.train_fwd_launches, fa.dkv_launches)
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
    delta = fa.flash_delta(o, do)
    dk, dv = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, scale)
    torch.cuda.synchronize()
    assert (fa.launches, fa.train_fwd_launches, fa.dkv_launches) == \
        (before[0], before[1] + 1, before[2] + 1)
    o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale)
    torch.testing.assert_close(o.float(), o_ref.float(), **K4_TOL[torch.bfloat16])
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-3)
    _, want_dk, want_dv, _ = fa.flash_attention_relpos_bwd_ref(q, k, v, bias_t, o, l, m, do,
                                                               scale)
    assert dk.dtype == dv.dtype == torch.bfloat16
    torch.testing.assert_close(dk.float(), want_dk.float(), **K4_TOL[torch.bfloat16])
    torch.testing.assert_close(dv.float(), want_dv.float(), **K4_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("bq,t_len", [(64, 448), (64, 512), (128, 512)])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_bf16_blocks_match_twins_on_card(cuda_device, bq, t_len, batch, bias_dtype):
    """Every block the bf16 routes take: K4a with its residuals at 64 and
    128 query rows (the serving kernel's `bq`), so at B = 3 a part group of
    four or two batch rows and at B = 1 one; K4b's two-row groups of 128
    keys (B = 3, T = 512: a part group) and its one-row block of 64 keys (B
    = 1, and T = 448, not a multiple of 128)."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, (batch, 3, t_len, 64), torch.bfloat16,
                                        bias_dtype, 90 + bq + batch + t_len)
    l = torch.empty((3, batch, t_len), dtype=torch.float32, device=cuda_device)
    m = torch.empty_like(l)
    o = fa._serve_cuda(q, k, v, bias_t, 0.125, bq, l, m)
    delta = fa.flash_delta(o, do)
    dk, dv = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, 0.125)
    torch.cuda.synchronize()
    o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, 0.125)
    torch.testing.assert_close(o.float(), o_ref.float(), **K4_TOL[torch.bfloat16])
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-3)
    _, want_dk, want_dv, _ = fa.flash_attention_relpos_bwd_ref(q, k, v, bias_t, o, l, m, do,
                                                               0.125)
    torch.testing.assert_close(dk.float(), want_dk.float(), **K4_TOL[torch.bfloat16])
    torch.testing.assert_close(dv.float(), want_dv.float(), **K4_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,t_len", [(16, 1024), (1, 1024), (7, 1024), (7, 960)])
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
def test_flash_bf16_dkv_gives_the_same_bits_every_run(cuda_device, batch, t_len, bias_dtype):
    """K4b's bf16 route owns each key's dk, dv rows in one warp, or adds its
    two query parts in one order (B = 1, and T = 960, not a multiple of
    128): two launches, equal bits."""
    q, k, v, do, bias_t = _flash_inputs(cuda_device, (batch, 4, t_len, 64), torch.bfloat16,
                                        bias_dtype, 17 + batch)
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
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("t", [64, 512, 1024])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_tf32_matches_twin_on_card(cuda_device, d, batch, t, bias_dtype):
    """K4a's f32 route (3xTF32 tensor cores, a block serving a group of
    batch rows; B = 3 leaves a partial group, T = 64 one key tile, D = 128
    one cp.async stage) against the twin: o within K3's f32 tolerance,
    which is inside K4's, and the residuals l and m."""
    q, k, v, _, bias_t = _flash_inputs(cuda_device, (batch, 2, t, d), torch.float32,
                                       bias_dtype, 60 + batch + t + d)
    scale = d ** -0.5
    before = fa.train_fwd_launches
    o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
    torch.cuda.synchronize()
    assert fa.train_fwd_launches == before + 1
    o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale)
    torch.testing.assert_close(o, o_ref, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(1, 64, 64), (2, 64, 64), (2, 64, 32), (1, 128, 64),
                                   (2, 128, 64), (2, 128, 32)])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("residuals", [True, False])
def test_flash_fwd_tf32_blocks_match_twin_on_card(cuda_device, block, batch, residuals):
    """Every block of the f32 route that `profile_kernel.py --kernel k4a
    --variants` times (1 or 2 batch rows, 64 or 128 query rows, 64 or 32
    keys a tile), with and without the residuals (K4a, K3), against the
    twin."""
    q, k, v, _, bias_t = _flash_inputs(cuda_device, (batch, 3, 512, 64), torch.float32,
                                       torch.float32, 70 + sum(block) + batch)
    o, l, m = fa._forward_cuda(q, k, v, bias_t, 0.125, residuals, block)
    torch.cuda.synchronize()
    o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, 0.125)
    torch.testing.assert_close(o, o_ref, atol=F32_TOL, rtol=F32_TOL)
    if residuals:
        torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-4)
    else:
        assert l is None and m is None


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_tf32_gives_the_same_bits_every_run(cuda_device, bias_dtype):
    """K4a's f32 route has no atomics: two launches, equal bits."""
    q, k, v, _, bias_t = _flash_inputs(cuda_device, (3, 4, 1024, 64), torch.float32,
                                       bias_dtype, 16)
    first = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
    second = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(fa.flash_attention_relpos(q, k, v, bias_t, 0.125), first[0])


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


# ---------------------------------------------------------------- R1-R3 ---

def _rel_rms(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).square().mean() / b.square().mean().clamp_min(1e-30)).sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t_len", [(1, 1), (3, 31), (33, 1000), (128, 4096)])
@pytest.mark.parametrize("n_sec", [1, 2, 5, 12])
@pytest.mark.parametrize("per_row", [False, True])
def test_sosfilt_kernel_matches_twin_and_f64(cuda_device, rows, t_len, n_sec, per_row):
    import numpy as np
    import scipy.signal
    from audio_algebra_torch.ops.filters import butter_sos
    g = torch.Generator(device=cuda_device).manual_seed(rows + n_sec)
    x = 0.3 * torch.randn((rows, t_len), generator=g, device=cuda_device)
    cut = torch.linspace(2000.0, 12000.0, rows if per_row else 1, device=cuda_device)
    sos = torch.cat([butter_sos(2, cut, 48000, "lowpass")] * n_sec, 1)   # (R|1, n_sec, 6)
    before = rec.launches["sosfilt"]
    got = rec.sosfilt_rows(sos, x)
    torch.cuda.synchronize()
    assert rec.launches["sosfilt"] - before == -(-n_sec // rec.MAX_SECTIONS)
    want = rec.sosfilt_rows_ref(sos, x)
    assert _rel_rms(got, want) < 1e-4
    f64 = scipy.signal.sosfilt(sos[-1].double().cpu().numpy(), x[-1].double().cpu().numpy())
    assert _rel_rms(got[-1], torch.from_numpy(np.asarray(f64))) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t_len,n_sec", [
    (4, 5000, 2),               # 40 chunks of 128, the last 8 samples
    (3, 96, 2),                 # too short to cut: one chunk, a thread a row
    (8, 20000, 8),              # 8 sections, a row's own: 157 chunks of 128
    (8, 20000, 9),              # 9 sections: two launches, 8 + 1
    (2, 200000, 2),             # 782 chunks of 256, the last 64
])
def test_sosfilt_chunked_scan_edges(cuda_device, rows, t_len, n_sec):
    """R1's chunked scan where its chunks end: against the twin and
    float64, with its launches counted."""
    import numpy as np
    import scipy.signal
    from audio_algebra_torch.ops.filters import butter_sos
    g = torch.Generator(device=cuda_device).manual_seed(t_len + n_sec)
    x = 0.3 * torch.randn((rows, t_len), generator=g, device=cuda_device)
    cut = torch.linspace(1500.0, 12000.0, rows, device=cuda_device)
    sos = butter_sos(2, cut, 48000, "lowpass").repeat(1, n_sec, 1)         # (R, n_sec, 6)
    length, chunks = rec.chunk_plan(rows, t_len)
    before = (rec.launches["sosfilt"], rec.cuda_launches["sosfilt"])
    got = rec.sosfilt_rows(sos, x)
    torch.cuda.synchronize()
    groups = -(-n_sec // rec.MAX_SECTIONS)
    assert (rec.launches["sosfilt"] - before[0], rec.cuda_launches["sosfilt"] - before[1]) \
        == (groups, groups * (3 if chunks > 1 else 1))
    assert (chunks > 1) == (t_len > rec.MIN_CHUNK)
    assert _rel_rms(got, rec.sosfilt_rows_ref(sos, x)) < 1e-4
    f64 = scipy.signal.sosfilt(sos[-1].double().cpu().numpy(), x[-1].double().cpu().numpy())
    assert _rel_rms(got[-1], torch.from_numpy(np.asarray(f64))) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t_len,kind", [
    (1, 5, "noise"),            # one chunk: a thread a row
    (4, 16384, "noise"),        # 128 chunks of 128
    (40, 2000, "noise"),        # 16 chunks a row, a warp's lanes half used
    (4, 16384, "gate"),         # the level jumps on chunk starts
    (4, 16384, "dc"),           # ties: l == env from the first chunk on
    (3, 16035, "noise"),        # no multiple of 4 or of L: padded, a last chunk of 36
    (4, 16384, "nan"),          # NaN from sample 5,000 on, as the twin
])
def test_envelope_kernel_matches_twin(cuda_device, rows, t_len, kind):
    """R2 on both routes against the twin, one launch a call, its rounds
    and repair flag read: every row ends its rounds with no repair."""
    import math
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = 0.3 * torch.randn((rows, t_len), generator=g, device=cuda_device)
    x[:, t_len // 3: t_len // 2] *= 6.0
    t = torch.arange(t_len, device=cuda_device, dtype=torch.float32)
    if kind == "gate":
        tone = 0.8 * torch.sin(2 * math.pi * 220.0 * t / 48000) * torch.exp(-(t % 2048) / 600)
        x = torch.where(t % 2048 < 1024, tone, 0.0).repeat(rows, 1)
    elif kind == "dc":
        x = torch.full_like(x, 0.5)
    elif kind == "nan":
        x[:, 5000] = float("nan")
    before = (rec.launches["envelope"], rec.cuda_launches["envelope"])
    got = rec.envelope(x, 0.97938, 0.99979)
    stats = rec.envelope_stats()
    torch.cuda.synchronize()
    assert (rec.launches["envelope"] - before[0], rec.cuda_launches["envelope"] - before[1]) \
        == (1, 1)
    length, chunks = rec.envelope_plan(rows, t_len + (-t_len % 4))
    assert (stats["chunk_len"], stats["chunks"]) == (length, chunks)
    assert stats["resident"] == (chunks > 1)
    assert (chunks > 1) == (t_len > rec.MIN_CHUNK)
    assert stats["repaired"] == [False] * rows
    assert max(stats["rounds"]) <= (2 if kind == "dc" else rec.ENV_MAX_ROUNDS)
    want = rec.envelope_ref(x, 0.97938, 0.99979)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if kind == "nan":
        assert torch.isnan(got[:, 5000:]).all() and torch.isfinite(got[:, :5000]).all()
        got, want = got[:, :5000], want[:, :5000]
    assert _rel_rms(got, want) < 1e-5


@pytest.mark.cuda
def test_envelope_streamed_route_matches_f64(cuda_device):
    """A 30 s row at 48 kHz: 704 chunks of 2,048, too long for the cluster's
    shared memory, so every run streams its chunks from L2; against a
    float64 walk with the kernel's f32 coefficients (the twin would take
    minutes), within 1e-5 of the peak elementwise."""
    import numpy as np
    a_att, a_rel = 0.97938, 0.99979
    g = torch.Generator(device=cuda_device).manual_seed(30)
    x = 0.3 * torch.randn((1, 1_440_000), generator=g, device=cuda_device)
    x[:, 500_000:700_000] *= 6.0
    got = rec.envelope(x, a_att, a_rel)
    stats = rec.envelope_stats()
    assert (stats["chunk_len"], stats["chunks"], stats["resident"]) == (2048, 704, False)
    assert stats["repaired"] == [False]
    att, rel = float(np.float32(a_att)), float(np.float32(a_rel))
    env, want = 0.0, []
    for level in np.abs(x[0].double().cpu().numpy()).tolist():
        c = att if level > env else rel
        env = c * env + (1 - c) * level
        want.append(env)
    want = torch.tensor(want, dtype=torch.float64)
    assert float((got[0].double().cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [48000, 44100])
def test_freeverb_kernel_matches_twin(cuda_device, sr):
    fb = torch.tensor([0.703, 0.85, 0.977], device=cuda_device).repeat(2)
    dm = torch.full_like(fb, 0.2)
    spreads = [0, 0, 0, 23, 23, 23]
    before = rec.launches["freeverb_ir"]
    got = rec.freeverb_irs(fb, dm, spreads, 3000, sr)
    torch.cuda.synchronize()
    assert rec.launches["freeverb_ir"] == before + 1
    assert _rel_rms(got, rec.freeverb_irs_ref(fb, dm, spreads, 3000, sr)) < 1e-6
    for n_short in (1, 243, 245, 1000):       # inside, at and past the first chunk's end
        assert torch.equal(rec.freeverb_irs(fb, dm, spreads, n_short, sr), got[:, :n_short])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Reverb", "Compressor", "Phaser", "LowpassFilter",
                                  "HighpassFilter", "PitchShift"])
def test_effect_sweeps_on_the_card_match_the_cpu(cuda_device, name):
    import numpy as np
    from audio_algebra_torch.ops import effects as fx
    x = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal((2, 2, 8192)))
                         .astype(np.float32))
    knobs = fx.knob_sweep(name, 3)
    sweep = knobs if name in fx.STATIC_KNOB else torch.tensor(knobs, dtype=torch.float32)
    got = fx.apply_effect(name, x.to(cuda_device), sweep).cpu()
    want = fx.apply_effect(name, x, sweep)
    assert got.shape == (3, 2, 2, 8192)
    assert _rel_rms(got, want) < (1e-3 if name == "PitchShift" else 1e-4)

