"""Grouped GroupNorm [+ FiLM] [+ SiLU] — kernel K5.

`grouped_gn_film_silu` is the port of audio_algebra_tpu's
`ops/pallas/groupnorm_grouped.py:grouped_gn_film_silu` on the port's
(B, C, T) layout:

    silu(GroupNorm(x; groups, scale, bias) * (1 + film_scale) + film_shift)

with f32 statistics per (batch, group), eps 1e-6 as in flax. The port
always takes this fused route (the JAX package gates it behind
AA_LDM_GN=1). On a CUDA tensor it launches the hand-written CUDA kernel of
`csrc/grouped_gn.cu` (built for sm_90a at first use) or raises; on a CPU
tensor it takes the plain PyTorch twin `grouped_gn_film_silu_ref`, which
computes the same function. `launches` counts the kernel's launches.

It is differentiable: with grad enabled and an input that requires grad,
the CUDA launch runs inside a `torch.autograd.Function` whose backward
recomputes the twin from the saved inputs and takes its gradients, the
path through the statistics and the FiLM planes included. (In JAX the
Pallas apply has no VJP and training runs flax's GroupNorm, which XLA
differentiates; no TPU backward kernel exists to port.)
"""
from __future__ import annotations

import ctypes

import torch

from .groupnorm import _DTYPES, _MAX_ROW, _launch_shape, wants_grad

SOURCE = "grouped_gn.cu"

launches = 0


def grouped_gn_film_silu_ref(x, scale, bias, groups: int, film_scale=None,
                             film_shift=None, silu: bool = True,
                             eps: float = 1e-6, out_dtype=None):
    """Plain PyTorch twin on (B, C, T): per-(B, G) f32 statistics, the
    variance clamped at 0, folded into per-(B, C) planes S and T as in
    groupnorm_grouped.py:161-181, output in x's dtype (or `out_dtype`)."""
    b, c, t_len = x.shape
    x32 = x.float()
    xg = x32.reshape(b, groups, -1)
    mu = xg.mean(dim=2)                                     # (B, G)
    var = torch.clamp(xg.square().mean(dim=2) - mu.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    cg = c // groups
    mu_c = mu.repeat_interleave(cg, dim=1)                  # (B, C)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    s_planes = rstd_c * scale.float()[None]
    t_planes = bias.float()[None] - mu_c * s_planes
    if film_scale is not None:
        fs = film_scale.float().reshape(b, c)
        s_planes = s_planes * (1.0 + fs)
        t_planes = t_planes * (1.0 + fs)
    if film_shift is not None:
        t_planes = t_planes + film_shift.float().reshape(b, c)
    y = x32 * s_planes[:, :, None] + t_planes[:, :, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype or x.dtype)


def _check(x, scale, bias, groups, film_scale, film_shift):
    if x.dim() != 3:
        raise ValueError(f"grouped_gn_film_silu wants (B, C, T), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"grouped_gn_film_silu supports float32/bfloat16, got {x.dtype}")
    b, c, _ = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({c},) {x.dtype} on {x.device}, "
                             f"got {tuple(p.shape)} {p.dtype} on {p.device}")
    for name, p in (("film_scale", film_scale), ("film_shift", film_shift)):
        if p is not None and (p.shape != (b, c) or p.dtype != x.dtype
                              or p.device != x.device or p.stride(1) != 1):
            raise ValueError(f"{name} must be ({b}, {c}) {x.dtype} on {x.device} "
                             f"with unit channel stride")
    if film_scale is not None and film_shift is not None \
            and film_scale.stride(0) != film_shift.stride(0):
        raise ValueError("film_scale and film_shift must share a row stride")
    if not x.is_contiguous():
        raise ValueError("grouped_gn_film_silu wants a contiguous x")


def _lib():
    from ._build import load
    fn = load(SOURCE).aa_grouped_gn_film_silu
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, ci, vp, vp, ci, ci, ci, ci, ci, ci,
                       ci, ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def grouped_gn_film_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int, film_scale: torch.Tensor | None = None,
                         film_shift: torch.Tensor | None = None, silu: bool = True,
                         eps: float = 1e-6) -> torch.Tensor:
    """[silu](GroupNorm(x) * (1 + film_scale) + film_shift) on (B, C, T).

    scale and bias are (C,) in x's dtype; the FiLM planes are (B, C) in
    x's dtype (rows may be strided, as chunks of one (B, 2C) tensor are)
    or None. CPU tensors take the plain twin; CUDA tensors launch the
    CUDA kernel."""
    _check(x, scale, bias, groups, film_scale, film_shift)
    if x.device.type == "cpu":
        return grouped_gn_film_silu_ref(x, scale, bias, groups, film_scale,
                                        film_shift, silu, eps)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gn_film_silu: unsupported device {x.device}")
    if wants_grad(x, scale, bias, film_scale, film_shift):
        return _GroupedGN.apply(x, scale, bias, film_scale, film_shift, groups, silu, eps)
    return _launch(x, scale, bias, groups, film_scale, film_shift, silu, eps)


class _GroupedGN(torch.autograd.Function):
    """K5's launch with the twin's gradients as its backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, groups, silu, eps):
        ctx.save_for_backward(x, scale, bias, film_scale, film_shift)
        ctx.groups, ctx.silu, ctx.eps = groups, silu, eps
        return _launch(x, scale, bias, groups, film_scale, film_shift, silu, eps)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_() for t in saved]
            x, scale, bias, fs, sh = leaves
            y = grouped_gn_film_silu_ref(x, scale, bias, ctx.groups, fs, sh, ctx.silu,
                                         ctx.eps, out_dtype=torch.float32)
            given = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(y, given, dout.float()))
        out = [None if t is None else next(grads).to(t.dtype) for t in leaves]
        return (*out, None, None, None)


def _launch(x, scale, bias, groups: int, film_scale, film_shift, silu: bool,
            eps: float) -> torch.Tensor:
    global launches
    b, c, t_len = x.shape
    n = (c // groups) * t_len
    if n > _MAX_ROW or x.numel() >= 1 << 31:
        raise ValueError(f"grouped_gn_film_silu: {tuple(x.shape)} exceeds 32-bit indexing")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    vec = 16 // x.element_size()
    vec_ok = int(n % vec == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    rows = b * groups
    n_split, apply_blocks = _launch_shape(rows, n, vec)
    partials = torch.empty((rows, n_split, 2), dtype=torch.float32, device=x.device)
    film_stride = next((p.stride(0) for p in (film_scale, film_shift) if p is not None), 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(_DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 film_scale.data_ptr() if film_scale is not None else None,
                 film_shift.data_ptr() if film_shift is not None else None,
                 film_stride, y.data_ptr(), partials.data_ptr(), b, c, t_len, groups,
                 n_split, apply_blocks, int(silu), float(eps), vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"grouped_gn_film_silu kernel launch failed: CUDA error {err}")
    launches += 1
    return y

