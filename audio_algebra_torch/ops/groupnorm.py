"""Fused GroupNorm(1) [+ tanh-GELU] [+ residual] — kernels K1 and K2.

The port of audio_algebra_tpu's Pallas `ops/pallas/groupnorm.py:
groupnorm1_gelu_btc`, on the port's (B, C, T) layout:

  groupnorm1_gelu        (K1)  y = [res +] [gelu](gn(x) * scale + bias)
  groupnorm1_gelu_quant  (K2a) int8 of y on a per-channel grid (turbo GN_0)
  groupnorm1_gelu_res_amax (K2b, K2c) res + y and its per-channel amax,
                         plus an int8 twin on a given grid (turbo GN_1)

On a CUDA tensor each launches the hand-written CUDA kernel of
`csrc/groupnorm.cu` (built for sm_90a at first use; K2a as one cooperative
launch over row groups that fit in L2, planned by `quant_plan`) or raises;
on a CPU tensor it takes its plain PyTorch twin (`*_ref`), which computes
the same function. There is no fallback from the card to a twin.

K1 is differentiable, as JAX's `groupnorm1_gelu_btc` is: with grad enabled
and an input that requires grad, the CUDA launch runs inside a
`torch.autograd.Function` whose backward recomputes the f32 twin from the
saved (x, scale, bias) and takes its gradients (JAX's `_gn_bwd_core`, which
is plain jnp under a `custom_vjp`, no TPU kernel); the residual's cotangent
is the output's. The turbo modes (K2) are inference-only, as in JAX: on the
card they refuse inputs that require grad.

`launches` (K1), `quant_launches` (K2a), `amax_launches` (K2b) and
`amax_q_launches` (K2c) count the kernels' launches, so a run can show
that its main path went through them.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "groupnorm.cu"
GELU_C = 0.7978845608028654
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW = 1 << 30              # the kernel indexes a row with 32-bit ints
_MAX_AMAX_C = 12288             # the amax table lives in 48 KB of shared memory
_THREADS = 256
_QUANT, _RES_AMAX, _RES_AMAX_Q = 0, 1, 2
L2_GROUP_BYTES = 32 << 20       # x of one K2a row group: what L2 (50 MB) keeps
MAX_GROUP_ROWS = 64             # the kernel's (mu, rstd) table of a group
MAX_QUANT_BLOCKS = 1056         # K2a's grid at most: 132 SMs x 8 blocks of 256 threads

launches = 0
quant_launches = 0
amax_launches = 0
amax_q_launches = 0


def wants_grad(*tensors) -> bool:
    """True when grad is enabled and one of the tensors (None allowed)
    requires grad: a kernel's raw-pointer launch must then run inside an
    autograd.Function, or be refused."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise when `wants_grad`: `what` is an inference-only kernel, and
    writing its result through a raw pointer would return a tensor cut off
    from the graph."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{what} has no backward: call it under torch.no_grad() or "
                           "on tensors that do not require grad")


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, written out as the JAX kernels do."""
    return 0.5 * y * (1.0 + torch.tanh(GELU_C * (y + 0.044715 * y * y * y)))


def _gn_f32(x, scale, bias, gelu: bool, eps: float) -> torch.Tensor:
    """[gelu](GroupNorm1(x) * scale + bias) in f32: f32 statistics over
    (C, T) per batch row, variance clamped at 0."""
    x32 = x.float()
    mu = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(x32.square().mean(dim=(1, 2), keepdim=True)
                      - mu.square(), min=0.0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()[None, :, None] + bias.float()[None, :, None]
    return gelu_tanh(y) if gelu else y


def groupnorm1_gelu_ref(x, scale, bias, gelu: bool, residual=None,
                        eps: float = 1e-6):
    """Plain PyTorch GN(1)[+GELU][+residual] on (B, C, T), output in x's
    dtype."""
    y = _gn_f32(x, scale, bias, gelu, eps)
    if residual is not None:
        y = residual.float() + y
    return y.to(x.dtype)


def quant_inverse(q_scale: torch.Tensor) -> torch.Tensor:
    """The kernels' per-channel multiplier 1 / max(q_scale, 1e-12), in f32
    (the JAX wrapper's `qinv`)."""
    return (1.0 / torch.clamp(q_scale.float(), min=1e-12)).contiguous()


def quantize_rows(v32: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """int8 clip(round_half_even(v * qinv_c), +-127) of an f32 (B, C, T)."""
    return torch.clamp(torch.round(v32 * qinv[None, :, None]), -127, 127).to(torch.int8)


def groupnorm1_gelu_quant_ref(x, scale, bias, quant_scale, gelu: bool = True,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain twin of K2a: int8 of [gelu](gn(x) * scale + bias) on the
    per-channel grid `quant_scale` (C,), multiplied by its inverse."""
    return quantize_rows(_gn_f32(x, scale, bias, gelu, eps), quant_inverse(quant_scale))


def groupnorm1_gelu_res_amax_ref(x, scale, bias, residual, gelu: bool = True,
                                 q_emit_scale=None, eps: float = 1e-6):
    """Plain twin of K2b / K2c: out = residual + [gelu](gn(x) * scale +
    bias) in x's dtype and amax_c = max over (B, T) of |out|, both from the
    f32 sum; with `q_emit_scale` (C,), also the int8 twin of the f32 sum on
    that grid. Returns (out, amax) or (out, amax, out8)."""
    out32 = residual.float() + _gn_f32(x, scale, bias, gelu, eps)
    if out32.numel():
        amax = out32.abs().amax(dim=(0, 2))
    else:
        amax = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    out = out32.to(x.dtype)
    if q_emit_scale is None:
        return out, amax
    return out, amax, quantize_rows(out32, quant_inverse(q_emit_scale))


def _check(x, scale, bias, residual):
    if x.dim() != 3:
        raise ValueError(f"groupnorm1_gelu wants (B, C, T), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"groupnorm1_gelu supports float32/bfloat16, got {x.dtype}")
    c = x.shape[1]
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device:
            raise ValueError(f"{name} must be ({c},) {x.dtype} on {x.device}, "
                             f"got {tuple(p.shape)} {p.dtype} on {p.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError("residual must match x in shape, dtype and device")
    tensors = [x, scale, bias] + ([residual] if residual is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("groupnorm1_gelu wants contiguous tensors")


def _lib(name: str = "aa_groupnorm1_gelu"):
    from ._build import load
    fn = getattr(load(SOURCE), name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "aa_groupnorm1_gelu":
            fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                           cf, ci, vp]
        elif name == "aa_groupnorm1_quant":
            fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, ci, vp]
        else:
            fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                           ci, ci, ci, cf, ci, vp]
        fn.restype = ci
    return fn


def _launch_shape(b: int, n: int, vec: int) -> tuple[int, int]:
    """(n_split, apply_blocks): statistics blocks per row and apply blocks
    per row, so that each pass puts a few waves of blocks on the card."""
    n_split = max(1, min(-(-n // (_THREADS * vec * 4)), 1024 // b))
    apply_blocks = max(1, min(-(-n // (_THREADS * vec)), 2048 // b))
    return n_split, apply_blocks


def quant_plan(b: int, n: int, esize: int, vec: int) -> tuple[int, int]:
    """(max_split, group_rows) of K2a's one launch: the rows are taken in
    groups whose x (n elements of esize bytes a row) fits in
    L2_GROUP_BYTES, at least one row and at most MAX_GROUP_ROWS; the kernel
    cuts each row into n_split slices, one to a block of its grid (which
    the card sets), at most max_split: one vector a thread at least, and
    MAX_QUANT_BLOCKS a group."""
    group_rows = max(1, min(b, MAX_GROUP_ROWS, L2_GROUP_BYTES // max(1, n * esize)))
    max_split = max(1, min(-(-n // (_THREADS * vec)), MAX_QUANT_BLOCKS // group_rows))
    return max_split, group_rows


def gn1_backward(x, scale, bias, dout, gelu: bool, eps: float = 1e-6):
    """(dx, dscale, dbias) of [gelu](GroupNorm1(x) * scale + bias): the f32
    twin recomputed from (x, scale, bias) and differentiated, the gradients
    cast back to each input's dtype (JAX's `_gn_bwd_core`)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        y = _gn_f32(*leaves, gelu, eps)
        grads = torch.autograd.grad(y, leaves, dout.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, (x, scale, bias)))


class _GroupNorm1Gelu(torch.autograd.Function):
    """K1's launch with the plain backward of JAX's custom_vjp."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, gelu, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.gelu, ctx.eps, ctx.has_residual = gelu, eps, residual is not None
        return _launch_k1(x, scale, bias, gelu, residual, eps)

    @staticmethod
    def backward(ctx, dout):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = gn1_backward(x, scale, bias, dout, ctx.gelu, ctx.eps)
        return dx, dscale, dbias, (dout if ctx.has_residual else None), None, None


def groupnorm1_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    gelu: bool, residual: torch.Tensor | None = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """y = [residual +] [gelu](GroupNorm1(x) * scale + bias) on (B, C, T).

    scale and bias are (C,) in x's dtype. CPU tensors take the plain twin;
    CUDA tensors launch the CUDA kernel, inside an autograd.Function when
    an input requires grad."""
    _check(x, scale, bias, residual)
    if x.device.type == "cpu":
        return groupnorm1_gelu_ref(x, scale, bias, gelu, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm1_gelu: unsupported device {x.device}")
    if wants_grad(x, scale, bias, residual):
        return _GroupNorm1Gelu.apply(x, scale, bias, residual, gelu, eps)
    return _launch_k1(x, scale, bias, gelu, residual, eps)


def _launch_k1(x, scale, bias, gelu: bool, residual, eps: float) -> torch.Tensor:
    global launches
    b, c, t_len = x.shape
    n = c * t_len
    if n > _MAX_ROW:
        raise ValueError(f"groupnorm1_gelu: row of {n} elements exceeds {_MAX_ROW}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    vec = 16 // x.element_size()
    ptrs = [x.data_ptr(), y.data_ptr()] + \
        ([residual.data_ptr()] if residual is not None else [])
    vec_ok = int(n % vec == 0 and all(p % 16 == 0 for p in ptrs))
    n_split, apply_blocks = _launch_shape(b, n, vec)
    partials = torch.empty((b, n_split, 2), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(_DTYPES[x.dtype], x.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 partials.data_ptr(), b, c, t_len, n_split, apply_blocks,
                 int(gelu), int(residual is not None), float(eps), vec_ok,
                 stream)
    if err != 0:
        raise RuntimeError(f"groupnorm1_gelu kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _check_grid(q, c, x, name):
    if q.shape != (c,) or not q.is_floating_point() or q.device != x.device:
        raise ValueError(f"{name} must be a ({c},) float tensor on {x.device}, "
                         f"got {tuple(q.shape)} {q.dtype} on {q.device}")


def _turbo_launch(mode: int, x, scale, bias, residual, q_scale, gelu: bool,
                  eps: float):
    """Launch K2 in `mode` on CUDA tensors; returns (y, amax, y8), each
    None where the mode has no such output."""
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm1 turbo: unsupported device {x.device}")
    refuse_grad("the turbo GroupNorm (K2, inference only)", x, scale, bias, residual)
    b, c, t_len = x.shape
    n = c * t_len
    if n > _MAX_ROW:
        raise ValueError(f"groupnorm1 turbo: row of {n} elements exceeds {_MAX_ROW}")
    if mode != _QUANT and c > _MAX_AMAX_C:
        raise ValueError(f"groupnorm1 turbo: {c} channels exceed the amax table's "
                         f"{_MAX_AMAX_C}")
    y = torch.empty_like(x) if mode != _QUANT else None
    y8 = torch.empty(x.shape, dtype=torch.int8, device=x.device) if mode != _RES_AMAX else None
    amax = torch.empty(c, dtype=torch.float32, device=x.device) if mode != _QUANT else None
    if x.numel() == 0:
        if amax is not None:
            amax.zero_()
        return y, amax, y8
    qinv = quant_inverse(q_scale) if q_scale is not None else None
    vec = 16 // x.element_size()
    ptrs = [t.data_ptr() for t in (x, residual, y, y8) if t is not None]
    vec_ok = int(n % vec == 0 and all(p % 16 == 0 for p in ptrs))

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(x.device).cuda_stream
    if mode == _QUANT:
        max_split, group_rows = quant_plan(b, n, x.element_size(), vec)
        partials = torch.empty((b, max_split, 2), dtype=torch.float32, device=x.device)
        done = torch.empty(-(-b // group_rows), dtype=torch.int32, device=x.device)
        err = _lib("aa_groupnorm1_quant")(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ptr(qinv),
            ptr(y8), partials.data_ptr(), done.data_ptr(), b, c, t_len, max_split, group_rows,
            int(gelu), float(eps), vec_ok, stream)
    else:
        n_split, apply_blocks = _launch_shape(b, n, vec)
        partials = torch.empty((b, n_split, 2), dtype=torch.float32, device=x.device)
        err = _lib("aa_groupnorm1_turbo")(
            _DTYPES[x.dtype], mode, x.data_ptr(), ptr(residual), scale.data_ptr(),
            bias.data_ptr(), ptr(qinv), ptr(y), ptr(y8), ptr(amax), partials.data_ptr(),
            b, c, t_len, n_split, apply_blocks, int(gelu), float(eps), vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"groupnorm1 turbo kernel launch failed: CUDA error {err}")
    return y, amax, y8


def groupnorm1_gelu_quant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          quant_scale: torch.Tensor, gelu: bool = True,
                          eps: float = 1e-6) -> torch.Tensor:
    """K2a: int8 clip(round([gelu](GroupNorm1(x) * scale + bias) /
    quant_scale_c)) on (B, C, T), the float output never written.
    quant_scale is (C,) float (the kernel multiplies by its inverse). CPU
    tensors take the plain twin; CUDA tensors launch the CUDA kernel."""
    global quant_launches
    _check(x, scale, bias, None)
    _check_grid(quant_scale, x.shape[1], x, "quant_scale")
    if x.device.type == "cpu":
        return groupnorm1_gelu_quant_ref(x, scale, bias, quant_scale, gelu, eps)
    _, _, y8 = _turbo_launch(_QUANT, x, scale, bias, None, quant_scale, gelu, eps)
    quant_launches += 1
    return y8


def groupnorm1_gelu_res_amax(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             residual: torch.Tensor, gelu: bool = True,
                             q_emit_scale: torch.Tensor | None = None,
                             eps: float = 1e-6):
    """K2b: (out, amax) with out = residual + [gelu](GroupNorm1(x) * scale +
    bias) in x's dtype and amax (C,) f32 the max over (B, T) of |out|
    before the cast. K2c, with `q_emit_scale` (C,): (out, amax, out8), out8
    the int8 twin of out (before the cast) on that grid. CPU tensors take
    the plain twin; CUDA tensors launch the CUDA kernel."""
    global amax_launches, amax_q_launches
    _check(x, scale, bias, residual)
    if residual is None:
        raise ValueError("groupnorm1_gelu_res_amax needs a residual")
    if q_emit_scale is not None:
        _check_grid(q_emit_scale, x.shape[1], x, "q_emit_scale")
    if x.device.type == "cpu":
        return groupnorm1_gelu_res_amax_ref(x, scale, bias, residual, gelu,
                                            q_emit_scale, eps)
    mode = _RES_AMAX if q_emit_scale is None else _RES_AMAX_Q
    y, amax, y8 = _turbo_launch(mode, x, scale, bias, residual, q_emit_scale, gelu, eps)
    if q_emit_scale is None:
        amax_launches += 1
        return y, amax
    amax_q_launches += 1
    return y, amax, y8
