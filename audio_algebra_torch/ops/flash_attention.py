"""Blocked (flash) self-attention with an additive rel-pos bias — kernels
K3 (serving, forward only) and K4 (training, differentiable).

`flash_attention_relpos(q, k, v, biasT, sm_scale)` is the port of
audio_algebra_tpu's `ops/pallas/flash_attention.py:flash_attention_relpos`
(forward only): q, k, v are (B, H, T, D), biasT the TRANSPOSED bias
(H, S, T) (`models.unet_cfg1d.toeplitz_rel_pos_bias(..., transposed=True)`),
and it returns softmax(q·kᵀ·sm_scale + bias)·v in q's dtype, with f32
scores and softmax statistics and P cast to v's dtype before P·V.

`flash_attention_relpos_train` is the port of `flash_attention_relpos_train`
there, a `torch.autograd.Function` of three kernels: the forward with its
residuals (K4a, writing the final row max m and normaliser l, f32
(H, B, T)), dK/dV (K4b) and dQ with d(biasT) summed over the batch (K4c).
The forward is K3's kernel with the residuals: in f32 the 3xTF32
tensor-core kernel, a block serving one or two batch rows; in bf16 the
serving kernel, a block serving up to four. K4b in bf16 serves a group of
batch rows of a key tile too. Either way each bias tile is read once for
the rows a block serves. delta = Σ_d do·o is a plain reduction, as in JAX.

On a CUDA tensor each launches the hand-written CUDA kernels of
`csrc/flash_attention*.cu` (built for sm_90a at first use) or raises; on a
CPU tensor it takes the plain twins `flash_attention_relpos_fwd_ref` and
`flash_attention_relpos_bwd_ref`, which repeat the kernels' arithmetic. K3
has no backward: on the card it refuses inputs that require grad. `launches`
(K3), `train_fwd_launches` (K4a), `dkv_launches` (K4b) and `dq_launches`
(K4c) count the kernels' launches.
"""
from __future__ import annotations

import ctypes

import torch

from .groupnorm import _DTYPES, refuse_grad, stream_handle

SOURCE = "flash_attention.cu"
SOURCE_DKV = "flash_attention_dkv.cu"
SOURCE_DQ = "flash_attention_dq.cu"
HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                     # the kernels' query and key tile
_CPU_DTYPES = (*_DTYPES, torch.float64)        # the twins also run in f64 (gradcheck)

launches = 0
train_fwd_launches = 0
dkv_launches = 0
dq_launches = 0


def flash_ok(t: int, block: int = 512, min_t: int = 1024) -> bool:
    """True when the blocked serving path applies (the JAX gate): a long
    enough sequence that divides into blocks."""
    return t >= min_t and t % block == 0


def flash_train_ok(t: int, block: int = 512, min_t: int = 512) -> bool:
    """The training gate (JAX's): the plain path's stored score tensors
    only hurt at long T."""
    return t >= min_t and t % min(block, t) == 0


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (the twins under gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_attention_relpos_fwd_ref(q, k, v, biasT, sm_scale: float = 1.0):
    """Plain twin of K3 / K4a with the kernel's arithmetic: f32 scores plus
    the bias, P = exp(s - rowmax) and its f32 row sum l, P cast to v's
    dtype, P·V accumulated in f32, divided by l, output in q's dtype.
    biasT is (H, S, T). Returns (o, l, m), l and m f32 (H, B, T)."""
    ct = _compute_dtype(q)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * sm_scale
    s = s + biasT.to(ct).transpose(-1, -2)[None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(ct), v.to(ct))
    return ((acc / l).to(q.dtype), l[..., 0].transpose(0, 1).contiguous(),
            m[..., 0].transpose(0, 1).contiguous())


def flash_attention_relpos_ref(q, k, v, biasT, sm_scale: float = 1.0):
    """Plain twin of K3: the output of `flash_attention_relpos_fwd_ref`."""
    return flash_attention_relpos_fwd_ref(q, k, v, biasT, sm_scale)[0]


def flash_attention_relpos_bwd_ref(q, k, v, biasT, o, l, m, do, sm_scale: float = 1.0):
    """Plain twin of K4b and K4c, step by step as the kernels: the
    probabilities recomputed from the FINAL (l, m) and normalised before any
    cast; p cast to do's dtype for dv, ds to q's and k's for dk and dq; f32
    accumulation; d(biasT) summed over the batch in f32, in biasT's layout
    and dtype. Returns (dq, dk, dv, dbT)."""
    ct = _compute_dtype(q)
    qf, kf, vf, dof = (x.to(ct) for x in (q, k, v, do))
    delta = (dof * o.to(ct)).sum(dim=-1, keepdim=True)               # (B, H, T, 1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    s = s + biasT.to(ct).transpose(-1, -2)[None]
    p = torch.exp(s - m.transpose(0, 1)[..., None]) / l.transpose(0, 1)[..., None]
    dv = torch.matmul(p.to(do.dtype).to(ct).transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)       # (B, H, T, S)
    dk = sm_scale * torch.matmul(ds.to(q.dtype).to(ct).transpose(-1, -2), qf)
    dq = sm_scale * torch.matmul(ds.to(k.dtype).to(ct), kf)
    dbT = ds.sum(dim=0).transpose(-1, -2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbT.to(biasT.dtype).contiguous()


def _check(q, k, v, biasT):
    if q.dim() != 4:
        raise ValueError(f"flash_attention_relpos wants (B, H, T, D), got {tuple(q.shape)}")
    ok = _CPU_DTYPES if q.device.type == "cpu" else _DTYPES
    if q.dtype not in ok or biasT.dtype not in ok:
        raise TypeError("flash_attention_relpos supports float32/bfloat16, got "
                        f"{q.dtype} and a {biasT.dtype} bias")
    b, h, t, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if biasT.shape != (h, t, t) or biasT.device != q.device:
        raise ValueError(f"biasT must be ({h}, {t}, {t}) on {q.device}, "
                         f"got {tuple(biasT.shape)} on {biasT.device}")
    if not all(x.is_contiguous() for x in (q, k, v, biasT)):
        raise ValueError("flash_attention_relpos wants contiguous tensors")


def _check_cuda(q, biasT, *tensors):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_relpos: unsupported device {q.device}")
    b, h, t, d = q.shape
    if b < 1 or t % TILE or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_relpos: T={t} must be a multiple of {TILE} "
                         f"and D={d} one of {HEAD_DIMS}")
    if q.numel() >= 1 << 31 or biasT.numel() >= 1 << 40 or b * h > 65535:
        raise ValueError(f"flash_attention_relpos: {tuple(q.shape)} is too large")
    if any(x.data_ptr() % 16 for x in (q, biasT, *tensors)):
        raise ValueError("flash_attention_relpos wants 16-byte aligned tensors")


_ARGTYPES = {
    "aa_flash_attention_relpos": "iipppppppiiiifp",
    "aa_flash_attention_dkv": "iippppppppppiiiifp",
    "aa_flash_attention_dq": "iippppppppppiiiifp",
    "aa_flash_fwd_tf32": "ipppppppiiiifiiip",
    "aa_flash_serve_bf16": "ipppppppiiiifip",
}


def _lib(source: str, name: str):
    from ._build import load
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        kinds = {"i": ctypes.c_int, "p": ctypes.c_void_p, "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn


def _forward_cuda(q, k, v, biasT, sm_scale: float, residuals: bool,
                  block: tuple[int, int, int] | None = None):
    """Launch the forward kernel; returns (o, l, m), l and m None without
    `residuals`. bf16 takes the serving kernel. `block` = (batch rows 1 or
    2, query rows 64 or 128 (D <= 64), keys a tile 64 or 32) chooses the
    f32 route's block; None leaves it to the kernel."""
    b, h, t, d = q.shape
    l = m = None
    if residuals:
        l = torch.empty((h, b, t), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
    if block is not None and q.dtype != torch.float32:
        raise ValueError("flash_attention_relpos: `block` chooses the f32 route's block")
    if q.dtype == torch.bfloat16:
        return _serve_cuda(q, k, v, biasT, sm_scale, 0, l, m), l, m
    o = torch.empty_like(q)
    _check_cuda(q, biasT, k, v, o)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), biasT.data_ptr(), o.data_ptr(),
            l.data_ptr() if residuals else None, m.data_ptr() if residuals else None)
    stream = stream_handle(q.get_device())
    if block is not None:
        err = _lib(SOURCE, "aa_flash_fwd_tf32")(
            _DTYPES[biasT.dtype], *ptrs, b, h, t, d, float(sm_scale), *block, stream)
    else:
        err = _lib(SOURCE, "aa_flash_attention_relpos")(
            _DTYPES[q.dtype], _DTYPES[biasT.dtype], *ptrs, b, h, t, d, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_relpos kernel launch failed: CUDA error {err}")
    return o, l, m


def _serve_cuda(q, k, v, biasT, sm_scale: float, bq: int = 0, l=None, m=None):
    """Launch the bf16 serving kernel (each bias tile read once for a group
    of batch rows): K3, or K4a when `l` and `m` (f32 (H, B, T)) are given
    for the residuals. `bq` the query tile: 0 lets the kernel choose by
    shape, 64, or 128 at D <= 64."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    _check_cuda(q, biasT, k, v, o, *(x for x in (l, m) if x is not None))
    err = _lib(SOURCE, "aa_flash_serve_bf16")(
        _DTYPES[biasT.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), biasT.data_ptr(),
        o.data_ptr(), None if l is None else l.data_ptr(), None if m is None else m.data_ptr(),
        b, h, t, d, float(sm_scale), bq, stream_handle(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention_relpos kernel launch failed: CUDA error {err}")
    return o


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           biasT: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q·kᵀ·sm_scale + bias)·v for (B, H, T, D) q, k, v and the
    transposed (H, S, T) bias, in q's dtype: kernel K3, forward only. CPU
    tensors take the plain twin; CUDA tensors launch the CUDA kernel (T a
    multiple of 64, D one of 16, 32, 64, 128; bf16 q, k, v take the serving
    kernel, f32 ones K4a's 3xTF32 forward without its residuals) and must not
    require grad (`flash_attention_relpos_train` is the differentiable one)."""
    global launches
    _check(q, k, v, biasT)
    if q.device.type == "cpu":
        return flash_attention_relpos_ref(q, k, v, biasT, sm_scale)
    refuse_grad("flash_attention_relpos (K3, forward only; use "
                "flash_attention_relpos_train)", q, k, v, biasT)
    if q.dtype == torch.bfloat16:
        o = _serve_cuda(q, k, v, biasT, sm_scale)
    else:
        o, _, _ = _forward_cuda(q, k, v, biasT, sm_scale, residuals=False)
    launches += 1
    return o


def flash_attention_relpos_fwd(q, k, v, biasT, sm_scale: float = 1.0):
    """K4a outside autograd: (o, l, m) with the softmax residuals l and m,
    f32 (H, B, T). CPU tensors take the plain twin."""
    global train_fwd_launches
    _check(q, k, v, biasT)
    if q.device.type == "cpu":
        return flash_attention_relpos_fwd_ref(q, k, v, biasT, sm_scale)
    out = _forward_cuda(q, k, v, biasT, sm_scale, residuals=True)
    train_fwd_launches += 1
    return out


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum_d do * o in f32, (H, B, T) like l and m: a plain
    reduction, as in JAX."""
    return (do.float() * o.float()).sum(dim=-1).transpose(0, 1).contiguous()


def _backward_cuda(which: str, q, k, v, biasT, do, l, m, delta, sm_scale: float, outs):
    """Launch K4b ("dkv") or K4c ("dq") into the tensors `outs`."""
    b, h, t, d = q.shape
    for name, x in (("l", l), ("m", m), ("delta", delta)):
        if x.shape != (h, b, t) or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 ({h}, {b}, {t}) on {q.device}")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError("do must be contiguous and match q in shape, dtype and device")
    _check_cuda(q, biasT, k, v, do, l, m, delta, *outs)
    source = SOURCE_DKV if which == "dkv" else SOURCE_DQ
    err = _lib(source, f"aa_flash_attention_{which}")(
        _DTYPES[q.dtype], _DTYPES[biasT.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        biasT.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(), delta.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), b, h, t, d, float(sm_scale),
        stream_handle(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash attention {which} kernel launch failed: CUDA error {err}")


def flash_attention_relpos_dkv(q, k, v, biasT, do, l, m, delta, sm_scale: float = 1.0):
    """K4b on CUDA tensors: (dk, dv) from the forward's residuals (l, m) and
    delta (`flash_delta`)."""
    global dkv_launches
    _check(q, k, v, biasT)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _backward_cuda("dkv", q, k, v, biasT, do, l, m, delta, sm_scale, (dk, dv))
    dkv_launches += 1
    return dk, dv


def flash_attention_relpos_dq(q, k, v, biasT, do, l, m, delta, sm_scale: float = 1.0):
    """K4c on CUDA tensors: (dq, dbT). dbT is summed over the batch in f32
    in a fixed order (the same bits every run) and cast to biasT's dtype."""
    global dq_launches
    _check(q, k, v, biasT)
    h, t = q.shape[1], q.shape[2]
    dq = torch.empty_like(q)
    db = torch.empty((h, t, t), dtype=torch.float32, device=q.device)
    _backward_cuda("dq", q, k, v, biasT, do, l, m, delta, sm_scale, (dq, db))
    dq_launches += 1
    return dq, db.to(biasT.dtype)


def flash_attention_relpos_bwd(q, k, v, biasT, o, l, m, do, sm_scale: float = 1.0):
    """K4b and K4c outside autograd: (dq, dk, dv, dbT) from the forward's
    (o, l, m) and the output's cotangent. CPU tensors take the plain twin;
    CUDA tensors launch the two CUDA kernels."""
    _check(q, k, v, biasT)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("do must match q in shape, dtype and device")
    do = do.contiguous()
    if q.device.type == "cpu":
        return flash_attention_relpos_bwd_ref(q, k, v, biasT, o, l, m, do, sm_scale)
    delta = flash_delta(o, do)
    dk, dv = flash_attention_relpos_dkv(q, k, v, biasT, do, l, m, delta, sm_scale)
    dq, dbT = flash_attention_relpos_dq(q, k, v, biasT, do, l, m, delta, sm_scale)
    return dq, dk, dv, dbT


class _FlashTrain(torch.autograd.Function):
    """The differentiable attention: through the wrappers (kernels on the
    card, twins on the CPU), or with `twin` through the twins wherever the
    tensors lie."""

    @staticmethod
    def forward(ctx, q, k, v, biasT, sm_scale, twin):
        fwd = flash_attention_relpos_fwd_ref if twin else flash_attention_relpos_fwd
        o, l, m = fwd(q, k, v, biasT, sm_scale)
        ctx.save_for_backward(q, k, v, biasT, o, l, m)
        ctx.sm_scale, ctx.twin = sm_scale, twin
        return o

    @staticmethod
    def backward(ctx, do):
        bwd = flash_attention_relpos_bwd_ref if ctx.twin else flash_attention_relpos_bwd
        return (*bwd(*ctx.saved_tensors, do, ctx.sm_scale), None, None)


def flash_attention_relpos_train_ref(q, k, v, biasT, sm_scale: float = 1.0) -> torch.Tensor:
    """The plain twin of `flash_attention_relpos_train`, differentiable, on
    any device: what the card's kernels are held against."""
    return _FlashTrain.apply(q, k, v, biasT, float(sm_scale), True)


def flash_attention_relpos_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 biasT: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """Differentiable blocked attention (kernels K4a, K4b, K4c): the value
    of `flash_attention_relpos`, with gradients to q, k, v and biasT. Build
    biasT with toeplitz_rel_pos_bias(..., transposed=True) inside the graph,
    so that d(biasT) reaches the bucket table through that construction."""
    return _FlashTrain.apply(q, k, v, biasT, float(sm_scale), False)
