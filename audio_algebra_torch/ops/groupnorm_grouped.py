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
computes the same function.

The kernel has two routes, chosen by shape in `ggn_plan`: the cluster
route (one launch, a (batch, group) row to a thread-block cluster whose
CTAs hold their slices of the row in shared memory, so x is read once)
for every row whose slice fits a CTA at 16 CTAs or fewer, and the
two-pass route (statistics, then apply) for longer rows. `launches`
counts every call's launch, `cluster_launches` and `two_pass_launches`
each route's. The host path is cut to one output allocation, a plan and
its C argument array cached by shape, the raw stream handle and one
ctypes call.

It is differentiable: with grad enabled and an input that requires grad,
the CUDA launch runs inside a `torch.autograd.Function` whose backward
recomputes the twin from the saved inputs and takes its gradients, the
path through the statistics and the FiLM planes included. (In JAX the
Pallas apply has no VJP and training runs flax's GroupNorm, which XLA
differentiates; no TPU backward kernel exists to port.)
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .groupnorm import _DTYPES, _MAX_ROW, _launch_shape, stream_handle, wants_grad

SOURCE = "grouped_gn.cu"
SMEM_BUDGET = 225 * 1024          # dynamic shared memory a CTA may take (grouped_gn.cu)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is Hopper's non-portable cluster size
TARGET_SLICE_BYTES = 16 << 10     # cut rows into slices of about this size (PERF.md, PR 8)

launches = 0                      # both routes
cluster_launches = 0
two_pass_launches = 0


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
    """Raise on what K5 and its twin do not take. Each tensor's device is
    read once, as an index (-1 on the CPU): a call reads few attributes."""
    shape = x.shape
    if len(shape) != 3:
        raise ValueError(f"grouped_gn_film_silu wants (B, C, T), got {tuple(shape)}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"grouped_gn_film_silu supports float32/bfloat16, got {dt}")
    b, c, _ = shape
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    dev = x.get_device()
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype is not dt or p.get_device() != dev \
                or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({c},) {dt} on {x.device}, "
                             f"got {tuple(p.shape)} {p.dtype} on {p.device}")
    if film_scale is not None or film_shift is not None:
        rows = []
        for name, p in (("film_scale", film_scale), ("film_shift", film_shift)):
            if p is None:
                continue
            if p.shape != (b, c) or p.dtype is not dt or p.get_device() != dev \
                    or p.stride(1) != 1:
                raise ValueError(f"{name} must be ({b}, {c}) {dt} on {x.device} "
                                 f"with unit channel stride")
            rows.append(p.stride(0))
        if len(rows) == 2 and rows[0] != rows[1]:
            raise ValueError("film_scale and film_shift must share a row stride")
    if not x.is_contiguous():
        raise ValueError("grouped_gn_film_silu wants a contiguous x")


class GGNPlan(NamedTuple):
    """How K5 runs one shape: `route` "cluster" (one launch, a row to a
    cluster of `cs` CTAs of `threads` threads, each holding `per` elements
    of it in `smem` bytes of dynamic shared memory) or "two_pass" (the
    statistics and apply launches, `n_split` and `apply_blocks` blocks a
    row)."""
    route: str
    cs: int = 0
    threads: int = 0
    per: int = 0
    smem: int = 0
    n_split: int = 0
    apply_blocks: int = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def cluster_plan(n: int, cg: int, t_len: int, esize: int, cs: int) -> GGNPlan | None:
    """The cluster route at cluster size cs for rows of n elements (cg
    channels of t_len), or None when a CTA's slice and its channels'
    parameters and planes would not fit SMEM_BUDGET."""
    per = _round_up(-(-n // cs), 16 // esize)
    smem = _round_up(per * esize, 16) + 24 * min(cg, per // t_len + 2)
    if smem > SMEM_BUDGET:
        return None
    threads = 128 if per * esize <= 8 << 10 else 256 if per * esize <= 32 << 10 else 512
    return GGNPlan("cluster", cs, threads, per, smem)


def ggn_plan(b: int, c: int, t_len: int, groups: int, esize: int) -> GGNPlan:
    """K5's route for x of (b, c, t_len) in elements of esize bytes. A row
    (one (batch, group), n = c / groups * t_len elements) takes the cluster
    route when some cluster size in CLUSTER_SIZES gives each CTA a slice
    that fits SMEM_BUDGET with its channels' parameters and planes; the
    size is the least that fits, raised to cut the row into slices of
    about TARGET_SLICE_BYTES. Else the two-pass route."""
    cg = c // groups
    n = cg * t_len
    want = 1
    while want < CLUSTER_SIZES[-1] and n * esize >= 2 * want * TARGET_SLICE_BYTES:
        want *= 2
    for cs in CLUSTER_SIZES:
        plan = cluster_plan(n, cg, t_len, esize, cs) if cs >= want else None
        if plan is not None:
            return plan
    n_split, apply_blocks = _launch_shape(b * groups, n, 16 // esize)
    return GGNPlan("two_pass", n_split=n_split, apply_blocks=apply_blocks)


_FN = {}                                   # C entry -> ctypes function, argtypes set
_PLANS: dict[tuple, tuple] = {}            # shape key -> (plan, C plan array, flags)


def _fn(name: str):
    """The C entry `name` (aa_ggn_cluster or aa_ggn_two_pass) with its
    argtypes: plan array, flags, eps, x, scale, bias, film scale and shift,
    y, [partials,] stream."""
    fn = _FN.get(name)
    if fn is None:
        from ._build import load
        fn = getattr(load(SOURCE), name)
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, ctypes.c_float, vp, vp, vp, vp, vp, vp] + \
            ([vp] if name == "aa_ggn_two_pass" else []) + [vp]
        fn.restype = ctypes.c_int
        _FN[name] = fn
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
    if not x.is_cuda:
        if x.device.type == "cpu":
            return grouped_gn_film_silu_ref(x, scale, bias, groups, film_scale,
                                            film_shift, silu, eps)
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


def _plan(x, groups: int, film_stride: int) -> tuple:
    """(GGNPlan, C plan array, flags) of x's shape, computed once a shape;
    flags carries the dtype and whether a row is whole 16-byte vectors."""
    key = (x.shape, x.dtype, groups, film_stride)
    got = _PLANS.get(key)
    if got is None:
        b, c, t_len = x.shape
        n = (c // groups) * t_len
        if n > _MAX_ROW or x.numel() >= 1 << 31:
            raise ValueError(f"grouped_gn_film_silu: {tuple(x.shape)} exceeds 32-bit indexing")
        esize = x.element_size()
        plan = ggn_plan(b, c, t_len, groups, esize)
        ints = ((b, c, t_len, groups, plan.cs, plan.threads, plan.per, plan.smem, film_stride)
                if plan.route == "cluster" else
                (b, c, t_len, groups, plan.n_split, plan.apply_blocks, film_stride))
        flags = _DTYPES[x.dtype] | (4 if n % (16 // esize) == 0 else 0)
        got = _PLANS[key] = (plan, (ctypes.c_int * len(ints))(*ints), flags)
    return got


def _launch(x, scale, bias, groups: int, film_scale, film_shift, silu: bool,
            eps: float, plan: GGNPlan | None = None) -> torch.Tensor:
    """One K5 call on CUDA tensors that `_check` passed; `plan`, a cluster
    route plan (`cluster_plan`), replaces the planner's choice, to time
    other cluster sizes."""
    global launches, cluster_launches, two_pass_launches
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    film = film_scale if film_scale is not None else film_shift
    film_stride = film.stride(0) if film is not None else 0
    chosen, ints, flags = _plan(x, groups, film_stride)
    if plan is not None:
        b, c, t_len = x.shape
        ints = (ctypes.c_int * 9)(b, c, t_len, groups, plan.cs, plan.threads, plan.per,
                                  plan.smem, film_stride)
    plan = plan or chosen
    xp = x.data_ptr()
    if xp % 16:
        flags &= ~4
    if silu:
        flags |= 2
    fs = film_scale.data_ptr() if film_scale is not None else None
    sh = film_shift.data_ptr() if film_shift is not None else None
    stream = stream_handle(x.get_device())
    if plan.route == "cluster":
        err = _fn("aa_ggn_cluster")(ints, flags, eps, xp, scale.data_ptr(), bias.data_ptr(),
                                    fs, sh, y.data_ptr(), stream)
    else:
        partials = torch.empty((x.shape[0] * groups, plan.n_split, 2), dtype=torch.float32,
                               device=x.device)
        err = _fn("aa_ggn_two_pass")(ints, flags, eps, xp, scale.data_ptr(), bias.data_ptr(),
                                     fs, sh, y.data_ptr(), partials.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"grouped_gn_film_silu kernel launch failed: CUDA error {err}")
    if plan.route == "cluster":
        cluster_launches += 1
    else:
        two_pass_launches += 1
    launches += 1
    return y
