"""Parametric UMAP-style neighbour embedding.

Port of audio_algebra_tpu/umap_param.py, the UMAP and AlignedUMAP views of
the effects study (umap-learn is not a dependency):

  * an exact kNN graph with UMAP's smooth-k fuzzy weights (a per-point
    sigma by a 32-step binary search to log2(k) connectivity); the squared
    distances in full f32, since TF32 would reorder near-ties;
  * a small MLP f: R^D -> R^2 trained with the UMAP cross-entropy
    (attractive edges drawn by weight, uniform negatives) under Adam;
  * alignment across knob sweeps by construction: one fitted map embeds
    every sweep.

JAX draws the edges (`jax.random.categorical` over log-weights) and the
negatives (`randint`) inside one `lax.scan`; the port cannot reproduce
those bits. `train_step` takes the draws as arguments, and `_fit` draws
them from an explicit torch.Generator: `torch.multinomial` over the
weights samples the same distribution. The initial weights can be given
(`params`, JAX's list of {"w", "b"} leaves). On the card the steps are a
Python loop of small launches, where the TPU runs one compiled scan.

Curve constants (a, b) follow UMAP's min_dist=0.1 fit; q(d) =
(1 + a d^(2b))^-1.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .device import full_f32, resolve_device

# UMAP's fitted curve for min_dist=0.1, spread=1.0
_A, _B = 1.577, 0.895


def knn_graph(x: torch.Tensor, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of row vectors + UMAP fuzzy edge weights.

    Returns (indices (N, k), weights (N, k)). Weight kernel:
    exp(-(d - rho)/sigma), rho = nearest-neighbour distance, sigma solved
    per point (binary search) so sum_j w_ij = log2(k).
    """
    n = x.shape[0]
    with full_f32():
        sq = (x * x).sum(dim=1)
        d2 = sq[:, None] + sq[None, :] - 2 * (x @ x.T)
    d2 = d2.clamp_min(0.0) + torch.eye(n, dtype=x.dtype, device=x.device) * 1e12
    d = torch.sqrt(d2)
    neg_top, idx = torch.topk(-d, k, dim=1)        # (N, k) ascending distance
    nd = -neg_top
    rho = nd[:, :1]
    target = math.log2(max(k, 2))

    def weight(sigma):
        return torch.exp(-(nd - rho).clamp_min(0.0) / sigma[:, None])

    lo = torch.full((n,), 1e-6, dtype=x.dtype, device=x.device)
    hi = torch.full((n,), 1e3, dtype=x.dtype, device=x.device)
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        too_big = weight(mid).sum(dim=1) > target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    return idx, weight(0.5 * (lo + hi))


def _init_mlp(generator: torch.Generator, dims: Sequence[int], device) -> list:
    """He-normal weights, zero biases: [{"w": (a, b), "b": (b,)}, ...]."""
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, device=device) * math.sqrt(2.0 / a)
        params.append({"w": w, "b": torch.zeros((b,), device=device)})
    return params


def _leaf(v, device) -> torch.Tensor:
    """A fresh f32 copy of a weight (a tensor, or a numpy / JAX array)."""
    v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
    return v.to(device, torch.float32).clone()


def _mlp(params: list, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, lyr in enumerate(params):
        h = h @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def _q(d2: torch.Tensor) -> torch.Tensor:
    # exp(b log x) as JAX writes it (its backend lacked a float-exponent pow)
    return 1.0 / (1.0 + _A * torch.exp(_B * torch.log(d2.clamp_min(1e-10))))


def loss_fn(params: list, x: torch.Tensor, hk: torch.Tensor, tk: torch.Tensor,
            nk: torch.Tensor, neg_per_edge: int) -> torch.Tensor:
    """UMAP's cross-entropy over the edges (hk, tk) and the negatives nk
    (neg_per_edge a head). The three point sets go through the MLP as one
    batch: a third of the launches, which bound a step on a card."""
    eh, et, en = _mlp(params, x[torch.cat([hk, tk, nk])]).split([len(hk), len(tk), len(nk)])
    attract = -torch.log(_q(((eh - et) ** 2).sum(dim=-1)).clamp_min(1e-10)).mean()
    ehr = eh.repeat_interleave(neg_per_edge, dim=0)
    qn = _q(((ehr - en) ** 2).sum(dim=-1))
    repel = -torch.log((1.0 - qn).clamp_min(1e-10)).mean()
    return attract + repel


def make_optimizer(params: list, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    as torch's Adam."""
    return torch.optim.Adam([t for lyr in params for t in lyr.values()], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def train_step(params: list, opt: torch.optim.Optimizer, x: torch.Tensor, hk, tk, nk,
               neg_per_edge: int) -> torch.Tensor:
    """One Adam step on the given draws; returns the loss before it."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, x, hk, tk, nk, neg_per_edge)
    loss.backward()
    opt.step()
    return loss.detach()


def _fit(x: torch.Tensor, generator: torch.Generator, k: int, steps: int, batch_edges: int,
         neg_per_edge: int, n_components: int, hidden: Tuple[int, ...], lr: float,
         params: Optional[list] = None):
    """(params, embedding of x, losses (steps,)) of `steps` Adam steps."""
    n, dim = x.shape
    idx, w = knn_graph(x, k=k)
    heads = torch.arange(n, device=x.device).repeat_interleave(k)
    tails = idx.reshape(-1)
    probs = w.reshape(-1).clamp_min(1e-12)         # JAX: logits log(max(w, 1e-12))
    if params is None:
        params = _init_mlp(generator, (dim,) + tuple(hidden) + (n_components,), x.device)
    params = [{name: _leaf(v, x.device).requires_grad_() for name, v in lyr.items()}
              for lyr in params]
    opt = make_optimizer(params, lr)
    losses = []
    for _ in range(steps):
        e = torch.multinomial(probs, batch_edges, replacement=True, generator=generator)
        nk = torch.randint(0, n, (batch_edges * neg_per_edge,), generator=generator,
                           device=x.device)
        losses.append(train_step(params, opt, x, heads[e], tails[e], nk, neg_per_edge))
    params = [{k_: v.detach() for k_, v in lyr.items()} for lyr in params]
    with torch.no_grad():
        emb = _mlp(params, x)
    return params, emb, torch.stack(losses) if losses else torch.zeros(0)


class ParametricUMAP:
    """fit(x) learns the map; transform(y) embeds new points with it —
    aligned across datasets by construction (one shared map)."""

    def __init__(self, n_components: int = 2, k: int = 10, steps: int = 1500,
                 batch_edges: int = 256, neg_per_edge: int = 4,
                 hidden: Tuple[int, ...] = (128, 128), lr: float = 1e-2, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.n_components = n_components
        self.k = k
        self.steps = steps
        self.batch_edges = batch_edges
        self.neg_per_edge = neg_per_edge
        self.hidden = tuple(hidden)
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self.params = None
        self._mu = self._sd = None

    def _points(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def fit(self, x, params: Optional[list] = None) -> np.ndarray:
        """Fit on (N, D) points; `params` the initial weights (else drawn
        from the seed). Returns the (N, n_components) embedding."""
        x = self._points(x)
        if x.dim() != 2:
            raise ValueError(f"expected (N, D), got {tuple(x.shape)}")
        # standardise so the MLP init scale is data-independent
        self._mu = x.mean(dim=0)
        self._sd = x.std(dim=0, correction=0) + 1e-6
        xs = (x - self._mu) / self._sd
        k = min(self.k, x.shape[0] - 1)
        gen = torch.Generator(device=self.device).manual_seed(int(self.seed))
        self.params, emb, self.losses = _fit(
            xs, gen, k, self.steps, min(self.batch_edges, x.shape[0] * k),
            self.neg_per_edge, self.n_components, self.hidden, self.lr, params)
        return emb.cpu().numpy()

    def transform(self, y) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("fit first")
        with torch.no_grad():
            return _mlp(self.params, (self._points(y) - self._mu) / self._sd).cpu().numpy()

    def fit_transform(self, x) -> np.ndarray:
        return self.fit(x)


def aligned_sweep_maps(sweeps: dict, **kwargs) -> tuple:
    """Fit one parametric map on the union of all knob sweeps, then embed
    each sweep through it (the AlignedUMAP capability: corresponding clips
    stay comparable across sweeps because the map is shared).

    sweeps: {name: (n_points, D) array}. Returns ({name: (n_points, 2)},
    the fitted ParametricUMAP). kwargs go to ParametricUMAP (device too).
    """
    def rows(a):
        a = np.asarray(a, np.float32)
        return a.reshape(-1, a.shape[-1])

    pu = ParametricUMAP(**kwargs)
    pu.fit(np.concatenate([rows(sweeps[n]) for n in sweeps]))
    return {n: pu.transform(rows(sweeps[n])) for n in sweeps}, pu
