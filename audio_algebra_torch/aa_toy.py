#!/usr/bin/env python
"""aa-mixer toy: a 2-D synthetic study of the mixer-algebra training.

    python -m audio_algebra_torch.aa_toy [--steps 4000] [--out-dir DIR] [--device cpu]

Port of the repository's aa_toy.py, the scientific check of the mixer
objective: a frozen nonlinear 2-D encoder (`twist_and_scrunch`: a
radius-dependent rotation, then tanh) breaks vector addition; training
the algebra map h (ToyAA: models/aa._MLP encoder and decoder, residual,
no BatchNorm) with the VICReg objective restores it (zsum covers zmix),
which makes king - man + woman arithmetic work.

The data come from numpy's default_rng(seed), the same draws as JAX's.
Adam is optax.adam's (torch's Adam has the same update). The weights are
utils.params.random_init_'s for the seed, or the flax tree `init` hands
over (`train_toy(init=...)`, JAX's `model.init`).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .models.aa import _MLP
from .utils.params import load_flax_params, random_init_


def rand_vec_batch(rng: np.random.Generator, n: int, extent: float = 1.0) -> np.ndarray:
    """Uniform 2-D points in [-extent, extent)^2."""
    return (rng.random((n, 2), dtype=np.float32) * 2 - 1) * extent


def twist_and_scrunch(x: torch.Tensor, twist: float = 1.5, scrunch: float = 1.2) -> torch.Tensor:
    """The frozen nonlinear 'given encoder': rotate each point by an angle
    proportional to its radius, then tanh-compress."""
    ang = twist * torch.linalg.vector_norm(x, dim=-1)
    c, s = torch.cos(ang), torch.sin(ang)
    rot = torch.stack([c * x[..., 0] - s * x[..., 1], s * x[..., 0] + c * x[..., 1]], dim=-1)
    return torch.tanh(scrunch * rot)


class ToyAA(nn.Module):
    """h: 2-D y -> z and its inverse, each a residual 4-block MLP plus a
    global residual (JAX's ToyAA, the flax names `enc` / `dec`)."""

    def __init__(self, hidden: int = 64):
        super().__init__()
        self.enc = _MLP(2, hidden, resid=True, use_bn=False)
        self.dec = _MLP(2, hidden, resid=True, use_bn=False)

    def encode(self, y: torch.Tensor) -> torch.Tensor:
        return self.enc(y) + y

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.dec(z) + z

    def forward(self, y: torch.Tensor):
        z = self.encode(y)
        return z, self.decode(z)


def toy_loss(model: ToyAA, a, b, fa, fb):
    """(loss, logs): the mixer objective on the toy encoder. ya, yb and
    ymix go through h as one batch (the MLP works row by row): a third of
    the launches of three calls, which bound the step on a card."""
    ya, yb = twist_and_scrunch(a * fa), twist_and_scrunch(b * fb)
    ymix = twist_and_scrunch(a * fa + b * fb)
    z, y_rec = model(torch.cat([ya, yb, ymix]))
    (za, zb, zmix), (ya_rec, _, ymix_rec) = z.chunk(3), y_rec.chunk(3)
    zsum = za + zb
    mix_loss = ((zsum - zmix) ** 2).mean()
    std = torch.sqrt(zsum.var(dim=0, correction=0) + 1e-4)
    var_loss = torch.relu(1.0 - std).mean()
    zc = zsum - zsum.mean(dim=0)
    cov = (zc.T @ zc) / (zsum.shape[0] - 1)
    cov_loss = cov[0, 1] ** 2 / 2
    recon = ((ya_rec - ya) ** 2).mean() + ((ymix_rec - ymix) ** 2).mean()
    loss = mix_loss + 0.1 * var_loss + 0.1 * cov_loss + recon
    return loss, {"mix_loss": mix_loss.detach(), "recon": recon.detach()}


def train_toy(steps: int = 2000, batch: int = 256, hidden: int = 64, seed: int = 42,
              lr: float = 2e-3, log_every: int = 200, logger=None,
              init: Optional[dict] = None, device: str | torch.device = "cuda"):
    """Train h on the toy mixer objective; returns (model, history), the
    history a record every `log_every` steps and at the last. `init` is a
    flax params tree to start from."""
    device = resolve_device(device)
    model = ToyAA(hidden=hidden)
    model = load_flax_params(model, init) if init is not None else random_init_(model, seed)
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    history = []
    for i in range(steps):
        a = rand_vec_batch(rng, batch, 0.6)
        b = rand_vec_batch(rng, batch, 0.6)
        fa, fb = (float(np.float32(rng.uniform(0.5, 1.0))) for _ in range(2))
        loss, logs = toy_loss(model, torch.from_numpy(a).to(device),
                              torch.from_numpy(b).to(device), fa, fb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % log_every == 0 or i == steps - 1:
            rec = {"step": i, "loss": float(loss.detach()),
                   **{k: float(v) for k, v in logs.items()}}
            history.append(rec)
            if logger:
                logger.log(rec, step=i)
    return model, history


@torch.no_grad()
def algebra_error(model: ToyAA, n: int = 512, seed: int = 1) -> dict:
    """zsum-vs-zmix error through h against the raw encoder's."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rand_vec_batch(rng, n, 0.6)).to(device)
    b = torch.from_numpy(rand_vec_batch(rng, n, 0.6)).to(device)
    ya, yb, ymix = (twist_and_scrunch(v) for v in (a, b, a + b))
    raw_err = float(((ya + yb - ymix) ** 2).mean())
    z_err = float(((model.encode(ya) + model.encode(yb) - model.encode(ymix)) ** 2).mean())
    return {"raw_err": raw_err, "z_err": z_err, "improvement": raw_err / max(z_err, 1e-12)}


@torch.no_grad()
def kmw_demo(model: ToyAA, seed: int = 2) -> dict:
    """king - man + woman in z-space."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    king, man, woman = (torch.from_numpy(rand_vec_batch(rng, 1, 0.5)).to(device)
                        for _ in range(3))
    queen = king - man + woman                     # the truth in input space

    def enc(v):
        return model.encode(twist_and_scrunch(v))
    z_guess = enc(king) - enc(man) + enc(woman)
    return {"kmw_err": float(((z_guess - enc(queen)) ** 2).mean())}


def main(argv=None) -> dict:
    """The study: train, measure, write results.json. Returns the results."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--out-dir", default="aa_toy_out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, history = train_toy(steps=args.steps, device=args.device)
    err = algebra_error(model)
    kmw = kmw_demo(model)
    print(json.dumps({**err, **kmw, "final_loss": history[-1]["loss"]}, indent=2))
    results = {"history": history, **err, **kmw}
    with open(out / "results.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
