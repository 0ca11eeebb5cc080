"""The apps' two host-bound training loops, each in two forms, timed in
turns on the card.

    python -m audio_algebra_torch.profile_apps [--toy-steps 4000]
        [--umap-steps 1500] [--umap-points 328] [--rounds 2] [--out PATH]

aa_toy's `train_toy` (batch 256, hidden 64) and the parametric UMAP fit
of effects_explorer (`--umap-points` 64-wide points, k 10, 256 edges and
4 negatives each a step, hidden (128, 128)) run with their losses as the
package has them, where the point sets go through the MLP as one batch
("batched"), and as JAX writes them, one MLP call a set ("three"). Each
round runs three, batched, batched, three, so that drift of the host
falls on both alike. Prints one JSON line: each arm's seconds a run, in
order, their medians, and the card's name and power limit; `--out` gets
the same. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import aa_toy, umap_param


def toy_loss_three(model, a, b, fa, fb):
    """aa_toy.toy_loss with ya, yb and ymix through h in three calls, as
    the JAX script's loss_fn does."""
    ya, yb = aa_toy.twist_and_scrunch(a * fa), aa_toy.twist_and_scrunch(b * fb)
    ymix = aa_toy.twist_and_scrunch(a * fa + b * fb)
    za, ya_rec = model(ya)
    zb, _ = model(yb)
    zmix, ymix_rec = model(ymix)
    zsum = za + zb
    mix_loss = ((zsum - zmix) ** 2).mean()
    std = torch.sqrt(zsum.var(dim=0, correction=0) + 1e-4)
    var_loss = torch.relu(1.0 - std).mean()
    zc = zsum - zsum.mean(dim=0)
    cov_loss = ((zc.T @ zc) / (zsum.shape[0] - 1))[0, 1] ** 2 / 2
    recon = ((ya_rec - ya) ** 2).mean() + ((ymix_rec - ymix) ** 2).mean()
    loss = mix_loss + 0.1 * var_loss + 0.1 * cov_loss + recon
    return loss, {"mix_loss": mix_loss.detach(), "recon": recon.detach()}


def umap_loss_three(params, x, hk, tk, nk, neg_per_edge):
    """umap_param.loss_fn with heads, tails and negatives through the MLP
    in three calls, as the JAX module's loss_fn does."""
    eh, et, en = (umap_param._mlp(params, x[i]) for i in (hk, tk, nk))
    q = umap_param._q
    attract = -torch.log(q(((eh - et) ** 2).sum(dim=-1)).clamp_min(1e-10)).mean()
    qn = q(((eh.repeat_interleave(neg_per_edge, dim=0) - en) ** 2).sum(dim=-1))
    return attract - torch.log((1.0 - qn).clamp_min(1e-10)).mean()


FORMS = {"three": (toy_loss_three, umap_loss_three),
         "batched": (aa_toy.toy_loss, umap_param.loss_fn)}


def _points(n: int) -> np.ndarray:
    """n seeded 64-wide points in 8 clusters, like the explorer's
    time-mean embeddings."""
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((8, 64)) * 3
    return (centres[np.arange(n) % 8] + rng.standard_normal((n, 64))).astype(np.float32)


def _run(form: str, what: str, args) -> float:
    """Seconds of one toy training or one UMAP fit in `form`, to the end
    of its work on the card."""
    aa_toy.toy_loss, umap_param.loss_fn = FORMS[form]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if what == "toy":
        aa_toy.train_toy(steps=args.toy_steps, log_every=args.toy_steps, device="cuda")
    else:
        umap_param.ParametricUMAP(steps=args.umap_steps, device="cuda").fit(
            _points(args.umap_points))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--toy-steps", type=int, default=4000)
    p.add_argument("--umap-steps", type=int, default=1500)
    p.add_argument("--umap-points", type=int, default=328,
                   help="effects_explorer's default: 8 clips x (1 + 5 effects x 8 knobs)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_apps needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kept = FORMS["batched"]
    try:
        for what in ("toy", "umap"):                     # one warm-up each, not kept
            _run("batched", what, argparse.Namespace(**{**vars(args), "toy_steps": 50,
                                                        "umap_steps": 50}))
        seconds = {f"{what}_{form}": [] for what in ("toy", "umap") for form in FORMS}
        for _ in range(args.rounds):
            for what in ("toy", "umap"):
                for form in ("three", "batched", "batched", "three"):
                    seconds[f"{what}_{form}"].append(_run(form, what, args))
    finally:
        aa_toy.toy_loss, umap_param.loss_fn = kept
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    out = {"seconds": seconds,
           "median_s": {k: statistics.median(v) for k, v in seconds.items()},
           "toy_steps": args.toy_steps, "umap_steps": args.umap_steps,
           "umap_points": args.umap_points, "card": card}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
