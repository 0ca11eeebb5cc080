"""Visualisation data for the effects trainer's demos.

Port of the numpy part of audio_algebra_tpu/utils/viz.py that the demos
use: `embeddings_table` (summary statistics), `pca_point_cloud` (an SVD
PCA of embeddings), `tokens_spectrogram_image` (embeddings laid side by
side) and `save_image` (a PNG through matplotlib where it is installed).
Each takes numpy arrays or tensors on any device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _numpy(z) -> np.ndarray:
    return z.detach().float().cpu().numpy() if hasattr(z, "detach") else np.asarray(z)


def embeddings_table(zs: Sequence, names: Optional[Sequence[str]] = None) -> dict:
    """{name: {shape, mean, std, min, max}} for each embedding tensor."""
    names = names or [f"z{i}" for i in range(len(zs))]
    out = {}
    for name, z in zip(names, zs):
        z = _numpy(z)
        out[name] = {"shape": list(z.shape), "mean": float(z.mean()),
                     "std": float(z.std()), "min": float(z.min()),
                     "max": float(z.max())}
    return out


def pca_point_cloud(z, n_components: int = 3, mean_axis: Optional[int] = -1) -> np.ndarray:
    """Embeddings (b, d, n) as a (points, n_components) PCA cloud.
    mean_axis=-1 averages over time first; None makes every (b, n)
    position a point."""
    z = _numpy(z).astype(np.float64)
    if z.ndim == 3:
        pts = z.mean(axis=mean_axis) if mean_axis is not None \
            else np.moveaxis(z, 1, 2).reshape(-1, z.shape[1])
    else:
        pts = z.reshape(-1, z.shape[-1])
    pts = pts - pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts, full_matrices=False)
    proj = (pts @ vt[:n_components].T).astype(np.float32)
    if proj.shape[1] < n_components:            # rank below n_components
        proj = np.pad(proj, [(0, 0), (0, n_components - proj.shape[1])])
    return proj


def tokens_spectrogram_image(embeddings) -> np.ndarray:
    """Embeddings (b, d, n) -> the (d, b*n) image of the items side by side."""
    z = _numpy(embeddings)
    if z.ndim == 3:
        z = np.concatenate([z[i] for i in range(z.shape[0])], axis=-1)
    return z


def save_image(array: np.ndarray, path: str, cmap: str = "magma") -> Optional[str]:
    """Render a 2-D array to PNG with matplotlib; returns the path, or None
    (and the array saved as `path`.npy) when it cannot render."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.save(path + ".npy", array)
        return None
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(array, aspect="auto", origin="lower", cmap=cmap)
    ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
