"""Visualisation data for the effects trainer's demos and MIRAGE's CLI.

Port of audio_algebra_tpu/utils/viz.py: `embeddings_table` (summary
statistics), `pca_point_cloud` (an SVD PCA of embeddings),
`spectrogram_db` (a dB magnitude spectrogram image, through the port's
STFT: kernel K6 on the card), `tokens_spectrogram_image` (embeddings laid
side by side), `save_image` (a PNG through matplotlib where it is
installed) and `point_cloud_html` (a self-contained interactive 3-D
cloud). Each takes numpy arrays or tensors on any device.
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


def spectrogram_db(audio, sr: int = 48000, n_fft: int = 1024, hop: int = 256,
                   top_db: float = 80.0, device=None) -> np.ndarray:
    """Audio (T,) or (C, T) -> its dB magnitude spectrogram image (n_fft/2
    + 1, frames): the magnitude averaged over channels, clipped `top_db`
    below its peak, low frequencies at the bottom (row 0 the highest).
    A tensor is taken on its device, an array on `device` (the CPU by
    default); the STFT is ops.stft's, K6 on a card."""
    import torch
    from ..ops.stft import spectrogram

    x = audio if torch.is_tensor(audio) else torch.from_numpy(np.asarray(audio, np.float32))
    if device is not None:
        x = x.to(device)
    x = x.float()
    if x.dim() == 1:
        x = x[None]
    mag = spectrogram(x, n_fft, hop, power=1.0)
    mag = mag.mean(dim=0) if mag.dim() == 3 else mag
    db = 20.0 * torch.log10(mag.clamp_min(1e-10))
    db = torch.clamp(db, min=float(db.max()) - top_db)
    return db.flip(0).cpu().numpy()


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


def point_cloud_html(points, colors=None, title: str = "PCA point cloud",
                     path=None):
    """A self-contained interactive 3-D point cloud (drag to rotate, scroll
    to zoom) as one HTML string, the role of the reference's plotly
    scatter_3d (reference mirage.py:434-444) without plotly. `colors` is an
    optional scalar a point (a viridis-like ramp; the point's index by
    default). Writes to `path` when given; returns the HTML either way."""
    import json as _json

    pts = _numpy(points).astype(np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"expected (N, >=3) points, got {pts.shape}")
    pts = pts[:, :3]
    # normalize into [-1, 1] so the JS camera needs no per-data tuning
    c = pts.mean(axis=0)
    scale = float(np.abs(pts - c).max() or 1.0)
    pts = (pts - c) / scale
    if colors is None:
        colors = np.arange(len(pts), dtype=np.float32)
    col = np.asarray(colors, np.float32).ravel()[: len(pts)]
    span = float(col.max() - col.min()) or 1.0
    col = (col - col.min()) / span
    data = _json.dumps(np.round(np.column_stack([pts, col]), 4).tolist())

    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title><style>body{{margin:0;background:#111;color:#ddd;
font-family:system-ui}}#c{{display:block}}#t{{position:fixed;top:8px;
left:12px;font-size:14px}}</style></head><body>
<div id="t">{title} &mdash; drag to rotate, scroll to zoom</div>
<canvas id="c"></canvas><script>
const P={data};
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let rx=-0.5,ry=0.6,zoom=1,drag=null;
function viridis(t){{const s=[[68,1,84],[59,82,139],[33,145,140],
[94,201,98],[253,231,37]];const i=Math.min(3.999,t*4),k=i|0,f=i-k;
const a=s[k],b=s[k+1];return `rgb(${{a[0]+(b[0]-a[0])*f|0}},`+
`${{a[1]+(b[1]-a[1])*f|0}},${{a[2]+(b[2]-a[2])*f|0}})`}}
function draw(){{
 cv.width=innerWidth;cv.height=innerHeight;
 const w=cv.width,h=cv.height,s=Math.min(w,h)*0.36*zoom;
 ctx.fillStyle='#111';ctx.fillRect(0,0,w,h);
 const ca=Math.cos(ry),sa=Math.sin(ry),cb=Math.cos(rx),sb=Math.sin(rx);
 const q=P.map(p=>{{
  const x=p[0]*ca+p[2]*sa, z=-p[0]*sa+p[2]*ca;
  const y=p[1]*cb-z*sb, z2=p[1]*sb+z*cb;
  return [x,y,z2,p[3]];}}).sort((a,b)=>a[2]-b[2]);
 for(const [x,y,z,t] of q){{
  const d=1/(2.2-z);
  ctx.fillStyle=viridis(t);ctx.globalAlpha=0.85;
  ctx.beginPath();
  ctx.arc(w/2+x*s*d*2.2,h/2-y*s*d*2.2,Math.max(1.2,3.5*d),0,6.283);
  ctx.fill();}}
 ctx.globalAlpha=1;}}
addEventListener('resize',draw);
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{{if(drag){{ry+=(e.clientX-drag[0])*0.008;
 rx+=(e.clientY-drag[1])*0.008;drag=[e.clientX,e.clientY];draw();}}}};
cv.onwheel=e=>{{e.preventDefault();zoom*=e.deltaY<0?1.1:0.9;draw();}};
draw();
</script></body></html>"""
    if path is not None:
        with open(path, "w") as f:
            f.write(html)
    return html
