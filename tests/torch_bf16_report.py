"""Print the distances behind tests/test_torch_train_bf16.py's bounds: every
gradient of the port's bf16 step against JAX's bf16 step (the tool's
quick widths, JAX's default GroupNorm route), with JAX's own bf16-vs-f32
distance, the port's f32 step against JAX's bf16 step (the control: a
step that ignored compute_dtype) and the port's bf16 step against its f32
step beside it; the same at 128 channels with JAX's K5 route (AA_LDM_GN=1,
bf16 throughout); and the bf16 frozen encode's distances. On the CPU,
~1 min:

    python tests/torch_bf16_report.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["AA_TRAIN_FLASH"] = "interpret"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train_bf16 as t  # noqa: E402
from audio_algebra_tpu.models import stacked as jstacked  # noqa: E402


def step_report(ldm, ldm_gn: str) -> None:
    os.environ["AA_LDM_GN"] = ldm_gn
    jmodel = jstacked.StackedAELatentDiffusionCond(**ldm)
    tree = t.rand_tree(jmodel, 5, jnp.zeros((1,) + t.LAT_SHAPE[1:]), jnp.zeros((1,)),
                       jnp.zeros((1, 1, 512)))
    batch = t._batch(1)
    loss16, want16 = t._jax_step(jmodel, tree, batch, 0.0)[:2]
    loss32, want32 = t._jax_step(jmodel, tree, batch, 0.0, bf16=False)[:2]
    loss, got = port_step(ldm, tree, batch, torch.bfloat16)
    loss_f, got_f = port_step(ldm, tree, batch, torch.float32)
    w16, w32 = dict(t._leaves(want16)), dict(t._leaves(want32))

    def rel(a, b):
        return abs(a - float(b)) / abs(float(b))
    print(f"channels {ldm['channels']}, AA_LDM_GN={ldm_gn}: loss rel, port bf16 vs JAX bf16 "
          f"{rel(loss, loss16):.3g}, port f32 vs JAX bf16 {rel(loss_f, loss16):.3g}, "
          f"port bf16 vs port f32 {rel(loss, loss_f):.3g}, JAX bf16 vs JAX f32 "
          f"{rel(float(loss16), loss32):.3g}")
    print("  port vs JAX bf16 | JAX bf16 vs JAX f32 | port f32 vs JAX bf16 | "
          "port bf16 vs port f32 | leaf")
    rows = sorted(((t._rel_rms(got[k], w), t._rel_rms(w, w32[k]), t._rel_rms(got_f[k], w),
                    t._rel_rms(got[k], got_f[k]), k) for k, w in w16.items()
                   if np.abs(w).max() > 0), reverse=True)
    for a, b, c, d, k in rows:
        print(f"  {a:.3e} | {b:.3e} | {c:.3e} | {d:.3e} | {k}")
    print("  max over leaves: " + " | ".join(f"{max(r[i] for r in rows):.3e}"
                                             for i in range(4)))


def port_step(ldm, tree, batch, dtype):
    """The port's loss and gradients (by flax path) of one step in `dtype`."""
    model = t.load_flax_params(t.tstacked.StackedAELatentDiffusionCond(**ldm), tree)
    loss = t.tstacked.v_objective_loss(
        t.ttrain.mixed_precision(model, dtype), *(torch.from_numpy(a) for a in batch),
        keep=torch.ones((t.LAT_SHAPE[0], 1, 1), dtype=bool))
    loss.backward()
    return float(loss.detach()), dict(t._leaves(t.to_flax_grads(model)))


def encode_report() -> None:
    jm = jstacked.LatentAudioDiffusionAutoencoder(**t.LDAE)
    tree = t.rand_tree(jm, 4, jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))
    x = (np.random.default_rng(2).standard_normal((2, 2, 1024)) * 0.2).astype(np.float32)
    encode = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=jstacked.LatentAudioDiffusionAutoencoder.encode))
    w16 = np.asarray(encode(t._bf16_tree(tree), jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    w32 = np.asarray(encode(tree, jnp.asarray(x)))
    tm = t.load_flax_params(t.tstacked.LatentAudioDiffusionAutoencoder(**t.LDAE), tree)
    with torch.no_grad():
        g16 = t.tmixer.mixed_encode_fn(tm, "encode")(torch.from_numpy(x)).numpy()
        g32 = tm.encode(torch.from_numpy(x)).numpy()
    print(f"frozen encode rel-RMS: port bf16 vs JAX bf16 {t._rel_rms(g16, w16):.3e}, "
          f"JAX bf16 vs f32 {t._rel_rms(w16, w32):.3e}, port bf16 vs f32 "
          f"{t._rel_rms(g16, g32):.3e}, port f32 vs JAX f32 {t._rel_rms(g32, w32):.3e}")


if __name__ == "__main__":
    step_report(t.LDM, "0")
    step_report({**t.LDM, "channels": 128, "multipliers": (1, 1)}, "1")
    encode_report()
