"""The port's parametric UMAP against audio_algebra_tpu/umap_param.py on
the CPU: the kNN graph (indices equal, weights as close to float64 as
JAX's); the MLP and `transform` from JAX's initial weights within 1e-5;
one step's loss and gradients, on the same edge and negative draws,
within 1e-4 of jax.grad of a transcription of `_fit`'s loss_fn, and the
port's Adam against optax.adam's; and tests/test_umap.py's invariants on the port's
own draws (clusters separate, sweeps aligned, transform before fit
raises)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_algebra_tpu import umap_param as jumap
from audio_algebra_tpu.utils.prng import host_key
from audio_algebra_torch import umap_param as tumap


def _three_clusters(n_per=30, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.zeros((3, d))
    centers[0, 0] = centers[1, 1] = centers[2, 2] = 10.0
    x = np.concatenate([c + rng.standard_normal((n_per, d)) for c in centers]).astype(np.float32)
    return x, np.repeat(np.arange(3), n_per)


def _params_np(params):
    return [{k: np.asarray(v) for k, v in lyr.items()} for lyr in params]


def test_knn_graph_matches_jax():
    """Indices equal. The weights: |x|^2 + |y|^2 - 2 x.y in f32 leaves both
    sides 1-2e-5 from the float64 graph (JAX's CPU dot and torch's sum in
    different orders), so they cannot meet 1e-5 of each other; the port's
    distance from the float64 weights is held to twice JAX's own."""
    x, _ = _three_clusters(10)
    idx, w = tumap.knn_graph(torch.from_numpy(x), k=5)
    jidx, jw = jumap.knn_graph(jnp.asarray(x), k=5)
    idx64, w64 = tumap.knn_graph(torch.from_numpy(x).double(), k=5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx64.numpy(), np.asarray(jidx))
    jax_err = np.abs(np.asarray(jw) - w64.numpy()).max()
    assert np.abs(w.numpy() - w64.numpy()).max() <= 2 * jax_err, jax_err
    # tests/test_umap.py's invariants: no self, weights in (0, 1], the
    # nearest at 1, each row summing to log2(k)
    assert not (idx.numpy() == np.arange(30)[:, None]).any()
    w = w.numpy()
    assert (w > 0).all() and (w <= 1 + 1e-6).all()
    np.testing.assert_allclose(w[:, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(w.sum(1), np.log2(5), rtol=0.05)


def test_mlp_and_transform_from_jax_weights():
    x, _ = _three_clusters()
    dims = (16, 128, 128, 2)
    params = _params_np(jumap._init_mlp(jax.random.PRNGKey(3), dims))
    got = tumap._mlp([{k: torch.tensor(v) for k, v in lyr.items()} for lyr in params],
                     torch.from_numpy(x)).numpy()
    want = np.asarray(jumap._mlp(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # fit with no steps from JAX's weights for the seed, then transform: JAX's
    # ParametricUMAP.fit standardises x (population std + 1e-6) and
    # transform maps new points through the same standardisation
    tpu = tumap.ParametricUMAP(steps=0, seed=4, device="cpu")
    tpu.fit(x, params=_params_np(jumap._init_mlp(host_key(4), dims)))
    xj = jnp.asarray(x)
    want = np.asarray(jumap._mlp(jumap._init_mlp(host_key(4), dims),
                                 (xj[:7] + 0.5 - xj.mean(0)) / (xj.std(0) + 1e-6)))
    np.testing.assert_allclose(tpu.transform(x[:7] + 0.5), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _jax_loss(p, x, hk, tk, nk, neg_per_edge):
    """umap_param._fit's loss_fn, transcribed (it is local to _fit)."""
    _A, _B, _mlp = jumap._A, jumap._B, jumap._mlp
    eh, et = _mlp(p, x[hk]), _mlp(p, x[tk])
    d2 = jnp.sum((eh - et) ** 2, axis=-1)
    q = 1.0 / (1.0 + _A * jnp.exp(_B * jnp.log(jnp.maximum(d2, 1e-10))))
    attract = -jnp.log(jnp.maximum(q, 1e-10)).mean()
    en = _mlp(p, x[nk])
    ehr = jnp.repeat(eh, neg_per_edge, axis=0)
    d2n = jnp.sum((ehr - en) ** 2, axis=-1)
    qn = 1.0 / (1.0 + _A * jnp.exp(_B * jnp.log(jnp.maximum(d2n, 1e-10))))
    repel = -jnp.log(jnp.maximum(1.0 - qn, 1e-10)).mean()
    return attract + repel


def test_one_step_matches_jax_grad_on_the_same_draws():
    x, _ = _three_clusters()
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    rng = np.random.default_rng(5)
    hk, tk = rng.integers(0, 90, 64), rng.integers(0, 90, 64)
    nk = rng.integers(0, 90, 64 * 4)
    params = _params_np(jumap._init_mlp(jax.random.PRNGKey(6), (16, 32, 32, 2)))
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss), static_argnums=5)(
        params, jnp.asarray(x), hk, tk, nk, 4)
    tparams = [{k: torch.tensor(v, requires_grad=True) for k, v in lyr.items()}
               for lyr in params]
    tx = torch.from_numpy(x)
    tloss = tumap.loss_fn(tparams, tx, torch.from_numpy(hk), torch.from_numpy(tk),
                          torch.from_numpy(nk), 4)
    tloss.backward()
    assert float(tloss.detach()) == pytest.approx(float(loss), rel=1e-4)
    for i, (lyr, jlyr) in enumerate(zip(tparams, grads)):
        # relative to the layer's largest gradient: the last bias's is 0 in
        # exact arithmetic (the loss sees differences of embeddings only)
        scale = max(np.abs(np.asarray(v)).max() for v in jlyr.values())
        for k in lyr:
            err = np.abs(lyr[k].grad.numpy() - np.asarray(jlyr[k])).max()
            assert err <= 1e-4 * scale, (i, k, err)
    # the port's Adam against optax.adam(1e-2) on JAX's gradients (Adam's
    # first step is lr * sign(g) for the last bias's rounding noise)
    opt = optax.adam(1e-2)
    upd, _ = opt.update(grads, opt.init(params), params)
    want_params = optax.apply_updates(params, upd)
    tparams = [{k: torch.tensor(v, requires_grad=True) for k, v in lyr.items()}
               for lyr in params]
    for lyr, jlyr in zip(tparams, grads):
        for k in lyr:
            lyr[k].grad = torch.tensor(np.asarray(jlyr[k]))
    tumap.make_optimizer(tparams, 1e-2).step()
    for lyr, jlyr in zip(tparams, want_params):
        for k in lyr:
            np.testing.assert_allclose(lyr[k].detach().numpy(), np.asarray(jlyr[k]),
                                       rtol=1e-4, atol=1e-6)


def test_clusters_separate_in_2d():
    x, labels = _three_clusters()
    pu = tumap.ParametricUMAP(steps=400, seed=1, device="cpu")
    emb = pu.fit_transform(x)
    assert emb.shape == (90, 2) and np.isfinite(emb).all()
    assert pu.losses.shape == (400,) and float(pu.losses[-1]) < float(pu.losses[0])
    cents = np.stack([emb[labels == i].mean(0) for i in range(3)])
    intra = max(np.linalg.norm(emb[labels == i] - cents[i], axis=1).mean() for i in range(3))
    inter = min(np.linalg.norm(cents[i] - cents[j]) for i in range(3) for j in range(i + 1, 3))
    assert inter > 2 * intra, (inter, intra)


def test_alignment_across_sweeps():
    x, _ = _three_clusters()
    rng = np.random.default_rng(3)
    sweeps = {"a": x, "b": x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)}
    maps, pu = tumap.aligned_sweep_maps(sweeps, steps=400, seed=2, device="cpu")
    assert set(maps) == {"a", "b"}
    ea, eb = maps["a"], maps["b"]
    scale = np.linalg.norm(ea.max(0) - ea.min(0))
    drift = np.linalg.norm(ea - eb, axis=1).mean()
    assert drift < 0.1 * scale, (drift, scale)
    np.testing.assert_array_equal(pu.transform(x), pu.transform(x))


def test_transform_requires_fit():
    with pytest.raises(RuntimeError):
        tumap.ParametricUMAP(device="cpu").transform(np.zeros((4, 8)))


def test_profile_three_call_loss_is_loss_fn():
    """profile_apps times loss_fn against JAX's three-call form: both
    compute the same loss (1e-6 rel) and gradients (within 1e-6 of the
    largest: the last bias's is 0 in exact arithmetic, distances being
    shift-invariant)."""
    from audio_algebra_torch.profile_apps import umap_loss_three

    gen = torch.Generator().manual_seed(2)
    x = torch.randn((40, 16), generator=gen)
    hk, tk = torch.randint(0, 40, (24,), generator=gen), torch.randint(0, 40, (24,), generator=gen)
    nk = torch.randint(0, 40, (96,), generator=gen)
    out = []
    for fn in (tumap.loss_fn, umap_loss_three):
        params = [{k: v.clone().requires_grad_() for k, v in lyr.items()}
                  for lyr in tumap._init_mlp(torch.Generator().manual_seed(1), (16, 32, 2), "cpu")]
        loss = fn(params, x, hk, tk, nk, 4)
        loss.backward()
        out.append((float(loss), [t.grad for lyr in params for t in lyr.values()]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    scale = max(float(g.abs().max()) for g in out[1][1])
    for g1, g2 in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(g1, g2, rtol=0, atol=1e-6 * scale)
