"""The algebra trainers' host data against the JAX package's: equal bits
for equal seeds. `get_stems_faders` (numpy's default_rng), the host filter
design and application (ops/filters), each effect of the bank and
`DualEffectsDataset` through the DataLoader with `num_workers 0` (Python's
`random`)."""
import random

import numpy as np
import pytest

from audio_algebra_tpu import aa_mixer as jmixer
from audio_algebra_tpu import datasets as jds
from audio_algebra_tpu.ops import filters as jfilters
from audio_algebra_torch import aa_mixer as tmixer
from audio_algebra_torch import datasets as tds
from audio_algebra_torch.ops import filters as tfilters
from audio_algebra_torch.utils.audio_io import write_wav

SR = 48000


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 2, 64)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("maxstems,unity_gain", [(2, False), (4, False), (4, True)])
def test_get_stems_faders_draws_what_jax_draws(maxstems, unity_gain):
    dl = _batches(3)
    outs = []
    for mod in (jmixer, tmixer):
        rng, it, got = np.random.default_rng(9), iter(dl), []
        for batch in dl * 2:            # runs past the end: the iterator restarts
            stems, faders, it = mod.get_stems_faders(batch, it, dl, maxstems=maxstems,
                                                     unity_gain=unity_gain, rng=rng)
            got.append((stems, faders))
        outs.append(got)
    for (js, jf), (ts, tf) in zip(*outs):
        assert ts.dtype == np.float32 and tf.dtype == np.float32
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tf, jf)
    if unity_gain:
        assert all(set(np.abs(f)) == {1.0} for _, f in outs[1])


@pytest.mark.parametrize("btype,cutoff", [("lowpass", 900.0), ("highpass", 120.0),
                                          ("bandpass", (300.0, 2000.0)),
                                          ("bandstop", (300.0, 2000.0))])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_filters_match_jax(btype, cutoff, order):
    want = jfilters.butter_sos_np(order, cutoff, SR, btype)
    got = tfilters.butter_sos_np(order, cutoff, SR, btype)
    np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(order).standard_normal((2, 4096)).astype(np.float32)
    y = tfilters.sosfilt_np(got, x)
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, jfilters.sosfilt_np(want, x))


EFFECTS = ["Gain", "LowPassFilter", "HighPassFilter", "BandPassFilter", "BandStopFilter"]


@pytest.mark.parametrize("name", EFFECTS)
def test_effect_bank_matches_jax(name):
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 8192))).astype(np.float32)
    outs = []
    for mod in (jds, tds):
        random.seed(5)
        effect = getattr(mod, name)(p=1.0)
        outs.append([effect(x, sample_rate=SR) for _ in range(4)])
    for want, got in zip(*outs):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(outs[1][0], outs[1][1])     # fresh parameters each call
    random.seed(5)
    skipped = getattr(tds, name)(p=0.0)
    assert skipped(x, sample_rate=SR) is x
    random.seed(5)
    got = tds.math_loguniform(20.0, 2000.0)
    random.seed(5)
    assert got == jds.math_loguniform(20.0, 2000.0)


def test_dual_effects_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(6):
        t = np.arange(6000) / SR
        x = 0.4 * np.sin(2 * np.pi * (150 + 90 * i) * t) + 0.05 * rng.standard_normal(6000)
        write_wav(str(tmp_path / f"c{i}.wav"), np.stack([x, -x]).astype(np.float32), SR)
    batches = []
    for mod in (jds, tds):
        random.seed(3)
        ds = mod.DualEffectsDataset([str(tmp_path)], sample_rate=SR, sample_size=4096,
                                    load_frac=1.0)
        dl = mod.DataLoader(ds, batch_size=2, shuffle=True, num_workers=0, seed=4)
        batches.append(list(dl))
    assert len(batches[1]) == 3
    for want, got in zip(*batches):
        assert set(got) == {"a", "b", "a1", "b1", "a2", "b2", "e1", "e2"}
        for k in ("a", "b", "a1", "b1", "a2", "b2"):
            assert got[k].shape == (2, 2, 4096) and got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["e1"] == want["e1"] and got["e2"] == want["e2"]
        assert all(e1 != e2 for e1, e2 in zip(got["e1"], got["e2"]))
