"""The port's datasets module against the JAX package's (both numpy on the
host): PadCrop, Stereo, PhaseFlipper and is_silence on seeded arrays with
Python's `random` seeded identically on both sides; AudioDataset on
generated WAVs; the DataLoader's batch shapes, seeded order, worker
threads and tail handling."""
import random

import numpy as np
import pytest

from audio_algebra_tpu import datasets as jds
from audio_algebra_torch import datasets as tds
from audio_algebra_torch.utils.audio_io import write_wav


def _both(make, x, seed):
    out = []
    for mod in (jds, tds):
        random.seed(seed)
        out.append(make(mod)(x))
    return out


@pytest.mark.parametrize("length", [100, 4096, 10000])
@pytest.mark.parametrize("randomize", [True, False])
def test_padcrop_matches_jax(length, randomize):
    x = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    want, got = _both(lambda m: m.PadCrop(4096, randomize=randomize), x, 7)
    assert got.shape == (2, 4096) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_padcrop_redraws_silence():
    x = np.zeros((2, 20000), np.float32)
    x[:, 15000:] = 0.5
    want, got = _both(lambda m: m.PadCrop(4096, max_redraws=8), x, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [0, 1, 2, 3])
def test_stereo_matches_jax(channels):
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((channels, 50) if channels else (50,)).astype(np.float32)
    want, got = _both(lambda m: m.Stereo(), x, 0)
    assert got.shape == (2, 50)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_phase_flipper_matches_jax(seed):
    x = np.random.default_rng(seed).standard_normal((2, 64)).astype(np.float32)
    want, got = _both(lambda m: m.PhaseFlipper(), x, seed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("peak,thresh", [(0.0, -60), (1e-4, -60), (2e-3, -60), (0.05, -20)])
def test_is_silence_matches_jax(peak, thresh):
    x = np.full((2, 32), peak, np.float32)
    assert tds.is_silence(x, thresh) == jds.is_silence(x, thresh)
    assert tds.is_silence(np.zeros((2, 0), np.float32))


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(9000) / 48000
    for i in range(5):
        tone = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
        clip = np.stack([tone, 0.5 * tone]) + 0.02 * rng.standard_normal((2, 9000))
        write_wav(tmp_path / f"clip{i}.wav", clip.astype(np.float32), 48000)
    (tmp_path / "notes.txt").write_text("not audio")
    (tmp_path / "take.aiff").write_bytes(b"FORM")     # scanned, but not decoded
    return tmp_path


def test_audio_dataset_matches_jax(corpus):
    assert tds.get_audio_filenames(corpus) == jds.get_audio_filenames(corpus)
    items = []
    for mod in (jds, tds):
        random.seed(5)
        ds = mod.AudioDataset([corpus], filenames=sorted(str(p) for p in corpus.glob("*.wav")),
                              sample_size=4096)
        items.append([ds[i] for i in range(len(ds))])
    assert len(items[1]) == 5
    for want, got in zip(*items):
        assert got.shape == (2, 4096) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_audio_dataset_skips_what_it_cannot_decode(corpus, capsys):
    ds = tds.AudioDataset([corpus], sample_size=2048, load_frac=0.8, augs="Stereo()",
                          cache_training_data=True)
    assert "skipping 1 files" in capsys.readouterr().out
    assert len(ds) == 4 and len(ds._cache) == 4
    assert ds[0].shape == (2, 2048)
    with pytest.raises(NameError):
        tds.AudioDataset([corpus], augs="Gain()")       # an effect that is not ported


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 4), i, np.float32)


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_order_shapes_and_tail(workers, capsys):
    want = [b[:, 0, 0].tolist() for b in jds.DataLoader(_Rows(10), batch_size=4, seed=9)]
    dl = tds.DataLoader(_Rows(10), batch_size=4, seed=9, num_workers=workers)
    got = list(dl)
    assert len(dl) == len(got) == 2 and all(b.shape == (4, 2, 4) for b in got)
    assert [b[:, 0, 0].tolist() for b in got] == want
    assert "dropping the ragged tail batch of 2" in capsys.readouterr().out
    second = [b[:, 0, 0].tolist() for b in dl]
    assert second != want and sorted(sum(second, [])) != list(range(10))
    kept = list(tds.DataLoader(_Rows(10), batch_size=4, shuffle=False, drop_last=False))
    assert [len(b) for b in kept] == [4, 4, 2]
    assert np.concatenate(kept)[:, 0, 0].tolist() == list(range(10))


def test_dataloader_collates_dicts():
    class Pairs(_Rows):
        def __getitem__(self, i):
            return {"a": np.full((3,), i, np.float32), "name": f"item{i}"}

    batch = next(iter(tds.DataLoader(Pairs(4), batch_size=2, shuffle=False)))
    assert batch["a"].shape == (2, 3) and batch["name"] == ["item0", "item1"]
