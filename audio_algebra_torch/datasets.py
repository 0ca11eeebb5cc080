"""datasets — audio chunk datasets for the trainers.

Port of audio_algebra_tpu/datasets.py's core (numpy on the host, as there):
file scanning, random-crop chunking with silence redraw, the PadCrop /
Stereo / PhaseFlipper augmentations, `AudioDataset`, and a batching
`DataLoader` with a seeded shuffle and background-thread prefetch. Files
are read with the port's utils/audio_io.load_audio (WAV, MP3, FLAC, OGG) and
resampled with ops/resample.resample_np.

The effects trainer's bank: `Gain` and the Butterworth `LowPassFilter`,
`HighPassFilter`, `BandPassFilter`, `BandStopFilter` (audiomentations'
defaults), designed and applied on the host (ops/filters), and
`DualEffectsDataset`, two clips under two distinct effects. Like JAX's,
they draw from Python's `random`, so equal seeds give equal bits.
"""
from __future__ import annotations

import math
import os
import queue as queue_mod
import random
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .ops import filters as F
from .utils.audio_io import load_audio

__all__ = ['get_audio_filenames', 'is_silence', 'PadCrop', 'Stereo',
           'PhaseFlipper', 'Gain', 'LowPassFilter', 'HighPassFilter',
           'BandPassFilter', 'BandStopFilter', 'math_loguniform', 'AudioDataset',
           'DualEffectsDataset', 'DataLoader']

AUDIO_EXTS = ('.wav', '.mp3', '.flac', '.ogg', '.aif', '.aiff')
LOADABLE = ('.wav', '.wave', '.mp3', '.flac', '.ogg', '.oga')   # what utils/audio_io decodes
AUGMENTATIONS = {}                          # name -> class, for the `augs` string


def get_audio_filenames(paths) -> list:
    """Recursive audio file scan (aeiou.get_audio_filenames equivalent)."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    names = []
    for p in paths:
        p = Path(os.path.expanduser(str(p)))
        if p.is_file() and p.suffix.lower() in AUDIO_EXTS:
            names.append(str(p))
        elif p.is_dir():
            for ext in AUDIO_EXTS:
                names.extend(str(f) for f in p.rglob(f"*{ext}"))
    return sorted(names)


def is_silence(audio, thresh: int = -60) -> bool:
    """True when peak level is below `thresh` dB (aeiou.is_silence)."""
    peak = float(np.max(np.abs(np.asarray(audio)))) if np.size(audio) else 0.0
    return peak < 10.0 ** (thresh / 20.0)


# --------------------------------------------------------- augmentations ---

class PadCrop:
    """Random (or left-aligned) fixed-size crop, zero-padded when short
    (aeiou.PadCrop; reference datasets.py:58)."""

    def __init__(self, n_samples: int, randomize: bool = True,
                 redraw_silence: bool = True, silence_thresh: int = -60,
                 max_redraws: int = 2):
        self.n_samples = n_samples
        self.randomize = randomize
        self.redraw_silence = redraw_silence
        self.silence_thresh = silence_thresh
        self.max_redraws = max_redraws

    def __call__(self, x: np.ndarray) -> np.ndarray:
        c, t = x.shape
        out = np.zeros((c, self.n_samples), dtype=np.float32)
        for _ in range(self.max_redraws + 1):
            start = random.randint(0, max(0, t - self.n_samples)) if self.randomize else 0
            chunk = x[:, start : start + self.n_samples]
            out[:, : chunk.shape[1]] = chunk
            if not (self.redraw_silence and is_silence(out, self.silence_thresh)):
                break
        return out


class Stereo:
    """Force 2 channels: dup mono, crop >2 (aeiou.Stereo)."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] == 1:
            return np.concatenate([x, x], axis=0)
        return x[:2]


class PhaseFlipper:
    """Random polarity flip (aeiou.PhaseFlipper)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return -x if random.random() < self.p else x


AUGMENTATIONS.update(PadCrop=PadCrop, Stereo=Stereo, PhaseFlipper=PhaseFlipper)


# ----------------------------------------------------------- effect bank ---

class _FilterEffect:
    """An audiomentations-style effect: fresh random parameters each call,
    applied with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, samples: np.ndarray, sample_rate: int) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, samples: np.ndarray, sample_rate: int) -> np.ndarray:
        if random.random() > self.p:
            return samples
        return np.asarray(self.apply(np.asarray(samples, np.float32), sample_rate))


class Gain(_FilterEffect):
    """audiomentations.Gain: a uniform gain in dB (default ±12)."""

    def __init__(self, min_gain_db: float = -12.0, max_gain_db: float = 12.0,
                 p: float = 0.5):
        super().__init__(p)
        self.min_gain_db, self.max_gain_db = min_gain_db, max_gain_db

    def apply(self, x, sr):
        g = random.uniform(self.min_gain_db, self.max_gain_db)
        return x * (10.0 ** (g / 20.0))


class _ButterEffect(_FilterEffect):
    """A Butterworth filter designed and run on the host (numpy design,
    scipy sosfilt), with a random roll-off of 12-24 dB per octave."""
    btype = "lowpass"

    def __init__(self, min_rolloff: int = 12, max_rolloff: int = 24, p: float = 0.5):
        super().__init__(p)
        self.min_rolloff, self.max_rolloff = min_rolloff, max_rolloff

    def _order(self) -> int:
        # roll-off dB / octave -> Butterworth order (6 dB / octave a pole)
        rolloff = random.choice(range(self.min_rolloff, self.max_rolloff + 1, 6))
        return max(2, rolloff // 6)

    def _filter(self, x, cutoff, sr, two_sided: bool):
        sos = F.butter_sos_np(self._order(), cutoff if two_sided else float(cutoff),
                              sr, self.btype)
        return F.sosfilt_np(sos, x)


class LowPassFilter(_ButterEffect):
    """audiomentations.LowPassFilter (cutoff 150-7500 Hz, log-uniform)."""
    btype = "lowpass"

    def __init__(self, min_cutoff_freq: float = 150.0, max_cutoff_freq: float = 7500.0,
                 **kw):
        super().__init__(**kw)
        self.min_cutoff_freq, self.max_cutoff_freq = min_cutoff_freq, max_cutoff_freq

    def apply(self, x, sr):
        return self._filter(x, math_loguniform(self.min_cutoff_freq, self.max_cutoff_freq),
                            sr, False)


class HighPassFilter(_ButterEffect):
    """audiomentations.HighPassFilter (cutoff 20-2400 Hz, log-uniform)."""
    btype = "highpass"

    def __init__(self, min_cutoff_freq: float = 20.0, max_cutoff_freq: float = 2400.0,
                 **kw):
        super().__init__(**kw)
        self.min_cutoff_freq, self.max_cutoff_freq = min_cutoff_freq, max_cutoff_freq

    def apply(self, x, sr):
        return self._filter(x, math_loguniform(self.min_cutoff_freq, self.max_cutoff_freq),
                            sr, False)


class _BandEffect(_ButterEffect):
    def __init__(self, min_center_freq: float = 200.0, max_center_freq: float = 4000.0,
                 min_bandwidth_fraction: float = 0.5, max_bandwidth_fraction: float = 1.99,
                 **kw):
        super().__init__(**kw)
        self.min_center_freq, self.max_center_freq = min_center_freq, max_center_freq
        self.min_bw, self.max_bw = min_bandwidth_fraction, max_bandwidth_fraction

    def _edges(self, sr):
        center = math_loguniform(self.min_center_freq, self.max_center_freq)
        bw = random.uniform(self.min_bw, self.max_bw) * center
        return max(10.0, center - bw / 2), min(sr / 2 - 10.0, center + bw / 2)


class BandPassFilter(_BandEffect):
    """audiomentations.BandPassFilter."""
    btype = "bandpass"

    def apply(self, x, sr):
        return self._filter(x, self._edges(sr), sr, True)


class BandStopFilter(_BandEffect):
    """audiomentations.BandStopFilter."""
    btype = "bandstop"

    def apply(self, x, sr):
        return self._filter(x, self._edges(sr), sr, True)


def math_loguniform(lo: float, hi: float) -> float:
    return float(np.exp(random.uniform(math.log(lo), math.log(hi))))


# -------------------------------------------------------------- datasets ---

class AudioDataset:
    """Chunked audio dataset (aeiou.AudioDataset capability as used at
    reference train_aa_mixer.py:101-108): file scan, load, PadCrop +
    Stereo + PhaseFlipper, silence redraw."""

    def __init__(self, paths, filenames=None, sample_rate: int = 48000,
                 sample_size: int = 65536, random_crop: bool = True,
                 load_frac: float = 1.0, redraw_silence: bool = True,
                 silence_thresh: int = -60, max_redraws: int = 2,
                 augs: str = 'Stereo(), PhaseFlipper()', verbose: bool = False,
                 cache_training_data: bool = False):
        self.sr = sample_rate
        self.sample_size = sample_size
        self.verbose = verbose
        base = [PadCrop(sample_size, randomize=random_crop,
                        redraw_silence=redraw_silence,
                        silence_thresh=silence_thresh, max_redraws=max_redraws)]
        # the reference's eval-string, resolved against the ported classes only
        extra = eval(f"[{augs}]", {"__builtins__": {}}, dict(AUGMENTATIONS)) if augs else []
        self.augs = base + extra
        self.redraw_silence = redraw_silence
        self.silence_thresh = silence_thresh
        self.max_redraws = max_redraws
        self.filenames = get_audio_filenames(paths) if filenames is None else filenames
        skipped = [f for f in self.filenames
                   if Path(f).suffix.lower() not in LOADABLE]
        if skipped:
            print(f"AudioDataset: skipping {len(skipped)} files in formats "
                  f"the port does not decode yet "
                  f"(supported: wav, mp3, flac, ogg), e.g. {skipped[0]}")
            self.filenames = [f for f in self.filenames
                              if Path(f).suffix.lower() in LOADABLE]
        print(f"AudioDataset:{len(self.filenames)} files found.")
        self.n_files = int(len(self.filenames) * load_frac)
        self.filenames = self.filenames[: self.n_files]
        self._cache = {} if cache_training_data else None
        if self._cache is not None:
            for idx in range(len(self.filenames)):      # decode the corpus once
                self._load(idx)
            print(f"AudioDataset: pre-cached {len(self._cache)} files")

    def __len__(self):
        return len(self.filenames)

    def _load(self, idx: int) -> Optional[np.ndarray]:
        fn = self.filenames[idx]
        if self._cache is not None and fn in self._cache:
            return self._cache[fn]
        try:
            audio = load_audio(fn, sr=self.sr)
        except Exception as e:
            print(f"AudioDataset: Error loading file {fn}: {e}")
            return None
        if self._cache is not None:
            self._cache[fn] = audio
        return audio

    def get_next_chunk(self, idx: int) -> Optional[np.ndarray]:
        audio = self._load(idx)
        if audio is None:
            return None
        x = audio
        for aug in self.augs:
            x = aug(x)
        return np.clip(x, -1.0, 1.0)

    def get_nonsilent_chunk(self, idx: int) -> np.ndarray:
        x = self.get_next_chunk(idx)
        redraws = 0
        while (x is None or (self.redraw_silence and
                             is_silence(x, self.silence_thresh))) \
                and redraws < self.max_redraws:
            idx = random.randint(0, len(self.filenames) - 1)
            x, redraws = self.get_next_chunk(idx), redraws + 1
        if x is None:
            # a corpus where every draw fails must say so
            raise RuntimeError(
                f"AudioDataset: no loadable chunk after {self.max_redraws} "
                "redraws — is the corpus readable?")
        return x

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.get_nonsilent_chunk(idx)


class DualEffectsDataset(AudioDataset):
    """Two clips under two effects: {a, b, a1, b1, a2, b2, e1, e2}, the
    effects two distinct draws from `effects_list` (each applied with p =
    1), every clip cut to a's length."""

    def __init__(self, paths, effects_list=None, **kwargs):
        effects_list = effects_list if effects_list is not None else \
            [Gain, BandPassFilter, BandStopFilter, HighPassFilter, LowPassFilter]
        super().__init__(paths, **kwargs)
        print("effects_list = ", [x().__class__.__name__ for x in effects_list])
        self.effects_list = [x(p=1.0) for x in effects_list]

    def apply_effect(self, audio: np.ndarray, effect) -> np.ndarray:
        return np.asarray(effect(audio, sample_rate=self.sr))

    def check_size(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return b[:, : a.shape[-1]] if a.shape[-1] < b.shape[-1] else b

    def __getitem__(self, idx: int) -> dict:
        a = self.get_nonsilent_chunk(idx)
        b = self.get_nonsilent_chunk(random.randint(0, len(self.filenames) - 1))
        effect1 = random.choice(self.effects_list)
        effect2 = random.choice([e for e in self.effects_list if e is not effect1])
        a1, b1 = (self.apply_effect(x, effect1) for x in (a, b))
        a2, b2 = (self.apply_effect(x, effect2) for x in (a, b))
        b, a1, b1, a2, b2 = (self.check_size(a, x) for x in (b, a1, b1, a2, b2))
        return dict(zip(["a", "b", "a1", "b1", "a2", "b2", "e1", "e2"],
                        [a, b, a1, b1, a2, b2,
                         effect1.__class__.__name__, effect2.__class__.__name__]))


class DataLoader:
    """Batching iterator with optional background-thread prefetch, a seeded
    shuffle and numpy collation. With `drop_last` (the default) a ragged
    tail batch is dropped, and said so once. `shard=(rank, size)` yields
    rank's rows of each global batch of `batch_size` (the same shuffle on
    every rank, so the ranks' rows make up the batch one process would
    take), and raises where a batch (a corpus smaller than one, a kept
    tail) does not split evenly; len() still counts global batches."""

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = True,
                 num_workers: int = 0, drop_last: bool = True, seed: int = 0,
                 shard: tuple = (0, 1)):
        rank, size = shard
        if batch_size % size:
            raise ValueError(f"batch_size {batch_size} does not split over {size} ranks")
        self.shard = (int(rank), int(size))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._told_tail = False

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return max(n, 1)

    def _collate(self, items):
        if isinstance(items[0], dict):
            out = {}
            for k in items[0]:
                vals = [it[k] for it in items]
                out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
            return out
        return np.stack(items)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        n_full = len(idx) // self.batch_size
        tail = len(idx) % self.batch_size
        if self.drop_last and tail and n_full >= 1 and not self._told_tail:
            print(f"DataLoader: dropping the ragged tail batch of {tail} items each epoch "
                  f"({len(idx)} items, batch {self.batch_size})")
            self._told_tail = True
        batches = [idx[i * self.batch_size : (i + 1) * self.batch_size]
                   for i in range(max(n_full, 1))]
        if not self.drop_last and len(idx) % self.batch_size and n_full >= 1:
            batches.append(idx[n_full * self.batch_size :])
        rank, size = self.shard
        if size > 1:
            uneven = [len(b) for b in batches if len(b) % size]
            if uneven:
                raise ValueError(f"DataLoader: a batch of {uneven[0]} items does not split "
                                 f"over {size} ranks ({len(idx)} items, batch "
                                 f"{self.batch_size})")
            batches = [b.reshape(size, -1)[rank] for b in batches]
        return batches

    def __iter__(self):
        batches = self._index_batches()
        if self.num_workers <= 0:
            for bidx in batches:
                yield self._collate([self.dataset[int(i)] for i in bidx])
            return
        # True N-thread prefetch: num_workers threads each pull the next
        # unclaimed batch index and deposit (seq, batch); the consumer
        # reorders so iteration order matches num_workers=0 exactly.
        n_workers = min(self.num_workers, len(batches))
        q: queue_mod.Queue = queue_mod.Queue(maxsize=n_workers * 2)
        next_idx = iter(range(len(batches)))
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    seq = next(next_idx, None)
                if seq is None:
                    q.put((None, None))
                    return
                q.put((seq, self._collate(
                    [self.dataset[int(i)] for i in batches[seq]])))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        buffered: dict = {}
        want, done = 0, 0
        while done < n_workers:
            seq, item = q.get()
            if seq is None:
                done += 1
                continue
            buffered[seq] = item
            while want in buffered:
                yield buffered.pop(want)
                want += 1
        while want in buffered:   # drain any stragglers
            yield buffered.pop(want)
            want += 1
