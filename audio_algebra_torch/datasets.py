"""datasets — audio chunk datasets for the trainers.

Port of audio_algebra_tpu/datasets.py's core (numpy on the host, as there):
file scanning, random-crop chunking with silence redraw, the PadCrop /
Stereo / PhaseFlipper augmentations, `AudioDataset`, and a batching
`DataLoader` with a seeded shuffle and background-thread prefetch. Files
are read with the port's utils/audio_io.load_audio (WAV and MP3) and
resampled with ops/resample.resample_np. The filter effects (Gain, the
Butterworth classes) and `DualEffectsDataset` belong to the effects trainer
and are not ported yet.
"""
from __future__ import annotations

import os
import queue as queue_mod
import random
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .utils.audio_io import load_audio

__all__ = ['get_audio_filenames', 'is_silence', 'PadCrop', 'Stereo',
           'PhaseFlipper', 'AudioDataset', 'DataLoader']

AUDIO_EXTS = ('.wav', '.mp3', '.flac', '.ogg', '.aif', '.aiff')
LOADABLE = ('.wav', '.wave', '.mp3')        # what utils/audio_io decodes
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
                  f"(supported: wav/mp3), e.g. {skipped[0]}")
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


class DataLoader:
    """Batching iterator with optional background-thread prefetch, a seeded
    shuffle and numpy collation. With `drop_last` (the default) a ragged
    tail batch is dropped, and said so once."""

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = True,
                 num_workers: int = 0, drop_last: bool = True, seed: int = 0):
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
