"""Byte-level BPE tokenizer (GPT-2 / RoBERTa scheme), pure Python, offline.

Port of audio_algebra_tpu/utils/bpe.py. CLAP's text tower reads
RobertaTokenizer ids. The tokenizer is byte-level BPE: text is split by a
regex into pretoken chunks, each chunk's UTF-8 bytes are mapped through a
reversible byte -> unicode table, and the merge rules are applied greedily
by rank. The rules and the token -> id vocabulary are data (roberta-base's
vocab.json + merges.txt, about 1.3 MB), which the repository does not
ship: `RobertaBPE.from_assets(directory)` reads them from `directory`,
by default this package's assets/roberta_tokenizer/, and raises
FileNotFoundError without them (models/clap.tokenize then takes its
byte-level fallback). Unlike the JAX module it reads no environment
variable and no cache outside the package.
"""
from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["bytes_to_unicode", "RobertaBPE", "find_assets", "DEFAULT_ASSETS"]

DEFAULT_ASSETS = Path(__file__).resolve().parents[1] / "assets" / "roberta_tokenizer"


# GPT-2's pretokenizer split pattern; the `regex` module (imported when an
# engine is built) supports its \p classes.
_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
               r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte -> printable-unicode table of GPT-2's BPE.

    Printable bytes map to themselves; the rest are assigned codepoints
    256, 257, ... in byte order. This is an algorithm (not data): every
    byte-level BPE implementation reproduces exactly this table.
    """
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def find_assets(directory: Optional[os.PathLike] = None) -> Optional[Path]:
    """The directory holding vocab.json + merges.txt: `directory`, by
    default the package's assets/roberta_tokenizer/; None when the files
    are not there."""
    d = Path(directory) if directory is not None else DEFAULT_ASSETS
    if (d / "vocab.json").is_file() and (d / "merges.txt").is_file():
        return d
    return None


class RobertaBPE:
    """Exact byte-level BPE encoder over a vocab.json + merges.txt pair.

    Mirrors transformers.RobertaTokenizer's encoding semantics: GPT-2
    regex pretokenization, byte->unicode mapping, rank-greedy merges,
    ``<s>``/``</s>`` wrapping, ``<pad>`` padding.
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 bos: str = "<s>", eos: str = "</s>", pad: str = "<pad>",
                 unk: str = "<unk>"):
        import regex  # deferred: only needed when an engine is built

        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder[bos]
        self.eos_id = self.encoder[eos]
        self.pad_id = self.encoder[pad]
        self.unk_id = self.encoder.get(unk, self.pad_id)
        self._pat = regex.compile(_GPT2_SPLIT)
        self._cache: Dict[str, Tuple[str, ...]] = {}

    # ------------------------------------------------------------------ io
    @classmethod
    def from_assets(cls, directory: Optional[os.PathLike] = None
                    ) -> "RobertaBPE":
        d = find_assets(directory)
        if d is None:
            raise FileNotFoundError(
                "RoBERTa BPE assets (vocab.json + merges.txt) not found in "
                f"{directory if directory is not None else DEFAULT_ASSETS}")
        vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        merges: List[Tuple[str, str]] = []
        for line in (d / "merges.txt").read_text(encoding="utf-8").splitlines():
            if not line or line.startswith("#version"):
                continue
            a, _, b = line.partition(" ")
            if b:
                merges.append((a, b))
        return cls(vocab, merges)

    # ----------------------------------------------------------------- bpe
    def _bpe(self, token: str) -> Tuple[str, ...]:
        """Apply merges to one byte-unicode pretoken, lowest rank first."""
        hit = self._cache.get(token)
        if hit is not None:
            return hit
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[token] = word
        return word

    def encode_text(self, text: str) -> List[int]:
        """Raw BPE ids of `text` (no specials)."""
        ids: List[int] = []
        for chunk in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            ids.extend(self.encoder.get(t, self.unk_id)
                       for t in self._bpe(mapped))
        return ids

    def __call__(self, texts: Sequence[str], max_len: int = 77):
        """list[str] -> (N, L) int32 ids + mask, RoBERTa conventions:
        <s> ids </s>, truncation to max_len, <pad> to the longest row."""
        import numpy as np

        rows = []
        for t in texts:
            ids = [self.bos_id] + self.encode_text(t)[: max_len - 2] \
                + [self.eos_id]
            rows.append(ids)
        longest = max((len(r) for r in rows), default=2)
        out = np.full((len(rows), longest), self.pad_id, dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        mask = (out != self.pad_id).astype(np.int32)
        return out, mask
