"""Audio IO and chunking (host side, numpy), the port's own copy of
audio_algebra_tpu/utils/audio_io.py's Destructo subset.

WAV (PCM 8/16/24/32-bit and float32) goes through a numpy codec. MP3 goes
through the repository's C++ decoder `native/libaacodec.so` over a ctypes
binding of this module, when that library has been built
(`make -C native`). Other rates are resampled with ops.resample.resample_np.
`batch_it_crazy` chops a signal into a zero-padded batch of chunks;
`crossfade_flatten` stitches a batch of generations into one take.
"""
from __future__ import annotations

import ctypes
import os
import struct
import wave
from pathlib import Path

import numpy as np

NATIVE_LIB = Path(__file__).resolve().parents[2] / "native" / "libaacodec.so"


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array (channels, frames), sample_rate)."""
    path = os.path.expanduser(str(path))
    fmt_tag = channels = sr = sampwidth = data = None
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = chunk_hdr[:4], struct.unpack("<I", chunk_hdr[4:])[0]
            payload = f.read(csize + (csize & 1))[:csize]
            if cid == b"fmt ":
                fmt_tag, channels, sr = struct.unpack("<HHI", payload[:8])
                sampwidth = struct.unpack("<H", payload[14:16])[0] // 8
                if fmt_tag == 0xFFFE and csize >= 40:     # WAVE_FORMAT_EXTENSIBLE
                    fmt_tag = struct.unpack("<H", payload[24:26])[0]
            elif cid == b"data":
                data = payload
    if data is None or fmt_tag is None:
        raise ValueError(f"malformed WAV (missing fmt/data): {path}")
    if fmt_tag == 3 and sampwidth == 4:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif fmt_tag == 1 and sampwidth == 2:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif fmt_tag == 1 and sampwidth == 4:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif fmt_tag == 1 and sampwidth == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        x = ints.astype(np.float32) / 8388608.0
    elif fmt_tag == 1 and sampwidth == 1:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV format tag={fmt_tag} width={sampwidth}")
    return x.reshape(-1, channels).T.copy(), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              subtype: str = "pcm16") -> None:
    """Write (channels, frames) float32 in [-1, 1] as WAV (pcm16 or float32)."""
    path = os.path.expanduser(str(path))
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    frames = audio.T
    if subtype == "pcm16":
        with wave.open(path, "wb") as w:
            w.setnchannels(frames.shape[1])
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            pcm = np.clip(frames, -1.0, 1.0)
            w.writeframes(np.round(pcm * 32767.0).astype("<i2").tobytes())
    elif subtype == "float32":
        data = frames.astype("<f4").tobytes()
        n_ch, byte_rate = frames.shape[1], sample_rate * frames.shape[1] * 4
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, n_ch, sample_rate,
                                          byte_rate, n_ch * 4, 32))
            f.write(b"data" + struct.pack("<I", len(data)) + data)
    else:
        raise ValueError(f"unknown subtype {subtype!r}")


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an MP3 with native/libaacodec.so -> ((C, N) float32, sr)."""
    if not NATIVE_LIB.exists():
        raise RuntimeError("MP3 decoding requires the native codec: run "
                           "`make -C native` to build libaacodec.so")
    lib = ctypes.CDLL(str(NATIVE_LIB))
    fn = lib.aa_decode_mp3
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.aa_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.aa_free.restype = None
    buf = ctypes.POINTER(ctypes.c_float)()
    ch, sr = ctypes.c_int(0), ctypes.c_int(0)
    n = fn(str(path).encode(), ctypes.byref(buf), ctypes.byref(ch), ctypes.byref(sr))
    if n <= 0:
        raise ValueError(f"MP3 decode failed ({n}): {path}")
    try:
        arr = np.ctypeslib.as_array(buf, shape=(int(n) * ch.value,))
        arr = arr.reshape(int(n), ch.value).T.astype(np.float32)
    finally:
        lib.aa_free(buf)
    return arr, sr.value


def load_audio(path: str, sr: int = 48000) -> np.ndarray:
    """Read a .wav or .mp3 file and resample it to `sr` -> (C, N) float32."""
    path = os.path.expanduser(str(path))
    ext = Path(path).suffix.lower()
    if ext == ".mp3":
        audio, in_sr = decode_mp3(path)
    elif ext in (".wav", ".wave"):
        audio, in_sr = read_wav(path)
    else:
        raise ValueError(f"unsupported audio format: {ext}")
    if in_sr != sr:
        from ..ops.resample import resample_np
        audio = resample_np(audio, in_sr, sr)
    return audio


def save_audio(path: str, audio, sample_rate: int) -> None:
    """Write audio as 16-bit PCM WAV."""
    write_wav(path, np.asarray(audio), sample_rate, subtype="pcm16")


def batch_it_crazy(x, chunk_size: int, max_batch_size: int | None = None) -> np.ndarray:
    """Chop (C, N) or (N,) into a batch (B, C, chunk_size), zero-padding
    the tail chunk."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape
    n_chunks = max(1, int(np.ceil(n / chunk_size)))
    padded = np.zeros((c, n_chunks * chunk_size), dtype=np.float32)
    padded[:, :n] = x[:, : n_chunks * chunk_size]
    batch = padded.reshape(c, n_chunks, chunk_size).transpose(1, 0, 2)
    if max_batch_size is not None:
        batch = batch[:max_batch_size]
    return batch


def crossfade_flatten(fakes, sr: int = 48000, fade_secs: float = 1.5,
                      fade_type: str = "sine") -> np.ndarray:
    """Flatten a batch (B, C, N) to (C, ~B*N) with crossfades of fade_secs
    ('sine', 'linear' or 'sqrt' ramps) between neighbours."""
    fakes = np.asarray(fakes, dtype=np.float32)
    b, c, n = fakes.shape
    if b == 1:
        return fakes[0]
    ov = min(int(fade_secs * sr), n // 2)
    ramp = np.linspace(0.0, 1.0, ov, dtype=np.float32)
    if fade_type == "sine":
        fade_in = np.sin(0.5 * np.pi * ramp)
    elif fade_type == "sqrt":
        fade_in = np.sqrt(ramp)
    else:
        fade_in = ramp
    fade_out = fade_in[::-1]
    out = np.zeros((c, b * n - (b - 1) * ov), dtype=np.float32)
    pos = 0
    for i in range(b):
        seg = fakes[i].copy()
        if i > 0:
            seg[:, :ov] *= fade_in
        if i < b - 1:
            seg[:, -ov:] *= fade_out
        out[:, pos:pos + n] += seg
        pos += n - ov
    return out
