"""Audio IO and chunking (host side, numpy), the port's own copy of
audio_algebra_tpu/utils/audio_io.py.

WAV (PCM 8/16/24/32-bit and float32) goes through a numpy codec; MP3, FLAC
and OGG/Vorbis through the repository's C++ codec `native/libaacodec.so`
(`make -C native`) over a ctypes binding of this module: MP3 by mpg123 and
OGG by the system's libvorbisfile / libvorbisenc, both opened at run time
by the library, FLAC by its own decoder. FLAC is written by the numpy
encoder of utils/flac_write.py. `decode_batch` decodes many files in one
native call on a C++ thread pool, each by its magic bytes. Other rates are
resampled with ops.resample.resample_np. `batch_it_crazy` chops a signal
into a zero-padded batch of chunks; `crossfade_flatten` stitches a batch of
generations into one take.
"""
from __future__ import annotations

import ctypes
import os
import struct
import wave
from pathlib import Path

import numpy as np

NATIVE_LIB = Path(__file__).resolve().parents[2] / "native" / "libaacodec.so"
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_DECODE_ENTRIES = ("aa_decode_mp3", "aa_read_flac", "aa_decode_ogg", "aa_decode_any")
_LIB: list = []
_NO_VORBIS = -1   # the native codec's return when libvorbis* fail to open


class VorbisUnavailable(ValueError):
    """The running machine's libvorbisfile / libvorbisenc did not open (the
    native codec reaches them with dlopen at run time)."""


def native_lib() -> ctypes.CDLL:
    """The loaded native codec with every entry's argument types declared;
    raises when it has not been built."""
    if _LIB:
        return _LIB[0]
    if not NATIVE_LIB.exists():
        raise RuntimeError("MP3, FLAC and OGG decoding need the native codec: run "
                           "`make -C native` to build libaacodec.so")
    lib = ctypes.CDLL(str(NATIVE_LIB))
    for name in _DECODE_ENTRIES:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FLOAT_P),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.aa_free.argtypes = [_FLOAT_P]
    lib.aa_free.restype = None
    lib.aa_decode_batch.restype = ctypes.c_int
    lib.aa_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_FLOAT_P), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.aa_encode_ogg.restype = ctypes.c_int
    lib.aa_encode_ogg.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_float]
    _LIB.append(lib)
    return lib


def _take(lib, buf, frames: int, channels: int) -> np.ndarray:
    """Copy an interleaved native buffer out as (C, N) float32 and free it."""
    try:
        arr = np.ctypeslib.as_array(buf, shape=(frames * channels,))
        return arr.reshape(frames, channels).T.astype(np.float32)
    finally:
        lib.aa_free(buf)


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


def _native_decode(entry: str, path: str, kind: str) -> tuple[np.ndarray, int]:
    """Call a native `(path, float**, int*, int*) -> frames` decode entry."""
    lib = native_lib()
    buf = _FLOAT_P()
    ch, sr = ctypes.c_int(0), ctypes.c_int(0)
    n = getattr(lib, entry)(str(path).encode(), ctypes.byref(buf), ctypes.byref(ch),
                            ctypes.byref(sr))
    if n == _NO_VORBIS and entry == "aa_decode_ogg":
        raise VorbisUnavailable(f"OGG decode needs libvorbisfile.so.3: {path}")
    if n <= 0:
        raise ValueError(f"{kind} decode failed ({n}): {path}")
    return _take(lib, buf, int(n), ch.value), sr.value


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an MP3 with the native codec -> ((C, N) float32, sr)."""
    return _native_decode("aa_decode_mp3", path, "MP3")


def decode_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file with the native decoder -> ((C, N) float32, sr)."""
    return _native_decode("aa_read_flac", path, "FLAC")


def decode_ogg(path: str) -> tuple[np.ndarray, int]:
    """Decode OGG/Vorbis with the native codec (libvorbisfile)."""
    return _native_decode("aa_decode_ogg", path, "OGG")


def encode_ogg(path: str, audio: np.ndarray, sample_rate: int, quality: float = 0.4) -> None:
    """Encode (C, N) float32 in [-1, 1] as OGG/Vorbis (libvorbisenc)."""
    lib = native_lib()
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    interleaved = np.ascontiguousarray(audio.T, dtype=np.float32)
    rc = lib.aa_encode_ogg(str(path).encode(), interleaved.ctypes.data_as(_FLOAT_P),
                           interleaved.shape[0], audio.shape[0], sample_rate, quality)
    if rc == _NO_VORBIS:
        raise VorbisUnavailable(f"OGG encode needs libvorbisenc.so.2: {path}")
    if rc != 0:
        raise ValueError(f"ogg encode failed ({rc}): {path}")


def decode_batch(paths, num_threads: int = 0) -> list:
    """Decode many files in one native call on a C++ thread pool (the GIL
    released for the whole batch), each by its magic bytes: RIFF -> WAV,
    fLaC -> FLAC, OggS -> Vorbis, else MP3. Returns a list aligned with
    `paths` of ((C, N) float32, sr), or None for a file that failed."""
    paths = [os.path.expanduser(str(p)) for p in paths]
    lib = native_lib()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bufs = (_FLOAT_P * n)()
    frames = (ctypes.c_longlong * n)()
    chans = (ctypes.c_int * n)()
    rates = (ctypes.c_int * n)()
    lib.aa_decode_batch(c_paths, n, num_threads, bufs, frames, chans, rates)
    out = []
    for i in range(n):
        if frames[i] <= 0 or not bufs[i]:
            out.append(None)
        else:
            out.append((_take(lib, bufs[i], int(frames[i]), chans[i]), rates[i]))
    return out


def load_audio_raw(path: str) -> tuple[np.ndarray, int]:
    """Read a file at its own rate, by extension -> ((C, N) float32, sr)."""
    ext = Path(str(path)).suffix.lower()
    if ext == ".mp3":
        return decode_mp3(str(path))
    if ext == ".flac":
        return decode_flac(str(path))
    if ext in (".ogg", ".oga"):
        return decode_ogg(str(path))
    return read_wav(str(path))


def load_audio(path: str, sr: int = 48000) -> np.ndarray:
    """Read a .wav, .mp3, .flac or .ogg file and resample it to `sr` ->
    (C, N) float32."""
    path = os.path.expanduser(str(path))
    ext = Path(path).suffix.lower()
    if ext not in (".mp3", ".wav", ".wave", ".flac", ".ogg", ".oga"):
        raise ValueError(f"unsupported audio format: {ext}")
    audio, in_sr = load_audio_raw(path)
    if in_sr != sr:
        from ..ops.resample import resample_np
        audio = resample_np(audio, in_sr, sr)
    return audio


def save_audio(path: str, audio, sample_rate: int) -> None:
    """Write audio, the format by extension: .flac through the numpy FLAC
    encoder, .ogg / .oga through Vorbis, anything else as 16-bit PCM WAV."""
    ext = Path(str(path)).suffix.lower()
    if ext == ".flac":
        from .flac_write import write_flac
        write_flac(path, np.asarray(audio), sample_rate)
    elif ext in (".ogg", ".oga"):
        encode_ogg(path, np.asarray(audio), sample_rate)
    else:
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
