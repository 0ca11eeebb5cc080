"""Pure-Python FLAC writer: the port's own copy of
audio_algebra_tpu/utils/flac_write.py, which writes the same bytes.

The reference saves audio through torchaudio (libsndfile), which can emit
FLAC; this repo's native layer only *reads* FLAC (native/flac_decoder.cpp),
so the write side lives here as a small real encoder: fixed-blocksize
streams of CONSTANT / FIXED(0-2) / VERBATIM subframes with Rice-coded
residuals, optional left/side / mid/side stereo decorrelation, proper
frame CRC-8/CRC-16 and the STREAMINFO MD5. Output is spec-conformant FLAC
(decodable by libFLAC); compression is real but deliberately simple (no
LPC search). It is also the offline fixture generator for
tests/test_flac_ogg.py — the native decoder round-trips files written here.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

__all__ = ["write_flac"]


class _BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then the terminating 1

    def align(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned bit stream"
        return bytes(self._bytes)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8_coded(n: int) -> bytes:
    """FLAC's UTF-8-style frame-number coding (same scheme as UTF-8)."""
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shifts = 6 * (nbytes - 1)
    out.append(lead | (n >> shifts))
    for i in range(nbytes - 1):
        shifts -= 6
        out.append(0x80 | ((n >> shifts) & 0x3F))
    return bytes(out)


def _best_rice_param(u: np.ndarray) -> int:
    """Pick the Rice parameter minimising the encoded size (exact scan)."""
    if len(u) == 0:
        return 0
    best_p, best_bits = 0, None
    for p in range(15):
        bits = int(np.sum(u >> p)) + len(u) * (p + 1)
        if best_bits is None or bits < best_bits:
            best_p, best_bits = p, bits
        elif bits > best_bits * 2:
            break
    return best_p


def _write_residual(bw: _BitWriter, res: np.ndarray, order: int,
                    blocksize: int, partition_order: int) -> None:
    bw.write(0, 2)                                   # coding method: RICE
    bw.write(partition_order, 4)
    parts = 1 << partition_order
    step = blocksize >> partition_order
    idx = 0
    for p in range(parts):
        count = step - (order if p == 0 else 0)
        chunk = res[idx:idx + count]
        idx += count
        u = np.where(chunk >= 0, chunk.astype(np.int64) * 2,
                     -2 * chunk.astype(np.int64) - 1).astype(np.uint64)
        param = _best_rice_param(u)
        bw.write(param, 4)
        for v in u.tolist():
            bw.write_unary(int(v) >> param)
            bw.write(int(v) & ((1 << param) - 1), param)


def _write_subframe(bw: _BitWriter, s: np.ndarray, bps: int,
                    partition_order: int, subframe_mode: str = "auto") -> None:
    s = s.astype(np.int64)
    blocksize = len(s)
    if subframe_mode == "verbatim":
        bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)
        for v in s.tolist():
            bw.write_signed(int(v), bps)
        return
    if subframe_mode == "lpc" and blocksize > 2:
        # order-2 LPC whose quantised coefficients reproduce the fixed-2
        # predictor (coefs [2, -1] << shift 5): numerically identical
        # output through the decoder's LPC path
        order, shift, precision = 2, 5, 8
        coefs = [2 << shift, -(1 << shift)]
        res = s[2:] - 2 * s[1:-1] + s[:-2]
        porder = partition_order
        while porder and (blocksize % (1 << porder) or (blocksize >> porder) <= order):
            porder -= 1
        bw.write(0, 1)
        bw.write(0b100000 | (order - 1), 6)          # LPC subframe type
        bw.write(0, 1)                               # no wasted bits
        for w in s[:order].tolist():
            bw.write_signed(int(w), bps)
        bw.write(precision - 1, 4)
        bw.write_signed(shift, 5)
        for c in coefs:
            bw.write_signed(c, precision)
        _write_residual(bw, res, order, blocksize, porder)
        return
    if np.all(s == s[0]):                            # CONSTANT
        bw.write(0, 1); bw.write(0, 6); bw.write(0, 1)
        bw.write_signed(int(s[0]), bps)
        return
    # FIXED orders 0-2: pick whichever residual is cheapest (sum |res|)
    cands = {0: s}
    if blocksize > 1:
        cands[1] = s[1:] - s[:-1]
    if blocksize > 2:
        cands[2] = s[2:] - 2 * s[1:-1] + s[:-2]
    order = min(cands, key=lambda o: int(np.abs(cands[o]).sum()))
    res = cands[order]
    porder = partition_order
    while porder and (blocksize % (1 << porder) or (blocksize >> porder) <= order):
        porder -= 1                                  # partition must fit
    bw.write(0, 1)
    bw.write(0b001000 | order, 6)                    # FIXED subframe type
    bw.write(0, 1)                                   # no wasted bits
    for w in s[:order].tolist():
        bw.write_signed(int(w), bps)
    _write_residual(bw, res, order, blocksize, porder)


def write_flac(path: str, audio: np.ndarray, sample_rate: int,
               bits: int = 16, block_size: int = 4096,
               stereo_mode: str = "independent",
               partition_order: int = 0,
               subframe_mode: str = "auto") -> None:
    """Write (channels, frames) float32 in [-1, 1] as a FLAC file.

    stereo_mode: 'independent' | 'left_side' | 'mid_side' (2-channel only) —
    chooses the frame channel assignment, mainly so the native decoder's
    decorrelation paths are testable offline.
    subframe_mode: 'auto' (CONSTANT/FIXED per block) | 'verbatim' | 'lpc' —
    forces a subframe type so every decoder path has offline coverage.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    channels, total = int(audio.shape[0]), int(audio.shape[1])
    if bits != 16:
        raise ValueError("write_flac supports 16-bit output")
    if stereo_mode != "independent" and channels != 2:
        raise ValueError("stereo decorrelation requires 2 channels")
    pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int64)

    out = bytearray(b"fLaC")
    # STREAMINFO (type 0, last metadata block)
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24); si.write(0, 24)                 # frame sizes unknown
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(total, 36)
    md5 = hashlib.md5(
        pcm.astype("<i2").T.reshape(-1).tobytes()).digest()
    body = si.getvalue() + md5
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + body

    chan_code = {"independent": channels - 1, "left_side": 8,
                 "mid_side": 10}[stereo_mode]

    frame_idx = 0
    for start in range(0, total, block_size):
        blk = pcm[:, start:start + block_size]
        bs = int(blk.shape[1])
        # frame header: sync(14) resv(1) fixed-blocksize(1) bs=code7(16-bit)
        # sr=code0(STREAMINFO) chan bps=code4(16) resv(1)
        hw = _BitWriter()
        hw.write(0b11111111111110, 14)
        hw.write(0, 1); hw.write(0, 1)
        hw.write(7, 4)                               # 16-bit blocksize-1 follows
        hw.write(0, 4)                               # rate from STREAMINFO
        hw.write(chan_code, 4)
        hw.write(4, 3)                               # bps 16
        hw.write(0, 1)
        header = hw.getvalue() + _utf8_coded(frame_idx) + struct.pack(">H", bs - 1)
        header += bytes([_crc8(header)])

        fw = _BitWriter()
        if stereo_mode == "left_side":
            subs = [(blk[0], bits), (blk[0] - blk[1], bits + 1)]
        elif stereo_mode == "mid_side":
            side = blk[0] - blk[1]
            mid = (blk[0] + blk[1]) >> 1
            subs = [(mid, bits), (side, bits + 1)]
        else:
            subs = [(blk[c], bits) for c in range(channels)]
        for s, b in subs:
            _write_subframe(fw, s, b, partition_order, subframe_mode)
        fw.align()
        frame = header + fw.getvalue()
        frame += struct.pack(">H", _crc16(frame))
        out += frame
        frame_idx += 1

    with open(path, "wb") as f:
        f.write(bytes(out))
