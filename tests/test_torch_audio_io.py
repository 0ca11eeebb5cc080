"""The port's audio IO against the JAX package's: the FLAC encoder writes
the same bytes as JAX's, the native codec's FLAC and OGG/Vorbis round trips,
load_audio / save_audio dispatch by extension, decode_batch by magic bytes,
and the port's datasets take FLAC and OGG corpora (the cases of
tests/test_flac_ogg.py)."""
import numpy as np
import pytest

from audio_algebra_tpu.utils import audio_io as jio
from audio_algebra_tpu.utils.flac_write import write_flac as jax_write_flac
from audio_algebra_torch import datasets as tds
from audio_algebra_torch.utils import audio_io as tio
from audio_algebra_torch.utils.flac_write import write_flac

pytestmark = pytest.mark.skipif(not tio.NATIVE_LIB.exists(),
                                reason="native codec not built (make -C native)")
LSB = 2.0 / 32768.0          # 16-bit quantisation: half an LSB plus rounding slack


def _tone(channels=2, n=20000, sr=44100, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = np.stack([0.5 * np.sin(2 * np.pi * (220 * (c + 1)) * t)
                  + 0.05 * rng.standard_normal(n) for c in range(channels)])
    return np.clip(x, -1, 1).astype(np.float32)


@pytest.mark.parametrize("channels,kw", [
    (2, {}), (1, {}), (2, {"stereo_mode": "left_side"}), (2, {"stereo_mode": "mid_side"}),
    (2, {"partition_order": 3}), (1, {"block_size": 256}),
    (2, {"subframe_mode": "verbatim"}), (2, {"subframe_mode": "lpc", "partition_order": 2}),
])
def test_flac_bytes_equal_jax_and_round_trip(tmp_path, channels, kw):
    x = _tone(channels, n=30000 if "block_size" not in kw else 40000)
    write_flac(str(tmp_path / "t.flac"), x, 44100, **kw)
    jax_write_flac(str(tmp_path / "j.flac"), x, 44100, **kw)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    y, sr = tio.decode_flac(str(tmp_path / "t.flac"))
    assert sr == 44100 and y.shape == x.shape
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767)
    np.testing.assert_array_equal(y * 32768.0, pcm)           # bit-exact at 16 bits
    want, _ = jio.decode_flac(str(tmp_path / "j.flac"))
    np.testing.assert_array_equal(y, want)


def test_flac_constant_subframes_and_garbage(tmp_path):
    x = np.zeros((2, 4096 + 123), dtype=np.float32)           # CONSTANT, short last block
    write_flac(str(tmp_path / "z.flac"), x, 44100)
    y, _ = tio.decode_flac(str(tmp_path / "z.flac"))
    assert y.shape == x.shape and not y.any()
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaC" + b"\x00" * 16)
    with pytest.raises(ValueError):
        tio.decode_flac(str(bad))


def test_ogg_round_trip_and_jax_decode(tmp_path):
    x = _tone(2, n=44100)
    path = str(tmp_path / "t.ogg")
    tio.encode_ogg(path, x, 44100, quality=0.6)
    y, sr = tio.decode_ogg(path)
    assert sr == 44100 and y.shape[0] == 2
    assert abs(y.shape[1] - x.shape[1]) < 2048             # within one Vorbis block
    n = min(y.shape[1], x.shape[1])
    corr = np.dot(x[0, :n], y[0, :n]) / (np.linalg.norm(x[0, :n]) * np.linalg.norm(y[0, :n]))
    assert corr > 0.9
    want, want_sr = jio.decode_ogg(path)
    assert want_sr == sr
    np.testing.assert_array_equal(y, want)


def test_ogg_faults_are_not_missing_vorbis(tmp_path, monkeypatch):
    """Only the codec's 'libvorbis did not open' code reads as
    VorbisUnavailable; bad input and a file that is no OGG stay faults."""
    with pytest.raises(ValueError) as empty:
        tio.encode_ogg(str(tmp_path / "e.ogg"), np.zeros((2, 0), np.float32), 44100)
    (tmp_path / "n.ogg").write_bytes(b"not an ogg stream")
    with pytest.raises(ValueError) as garbage:
        tio.decode_ogg(str(tmp_path / "n.ogg"))
    for err in (empty.value, garbage.value):
        assert not isinstance(err, tio.VorbisUnavailable)

    class NoVorbis:
        aa_encode_ogg = aa_decode_ogg = staticmethod(lambda *args: -1)

    monkeypatch.setattr(tio, "_LIB", [NoVorbis()])
    with pytest.raises(tio.VorbisUnavailable):
        tio.encode_ogg(str(tmp_path / "e.ogg"), _tone(2, n=4096), 44100)
    with pytest.raises(tio.VorbisUnavailable):
        tio.decode_ogg(str(tmp_path / "n.ogg"))


@pytest.mark.parametrize("ext", ["flac", "ogg", "wav"])
def test_load_audio_dispatches_and_resamples_as_jax(tmp_path, ext):
    x = _tone(2, n=22050)
    path = str(tmp_path / f"t.{ext}")
    tio.save_audio(path, x, 44100)
    raw, sr = tio.load_audio_raw(path)
    want_raw, want_sr = jio.load_audio_raw(path)
    assert sr == want_sr == 44100
    np.testing.assert_array_equal(raw, want_raw)
    got = tio.load_audio(path, sr=48000)
    want = jio.load_audio(path, sr=48000)
    assert got.shape == want.shape and got.shape[0] == 2
    assert abs(got.shape[1] - int(22050 * 48000 / 44100)) <= 2
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_decode_batch_dispatches_by_magic(tmp_path):
    x = _tone(2, n=8192)
    # the extensions lie: decode_batch reads the magic bytes
    flac, ogg, wav = tmp_path / "a.dat", tmp_path / "b.flac", tmp_path / "c.ogg"
    write_flac(str(flac), x, 44100)
    tio.encode_ogg(str(ogg), x, 44100)
    tio.write_wav(str(wav), x, 44100)
    got = tio.decode_batch([str(flac), str(ogg), str(wav), str(tmp_path / "missing.wav")])
    want = jio.decode_batch([str(flac), str(ogg), str(wav)])
    assert got[3] is None and all(r is not None for r in got[:3])
    for (arr, sr), (warr, wsr) in zip(got[:3], want):
        assert sr == wsr == 44100 and arr.shape[0] == 2
        np.testing.assert_array_equal(arr, warr)
    assert np.abs(got[0][0] - x).max() < LSB and np.abs(got[2][0] - x).max() < LSB


def test_save_audio_extension_dispatch(tmp_path):
    x = _tone(2, n=9000)
    for ext in ("wav", "flac", "ogg", "oga"):
        path = str(tmp_path / f"out.{ext}")
        tio.save_audio(path, x, 48000)
        y, sr = tio.load_audio_raw(path)
        assert sr == 48000 and y.shape[0] == 2
    assert (tmp_path / "out.flac").read_bytes()[:4] == b"fLaC"
    assert (tmp_path / "out.ogg").read_bytes()[:4] == b"OggS"


def test_load_audio_refuses_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unsupported audio format"):
        tio.load_audio(str(tmp_path / "x.aiff"))


@pytest.mark.parametrize("ext", ["flac", "ogg"])
def test_dataset_accepts_flac_and_ogg(tmp_path, ext):
    for i in range(3):
        path = str(tmp_path / f"s{i}.{ext}")
        tio.save_audio(path, _tone(2, n=9000, seed=i), 48000)
    assert f".{ext}" in tds.LOADABLE
    ds = tds.AudioDataset([str(tmp_path)], sample_size=4096, augs="")
    assert len(ds) == 3
    item = np.asarray(ds[0])
    assert item.shape == (2, 4096) and np.isfinite(item).all() and np.abs(item).max() > 0
