"""The port's viz images and media twins against the JAX package's, on the
CPU: `utils/viz.spectrogram_db` (the port's STFT, K6's plain twin here)
against `audio_algebra_tpu/utils/viz.spectrogram_db` on the same seeded
audio, and `RunLogger.log_point_cloud`'s .npy and interactive .html
against JAX's, byte for byte.

spectrogram_db's tolerance: the images are dB of magnitudes, so they are
held in linear magnitude, 10^(dB/20), within 1e-5 of the image's peak
(f32 STFTs of unit-scale audio; a dB tolerance would be loosest where the
magnitude is largest and tightest near the clip floor), and the clip
floor (peak - top_db) within 1e-3 dB.
"""
import numpy as np
import pytest

MAG_REL_PEAK = 1e-5
FLOOR_DB = 1e-3


def _audio(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 48000
    tone = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3100 * t)
    return (tone + 1e-3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape, n_fft, hop, top_db", [
    ((2, 8192), 1024, 256, 80.0),
    ((6000,), 512, 128, 60.0),
])
def test_spectrogram_db_matches_jax(shape, n_fft, hop, top_db):
    from audio_algebra_tpu.utils import viz as jviz
    from audio_algebra_torch.utils import viz as tviz

    x = _audio(shape, 11)
    want = np.asarray(jviz.spectrogram_db(x, n_fft=n_fft, hop=hop, top_db=top_db))
    got = tviz.spectrogram_db(x, n_fft=n_fft, hop=hop, top_db=top_db, device="cpu")
    assert got.shape == want.shape == (n_fft // 2 + 1, shape[-1] // hop + 1)
    assert got.dtype == np.float32
    peak = 10.0 ** (want.max() / 20.0)
    err = np.abs(10.0 ** (got / 20.0) - 10.0 ** (want / 20.0)).max()
    assert err <= MAG_REL_PEAK * peak, (err, peak)
    assert abs(got.min() - want.min()) <= FLOOR_DB
    assert got.min() == pytest.approx(got.max() - top_db, abs=1e-3)    # the clip is hit
    # low frequencies at the bottom: the 440 Hz line is in the last rows
    row = int(np.argmax(got.mean(axis=1)))
    assert got.shape[0] - 1 - row == round(440 * n_fft / 48000)


@pytest.mark.parametrize("cols", [3, 6, 2])
def test_log_point_cloud_writes_jax_files(tmp_path, cols):
    """The same .npy and (for 3+ columns) the same .html bytes, under the
    same file names; two columns write no .html on either side."""
    from audio_algebra_tpu.utils.logging import RunLogger as JRunLogger
    from audio_algebra_torch.utils.logging import RunLogger

    pts = np.random.default_rng(cols).standard_normal((40, cols)).astype(np.float32)
    jlog = JRunLogger("p", "run", out_dir=str(tmp_path / "jax"), use_wandb=False)
    tlog = RunLogger("p", "run", out_dir=str(tmp_path / "torch"))
    jpath = jlog.log_point_cloud("embeddings/pca", pts, step=7)
    tpath = tlog.log_point_cloud("embeddings/pca", pts, step=7)
    jlog.finish()
    tlog.finish()
    jdir, tdir = tmp_path / "jax" / "p" / "run", tmp_path / "torch" / "p" / "run"
    names = sorted(p.name for p in jdir.iterdir() if p.suffix in (".npy", ".html"))
    assert names == sorted(p.name for p in tdir.iterdir() if p.suffix in (".npy", ".html"))
    assert len(names) == (2 if cols >= 3 else 1)
    assert tpath.endswith(jpath.rsplit("/", 1)[1])
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
