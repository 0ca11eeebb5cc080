"""A checkpoint file poured through a port wrapper's `setup` computes what
the reference-layout model computes, torch against torch on the CPU.

For DVAE, the stacked diffusion AE, the MIRAGE generator (through
CLAPDAE.setup and its environment variables), DMAE and RAVE (.ckpt and
TorchScript .ts): a tiny mirror of tests/torch_mirrors.py (main copies
perturbed away from the EMA twins) is saved with torch.save in the
reference's file layout, the wrapper's `setup` reads it, and the port's
forward must match the mirror's (its EMA copy) on the same seeded input:
rel-RMS < 1e-4, 1e-3 for the UNetCFG1d (MIRAGE's tolerance). `setup`
falls back to random weights on any failure, so the forward is the proof
that the pour happened; the printed hit and miss counts are checked too.
"""
import hashlib

import numpy as np
import pytest
import torch

from audio_algebra_torch import given_models as tgm
from torch_export import script_state_dict
import torch_mirrors as mirrors
from test_torch_convert import (DMAE, DVAE, LDM_MIRROR, RAVE, RAVE_MIRROR, STACKED,
                                perturb)

FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
STACKED_KWARGS = dict(second_stage_latent_dim=4, factors=(2, 2), latent_channels=16,
                      latent_multipliers=(1, 2, 2), latent_num_blocks=(2, 2),
                      diffusion_c_mults=(16, 16), diffusion_depth=2)


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


def tensors(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def file_info(path) -> dict:
    """ckpt_info for a local file: its path and SHA-256, no URL."""
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    return {"ckpt_path": str(path), "ckpt_hash": digest, "ckpt_url": "", "gdrive_path": ""}


def no_miss(out: str) -> None:
    assert "(0 unmatched torch tensors, 0 flax params left at init)" in out, out
    assert "Going with random weights" not in out, out


def seeded(shape, seed, scale=1.0) -> torch.Tensor:
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture(scope="module")
def stacked_mirror():
    torch.manual_seed(3)
    tm = mirrors.LatentAudioDiffusionAutoencoder(**STACKED)
    perturb(tm.latent_encoder, 4)
    perturb(tm.diffusion, 5)
    return tm.eval()


def check_stacked(diffae, tm) -> None:
    """encode, one diffusion_v and decode_first_stage against the mirror."""
    x = seeded((2, 2, 256), 4, 0.3)
    first = tm.autoencoder.encode(x)
    t = torch.tensor([0.3, 0.8])
    with torch.no_grad():
        z_ref = tm.encode(x)
        assert rel_rms(diffae.encode(x), z_ref) < 1e-4
        assert rel_rms(diffae.diffusion_v(first, t, z_ref),
                       tm.diffusion_ema(first, t, z_ref)) < 1e-4
        assert rel_rms(diffae.decode_first_stage(first), tm.autoencoder.decode(first)) < 1e-4


def test_dvae_setup_pours_the_ema_copy(tmp_path, capsys):
    torch.manual_seed(1)
    tm = mirrors.DiffusionDVAE(**DVAE)
    perturb(tm.encoder, 2)
    perturb(tm.diffusion, 3)
    tm.eval()
    path = tmp_path / "dvae.ckpt"
    torch.save({"state_dict": tensors(tm), "epoch": 1}, path)
    kw = {k: v for k, v in DVAE.items() if k != "latent_dim"}
    w = tgm.DVAEWrapper(args_dict={"latent_dim": 8, "sample_size": 256}, model_kwargs=kw,
                        device="cpu")
    w.ckpt_info = file_info(path)
    assert w.setup(gdrive=False) is w
    out = capsys.readouterr().out
    no_miss(out)
    assert "Checkpoint hash checks out." in out and "168 tensors mapped" in out
    x, t = seeded((2, 2, 256), 2, 0.3), torch.tensor([0.2, 0.7])
    with torch.no_grad():
        lat_ref = tm.encoder_ema(x)
        assert rel_rms(w.model.encode(x), lat_ref) < 1e-4
        cond = torch.tanh(lat_ref)
        assert rel_rms(w.model.decode_v(x, t, cond), tm.diffusion_ema(x, t, cond)) < 1e-4


def test_stacked_setup_pours_with_the_ema_swap(stacked_mirror, tmp_path, capsys):
    path = tmp_path / "stacked.ckpt"
    torch.save({"state_dict": tensors(stacked_mirror)}, path)
    w = tgm.StackedDiffAEWrapper(first_stage_config=FIRST_STAGE, model_kwargs=STACKED_KWARGS,
                                 ckpt_info=file_info(path), device="cpu")
    w.setup(gdrive=False)
    no_miss(capsys.readouterr().out)
    check_stacked(w.model, stacked_mirror)


def test_clapdae_setup_pours_the_generator_and_its_stage_one(stacked_mirror, tmp_path,
                                                             monkeypatch, capsys):
    """CLAPDAE_CKPT_22s names a generator checkpoint (ema_pytorch layout)
    that also carries the stage-1 stack under latent_ae.*."""
    torch.manual_seed(11)
    ldm = mirrors.StackedAELatentDiffusionCondLDM(**LDM_MIRROR)
    perturb(ldm.diffusion_ema.ema_model, 12)
    ldm.eval()
    sd = {**tensors(ldm), **{f"latent_ae.{k}": v for k, v in tensors(stacked_mirror).items()}}
    path = tmp_path / "clapdae_22s.ckpt"
    torch.save({"state_dict": sd}, path)
    for var in ("LATENT_DIFFAE_CKPT", "CLAP_CKPT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CLAPDAE_CKPT_22s", str(path))
    m = tgm.CLAPDAE(
        sample_size=4096, first_stage_config=FIRST_STAGE, device="cpu",
        model_kwargs=dict(**STACKED_KWARGS, embedding_features=16, channels=8,
                          resnet_groups=2, multipliers=(1, 2, 2), factors2=(1, 2),
                          num_blocks=(1, 1), attentions=(0, 0, 1), attention_heads=2,
                          attention_features=4, attention_multiplier=2,
                          attention_rel_pos_num_buckets=8,
                          attention_rel_pos_max_distance=16))
    assert m.setup(gdrive=False) is m
    out = capsys.readouterr().out
    assert "StackedAELatentDiffusionCond: converted" in out and \
        "LatentAudioDiffusionAutoencoder: converted" in out
    no_miss(out)
    unet, ref = m.latent_diffusion_model.diffusion, ldm.diffusion_ema.ema_model
    x, t = seeded((2, 4, 16), 5, 0.5), torch.tensor([0.4, 0.9])
    emb = seeded((2, 1, 16), 6, 0.3)
    with torch.no_grad():
        assert rel_rms(unet(x, t), ref(x, t)) < 1e-3
        assert rel_rms(unet(x, t, embedding=emb, embedding_scale=2.0),
                       ref(x, t, embedding=emb, embedding_scale=2.0)) < 1e-3
    check_stacked(m.latent_diffae, stacked_mirror)


def test_dmae_setup_pours_model_state_dict(tmp_path, capsys):
    torch.manual_seed(7)
    tm = mirrors.TorchDMAE(**DMAE).eval()
    path = tmp_path / "dmae.ckpt"
    torch.save({"model_state_dict": tensors(tm), "step": 10}, path)
    w = tgm.DMAE1d(model_kwargs=dict(**DMAE, mel_n_fft=64, mel_hop=16), device="cpu")
    w.ckpt_info = file_info(path)
    w.setup(gdrive=False)
    no_miss(capsys.readouterr().out)
    mel = seeded((2, 2 * 16, 16), 9)
    x, t, z = seeded((2, 2, 256), 10, 0.5), torch.tensor([0.1, 0.6]), seeded((2, 4, 8), 11, 0.7)
    with torch.no_grad():
        assert rel_rms(w.model.encoder.encode_mel(mel), tm.encode_mel(mel)) < 1e-4
        assert rel_rms(w.model.decode_v(x, t, z), tm.decode_v(x, t, z)) < 1e-4


@pytest.mark.parametrize("ext", [".ckpt", ".ts"])
def test_rave_setup_pours_ckpt_and_torchscript(ext, tmp_path, capsys):
    torch.manual_seed(5)
    tm = mirrors.RaveV2(**RAVE_MIRROR).eval()
    path = tmp_path / f"rave{ext}"
    if ext == ".ckpt":
        torch.save({"state_dict": tensors(tm)}, path)
    else:
        torch.jit.save(script_state_dict(tensors(tm)), str(path))
    w = tgm.RAVEWrapper(checkpoint_file=str(path), device="cpu", **RAVE)
    w.ckpt_info["ckpt_path"] = str(path)
    w.setup()
    out = capsys.readouterr().out
    no_miss(out)
    assert w.latent_pca is None
    bands = seeded((2, 4, 64), 6, 0.3)
    with torch.no_grad():
        z_ref = tm.encode_bands(bands)
        assert rel_rms(w.model.encode_bands(bands)[:, :8], z_ref) < 1e-4
        noise = torch.rand((2, z_ref.shape[-1] * 8 // 4, 4, 4),
                           generator=torch.Generator().manual_seed(7)) * 2 - 1
        assert rel_rms(w.model.decode_bands(z_ref, noise=noise),
                       tm.decode_bands(z_ref, noise=noise)) < 1e-4


def test_rave_export_pca_rotates_and_zero_fills(tmp_path, capsys):
    """An export's latent PCA (cropped to 5 of 8 dims): encode returns
    P (z - mu), decode takes P^T z' + mu, the cropped dims zero."""
    torch.manual_seed(5)
    sd = tensors(mirrors.RaveV2(**RAVE_MIRROR))
    rng = np.random.default_rng(0)
    pca = torch.from_numpy(np.linalg.qr(rng.standard_normal((8, 8)))[0][:5].astype(np.float32))
    mean = seeded((8,), 1)
    path = tmp_path / "rave.ts"
    torch.jit.save(script_state_dict({**sd, "latent_pca": pca, "latent_mean": mean}), str(path))
    w = tgm.RAVEWrapper(checkpoint_file=str(path), device="cpu", **RAVE)
    w.ckpt_info["ckpt_path"] = str(path)
    w.setup()
    assert "applying exported latent PCA (5 of 8 dims)" in capsys.readouterr().out
    audio = seeded((2, 1, 1024), 2, 0.3)
    noise = torch.rand((2, 64, 4, 4), generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        z = w.model.encode(audio)
        zp = w.encode(audio)
        assert zp.shape == (2, 5, 1024 // 8 // 4)
        assert rel_rms(zp, torch.einsum("ij,bjt->bit", pca, z - mean[None, :, None])) < 1e-6
        full = torch.cat([zp, torch.zeros(2, 3, zp.shape[-1])], dim=1)   # the zero-filled dims
        basis = torch.cat([pca, torch.zeros(3, 8)])
        want = w.model.decode(torch.einsum("ji,bjt->bit", basis, full) + mean[None, :, None],
                              noise=noise)
        assert rel_rms(w.decode(zp, noise=noise), want) < 1e-6
