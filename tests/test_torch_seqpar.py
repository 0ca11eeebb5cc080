"""The port's sequence-parallel decodes and multi-rank encodes against the
JAX package, on the CPU: one group of 4 `gloo` worker processes (this file
run as a script, `python tests/test_torch_seqpar.py RANK DIR PORT`, torch
only) runs every multi-rank case once and writes what it got; the tests
hold that against JAX and against one process.

  * conv1d_seq for K = 1, 2, 4, 5 (the even kernels split their halo as
    XLA's SAME does) against JAX's conv1d_seq on 4 virtual devices (exact
    up to f32 rounding: atol 1e-6);
  * groupnorm1_seq with GELU on and off and resconv_block_seq against
    JAX's unsharded groupnorm1_gelu_btc and ResConvBlock (f32, 1e-5);
  * K1's split route in one process: S = 2, 4, 8 slabs of one tensor with
    their partials summed, against the whole K1 twin (f32 1e-6, bf16 one
    rounding) and JAX's groupnorm1_gelu_btc;
  * pick_sharded_levels against JAX's over a table;
  * decode_unet_seqpar for JAX's two `test_seqpar_unet.CFGS` (attn-cond,
    plain) on 2 ranks (a subgroup) and 4, with auto levels and
    sharded_levels=0, against JAX's unsharded DiffusionAttnUnet1D.apply on
    the same flax params (f32 rel-RMS < 1e-5);
  * DVAEWrapper.decode_seqpar and CLAPDAE.generate_seqpar at tiny configs,
    with the same noises, against JAX's decode and generate (f32, 1e-4 of
    the peak: test_torch_destructo's and test_torch_mirage's bound);
  * the CLIs on the same group against one process: destructo
    --num-devices 4 on 6 chunks (2 zero chunks of pad; f32 1e-5), and
    xae_dataset --encode (batches padded by repeating rows; f32, XAE_ATOL:
    the encoder's convolutions round by batch size), mirage --mesh seq=4
    (its bf16 model, MIRAGE_BF16_REL_RMS), and serve --mesh seq=4 (f32)
    answering 2 HTTP requests (a seeded one and one through the
    micro-batcher) through the follower loop, then stopping (the 16-bit
    PCM's step).

JAX's own seqpar test (test_seqpar_unet.py) is slow on the CPU; the port
is held to JAX's unsharded model instead, which that test holds JAX's
seqpar to within 1e-6. The workers have WORKER_TIMEOUT_S each.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

RANKS = 4
WORKER_TIMEOUT_S = 150
CONV_KS = (1, 2, 4, 5)
UNET_CFGS = {   # JAX's tests/test_seqpar_unet.CFGS
    "attn-cond": dict(io_channels=2, cond_dim=4, n_attn_layers=1, c_mults=(8, 8, 16, 16)),
    "plain": dict(io_channels=4, cond_dim=0, n_attn_layers=0, c_mults=(8, 16)),
}
UNET_T = 512
UNET_REL_RMS = 1e-5
MODULE_TOL = 1e-5            # f32 conv / GN / block against JAX, atol and rtol
MODEL_TOL = 1e-4             # f32 decodes after a few sampler steps, of the peak
XAE_ATOL = 1e-5              # f32 tanh latents, encoded in batches of other sizes
MIRAGE_BF16_REL_RMS = 5e-2   # chip_smoke's MIRAGE bf16 bound (MIRAGE_REL_RMS_BOUND)
DVAE_KWARGS = dict(capacity=4, c_mults=(2, 4), strides=(4, 2), n_attn_layers=1,
                   diffusion_c_mults=(128, 128, 256))
DVAE_ARGS = {"sample_size": 1024, "latent_dim": 8, "demo_steps": 3}
FIRST_STAGE = {"capacity": 4, "c_mults": [2, 4], "strides": [2, 2], "latent_dim": 8}
MIRAGE_KWARGS = dict(second_stage_latent_dim=4, factors=[2, 2], latent_channels=8,
                     latent_multipliers=[1, 2, 2], latent_num_blocks=[1, 1],
                     diffusion_c_mults=[8, 16], diffusion_depth=2, channels=8,
                     multipliers=[1, 2], factors2=[2], num_blocks=[1],
                     attentions=[0, 1], attention_heads=2, attention_features=16)
GEN_SAMPLES = 8192           # stage-1 latents of 2048 samples: 512 a rank
CLI_SAMPLES = 4096
CHUNK = 1024


# --------------------------------------------------------------- inputs ---

def _rng(seed):
    return np.random.default_rng(seed)


def _conv_inputs(k):
    rng = _rng(10 + k)
    return (rng.standard_normal((2, 6, 64)).astype(np.float32),
            (rng.standard_normal((k, 6, 5)) / np.sqrt(6 * k)).astype(np.float32))


def _gn_inputs():
    rng = _rng(20)
    return ((1.5 * rng.standard_normal((2, 8, 64)) + 0.3).astype(np.float32),
            (1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
            (0.2 * rng.standard_normal(8)).astype(np.float32))


def _unet_inputs(cfg):
    rng = _rng(30)
    x = rng.standard_normal((2, cfg["io_channels"], UNET_T)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    cond = rng.standard_normal((2, 4, 16)).astype(np.float32) if cfg["cond_dim"] else None
    return x, t, cond


def _decode_inputs():
    rng = _rng(40)
    return (np.tanh(rng.standard_normal((3, 8, 128))).astype(np.float32),
            rng.standard_normal((3, 2, CHUNK)).astype(np.float32))


def _unit(rng):
    e = rng.standard_normal((1, 1, 512)).astype(np.float32)
    return e / np.linalg.norm(e)


def _generate_inputs():
    rng = _rng(50)
    return (_unit(rng), rng.standard_normal((1, 4, GEN_SAMPLES // 16)).astype(np.float32),
            rng.standard_normal((1, 8, GEN_SAMPLES // 4)).astype(np.float32))


def _serve_specs():
    rng = _rng(60)
    return [{"embeddings": _unit(rng)[0].tolist(), "steps": 2, "outer_steps": 2, "seed": 0},
            {"embeddings": _unit(rng)[0].tolist(), "steps": 2, "outer_steps": 1}]


def _mirage_config() -> dict:
    from audio_algebra_torch.models import clap as tclap
    return dict(sample_size=CLI_SAMPLES, first_stage_config=FIRST_STAGE,
                model_kwargs=MIRAGE_KWARGS,
                clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                 text_cfg=dict(tclap.TINY_TEXT_CFG)))


def _tiny_clapdae(tmp, sample_size):
    from audio_algebra_torch.given_models import CLAPDAE
    from audio_algebra_torch.models import clap as tclap

    m = CLAPDAE(sample_size=sample_size, first_stage_config=FIRST_STAGE,
                model_kwargs=MIRAGE_KWARGS, device="cpu",
                clap_kwargs=dict(audio_cfg=dict(tclap.TINY_AUDIO_CFG),
                                 text_cfg=dict(tclap.TINY_TEXT_CFG)))
    m.latent_diffae.load_state_dict(torch.load(Path(tmp) / "diffae.pt"))
    m.latent_diffusion_model.load_state_dict(torch.load(Path(tmp) / "ldm.pt"))
    m._place()
    return m


def _tiny_dvae(tmp):
    from audio_algebra_torch.given_models import DVAEWrapper

    w = DVAEWrapper(args_dict=DVAE_ARGS, model_kwargs=DVAE_KWARGS, device="cpu")
    w.model.load_state_dict(torch.load(Path(tmp) / "dvae.pt"))
    w._loaded = True
    return w


def _cli_argv(tmp):
    tmp = Path(tmp)
    return {
        "destructo": [str(tmp / "in.wav"), "--op", "destructo", "--steps", "2",
                      "--chunk-size", str(CHUNK), "--model-config", str(tmp / "dvae.json"),
                      "--device", "cpu", "--dtype", "float32"],
        "xae": ["--source-dir", str(tmp / "src"), "--chunk-size", "4096", "--knob-steps", "3",
                "--effects", "Clean,Gain", "--normalize", "maxabs", "--encode",
                "--encode-batch", "5", "--model-config", str(tmp / "xae.json"),
                "--device", "cpu"],
        "mirage": ["--text", "a", "--text", "b", "--steps", "2", "--outer-steps", "2",
                   "--seed", "0", "--model-config", str(tmp / "mirage.json"),
                   "--device", "cpu"],
    }


def run_serve(tmp, world_spec: str | None, rank: int = 0):
    """The service around the tiny CLAPDAE: rank 0 answers the two specs
    over HTTP (the second through the micro-batcher) and closes; other
    ranks follow. Returns the answers' PCM (rank 0) or the follower's
    count."""
    import threading
    import urllib.request

    from audio_algebra_torch import serve as tserve
    from audio_algebra_torch.utils.audio_io import read_wav

    svc = tserve.MirageService(model=_tiny_clapdae(tmp, CLI_SAMPLES), verbose=False,
                               device="cpu", batch_window_s=0.01, mesh_spec=world_spec)
    if rank != 0:
        return {"followed": svc.follow()}
    server = tserve.make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    pcm = []
    try:
        for i, spec in enumerate(_serve_specs()):
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}"
                                         "/generate", data=json.dumps(spec).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                path = Path(tmp) / f"serve_{world_spec}_{i}.wav"
                path.write_bytes(r.read())
            pcm.append(read_wav(path)[0])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        svc.close()
    return {"pcm": pcm, "batched_runs": svc.health().get("batched_runs")}


# --------------------------------------------------------------- worker ---

def worker(rank: int, tmp: str, port: int) -> None:
    import torch.distributed as dist
    from audio_algebra_torch import destructo, mirage, xae_dataset
    from audio_algebra_torch.models.blocks import ResConvBlock
    from audio_algebra_torch.models.unet1d import DiffusionAttnUnet1D
    from audio_algebra_torch.parallel.infer import decode_unet_seqpar, pick_sharded_levels
    from audio_algebra_torch.parallel.mesh import World, make_mesh
    from audio_algebra_torch.parallel.multihost import initialize_distributed
    from audio_algebra_torch.parallel.seq import conv1d_seq, groupnorm1_seq, resconv_block_seq

    torch.set_num_threads(1)
    tmp = Path(tmp)
    assert initialize_distributed(f"localhost:{port}", RANKS, rank, backend="gloo")
    out, info = {}, {}
    try:
        w4 = make_mesh(axis_names=("seq",), shape=(RANKS,), device="cpu")
        sub = dist.new_group([0, 1])
        w2 = World(2, rank, torch.device("cpu"), axis="seq", group=sub) if rank < 2 else None
        with torch.no_grad():
            for k in CONV_KS:
                x, kern = _conv_inputs(k)
                weight = torch.from_numpy(kern.transpose(2, 1, 0).copy())
                local = torch.from_numpy(x)[..., w4.slab(x.shape[-1])]
                out[f"conv{k}"] = w4.all_gather_time(conv1d_seq(local, weight, None, w4))
            x, scale, bias = (torch.from_numpy(a) for a in _gn_inputs())
            for gelu in (True, False):
                out[f"gn_gelu{int(gelu)}"] = w4.all_gather_time(
                    groupnorm1_seq(x[..., w4.slab(x.shape[-1])], scale, bias, w4, gelu=gelu))
            block = ResConvBlock(8, 8, 8)
            block.load_state_dict(torch.load(tmp / "block.pt"))
            out["block"] = w4.all_gather_time(resconv_block_seq(x[..., w4.slab(64)], block, w4))
            for name, cfg in UNET_CFGS.items():
                unet = DiffusionAttnUnet1D(**cfg).eval()
                unet.load_state_dict(torch.load(tmp / f"unet_{name}.pt"))
                x, t, cond = (None if a is None else torch.from_numpy(a)
                              for a in _unet_inputs(cfg))
                for world in (w2, w4):
                    if world is None:
                        dist.barrier()            # ranks 2, 3 wait out the pair's cases
                        continue
                    for levels in (None, 0):
                        v = decode_unet_seqpar(unet, x[..., world.slab(UNET_T)], t, cond,
                                               world, sharded_levels=levels)
                        key = f"unet_{name}_{world.size}_{'auto' if levels is None else 0}"
                        out[key] = world.all_gather_time(v)
                    info[f"levels_{name}_{world.size}"] = pick_sharded_levels(
                        UNET_T, world.size, unet.depth,
                        unet.depth - cfg["n_attn_layers"])
                    if world is w2:
                        dist.barrier()
        reps, noise = _decode_inputs()
        dvae = _tiny_dvae(tmp)
        dvae.noise = torch.from_numpy(noise)
        out["decode_seqpar"] = dvae.decode_seqpar(reps, w4)
        emb, latent_noise, s1_noise = _generate_inputs()
        fakes, lat = _tiny_clapdae(tmp, GEN_SAMPLES).generate_seqpar(
            emb, w4, cfg_scales=2, demo_steps=3, outer_steps=2, latent_noise=latent_noise,
            s1_noise=s1_noise)
        out["generate_seqpar"], out["generate_seqpar_latents"] = fakes, lat

        argv = _cli_argv(tmp)
        out["destructo"] = torch.from_numpy(destructo.main(
            [*argv["destructo"], "--out", str(tmp / "destructo_4.wav"), "--num-devices", "4"]))
        info["xae"] = xae_dataset.main([*argv["xae"], "--out-dir", str(tmp / "xae_4"),
                                        "--num-devices", "4"])
        info["mirage"] = mirage.main([*argv["mirage"], "--output-dir", str(tmp / "mirage_4"),
                                      "--mesh", "seq=4"])
        serve = run_serve(tmp, "seq=4", rank)
        if rank == 0:
            out.update({f"serve{i}": torch.from_numpy(p) for i, p in enumerate(serve["pcm"])})
            info["serve_batched_runs"] = serve["batched_runs"]
        else:
            info["followed"] = serve["followed"]
    finally:
        dist.destroy_process_group()
    np.savez(tmp / f"seqpar_{rank}.npz", **{k: v.float().numpy() for k, v in out.items()})
    (tmp / f"seqpar_{rank}.json").write_text(json.dumps(info, default=str))


# --------------------------------------------------------------- parent ---

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_inputs(tmp: Path) -> dict:
    """Flax trees of every model (saved as the port's state dicts), the CLIs'
    audio and configs. Returns the trees, for JAX's side."""
    import jax.numpy as jnp
    from audio_algebra_tpu.given_models import CLAPDAE as JCLAPDAE
    from audio_algebra_tpu.models.blocks import ResConvBlock as JResConvBlock
    from audio_algebra_tpu.models.clap import TINY_AUDIO_CFG, TINY_TEXT_CFG
    from audio_algebra_tpu.models.dvae import DiffusionDVAE as JDVAE
    from audio_algebra_tpu.models.unet1d import DiffusionAttnUnet1D as JUnet
    from audio_algebra_torch.given_models import CLAPDAE
    from audio_algebra_torch.models.blocks import ResConvBlock
    from audio_algebra_torch.models.dvae import DiffusionDVAE
    from audio_algebra_torch.models.unet1d import DiffusionAttnUnet1D
    from audio_algebra_torch.utils.audio_io import write_wav
    from audio_algebra_torch.utils.params import load_flax_params
    from test_torch_blocks import rand_tree

    trees = {"block": rand_tree(JResConvBlock(8, 8), 1, jnp.zeros((2, 64, 8)))}
    torch.save(load_flax_params(ResConvBlock(8, 8, 8), trees["block"]).state_dict(),
               tmp / "block.pt")
    for name, cfg in UNET_CFGS.items():
        x, t, cond = _unet_inputs(cfg)
        trees[name] = rand_tree(JUnet(**cfg), 2, jnp.asarray(x), jnp.asarray(t),
                                None if cond is None else jnp.asarray(cond))
        torch.save(load_flax_params(DiffusionAttnUnet1D(**cfg), trees[name]).state_dict(),
                   tmp / f"unet_{name}.pt")
    trees["dvae"] = rand_tree(JDVAE(latent_dim=8, **DVAE_KWARGS), 11,
                              jnp.zeros((1, 2, CHUNK)), jnp.zeros((1,)))
    torch.save(load_flax_params(DiffusionDVAE(latent_dim=8, **DVAE_KWARGS),
                                trees["dvae"]).state_dict(), tmp / "dvae.pt")
    jw = JCLAPDAE(sample_size=GEN_SAMPLES, first_stage_config=FIRST_STAGE,
                  model_kwargs={k: tuple(v) if isinstance(v, list) else v
                                for k, v in MIRAGE_KWARGS.items()},
                  clap_kwargs=dict(audio_cfg=dict(**TINY_AUDIO_CFG),
                                   text_cfg=dict(**TINY_TEXT_CFG)))
    trees["diffae"] = rand_tree(jw.latent_diffae, 1, jnp.zeros((1, 2, 1024)), jnp.zeros((1,)))
    trees["ldm"] = rand_tree(jw.latent_diffusion_model, 2, jnp.zeros((1, 4, 64)),
                             jnp.zeros((1,)), jnp.zeros((1, 1, 512)))
    trees["jclapdae"] = jw
    tw = CLAPDAE(sample_size=GEN_SAMPLES, first_stage_config=FIRST_STAGE,
                 model_kwargs=MIRAGE_KWARGS, device="cpu")
    tw.load_flax_params(trees["diffae"], trees["ldm"])
    torch.save(tw.latent_diffae.state_dict(), tmp / "diffae.pt")
    torch.save(tw.latent_diffusion_model.state_dict(), tmp / "ldm.pt")

    rng = _rng(70)
    write_wav(tmp / "in.wav", (0.3 * rng.standard_normal((2, 6 * CHUNK - 100)))
              .astype(np.float32), 48000)
    (tmp / "dvae.json").write_text(json.dumps({"model_kwargs": DVAE_KWARGS,
                                               "args_dict": {"latent_dim": 8}}))
    (tmp / "xae.json").write_text(json.dumps({
        "model_kwargs": {"capacity": 4, "c_mults": [2, 4], "strides": [4, 2],
                         "n_attn_layers": 0, "diffusion_c_mults": [8, 16]},
        "args_dict": {"latent_dim": 8}}))
    (tmp / "mirage.json").write_text(json.dumps(_mirage_config()))
    (tmp / "src").mkdir()
    tt = np.arange(9000) / 44100
    for i, f0 in enumerate((220, 330)):
        x = np.stack([0.4 * np.sin(2 * np.pi * f0 * tt), 0.3 * np.sin(2 * np.pi * 1.5 * f0 * tt)])
        write_wav(tmp / "src" / f"s{i}.wav",
                  (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), 44100)
    return trees


def _jax_references(tmp: Path, trees: dict, monkeypatch_host_normal) -> dict:
    """JAX's side of every case."""
    import jax.numpy as jnp
    from audio_algebra_tpu import given_models as jgm
    from audio_algebra_tpu.models.blocks import ResConvBlock as JResConvBlock
    from audio_algebra_tpu.models.unet1d import DiffusionAttnUnet1D as JUnet
    from audio_algebra_tpu.ops.pallas.groupnorm import groupnorm1_gelu_btc
    from audio_algebra_tpu.parallel.mesh import make_mesh as jmake_mesh
    from audio_algebra_tpu.parallel.seq import conv1d_seq as jconv1d_seq

    ref = {}
    mesh = jmake_mesh(n_devices=RANKS, axis_names=("seq",))
    for k in CONV_KS:
        x, kern = _conv_inputs(k)
        ref[f"conv{k}"] = np.asarray(jconv1d_seq(jnp.asarray(x.transpose(0, 2, 1)),
                                                 jnp.asarray(kern), mesh, "seq")
                                     ).transpose(0, 2, 1)
    x, scale, bias = _gn_inputs()
    x_btc = jnp.asarray(x.transpose(0, 2, 1))
    for gelu in (True, False):
        ref[f"gn_gelu{int(gelu)}"] = np.asarray(groupnorm1_gelu_btc(
            x_btc, jnp.asarray(scale), jnp.asarray(bias), gelu=gelu)).transpose(0, 2, 1)
    ref["block"] = np.asarray(JResConvBlock(8, 8).apply({"params": trees["block"]}, x_btc)
                              ).transpose(0, 2, 1)
    for name, cfg in UNET_CFGS.items():
        x, t, cond = (None if a is None else jnp.asarray(a) for a in _unet_inputs(cfg))
        ref[f"unet_{name}"] = np.asarray(JUnet(**cfg).apply({"params": trees[name]}, x, t,
                                                            cond))
    reps, noise = _decode_inputs()
    jw = jgm.DVAEWrapper(args_dict=DVAE_ARGS, model_kwargs=DVAE_KWARGS, debug=False)
    jw.params = jw.params_ema = {"params": trees["dvae"]}
    jw.noise = jnp.asarray(noise)
    ref["decode"] = np.asarray(jw.decode(jnp.asarray(reps)))
    emb, latent_noise, s1_noise = _generate_inputs()
    jc = trees["jclapdae"]
    jc.diffae_params, jc.ldm_params = {"params": trees["diffae"]}, {"params": trees["ldm"]}
    left = monkeypatch_host_normal([latent_noise, s1_noise])
    fakes, lat = jc.generate(jnp.asarray(emb), cfg_scales=2, demo_steps=3, outer_steps=2)
    assert not left
    ref["generate"], ref["generate_latents"] = np.asarray(fakes), np.asarray(lat)
    return ref


def _one_process(tmp: Path) -> dict:
    """The CLIs in this process, no group."""
    from audio_algebra_torch import destructo, embedding_math, mirage, xae_dataset
    from audio_algebra_torch.utils.audio_io import read_wav

    argv = _cli_argv(tmp)
    one = {"destructo": destructo.main([*argv["destructo"], "--out",
                                        str(tmp / "destructo_1.wav")])}
    xae_dataset.main([*argv["xae"], "--out-dir", str(tmp / "xae_1")])
    cache = dict(embedding_math._model_cache)
    try:
        mirage.main([*argv["mirage"], "--output-dir", str(tmp / "mirage_1")])
    finally:
        embedding_math._model_cache.clear()
        embedding_math._model_cache.update(cache)
    one["mirage"] = read_wav(tmp / "mirage_1" / "mirage_out.wav")[0]
    one["serve"] = run_serve(tmp, None)["pcm"]
    return one


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the 4 workers once, and meanwhile JAX's side and the one-process
    CLIs here; returns (rank results, infos, JAX references, one-process
    results, tmp)."""
    from audio_algebra_tpu import given_models as jgm

    tmp = tmp_path_factory.mktemp("seqpar")
    trees = _write_inputs(tmp)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(root / "tests")]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(tmp), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=str(tmp)) for rank in range(RANKS)]
    original = jgm.host_normal

    def feed(arrays):
        queue = list(arrays)

        def fake(key, shape, dtype=None):
            arr = queue.pop(0)
            assert arr.shape == tuple(shape)
            return arr
        jgm.host_normal = fake
        return queue

    logs = []
    try:
        ref = _jax_references(tmp, trees, feed)
        jgm.host_normal = original
        one = _one_process(tmp)
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append(out)
    finally:
        jgm.host_normal = original
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    ranks = [dict(np.load(tmp / f"seqpar_{r}.npz")) for r in range(RANKS)]
    infos = [json.loads((tmp / f"seqpar_{r}.json").read_text()) for r in range(RANKS)]
    return {"ranks": ranks, "infos": infos, "ref": ref, "one": one, "tmp": tmp}


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30)))


def _rel_peak(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("k", CONV_KS)
def test_conv1d_seq_is_jax_conv1d_seq(group, k):
    np.testing.assert_allclose(group["ranks"][0][f"conv{k}"], group["ref"][f"conv{k}"],
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("gelu", [True, False])
def test_groupnorm1_seq_is_the_whole_rows_groupnorm(group, gelu):
    key = f"gn_gelu{int(gelu)}"
    np.testing.assert_allclose(group["ranks"][0][key], group["ref"][key], atol=MODULE_TOL,
                               rtol=MODULE_TOL)


def test_resconv_block_seq_is_jax_resconv_block(group):
    np.testing.assert_allclose(group["ranks"][0]["block"], group["ref"]["block"],
                               atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("name", list(UNET_CFGS))
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("levels", ["auto", "0"])
def test_decode_unet_seqpar_is_jax_unsharded_unet(group, name, ranks, levels):
    got = group["ranks"][0][f"unet_{name}_{ranks}_{levels}"]
    assert _rel_rms(got, group["ref"][f"unet_{name}"]) < UNET_REL_RMS
    chosen = group["infos"][0][f"levels_{name}_{ranks}"]
    assert 0 < chosen <= len(UNET_CFGS[name]["c_mults"]) - max(
        1, UNET_CFGS[name]["n_attn_layers"])


def test_ranks_hold_the_same_gathered_results(group):
    """Every rank of the world of 4 holds the same gathered outputs."""
    r0 = group["ranks"][0]
    for other in group["ranks"][1:]:
        for k in ("conv4", "gn_gelu1", "block", "unet_attn-cond_4_auto", "decode_seqpar",
                  "generate_seqpar", "destructo"):
            assert np.array_equal(r0[k], other[k]), k


def test_pick_sharded_levels_is_jax():
    from audio_algebra_tpu.parallel.infer import pick_sharded_levels as jpick
    from audio_algebra_torch.parallel.infer import pick_sharded_levels

    table = [(t_len, n, depth, attn) for t_len in (64, 512, 1024, 65536, 1000)
             for n in (1, 2, 4, 8) for depth in (2, 4, 14) for attn in (0, 1, 2, 10)]
    for row in table:
        assert pick_sharded_levels(*row) == jpick(*row), row
    assert pick_sharded_levels(65536, 8, 14, 10) == 10 and pick_sharded_levels(32768, 1, 5, 5) == 4


def test_decode_seqpar_is_jax_decode(group):
    got = group["ranks"][0]["decode_seqpar"]
    assert got.shape == (2, 3 * CHUNK)
    assert _rel_peak(got, group["ref"]["decode"]) < MODEL_TOL


def test_generate_seqpar_is_jax_generate(group):
    r0, ref = group["ranks"][0], group["ref"]
    assert r0["generate_seqpar"].shape == (2, GEN_SAMPLES)
    assert _rel_peak(r0["generate_seqpar_latents"], ref["generate_latents"]) < MODEL_TOL
    assert _rel_peak(r0["generate_seqpar"], ref["generate"]) < MODEL_TOL


def test_destructo_num_devices_is_one_process(group):
    """6 chunks over 4 ranks (2 zero chunks of pad, dropped): one process's
    output, from its rows of one process's noise; rank 0 alone writes."""
    tmp = group["tmp"]
    got = group["ranks"][0]["destructo"]
    assert got.shape == (2, 6 * CHUNK)
    np.testing.assert_allclose(got, group["one"]["destructo"], rtol=1e-5, atol=1e-6)
    from audio_algebra_torch.utils.audio_io import read_wav
    np.testing.assert_allclose(read_wav(tmp / "destructo_4.wav")[0],
                               read_wav(tmp / "destructo_1.wav")[0], atol=2 / 32767)


def test_xae_encode_over_ranks_is_one_process(group):
    tmp = group["tmp"]
    assert [i["xae"]["world"] for i in group["infos"]] == [[4, r] for r in range(RANKS)]
    for name in ("Clean", "Gain"):
        got, want = np.load(tmp / "xae_4" / f"emb_{name}.npy"), \
            np.load(tmp / "xae_1" / f"emb_{name}.npy")
        assert got.shape == want.shape and got.shape[:2] == (4, 1 if name == "Clean" else 3)
        # f32: the encoder's convolutions round by the batch's size on the CPU
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=XAE_ATOL)
    assert (tmp / "xae_4" / "manifest.json").read_text() == \
        (tmp / "xae_1" / "manifest.json").read_text()


def test_mirage_mesh_is_one_process(group):
    """mirage --mesh seq=4: rank 0 alone writes; the take is one process's
    to MIRAGE's bf16 bound (the CLI's model is bf16, and the split
    GroupNorm's sums differ in order: a flipped bf16 rounding grows over
    the sampler's steps)."""
    from audio_algebra_torch.utils.audio_io import read_wav

    tmp = group["tmp"]
    infos = group["infos"]
    assert infos[0]["mirage"]["wav"] and all(i["mirage"]["wav"] is None for i in infos[1:])
    got = read_wav(tmp / "mirage_4" / "mirage_out.wav")[0]
    assert got.shape == group["one"]["mirage"].shape == (2, CLI_SAMPLES)
    assert _rel_rms(got, group["one"]["mirage"]) < MIRAGE_BF16_REL_RMS


def test_serve_mesh_answers_through_the_followers(group):
    """serve --mesh seq=4: two requests answered (the seeded one and one
    through the micro-batcher), each by every rank's generate_seqpar, then
    the followers stop; the answers are one process's (f32 model: equal to
    the 16-bit PCM's step)."""
    infos, r0 = group["infos"], group["ranks"][0]
    assert [i["followed"] for i in infos[1:]] == [2, 2, 2]
    assert infos[0]["serve_batched_runs"] == 1
    for i, want in enumerate(group["one"]["serve"]):
        assert r0[f"serve{i}"].shape == want.shape == (2, CLI_SAMPLES)
        np.testing.assert_allclose(r0[f"serve{i}"], want, atol=1.5 / 32767, rtol=0)


# ------------------------------------------------- K1 split, one process ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slabs", [2, 4, 8])
@pytest.mark.parametrize("residual", [False, True])
def test_k1_split_over_slabs_is_k1_whole(dtype, slabs, residual):
    """One tensor cut into S time slabs: the split twin with the slabs'
    partials summed, against K1's twin on the whole tensor (f32 1e-6; bf16
    within one bf16 rounding) and, in f32, JAX's groupnorm1_gelu_btc."""
    import jax.numpy as jnp
    from audio_algebra_tpu.ops.pallas.groupnorm import groupnorm1_gelu_btc
    from audio_algebra_torch.ops import groupnorm as gn

    dt = getattr(torch, dtype)
    rng = _rng(80 + slabs)
    x = torch.from_numpy((1.5 * rng.standard_normal((2, 16, 256)) + 0.2).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((2, 16, 256)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.3 * rng.standard_normal(16)).astype(np.float32))
    bias = torch.from_numpy((0.2 * rng.standard_normal(16)).astype(np.float32))
    x, res, scale, bias = (a.to(dt) for a in (x, res, scale, bias))
    r = res if residual else None
    per = 256 // slabs
    sums = []

    def collect(tensors):                 # each slab's partials, as a rank holds them
        sums.append(tensors[0].clone())

    for s in range(slabs):
        gn.groupnorm1_gelu_sharded_ref(x[..., s * per:(s + 1) * per].contiguous(), scale,
                                       bias, True, reduce_sum_=collect)
    total = torch.stack(sums).sum(0)      # what the all_reduce over the ranks gives

    def reduce_sum_(tensors):
        tensors[0].copy_(total)

    got = torch.cat([gn.groupnorm1_gelu_sharded(
        x[..., s * per:(s + 1) * per].contiguous(), scale, bias, True,
        None if r is None else r[..., s * per:(s + 1) * per].contiguous(),
        reduce_sum_=reduce_sum_, n_ranks=slabs) for s in range(slabs)], -1)
    want = gn.groupnorm1_gelu_ref(x, scale, bias, True, r)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
        jw = groupnorm1_gelu_btc(jnp.asarray(x.numpy().transpose(0, 2, 1)),
                                 jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
                                 gelu=True, residual=None if r is None else
                                 jnp.asarray(r.numpy().transpose(0, 2, 1)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jw).transpose(0, 2, 1),
                                   atol=MODULE_TOL, rtol=MODULE_TOL)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2 ** -7 * want.float().abs() + 1e-2).all())


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]))
