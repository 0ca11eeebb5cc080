"""MIRAGE: the command line (and optional Gradio GUI) over CLAPDAE.

    python -m audio_algebra_torch.mirage --text "low brass" --text "warm pad"
        [--audio a.wav ...] [--interp 0.5 | --algebra --weights 1,-0.5]
        [--cfg-scale 4] [--steps 150] [--outer-steps 100]
        [--init-audio x.flac --init-strength 0.4] [--batch-size 1]
        [--seed N] [--model 22s|66s] [--model-config kwargs.json]
        [--output-dir mirage_out] [--device cuda] [--turbo] [--gui [--share]]

Port of the root `mirage.py`: embed audio and text prompts with CLAP,
combine them by slerp or by the renormalised weighted sum, optionally start
from init-audio latents, generate by CFG latent diffusion, crossfade the
batch's variations into one take, and save it as a WAV with a 3-D PCA
cloud of the latents (.npy and an interactive .html). It runs on the card
unless `--device cpu` is given. `--seed` seeds the model's torch.Generator,
from which `CLAPDAE.generate` draws its noise.

`--mesh seq=N` runs the outer stage sequence-parallel over N processes,
one a card (`CLAPDAE.generate_seqpar`): every rank runs the CLI with the
same flags and rank 0 alone writes files,

    torchrun --nproc_per_node N -m audio_algebra_torch.mirage --mesh seq=N ...

Outside a group of N it raises and says so; `--init-audio` with `--mesh`
raises ValueError (the img2img resample is single-program, as in JAX).

`--turbo` builds the model on the int8 routes of its outer stage (JAX's
flag sets AA_TURBO_INT8=1; `CLAPDAE(turbo=True)`). The outer stage and the
AE decode run in micro-batches of AA_MIRAGE_DECODE_BATCH rows when it is
set, as JAX's CLI does (`CLAPDAE(decode_batch=)`, default 4; the model
cache keys on it). Under `--turbo` a micro-batch of 16 or more takes the
amax carry, a smaller one int8 inside the fold: so at the default each
runs in the fold whatever `--batch-size` is, and
`AA_MIRAGE_DECODE_BATCH=16 ... --turbo --batch-size 16` takes the carry.
`--turbo` is refused with `--mesh` (the sequence-parallel outer stage is
float only).
The XLA compile cache has no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .embedding_math import (TURBO_SEQPAR_REFUSAL, decode_batch_from_env, get_model_ready,
                             interp_embeddings, weighted_algebra)

SAMPLE_RATE = 48000


def unpack_audio_tup(audio_tup, verbose: bool = True):
    """(sr, int or float array (N,) or (N, C)) -> ((C, N) float32 at 48 kHz,
    restore info); integer PCM is scaled by its dtype's range, mono is
    doubled to stereo."""
    if audio_tup is None:
        return None, None
    sr, audio = audio_tup
    audio = np.asarray(audio)
    in_dtype = audio.dtype
    if np.issubdtype(in_dtype, np.integer):
        ii = np.iinfo(in_dtype)
        if ii.min < 0:
            audio = audio.astype(np.float32) / float(-int(ii.min))
        else:                                   # offset binary
            half = float(ii.max + 1) / 2.0
            audio = (audio.astype(np.float32) - half) / half
    audio = audio.astype(np.float32)
    mono_in = audio.ndim == 1
    if mono_in:
        audio = audio[:, None]
    audio = audio.T
    if audio.shape[0] == 1:
        audio = np.concatenate([audio, audio], axis=0)
    if sr != SAMPLE_RATE:
        from .ops.resample import resample_np
        audio = resample_np(audio, sr, SAMPLE_RATE)
    if verbose:
        print(f"unpack_audio_tup: sr={sr} shape={audio.shape}")
    return audio, {"sr": sr, "mono_in": mono_in, "dtype": str(in_dtype)}


def repack_audio_tup(audio, info, verbose: bool = True):
    """(C, N) float32 -> (48000, (N, C) int16), the GUI's audio tuple."""
    audio = np.clip(np.asarray(audio), -1, 1)
    out = (audio.T * 32767.0).astype(np.int16)
    if info and info.get("mono_in"):
        out = out[:, :1]
    if verbose:
        print(f"repack_audio_tup: shape={out.shape}")
    return (SAMPLE_RATE, out)


def process_audio(audio_tups: Sequence = (), text_prompts: Sequence[str] = (),
                  weights: Optional[Sequence[float]] = None,
                  interp_scale: float = 0.5, use_algebra: bool = False,
                  cfg_scale: float = 4.0, demo_steps: int = 150,
                  outer_steps: int = 100, init_audio_tup=None,
                  init_strength: float = 0.4, batch_size: int = 1,
                  seed: int = -1, model_choice: str = "22s",
                  output_dir: str = ".", verbose: bool = True,
                  model_kwargs: Optional[dict] = None, save_pca: bool = True,
                  mesh_spec: Optional[str] = None, device="cuda", turbo: bool = False):
    """Embed -> combine -> generate -> crossfade -> save. Returns (wav path,
    PCA .npy path or None, the (2, N) take). With `mesh_spec` ('seq=N', in
    a group of N processes) the outer stage runs sequence-parallel on the
    rank's card and only rank 0 writes files (the others return None
    paths). `turbo` generates on get_model_ready's turbo model;
    AA_MIRAGE_DECODE_BATCH, when set, is the model's outer micro-batch."""
    from .utils.audio_io import crossfade_flatten, save_audio
    from .utils.viz import pca_point_cloud, point_cloud_html

    world = None
    if mesh_spec:
        from .parallel.mesh import mesh_from_spec
        world = mesh_from_spec(mesh_spec, device=device, module="mirage")
        if world.axis != "seq":
            raise ValueError(f"--mesh {mesh_spec!r}: generation shards over a 'seq' axis "
                             "(e.g. --mesh seq=4)")
        if init_audio_tup is not None:
            raise ValueError("--mesh seq=N does not support --init-audio: the img2img "
                             "resample path is single-program; drop one flag")
        device = world.device
    model = get_model_ready(model_choice, device=device, verbose=verbose, turbo=turbo,
                            **decode_batch_from_env(), **(model_kwargs or {}))
    if seed >= 0:
        model.generator.manual_seed(seed)

    embeddings = []
    for tup in audio_tups:
        audio, _ = unpack_audio_tup(tup, verbose=verbose)
        if audio is not None:
            embeddings.append(model.embed(audio))
    for text in text_prompts:
        if text:
            embeddings.append(model.embed(text))
    if not embeddings:
        raise ValueError("no inputs: supply audio and/or text prompts")

    if len(embeddings) == 1:
        emb = embeddings[0]
    elif use_algebra:
        emb = weighted_algebra(embeddings, weights or [1.0] * len(embeddings))
    else:
        emb = interp_embeddings(embeddings[0], embeddings[1], interp_scale)
        for extra in embeddings[2:]:
            emb = interp_embeddings(emb, extra, interp_scale)

    init_latents = None
    if init_audio_tup is not None:
        init_audio, _ = unpack_audio_tup(init_audio_tup, verbose=verbose)
        need = model.sample_size
        reps = int(np.ceil(need / init_audio.shape[-1]))
        looped = np.tile(init_audio, (1, reps))[:, :need]          # loop-repeat
        init_latents = model.encode_audio_latents(looped[None])

    if world is not None:
        fakes, fake_latents = model.generate_seqpar(
            emb, world, cfg_scales=cfg_scale, demo_steps=demo_steps, outer_steps=outer_steps,
            batch_size=batch_size, flatten=False)
    else:
        fakes, fake_latents = model.generate(
            emb, cfg_scales=cfg_scale, demo_steps=demo_steps, outer_steps=outer_steps,
            init_audio_latents=init_latents, init_strength=init_strength,
            batch_size=batch_size, flatten=False)
    out = crossfade_flatten(fakes.float().cpu().numpy(), sr=SAMPLE_RATE)
    if world is not None and world.rank != 0:
        return None, None, out

    os.makedirs(output_dir, exist_ok=True)
    wav_path = str(Path(output_dir) / "mirage_out.wav")
    save_audio(wav_path, out, SAMPLE_RATE)
    pca_path = None
    if save_pca:
        cloud = pca_point_cloud(fake_latents, mean_axis=None)
        pca_path = str(Path(output_dir) / "mirage_latents_pca.npy")
        np.save(pca_path, cloud)
        point_cloud_html(cloud, title="MIRAGE latents (PCA)",
                         path=str(Path(output_dir) / "mirage_latents_pca.html"))
    if verbose:
        print(f"wrote {wav_path}" + (f" and {pca_path}" if pca_path else ""))
    return wav_path, pca_path, out


def load_examples_csv(path: str) -> list:
    """The GUI's preset rows from a CSV ([audio1, audio2, text1, text2,
    interp, cfg, steps, seed]); '#' rows are comments, '' and 'None' None."""
    import csv

    rows = []
    with open(os.path.expanduser(path)) as f:
        for row in csv.reader(f):
            row = [c.strip() for c in row]
            if row and not row[0].startswith("#"):
                rows.append([None if c in ("", "None") else c for c in row])
    return rows


def save_html_hosting_info(share_url: str, info_file: str = "mirage.html",
                           host_url: str = "https://example.org/mirage/") -> str:
    """Write the landing page that redirects to the (ephemeral) Gradio share
    URL after 2 s, with OpenGraph metadata, so a stable host URL can front
    the app."""
    share_url += "?__theme=dark"
    html = (
        "<DOCTYPE html>\n<html>\n  <head>\n  <title>MIRAGE Demo</title>\n"
        '  <meta charset="UTF-8" />\n'
        f'  <meta property="og:url" content="{host_url}">\n'
        f'  <meta property="og:image" content="{host_url}mirage_screenshot.png">\n'
        '  <meta property="og:title" content="Demo of MIRAGE">\n'
        '  <meta property="og:description" content="Music Information '
        'Retrieval-based Audio Generation via Entropy">\n'
        f'  <meta http-equiv="Refresh" content="2; url={share_url}" />\n'
        "  </head>\n  <body>\n  <h1>Redirecting</h1>\n"
        "  Redirecting in 2 seconds.  If you are not automatically "
        f'redirected, click <a href="{share_url}">here</a>.\n'
        "  </body>\n</html>"
    )
    print(f"Saving HTML forwarding info to {info_file}")
    with open(os.path.expanduser(info_file), "w") as f:
        f.write(html)
    return html


def run_gui(args) -> None:
    """The two-tab Gradio GUI (interpolation, algebra); Gradio is imported
    here, and without it the CLI is the way."""
    try:
        import gradio as gr
    except ImportError:
        print("mirage: gradio is not installed; use the CLI "
              "(python -m audio_algebra_torch.mirage --text '...' --output-dir out/)")
        return
    device = getattr(args, "device", "cuda")
    turbo = getattr(args, "turbo", False)

    def tab1(audio1, audio2, text1, text2, interp, cfg, steps, seed):
        wav, _, _ = process_audio(
            audio_tups=[a for a in (audio1, audio2) if a is not None],
            text_prompts=[t for t in (text1, text2) if t], interp_scale=interp,
            cfg_scale=cfg, demo_steps=int(steps), seed=int(seed), device=device,
            turbo=turbo)
        return wav

    def tab2(audio1, audio2, text1, text2, w1, w2, w3, w4, cfg, steps, seed):
        wav, _, _ = process_audio(
            audio_tups=[a for a in (audio1, audio2) if a is not None],
            text_prompts=[t for t in (text1, text2) if t], weights=[w1, w2, w3, w4],
            use_algebra=True, cfg_scale=cfg, demo_steps=int(steps), seed=int(seed),
            device=device, turbo=turbo)
        return wav

    with gr.Blocks(title="MIRAGE") as demo:
        with gr.Tab("Interpolation"):
            a1, a2 = gr.Audio(), gr.Audio()
            t1, t2 = gr.Textbox(label="text 1"), gr.Textbox(label="text 2")
            interp = gr.Slider(0, 1, 0.5, label="interp")
            cfg = gr.Slider(0, 15, 4, label="CFG scale")
            steps = gr.Slider(10, 250, 150, label="steps")
            seed = gr.Number(value=-1, label="seed")
            out1 = gr.Audio(label="result")
            gr.Button("Generate").click(tab1, [a1, a2, t1, t2, interp, cfg, steps, seed], out1)
            if os.path.exists(args.examples_csv):
                gr.Examples(examples=load_examples_csv(args.examples_csv),
                            inputs=[a1, a2, t1, t2, interp, cfg, steps, seed])
        with gr.Tab("Algebra"):
            b1, b2 = gr.Audio(), gr.Audio()
            s1, s2 = gr.Textbox(label="text 1"), gr.Textbox(label="text 2")
            ws = [gr.Slider(-2, 2, 1.0, label=f"w{i}") for i in range(4)]
            cfg2 = gr.Slider(0, 15, 4, label="CFG scale")
            steps2 = gr.Slider(10, 250, 150, label="steps")
            seed2 = gr.Number(value=-1, label="seed")
            out2 = gr.Audio(label="result")
            gr.Button("Generate").click(tab2, [b1, b2, s1, s2, *ws, cfg2, steps2, seed2], out2)
    auth = None
    if os.environ.get("MIRAGE_USERNAME"):
        auth = (os.environ["MIRAGE_USERNAME"], os.environ.get("MIRAGE_PASSWORD", ""))
    app = demo.launch(share=args.share, auth=auth, prevent_thread_lock=args.share)
    if args.share:
        share_url = getattr(app, "share_url", None) or getattr(demo, "share_url", "")
        if share_url:
            save_html_hosting_info(share_url, info_file=args.html_info_file)
        demo.block_thread()


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description="MIRAGE generator (PyTorch port)")
    p.add_argument("--audio", action="append", default=[], help="input audio file(s)")
    p.add_argument("--text", action="append", default=[], help="text prompt(s)")
    p.add_argument("--weights", type=str, default="", help="comma-separated algebra weights")
    p.add_argument("--interp", type=float, default=0.5)
    p.add_argument("--algebra", action="store_true")
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--outer-steps", type=int, default=100)
    p.add_argument("--init-audio", type=str, default=None)
    p.add_argument("--init-strength", type=float, default=0.4)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--model", choices=["22s", "66s"], default="22s")
    p.add_argument("--model-config", type=str, default=None,
                   help="JSON of CLAPDAE kwargs (custom model sizes)")
    p.add_argument("--output-dir", type=str, default="mirage_out")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--gui", action="store_true")
    p.add_argument("--share", action="store_true")
    p.add_argument("--examples-csv", type=str, default="mirage_examples.csv",
                   help="CSV of GUI preset rows")
    p.add_argument("--html-info-file", type=str, default="mirage.html",
                   help="where --share writes the redirect page")
    p.add_argument("--turbo", action="store_true",
                   help="int8 outer stage (JAX's AA_TURBO_INT8=1): each micro-batch of "
                        "4 runs its outer levels' convs int8 (the int8-in-fold route)")
    p.add_argument("--mesh", type=str, default=None, metavar="seq=N",
                   help="run the outer stage sequence-parallel over N processes, one a "
                        "card: torchrun --nproc_per_node N -m audio_algebra_torch.mirage "
                        "--mesh seq=N ...")
    args = p.parse_args(argv)
    if args.turbo and args.mesh:
        p.error(f"--turbo with --mesh: {TURBO_SEQPAR_REFUSAL}; drop one flag")
    if args.gui:
        run_gui(args)
        return {}

    from .device import resolve_device
    from .utils.audio_io import load_audio

    device = resolve_device(args.device)
    audio_tups = [(SAMPLE_RATE, load_audio(path, sr=SAMPLE_RATE).T) for path in args.audio]
    init_tup = None
    if args.init_audio:
        init_tup = (SAMPLE_RATE, load_audio(args.init_audio, sr=SAMPLE_RATE).T)
    weights = [float(w) for w in args.weights.split(",")] if args.weights else None
    model_kwargs = None
    if args.model_config:
        with open(args.model_config) as f:
            model_kwargs = json.load(f)
    wav, pca, _ = process_audio(
        audio_tups=audio_tups, text_prompts=args.text, weights=weights,
        interp_scale=args.interp, use_algebra=args.algebra, cfg_scale=args.cfg_scale,
        demo_steps=args.steps, outer_steps=args.outer_steps, init_audio_tup=init_tup,
        init_strength=args.init_strength, batch_size=args.batch_size, seed=args.seed,
        model_choice=args.model, output_dir=args.output_dir, model_kwargs=model_kwargs,
        mesh_spec=args.mesh, device=device, turbo=args.turbo)
    result = {"wav": wav, "pca": pca}
    if wav is not None:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
