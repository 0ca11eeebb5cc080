#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

Runs from the root of a checkout of the repository, on a machine with a
CUDA card (sm_90a: H100). It imports nothing of JAX or of the JAX package.
Phases, each printing one JSON line:

  build         compile every CUDA source of audio_algebra_torch/csrc with
                nvcc, all started together
  kernels       hold each kernel against its plain PyTorch twin on the card,
                at the main paths' shapes, and time it beside the twin, one
                PyTorch library call and its bound: K1 (fused GroupNorm(1)
                [+GELU] [+residual]), K3 (rel-pos flash attention; each row
                also on the device alone) and K5 (grouped GroupNorm + FiLM
                + SiLU; each row on the device alone, with the wrapper's
                host microseconds a call, the route the planner chose and a
                same-bits check of two launches)
  kernels (K1 split)  K1's two passes apart (aa_groupnorm1_stats,
                aa_groupnorm1_apply), the sequence-parallel decodes'
                GroupNorm: (4, 256, 65536) bf16 and f32, with and without a
                residual, cut along T into 2, 4 and 8 slabs in one process,
                the slabs' partials summed between the passes; against K1 on
                the whole tensor and the twin (TOL), timed beside K1 whole,
                the twin, the library chain and K1's byte bound
  model         one full-width Destructo UNet forward, (2, 2, 16384) bf16,
                through K1 and through the twin with the same weights:
                rel-RMS under a bound
  destructo     the Destructo pipeline at the reference width in bf16 with
                seeded random weights: a 44.1 kHz WAV is loaded, resampled
                and chunked into 4 x 65536 samples, encoded, negated and
                decoded in 35 v-DDIM steps; K1 must launch 35 x 191 times
  kernels (K2)  the turbo GroupNorm modes (int8 emit, residual + amax, +
                int8 twin) against their twins at the turbo decode's level
                0 and 2 shapes, each timed beside the twin, the library
                chain and its byte bound, with the rate it reached (TB/s of
                the bound's bytes); and the int8 conv against the bf16 cuDNN
                conv at level 0
  destructo_turbo  the same pipeline at B = 16 x 65536 chunks, decoded in 35
                steps once in bf16 and once through the turbo int8 route with
                the amax carry, from the same noise: both realtime factors,
                the rel-RMS between the decodes (< 0.08), and the K1/K2
                launch counts of the turbo decode
  mirage_model  one full-width MIRAGE UNetCFG1d forward (songs config, CFG
                scale 4, batch 1 -> 2, T = 2048) in f32 and bf16, through K3
                and K5 and through their twins with the same weights:
                rel-RMS under a bound; 4 K3 and 63 K5 launches
  mirage        CLAPDAE().half() at full width with seeded random weights:
                22 s (1,048,576 samples), batch 1, CFG 4, 150 DPM++(2M)
                inner steps and 100 v-DDIM outer steps, from the weighted
                algebra of two seeded unit embeddings, run twice; K3, K5 and
                K1 must launch 150 x 4, 150 x 63 and 100 x 119 times, every
                K5 launch on its one-launch cluster route
  mirage_turbo  the mirage phase's model turned turbo (CLAPDAE.turbo): a
                batch-1 generate (150 + 100 steps) from that phase's noises,
                int8 inside the fold (7 of 10 outer levels' conv5s on a
                dynamic amax, K1 for every GroupNorm), against the bf16
                generate (rel-RMS in (1e-4, 0.08)) with stage seconds beside
                the bf16 ones; one outer forward in that mode through K1
                against K1's twin (< 5e-2); a batch-4 generate at 20 + 10
                steps (9 levels); 16 rows at 10 + 10 steps from seeded
                noises with CLAPDAE.decode_batch 16 (JAX's
                AA_MIRAGE_DECODE_BATCH=16: the outer stage on the amax carry,
                K2a/b/c), 4 (int8 in the fold) and in bf16, each turbo run
                against the bf16 one (rel-RMS in (1e-4, 0.08)), the outer s a
                row and peak memory of each; StackedDiffAEWrapper(turbo=True)
                at its default width, decode_stage1to2 of (16, 32, 2048)
                latents for 10 steps on the amax carry against its float
                route (rel-RMS in (1e-4, 0.08)); K1, K2a/b/c and int8-conv5
                counts asserted
  kernels (K6)  the fused STFT on each route against its twin (atol 5e-4 +
                rtol 1e-4, the JAX package's own tolerance) and float64: the
                shared-memory FFT at the spectrogram models' (32, 65536)
                1024/256, CLAP's (1, 1048576) 1024/480, DMAE's mel (8,
                66304) 1024/256 at center=False and PitchShift's (4,
                262144) 2048/512; its mixed-radix plans at (32, 65536)
                1000/250, 1920/480, 1536/384, 1408/128 and 384/128 and (8,
                48000) 2000/2000 (each no further from float64 than the
                twin); the chirp-z route at (32, 65536)
                1018/250, 1102/441 and 999/250 (odd) and (8, 48000)
                2018/2018; the cluster route at (4, 262144) 8192/2048 (a CTA
                a frame), 16384/4096 (2 CTAs), 10000/2500 (2 mixed-radix
                parts) and 8194/2048 (chirp-z on 4 CTAs); the DFT product at
                (32, 65536) 14/4; each on its planned route in one launch,
                within the tolerance of float64 too and no further from it
                than the twin (the DFT product excepted), timed beside the
                twin, torch.stft (cuFFT), its byte bound and the DFT's
                operations bound, per call and on the device alone (the card
                kept busy while the host queues). Then clips of 1, 2,
                n_fft/4, n_fft/2 and n_fft/2 + 1 samples (2-4 rows) at
                1024/256, 1000/250, 1018/250, 2048/512, 999/250 and
                2049/512 (odd, 2 CTAs), no longer than the reflect pad: against the twin
                and a float64 STFT of numpy's reflect-padded clip, timed
                beside the twin and torch.stft of the padded clip
  spectrogram   the four spectrogram given models at (16, 2, 65536) f32
                (1024/256, 32 Griffin-Lim rounds): the SpectrogramAE and
                MagDPhase (init 'true') round trips under 1e-9 and 1e-8 rel
                MSE (the CPU test's bound at this length); the
                Mag and Mel decodes through K6 against the same decodes
                through the twin from the same angles (rel-RMS under the
                larger of 1e-3 and the twin's own spread under a 1e-6 input
                change); spectral convergence, encode and decode times; K6
                must launch 1 + 33 + 33 + 1 = 68 times, all on the FFT route.
                Then one model a route, an encode and a Griffin-Lim decode
                whose 33 K6 launches must all take that route, the decode
                against the same through the twin: MelSpectrogramAE at
                1920/480 (40 ms windows, 10 ms hops at 48 kHz; the
                mixed-radix FFT), MelSpectrogramAE at 44.1 kHz 1102/551 (25
                ms windows; the chirp-z route) and MagSpectrogramAE at
                16384/4096 (the cluster route)
  clap          the served model's CLAP module at full width in f32 with
                seeded random weights (HTSAT-base with fusion, RoBERTa-base):
                a 5 s clip (short path), a 22 s clip (fusion path) and two
                texts embedded through CLAPDAE.embed: (1, 1, 512), unit norm,
                finite; the audio embeddings through K6 against the same
                through the twin (rel diff < 1e-4); one K6 launch per clip
  io            a seeded 30 s stereo 44.1 kHz signal written as FLAC by the
                port's encoder and as OGG (where the machine's libvorbis
                opens), read back through load_audio (resampled to 48 kHz)
                and decode_batch; FLAC bit-exact at 16 bits; ms a file
  serve         the port's HTTP service in-process on localhost: /health,
                two /generate requests with embeddings (slerp, algebra) and
                one with a text prompt at full width and reduced steps,
                /embed with a text (512 floats and the tokenizer warning)
                and with WAV, FLAC and OGG bytes, GET / (the GUI), 4
                concurrent requests through the micro-batcher (one generate:
                batched_runs 1, coalesced_requests 4; wall s against 4
                serial requests, at 20 + 10 steps), basic auth (401 without
                credentials, 200 with them, /health open), and a
                strict-text service answering 409
  mirage_cli    `python -m audio_algebra_torch.mirage`'s main at full width
                on the warm model (get_model_ready's cache), 50 + 25 steps
                (cut from 150 + 100): two text prompts slerped with
                --init-audio (the io phase's FLAC), and with the FLAC as an
                audio prompt at --batch-size 2; the WAVs, the PCA .npy /
                .html, the launches of K1, K3, K5 and K6
  seqpar        an nccl group of one (NCCL takes one rank a card): the
                destructo phase's DVAEWrapper() decode_seqpar (bf16, B = 4 x
                65536, 35 steps) of its latents from its noise against its
                decode (rel-RMS < 2e-2), and the mirage phase's CLAPDAE()
                generate_seqpar (22 s, bf16, 150 + 100 steps) from its steady
                run's noises against that run (< 5e-2); seconds of each
                route, split-K1 and K1-whole launches a forward (summing to
                the unsharded forward's K1), pick_sharded_levels' choice
  kernels (K4)  the differentiable flash attention: K4a's (o, l, m), K4b's
                (dk, dv) and K4c's (dq, dbT) against the twins at the
                trainer's sites (8, 16, 1024 / 512, 64) in f32 (atol = rtol =
                2e-4, the JAX package's), at the bf16 step's (8 and 16, 16,
                1024, 64) and (8, 16, 512, 64) in bf16 with a bf16 and an f32
                bias, at a ragged (3, 5, 320, 64) in bf16 and at B = 1 in f32,
                each timed beside the twin, SDPA forward / backward (in q's
                dtype) and its bound, with the bound's share (K4a, K4b and
                K4c in f32: 3xTF32 on the tensor cores, and the f32
                CUDA-core bound beside it; K4c in bf16: wgmma on TMA tiles,
                two batch rows a step, dq in registers, its share of the
                bf16 peak held by the step's phases running one after the
                other); two launches each of K4b and K4c
                at (8, 16, 1024, 64) f32 and bf16 and at (16, 16, 1024, 64)
                bf16 give the same bits; and the autograd Functions around
                K1 and K5: forward through the kernel, backward() against
                autograd of the twin
  train_model   one v_objective_loss forward + backward of the full-width
                songs UNetCFG1d at (8, 32, 2048) f32 through K4 and K5 and
                through their twins, from the same weights, noise, t,
                embeddings and keep mask: the loss and every parameter's
                gradient under a bound, all finite, none zero that the
                twin's is not; 8 / 8 / 8 K4, 63 K5 and 0 K3 launches
  train_bf16    the JAX repo's bf16 mixed-precision training measurements
                (tools/bench_train.py) on the port: train_model's UNetCFG1d
                under train_clapdae.make_train_step(compute_dtype=bf16) at
                batch 16 (halved while it does not fit) x (32, 2048): the
                bf16 loss and every f32 master gradient through the kernels
                against the same through the twins (loss rel < 1e-3, each
                gradient rel-RMS < 2e-2, all f32 and finite, none zero that
                the twin's is not), the step shown to compute in bf16 (its
                modules' outputs bf16; its worst gradient more than bf16's
                roundoff 2^-8 from the f32 step's on the same batch), 1
                warm-up and 3 timed optimiser steps (ms, peak memory, 8 / 8
                / 8 K4 and 63 K5 launches a step); the bf16 frozen stage-1
                encode (aa_mixer.mixed_encode_fn on the whole
                LatentAudioDiffusionAutoencoder, its encoder's weights cast
                once, that cast timed) at 4 x 1,048,576 against the f32
                encode (rel-RMS < 0.1, 65 K5 an encode), ms of each; the
                mixer step at 128 x 65,536 with the
                DVAE encode in bf16 and in f32, in turns, ms split into host
                data, encode and algebra + Adam
  train         audio_algebra_torch.train_clapdae.main on 16 seeded synthetic
                48 kHz stereo WAVs of 1,048,576 samples: CLAPDAE() defaults at
                full width in f32, batch 8, 2 epochs (4 steps), a checkpoint;
                then a second main that resumes at step 4 and takes one more
                step; lr and EMA decay against their closed forms, launch
                counts (8 / 8 / 8 K4, 63 + 65 K5 and 1 K6 a step), stage
                times, peak memory
  train_aa_model  the algebra layer's two losses at full width (the frozen
                DVAEWrapper() encode of a seeded stems batch (2, 128, 2, 65536)
                with faders (1.1, -0.8) and a raw (128, 2, 65536) batch, and of
                four (128, 2, 65536) clips; AudioAlgebra(64, 64)): the loss, its
                terms and all 16 gradients in f32 against float64 on the card
                from the same latents and weights (loss rel < 1e-5, gradient
                rel-RMS < 1e-4, finite); the cov loss's Gram identity in f64
                against the direct (c·t)^2 covariance at (128, 64, 512), rel <
                1e-9, and the f32 Gram value's error against it; one v-DDIM
                step of the demos' batch-1 f32 decode of aa.decode(zmix[:1]),
                each of its 191 K1 calls against the twin on the same inputs
  train_aa      audio_algebra_torch.train_aa_mixer.main on 256 seeded
                synthetic 48 kHz stereo WAVs of 65,536 samples: batch 128
                (defaults.ini's 1024 over its 8 GPUs), latent 64, hidden 64,
                2 epochs (4 steps), a demo at step 2 (13,370 K1 launches, no
                other kernel), a checkpoint; the same flags again resuming
                from it at step 4 for 4 more steps; train_aa_effects.main for
                2 epochs (4 steps) with a demo at step 2 (13,370 K1); every
                demo's media logged without an error, its WAVs finite at (2,
                65536); the lr Adam stepped with against the one-cycle closed
                form, the resumed state against the saved bits, ms a step
                split into host data, frozen encode and algebra + Adam, peak
                memory

  checkpoints   the reference's torch checkpoints poured through each
                wrapper's setup at its default width, from files a
                reference-layout mirror (tests/torch_mirrors.py) writes:
                DVAE, the stacked diffusion AE, DMAE, RAVE (.ckpt and .ts)
                and MIRAGE (CLAPDAE_CKPT_22s, LATENT_DIFFAE_CKPT); every
                pour without a miss, the port's forward (kernels, f32)
                against the mirror's EMA copy (rel-RMS < 1e-4, MIRAGE's
                UNetCFG1d < 1e-3), DMAE's encode through K6 at center=False
                against the twin, Destructo (bf16, B = 4 x 65536, 35 steps)
                and a MIRAGE generate (bf16, 10 + 10 steps) from the poured
                weights; launch counts of K1, K3, K5 and K6 asserted

  recurrence    the effects bank's kernels against their twins and float64
                at the xae path's shapes: R1 (biquad cascade) at (128,
                262144) one section a row, (1024, 32768) the phaser's two,
                (2, 1440000) loudness's K-weighting; R2 (the compressor's
                envelope, Newton rounds over chunks) at (4, 262144) on noise,
                a burst, a gate on chunk starts, a crescendo, DC and zeros
                (its twin at 16384 samples; rounds and repair flag read),
                and at (4, 16035), (4, 96) and (40, 2000); R3
                (Freeverb's impulse response) 64 responses of 262144, its
                twin at 4096; each timed beside its bound (bytes or the
                serial chain at the SM clock)
  effects       every effect of the bank swept over 32 knobs on (2, 2,
                262144) f32: s a sweep, peak memory, R1 / R2 / R3 / K6
                launches
  xae           audio_algebra_torch.xae_dataset.main on two generated 6 s
                files (FLAC and OGG, or two FLACs without libvorbis),
                chunk 262144, 32 knobs, all 12 effects, loudness
                normalised, encoded through DVAEWrapper() at full width;
                shapes, finite values, launches
  apps          the effects-study apps at full width on seeded files:
                effects_explorer.main (DVAEWrapper(), 8 clips, the default 6
                effects over 8 knobs, 1500 parametric-UMAP steps, a 35-step
                FX2FX decode of Clean->Reverb: R1, R3 and 35 x 191 K1
                launches), spectrogram_db of one clip (one K6, against the
                twin's image), calc_effects_pca.main on bdct-chunk-pca.ini
                (2 batches of 1024 x 65536; the covariance against a float64
                two-pass covariance of the same latents, rel < 1e-4) and
                aa_toy.main at 4000 steps (improvement > 1); seconds a
                stage, peak memory
  ddp           an nccl process group of one: one algebra mixer step at
                (2, 128, 2, 65536) f32 as the trainer takes it, through
                parallel.train's step and through parallel.manual's, all
                three updates equal to f32 rounding; train_aa_mixer_accel
                for 4 steps and resumed for 4 more; the group destroyed
  fsdp          an nccl group of one: the songs UNetCFG1d trainer step
                (make_train_step, f32, TF32 off, (8, 32, 2048) latents: batch
                8 x 1,048,576 samples), two steps replicated and two with the
                state sharded by parallel.fsdp.shard_state, and two
                replicated again, from the same weights: parameters, EMA and
                Adam's m and v within 4x the replicated pair's difference
                (the trainer's backward does not repeat its bits) and at
                least DDP_REL; state_bytes_per_device against the shards
                held, step ms and peak memory of each arm

The phases run in the order above, Destructo's first (io, serve and
mirage_cli right after clap, on the warm model). Then the `kernels`
summary line, the card's name and power limit from nvidia-smi, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result. `--only build,kernels_k4,...` (phase function names without
`phase_`) runs those phases alone and prints no result line: for work on
one phase.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32_TC_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
GN_CALLS_PER_FORWARD = 191     # 14 levels x 6 blocks x 2 - 1 + 24 attention pre-norms
STEPS = 35
CHUNK = 65536                  # samples per Destructo chunk
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7)}   # (atol, rtol)
MODEL_REL_RMS_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
# MIRAGE (22 s, songs config): the inner UNet runs 4 flash sites (level 2,
# T = 1024) and 63 grouped GroupNorms (31 ResnetBlocks x 2 + out_norm) per
# forward; the outer UNet (depth 10, no attention) 10 x 6 x 2 - 1 = 119 K1.
K3_PER_INNER, K5_PER_INNER, K1_PER_OUTER = 4, 63, 119
INNER_STEPS, OUTER_STEPS, MIRAGE_SAMPLES = 150, 100, 1048576
MIRAGE_REL_RMS_BOUND = {"float32": 1e-3, "bfloat16": 5e-2}
# Destructo turbo (B = 16 >= the turbo batch gate): per UNet forward, 83 GN_0
# int8 emits (every block but stack_000.m0, whose 82-channel input fails the
# C % 128 gate), GN_1 with amax in the 20 stacks without attention (59 on
# step 0; on later steps the carry turns m0/m2's 40 into K2c), and K1 at the
# 24 attention pre-norms, the attention stacks' 24 GN_1 and stack_000.m0.
TURBO_B = 16
TURBO_STEP0 = {"k1": 49, "k2a": 83, "k2b": 59, "k2c": 0}
TURBO_STEP = {"k1": 49, "k2a": 83, "k2b": 19, "k2c": 40}
TURBO_REL_RMS_BOUND = 0.08     # turbo vs bf16 decode (the JAX package's band)
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense
# MIRAGE turbo (mirage_turbo): below the batch gate the outer stage runs int8
# inside the fold, 12 conv5s (2 stacks x 3 blocks x 2) a folded level; the
# default micro-batch of 4 at 20 + 10 steps. The stacked AE's carry route at
# B = 16 x 32768 (22 s), depth 10 x 512 channels: GN_0 int8 (K2a) in every
# block but stack_000.m0 (80-channel input: K1), GN_1 with amax (K2b) in the
# 59 blocks that have one on step 0; later m0/m2's 40 take K2c
MIRAGE_TURBO_B4_STEPS = (20, 10)
# 16 rows in one micro-batch (CLAPDAE(decode_batch=16), JAX's
# AA_MIRAGE_DECODE_BATCH=16): the outer stage on the amax carry at the
# stacked AE's shapes (16 x 32 x 32768), beside the same rows in micro-batches
# of 4 (int8 in the fold) and in bf16; steps cut from 150 + 100
MIRAGE_TURBO_B16_STEPS = (10, 10)
STACKED_TURBO_B, STACKED_TURBO_STEPS = 16, 10
STACKED_STEP0 = {"k1": 1, "k2a": 59, "k2b": 59, "k2c": 0}
STACKED_STEP = {"k1": 1, "k2a": 59, "k2b": 19, "k2c": 40}
# the spectrogram models (16, 2, 65536) at 1024 / 256: SpectrogramAE and
# MagDPhase encode once, Mag and Mel encode once and take 32 Griffin-Lim rounds
SPEC_SHAPE, SPEC_ITERS = (16, 2, 65536), 32
K6_SPECTROGRAM = 1 + (1 + SPEC_ITERS) + (1 + SPEC_ITERS) + 1
# then one model a route, each an encode and a Griffin-Lim decode of the
# same clips (1 + 32 launches, all on the route): MelSpectrogramAE at 40 ms
# windows, 10 ms hops (1920 / 480 at 48 kHz) on K6's mixed-radix FFT (8, 8,
# 3, 5); MelSpectrogramAE at 25 ms windows at 44.1 kHz (1102; half 551 = 19
# x 29) on the chirp-z route, hop 551 (half a window: the overlap-add of
# istft, JAX's and the port's, needs n_fft % hop == 0, so 441 cannot decode);
# MagSpectrogramAE at 16384 / 4096 on the cluster route (2 CTAs)
SPEC_ROUTES = (("MelSpectrogramAE", 48000, 1920, 480, "fft"),
               ("MelSpectrogramAE", 44100, 1102, 551, "chirp"),
               ("MagSpectrogramAE", 48000, 16384, 4096, "cluster"))
STFT_TOL = (5e-4, 1e-4)        # (atol, rtol): the JAX package's for its kernel
# clips no longer than the reflect pad n_fft / 2 (or one sample longer) on
# each of K6's routes: the power-of-two FFT (and PitchShift's 2048 / 512),
# the mixed radices, the chirp-z route (even and odd), the cluster route
SHORT_CLIP_STFT = ((1024, 256), (1000, 250), (1018, 250), (2048, 512), (999, 250),
                   (2049, 512))
K6_ROUTES = ("fft", "chirp", "cluster", "dft")
GL_REL_RMS = 1e-3
# the exact round trips, rel MSE: SpectrogramAE's; MagDPhase integrates f32
# phase increments over 257 frames, where JAX's own round trip reaches 1.9e-9
# (the bound of tests/test_torch_spectrogram_models.py at this length)
ROUND_TRIP = {"SpectrogramAE": 1e-9, "MagDPhaseSpectrogramAE": 1e-8}
CLAP_REL = 1e-4
CLAP_SHORT, CLAP_LONG = 240000, MIRAGE_SAMPLES     # 5 s and 22 s at 48 kHz
# the trainer: batch 8 x 1,048,576 samples -> (8, 32, 2048) latents; per
# forward + backward of the songs UNetCFG1d 4 flash sites at T = 1024 and 4 at
# T = 512 (one launch of K4a, K4b and K4c each) and 63 grouped GroupNorms;
# the frozen stage-1 encode of a batch runs 65 more (Encoder1d: 32
# ResnetBlocks x 2 + its out norm), under no_grad
TRAIN_BATCH, TRAIN_FILES, TRAIN_EPOCHS = 8, 16, 2
K4_PER_STEP, K5_PER_STEP, K5_PER_ENCODE = 8, 63, 65
K4_TOL = {"float32": (2e-4, 2e-4), "bfloat16": TOL["bfloat16"]}      # (atol, rtol)
TRAIN_LOSS_REL, TRAIN_GRAD_REL_RMS = 1e-4, 1e-3
# the bf16 training step of tools/bench_train.py (train_clapdae.make_train_step
# with compute_dtype bf16): batch 16 (halved on running out of memory, as the
# tool does) x (32, 2048) latents, 1 warm-up and 3 timed steps; kernels against
# twins on the same bf16 step: loss rel < 1e-3, each gradient rel-RMS < 2e-2.
# The bf16 frozen encode at the tool's batch 4 x 1,048,576: rel-RMS from the
# f32 encode under 0.1 (the tests' tiny stage-1 stack on the CPU: 4.0e-2 for
# the port, 4.1e-2 for JAX's own bf16 encode). The mixer step at 128 x 65,536
# with the DVAE encode in bf16 and in f32
BF16_TRAIN_BATCH, BF16_TRAIN_STEPS = 16, 3
BF16_TRAIN_LOSS_REL, BF16_TRAIN_GRAD_REL_RMS = 1e-3, 2e-2
BF16_ENCODE_BATCH, BF16_ENCODE_REL_RMS = 4, 0.1
BF16_VS_F32_FLOOR = 2.0 ** -8  # bf16's unit roundoff: the least worst-gradient gap
BF16_MIXER_STEPS = 2
# the algebra layer at one card's share of defaults.ini (batch_size 1024 over
# num_gpus 8): batch 128 x 65536 samples, latent 64, hidden 64, 2 stems. Its
# one frozen DVAEWrapper encode launches no kernel; each demo decodes zsum and
# zmix (or za2_guess and za2) at batch 1 in 35 v-DDIM steps, 191 K1 a step
AA_BATCH, AA_FILES, AA_DIMS, AA_FADERS = 128, 256, 64, (1.1, -0.8)
AA_LOSS_REL, AA_GRAD_REL_RMS, AA_GRAM_REL = 1e-5, 1e-4, 1e-9
K1_PER_AA_DEMO = 2 * STEPS * GN_CALLS_PER_FORWARD
# the checkpoints phase: each model's forward against its mirror's, f32
# (MIRAGE's UNetCFG1d at its own 1e-3); the MIRAGE generate at 10 + 10 steps.
# DMAE's mel at its default: 48 kHz (4, 2, 65536) -> 44.1 kHz, padded to
# 65536, reflect-padded by (1024 - 256) / 2 -> 8 rows of 66304, center=False
CKPT_REL_RMS, CKPT_STEPS = 1e-4, 10
DMAE_STFT = (8, CHUNK + 1024 - 256)
DMAE_FULL = dict(channels=(256, 512, 512, 512, 1024, 1024, 1024), factors=(1, 2, 2, 2, 2, 2, 2),
                 items=(1, 2, 2, 2, 2, 2, 2), linear_attentions=(0, 1, 1, 1, 1, 1, 1),
                 attention_features=64, attention_heads=8, inject_depth=4, latent_dim=32,
                 resnet_groups=8, num_filters=128, window_length=128, lt_stride=64,
                 enc_channels=512, enc_multipliers=(1, 1, 1), enc_factors=(2, 2),
                 enc_num_blocks=(4, 8), n_mels=80)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call: the card is kept busy (torch.cuda._sleep, ~0.1
    s) while the host queues the calls, so the events time the card alone
    and not the host's launch path."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> None:
    from audio_algebra_torch.ops import _build
    sources = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    t0 = time.time()
    logs = _build.build(sources)
    log = "\n".join(logs.values())
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    emit({"phase": "build", "sources": sources, "built": sorted(logs),
          "seconds": time.time() - t0, "max_registers": max(regs, default=None),
          "spill_store_bytes": sum(spills)})


def gn_bound(shape, dtype, gelu: bool, residual: bool) -> tuple[float, str]:
    """Least time for GN(1)[+GELU][+res]: read x (and res) once, write y
    once; or its f32 operations (stats 3, normalise + affine 4, GELU 8,
    residual 1 per element) at the f32 peak, whichever is larger."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    t_bytes = (n * esize * (3 if residual else 2) + 2 * c * esize) / HBM_BYTES_PER_S * 1e3
    t_ops = n * (7 + 8 * gelu + residual) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    cases = [(shape, dt, gelu, res)
             for shape in [(4, 256, 65536), (4, 512, 8)]
             for dt in (torch.bfloat16, torch.float32)
             for gelu in (True, False) for res in (True, False)]
    cases.append(((2, 128, 1000), torch.float32, True, True))
    cases.append(((1, 512, 32768), torch.bfloat16, True, True))     # MIRAGE outer UNet
    # the algebra demos' decode: batch 1 in f32, its own launch plan
    cases.append(((1, 256, 65536), torch.float32, True, True))
    cases.append(((1, 512, 8), torch.float32, True, True))
    rows = []
    for shape, dt, gelu, res in cases:
        g = torch.Generator(device=dev).manual_seed(len(rows))
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        r = torch.randn(shape, generator=g, device=dev).to(dt) if res else None
        scale = (torch.rand(shape[1], generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(shape[1], generator=g, device=dev) - 0.5).to(dt)
        got = gn.groupnorm1_gelu(x, scale, bias, gelu, r)
        torch.cuda.synchronize()
        want = gn.groupnorm1_gelu_ref(x, scale, bias, gelu, r)
        name = str(dt).removeprefix("torch.")
        atol, rtol = TOL[name]
        err = (got.float() - want.float()).abs()
        bad = int((err > atol + rtol * want.float().abs()).sum())

        def library():
            y = F.group_norm(x, 1, scale, bias, 1e-6)
            if gelu:
                y = F.gelu(y, approximate="tanh")
            return y + r if res else y

        iters = 20 if x.numel() > 1 << 20 else 200
        bound_ms, bound_by = gn_bound(shape, dt, gelu, res)
        row = {"shape": list(shape), "dtype": name, "gelu": gelu, "residual": res,
               "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
               "n_outside_tol": bad,
               "kernel_ms": cuda_ms(lambda: gn.groupnorm1_gelu(x, scale, bias, gelu, r), iters),
               "plain_ms": cuda_ms(lambda: gn.groupnorm1_gelu_ref(x, scale, bias, gelu, r), iters),
               "library_ms": cuda_ms(library, iters),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        del x, r, got, want, err
    emit({"phase": "kernels", "kernel": "groupnorm1_gelu", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K1 disagrees with its twin: {failed}")
    return next(r for r in rows if r["shape"] == [4, 256, 65536]
                and r["dtype"] == "bfloat16" and r["gelu"] and r["residual"])


def _compare(got, want, dtype) -> dict:
    name = str(dtype).removeprefix("torch.")
    atol, rtol = TOL[name]
    err = (got.float() - want.float()).abs()
    return {"dtype": name, "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
            "n_outside_tol": int((err > atol + rtol * want.float().abs()).sum())}


def flash_bound(shape, dtype, bias_dtype) -> tuple[float, str]:
    """Least time for K3: read q, k, v and the (H, T, T) bias once, write o
    once; or its 4 B H T^2 D product operations at the peak of q's type
    (bf16 tensor cores, or f32 outside them), whichever is larger."""
    import torch
    b, h, t, d = shape
    qkv = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * h * t * d * qkv + h * t * t * torch.empty((), dtype=bias_dtype).element_size()
    peak = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * b * h * t * t * d / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_k3() -> dict:
    """K3 at the MIRAGE inner UNet's flash sites: 22 s (T = 1024) and 66 s
    (T = 3072, 1536), B = 2 from CFG, 16 heads x 64, bf16 with a bf16
    bias; B = 1 and 4 at T = 1024; and one f32 row. Each row by CUDA events
    (a call) and on the device alone (`device_ms`)."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cases = [((2, 16, 1024, 64), bf16, bf16), ((2, 16, 3072, 64), bf16, bf16),
             ((2, 16, 1536, 64), bf16, bf16), ((1, 16, 1024, 64), bf16, bf16),
             ((4, 16, 1024, 64), bf16, bf16),
             ((2, 16, 1024, 64), torch.float32, torch.float32)]
    rows = []
    for shape, dt, bdt in cases:
        g = torch.Generator(device=dev).manual_seed(100 + len(rows))
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(3))
        h, t = shape[1], shape[2]
        bias_t = (torch.randn((h, t, t), generator=g, device=dev) * 0.5).to(bdt)
        scale = shape[3] ** -0.5
        got = fa.flash_attention_relpos(q, k, v, bias_t, scale)
        torch.cuda.synchronize()
        want = fa.flash_attention_relpos_ref(q, k, v, bias_t, scale)
        row = {"shape": list(shape), "bias_dtype": str(bdt).removeprefix("torch."),
               **_compare(got, want, dt)}
        del got, want
        mask = bias_t.transpose(1, 2)[None].to(dt)           # (1, H, T, S)
        big = t > 1024
        bound_ms, bound_by = flash_bound(shape, dt, bdt)

        def kernel():
            return fa.flash_attention_relpos(q, k, v, bias_t, scale)

        row.update({
            "kernel_ms": cuda_ms(kernel, 20), "kernel_device_ms": device_ms(kernel, 20),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_relpos_ref(q, k, v, bias_t, scale),
                                3 if big else 10, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), 20),
            "bound_ms": bound_ms, "bound_by": bound_by})
        rows.append(row)
        del q, k, v, bias_t, mask
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_attention_relpos", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K3 disagrees with its twin: {failed}")
    return rows[0]


def ggn_bound(shape, dtype, film: bool) -> tuple[float, str]:
    """Least time for K5: read x once, write y once (plus the per-channel
    planes); or its f32 operations (statistics 3, affine 2, SiLU 4 per
    element) at the f32 peak, whichever is larger."""
    import torch
    b, c, t = shape
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * b * c * t * esize + (2 * c + (2 * b * c if film else 0)) * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = b * c * t * 9 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_us(fn, iters: int = 300) -> float:
    """Host microseconds a call, the card kept busy (torch.cuda._sleep) so
    that no call waits for it: the inverse of `device_ms`."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def phase_kernels_k5() -> dict:
    """K5 at the MIRAGE inner UNet's shapes (8 groups, SiLU): the widest
    level with FiLM, the widest up-level input without FiLM, the deepest
    level; one f32 row and the trainer's (8, 512, 2048) f32; bf16 rows at
    the batches of the MIRAGE CLI (4) and of the service's 4-request
    micro-batch (8). Each row by
    CUDA events, on the device alone, and the wrapper's host microseconds
    a call, with the route the planner chose; two launches give the same
    bits."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    dev = torch.device("cuda")
    cases = [((2, 512, 2048), torch.bfloat16, True), ((2, 1536, 2048), torch.bfloat16, False),
             ((2, 1024, 32), torch.bfloat16, True), ((2, 512, 2048), torch.float32, True),
             ((8, 512, 2048), torch.float32, True),
             # the MIRAGE CLI at --batch-size 2 and the service's 4-request micro-batch
             ((4, 512, 2048), torch.bfloat16, True), ((8, 512, 2048), torch.bfloat16, True),
             ((8, 1536, 2048), torch.bfloat16, False), ((8, 1024, 32), torch.bfloat16, True)]
    rows = []
    for shape, dt, film in cases:
        g = torch.Generator(device=dev).manual_seed(200 + len(rows))
        b, c, t = shape
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        scale = (torch.rand(c, generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(c, generator=g, device=dev) - 0.5).to(dt)
        ts = (torch.randn((b, 2 * c), generator=g, device=dev) * 0.3).to(dt)
        fs, sh = ts.chunk(2, dim=1) if film else (None, None)
        got = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
        again = ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)
        torch.cuda.synchronize()
        want = ggn.grouped_gn_film_silu_ref(x, scale, bias, 8, fs, sh)
        plan = ggn.ggn_plan(b, c, t, 8, x.element_size())
        row = {"shape": list(shape), "film": film, "silu": True, "route": plan.route,
               "cluster_size": plan.cs, "threads": plan.threads, "smem_bytes": plan.smem,
               "same_bits": bool(torch.equal(got, again)), **_compare(got, want, dt)}
        del got, again, want

        def library():
            y = F.group_norm(x, 8, scale, bias, 1e-6)
            if film:
                y = y * (1 + fs[:, :, None]) + sh[:, :, None]
            return F.silu(y)

        def kernel():
            return ggn.grouped_gn_film_silu(x, scale, bias, 8, fs, sh)

        bound_ms, bound_by = ggn_bound(shape, dt, film)
        row.update({"kernel_ms": cuda_ms(kernel, 200), "kernel_device_ms": device_ms(kernel, 200),
                    "host_us": host_us(kernel),
                    "plain_ms": cuda_ms(lambda: ggn.grouped_gn_film_silu_ref(x, scale, bias,
                                                                              8, fs, sh), 50),
                    "library_ms": cuda_ms(library, 200),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        rows.append(row)
    emit({"phase": "kernels", "kernel": "grouped_gn_film_silu", "cases": rows})
    failed = [r for r in rows if r["n_outside_tol"] or not r["same_bits"]]
    if failed:
        raise AssertionError(f"K5 disagrees with its twin or with itself: {failed}")
    return rows[0]


def rel_rms(a, b) -> float:
    return float(((a - b).square().mean() / b.square().mean().clamp_min(1e-12)).sqrt())


def phase_model() -> None:
    """One full-width UNet forward through K1 and through its twin, in f32
    and in bf16. The bf16 twin against the f32 twin gives the size of bf16
    rounding itself, the scale against which the bf16 difference is read."""
    import torch
    from audio_algebra_torch.models import blocks
    from audio_algebra_torch.models.unet1d import DiffusionAttnUnet1D
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    unet = random_init_(DiffusionAttnUnet1D(io_channels=2, cond_dim=64), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 2, 16384), generator=g, device=dev)
    t = torch.rand((2,), generator=g, device=dev)
    cond = torch.tanh(torch.randn((2, 64, 128), generator=g, device=dev))
    out, calls = {}, {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            unet.to(dt)
            args = (x.to(dt), t.to(dt), cond.to(dt))
            before = gn.launches
            out["kernel", dt] = unet(*args).float()
            calls[dt] = gn.launches - before
            blocks.groupnorm1_gelu = gn.groupnorm1_gelu_ref
            try:
                out["plain", dt] = unet(*args).float()
            finally:
                blocks.groupnorm1_gelu = gn.groupnorm1_gelu
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"float32": rel_rms(out["kernel", f32], out["plain", f32]),
            "bfloat16": rel_rms(out["kernel", bf16], out["plain", bf16])}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    emit({"phase": "model", "shape": [2, 2, 16384], "k1_launches": calls[bf16],
          "rel_rms_kernel_vs_plain": errs, "bound": MODEL_REL_RMS_BOUND,
          "rel_rms_plain_bf16_vs_f32": rel_rms(out["plain", bf16], out["plain", f32]),
          "finite": finite})
    if set(calls.values()) != {GN_CALLS_PER_FORWARD}:
        raise AssertionError(f"UNet forward launched K1 {calls} times")
    if not finite or any(errs[k] >= MODEL_REL_RMS_BOUND[k] for k in errs):
        raise AssertionError(f"UNet through K1 vs plain: rel-RMS {errs}")


def phase_destructo() -> int:
    import numpy as np
    import torch
    from audio_algebra_torch.destructo import mathemangle
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.utils.audio_io import batch_it_crazy, load_audio, write_wav

    chunk, n_chunks, sr_in = 65536, 4, 44100
    n_in = int((n_chunks - 0.25) * chunk * sr_in / 48000)
    tt = np.arange(n_in) / sr_in
    rng = np.random.default_rng(0)
    signal = np.stack([0.3 * np.sin(2 * np.pi * 220 * tt), 0.3 * np.sin(2 * np.pi * 330 * tt)])
    signal = (signal + 0.05 * rng.standard_normal(signal.shape)).astype(np.float32)

    w = DVAEWrapper(args_dict={"sample_size": chunk, "demo_steps": STEPS},
                    device="cuda", dtype=torch.bfloat16)
    t0 = time.time()
    w.ensure_params()
    init_s = time.time() - t0

    def pipeline():
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "in.wav"
            write_wav(path, signal, sr_in)
            batch = batch_it_crazy(load_audio(path, sr=48000), chunk, max_batch_size=8)
        torch.cuda.synchronize()
        t_enc = time.time()
        z = mathemangle(w.encode(batch), "destructo")
        torch.cuda.synchronize()
        t_dec = time.time()
        out = w.decode(z, demo_steps=STEPS)
        torch.cuda.synchronize()
        return batch, out, t_dec - t_enc, time.time() - t_dec, z

    torch.cuda.reset_peak_memory_stats()
    gn.launches = 0
    batch, out, enc_s, dec_s, _ = pipeline()
    launches = gn.launches
    _, out2, enc2_s, dec2_s, z2 = pipeline()      # steady state (warm cuDNN plans)
    audio_s = batch.shape[0] * chunk / 48000
    finite = bool(torch.isfinite(out).all())
    emit({"phase": "destructo", "batch": list(batch.shape), "steps": STEPS,
          "dtype": "bfloat16", "out_shape": list(out.shape), "finite": finite,
          "k1_launches": launches, "k1_expected": STEPS * GN_CALLS_PER_FORWARD,
          "init_s": init_s, "first_encode_s": enc_s, "first_decode_s": dec_s,
          "encode_s": enc2_s, "decode_s": dec2_s, "ms_per_step": dec2_s / STEPS * 1e3,
          "realtime_factor": audio_s / (enc2_s + dec2_s),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if tuple(out.shape) != (2, n_chunks * chunk) or batch.shape[0] != n_chunks or not finite:
        raise AssertionError(f"destructo output {tuple(out.shape)} finite={finite}")
    if launches != STEPS * GN_CALLS_PER_FORWARD:
        raise AssertionError(f"K1 launched {launches} times in the decode, "
                             f"expected {STEPS * GN_CALLS_PER_FORWARD}")
    # the steady run's wrapper (its stored noise), latents, audio and seconds:
    # the seqpar phase decodes the same latents from the same noise
    return {"k1": launches, "wrapper": w, "z": z2, "out": out2, "decode_s": dec2_s}


def k2_bytes(shape, dtype, mode: str) -> int:
    """Bytes K2 must move: x (and the residual) read once, each output
    written once, the (C,) planes."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    per = {"quant": esize + 1, "res_amax": 3 * esize, "res_amax_q": 3 * esize + 1}[mode]
    return n * per + 4 * c * esize


def k2_bound(shape, dtype, mode: str) -> tuple[float, str]:
    """Least time for K2: read x (and the residual) once, write each output
    once (int8: 1 byte an element, amax and the (C,) planes negligible
    but counted); or its f32 operations (statistics 3, normalise + affine
    4, GELU 8, residual and amax 2, quantise 3 per element) at the f32
    peak, whichever is larger."""
    import torch
    n, c = math.prod(shape), shape[1]
    esize = torch.empty((), dtype=dtype).element_size()
    ops = {"quant": 18, "res_amax": 17, "res_amax_q": 20}[mode]
    t_bytes = k2_bytes(shape, dtype, mode) / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_compare(got, want, dtype) -> dict:
    """K2's tolerances on one call's outputs against its twin's: int8 within
    one step on at most 1e-3 of the values, the amax within 1e-5 relative,
    the float output inside TOL. `n_outside_tol` counts the breaches."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    row, errs, bad = {}, [], 0
    for a, b in zip(got, want):
        if a.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            row["int8_max_lsb"] = int(d.max())
            row["int8_share_off"] = float((d > 0).float().mean())
            bad += int(d.max() > 1 or row["int8_share_off"] > 1e-3)
            errs.append(float(d.max()))
        elif a.dim() == 1:
            row["amax_max_rel_err"] = float(((a - b).abs() / b.abs().clamp_min(1e-12)).max())
            bad += int(row["amax_max_rel_err"] > 1e-5)
        else:
            cmp = _compare(a, b, dtype)
            row["out_max_abs_err"] = cmp["max_abs_err"]
            bad += cmp["n_outside_tol"]
            errs.append(cmp["max_abs_err"])
    row["max_abs_err"] = max(errs)
    row["n_outside_tol"] = bad
    return row


def phase_kernels_k2() -> dict:
    """K2's three modes at the turbo decode's level 0 (16, 256, 65536) and
    level 2 (16, 512, 16384), and the stacked AE carry's level 0
    (16, 512, 32768), in bf16, each against its twin and timed beside the
    twin, the library chain and the bound; then the int8 conv against the
    bf16 cuDNN conv at level 0. Returns the level-0 row of each mode."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.models import blocks
    from audio_algebra_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    rows = []
    for shape in [(16, 256, 65536), (16, 512, 16384), (16, 512, 32768)]:
        g = torch.Generator(device=dev).manual_seed(300 + len(rows))
        c = shape[1]
        dt = torch.bfloat16
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).to(dt)
        res = (torch.randn(shape, generator=g, device=dev) * 2.0).to(dt)
        scale = (torch.rand(c, generator=g, device=dev) + 0.5).to(dt)
        bias = (torch.rand(c, generator=g, device=dev) - 0.5).to(dt)
        grid = torch.rand(c, generator=g, device=dev) * 0.06 + 0.02
        for mode in ("quant", "res_amax", "res_amax_q"):
            q = grid if mode == "res_amax_q" else None
            if mode == "quant":
                def kernel():
                    return gn.groupnorm1_gelu_quant(x, scale, bias, grid)

                def plain():
                    return gn.groupnorm1_gelu_quant_ref(x, scale, bias, grid)
            else:
                def kernel():
                    return gn.groupnorm1_gelu_res_amax(x, scale, bias, res, q_emit_scale=q)

                def plain():
                    return gn.groupnorm1_gelu_res_amax_ref(x, scale, bias, res, q_emit_scale=q)

            def library():
                y = F.gelu(F.group_norm(x, 1, scale, bias, 1e-6), approximate="tanh")
                if mode == "quant":
                    return torch.clamp(torch.round(y.float() / grid[:, None]), -127,
                                       127).to(torch.int8)
                out = res.float() + y.float()
                amax = out.abs().amax(dim=(0, 2))
                if q is None:
                    return out.to(dt), amax
                return out.to(dt), amax, torch.clamp(torch.round(out / q[:, None]), -127,
                                                      127).to(torch.int8)

            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            row = {"shape": list(shape), "dtype": "bfloat16", "mode": mode,
                   **k2_compare(got, want, dt)}
            del got, want
            big = shape[2] > 16384
            bound_ms, bound_by = k2_bound(shape, dt, mode)
            kernel_ms = cuda_ms(kernel, 20)
            row.update({"kernel_ms": kernel_ms,
                        "kernel_tb_s": k2_bytes(shape, dt, mode) / kernel_ms / 1e9,
                        "plain_ms": cuda_ms(plain, 3 if big else 10, warmup=1),
                        "library_ms": cuda_ms(library, 3 if big else 10, warmup=1),
                        "bound_ms": bound_ms, "bound_by": bound_by})
            rows.append(row)
            torch.cuda.empty_cache()
        del x, res

    # the int8 conv of a turbo block at level 0 against the bf16 conv
    g = torch.Generator(device=dev).manual_seed(310)
    b, c, t = 16, 256, 65536
    x = torch.randn((b, c, t), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((c, c, 5), generator=g, device=dev) / math.sqrt(5 * c)).to(torch.bfloat16)
    bias = (torch.randn(c, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    x8, s_x = blocks.quantize_act(x, x.float().abs().amax(dim=(0, 2)))
    w8 = torch.randint(-127, 128, (c, c, 5), generator=g, device=dev, dtype=torch.int8)
    cols = torch.randint(-127, 128, (b * t, 5 * c), generator=g, device=dev, dtype=torch.int8)
    wmat = w8.permute(0, 2, 1).reshape(c, 5 * c)
    conv = {"shape": [b, c, t], "c_out": c, "kernel_size": 5,
            "int8_conv_ms": cuda_ms(lambda: blocks.conv1d_int8(x8, s_x, w, bias,
                                                               torch.bfloat16), 10),
            "int8_acc_ms": cuda_ms(lambda: blocks._int8_conv_acc(x8, w8), 10),
            "int8_product_ms": cuda_ms(lambda: torch._int_mm(wmat, cols.t()), 10),
            "bf16_cudnn_conv_ms": cuda_ms(lambda: blocks.conv1d(x, w, bias), 10),
            "int8_bound_ms": 2 * b * t * c * c * 5 / INT8_OPS_PER_S * 1e3,
            "bf16_bound_ms": 2 * b * t * c * c * 5 / BF16_TC_OPS_PER_S * 1e3}
    del x, x8, cols
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "groupnorm1_turbo", "cases": rows, "int8_conv": conv})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K2 disagrees with its twin: {failed}")
    return {r["mode"]: r for r in rows if r["shape"] == [16, 256, 65536]}


def phase_destructo_turbo() -> dict:
    """Destructo at B = 16 x 65536, bf16, 35 steps, through the user's
    entry points: one wrapper encodes, then decodes the negated latents
    from the same noise in bf16 and through the turbo int8 route (after a
    2-step warm-up of each). Returns the turbo decode's launch counts."""
    import numpy as np
    import torch
    from audio_algebra_torch.destructo import mathemangle
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.utils.audio_io import batch_it_crazy, load_audio, write_wav

    chunk, sr_in = CHUNK, 44100
    n_in = int((TURBO_B - 0.25) * chunk * sr_in / 48000)
    tt = np.arange(n_in) / sr_in
    rng = np.random.default_rng(3)
    signal = np.stack([0.3 * np.sin(2 * np.pi * 220 * tt), 0.3 * np.sin(2 * np.pi * 277 * tt)])
    signal = (signal + 0.05 * rng.standard_normal(signal.shape)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "in.wav"
        write_wav(path, signal, sr_in)
        batch = batch_it_crazy(load_audio(path, sr=48000), chunk, max_batch_size=TURBO_B)
    w = DVAEWrapper(args_dict={"sample_size": chunk, "demo_steps": STEPS},
                    device="cuda", dtype=torch.bfloat16, turbo=True)
    w.ensure_params()
    torch.cuda.synchronize()
    t0 = time.time()
    z = mathemangle(w.encode(batch), "destructo")
    torch.cuda.synchronize()
    enc_s = time.time() - t0

    def counts():
        return {"k1": gn.launches, "k2a": gn.quant_launches, "k2b": gn.amax_launches,
                "k2c": gn.amax_q_launches}

    def decode(turbo: bool, steps: int):
        w.turbo = turbo
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.time()
        out = w.decode(z, demo_steps=steps)
        torch.cuda.synchronize()
        return out, time.time() - start, torch.cuda.max_memory_allocated() / 1e9

    decode(False, 2)                                  # warm-ups: plans, allocator
    decode(True, 2)
    out_bf16, bf16_s, bf16_mem = decode(False, STEPS)
    gn.launches = gn.quant_launches = gn.amax_launches = gn.amax_q_launches = 0
    out_turbo, turbo_s, turbo_mem = decode(True, STEPS)
    launches = counts()
    expected = {k: TURBO_STEP0[k] + (STEPS - 1) * TURBO_STEP[k] for k in TURBO_STEP}
    audio_s = batch.shape[0] * chunk / 48000
    err = rel_rms(out_turbo.float(), out_bf16.float())
    finite = bool(torch.isfinite(out_turbo).all() and torch.isfinite(out_bf16).all())
    emit({"phase": "destructo_turbo", "batch": list(batch.shape), "steps": STEPS,
          "dtype": "bfloat16", "out_shape": list(out_turbo.shape), "finite": finite,
          "encode_s": enc_s,
          "bf16": {"decode_s": bf16_s, "ms_per_step": bf16_s / STEPS * 1e3,
                   "realtime_factor": audio_s / (enc_s + bf16_s),
                   "decode_realtime_factor": audio_s / bf16_s, "peak_mem_gb": bf16_mem},
          "turbo": {"decode_s": turbo_s, "ms_per_step": turbo_s / STEPS * 1e3,
                    "realtime_factor": audio_s / (enc_s + turbo_s),
                    "decode_realtime_factor": audio_s / turbo_s, "peak_mem_gb": turbo_mem},
          "turbo_over_bf16_time": turbo_s / bf16_s,
          "rel_rms_turbo_vs_bf16": err, "bound": TURBO_REL_RMS_BOUND,
          "launches": launches, "launches_expected": expected})
    if tuple(out_turbo.shape) != (2, TURBO_B * chunk) or batch.shape[0] != TURBO_B \
            or not finite:
        raise AssertionError(f"turbo output {tuple(out_turbo.shape)} finite={finite}")
    if not err < TURBO_REL_RMS_BOUND:
        raise AssertionError(f"turbo vs bf16 decode rel-RMS {err} >= {TURBO_REL_RMS_BOUND}")
    if launches != expected:
        raise AssertionError(f"turbo decode launches {launches}, expected {expected}")
    return launches


def phase_mirage_model() -> None:
    """One full-width MIRAGE UNetCFG1d forward (the songs config, CFG
    scale 4 over a doubled batch, T = 2048) through K3 and K5 and through
    their twins with the same weights, in f32 and in bf16. The bf16 twin
    against the f32 twin gives the size of bf16 rounding itself."""
    import torch
    from audio_algebra_torch.models import blocks, unet_cfg1d
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    t_len = MIRAGE_SAMPLES // 512
    unet = random_init_(unet_cfg1d.UNetCFG1d(), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1, 32, t_len), generator=g, device=dev)
    t = torch.rand((1,), generator=g, device=dev)
    emb = torch.randn((1, 1, 512), generator=g, device=dev)
    emb = emb / emb.norm()
    out, calls, fwd_ms = {}, {}, {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            unet.to(dt)
            rb = unet_cfg1d.precompute_rel_biases(unet, t_len)
            kw = dict(embedding=emb.to(dt), embedding_scale=4.0, rel_biases=rb)
            args = (x.to(dt), t.to(dt))
            before = (fa.launches, ggn.launches)
            out["kernel", dt] = unet(*args, **kw).float()
            calls[str(dt).removeprefix("torch.")] = [fa.launches - before[0],
                                                     ggn.launches - before[1]]
            fwd_ms[str(dt).removeprefix("torch.")] = cuda_ms(lambda: unet(*args, **kw), 5)
            unet_cfg1d.flash_attention_relpos = fa.flash_attention_relpos_ref
            blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu_ref
            try:
                out["plain", dt] = unet(*args, **kw).float()
            finally:
                unet_cfg1d.flash_attention_relpos = fa.flash_attention_relpos
                blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"float32": rel_rms(out["kernel", f32], out["plain", f32]),
            "bfloat16": rel_rms(out["kernel", bf16], out["plain", bf16])}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    emit({"phase": "mirage_model", "shape": [1, 32, t_len], "cfg_scale": 4.0,
          "k3_k5_launches": calls, "forward_ms": fwd_ms,
          "rel_rms_kernel_vs_plain": errs, "bound": MIRAGE_REL_RMS_BOUND,
          "rel_rms_plain_bf16_vs_f32": rel_rms(out["plain", bf16], out["plain", f32]),
          "finite": finite})
    if any(c != [K3_PER_INNER, K5_PER_INNER] for c in calls.values()):
        raise AssertionError(f"UNetCFG1d forward launched (K3, K5) {calls} times")
    if not finite or any(errs[k] >= MIRAGE_REL_RMS_BOUND[k] for k in errs):
        raise AssertionError(f"UNetCFG1d through K3/K5 vs plain: rel-RMS {errs}")


def phase_mirage():
    """Full-width 22 s MIRAGE generate in bf16 with seeded random weights,
    run twice (the second is the steady state). Returns the model (warm,
    for the serve phase) and the first run's launch counts."""
    import numpy as np
    import torch
    from audio_algebra_torch.embedding_math import weighted_algebra
    from audio_algebra_torch.given_models import CLAPDAE
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    t0 = time.time()
    model = CLAPDAE(device="cuda", seed=0).setup(model_len="22s").half()
    init_s = time.time() - t0
    rng = np.random.default_rng(0)
    a, b = (v / np.linalg.norm(v) for v in rng.standard_normal((2, 1, 1, 512)).astype("f4"))
    emb = weighted_algebra([a, b], [1.0, -0.5])

    def run(**noises):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fakes, lat = model.generate(emb, cfg_scales=4, demo_steps=INNER_STEPS,
                                    outer_steps=OUTER_STEPS, batch_size=1, stage_times=True,
                                    **noises)
        torch.cuda.synchronize()
        return fakes, lat, time.perf_counter() - start, dict(model.last_stage_times)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = ggn.launches = gn.launches = 0
    ggn.cluster_launches = ggn.two_pass_launches = 0
    fakes, lat, first_s, first_stages = run()
    counts = {"k3": fa.launches, "k5": ggn.launches, "k1": gn.launches}
    k5_routes = {"cluster": ggn.cluster_launches, "two_pass": ggn.two_pass_launches}
    g = torch.Generator(device="cuda").manual_seed(7)     # the steady run's noises, kept
    noises = {"latent_noise": torch.randn((1, model.latent_dim,
                                           MIRAGE_SAMPLES // model.downsampling_ratio),
                                          generator=g, device="cuda").to(torch.bfloat16),
              "s1_noise": torch.randn((1, model.latent_diffae.latent_dim, MIRAGE_SAMPLES //
                                       model.latent_diffae.autoencoder.downsampling_ratio),
                                      generator=g, device="cuda").to(torch.bfloat16)}
    fakes2, _, gen_s, stages = run(**noises)
    expected = {"k3": INNER_STEPS * K3_PER_INNER, "k5": INNER_STEPS * K5_PER_INNER,
                "k1": OUTER_STEPS * K1_PER_OUTER}
    finite = bool(torch.isfinite(fakes).all())
    in_range = bool((lat.abs() <= 1).all())
    emit({"phase": "mirage", "samples": MIRAGE_SAMPLES, "batch": 1, "cfg_scale": 4,
          "inner_steps": INNER_STEPS, "outer_steps": OUTER_STEPS, "dtype": "bfloat16",
          "init_s": init_s, "first_generate_s": first_s, "first_stages_s": first_stages,
          "inner_s": stages["inner_s"], "outer_s": stages["outer_s"],
          "ae_decode_s": stages["decode_s"], "generate_s": gen_s,
          "inner_ms_per_step": stages["inner_s"] / INNER_STEPS * 1e3,
          "outer_ms_per_step": stages["outer_s"] / OUTER_STEPS * 1e3,
          "realtime_factor": MIRAGE_SAMPLES / 48000 / gen_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "out_shape": list(fakes.shape), "finite": finite, "latents_in_range": in_range,
          "launches": counts, "launches_expected": expected, "k5_routes": k5_routes})
    if tuple(fakes.shape) != (2, MIRAGE_SAMPLES) or not finite or not in_range:
        raise AssertionError(f"mirage output {tuple(fakes.shape)} finite={finite} "
                             f"latents in range={in_range}")
    if counts != expected:
        raise AssertionError(f"mirage launches {counts}, expected {expected}")
    if k5_routes != {"cluster": expected["k5"], "two_pass": 0}:
        raise AssertionError(f"mirage K5 routes {k5_routes}: every inner-UNet shape should "
                             f"take the one-launch cluster route")
    return model, counts, {"emb": emb, "noises": noises, "fakes": fakes2, "generate_s": gen_s,
                           "stages": stages}


def phase_mirage_turbo(model=None, mirage_ref=None) -> dict:
    """MIRAGE's and the stacked AE's turbo routes at full width, bf16,
    through the entry points a user calls. The mirage phase's CLAPDAE()
    turned turbo: a batch-1 generate (150 + 100 steps, CFG 4) from that
    phase's steady-run noises, int8 inside the fold at every outer step,
    against its bf16 generate (rel-RMS in (1e-4, 0.08)), stage seconds
    beside the bf16 ones, K1 and int8-conv5 counts; one outer-UNet forward
    in the int8-in-fold mode through K1 against the same through K1's twin
    (MIRAGE_REL_RMS_BOUND bf16), each route's forward ms beside the float
    forward's; a batch-4 generate at 20 + 10 steps (the default
    micro-batch: 9 levels int8); 16 rows at MIRAGE_TURBO_B16_STEPS
    (`_sixteen_rows`): decode_batch 16 on the amax carry (K2a/b/c counted
    as the stacked AE's carry decode), decode_batch 4 int8 in the fold,
    each against the bf16 generate of the same noises (rel-RMS in (1e-4,
    0.08)). Then StackedDiffAEWrapper(turbo=True) at
    its default width, decode_stage1to2 of (16, 32, 2048) stage-2 latents
    for 10 steps on the amax carry (K2a/b/c) against its float route from
    the same noise; and one carry step of its diffusion_v_aux (the q_aux of
    a step before) with every K2 call held against its twin on the same
    inputs under K2's tolerances (`k2_compare`), then the same step through
    the twins of K1 and K2 (MIRAGE_REL_RMS_BOUND bf16). Without the mirage
    phase's state (--only) it runs that phase first."""
    import torch
    from audio_algebra_torch.given_models import StackedDiffAEWrapper
    from audio_algebra_torch.models import blocks
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.parallel.fold import (decode_unet_seqfold, pick_fold_blocks,
                                                   pick_folded_levels)

    if model is None or mirage_ref is None:
        model, _, mirage_ref = phase_mirage()
    int8_convs = [0]
    real_conv = blocks.conv1d_int8

    def counted_conv(*args, **kwargs):
        int8_convs[0] += 1
        return real_conv(*args, **kwargs)

    def zero():
        gn.launches = gn.quant_launches = gn.amax_launches = gn.amax_q_launches = 0
        int8_convs[0] = 0

    def counts():
        return {"k1": gn.launches, "k2a": gn.quant_launches, "k2b": gn.amax_launches,
                "k2c": gn.amax_q_launches, "int8_conv5": int8_convs[0]}

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    la = model.latent_diffae
    unet = la.diffusion
    t_len = MIRAGE_SAMPLES // la.autoencoder.downsampling_ratio
    levels = {b: pick_folded_levels(t_len, pick_fold_blocks(b, 32), unet.depth,
                                    unet.attn_start) for b in (1, 4)}
    emb, noises = mirage_ref["emb"], mirage_ref["noises"]
    blocks.conv1d_int8 = counted_conv
    model.turbo = True
    gen_state = model.generator.get_state()          # later phases draw as before
    try:
        with torch.inference_mode():
            model.generate(emb, cfg_scales=4, demo_steps=2, outer_steps=2)      # warm-up
            zero()
            (fakes, lat), gen_s = timed(lambda: model.generate(
                emb, cfg_scales=4, demo_steps=INNER_STEPS, outer_steps=OUTER_STEPS,
                batch_size=1, stage_times=True, **noises))
            stages = dict(model.last_stage_times)
            gen_counts = counts()
            # one outer forward in the int8-in-fold mode: K1, then K1's twin
            x, t = noises["s1_noise"], torch.full((1,), 0.5, device="cuda", dtype=lat.dtype)
            fwd = {"int8_fold": lambda: decode_unet_seqfold(unet, x, t, lat, quantized=True),
                   "float": lambda: unet(x, t, lat)}
            out = {k: f().float() for k, f in fwd.items()}
            fwd_ms = {k: cuda_ms(f, 5) for k, f in fwd.items()}
            blocks.groupnorm1_gelu = gn.groupnorm1_gelu_ref
            try:
                plain = {k: f().float() for k, f in fwd.items()}
            finally:
                blocks.groupnorm1_gelu = gn.groupnorm1_gelu
            zero()
            (fakes4, _), gen4_s = timed(lambda: model.generate(
                emb, cfg_scales=4, demo_steps=MIRAGE_TURBO_B4_STEPS[0],
                outer_steps=MIRAGE_TURBO_B4_STEPS[1], batch_size=4, stage_times=True))
            stages4 = dict(model.last_stage_times)
            b4_counts = counts()
            b16 = _sixteen_rows(model, emb, t_len, zero, counts, timed)
    finally:
        model.turbo = False
        model.decode_batch = model.DECODE_BATCH
        model.generator.set_state(gen_state)
        blocks.conv1d_int8 = real_conv
    gen_rel = rel_rms(fakes.float(), mirage_ref["fakes"].float())
    fwd_err = {k: rel_rms(out[k], plain[k]) for k in out}
    gen_expected = {"k1": OUTER_STEPS * K1_PER_OUTER, "k2a": 0, "k2b": 0, "k2c": 0,
                    "int8_conv5": OUTER_STEPS * 12 * levels[1]}
    b4_expected = {"k1": MIRAGE_TURBO_B4_STEPS[1] * K1_PER_OUTER, "k2a": 0, "k2b": 0, "k2c": 0,
                   "int8_conv5": MIRAGE_TURBO_B4_STEPS[1] * 12 * levels[4]}
    outer16 = MIRAGE_TURBO_B16_STEPS[1]
    b16_expected = {     # carry: the stacked AE's per-step counts (its int8 conv5s not held)
        "carry": {k: STACKED_STEP0[k] + (outer16 - 1) * STACKED_STEP[k] for k in STACKED_STEP},
        "fold": {"k1": 4 * outer16 * K1_PER_OUTER, "k2a": 0, "k2b": 0, "k2c": 0,
                 "int8_conv5": 4 * outer16 * 12 * levels[4]},
        "bf16": {"k1": outer16 * K1_PER_OUTER, "k2a": 0, "k2b": 0, "k2c": 0, "int8_conv5": 0}}
    b16_rel = {route: rel_rms(b16[route]["fakes"].float(), b16["bf16"]["fakes"].float())
               for route in ("carry", "fold")}

    w = StackedDiffAEWrapper(device="cuda", dtype=torch.bfloat16, turbo=True)
    w.ensure_params()
    g = torch.Generator(device="cuda").manual_seed(12)
    n = MIRAGE_SAMPLES // w.model.downsampling_ratio
    small = torch.tanh(torch.randn((STACKED_TURBO_B, w.model.second_stage_latent_dim, n),
                                   generator=g, device="cuda")).to(torch.bfloat16)
    s_noise = torch.randn((STACKED_TURBO_B, w.latent_dim, n * w.latent_downsampling_ratio),
                          generator=g, device="cuda").to(torch.bfloat16)
    decoded, st_s = {}, {}
    for turbo in (False, True):                       # warm-ups: plans, allocator
        w.turbo = turbo
        w.decode_stage1to2(small, steps=1, noise=s_noise)
    for turbo in (False, True):
        w.turbo = turbo
        zero()
        decoded[turbo], st_s[turbo] = timed(lambda: w.decode_stage1to2(
            small, steps=STACKED_TURBO_STEPS, noise=s_noise))
    st_counts = counts()
    del st_counts["int8_conv5"]                       # not counted here

    # one carry step: each K2 call beside its twin, then the step on the twins
    k2_calls = []

    def checked(kernel, twin):
        def call(*args, **kwargs):
            got = kernel(*args, **kwargs)
            k2_calls.append({"fn": kernel.__name__, "shape": list(args[0].shape),
                             "carry": kwargs.get("q_emit_scale") is not None,
                             **k2_compare(got, twin(*args, **kwargs), args[0].dtype)})
            return got
        return call

    swapped = ("groupnorm1_gelu", "groupnorm1_gelu_quant", "groupnorm1_gelu_res_amax")
    with torch.inference_mode():
        t_half = torch.full((STACKED_TURBO_B,), 0.5, device="cuda", dtype=small.dtype)
        _, q_aux = w.model.diffusion_v_aux(s_noise, t_half, small)
        blocks.groupnorm1_gelu_quant = checked(gn.groupnorm1_gelu_quant,
                                               gn.groupnorm1_gelu_quant_ref)
        blocks.groupnorm1_gelu_res_amax = checked(gn.groupnorm1_gelu_res_amax,
                                                  gn.groupnorm1_gelu_res_amax_ref)
        try:
            step = {"kernels": w.model.diffusion_v_aux(s_noise, t_half, small, q_aux=q_aux)[0]}
            for name in swapped:
                setattr(blocks, name, getattr(gn, f"{name}_ref"))
            step["twins"] = w.model.diffusion_v_aux(s_noise, t_half, small, q_aux=q_aux)[0]
        finally:
            for name in swapped:
                setattr(blocks, name, getattr(gn, name))
    step_rel = rel_rms(step["kernels"].float(), step["twins"].float())
    k2_worst = {fn: max((c for c in k2_calls if c["fn"] == fn), key=lambda c: c["max_abs_err"])
                for fn in {c["fn"] for c in k2_calls}}
    k2_bad = [c for c in k2_calls if c["n_outside_tol"]]
    del step
    st_expected = {k: STACKED_STEP0[k] + (STACKED_TURBO_STEPS - 1) * STACKED_STEP[k]
                   for k in STACKED_STEP}
    st_rel = rel_rms(decoded[True].float(), decoded[False].float())
    finite = all(bool(torch.isfinite(v).all()) for v in (
        fakes, fakes4, *decoded.values(), *(r["fakes"] for r in b16.values())))
    row = {"phase": "mirage_turbo", "dtype": "bfloat16", "card": card(),
           "generate": {"samples": MIRAGE_SAMPLES, "batch": 1, "cfg_scale": 4,
                        "steps": [INNER_STEPS, OUTER_STEPS], "folded_levels": levels[1],
                        "generate_s": gen_s, "bf16_generate_s": mirage_ref["generate_s"],
                        "stages_s": stages, "bf16_stages_s": mirage_ref["stages"],
                        "outer_over_bf16": stages["outer_s"] / mirage_ref["stages"]["outer_s"],
                        "rel_rms_vs_bf16": gen_rel, "bound": [1e-4, TURBO_REL_RMS_BOUND],
                        "launches": gen_counts, "launches_expected": gen_expected},
           "outer_forward": {"shape": list(x.shape), "rel_rms_kernel_vs_plain": fwd_err,
                             "bound": MIRAGE_REL_RMS_BOUND["bfloat16"], "ms": fwd_ms},
           "generate_b4": {"batch": 4, "steps": list(MIRAGE_TURBO_B4_STEPS),
                           "folded_levels": levels[4], "generate_s": gen4_s,
                           "stages_s": stages4, "launches": b4_counts,
                           "launches_expected": b4_expected, "out_shape": list(fakes4.shape)},
           "generate_b16": {
               "batch": 16, "steps": list(MIRAGE_TURBO_B16_STEPS),
               "rel_rms_vs_bf16": b16_rel, "bound": [1e-4, TURBO_REL_RMS_BOUND],
               "launches_expected": b16_expected,
               **{route: {k: v for k, v in r.items() if k != "fakes"}
                  for route, r in b16.items()},
               "carry_outer_s_per_row_over_fold": b16["carry"]["outer_s_per_row"]
               / b16["fold"]["outer_s_per_row"]},
           "stacked": {"batch": [STACKED_TURBO_B, *small.shape[1:]], "t_len": s_noise.shape[-1],
                       "steps": STACKED_TURBO_STEPS, "turbo_s": st_s[True],
                       "float_s": st_s[False], "turbo_over_float": st_s[True] / st_s[False],
                       "rel_rms_turbo_vs_float": st_rel, "bound": [1e-4, TURBO_REL_RMS_BOUND],
                       "launches": st_counts, "launches_expected": st_expected,
                       "carry_step_k2_calls": len(k2_calls),
                       "carry_step_k2_carry_calls": sum(c["carry"] for c in k2_calls),
                       "carry_step_k2_shapes": sorted({tuple(c["shape"]) for c in k2_calls}),
                       "carry_step_k2_worst": k2_worst, "carry_step_k2_outside": k2_bad[:4],
                       "carry_step_rel_rms_kernels_vs_twins": step_rel,
                       "carry_step_bound": MIRAGE_REL_RMS_BOUND["bfloat16"]},
           "finite": finite}
    emit(row)
    faults = []
    if not 1e-4 < gen_rel < TURBO_REL_RMS_BOUND or not 1e-4 < st_rel < TURBO_REL_RMS_BOUND:
        faults.append(f"turbo rel-RMS: generate {gen_rel}, stacked {st_rel}")
    if not fwd_err["int8_fold"] < MIRAGE_REL_RMS_BOUND["bfloat16"]:
        faults.append(f"int8-in-fold forward through K1 vs twin {fwd_err}")
    k2_per_step = STACKED_STEP["k2a"] + STACKED_STEP["k2b"] + STACKED_STEP["k2c"]
    if k2_bad or len(k2_calls) != k2_per_step or not step_rel < MIRAGE_REL_RMS_BOUND["bfloat16"]:
        faults.append(f"stacked carry step: {len(k2_bad)} of {len(k2_calls)} K2 calls off "
                      f"their twins, kernels vs twins rel-RMS {step_rel}")
    if gen_counts != gen_expected or b4_counts != b4_expected or st_counts != st_expected:
        faults.append(f"launches {gen_counts}, {b4_counts}, {st_counts}")
    b16_counts = {route: r["launches"] for route, r in b16.items()}
    checked = {route: {k: c[k] for k in b16_expected[route]} for route, c in b16_counts.items()}
    if checked != b16_expected or not all(b16_counts["carry"][k] for k in ("k2a", "k2b", "k2c")):
        faults.append(f"16-row launches {b16_counts}, expected {b16_expected}")
    if not all(1e-4 < v < TURBO_REL_RMS_BOUND for v in b16_rel.values()):
        faults.append(f"16-row turbo rel-RMS against bf16 {b16_rel}")
    if tuple(fakes.shape) != (2, MIRAGE_SAMPLES) or tuple(fakes4.shape) != (2, 4 * MIRAGE_SAMPLES) \
            or any(tuple(r["fakes"].shape) != (2, 16 * MIRAGE_SAMPLES) for r in b16.values()) \
            or not finite:
        faults.append("outputs")
    if faults:
        raise AssertionError(f"mirage_turbo: {faults}")
    return {"mirage_turbo": gen_counts, "stacked_turbo": st_counts,
            "mirage_turbo_carry": b16_counts["carry"]}


def _sixteen_rows(model, emb, t_len: int, zero, counts, timed) -> dict:
    """16 rows from seeded noises through `model.generate` three ways, the
    launch counts zeroed before each: turbo at decode_batch 16 (one
    micro-batch: the amax carry), turbo at 4 (four: int8 in the fold), and
    bf16 at 16 (turbo off), each after a 1 + 1-step warm-up. Each with its
    stage seconds, outer seconds a row and peak device memory."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(16)
    n_latent = MIRAGE_SAMPLES // model.downsampling_ratio
    noises = {"latent_noise": torch.randn((16, model.latent_dim, n_latent), generator=g,
                                          device="cuda").to(torch.bfloat16),
              "s1_noise": torch.randn((16, model.latent_diffae.latent_dim, t_len), generator=g,
                                      device="cuda").to(torch.bfloat16)}
    out = {}
    for route, turbo, decode_batch in (("carry", True, 16), ("fold", True, 4),
                                       ("bf16", False, 16)):
        model.turbo, model.decode_batch = turbo, decode_batch
        model.generate(emb, cfg_scales=4, demo_steps=1, outer_steps=1, batch_size=16,
                       **noises)                          # warm-up: plans, cuDNN, allocator
        zero()
        torch.cuda.reset_peak_memory_stats()
        (fakes, _), gen_s = timed(lambda: model.generate(
            emb, cfg_scales=4, demo_steps=MIRAGE_TURBO_B16_STEPS[0],
            outer_steps=MIRAGE_TURBO_B16_STEPS[1], batch_size=16, stage_times=True, **noises))
        stages = dict(model.last_stage_times)
        out[route] = {"decode_batch": decode_batch, "turbo": turbo, "generate_s": gen_s,
                      "stages_s": stages, "outer_s_per_row": stages["outer_s"] / 16,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": counts(), "fakes": fakes}
    return out


def stft_bounds(rows: int, t_len: int, n_fft: int, n_frames: int) -> dict:
    """Least time for the STFT: read the signal once and write the complex64
    output once, or an FFT's ~5 (n_fft / 2) log2(n_fft / 2) f32 operations a
    frame at the f32 peak, whichever is larger; and beside it, under its own
    name, the DFT product's 4 n_fft n_bins operations a frame at that peak
    (what the DFT route does)."""
    n_bins = n_fft // 2 + 1
    t_bytes = (rows * t_len * 4 + rows * n_bins * n_frames * 8) / HBM_BYTES_PER_S * 1e3
    half = n_fft // 2
    t_fft = 5 * half * math.log2(half) * rows * n_frames / F32_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_fft else (t_fft, "operations")
    return {"bound_ms": bound[0], "bound_by": bound[1],
            "dft_operations_ms": 4 * n_fft * n_bins * rows * n_frames / F32_OPS_PER_S * 1e3}


def k6_route_launches() -> dict:
    """K6's launch counters, by route."""
    from audio_algebra_torch.ops import stft_kernel as stk
    return {route: getattr(stk, f"{route}_launches") for route in K6_ROUTES}


def phase_kernels_k6() -> tuple:
    """K6 on each route (ops/stft_kernel.plan), each row against its twin
    and float64 and timed beside the twin, torch.stft and the bounds: the
    power-of-two FFT at the spectrogram models' shape, at CLAP's 22 s clip,
    at DMAE's mel (center=False, no reflect pad) and at PitchShift's (2
    clips x 2 channels, 262144; n_fft 2048, hop 512) on the effects and
    xae paths; the mixed-radix FFT at non-power-of-two n_fft; the chirp-z
    route at n_fft whose half has a prime factor above 13 and at odd n_fft;
    the cluster route above 8192; the DFT product below 16; and shapes
    whose 32-frame span the card once refused. Then the short clips
    (`_short_clip_rows`) on each route. Returns the rows by case and the
    short clips' rows."""
    import torch
    from audio_algebra_torch.ops import stft_kernel as stk

    dev = torch.device("cuda")
    cases = [  # (case, shape, n_fft, hop, center); the first row of each route first
        ("fft", (32, 65536), 1024, 256, True),              # the spectrogram models
        ("clap", (1, CLAP_LONG), 1024, 480, True),          # CLAP's 22 s mel
        ("center_false", DMAE_STFT, 1024, 256, False),      # DMAE's mel
        ("pitch_shift", PITCH_STFT, 2048, 512, True),       # effects, xae
        ("fft_1000", (32, 65536), 1000, 250, True),         # radices 4, 5, 5, 5
        ("fft_1920", (32, 65536), 1920, 480, True),         # 8, 8, 3, 5: 40 ms / 10 ms at 48 kHz
        ("fft_1536", (32, 65536), 1536, 384, True),         # 4, 8, 8, 3
        ("fft_1408", (32, 65536), 1408, 128, True),         # 8, 8, 11: the JAX kernel's largest
        ("fft_384", (32, 65536), 384, 128, True),           # 8, 8, 3
        ("cluster_8192", (4, 262144), 8192, 2048, True),    # a CTA a frame, 4 a cluster
        ("fft_2000", (8, 48000), 2000, 2000, True),         # 8, 5, 5, 5: frames without overlap
        ("chirp_1018", (32, 65536), 1018, 250, True),       # half 509, a prime: M = 1024
        ("chirp_2018", (8, 48000), 2018, 2018, True),       # half 1009, no overlap: M = 2048
        ("chirp_1102", (32, 65536), 1102, 441, True),       # 25 / 10 ms at 44.1 kHz: M = 2048
        ("chirp_999", (32, 65536), 999, 250, True),         # odd, two frames a transform
        ("cluster_16384", (4, 262144), 16384, 4096, True),  # 2 CTAs, no chirp
        ("cluster_10000", (4, 262144), 10000, 2500, True),  # half 5000: 2 parts of 2500
        ("cluster_8194", (4, 262144), 8194, 2048, True),    # half 4097: chirp-z on 4 CTAs
        ("dft_14", (32, 65536), 14, 4, True),               # below 16: the DFT product
    ]
    rows = {}
    for case, shape, n_fft, hop, center in cases:
        g = torch.Generator(device=dev).manual_seed(400 + len(rows))
        x = torch.randn(shape, generator=g, device=dev) * 0.5
        route, radices = stk.plan(n_fft)
        before = k6_route_launches()
        got = stk.stft_fused(x, n_fft, hop, center)
        torch.cuda.synchronize()
        took = {k: n - before[k] for k, n in k6_route_launches().items()}
        want = stk.stft_ref(x, n_fft, hop, center)
        atol, rtol = STFT_TOL
        err = (got - want).abs()
        window = torch.hann_window(n_fft, device=dev)
        # both against the same STFT in float64: how far each is from exact
        exact = torch.stft(x.double(), n_fft, hop, window=window.double(), center=center,
                           pad_mode="reflect", return_complex=True)
        rows[case] = {
            "case": case, "route": route, "radices": list(radices), "route_launches": took,
            "shape": list(shape), "n_fft": n_fft, "hop": hop, "center": center,
            "dtype": "float32",
            "out_shape": list(got.shape), "max_abs_err": float(err.max()), "atol": atol,
            "rtol": rtol, "n_outside_tol": int((err > atol + rtol * want.abs()).sum()),
            "kernel_max_abs_err_vs_f64": float((got - exact).abs().max()),
            "n_outside_tol_vs_f64": int(((got - exact).abs() > atol + rtol * exact.abs()).sum()),
            "plain_max_abs_err_vs_f64": float((want - exact).abs().max()),
            "kernel_ms": cuda_ms(lambda: stk.stft_fused(x, n_fft, hop, center), 20),
            "plain_ms": cuda_ms(lambda: stk.stft_ref(x, n_fft, hop, center), 20),
            "library_ms": cuda_ms(lambda: torch.stft(
                x, n_fft, hop, window=window, center=center, pad_mode="reflect",
                return_complex=True), 20),
            "kernel_device_ms": device_ms(lambda: stk.stft_fused(x, n_fft, hop, center), 20),
            "library_device_ms": device_ms(lambda: torch.stft(
                x, n_fft, hop, window=window, center=center, pad_mode="reflect",
                return_complex=True), 20),
            **stft_bounds(shape[0], shape[1], n_fft, got.shape[-1])}
        del x, got, want, err, exact
    short = _short_clip_rows(dev)
    emit({"phase": "kernels", "kernel": "stft", "cases": list(rows.values()),
          "short_clips": short})
    failed = [r for r in [*rows.values(), *short] if r["n_outside_tol"] or r["route_launches"]
              != {k: int(k == r["route"]) for k in K6_ROUTES}]
    failed += [r for r in [*rows.values(), *short] if r["n_outside_tol_vs_f64"]]
    if failed:
        raise AssertionError(f"K6 disagrees with its twin or float64, or took the wrong "
                             f"route: {failed}")
    # the FFTs (the chirp-z and cluster routes' too) round like log n_fft,
    # the DFT product like sqrt(n_fft)
    farther = [r for r in rows.values() if r["route"] != "dft"
               and r["kernel_max_abs_err_vs_f64"] > r["plain_max_abs_err_vs_f64"]]
    if farther:
        raise AssertionError(f"K6's FFT is farther from float64 than its twin: {farther}")
    return rows, short


def _short_clip_rows(dev) -> list:
    """K6 at clips of T in {1, 2, n_fft / 4, n_fft / 2, n_fft / 2 + 1}
    samples (2-4 rows) for each SHORT_CLIP_STFT shape, centred: the reflect
    padding of n_fft / 2 folds as numpy's does, as often as the clip needs.
    Each against the twin and against a float64 torch.stft of numpy's
    reflect-padded clip (center=False), both under STFT_TOL, and timed
    beside the twin and the library call, torch.stft of the padded clip
    (center=False: torch.stft reflects a pad shorter than the clip only),
    with the bounds."""
    import numpy as np
    import torch
    from audio_algebra_torch.ops import stft_kernel as stk

    atol, rtol = STFT_TOL
    out = []
    for n_fft, hop in SHORT_CLIP_STFT:
        half = n_fft // 2
        window = torch.hann_window(n_fft, dtype=torch.float64, device=dev)
        for t_len in (1, 2, n_fft // 4, half, half + 1):
            g = torch.Generator(device=dev).manual_seed(500 + len(out))
            x = torch.randn((2 + t_len % 3, t_len), generator=g, device=dev) * 0.5
            before = k6_route_launches()
            got = stk.stft_fused(x, n_fft, hop)
            torch.cuda.synchronize()
            took = {k: n - before[k] for k, n in k6_route_launches().items()}
            want = stk.stft_ref(x, n_fft, hop)
            padded = np.pad(x.double().cpu().numpy(), ((0, 0), (half, half)), mode="reflect")
            exact = torch.stft(torch.from_numpy(padded).to(dev), n_fft, hop, window=window,
                               center=False, return_complex=True)
            padded32, window32 = torch.from_numpy(padded).float().to(dev), window.float()
            err, err64 = (got - want).abs(), (got.to(exact.dtype) - exact).abs()
            out.append({
                "n_fft": n_fft, "hop": hop, "t_len": t_len, "shape": list(x.shape),
                "route": stk.plan(n_fft).route, "route_launches": took,
                "out_shape": list(got.shape), "max_abs_err": float(err.max()),
                "n_outside_tol": int((err > atol + rtol * want.abs()).sum()),
                "max_abs_err_vs_f64": float(err64.max()),
                "n_outside_tol_vs_f64": int((err64 > atol + rtol * exact.abs()).sum()),
                "plain_max_abs_err_vs_f64": float((want.to(exact.dtype) - exact).abs().max()),
                "kernel_ms": cuda_ms(lambda: stk.stft_fused(x, n_fft, hop), 20),
                "plain_ms": cuda_ms(lambda: stk.stft_ref(x, n_fft, hop), 20),
                "library_ms": cuda_ms(lambda: torch.stft(
                    padded32, n_fft, hop, window=window32, center=False,
                    return_complex=True), 20),
                **stft_bounds(x.shape[0], t_len, n_fft, got.shape[-1])})
    return out


def _synced_s(fn):
    import torch
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def _with_twin_stft(fn):
    """Run fn with the port's stft routed through K6's plain twin."""
    from audio_algebra_torch.ops import stft_kernel as stk
    kernel = stk.stft_fused
    stk.stft_fused = stk.stft_ref
    try:
        return fn()
    finally:
        stk.stft_fused = kernel


def phase_spectrogram() -> tuple:
    """The four spectrogram given models at full size through their entry
    points, K6's launches counted over the run; then, outside the count,
    the Mag and Mel decodes again through the twin. Then one model a K6
    route (SPEC_ROUTES: the mixed-radix FFT, the chirp-z route, the cluster
    route), each run's launches counted alone, and its decode through the
    twin. Returns the launches of all runs and those of the route runs by
    route."""
    import numpy as np
    import torch
    from audio_algebra_torch import given_models as gm
    from audio_algebra_torch.ops import stft_kernel as stk

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    t = np.arange(SPEC_SHAPE[-1]) / 48000
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000, (SPEC_SHAPE[0], 2, 1)) * t)
    clip = (tone + 0.05 * rng.standard_normal(SPEC_SHAPE)).astype(np.float32)
    models = {"SpectrogramAE": gm.SpectrogramAE(device="cuda"),
              "MagSpectrogramAE": gm.MagSpectrogramAE(device="cuda", n_iter=SPEC_ITERS),
              "MelSpectrogramAE": gm.MelSpectrogramAE(device="cuda", n_iter=SPEC_ITERS),
              "MagDPhaseSpectrogramAE": gm.MagDPhaseSpectrogramAE(device="cuda")}
    x = torch.from_numpy(clip).to(dev)
    angles = torch.rand((*SPEC_SHAPE[:2], 513, SPEC_SHAPE[-1] // 256 + 1),
                        generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev) * (2 * math.pi)
    for name, m in models.items():                          # warm-up: first-use loads
        kw = {"init_angle": angles[:1]} if name in ("MagSpectrogramAE",
                                                    "MelSpectrogramAE") else {}
        m.decode(m.encode(x[:1]), **kw)
    rows, reps, outs = {}, {}, {}
    stk.launches = stk.fft_launches = 0
    for name, m in models.items():
        reps[name], enc_s = _synced_s(lambda: m.encode(x))
        kw = {"init_angle": angles} if name in ("MagSpectrogramAE", "MelSpectrogramAE") else {}
        outs[name], dec_s = _synced_s(lambda: m.decode(reps[name], **kw))
        rows[name] = {"encode_ms": enc_s * 1e3, "decode_ms": dec_s * 1e3,
                      "reps_shape": list(reps[name].shape), "out_shape": list(outs[name].shape)}
    launches, fft_launches = stk.launches, stk.fft_launches

    def rel_mse(a):
        return float((a - x).square().mean() / x.square().mean())

    ref_mag = stk.stft_ref(x, 1024, 256).abs()
    for name, out in outs.items():
        sc = (stk.stft_ref(out, 1024, 256).abs() - ref_mag).norm() / ref_mag.norm()
        rows[name].update({"spectral_convergence": float(sc), "rel_mse": rel_mse(out),
                           "finite": bool(torch.isfinite(out).all())})
    for name in ("MagSpectrogramAE", "MelSpectrogramAE"):
        m = models[name]
        twin = _with_twin_stft(lambda: m.decode(reps[name], init_angle=angles))
        nudge = 1 + 1e-6 * torch.randn(reps[name].shape, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(7))
        spread = _with_twin_stft(lambda: m.decode(reps[name] * nudge, init_angle=angles))
        rows[name].update({"rel_rms_kernel_vs_twin": rel_rms(outs[name], twin),
                           "twin_spread_1e-6": rel_rms(spread, twin)})
    emit({"phase": "spectrogram", "shape": list(SPEC_SHAPE), "n_fft": 1024, "hop": 256,
          "n_iter": SPEC_ITERS, "models": rows, "round_trip_bounds": ROUND_TRIP,
          "gl_rel_rms_bound": GL_REL_RMS, "k6_launches": launches,
          "k6_expected": K6_SPECTROGRAM})
    for name, r in rows.items():
        if r["out_shape"] != list(SPEC_SHAPE) or not r["finite"]:
            raise AssertionError(f"{name} decoded {r}")
    for name, bound in ROUND_TRIP.items():
        if not rows[name]["rel_mse"] < bound:
            raise AssertionError(f"{name} round trip rel MSE {rows[name]['rel_mse']}")
    for name in ("MagSpectrogramAE", "MelSpectrogramAE"):
        r = rows[name]
        if not r["rel_rms_kernel_vs_twin"] < max(GL_REL_RMS, r["twin_spread_1e-6"]):
            raise AssertionError(f"{name} through K6 vs twin: {r}")
    if launches != K6_SPECTROGRAM or fft_launches != launches:
        raise AssertionError(f"K6 launched {launches} times ({fft_launches} on the FFT "
                             f"route), expected {K6_SPECTROGRAM}, all FFT")
    by_route = {r[-1]: _spectrogram_route(x, *r) for r in SPEC_ROUTES}
    return launches + sum(by_route.values()), by_route


def _spectrogram_route(x, name: str, sample_rate: int, n_fft: int, hop: int,
                       route: str) -> int:
    """One spectrogram model of SPEC_ROUTES on the spectrogram phase's
    clips: an encode and a Griffin-Lim decode through K6 (counted alone:
    all on `route`), the same decode through the twin and the twin's
    spread under a 1e-6 change of the model's input to Griffin-Lim.
    Returns K6's launches."""
    import torch
    from audio_algebra_torch import given_models as gm
    from audio_algebra_torch.ops import stft_kernel as stk

    dev = x.device
    kw = {"sample_rate": sample_rate} if name == "MelSpectrogramAE" else {}
    model = getattr(gm, name)(device="cuda", n_fft=n_fft, hop_length=hop, n_iter=SPEC_ITERS,
                              **kw)
    assert stk.plan(n_fft).route == route, (n_fft, stk.plan(n_fft))
    angles = torch.rand((*SPEC_SHAPE[:2], n_fft // 2 + 1, SPEC_SHAPE[-1] // hop + 1),
                        generator=torch.Generator(device=dev).manual_seed(8),
                        device=dev) * (2 * math.pi)
    model.decode(model.encode(x[:1]), init_angle=angles[:1])      # warm-up: tables
    stk.launches = 0
    for r in K6_ROUTES:
        setattr(stk, f"{r}_launches", 0)
    reps, enc_s = _synced_s(lambda: model.encode(x))
    out, dec_s = _synced_s(lambda: model.decode(reps, init_angle=angles))
    took = {"launches": stk.launches, **k6_route_launches()}
    twin = _with_twin_stft(lambda: model.decode(reps, init_angle=angles))
    nudge = 1 + 1e-6 * torch.randn(reps.shape, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(9))
    spread = _with_twin_stft(lambda: model.decode(reps * nudge, init_angle=angles))
    expected = {"launches": 1 + SPEC_ITERS,
                **{r: (1 + SPEC_ITERS) * (r == route) for r in K6_ROUTES}}
    row = {"n_fft": n_fft, "hop": hop, "sample_rate": sample_rate, "route": route,
           "radices": list(stk.plan(n_fft).radices),
           "encode_ms": enc_s * 1e3, "decode_ms": dec_s * 1e3,
           "reps_shape": list(reps.shape), "out_shape": list(out.shape),
           "finite": bool(torch.isfinite(out).all()),
           "rel_rms_kernel_vs_twin": rel_rms(out, twin), "twin_spread_1e-6": rel_rms(spread, twin),
           "k6_launches": took, "k6_expected": expected}
    emit({"phase": "spectrogram", "model": name, **row})
    if row["out_shape"] != list(SPEC_SHAPE) or not row["finite"]:
        raise AssertionError(f"{name} at {n_fft} / {hop} decoded {row}")
    if not row["rel_rms_kernel_vs_twin"] < max(GL_REL_RMS, row["twin_spread_1e-6"]):
        raise AssertionError(f"{name} at {n_fft} / {hop} through K6 vs twin: {row}")
    if took != expected:
        raise AssertionError(f"{name} at {n_fft} / {hop}: K6 launched {took}, "
                             f"expected {expected}")
    return took["launches"]


def phase_clap(model) -> int:
    """CLAP at full width through CLAPDAE.embed: two clips and two texts;
    the clips again through K6's twin, outside the count. Returns K6's
    launches."""
    import numpy as np
    import torch
    from audio_algebra_torch.ops import stft_kernel as stk

    clap = model.clap_module
    t0 = time.perf_counter()
    clap.ensure_params()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(8)
    clips = {}
    for name, n in (("short_5s", CLAP_SHORT), ("fusion_22s", CLAP_LONG)):
        t = np.arange(n) / 48000
        clips[name] = (np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                                 0.3 * np.sin(2 * np.pi * 331 * t)])
                       + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    texts = ["low brass ensemble", "a bright piano arpeggio"]
    for prompt in [*clips.values(), texts[0]]:              # warm-up: cuDNN plans
        model.embed(prompt)
    embs, ms = {}, {}
    stk.launches = 0
    for name, prompt in [*clips.items(), *zip(("text_0", "text_1"), texts)]:
        embs[name], sec = _synced_s(lambda: model.embed(prompt))
        ms[name] = sec * 1e3
    launches = stk.launches
    twin = {name: _with_twin_stft(lambda: model.embed(clips[name])) for name in clips}
    norms = {k: float(torch.linalg.vector_norm(e)) for k, e in embs.items()}
    rel = {k: float((embs[k] - twin[k]).abs().max() / twin[k].abs().max()) for k in clips}
    result = {"phase": "clap", "audio": "HTSAT-base fusion", "text": "RoBERTa-base",
              "dtype": "float32", "init_s": init_s, "embed_ms": ms,
              "shapes": {k: list(e.shape) for k, e in embs.items()}, "norms": norms,
              "finite": all(bool(torch.isfinite(e).all()) for e in embs.values()),
              "rel_diff_kernel_vs_twin": rel, "bound": CLAP_REL,
              "text_tokenizer": clap.tokenizer_backend()[0],
              "k6_launches": launches, "k6_expected": len(clips)}
    emit(result)
    if any(v != [1, 1, 512] for v in result["shapes"].values()) or not result["finite"] \
            or any(abs(v - 1.0) > 1e-4 for v in norms.values()):
        raise AssertionError(f"CLAP embeddings {result}")
    if any(not v < CLAP_REL for v in rel.values()):
        raise AssertionError(f"CLAP audio embeddings through K6 vs twin: {rel}")
    if launches != len(clips):
        raise AssertionError(f"K6 launched {launches} times over {len(clips)} clips")
    return launches


def phase_serve(model, io_files: dict) -> int:
    """The HTTP service in-process on localhost, around the warm model; a
    second service over the same model in strict-text mode; a third with
    the micro-batcher (4 concurrent requests, one generate) and a fourth
    with basic auth. Returns K6's launches over the requests."""
    import base64
    import io
    import threading
    import urllib.error
    import urllib.request
    import wave

    import numpy as np
    from audio_algebra_torch import serve
    from audio_algebra_torch.ops import stft_kernel as stk

    def start(svc):
        server = serve.make_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread, f"http://127.0.0.1:{server.server_address[1]}"

    def post(base, path, body, ctype="application/json", timeout=600, headers=()):
        data = json.dumps(body).encode() if ctype == "application/json" else body
        req = urllib.request.Request(f"{base}{path}", data=data,
                                     headers={"Content-Type": ctype, **dict(headers)})
        return urllib.request.urlopen(req, timeout=timeout)

    def get(base, path, headers=()):
        req = urllib.request.Request(f"{base}{path}", headers=dict(headers))
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers.get("Content-Type", ""), r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("WWW-Authenticate", ""), e.read()

    rng = np.random.default_rng(1)
    embs = [(v / np.linalg.norm(v)).tolist() for v in rng.standard_normal((2, 512))]
    specs = {"slerp": {"embeddings": embs, "interp": 0.3, "steps": 8, "outer_steps": 4,
                       "seed": 1},
             "algebra": {"embeddings": embs, "algebra": True, "weights": [1.0, -0.5],
                         "steps": 8, "outer_steps": 4, "seed": 2},
             "text": {"text": ["low brass"], "steps": 8, "outer_steps": 4, "seed": 3}}
    clip = io.BytesIO()
    t = np.arange(3 * 48000) / 48000
    with wave.open(clip, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48000)
        pcm = (np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)]) * 9000)
        w.writeframes(pcm.T.astype("<i2").tobytes())
    result = {"phase": "serve", "requests": {}}
    servers = []
    try:
        server, thread, base = start(serve.MirageService(model=model, verbose=False))
        servers.append((server, thread))
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            result["health"] = json.loads(r.read())
        stk.launches = 0
        for name, spec in specs.items():
            start_s = time.perf_counter()
            with post(base, "/generate", spec) as r:
                status, ctype, body = r.status, r.headers["Content-Type"], r.read()
                info = json.loads(r.headers["X-Generate-Info"])
            with wave.open(io.BytesIO(body)) as w:
                fmt = [w.getnchannels(), w.getframerate(), w.getnframes()]
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            result["requests"][name] = {
                "status": status, "content_type": ctype, "wav": fmt,
                "tokenizer_warning": "tokenizer_warning" in info,
                "seconds": time.perf_counter() - start_s, "rms": float(np.sqrt(
                    np.mean((pcm / 32767.0) ** 2)))}
        bodies = [("embed_text", {"text": "low brass"}, "application/json"),
                  ("embed_wav", clip.getvalue(), "audio/wav"),
                  ("embed_flac", io_files["flac"].read_bytes(), "application/octet-stream")]
        if io_files["ogg"]:
            bodies.append(("embed_ogg", io_files["ogg_path"].read_bytes(),
                           "application/octet-stream"))
        for name, body, ctype in bodies:
            start_s = time.perf_counter()
            with post(base, "/embed", body, ctype) as r:
                answer = json.loads(r.read())
            emb = np.asarray(answer["embedding"], np.float64)
            result["requests"][name] = {
                "status": r.status, "floats": int(emb.size), "norm": float(np.linalg.norm(emb)),
                "tokenizer_warning": "tokenizer_warning" in answer,
                "seconds": time.perf_counter() - start_s}
        launches = stk.launches
        code, ctype, page = get(base, "/")
        result["gui"] = {"status": code, "content_type": ctype, "bytes": len(page),
                         "title": b"<title>MIRAGE</title>" in page}
        # 4 concurrent single-variation requests, one sampler config: one
        # generate on the batched service; the same 4 one after another on
        # the plain one
        inner, outer = SERVE_BATCH_STEPS
        batch_specs = [{"embeddings": [embs[i % 2]], "interp": 0.5, "steps": inner,
                        "outer_steps": outer} for i in range(4)]
        server, thread, bbase = start(serve.MirageService(model=model, verbose=False,
                                                          batch_window_s=0.5))
        servers.append((server, thread))
        answers = [None] * 4

        def one(i):
            with post(bbase, "/generate", batch_specs[i]) as r:
                answers[i] = (r.status, len(r.read()))

        t0 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        batched_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"{bbase}/health", timeout=60) as r:
            bhealth = json.loads(r.read())
        t0 = time.perf_counter()
        for spec in batch_specs:
            with post(base, "/generate", spec) as r:
                r.read()
        serial_s = time.perf_counter() - t0
        result["batching"] = {"steps": [inner, outer], "window_s": 0.5,
                              "answers": answers, "batched_runs": bhealth["batched_runs"],
                              "coalesced_requests": bhealth["coalesced_requests"],
                              "wall_s_4_concurrent": batched_s, "wall_s_4_serial": serial_s}
        # basic auth from the environment: /health open, the rest 401 without
        os.environ["MIRAGE_USERNAME"], os.environ["MIRAGE_PASSWORD"] = "alice", "s3cret"
        try:
            server, thread, abase = start(serve.MirageService(model=model, verbose=False))
        finally:
            del os.environ["MIRAGE_USERNAME"], os.environ["MIRAGE_PASSWORD"]
        servers.append((server, thread))
        token = base64.b64encode(b"alice:s3cret").decode()
        result["auth"] = {"health": get(abase, "/health")[0],
                          "gui_without": get(abase, "/")[:2],
                          "gui_with": get(abase, "/", [("Authorization", f"Basic {token}")])[0],
                          "gui_wrong": get(abase, "/", [("Authorization", "Basic eDp5")])[0]}
        server, thread, base = start(serve.MirageService(model=model, verbose=False,
                                                         strict_text=True))
        servers.append((server, thread))
        try:
            post(base, "/generate", specs["text"], timeout=60)
            result["strict_text"] = None
        except urllib.error.HTTPError as e:
            result["strict_text"] = {"code": e.code, "error": json.loads(e.read())["error"]}
    finally:
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    result["k6_launches"] = launches
    emit(result)
    if not result["health"].get("ok"):
        raise AssertionError(f"/health answered {result['health']}")
    for name in specs:
        r = result["requests"][name]
        if r["status"] != 200 or r["content_type"] != "audio/wav" \
                or r["wav"] != [2, 48000, MIRAGE_SAMPLES]:
            raise AssertionError(f"/generate ({name}) answered {r}")
    fallback = result["health"]["text_tokenizer"] == "byte-fallback"
    if result["requests"]["text"]["tokenizer_warning"] != fallback:
        raise AssertionError(f"text prompt's tokenizer warning: {result['requests']['text']}")
    audio_embeds = ["embed_wav", "embed_flac"] + (["embed_ogg"] if io_files["ogg"] else [])
    for name, warned in [("embed_text", fallback)] + [(n, False) for n in audio_embeds]:
        r = result["requests"][name]
        if r["status"] != 200 or r["floats"] != 512 or abs(r["norm"] - 1) > 1e-4 \
                or r["tokenizer_warning"] != warned:
            raise AssertionError(f"/embed ({name}) answered {r}")
    if fallback and result["strict_text"] != {"code": 409,
                                              "error": "text_tokenizer_unavailable"}:
        raise AssertionError(f"strict-text service answered {result['strict_text']}")
    if launches != len(audio_embeds):
        raise AssertionError(f"the requests launched K6 {launches} times, expected "
                             f"{len(audio_embeds)} (the audio posted to /embed)")
    if not (result["gui"]["status"] == 200 and result["gui"]["title"]
            and result["gui"]["content_type"].startswith("text/html")):
        raise AssertionError(f"GET / answered {result['gui']}")
    b = result["batching"]
    if b["batched_runs"] != 1 or b["coalesced_requests"] != 4 \
            or any(a is None or a[0] != 200 for a in b["answers"]):
        raise AssertionError(f"micro-batcher: {b}")
    a = result["auth"]
    if a["health"] != 200 or a["gui_without"][0] != 401 \
            or not a["gui_without"][1].startswith("Basic") or a["gui_with"] != 200 \
            or a["gui_wrong"] != 401:
        raise AssertionError(f"basic auth: {a}")
    if any(thread.is_alive() for _, thread in servers):
        raise AssertionError("a server thread did not stop")
    return launches


def k4_bounds(shape, dtype, bias_dtype) -> dict:
    """Least times for K4a, K4b and K4c: each input read once and each
    output written once, or the products' operations (2, 4 and 3 products
    of 2 B H T^2 D operations) at the peak of q's type, whichever is
    larger. Inputs of the backward kernels: q, k, v, do, biasT and the
    three (H, B, T) f32 rows; K4c returns dq and dbT, which is like biasT.
    In f32, all three run their products as 3xTF32 on the tensor cores:
    their bounds are three TF32 passes of each product at the dense TF32
    peak ("k4a", "k4b", "k4c"), and the f32 CUDA-core bounds stand beside
    them as "k4a_f32_cuda_cores", "k4b_f32_cuda_cores" and
    "k4c_f32_cuda_cores"."""
    import torch
    b, h, t, d = shape
    e = torch.empty((), dtype=dtype).element_size()
    eb = torch.empty((), dtype=bias_dtype).element_size()
    qkv, bias, row = b * h * t * d * e, h * t * t * eb, h * b * t * 4
    peak = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    product = 2 * b * h * t * t * d
    out = {}
    for name, nbytes, n_products in (("k4a", 4 * qkv + bias + 2 * row, 2),
                                     ("k4b", 6 * qkv + bias + 3 * row, 4),
                                     ("k4c", 5 * qkv + 2 * bias + 3 * row, 3)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_products * product / peak * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        if dtype == torch.float32:
            out[f"{name}_f32_cuda_cores"] = out[name]
            t_tf32 = 3 * n_products * product / TF32_TC_OPS_PER_S * 1e3
            out[name] = (t_bytes, "bytes") if t_bytes >= t_tf32 else (t_tf32, "operations")
    return out


def phase_kernels_k4() -> dict:
    """K4a, K4b and K4c at the trainer's flash sites and beside them, each
    against its twin and timed beside the twin, SDPA and its bound; then the
    autograd Functions around K1 and K5. Returns the rows of the
    (8, 16, 1024, 64) f32 case, one per kernel."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    # (shape, dtype, bias dtype): the f32 trainer's sites, the bf16 step's
    # (batch 8 and 16, T = 1024 and 512) with a bf16 bias (the step's) and an
    # f32 one, a ragged bf16 shape (3 rows, 5 heads, T = 320), B = 1
    cases = [((8, 16, 1024, 64), f32, f32), ((8, 16, 512, 64), f32, f32),
             ((8, 16, 1024, 64), bf16, bf16), ((8, 16, 1024, 64), bf16, f32),
             ((8, 16, 512, 64), bf16, bf16), ((8, 16, 512, 64), bf16, f32),
             ((16, 16, 1024, 64), bf16, bf16), ((16, 16, 1024, 64), bf16, f32),
             ((3, 5, 320, 64), bf16, bf16), ((3, 5, 320, 64), bf16, f32),
             ((1, 16, 1024, 64), f32, f32)]
    rows = []
    for shape, dt, bias_dt in cases:
        g = torch.Generator(device=dev).manual_seed(500 + len(rows))
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt) for _ in range(4))
        h, t = shape[1], shape[2]
        bias_t = (torch.randn((h, t, t), generator=g, device=dev) * 0.5).to(bias_dt)
        scale = shape[3] ** -0.5
        name = str(dt).removeprefix("torch.")
        atol, rtol = K4_TOL[name]

        def compare(got, want):
            err = (got.float() - want.float()).abs()
            return float(err.max()), int((err > atol + rtol * want.float().abs()).sum())

        o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale)
        delta = fa.flash_delta(o, do)
        dk, dv = fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m, delta, scale)
        dq, db = fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m, delta, scale)
        torch.cuda.synchronize()
        o_ref, l_ref, m_ref = fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale)
        # the twin of the backward from the kernel's own residuals
        dq_ref, dk_ref, dv_ref, db_ref = fa.flash_attention_relpos_bwd_ref(
            q, k, v, bias_t, o, l, m, do, scale)
        # l is a sum of T f32 terms of exp: relative; m a max of scores: absolute
        resid = {"l_max_rel_err": float(((l - l_ref).abs() / l_ref).max()),
                 "m_max_abs_err": float((m - m_ref).abs().max())}
        def both(a, b):
            return max(a[0], b[0]), a[1] + b[1]

        # d(biasT) sums bf16 products' ds where q or the bias is bf16
        db_tol = K4_TOL["float32" if dt == bias_dt == f32 else "bfloat16"]
        db_err = (db.float() - db_ref.float()).abs()
        errs = {"k4a": compare(o, o_ref),
                "k4b": both(compare(dk, dk_ref), compare(dv, dv_ref)),
                "k4c": both(compare(dq, dq_ref),
                            (float(db_err.max()), int((db_err > db_tol[0] + db_tol[1]
                                                       * db_ref.float().abs()).sum())))}
        bad_resid = int(resid["l_max_rel_err"] > 1e-3) + int(resid["m_max_abs_err"] > 1e-3)
        del o_ref, l_ref, m_ref, dq_ref, dk_ref, dv_ref, db_ref, dk, dv, dq, db
        torch.cuda.empty_cache()

        mask = bias_t.transpose(1, 2)[None].to(dt)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, mask)]
        o_lib = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale)

        def sdpa_backward():
            return torch.autograd.grad(o_lib, leaves, do, retain_graph=True)

        big = shape[0] * t >= 8192
        times = {
            "k4a": (cuda_ms(lambda: fa.flash_attention_relpos_fwd(q, k, v, bias_t, scale), 10),
                    cuda_ms(lambda: fa.flash_attention_relpos_fwd_ref(q, k, v, bias_t, scale),
                            3 if big else 10, warmup=1),
                    cuda_ms(sdpa, 10)),
            "k4b": (cuda_ms(lambda: fa.flash_attention_relpos_dkv(q, k, v, bias_t, do, l, m,
                                                                  delta, scale), 10),),
            "k4c": (cuda_ms(lambda: fa.flash_attention_relpos_dq(q, k, v, bias_t, do, l, m,
                                                                 delta, scale), 10),)}
        # the twin and SDPA compute dq, dk, dv and the bias gradient in one
        # backward: their time stands beside K4b and K4c together
        bwd_plain = cuda_ms(lambda: fa.flash_attention_relpos_bwd_ref(
            q, k, v, bias_t, o, l, m, do, scale), 3 if big else 10, warmup=1)
        bwd_library = cuda_ms(sdpa_backward, 10)
        bounds = k4_bounds(shape, dt, bias_dt)
        for kern in ("k4a", "k4b", "k4c"):
            rows.append({
                "kernel": kern, "shape": list(shape), "dtype": name,
                "bias_dtype": str(bias_dt).removeprefix("torch."), "atol": atol, "rtol": rtol,
                "max_abs_err": errs[kern][0],
                "n_outside_tol": errs[kern][1] + (bad_resid if kern == "k4a" else 0),
                **(resid if kern == "k4a" else {}),
                "kernel_ms": times[kern][0],
                "plain_ms": times[kern][1] if kern == "k4a" else bwd_plain,
                "library_ms": times[kern][2] if kern == "k4a" else bwd_library,
                "plain_and_library_cover": "K4a" if kern == "k4a" else "K4b + K4c",
                "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1],
                "bound_share": bounds[kern][0] / times[kern][0],
                **({"bound_f32_cuda_cores_ms": bounds[f"{kern}_f32_cuda_cores"][0]}
                   if f"{kern}_f32_cuda_cores" in bounds else {})})
        del q, k, v, do, bias_t, mask, o, l, m, delta, leaves, o_lib
        torch.cuda.empty_cache()
    main = {r["kernel"]: r for r in rows
            if r["shape"] == [8, 16, 1024, 64] and r["dtype"] == "float32"}
    main.update({f"{r['kernel']}_bf16": r for r in rows if r["shape"] == [8, 16, 1024, 64]
                 and r["dtype"] == r["bias_dtype"] == "bfloat16"})
    emit({"phase": "kernels", "kernel": "flash_attention_relpos_train", "cases": rows,
          "k4b_f32_under_sdpa_backward": main["k4b"]["kernel_ms"] <= main["k4b"]["library_ms"]})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K4 disagrees with its twin: {failed}")

    # K4b and K4c sum in a fixed order: two launches of each, the same bits
    # (the bf16 step's batch 16 too)
    same = {}
    for dt, batch in ((f32, TRAIN_BATCH), (bf16, TRAIN_BATCH), (bf16, BF16_TRAIN_BATCH)):
        g = torch.Generator(device=dev).manual_seed(530)
        q, k, v, do = (torch.randn((batch, 16, 1024, 64), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        bias_t = (torch.randn((16, 1024, 1024), generator=g, device=dev) * 0.5).to(dt)
        o, l, m = fa.flash_attention_relpos_fwd(q, k, v, bias_t, 0.125)
        delta = fa.flash_delta(o, do)
        for kern, fn in (("k4b", fa.flash_attention_relpos_dkv),
                         ("k4c", fa.flash_attention_relpos_dq)):
            first = fn(q, k, v, bias_t, do, l, m, delta, 0.125)
            second = fn(q, k, v, bias_t, do, l, m, delta, 0.125)
            same[f"{kern}_{str(dt).removeprefix('torch.')}_b{batch}"] = all(
                torch.equal(a, b) for a, b in zip(first, second))
            del first, second
        del q, k, v, do, bias_t, o, l, m, delta
    emit({"phase": "kernels", "kernel": "flash_attention_relpos_train_dkv_dq",
          "shape": [None, 16, 1024, 64], "bitwise_equal_across_two_runs": same})
    if not all(same.values()):
        raise AssertionError(f"K4b or K4c gave other bits on a second run: {same}")

    # the Functions around K1 and K5: forward through the kernel, backward()
    # against autograd of the twin, relative to each gradient's peak
    grads = []
    g = torch.Generator(device=dev).manual_seed(520)
    x = (torch.randn((2, 256, 16384), generator=g, device=dev) * 1.5 + 0.2).requires_grad_()
    res = torch.randn((2, 256, 16384), generator=g, device=dev).requires_grad_()
    scale_p = (torch.rand(256, generator=g, device=dev) + 0.5).requires_grad_()
    bias_p = (torch.rand(256, generator=g, device=dev) - 0.5).requires_grad_()
    dout = torch.randn((2, 256, 16384), generator=g, device=dev)
    before = gn.launches
    y = gn.groupnorm1_gelu(x, scale_p, bias_p, True, res)
    got = torch.autograd.grad(y, (x, scale_p, bias_p, res), dout)
    want = torch.autograd.grad(gn.groupnorm1_gelu_ref(x, scale_p, bias_p, True, res),
                               (x, scale_p, bias_p, res), dout)
    grads.append({"kernel": "groupnorm1_gelu", "shape": [2, 256, 16384], "dtype": "float32",
                  "has_grad_fn": y.grad_fn is not None, "launches": gn.launches - before,
                  "rel_err": {n: float((a - b).abs().max() / b.abs().max())
                              for n, a, b in zip(("dx", "dscale", "dbias", "dres"), got, want)}})
    b, c, t = TRAIN_BATCH, 512, 2048
    x = (torch.randn((b, c, t), generator=g, device=dev) * 1.5 + 0.2).requires_grad_()
    scale_p = (torch.rand(c, generator=g, device=dev) + 0.5).requires_grad_()
    bias_p = (torch.rand(c, generator=g, device=dev) - 0.5).requires_grad_()
    ts = (torch.randn((b, 2 * c), generator=g, device=dev) * 0.3).requires_grad_()
    dout = torch.randn((b, c, t), generator=g, device=dev)
    fs, sh = ts.chunk(2, dim=1)
    before = ggn.launches
    y = ggn.grouped_gn_film_silu(x, scale_p, bias_p, 8, fs, sh)
    got = torch.autograd.grad(y, (x, scale_p, bias_p, ts), dout)
    want = torch.autograd.grad(ggn.grouped_gn_film_silu_ref(x, scale_p, bias_p, 8, fs, sh),
                               (x, scale_p, bias_p, ts), dout)
    grads.append({"kernel": "grouped_gn_film_silu", "shape": [b, c, t], "dtype": "float32",
                  "has_grad_fn": y.grad_fn is not None, "launches": ggn.launches - before,
                  "rel_err": {n: float((a - b).abs().max() / b.abs().max())
                              for n, a, b in zip(("dx", "dscale", "dbias", "dfilm"), got, want)}})
    emit({"phase": "kernels", "kernel": "autograd functions (K1, K5)", "bound": 1e-4,
          "cases": grads})
    for r in grads:
        if not r["has_grad_fn"] or r["launches"] != 1 \
                or any(not e < 1e-4 for e in r["rel_err"].values()):
            raise AssertionError(f"autograd through the kernel wrapper: {r}")
    return main


def _k4_k5_counts():
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.ops import stft_kernel as stk
    return {"k3": fa.launches, "k4a": fa.train_fwd_launches, "k4b": fa.dkv_launches,
            "k4c": fa.dq_launches, "k5": ggn.launches, "k6": stk.launches,
            "k5_cluster": ggn.cluster_launches, "k5_two_pass": ggn.two_pass_launches}


def _zero_train_counts():
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.ops import stft_kernel as stk
    fa.launches = fa.train_fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    ggn.launches = ggn.cluster_launches = ggn.two_pass_launches = stk.launches = 0


def phase_train_model():
    """One training forward + backward of the full-width songs UNetCFG1d
    through the kernels and through their twins: the check that no kernel
    wrapper cuts the graph. Returns the UNet (train_bf16 takes it)."""
    import torch
    from audio_algebra_torch.models import blocks, unet_cfg1d
    from audio_algebra_torch.models.stacked import v_objective_loss
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    t_len = MIRAGE_SAMPLES // 512
    unet = random_init_(unet_cfg1d.UNetCFG1d(), 0).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    latents = torch.tanh(torch.randn((TRAIN_BATCH, 32, t_len), generator=g, device=dev))
    noise = torch.randn((TRAIN_BATCH, 32, t_len), generator=g, device=dev)
    t = torch.rand((TRAIN_BATCH,), generator=g, device=dev)
    emb = torch.randn((TRAIN_BATCH, 1, 512), generator=g, device=dev)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    keep = torch.tensor([True, False, True, True, True, False, True, True], device=dev)

    def run():
        unet.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        loss = v_objective_loss(unet, latents, emb, t, noise, keep=keep)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() if p.grad is not None else None
                 for n, p in unet.named_parameters()}
        return float(loss.detach()), grads, time.perf_counter() - start, \
            torch.cuda.max_memory_allocated() / 1e9

    run()                                               # warm-up: cuDNN plans
    _zero_train_counts()
    loss_k, grads_k, secs_k, mem_k = run()
    counts = _k4_k5_counts()
    unet_cfg1d.flash_attention_relpos_train = fa.flash_attention_relpos_train_ref
    blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu_ref
    try:
        loss_p, grads_p, secs_p, mem_p = run()
    finally:
        unet_cfg1d.flash_attention_relpos_train = fa.flash_attention_relpos_train
        blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu
    missing = [n for n, gk in grads_k.items() if gk is None]
    not_finite = [n for n, gk in grads_k.items() if gk is not None
                  and not bool(torch.isfinite(gk).all())]
    zero = [n for n, gk in grads_k.items() if gk is not None and not bool(gk.any())
            and bool(grads_p[n].any())]
    errs = {n: rel_rms(gk, grads_p[n]) for n, gk in grads_k.items() if gk is not None}
    worst = sorted(errs, key=errs.get, reverse=True)[:5]
    named = [n for n in errs if n.endswith("rel_pos_bias") or n == "fixed_embedding"]
    flash_tables = [n for n in named if re.search(r"attn[23]_", n)]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "train_model", "shape": [TRAIN_BATCH, 32, t_len], "dtype": "float32",
          "parameters": len(grads_k), "loss_kernels": loss_k, "loss_twins": loss_p,
          "loss_rel_diff": loss_rel, "loss_bound": TRAIN_LOSS_REL,
          "grad_rel_rms_max": max(errs.values()), "grad_rel_rms_bound": TRAIN_GRAD_REL_RMS,
          "grad_rel_rms_worst": {n: errs[n] for n in worst},
          "grad_rel_rms_named": {n: errs[n] for n in named},
          "grad_abs_max_named": {n: float(grads_k[n].abs().max()) for n in named},
          "missing": missing, "not_finite": not_finite, "zero_where_twin_is_not": zero,
          "launches": counts, "forward_backward_ms": {"kernels": secs_k * 1e3,
                                                      "twins": secs_p * 1e3},
          "peak_mem_gb": {"kernels": mem_k, "twins": mem_p}})
    if missing or not_finite or zero:
        raise AssertionError(f"gradients missing {missing}, not finite {not_finite}, "
                             f"zero where the twin's is not {zero}")
    if len(flash_tables) != K4_PER_STEP or "fixed_embedding" not in named \
            or any(not float(grads_k[n].abs().max()) > 0 for n in flash_tables +
                   ["fixed_embedding"]):
        raise AssertionError(f"the flash sites' bucket tables or the null embedding got no "
                             f"gradient: {named}")
    if not loss_rel < TRAIN_LOSS_REL or not max(errs.values()) < TRAIN_GRAD_REL_RMS:
        raise AssertionError(f"kernels vs twins: loss rel {loss_rel}, worst gradients "
                             f"{ {n: errs[n] for n in worst} }")
    want = {"k3": 0, "k4a": K4_PER_STEP, "k4b": K4_PER_STEP, "k4c": K4_PER_STEP,
            "k5": K5_PER_STEP, "k6": 0, "k5_cluster": K5_PER_STEP, "k5_two_pass": 0}
    if counts != want:
        raise AssertionError(f"training forward + backward launched {counts}, expected {want}")
    return unet


def _synced() -> float:
    import torch
    torch.cuda.synchronize()
    return time.perf_counter()


def phase_train_bf16(unet=None) -> dict:
    """The JAX repo's bf16 mixed-precision training measurements
    (tools/bench_train.py) on the port: the songs UNetCFG1d's bf16 step
    (make_train_step with compute_dtype bf16) at batch 16 x (32, 2048), the
    kernels against their twins and the f32 step on the same batch; the
    bf16 frozen stage-1 encode; the mixer step with the DVAE encode in bf16
    against f32. `unet`: train_model's UNetCFG1d (else one is built).
    Returns the launch counts of the timed steps."""
    import numpy as np
    import torch
    from audio_algebra_torch import train_clapdae
    from audio_algebra_torch.aa_mixer import (AABundle, OneCycleAdam, as_tensors,
                                              encode_mixer_inputs, given_model_encode_fn,
                                              mixed_encode_fn, mixer_loss)
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.models import blocks, unet_cfg1d
    from audio_algebra_torch.models.stacked import (LatentAudioDiffusionAutoencoder,
                                                    v_objective_loss)
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    t_len = MIRAGE_SAMPLES // 512
    if unet is None:
        unet = random_init_(unet_cfg1d.UNetCFG1d(), 0).to(dev)
    unet.requires_grad_(True)

    def draw(b):
        g = torch.Generator(device=dev).manual_seed(17)
        latents = torch.tanh(torch.randn((b, 32, t_len), generator=g, device=dev))
        noise = torch.randn((b, 32, t_len), generator=g, device=dev)
        t = torch.rand((b,), generator=g, device=dev)
        emb = torch.randn((b, 1, 512), generator=g, device=dev)
        keep = torch.rand((b, 1, 1), generator=g, device=dev) < 0.9
        keep[0] = False                      # the null embedding learns in every run
        return latents, emb / emb.norm(dim=-1, keepdim=True), t, noise, keep

    seen = set()                             # dtypes of the modules' floating outputs

    def hook(module, inputs, out):
        if torch.is_tensor(out) and out.is_floating_point():
            seen.add(out.dtype)

    def loss_and_grads(batch, dtype):
        unet.zero_grad(set_to_none=True)
        latents, emb, t, noise, keep = batch
        seen.clear()
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            loss = v_objective_loss(train_clapdae.mixed_precision(unet, dtype), latents, emb,
                                    t, noise, keep=keep)
        finally:
            handle.remove()
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                 for n, p in unet.named_parameters()}
        unet.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    # the step's batch: 16, halved while it does not fit (the tool's rule)
    b = BF16_TRAIN_BATCH
    while True:
        batch = draw(b)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = _synced()
            loss_k, grads_k = loss_and_grads(batch, bf16)
            first_s = _synced() - t0
            seen_k = set(seen)
            break
        except torch.cuda.OutOfMemoryError:
            del batch
            unet.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            b //= 2
            print(f"train_bf16: batch {2 * b} does not fit; batch {b}", flush=True)
            if b < 1:
                raise
    unet_cfg1d.flash_attention_relpos_train = fa.flash_attention_relpos_train_ref
    blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu_ref
    try:
        loss_p, grads_p = loss_and_grads(batch, bf16)
    finally:
        unet_cfg1d.flash_attention_relpos_train = fa.flash_attention_relpos_train
        blocks.grouped_gn_film_silu = ggn.grouped_gn_film_silu
    errs = {n: rel_rms(gk, grads_p[n]) for n, gk in grads_k.items()}
    not_f32 = [n for n, gk in grads_k.items() if gk.dtype != torch.float32]
    not_finite = [n for n, gk in grads_k.items() if not bool(torch.isfinite(gk).all())]
    zero = [n for n, gk in grads_k.items() if not bool(gk.any()) and bool(grads_p[n].any())]
    del grads_p
    try:                                      # the f32 step's distance: a floor only
        loss_f, grads_f = loss_and_grads(batch, torch.float32)
        f32 = {"loss_rel_diff": abs(loss_k - loss_f) / abs(loss_f),
               "grad_rel_rms_max": max(rel_rms(gk, grads_f[n]) for n, gk in grads_k.items()),
               "grad_rel_rms_floor": BF16_VS_F32_FLOOR}
        f32["grad_rel_rms_median"] = float(np.median([rel_rms(gk, grads_f[n])
                                                      for n, gk in grads_k.items()]))
        del grads_f
    except torch.cuda.OutOfMemoryError:
        f32 = "not measured: the f32 step at this batch does not fit"
    del grads_k
    torch.cuda.empty_cache()

    # the optimiser steps: 1 warm-up, then BF16_TRAIN_STEPS timed
    state = train_clapdae.make_state(unet)
    step = train_clapdae.make_train_step(state, compute_dtype=bf16)
    loss0 = float(step(*batch))
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    step_ms, losses = [], []
    for _ in range(BF16_TRAIN_STEPS):
        t0 = _synced()
        losses.append(float(step(*batch)))
        step_ms.append((_synced() - t0) * 1e3)
    counts = _k4_k5_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    master_f32 = all(p.dtype == torch.float32 for p in unet.parameters()) and all(
        e.dtype == torch.float32 for e in state.ema_params.values())
    del state, step, batch
    torch.cuda.empty_cache()

    # the frozen stage-1 encode at the tool's batch 4 x 1,048,576, bf16 and
    # f32, on the whole module as a caller holds it (its decoder and stage-1
    # UNet too); mixed_encode_fn casts the encoder's weights once
    ae = random_init_(LatentAudioDiffusionAutoencoder(), 1).to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn((BF16_ENCODE_BATCH, 2, MIRAGE_SAMPLES), generator=g, device=dev) * 0.2
    encode_ms = {}
    t0 = _synced()
    encode16 = mixed_encode_fn(ae, "encode")
    cast_ms = (_synced() - t0) * 1e3
    with torch.no_grad():
        lat32 = ae.encode(x)
        lat16 = encode16(x)
        _zero_train_counts()
        for name, fn in (("bfloat16", encode16), ("float32", ae.encode),
                         ("float32_again", ae.encode), ("bfloat16_again", encode16)):
            t0 = _synced()
            fn(x)
            encode_ms[name] = (_synced() - t0) * 1e3
        k5_per_encode = _k4_k5_counts()["k5"] / 4
    encoder_params = sum(p.numel() for n, p in ae.named_parameters()
                         if n.startswith(tuple(f"{s}." for s in ae.ENCODER_PARTS)))
    encode_rel = rel_rms(lat16, lat32)
    encode_ok = bool(torch.isfinite(lat16).all()) and lat16.dtype == torch.float32 \
        and lat16.shape == lat32.shape
    module_params = sum(p.numel() for p in ae.parameters())
    del ae, encode16, x, lat16, lat32
    torch.cuda.empty_cache()

    # the mixer step with the frozen DVAE encode in bf16 and in f32, in turns
    wrapper = DVAEWrapper(args_dict={"latent_dim": AA_DIMS, "sample_size": CHUNK},
                          device="cuda")
    rng = np.random.default_rng(52)
    stems = (0.3 * rng.standard_normal((2, AA_BATCH, 2, CHUNK))).astype(np.float32)
    faders = np.asarray(AA_FADERS, np.float32)
    batch_x = (0.3 * rng.standard_normal((AA_BATCH, 2, CHUNK))).astype(np.float32)
    aa = AABundle(dims=AA_DIMS, hidden_dims=AA_DIMS, seed=0, device="cuda")
    opt = OneCycleAdam(aa.module, 100, 1e-3)
    encoders = {"float32": given_model_encode_fn(wrapper),
                "bfloat16": mixed_encode_fn(wrapper.model)}
    latents_of = {}

    def mixer_step(dtype):
        t0 = _synced()
        args = as_tensors("cuda", stems, faders, batch_x)
        t1 = _synced()
        y_all, y_batch = encode_mixer_inputs(encoders[dtype], *args)
        t2 = _synced()
        loss, _ = mixer_loss(aa.module, y_all, y_batch, stems.shape[0])
        loss.backward()
        opt.step()
        t3 = _synced()
        latents_of[dtype] = y_batch
        return {"host_data_ms": (t1 - t0) * 1e3, "encode_ms": (t2 - t1) * 1e3,
                "algebra_adam_ms": (t3 - t2) * 1e3, "loss": float(loss.detach())}

    mixer_step("float32")
    mixer_step("bfloat16")                    # warm-ups: cuDNN plans
    runs = {"float32": [], "bfloat16": []}
    for dtype in ("float32", "bfloat16") * BF16_MIXER_STEPS:     # in turns
        runs[dtype].append(mixer_step(dtype))
    mixer = {dtype: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
             for dtype, rs in runs.items()}
    for dtype, row in mixer.items():
        row["step_ms"] = row["host_data_ms"] + row["encode_ms"] + row["algebra_adam_ms"]
    mixer["bf16_latents_rel_rms_vs_f32"] = rel_rms(latents_of["bfloat16"],
                                                   latents_of["float32"])
    del wrapper, aa, opt, encoders, latents_of
    torch.cuda.empty_cache()

    per_step = {k: v / BF16_TRAIN_STEPS for k, v in counts.items()}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = sorted(errs, key=errs.get, reverse=True)[:5]
    emit({"phase": "train_bf16", "model": "UNetCFG1d() (songs, 499 M parameters)",
          "parameters": sum(p.numel() for p in unet.parameters()),
          "batch": [b, 32, t_len], "batch_asked": BF16_TRAIN_BATCH,
          "compute_dtype": "bfloat16", "masters": "float32", "allow_tf32": False,
          "first_forward_backward_s": first_s, "warmup_loss": loss0, "losses": losses,
          "ms_per_step": float(np.mean(step_ms)), "step_ms": step_ms, "peak_mem_gb": peak,
          "launches_per_step": per_step, "masters_and_ema_f32": master_f32,
          "module_output_dtypes": sorted(str(d) for d in seen_k),
          "kernels_vs_twins": {"loss_kernels": loss_k, "loss_twins": loss_p,
                               "loss_rel_diff": loss_rel, "loss_bound": BF16_TRAIN_LOSS_REL,
                               "grad_rel_rms_max": max(errs.values()),
                               "grad_rel_rms_bound": BF16_TRAIN_GRAD_REL_RMS,
                               "grad_rel_rms_worst": {n: errs[n] for n in worst},
                               "not_f32": not_f32, "not_finite": not_finite,
                               "zero_where_twin_is_not": zero},
          "bf16_vs_f32_step": f32,
          "frozen_encode": {"batch": [BF16_ENCODE_BATCH, 2, MIRAGE_SAMPLES], "ms": encode_ms,
                            "cast_once_ms": cast_ms, "module_parameters": module_params,
                            "encoder_parameters_cast": encoder_params,
                            "k5_per_encode": k5_per_encode, "rel_rms_vs_f32": encode_rel,
                            "bound": BF16_ENCODE_REL_RMS},
          "mixer_step": {"batch": [2, AA_BATCH, 2, CHUNK], **mixer}})
    if not math.isfinite(loss_k) or not_f32 or not_finite or zero or not master_f32 \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bf16 step: loss {loss_k}, gradients not f32 {not_f32}, not "
                             f"finite {not_finite}, zero where the twin's is not {zero}")
    # the step computed in bf16: its modules' outputs, and (where the f32
    # step fit) its gradients at least bf16's roundoff from the f32 step's
    if bf16 not in seen_k or (isinstance(f32, dict)
                              and not f32["grad_rel_rms_max"] > BF16_VS_F32_FLOOR):
        raise AssertionError(f"bf16 step did not compute in bf16: module outputs {seen_k}, "
                             f"against the f32 step {f32}")
    if not loss_rel < BF16_TRAIN_LOSS_REL or not max(errs.values()) < BF16_TRAIN_GRAD_REL_RMS:
        raise AssertionError(f"bf16 step, kernels vs twins: loss rel {loss_rel}, worst "
                             f"gradients { {n: errs[n] for n in worst} }")
    want = {"k3": 0, "k4a": K4_PER_STEP, "k4b": K4_PER_STEP, "k4c": K4_PER_STEP,
            "k5": K5_PER_STEP, "k6": 0, "k5_cluster": K5_PER_STEP, "k5_two_pass": 0}
    if per_step != want:
        raise AssertionError(f"bf16 step launched {per_step} a step, expected {want}")
    if not encode_ok or not encode_rel < BF16_ENCODE_REL_RMS or k5_per_encode != K5_PER_ENCODE:
        raise AssertionError(f"bf16 frozen encode: rel-RMS {encode_rel}, K5 {k5_per_encode}")
    if not all(math.isfinite(r["loss"]) for rs in runs.values() for r in rs):
        raise AssertionError(f"mixer steps: {runs}")
    return counts


def phase_train(clap_module) -> dict:
    """The trainer's entry point at full width: 4 steps and a checkpoint,
    then a resumed run of one more step. Returns the launch counts of the
    first run."""
    import numpy as np
    import torch
    from audio_algebra_torch import train_clapdae
    from audio_algebra_torch.models.ema import EMASchedule
    from audio_algebra_torch.utils.audio_io import write_wav

    steps = TRAIN_EPOCHS * TRAIN_FILES // TRAIN_BATCH
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(11)
        tt = np.arange(MIRAGE_SAMPLES, dtype=np.float32) / 48000
        (Path(tmp) / "wavs").mkdir()
        t0 = time.perf_counter()
        for i in range(TRAIN_FILES):
            f0, f1 = rng.uniform(80, 1200, 2)
            clip = np.stack([0.3 * np.sin(2 * np.pi * f0 * tt), 0.3 * np.sin(2 * np.pi * f1 * tt)])
            clip += 0.05 * rng.standard_normal(clip.shape).astype(np.float32)
            write_wav(Path(tmp) / "wavs" / f"clip{i:02d}.wav", clip.astype(np.float32), 48000)
        corpus_s = time.perf_counter() - t0
        argv = ["--training_dir", str(Path(tmp) / "wavs"), "--batch_size", str(TRAIN_BATCH),
                "--sample_size", str(MIRAGE_SAMPLES), "--num_workers", "4", "--num_gpus", "1",
                "--name", "smoke", "--seed", "0"]
        os.chdir(tmp)                    # the run directory (runs/) is made beside the cwd
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_train_counts()
            t0 = time.perf_counter()
            run = train_clapdae.main([*argv, "--load_frac", "1.0", "--max_epochs",
                                      str(TRAIN_EPOCHS)], clap_module=clap_module)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = _k4_k5_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            digests = (run["start_digest"], run["end_digest"])
            del run["state"]
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            again = train_clapdae.main([*argv, "--load_frac", "0.5", "--max_epochs", "1",
                                        "--ckpt_path", f"{run['run_dir']}/ckpt"],
                                       clap_module=clap_module)
            torch.cuda.synchronize()
            again_s = time.perf_counter() - t0
            del again["state"]
            torch.cuda.empty_cache()
        finally:
            os.chdir(home)
    records = run["records"] + again["records"]
    ema = EMASchedule(0.9999, 0.75)
    closed_forms = all(
        abs(r["train_lr"] - train_clapdae.cosine_lr(r["step"], 4e-5, 500)) < 1e-12
        and r["train_ema_decay"] == ema.decay(r["step"]) for r in records)
    steady = run["records"][1:]
    expected = {"k3": 0, "k4a": steps * K4_PER_STEP, "k4b": steps * K4_PER_STEP,
                "k4c": steps * K4_PER_STEP, "k5": steps * (K5_PER_STEP + K5_PER_ENCODE),
                "k6": steps, "k5_cluster": steps * (K5_PER_STEP + K5_PER_ENCODE),
                "k5_two_pass": 0}
    emit({"phase": "train", "batch": [TRAIN_BATCH, 2, MIRAGE_SAMPLES], "dtype": "float32",
          "allow_tf32": False, "files": TRAIN_FILES, "corpus_s": corpus_s,
          "steps": [{k: r[k] for k in ("step", "train_loss", "train_lr", "train_ema_decay",
                                       "encode_ms", "embed_ms", "step_ms")} for r in records],
          "ms_per_step": float(np.mean([r["step_ms"] for r in steady])),
          "encode_ms": float(np.mean([r["encode_ms"] for r in steady])),
          "embed_ms": float(np.mean([r["embed_ms"] for r in steady])),
          "run_s": run_s, "resumed_run_s": again_s, "peak_mem_gb": peak,
          "launches": counts, "launches_expected": expected,
          "start_step": [run["start_step"], again["start_step"]],
          "end_step": [run["end_step"], again["end_step"]],
          "params_moved": digests[0]["params"] != digests[1]["params"],
          "ema_differs_from_params": digests[1]["ema"] != digests[1]["params"],
          "resume_reproduces_saved_state": again["start_digest"] == digests[1],
          "closed_forms": closed_forms})
    if not all(math.isfinite(r["train_loss"]) for r in records) or not closed_forms:
        raise AssertionError(f"losses or schedules: {records}")
    if [run["start_step"], run["end_step"], again["start_step"], again["end_step"]] != \
            [0, steps, steps, steps + 1]:
        raise AssertionError(f"steps: first run {run['start_step']}..{run['end_step']}, "
                             f"resumed {again['start_step']}..{again['end_step']}")
    if digests[0]["params"] == digests[1]["params"] or digests[1]["ema"] == digests[1]["params"]:
        raise AssertionError("the parameters did not move, or the EMA equals them")
    if again["start_digest"] != digests[1]:
        raise AssertionError("the resumed run did not reproduce the saved parameters and EMA")
    if counts != expected:
        raise AssertionError(f"training launches {counts}, expected {expected}")
    return counts


def _all_counts():
    from audio_algebra_torch.ops import groupnorm as gn
    return {"k1": gn.launches, "k2": gn.quant_launches + gn.amax_launches + gn.amax_q_launches,
            **_k4_k5_counts()}


def _zero_all_counts():
    from audio_algebra_torch.ops import groupnorm as gn
    gn.launches = gn.quant_launches = gn.amax_launches = gn.amax_q_launches = 0
    _zero_train_counts()


def _loss_and_grads(fn, module, dtype, *latents):
    """(loss, logs, {name: gradient in f64}) of an algebra loss on latents
    cast to `dtype`, through `module` in that dtype."""
    import torch
    module.zero_grad(set_to_none=True)
    loss, logs = fn(module, *(y.to(dtype) for y in latents))
    loss.backward()
    return float(loss.detach()), {k: float(v) for k, v in logs.items()}, \
        {n: p.grad.double() for n, p in module.named_parameters()}


def _f32_against_f64(name, fn, module, *latents) -> dict:
    """One algebra loss and every gradient in f32 against the same in f64
    on the card, from the same frozen latents and weights."""
    import copy
    import torch
    loss32, logs32, g32 = _loss_and_grads(fn, module, torch.float32, *latents)
    loss64, logs64, g64 = _loss_and_grads(fn, copy.deepcopy(module).double(), torch.float64,
                                          *latents)
    errs = {n: rel_rms(g32[n], g64[n]) for n in g64}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    out = {"loss": name, "loss_f32": loss32, "loss_f64": loss64,
           "loss_rel_diff": abs(loss32 - loss64) / abs(loss64),
           "terms_rel_diff": {k: abs(logs32[k] - logs64[k]) / max(abs(logs64[k]), 1e-30)
                              for k in logs64},
           "terms_f64": logs64, "parameters": len(errs),
           "grad_rel_rms_max": max(errs.values()),
           "grad_rel_rms_worst": {n: errs[n] for n in worst},
           "finite": all(bool(torch.isfinite(g).all()) for g in g32.values())
           and math.isfinite(loss32)}
    if not (out["finite"] and out["loss_rel_diff"] < AA_LOSS_REL
            and out["grad_rel_rms_max"] < AA_GRAD_REL_RMS):
        emit({"phase": "train_aa_model", "failed": out})
        raise AssertionError(f"{name}: f32 against f64 {out}")
    return out


def _k1_in_demo_decode(wrapper, y) -> dict:
    """One v-DDIM step of the algebra demos' decode (batch 1, f32), every
    K1 call held against its twin on the same inputs; rows by (shape,
    dtype, gelu, residual)."""
    import torch
    from audio_algebra_torch.models import blocks
    from audio_algebra_torch.ops import groupnorm as gn

    atol, rtol = TOL["float32"]
    rows = {}

    def checked(x, scale, bias, gelu, residual=None, eps=1e-6):
        got = gn.groupnorm1_gelu(x, scale, bias, gelu, residual, eps)
        want = gn.groupnorm1_gelu_ref(x, scale, bias, gelu, residual, eps).float()
        err = (got.float() - want).abs()
        key = (tuple(x.shape), str(x.dtype).removeprefix("torch."), bool(gelu),
               residual is not None)
        row = rows.setdefault(key, {"calls": 0, "max_abs_err": 0.0, "n_outside_tol": 0})
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], float(err.max()))
        row["n_outside_tol"] += int((err > atol + rtol * want.abs()).sum())
        return got

    blocks.groupnorm1_gelu = checked
    try:
        audio = wrapper.decode(y, demo_steps=1)
    finally:
        blocks.groupnorm1_gelu = gn.groupnorm1_gelu
    out = {"latents": list(y.shape), "audio": list(audio.shape),
           "audio_finite": bool(torch.isfinite(audio).all()), "atol": atol, "rtol": rtol,
           "calls": sum(r["calls"] for r in rows.values()),
           "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
           "n_outside_tol": sum(r["n_outside_tol"] for r in rows.values()),
           "cases": [{"shape": list(k[0]), "dtype": k[1], "gelu": k[2], "residual": k[3], **r}
                     for k, r in rows.items()]}
    if out["calls"] != GN_CALLS_PER_FORWARD or out["n_outside_tol"] or \
            not out["audio_finite"] or out["audio"][-2:] != [2, CHUNK] or \
            math.prod(out["audio"]) != 2 * CHUNK:
        emit({"phase": "train_aa_model", "failed": {"k1_demo_decode": out}})
        raise AssertionError(f"K1 in the demo decode against its twin: {out}")
    return out


def phase_train_aa_model() -> None:
    """The mixer and effects losses at full width in f32 against float64 on
    the card, from the same frozen DVAE latents and algebra weights; the
    cov loss's Gram identity in f64 against the direct covariance; and one
    step of the demos' batch-1 decode with every K1 call against its twin."""
    import numpy as np
    import torch
    from audio_algebra_torch import aa_effects, aa_mixer
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.models.aa import AudioAlgebra
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    wrapper = DVAEWrapper(device=dev)
    wrapper.ensure_params()
    encode = aa_mixer.given_model_encode_fn(wrapper)
    module = random_init_(AudioAlgebra(dims=AA_DIMS, hidden_dims=AA_DIMS), 1).to(dev)
    rng = np.random.default_rng(21)

    def audio(*shape):
        return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    stems, batch = audio(2, AA_BATCH, 2, CHUNK), audio(AA_BATCH, 2, CHUNK)
    faders = torch.tensor(AA_FADERS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y_all, y_batch = aa_mixer.encode_mixer_inputs(encode, stems, faders, batch)
    torch.cuda.synchronize()
    mixer_encode_s = time.perf_counter() - t0
    encode_peak = torch.cuda.max_memory_allocated() / 1e9
    del stems, batch
    mixer = _f32_against_f64(
        "make_mixer_loss_fn",
        lambda m, ya, yb: aa_mixer.mixer_loss(m, ya, yb, len(AA_FADERS)), module, y_all, y_batch)

    # the cov loss's Gram identity against the direct (c t)^2 covariance, f64
    with torch.no_grad():
        z = module.encode(y_all[len(AA_FADERS) * AA_BATCH:]).double()
        gram64 = float(aa_mixer.vicreg_cov_loss(z))
        gram32 = float(aa_mixer.vicreg_cov_loss(z.float()))
        flat = z.reshape(z.shape[0], -1)
        zc = flat - flat.mean(dim=0)
        cov = zc.T @ zc / (z.shape[0] - 1)
        del zc
        direct = float(aa_mixer.off_diagonal(cov).square_().sum() / flat.shape[1])
        del cov
    torch.cuda.empty_cache()
    gram = {"shape": list(z.shape), "direct_f64": direct, "gram_f64": gram64,
            "gram_f64_rel_err": abs(gram64 - direct) / abs(direct), "gram_f32": gram32,
            "gram_f32_rel_err": abs(gram32 - direct) / abs(direct)}
    with torch.no_grad():                # as aa_demo: aa.decode(zmix[:1]), then the DVAE
        k1_demo = _k1_in_demo_decode(wrapper, module.decode(z[:1].float()))
    del y_all, y_batch, z

    clips = [audio(AA_BATCH, 2, CHUNK) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y4 = encode(torch.cat(clips, dim=0))
    torch.cuda.synchronize()
    effects_encode_s = time.perf_counter() - t0
    del clips
    effects = _f32_against_f64("make_effects_loss_fn", aa_effects.effects_loss, module, y4)
    del y4
    torch.cuda.empty_cache()
    emit({"phase": "train_aa_model", "dtype": "float32", "allow_tf32": False,
          "algebra": {"dims": AA_DIMS, "hidden_dims": AA_DIMS},
          "stems": [len(AA_FADERS), AA_BATCH, 2, CHUNK], "faders": list(AA_FADERS),
          "clips": [4, AA_BATCH, 2, CHUNK], "bounds": {
              "loss_rel": AA_LOSS_REL, "grad_rel_rms": AA_GRAD_REL_RMS,
              "gram_f64_rel": AA_GRAM_REL},
          "mixer": mixer, "effects": effects, "cov_gram": gram, "k1_demo_decode": k1_demo,
          "encode_s": {"mixer_384_plus_128": mixer_encode_s, "effects_512": effects_encode_s},
          "encode_peak_mem_gb": encode_peak})
    if not gram["gram_f64_rel_err"] < AA_GRAM_REL:
        raise AssertionError(f"the Gram identity in f64 against the direct form: {gram}")


def _demo_media(run) -> dict:
    """The demo files a trainer's run logged: name -> (exists, and for a WAV its
    shape and whether it is finite)."""
    import numpy as np
    from audio_algebra_torch.utils.audio_io import read_wav

    logged = {}
    with open(Path(run["run_dir"]) / "log.jsonl") as f:
        for line in f:
            logged.update({k: v for k, v in json.loads(line).items()
                           if k.startswith("demo/")})
    out = {}
    for name, path in logged.items():
        row = {"exists": Path(path).is_file()}
        if row["exists"] and str(path).endswith(".wav"):
            audio, _ = read_wav(path)
            row.update(shape=list(audio.shape), finite=bool(np.isfinite(audio).all()))
        out[name] = row
    return out


def phase_train_aa() -> dict:
    """Both algebra trainers' entry points at full width, with the flags
    the reference's scripts take: the mixer for 2 epochs of 2 batches with a
    demo and a checkpoint, the same run resumed from it for 4 more steps
    past the schedule's end, and the effects trainer for 2 epochs with a
    demo. Every demo must log its media without an error, its audio finite
    at (2, CHUNK). Returns K1's launches in the two demos."""
    import numpy as np
    import torch
    from audio_algebra_torch import train_aa_effects, train_aa_mixer
    from audio_algebra_torch.train_clapdae import onecycle_lr

    home = os.getcwd()
    steps = 2 * AA_FILES // AA_BATCH
    demo_media = {"mixer": ("demo/zsum", "demo/zmix"),
                  "effects": ("demo/za2_guess", "demo/za2", "demo/emb_stats",
                              "demo/pca_cloud", "demo/tokens_za1", "demo/tokens_zb1",
                              "demo/tokens_za2", "demo/tokens_zb2")}

    with tempfile.TemporaryDirectory() as tmp:
        wavs = Path(tmp) / "wavs"
        corpus_s = _write_corpus(wavs, AA_FILES, 12)
        argv = ["--training_dir", str(wavs), "--batch_size", str(AA_BATCH),
                "--sample_size", str(CHUNK), "--latent_dim", str(AA_DIMS),
                "--hidden_dims", str(AA_DIMS), "--num_workers", "8", "--num_gpus", "1",
                "--checkpoint_every", "0", "--seed", "0"]
        os.chdir(tmp)                    # the run directory (runs/) is made beside the cwd
        try:
            def timed(main, *extra):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_all_counts()
                t0 = time.perf_counter()
                run = main([*argv, *extra])
                torch.cuda.synchronize()
                run.update(seconds=time.perf_counter() - t0, counts=_all_counts(),
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
                del run["state"]
                torch.cuda.empty_cache()
                return run
            mixer = timed(train_aa_mixer.main, "--name", "mixer", "--load_frac", "1.0",
                          "--max_epochs", "2", "--demo_every", "2")
            resumed = timed(train_aa_mixer.main, "--name", "resumed", "--load_frac", "1.0",
                            "--max_epochs", "2", "--demo_every", "0",
                            "--ckpt_path", f"{mixer['run_dir']}/ckpt")
            effects = timed(train_aa_effects.main, "--name", "effects", "--load_frac", "1.0",
                            "--max_epochs", "2", "--demo_every", "2")
            demos = {"mixer": _demo_media(mixer), "effects": _demo_media(effects)}
        finally:
            os.chdir(home)

    def summary(run):
        recs = run["records"]
        steady = recs[1:] or recs
        return {"steps": [{k: r[k] for k in ("step", "train_loss", "mix_loss", "var_loss",
                                             "cov_loss", "aa_recon_loss", "lr", "data_ms",
                                             "encode_ms", "step_ms")} for r in recs],
                "ms_per_step": {k: float(np.mean([r[k] for r in steady]))
                                for k in ("data_ms", "encode_ms", "step_ms")},
                "start_step": run["start_step"], "end_step": run["end_step"],
                "total_updates": run["total_updates"], "seconds": run["seconds"],
                "demo_s": run["demo_s"], "demo_errors": run["demo_errors"],
                "peak_mem_gb": run["peak_mem_gb"], "launches": run["counts"]}

    runs = {"mixer": mixer, "resumed": resumed, "effects": effects}
    out = {name: summary(run) for name, run in runs.items()}
    # each record's lr is the one Adam's param group stepped with
    lr_closed_form = all(r["lr"] == onecycle_lr(r["step"], steps, 1e-3)
                         for run in runs.values() for r in run["records"])
    want = {"mixer": (0, steps, K1_PER_AA_DEMO), "resumed": (steps, 2 * steps, 0),
            "effects": (0, steps, K1_PER_AA_DEMO)}
    demo_faults = {name: [k for k in keys if not (
        demos[name].get(k, {}).get("exists") and demos[name][k].get("finite", True)
        and demos[name][k].get("shape", [2, CHUNK]) == [2, CHUNK])]
        for name, keys in demo_media.items()}
    demo_faults = {k: v for k, v in demo_faults.items() if v}
    emit({"phase": "train_aa", "batch": [AA_BATCH, 2, CHUNK], "dtype": "float32",
          "allow_tf32": False, "files": AA_FILES, "corpus_s": corpus_s, **out,
          "demo_media": demos, "demo_faults": demo_faults,
          "lr_closed_form": lr_closed_form,
          "resume_reproduces_saved_state": resumed["start_digest"] == mixer["end_digest"],
          "k1_expected_per_demo": K1_PER_AA_DEMO})
    for name, (start, end, k1) in want.items():
        run = runs[name]
        if (run["start_step"], run["end_step"]) != (start, end):
            raise AssertionError(f"{name}: steps {run['start_step']}..{run['end_step']}, "
                                 f"expected {start}..{end}")
        if not all(math.isfinite(r["train_loss"]) for r in run["records"]):
            raise AssertionError(f"{name}: losses {run['records']}")
        others = {k: v for k, v in run["counts"].items() if k != "k1" and v}
        if run["counts"]["k1"] != k1 or others:
            raise AssertionError(f"{name}: launches {run['counts']}, expected {k1} K1 only")
    if not lr_closed_form:
        raise AssertionError("a learning rate is off the one-cycle closed form")
    if any(run["demo_errors"] for run in runs.values()) or demo_faults:
        raise AssertionError(f"a demo failed: errors "
                             f"{ {k: r['demo_errors'] for k, r in runs.items()} }, "
                             f"missing or bad media {demo_faults}")
    if resumed["start_digest"] != mixer["end_digest"] or \
            mixer["start_digest"]["params"] == mixer["end_digest"]["params"]:
        raise AssertionError("the mixer did not train, or the resumed run did not start "
                             "from the saved bits")
    return mixer["counts"]["k1"] + effects["counts"]["k1"]


def _test_module(name: str):
    """A torch-only helper of tests/ (torch_mirrors, torch_export), loaded by
    path: the reference-layout models whose files the checkpoints phase
    writes."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Tee:
    """stdout to the terminal and to a buffer, to read a setup's report."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


POUR_LINE = re.compile(r"([\w ]+): converted (\d+) tensors \((\d+) unmatched torch tensors, "
                       r"(\d+) flax params left at init\)")


def _setup(name: str, fn, files) -> dict:
    """Run a wrapper's setup with its printed report kept: seconds, the
    file sizes and every pour's hits and misses. Fails on a fallback to
    random weights or on any miss; the forward check after it is the proof
    that the weights landed."""
    import contextlib
    import io

    import torch
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        fn()
    torch.cuda.synchronize()
    text = buf.getvalue()
    pours = [{"model": m[0].strip(), "hits": int(m[1]), "unmatched": int(m[2]),
              "left_at_init": int(m[3])} for m in POUR_LINE.findall(text)]
    report = {"setup_s": time.time() - t0, "pours": pours,
              "file_mb": {Path(f).name: Path(f).stat().st_size / 1e6 for f in files}}
    if "Going with random weights" in text or not pours or \
            any(p["unmatched"] or p["left_at_init"] or not p["hits"] for p in pours):
        raise AssertionError(f"checkpoints: {name} did not pour whole: {report}")
    return report


def _ckpt_info(path) -> dict:
    """ckpt_info for a local file: its path and SHA-256 (checked by
    get_checkpoint), no URL, so no fetch is ever tried."""
    from audio_algebra_torch.given_models import _sha256
    return {"ckpt_path": str(path), "ckpt_hash": _sha256(path), "ckpt_url": "",
            "gdrive_path": ""}


def _perturb(module, seed: int) -> None:
    """Move a main copy away from its EMA twin, so the pour must take the
    EMA copy to agree with it."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=p.device))


def _finite(x) -> bool:
    import torch
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("checkpoints: a non-finite output")
    return True


def _against_mirror(got, want, bound) -> dict:
    err = rel_rms(got.float(), want.float())
    if not err < bound:
        raise AssertionError(f"checkpoints: rel-RMS {err} against the mirror, bound {bound}")
    return {"rel_rms": err, "bound": bound, "shape": list(got.shape), "finite": _finite(got),
            "mirror_rms": float(want.float().square().mean().sqrt())}


def phase_checkpoints() -> dict:
    """The reference's torch checkpoints poured through each wrapper's
    `setup`, at each wrapper's default width. For each model a
    reference-layout mirror (tests/torch_mirrors.py) is built, its main
    copy perturbed away from its EMA twin, saved with torch.save in the
    reference's layout, read by setup (no URL), and the port's forward
    (kernels on, f32) held against the mirror's EMA copy (plain torch,
    f32) on the same seeded input. DVAE (Lightning state_dict): encode and
    decode_v, K1 191 a forward, then Destructo from the poured weights in
    bf16 (B = 4 x 65536, 35 steps); stacked (the MIRAGE stage-1 stack):
    encode, diffusion_v (K1 119), decode_first_stage; DMAE
    (model_state_dict): encode_mel and decode_v, then the wrapper's whole
    encode of (4, 2, 65536) through K6 at center=False against the STFT
    twin; RAVE (.ckpt and TorchScript .ts): encode_bands and decode_bands
    with the same noise; MIRAGE (CLAPDAE through CLAPDAE_CKPT_22s and
    LATENT_DIFFAE_CKPT): one UNetCFG1d forward through K3 and K5, then a
    bf16 generate at 10 + 10 steps. CLAP's pour is host numpy, held on the
    CPU by tests/test_torch_convert.py against a transformers ClapModel:
    the script needs no transformers, and the repository has no torch
    CLAP mirror. Returns the phase's kernel launch counts."""
    import torch
    from audio_algebra_torch.destructo import mathemangle
    from audio_algebra_torch.given_models import (CLAPDAE, DMAE1d, DVAEWrapper, RAVEWrapper,
                                                  StackedDiffAEWrapper)
    from audio_algebra_torch.models.unet_cfg1d import precompute_rel_biases
    from audio_algebra_torch.ops import flash_attention as fa
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import groupnorm_grouped as ggn
    from audio_algebra_torch.ops import stft_kernel as stk

    mirrors, export = _test_module("torch_mirrors"), _test_module("torch_export")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    counts = {"k1": 0, "k3": 0, "k5": 0, "k6": 0}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def launches():
        return {"k1": gn.launches, "k3": fa.launches, "k5": ggn.launches, "k6": stk.launches}

    def counted(fn):
        """fn()'s result and the kernel launches it made (added to counts)."""
        before = launches()
        out = fn()
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in launches().items()}
        for k, v in took.items():
            counts[k] += v
        return out, took

    def build(make, seed):
        torch.manual_seed(seed)
        with torch.device(dev):
            return make().eval()

    def done(name, row):
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        emit({"phase": "checkpoints", "model": name, **row})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- DVAE: DiffusionDVAE() defaults, a Lightning checkpoint
        tm = build(mirrors.DiffusionDVAE, 100)
        _perturb(tm.encoder, 101)
        _perturb(tm.diffusion, 102)
        path = tmp / "dvae.ckpt"
        torch.save({"state_dict": tm.state_dict(), "epoch": 0}, path)
        info = _ckpt_info(path)                 # one hash: the bf16 wrapper reads it too
        w = DVAEWrapper(device="cuda")
        w.ckpt_info = dict(info)
        row = _setup("DVAE", lambda: w.setup(gdrive=False), [path])
        x, t = randn(2, 2, CHUNK, scale=0.3), torch.rand((2,), generator=g, device=dev)
        with torch.inference_mode():
            lat_ref = tm.encoder_ema(x)
            cond = torch.tanh(lat_ref)
            (lat, v), took = counted(lambda: (w.model.encode(x), w.model.decode_v(x, t, cond)))
            row["encode"] = _against_mirror(lat, lat_ref, CKPT_REL_RMS)
            row["decode_v"] = _against_mirror(v, tm.diffusion_ema(x, t, cond), CKPT_REL_RMS)
            row["decode_v_ms"] = cuda_ms(lambda: w.model.decode_v(x, t, cond), 3)
        row["launches"] = took
        if took["k1"] != GN_CALLS_PER_FORWARD:
            raise AssertionError(f"checkpoints: the poured DVAE launched K1 {took} times")
        del tm, w, lat, v, lat_ref, cond
        wb = DVAEWrapper(args_dict={"sample_size": CHUNK, "demo_steps": STEPS}, device="cuda",
                         dtype=torch.bfloat16)
        wb.ckpt_info = dict(info)
        row["bf16_setup"] = _setup("DVAE bf16", lambda: wb.setup(gdrive=False), [path])
        audio = randn(4, 2, CHUNK, scale=0.3)
        start = time.perf_counter()
        with torch.inference_mode():
            out, took = counted(lambda: wb.decode(mathemangle(wb.encode(audio), "destructo")))
        row["destructo"] = {"batch": [4, 2, CHUNK], "steps": STEPS, "dtype": "bfloat16",
                            "seconds": time.perf_counter() - start, "out_shape": list(out.shape),
                            "finite": _finite(out), "launches": took}
        if tuple(out.shape) != (2, 4 * CHUNK) or took["k1"] != STEPS * GN_CALLS_PER_FORWARD:
            raise AssertionError(f"checkpoints: Destructo from the poured weights {row}")
        del wb, out, audio
        path.unlink()
        done("DVAE", row)

        # ---- the stacked diffusion AE: StackedDiffAEWrapper() defaults
        sm = build(mirrors.LatentAudioDiffusionAutoencoder, 110)
        _perturb(sm.latent_encoder, 111)
        _perturb(sm.diffusion, 112)
        stacked_path = tmp / "stacked.ckpt"
        torch.save({"state_dict": sm.state_dict()}, stacked_path)
        w = StackedDiffAEWrapper(device="cuda", ckpt_info=_ckpt_info(stacked_path))
        row = _setup("stacked", lambda: w.setup(gdrive=False), [stacked_path])
        x, t = randn(2, 2, CHUNK, scale=0.3), torch.rand((2,), generator=g, device=dev)
        with torch.inference_mode():
            first = sm.autoencoder.encode(x)
            z_ref = sm.encode(x)
            (z, v, dec), took = counted(lambda: (
                w.encode(x), w.model.diffusion_v(first, t, z_ref),
                w.model.decode_first_stage(first)))
            row["encode"] = _against_mirror(z, z_ref, CKPT_REL_RMS)
            row["diffusion_v"] = _against_mirror(v, sm.diffusion_ema(first, t, z_ref),
                                                 CKPT_REL_RMS)
            row["decode_first_stage"] = _against_mirror(dec, sm.autoencoder.decode(first),
                                                        CKPT_REL_RMS)
            row["diffusion_v_ms"] = cuda_ms(lambda: w.model.diffusion_v(first, t, z_ref), 3)
        row["launches"] = took
        if took["k1"] != K1_PER_OUTER or not took["k5"]:
            raise AssertionError(f"checkpoints: the poured stacked AE launched {took}")
        del sm, w, first, z_ref, z, v, dec
        done("stacked", row)

        # ---- DMAE: DMAE1d() defaults (DiffusionAE1d), a model_state_dict file
        dm = build(lambda: mirrors.TorchDMAE(**DMAE_FULL), 120)
        path = tmp / "dmae.ckpt"
        torch.save({"model_state_dict": dm.state_dict()}, path)
        w = DMAE1d(device="cuda")
        w.ckpt_info = _ckpt_info(path)
        row = _setup("DMAE", lambda: w.setup(gdrive=False), [path])
        logmel = randn(2, 2 * 80, 256)
        x, t = randn(2, 2, CHUNK, scale=0.5), torch.rand((2,), generator=g, device=dev)
        lat = torch.tanh(randn(2, 32, CHUNK // 1024))
        audio = randn(4, 2, CHUNK, scale=0.3)
        with torch.inference_mode():
            row["encode_mel"] = _against_mirror(w.model.encoder.encode_mel(logmel),
                                                dm.encode_mel(logmel), CKPT_REL_RMS)
            row["decode_v"] = _against_mirror(w.model.decode_v(x, t, lat),
                                              dm.decode_v(x, t, lat), CKPT_REL_RMS)
            row["decode_v_ms"] = cuda_ms(lambda: w.model.decode_v(x, t, lat), 3)
            z, took = counted(lambda: w.encode(audio))
            z_twin = _with_twin_stft(lambda: w.encode(audio))
        row["encode_k6_vs_twin"] = {"rel_rms": rel_rms(z, z_twin), "bound": CKPT_REL_RMS,
                                    "shape": list(z.shape), "stft_rows": DMAE_STFT}
        row["launches"] = took
        if took["k6"] != 1 or not row["encode_k6_vs_twin"]["rel_rms"] < CKPT_REL_RMS:
            raise AssertionError(f"checkpoints: DMAE's encode through K6 {row}")
        del dm, w, z, z_twin
        path.unlink()
        done("DMAE", row)

        # ---- RAVE: RAVEWrapper() defaults (RaveV2, weight-normed), .ckpt and .ts
        rm = build(mirrors.RaveV2, 130)
        sd = {k: v.detach().cpu() for k, v in rm.state_dict().items()}
        files = {".ckpt": tmp / "rave.ckpt", ".ts": tmp / "rave.ts"}
        torch.save({"state_dict": sd}, files[".ckpt"])
        torch.jit.save(export.script_state_dict(sd), str(files[".ts"]))
        bands = randn(2, 16, 4096, scale=0.3)
        with torch.inference_mode(), torch.device(dev):   # the mirror's bare factories
            z_ref = rm.encode_bands(bands)
            noise = torch.rand((2, 4096 // 64, 16, 64), generator=g, device=dev) * 2 - 1
            bands_ref = rm.decode_bands(z_ref, noise=noise)
        for ext, path in files.items():
            w = RAVEWrapper(checkpoint_file=str(path), device="cuda")
            w.ckpt_info = _ckpt_info(path)
            row = _setup(f"RAVE {ext}", lambda: w.setup(), [path])
            with torch.inference_mode():
                row["encode_bands"] = _against_mirror(w.model.encode_bands(bands)[:, :128],
                                                      z_ref, CKPT_REL_RMS)
                row["decode_bands"] = _against_mirror(w.model.decode_bands(z_ref, noise=noise),
                                                      bands_ref, CKPT_REL_RMS)
                row["decode_bands_ms"] = cuda_ms(lambda: w.model.decode_bands(z_ref, noise=noise), 3)
            done(f"RAVE{ext}", row)
        del rm, w

        # ---- MIRAGE: CLAPDAE() defaults from CLAPDAE_CKPT_22s and LATENT_DIFFAE_CKPT
        lm = build(mirrors.StackedAELatentDiffusionCondLDM, 140)
        _perturb(lm.diffusion_ema.ema_model, 141)
        path = tmp / "clapdae_22s.ckpt"
        torch.save({"state_dict": lm.state_dict()}, path)
        ref = lm.diffusion_ema.ema_model
        del lm
        saved = {k: os.environ.get(k) for k in ("CLAPDAE_CKPT_22s", "LATENT_DIFFAE_CKPT",
                                                  "CLAP_CKPT")}
        os.environ.update({"CLAPDAE_CKPT_22s": str(path), "LATENT_DIFFAE_CKPT": str(stacked_path)})
        os.environ.pop("CLAP_CKPT", None)
        try:
            model = CLAPDAE(device="cuda", seed=0)
            row = _setup("MIRAGE", lambda: model.setup(model_len="22s"), [path, stacked_path])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if len(row["pours"]) != 2:
            raise AssertionError(f"checkpoints: MIRAGE poured {row['pours']}")
        unet, t_len = model.latent_diffusion_model.diffusion, MIRAGE_SAMPLES // 512
        x, t = randn(1, 32, t_len), torch.rand((1,), generator=g, device=dev)
        emb = randn(1, 1, 512)
        emb = emb / emb.norm()
        with torch.inference_mode():
            rb = precompute_rel_biases(unet, t_len)
            kw = dict(embedding=emb, embedding_scale=4.0)
            v, took = counted(lambda: unet(x, t, rel_biases=rb, **kw))
            with torch.device(dev):               # the mirror's bare factories: on the card
                v_ref = ref(x, t, **kw)
            row["unet_cfg1d"] = _against_mirror(v, v_ref, MIRAGE_REL_RMS_BOUND["float32"])
            row["unet_cfg1d_ms"] = cuda_ms(lambda: unet(x, t, rel_biases=rb, **kw), 3)
        row["launches"] = took
        if took["k3"] != K3_PER_INNER or took["k5"] != K5_PER_INNER:
            raise AssertionError(f"checkpoints: the poured UNetCFG1d launched {took}")
        del ref, v, v_ref
        torch.cuda.empty_cache()
        model.half()
        start = time.perf_counter()
        (fakes, latents), took = counted(lambda: model.generate(
            emb, cfg_scales=4, demo_steps=CKPT_STEPS, outer_steps=CKPT_STEPS, batch_size=1))
        in_range = bool((latents.abs() <= 1).all())
        row["generate"] = {"steps": [CKPT_STEPS, CKPT_STEPS], "dtype": "bfloat16",
                           "seconds": time.perf_counter() - start,
                           "out_shape": list(fakes.shape), "finite": _finite(fakes),
                           "latents_in_range": in_range, "launches": took}
        want = {"k1": CKPT_STEPS * K1_PER_OUTER, "k3": CKPT_STEPS * K3_PER_INNER,
                "k5": CKPT_STEPS * K5_PER_INNER}
        if tuple(fakes.shape) != (2, MIRAGE_SAMPLES) or not in_range or \
                any(took[k] != n for k, n in want.items()):
            raise AssertionError(f"checkpoints: MIRAGE from the poured weights {row}")
        del model, fakes, latents
        done("MIRAGE", row)
    emit({"phase": "checkpoints", "seconds": time.time() - t_phase, "launches": counts,
          "card": card(),
          "clap": "poured on the CPU only (tests/test_torch_convert.py, against a "
                  "transformers ClapModel): no torch CLAP mirror in the repository"})
    return counts


# ------------------------------------------------------------------------
# The effects bank's recurrences (R1-R3), its sweep, IO, the XAE corpus
# builder and the MIRAGE CLI.

FMA_LATENCY_CYCLES = 4         # a dependent f32 FMA (or select) on the SM
# f32 operations a sample: R1 5 multiply-adds a section, R2 two
# multiply-adds, a product and a select, R3 per comb the damping and the
# feedback (2 multiply-adds and a product) and the sum, per allpass a
# multiply-add and a difference
REC_OPS_PER_SAMPLE = {"sosfilt": 10, "envelope": 7, "freeverb_ir": 8 * 7 + 4 * 3}
# R1-R3's distance from float64 on the card in their serial designs (R1
# and R2 a thread a row, R3's damping chains a thread a comb; PERF.md's
# recurrence table): a case may sit no further than the larger of 1e-6
# and twice that
REC_SERIAL_REL_RMS_VS_F64 = {("sosfilt", "tpt"): 5.4e-8, ("sosfilt", "phaser"): 6.0e-7,
                             ("sosfilt", "loudness"): 8.8e-5,
                             ("sosfilt", "apps_lowpass"): 5.4e-8,
                             ("sosfilt", "apps_highpass"): 2.5e-7,
                             ("envelope", None): 4.2e-6,
                             ("freeverb_ir", "xae"): 3.1e-7, ("freeverb_ir", "apps"): 2.1e-7}
XAE_CHUNK, XAE_KNOBS, XAE_CLIPS = 262144, 32, 2
IO_FX_CLI_PHASES = ("io", "mirage_cli", "recurrence", "effects", "xae")   # budget ~90 s together
PITCH_STFT = (XAE_CLIPS * 2, XAE_CHUNK)   # PitchShift's stft rows: clips x stereo
REC_TWIN_T = {"envelope": 16384, "freeverb_ir": 4096}    # the loop twins' lengths
REC_REL_RMS = 1e-4             # R1-R3 vs twin and vs float64 (filters, compressor, reverb)
REC_ENV_MAX_ERR = 1e-5         # R2's largest error from float64, over the row's peak
IO_SECONDS, IO_SR = 30, 44100
MIRAGE_CLI_STEPS = (50, 25)    # inner, outer: cut from 150 + 100 for the time limit
SERVE_BATCH_STEPS = (20, 10)   # the micro-batcher's requests, cut likewise


def sm_clock_hz() -> float:
    """The SM's maximum clock, from nvidia-smi."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def rec_bound(name: str, rows: int, t_len: int, steps_per_sample: int, n_sec: int = 1,
              io_tensors: int = 2) -> dict:
    """A recurrence's bound, the least time the card could take: the larger
    of its bytes (each f32 input read once, each output written once) over
    the HBM rate and its f32 operations (REC_OPS_PER_SAMPLE, x n_sec for
    R1) over the f32 peak. Beside it `serial_chain_ms`, what a design that
    walks each row with one thread could reach at best: t_len samples x the
    dependent steps a sample x one FMA's latency at the SM's clock. It is
    not the bound: R1 and R3 cut time apart."""
    t_bytes = io_tensors * rows * t_len * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = rows * t_len * REC_OPS_PER_SAMPLE[name] * n_sec / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "operations_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_kind": f"{'bytes' if t_bytes >= t_ops else 'f32 operations'}: "
                          f"{io_tensors} x {rows} x {t_len} f32 at 3.35 TB/s, "
                          f"{REC_OPS_PER_SAMPLE[name] * n_sec} FLOP a sample at 67 TF/s",
            "serial_chain_ms": t_len * steps_per_sample * FMA_LATENCY_CYCLES
            / sm_clock_hz() * 1e3}


def _envelope_f64(x, a_att, a_rel):
    import numpy as np
    env, out = 0.0, []
    for level in np.abs(np.asarray(x, np.float64)).tolist():
        c = a_att if level > env else a_rel
        env = c * env + (1 - c) * level
        out.append(env)
    return np.asarray(out)


def envelope_inputs(rows: int, t_len: int, gen) -> dict:
    """R2's kinds of input, (rows, t_len) f32 on the card each: white noise;
    a burst of 4,000 samples then silence; a decaying 220 Hz tone gated on
    for 1,024 samples from every multiple of 2,048 (so its level jumps on
    chunk starts for L <= 1,024) and silent between; a crescendo (a 440 Hz
    sine under a linear ramp); a constant 0.5 (ties: l == env); zeros."""
    import torch
    dev = gen.device
    t = torch.arange(t_len, device=dev, dtype=torch.float32)
    scale = torch.linspace(0.6, 1.0, rows, device=dev)[:, None]
    burst = 0.8 * torch.randn((rows, t_len), generator=gen, device=dev)
    burst[:, 4000:] = 0.0
    tone = torch.sin(2 * math.pi * 220.0 * t / 48000) * torch.exp(-(t % 2048) / 600)
    phase = torch.arange(rows, device=dev)[:, None]
    return {"noise": 0.3 * torch.randn((rows, t_len), generator=gen, device=dev),
            "burst": burst,
            "gate": scale * torch.where(t % 2048 < 1024, 0.8 * tone, 0.0),
            "crescendo": torch.sin(2 * math.pi * 440.0 * t / 48000 + phase) * t / t_len,
            "dc": torch.full((rows, t_len), 0.5, device=dev),
            "zeros": torch.zeros((rows, t_len), device=dev)}


def _freeverb_ir_f64(feedback, damp, n, sr, spread):
    """JUCE's comb / allpass recurrence in float64 (tests/test_effects.py's)."""
    import numpy as np
    from audio_algebra_torch.ops.recurrence import delay_sizes
    combs, aps = delay_sizes(sr, spread)
    bufs = [np.zeros(s) for s in combs]
    lasts = [0.0] * len(combs)
    apbufs = [np.zeros(s) for s in aps]
    ir = np.zeros(n)
    for i in range(n):
        inp = 1.0 if i == 0 else 0.0
        acc = 0.0
        for j, s in enumerate(combs):
            o = bufs[j][i % s]
            lasts[j] = o * (1 - damp) + lasts[j] * damp
            bufs[j][i % s] = inp + lasts[j] * feedback
            acc += o
        for k, s in enumerate(aps):
            bo = apbufs[k][i % s]
            apbufs[k][i % s] = acc + bo * 0.5
            acc = bo - acc
        ir[i] = acc
    return ir


def _rel_rms_np(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / max((b ** 2).mean(), 1e-30)))


def phase_recurrence() -> dict:
    """R1, R2 and R3 on the card at the xae path's shapes, R1 and R3 at the
    apps path's too, and R1 where its chunked scan's edges lie: each
    against its twin (R1 at full length; R2 and R3, whose twins loop, at
    REC_TWIN_T), at full length against a float64 recurrence on a subset
    of rows, and timed beside its twin, its bound and its serial chain.
    R1's rows give the chunk length and count and the launches a call,
    each checked."""
    import numpy as np
    import scipy.signal
    import torch
    from audio_algebra_torch.ops import effects as fx
    from audio_algebra_torch.ops import recurrence as rec
    from audio_algebra_torch.ops.filters import butter_sos
    from audio_algebra_torch.ops.loudness import _k_weighting_sos

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows_xae = XAE_CLIPS * XAE_KNOBS * 2
    out = {}

    def randn(*shape):
        return 0.3 * torch.randn(shape, generator=gen, device=dev)

    def held(name, got, want, pick, full, f64, ms, plain_ms, plain_shape, bound, **extra):
        """`got` / `want`: kernel / twin on the same inputs (the twin's
        length); `full`: the kernel at full length; `f64`: the float64
        recurrence of rows `pick` at full length. The kernel must be as
        close to float64 as the twin (or within REC_REL_RMS), and as close
        to the twin as twice the twin's own distance from float64; a case
        of REC_SERIAL_REL_RMS_VS_F64 no further from float64 than the larger
        of 1e-6 and twice its distance there."""
        n = want.shape[-1]
        row = {"max_abs_err": (got - want).abs().max().item(),
               "rel_rms_vs_twin": rel_rms(got.double(), want.double()),
               "rel_rms_vs_f64": _rel_rms_np(full[pick].cpu().numpy(), f64),
               "twin_rel_rms_vs_f64": _rel_rms_np(want[pick].cpu().numpy(), f64[:, :n]),
               "kernel_ms": ms["call"], "kernel_device_ms": ms["device"],
               "bound_share": bound["bound_ms"] / ms["device"],
               "plain_ms": plain_ms, "plain_shape": plain_shape, "library_ms": None,
               "library": "chain: no PyTorch call computes a recurrence", **bound, **extra}
        earlier = REC_SERIAL_REL_RMS_VS_F64.get((name, extra.get("case")),
                                                REC_SERIAL_REL_RMS_VS_F64.get((name, None)))
        if earlier is not None:
            row["f64_limit"] = max(1e-6, 2 * earlier)
        out.setdefault(name, []).append(row)
        emit({"phase": "recurrence", "kernel": name, **row})
        if not (row["rel_rms_vs_f64"] <= max(REC_REL_RMS, row["twin_rel_rms_vs_f64"])
                and row["rel_rms_vs_twin"] <= max(REC_REL_RMS, 2 * row["twin_rel_rms_vs_f64"])
                and row["rel_rms_vs_f64"] <= row.get("f64_limit", math.inf)
                and row["bound_share"] <= 1.0):
            raise AssertionError(f"{name}: {row}")

    def times(fn, iters):
        return {"call": cuda_ms(fn, iters), "device": device_ms(fn, iters)}

    # R1 at its three xae-path shapes: the TPT filters' one section a row,
    # the phaser's 8 segments x 2 sections a row, loudness's 2 shared
    # sections over a whole 30 s track
    knobs = torch.tensor(fx.knob_sweep("LowpassFilter", XAE_KNOBS), dtype=torch.float32,
                         device=dev)
    tpt = fx._tpt_first_order_sos(knobs, 48000, "lowpass")                 # (K, 1, 6)
    cases = {
        "tpt": (tpt.repeat_interleave(rows_xae // XAE_KNOBS, 0), randn(rows_xae, XAE_CHUNK)),
        "phaser": (None, randn(rows_xae * 8, XAE_CHUNK // 8)),
        "loudness": (_k_weighting_sos(48000).to(dev)[None], randn(2, IO_SECONDS * 48000)),
    }
    f = 1300.0 * (1.0 + 0.4 * torch.sin(torch.rand(rows_xae * 8, generator=gen, device=dev)))
    b, a = fx.biquad_coeffs("notch", f, 48000, q=0.7)
    cases["phaser"] = (torch.cat([b, a], -1)[:, None, :].expand(-1, 2, 6).contiguous(),
                       cases["phaser"][1])
    # and at the apps path's: one clip's LowpassFilter / HighpassFilter sweep
    # in effects_explorer, APPS_KNOBS knobs x 2 channels of CHUNK, a row's
    # own coefficients (each knob's on its two channels' rows)
    for kind, effect in (("lowpass", "LowpassFilter"), ("highpass", "HighpassFilter")):
        k = torch.tensor(fx.knob_sweep(effect, APPS_KNOBS), dtype=torch.float32, device=dev)
        cases[f"apps_{kind}"] = (fx._tpt_first_order_sos(k, 48000, kind).repeat_interleave(2, 0),
                                 randn(2 * APPS_KNOBS, CHUNK))
    # and where the chunked scan's edges lie: a last chunk shorter than L
    # (100,000 = 781 x 128 + 32; 200,000 = 781 x 256 + 64), a row too short
    # to cut (96 samples: one chunk, a thread a row), 8 sections with a
    # row's own coefficients, 9 (two launches: 8 + 1)
    cut = torch.linspace(1500.0, 12000.0, 64, device=dev)
    butter = butter_sos(2, cut, 48000, "lowpass")                         # (64, 1, 6)
    cases |= {"ragged": (butter.repeat(1, 2, 1), randn(64, 100_000)),
              "ragged_l256": (butter[:2].repeat(1, 2, 1), randn(2, 200_000)),
              "short": (butter[:16].repeat(1, 2, 1), randn(16, 96)),
              "sections8": (butter[:32].repeat(1, 8, 1), randn(32, 20000)),
              "sections9": (butter[:32].repeat(1, 9, 1), randn(32, 20000))}
    for case, (sos, x) in cases.items():
        groups = -(-sos.shape[1] // rec.MAX_SECTIONS)
        before = (rec.launches["sosfilt"], rec.cuda_launches["sosfilt"])
        y = rec.sosfilt_rows(sos, x)
        torch.cuda.synchronize()
        length, chunks = rec.chunk_plan(x.shape[0], x.shape[1] + (-x.shape[1] % 4))
        cuda_per_call = rec.cuda_launches["sosfilt"] - before[1]
        if (rec.launches["sosfilt"] - before[0], cuda_per_call) != \
                (groups, groups * (3 if chunks > 1 else 1)):
            raise AssertionError(f"sosfilt ({case}): launches {before} -> "
                                 f"{rec.launches['sosfilt']}, {rec.cuda_launches['sosfilt']}")
        want = rec.sosfilt_rows_ref(sos, x)
        pick = [0, x.shape[0] - 1]
        f64 = [scipy.signal.sosfilt(sos[min(r, sos.shape[0] - 1)].double().cpu().numpy(),
                                    x[r].double().cpu().numpy()) for r in pick]
        held("sosfilt", y, want, pick, y, np.stack(f64),
             times(lambda: rec.sosfilt_rows(sos, x), 10),
             cuda_ms(lambda: rec.sosfilt_rows_ref(sos, x), 2), list(x.shape),
             rec_bound("sosfilt", x.shape[0], x.shape[1], 2, n_sec=sos.shape[1]), case=case,
             shape=list(x.shape), sections=sos.shape[1],
             coefficients_per_row=sos.shape[0] != 1, chunk_len=length, chunks=chunks,
             launches_a_call=groups, cuda_launches_a_call=cuda_per_call)

    # R2 at the compressor's (2 clips x 2 channels, 262144) on six kinds of
    # input (envelope_inputs), then where its plan's edges lie: a length that
    # is no multiple of 4 or of L, one chunk (the serial route), 40 rows x
    # 2,000, and a 30 s row whose chunks stream from L2 (too long for the
    # cluster's shared memory). Each against the twin (the six at REC_TWIN_T
    # in one twin call, the 30 s row's prefix alone, the others at full
    # length, on the CPU, where a loop of small steps runs faster), at full
    # length against float64 on its first row; its rounds, repair flag and
    # launches read and checked
    a_att, a_rel = math.exp(-1.0 / 48.0), math.exp(-1.0 / 4800.0)
    t_short = REC_TWIN_T["envelope"]
    env_cases = envelope_inputs(XAE_CLIPS * 2, XAE_CHUNK, gen)
    stacked = torch.cat([x[:, :t_short] for x in env_cases.values()])
    t0 = time.perf_counter()
    want_all = rec.envelope_ref(stacked, a_att, a_rel)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name_x, shape in (("ragged", (4, 16035)), ("one_chunk", (4, 96)),
                          ("rows40", (40, 2000)), ("streamed", (1, IO_SECONDS * 48000))):
        x = randn(*shape)
        x[:, shape[1] // 3: shape[1] // 2] *= 6.0
        env_cases[name_x] = x
    for i, (case, x) in enumerate(env_cases.items()):
        rows_x, t_len = x.shape
        before = (rec.launches["envelope"], rec.cuda_launches["envelope"])
        env = rec.envelope(x, a_att, a_rel)
        stats = rec.envelope_stats()
        if (rec.launches["envelope"] - before[0], rec.cuda_launches["envelope"] - before[1]) \
                != (1, 1) or stats["repaired"] != [False] * rows_x:
            raise AssertionError(f"envelope ({case}): launches {before} -> "
                                 f"{rec.launches['envelope']}, {rec.cuda_launches['envelope']}; "
                                 f"{stats}")
        if t_len == XAE_CHUNK:
            short = rec.envelope(x[:, :t_short].contiguous(), a_att, a_rel)
            want, twin_ms, twin_shape = (want_all[i * rows_x:(i + 1) * rows_x], plain_ms,
                                         list(stacked.shape))
        else:               # at full length (the 30 s row: its prefix), on the CPU
            twin_x = x[:, :t_short].contiguous() if case == "streamed" else x
            short = rec.envelope(twin_x, a_att, a_rel) if case == "streamed" else env
            t0 = time.perf_counter()
            want = rec.envelope_ref(twin_x.cpu(), a_att, a_rel).to(dev)
            twin_ms, twin_shape = (time.perf_counter() - t0) * 1e3, list(twin_x.shape)
        pick = [0]
        xs = x[pick].double().cpu().numpy()
        # float64 walks with the coefficients the kernel takes (f32-rounded:
        # the kernel's own arithmetic) and with exact ones (their rounding
        # alone puts any f32 walk 1.6e-5 rel-RMS off over a burst's release)
        f64 = np.stack([_envelope_f64(r, float(np.float32(a_att)), float(np.float32(a_rel)))
                        for r in xs])
        f64_exact = np.stack([_envelope_f64(r, a_att, a_rel) for r in xs])
        peak = max(float(np.abs(f64).max()), 1e-30)
        got = env[pick].double().cpu().numpy()
        held("envelope", short, want, pick, env, f64,
             times(lambda: rec.envelope(x, a_att, a_rel), 10), twin_ms, twin_shape,
             rec_bound("envelope", rows_x, t_len, 2), case=case, shape=list(x.shape),
             chunk_len=stats["chunk_len"], chunks=stats["chunks"],
             resident=stats["resident"], warps_a_block=stats["warps"],
             rounds=max(stats["rounds"]), rounds_by_row=stats["rounds"],
             repaired=any(stats["repaired"]), cuda_launches_a_call=1,
             max_err_over_peak_vs_f64=float(np.abs(got - f64).max()) / peak,
             rel_rms_vs_f64_exact_coefficients=_rel_rms_np(got, f64_exact),
             max_err_over_peak_vs_f64_exact_coefficients=float(np.abs(got - f64_exact).max())
             / peak)
        row = out["envelope"][-1]
        # the noise row as the serial design's was held: against exact
        # coefficients too
        if not (row["max_err_over_peak_vs_f64"] <= REC_ENV_MAX_ERR
                and (case != "noise" or row["rel_rms_vs_f64_exact_coefficients"]
                     <= row["f64_limit"])):
            raise AssertionError(f"envelope ({case}): {row}")

    # R3 at the reverb sweeps' knobs x 2 spreads: the xae path's 32 knobs,
    # n = 262144, and the apps path's APPS_KNOBS, n = CHUNK
    n_short = REC_TWIN_T["freeverb_ir"]
    for case, n_knobs, t_len in (("xae", XAE_KNOBS, XAE_CHUNK), ("apps", APPS_KNOBS, CHUNK)):
        room = torch.tensor(fx.knob_sweep("Reverb", n_knobs), dtype=torch.float32, device=dev)
        fb = torch.cat([room * 0.28 + 0.7] * 2)
        dm = torch.full_like(fb, float(np.float32(0.5) * np.float32(0.4)))
        spreads = [0] * n_knobs + [fx.FREEVERB_STEREO_SPREAD] * n_knobs
        ir = rec.freeverb_irs(fb, dm, spreads, t_len)
        short = rec.freeverb_irs(fb, dm, spreads, n_short)
        t0 = time.perf_counter()
        want = rec.freeverb_irs_ref(fb, dm, spreads, n_short)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        last = 2 * n_knobs - 1
        held("freeverb_ir", short, want, [last], ir,
             _freeverb_ir_f64(float(fb[last]), float(dm[last]), t_len, 48000,
                              spreads[last])[None],
             times(lambda: rec.freeverb_irs(fb, dm, spreads, t_len), 5), plain_ms,
             [2 * n_knobs, n_short], rec_bound("freeverb_ir", 2 * n_knobs, t_len, 1,
                                               io_tensors=1),
             case=case, shape=[2 * n_knobs, t_len],
             prefix_equal=bool(torch.equal(ir[:, :n_short], short)))
        if not out["freeverb_ir"][-1]["prefix_equal"]:
            raise AssertionError(f"R3 ({case}): a shorter response is not the longer one's "
                                 "prefix")
    emit({"phase": "recurrence", "card": card()})
    return out


def _ensure_native_codec() -> dict:
    """Build native/libaacodec.so (make, g++) when the checkout has none."""
    from audio_algebra_torch.utils import audio_io
    built = False
    if not audio_io.NATIVE_LIB.exists():
        subprocess.run(["make", "-C", str(ROOT / "native")], check=True,
                       capture_output=True, timeout=300)
        built = True
    return {"native_lib": str(audio_io.NATIVE_LIB.relative_to(ROOT)), "built": built}


def _ogg_available(tmp: Path) -> tuple[bool, str]:
    """Whether the running machine's libvorbis / libvorbisenc open: the native
    codec reaches them with dlopen at run time. Only that case reads as no
    OGG; any other failure of the binding raises."""
    import numpy as np
    from audio_algebra_torch.utils import audio_io
    try:
        audio_io.encode_ogg(str(tmp / "probe.ogg"), np.zeros((2, 4096), np.float32), 44100)
        audio_io.decode_ogg(str(tmp / "probe.ogg"))
        return True, ""
    except audio_io.VorbisUnavailable as e:
        return False, str(e)


def _music(rng, channels: int, n: int, sr: int):
    """A seeded stand-in for music: three tones a channel, a slow tremolo
    and noise, peak under 1."""
    import numpy as np
    t = np.arange(n) / sr
    x = np.zeros((channels, n))
    for c in range(channels):
        for f in rng.uniform(80, 2000, 3):
            x[c] += 0.18 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.283))
        x[c] *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
    x += 0.03 * rng.standard_normal(x.shape)
    return np.clip(x, -1, 1).astype(np.float32)


def phase_io(tmp: Path) -> dict:
    """A 30 s stereo 44.1 kHz signal written as FLAC by the port's encoder
    and as OGG, read back through load_audio (resampled to 48 kHz) and
    through decode_batch; FLAC round-trips bit-exactly at 16 bits. Returns
    the FLAC's path and whether OGG works on the running machine."""
    import numpy as np
    from audio_algebra_torch.utils import audio_io
    from audio_algebra_torch.utils.flac_write import write_flac

    build = _ensure_native_codec()
    ogg, ogg_reason = _ogg_available(tmp)
    x = _music(np.random.default_rng(11), 2, IO_SECONDS * IO_SR, IO_SR)
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767)
    paths = {"flac": tmp / "io.flac", "ogg": tmp / "io.ogg"}
    row = {"phase": "io", **build, "seconds_of_audio": IO_SECONDS, "sample_rate": IO_SR,
           "ogg_available": ogg, "ogg_unavailable_reason": ogg_reason or None, "ms": {}}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        row["ms"][key] = (time.perf_counter() - t0) * 1e3
        return out

    timed("write_flac", lambda: write_flac(str(paths["flac"]), x, IO_SR))
    raw, sr = timed("decode_flac", lambda: audio_io.decode_flac(str(paths["flac"])))
    row["flac_bytes"] = paths["flac"].stat().st_size
    row["flac_bit_exact"] = bool(sr == IO_SR and raw.shape == x.shape
                                 and np.array_equal(raw * 32768.0, pcm))
    y48 = timed("load_audio_flac_48k", lambda: audio_io.load_audio(str(paths["flac"]), 48000))
    row["flac_48k_shape"] = list(y48.shape)
    files = [paths["flac"]]
    if ogg:
        timed("encode_ogg", lambda: audio_io.encode_ogg(str(paths["ogg"]), x, IO_SR))
        o48 = timed("load_audio_ogg_48k", lambda: audio_io.load_audio(str(paths["ogg"]), 48000))
        row["ogg_bytes"] = paths["ogg"].stat().st_size
        row["ogg_48k_shape"] = list(o48.shape)
        n = min(o48.shape[1], y48.shape[1])
        row["ogg_corr"] = float(np.dot(o48[0, :n], y48[0, :n])
                                / (np.linalg.norm(o48[0, :n]) * np.linalg.norm(y48[0, :n])))
        files.append(paths["ogg"])
    batch = timed("decode_batch", lambda: audio_io.decode_batch([str(p) for p in files]))
    row["decode_batch"] = [None if b is None else [list(b[0].shape), b[1]] for b in batch]
    row["decode_batch_flac_equal"] = bool(batch[0] is not None
                                          and np.array_equal(batch[0][0], raw))
    emit(row)
    want_48k = [2, int(math.ceil(IO_SECONDS * IO_SR * 48000 / IO_SR))]
    if not (row["flac_bit_exact"] and row["flac_48k_shape"] == want_48k
            and row["decode_batch_flac_equal"] and all(b is not None for b in batch)):
        raise AssertionError(f"io: {row}")
    if ogg and not (row["ogg_48k_shape"][0] == 2 and row["ogg_corr"] > 0.9):
        raise AssertionError(f"io (ogg): {row}")
    return {"flac": paths["flac"], "ogg": ogg, "ogg_path": paths["ogg"],
            "ogg_reason": ogg_reason}


def _effect_counts() -> dict:
    from audio_algebra_torch.ops import recurrence as rec
    from audio_algebra_torch.ops import stft_kernel as stk
    return {"r1": rec.launches["sosfilt"], "r2": rec.launches["envelope"],
            "r3": rec.launches["freeverb_ir"], "k6": stk.launches}


def _zero_effect_counts() -> None:
    from audio_algebra_torch.ops import recurrence as rec
    from audio_algebra_torch.ops import stft_kernel as stk
    for key in rec.launches:
        rec.launches[key] = 0
    for key in rec.cuda_launches:
        rec.cuda_launches[key] = 0
    stk.launches = 0
    for route in K6_ROUTES:
        setattr(stk, f"{route}_launches", 0)


def phase_effects() -> dict:
    """Every effect of EFFECTS swept over 32 knobs on (2, 2, 262144) f32
    (PitchShift's static knob looping on the host): seconds of a first
    sweep and of a second (plans and tables built), peak memory, launches
    of R1, R2, R3 and K6 in the second, finite outputs of (K, 2, 2, T)."""
    import numpy as np
    import torch
    from audio_algebra_torch.ops import effects as fx

    x = torch.from_numpy(np.stack([_music(np.random.default_rng(20 + i), 2, XAE_CHUNK, 48000)
                                   for i in range(XAE_CLIPS)])).cuda()
    rows, total = {}, {"r1": 0, "r2": 0, "r3": 0, "k6": 0}
    for name, (_, knob_name, *_) in fx.EFFECTS.items():
        knobs = fx.knob_sweep(name, XAE_KNOBS) if knob_name != "none" else np.asarray([0.0])
        sweep = knobs if name in fx.STATIC_KNOB else torch.tensor(knobs, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fx.apply_effect(name, x, sweep)      # first call: FFT plans, resampling tables
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        _zero_effect_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        y = fx.apply_effect(name, x, sweep)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts = _effect_counts()
        rows[name] = {"sweep_s": s, "sweep_s_first_call": cold_s, "knobs": len(knobs),
                      "shape": list(y.shape),
                      "finite": bool(torch.isfinite(y).all()),
                      "peak_gb_over_input": (torch.cuda.max_memory_allocated() - base) / 1e9,
                      "launches": counts}
        for key in total:
            total[key] += counts[key]
        del y
        emit({"phase": "effects", "effect": name, **rows[name]})
    emit({"phase": "effects", "shape": list(x.shape), "knob_steps": XAE_KNOBS,
          "launches": total, "sweep_s_total": sum(r["sweep_s"] for r in rows.values())})
    bad = {n: r for n, r in rows.items()
           if not r["finite"] or r["shape"] != [r["knobs"], *x.shape]}
    if bad:
        raise AssertionError(f"effects: {bad}")
    for name, key in (("LowpassFilter", "r1"), ("Phaser", "r1"), ("Compressor", "r2"),
                      ("Reverb", "r3"), ("PitchShift", "k6")):
        if rows[name]["launches"][key] < 1:
            raise AssertionError(f"effects: {name} launched no {key}: {rows[name]}")
    return total


def phase_xae(tmp: Path, ogg: bool) -> dict:
    """audio_algebra_torch.xae_dataset.main on two generated ~6 s source
    files (a FLAC and an OGG; a second FLAC where the machine has no
    libvorbis) at --chunk-size 262144, --knob-steps 32, all 12 effects,
    --normalize loudness, --encode through DVAEWrapper() at its default
    width with seeded random weights; the arrays' and the manifest's shapes,
    finite values, and the launches of R1, R2, R3 and K6."""
    import numpy as np
    from audio_algebra_torch import xae_dataset
    from audio_algebra_torch.ops import effects as fx
    from audio_algebra_torch.utils import audio_io
    from audio_algebra_torch.utils.flac_write import write_flac

    src, out = tmp / "xae_src", tmp / "xae_out"
    src.mkdir()
    n = 6 * IO_SR
    write_flac(str(src / "a.flac"), _music(np.random.default_rng(31), 2, n, IO_SR), IO_SR)
    second = src / ("b.ogg" if ogg else "b.flac")
    audio = _music(np.random.default_rng(32), 2, n, IO_SR)
    (audio_io.encode_ogg if ogg else write_flac)(str(second), audio, IO_SR)
    names = list(fx.EFFECTS)
    _zero_effect_counts()
    t0 = time.perf_counter()
    xae_dataset.main(["--source-dir", str(src), "--out-dir", str(out),
                      "--chunk-size", str(XAE_CHUNK), "--knob-steps", str(XAE_KNOBS),
                      "--effects", ",".join(names), "--normalize", "loudness",
                      "--encode", "--encode-batch", "16", "--device", "cuda"])
    seconds = time.perf_counter() - t0
    counts = _effect_counts()
    manifest = json.loads((out / "manifest.json").read_text())
    clips = np.load(out / "clips.npy")
    arrays = {p.name: np.load(p) for p in sorted(out.glob("*.npy"))}
    finite = {k: bool(np.isfinite(v).all()) for k, v in arrays.items()}
    want_rows = XAE_CLIPS * sum(1 if fx.EFFECTS[e][1] == "none" else XAE_KNOBS for e in names)
    row = {"phase": "xae", "seconds": seconds, "sources": [p.name for p in sorted(src.iterdir())],
           "clips": list(clips.shape), "rows": len(manifest["rows"]), "rows_expected": want_rows,
           "shapes": {k: list(v.shape) for k, v in arrays.items()}, "launches": counts,
           "all_finite": all(finite.values()), "card": card()}
    emit(row)
    ok = (list(clips.shape) == [XAE_CLIPS, 2, XAE_CHUNK] and row["all_finite"]
          and len(manifest["rows"]) == want_rows and manifest["effects"] == names
          and manifest["chunk_size"] == XAE_CHUNK)
    for e in names:
        k = 1 if fx.EFFECTS[e][1] == "none" else XAE_KNOBS
        ok &= list(arrays[f"fx_{e}.npy"].shape) == [XAE_CLIPS, k, 2, XAE_CHUNK]
        ok &= arrays[f"emb_{e}.npy"].shape[:2] == (XAE_CLIPS, k)
    if not ok or min(counts.values()) < 1:
        raise AssertionError(f"xae: {row}")
    return counts


def phase_mirage_cli(model, flac: Path, tmp: Path) -> dict:
    """`python -m audio_algebra_torch.mirage`'s main at full width on the
    warm 22 s model (get_model_ready's cache seeded with it), twice at
    MIRAGE_CLI_STEPS: two text prompts slerped with --init-audio from the io
    phase's FLAC (the img2img path generates one take a clip, as the
    reference's does), and two text prompts and the FLAC as an audio prompt
    at --batch-size 2. Checks the WAVs, the PCA .npy / .html and the
    launches of K1, K3, K5 and K6."""
    import numpy as np
    from audio_algebra_torch import embedding_math, mirage
    from audio_algebra_torch.utils.audio_io import read_wav

    embedding_math._model_cache[embedding_math.model_cache_key("22s", True, "cuda")] = model
    inner, outer = MIRAGE_CLI_STEPS
    runs = {"init_audio": ["--init-audio", str(flac), "--batch-size", "2"],
            "audio_prompt": ["--audio", str(flac), "--batch-size", "2"]}
    want_samples = {"init_audio": MIRAGE_SAMPLES, "audio_prompt": 2 * MIRAGE_SAMPLES - 72000}
    out, counts = {}, {}
    for name, extra in runs.items():
        out_dir = tmp / f"mirage_{name}"
        _zero_all_counts()
        t0 = time.perf_counter()
        result = mirage.main(["--text", "low brass", "--text", "warm pad", *extra,
                              "--steps", str(inner), "--outer-steps", str(outer), "--seed", "0",
                              "--output-dir", str(out_dir)])
        s = time.perf_counter() - t0
        counts[name] = dict(_all_counts())
        wav, sr = read_wav(result["wav"])
        cloud = np.load(result["pca"])
        html = (out_dir / "mirage_latents_pca.html").read_text()
        out[name] = {"seconds": s, "wav": [*wav.shape, sr], "finite": bool(np.isfinite(wav).all()),
                     "rms": float(np.sqrt((wav ** 2).mean())), "pca": list(cloud.shape),
                     "html_bytes": len(html), "launches": counts[name]}
        emit({"phase": "mirage_cli", "run": name, "steps": [inner, outer], **out[name]})
        ok = (out[name]["wav"] == [2, want_samples[name], 48000] and out[name]["finite"]
              and cloud.shape[1] == 3 and np.isfinite(cloud).all() and "<canvas" in html
              and min(counts[name][k] for k in ("k1", "k3", "k5")) > 0)
        if not ok:
            raise AssertionError(f"mirage_cli ({name}): {out[name]}")
    if counts["audio_prompt"]["k6"] != 1:
        raise AssertionError(f"mirage_cli: the audio prompt launched K6 "
                             f"{counts['audio_prompt']['k6']} times, expected 1")
    return {k: sum(c[k] for c in counts.values()) for k in ("k1", "k3", "k5", "k6")}


# the effects-study apps: effects_explorer over 8 clips x the default 6
# effects x 8 knobs at 65536 samples (the JAX script's defaults) with 1500
# UMAP steps and a 35-step FX2FX decode at batch 1 (191 K1 a step);
# calc_effects_pca on bdct-chunk-pca.ini's 1024 x 65536 batch, 2 batches;
# aa_toy at its default 4000 steps
APPS_CLIPS, APPS_KNOBS, APPS_UMAP_STEPS, APPS_FX2FX_STEPS = 8, 8, 1500, 35
PCA_BATCH, PCA_BATCHES, PCA_COV_REL = 1024, 2, 1e-4
TOY_STEPS = 4000
SPEC_DB_TOL = 0.1              # dB, K6 against its twin over the image
# data parallelism at world 1 over nccl: one mixer step at the algebra
# phase's batch, three ways, updates equal to f32 rounding
DDP_REL = 1e-6


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_corpus(root: Path, n: int, seed: int, subtype: str = "float32") -> float:
    """n seeded stereo WAVs of CHUNK samples at 48 kHz; returns seconds."""
    import numpy as np
    from audio_algebra_torch.utils.audio_io import write_wav

    root.mkdir()
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    phase = (2 * np.pi / 48000 * np.arange(CHUNK)).astype(np.float32)
    for i in range(n):                   # a tone a channel and noise, all f32
        clip = 0.3 * np.sin(rng.uniform(60, 2000, (2, 1)).astype(np.float32) * phase)
        clip += 0.05 * rng.standard_normal((2, CHUNK), dtype=np.float32)
        write_wav(root / f"clip{i:04d}.wav", clip, 48000, subtype=subtype)
    return time.perf_counter() - t0


def phase_apps() -> dict:
    """The effects-study apps at full width on seeded files the phase
    writes: effects_explorer.main (DVAEWrapper() default, APPS_CLIPS clips,
    the default 6 effects, APPS_KNOBS knobs, --umap at APPS_UMAP_STEPS,
    --fx2fx Clean,Reverb at APPS_FX2FX_STEPS); spectrogram_db of one clip
    (K6, against the twin's image); calc_effects_pca.main on
    bdct-chunk-pca.ini for PCA_BATCHES batches of PCA_BATCH, its covariance
    against a float64 two-pass covariance of the same latents; aa_toy.main
    at TOY_STEPS. Seconds a stage, peak memory, the launches of K1, K6, R1
    and R3; returns those launches."""
    import numpy as np
    import torch
    from audio_algebra_torch import aa_toy, calc_effects_pca, effects_explorer
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.ops import stft_kernel as stk
    from audio_algebra_torch.utils.audio_io import read_wav, write_wav
    from audio_algebra_torch.utils.viz import spectrogram_db

    home = os.getcwd()
    seconds, peak, counts = {}, {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_effect_counts()
        gn.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        counts[name] = {**_effect_counts(), "k1": gn.launches}
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)                    # calc_effects_pca's run directory (runs/)
        try:
            src = tmp / "fx_src"
            src.mkdir()
            for i in range(APPS_CLIPS):
                write_wav(src / f"clip{i}.wav",
                          _music(np.random.default_rng(40 + i), 2, 2 * 48000, 48000), 48000,
                          subtype="float32")
            fx = stage("effects_explorer", lambda: effects_explorer.main([
                "--source-dir", str(src), "--out-dir", str(tmp / "fx_out"),
                "--knob-steps", str(APPS_KNOBS), "--chunk-size", str(CHUNK),
                "--max-clips", str(APPS_CLIPS), "--umap", "--umap-steps", str(APPS_UMAP_STEPS),
                "--fx2fx", "Clean,Reverb", "--fx2fx-steps", str(APPS_FX2FX_STEPS),
                "--device", "cuda"]))
            out = Path(fx["out_dir"])
            embs = dict(np.load(out / "embeddings.npz"))
            maps = dict(np.load(out / "umap_maps.npz"))
            wav, _ = read_wav(str(out / "fx2fx_Clean_to_Reverb.wav"))

            clip = _music(np.random.default_rng(40), 2, CHUNK, 48000)
            db = stage("spectrogram_db", lambda: spectrogram_db(torch.from_numpy(clip).cuda()))
            db_twin = spectrogram_db(clip)

            latents = []
            encode_fn = calc_effects_pca.given_model_encode_fn

            def recording(given_model):
                enc = encode_fn(given_model)

                def fn(x):
                    y = enc(x)
                    latents.append(y)
                    return y
                return fn
            pca_files_s = _write_corpus(tmp / "pca_wavs", PCA_BATCH * PCA_BATCHES, 41,
                                        subtype="pcm16")
            calc_effects_pca.given_model_encode_fn = recording
            try:
                pca = stage("calc_effects_pca", lambda: calc_effects_pca.main([
                    "--training_dir", str(tmp / "pca_wavs"), "--batch_size", str(PCA_BATCH),
                    "--device", "cuda"]))
            finally:
                calc_effects_pca.given_model_encode_fn = encode_fn
            flat = torch.cat([y.transpose(0, 1).reshape(y.shape[1], -1) for y in latents],
                             dim=1).double()
            del latents
            xc = flat - flat.mean(dim=1, keepdim=True)
            cov64 = (xc @ xc.T / (flat.shape[1] - 1)).cpu().numpy()
            del flat, xc
            cov_rel = float(np.linalg.norm(pca["cov"] - cov64) / np.linalg.norm(cov64))

            toy = stage("aa_toy", lambda: aa_toy.main(["--steps", str(TOY_STEPS), "--out-dir",
                                                        str(tmp / "toy"), "--device", "cuda"]))
        finally:
            os.chdir(home)
    torch.cuda.empty_cache()

    knobs = {n: 1 if n == "Clean" else APPS_KNOBS for n in embs}
    want_embs = {n: [APPS_CLIPS, k, 64, CHUNK // 128] for n, k in knobs.items()}
    k1_fx2fx = APPS_FX2FX_STEPS * GN_CALLS_PER_FORWARD
    row = {"phase": "apps", "seconds": seconds, "explorer_stage_s": fx["seconds"],
           "peak_mem_gb": peak, "launches": counts, "k1_expected_fx2fx": k1_fx2fx,
           "embeddings": {n: list(e.shape) for n, e in embs.items()},
           "embeddings_finite": all(bool(np.isfinite(e).all()) for e in embs.values()),
           "umap_maps": {n: list(m.shape) for n, m in maps.items()},
           "umap_finite": all(bool(np.isfinite(m).all()) for m in maps.values()),
           "fx2fx_wav": list(wav.shape), "fx2fx_finite": bool(np.isfinite(wav).all()),
           "spectrogram_db_shape": list(db.shape),
           "spectrogram_db_max_abs_diff_vs_twin": float(np.abs(db - db_twin).max()),
           "pca_batch": [PCA_BATCH, 2, CHUNK], "pca_batches": pca["batches"],
           "pca_count": pca["count"], "pca_corpus_s": pca_files_s,
           "pca_cov_rel_vs_f64_two_pass": cov_rel,
           "pca_top_eigenvalues": [float(v) for v in pca["eigvals"][:4]],
           "toy_improvement": toy["improvement"], "toy_kmw_err": toy["kmw_err"],
           "toy_raw_err": toy["raw_err"], "toy_z_err": toy["z_err"], "card": card()}
    emit(row)
    faults = []
    if {n: list(e.shape) for n, e in embs.items()} != want_embs or not row["embeddings_finite"]:
        faults.append("embeddings")
    if any(list(maps[n].shape) != [APPS_CLIPS * k, 2] for n, k in knobs.items()) \
            or not row["umap_finite"]:
        faults.append("umap maps")
    if row["fx2fx_wav"] != [2, CHUNK] or not row["fx2fx_finite"]:
        faults.append("fx2fx wav")
    explorer = counts["effects_explorer"]
    if explorer["r1"] < 1 or explorer["r3"] < 1 or explorer["k1"] != k1_fx2fx:
        faults.append(f"effects_explorer launches {explorer}")
    if counts["spectrogram_db"]["k6"] != 1 or list(db.shape) != [513, CHUNK // 256 + 1] \
            or row["spectrogram_db_max_abs_diff_vs_twin"] > SPEC_DB_TOL:
        faults.append("spectrogram_db")
    if pca["batches"] != PCA_BATCHES or not cov_rel < PCA_COV_REL:
        faults.append(f"calc_effects_pca: {pca['batches']} batches, cov rel {cov_rel}")
    if not (toy["improvement"] > 1 and math.isfinite(toy["kmw_err"])):
        faults.append(f"aa_toy: {toy}")
    if faults:
        raise AssertionError(f"apps: {faults}")
    return {"k1": explorer["k1"], "k6": counts["spectrogram_db"]["k6"] + explorer["k6"],
            "r1": explorer["r1"], "r3": explorer["r3"]}


def phase_ddp() -> dict:
    """Data parallelism over a process group of one: an nccl group on a
    free local port; one mixer step at (2, AA_BATCH, 2, CHUNK) stems (f32,
    TF32 off) three ways from the same weights, data and Adam: the trainer's
    single-process step (encode, mixer_loss, backward, OneCycleAdam), the
    annotated step of parallel.train (all_gather and gradient all_reduce
    through nccl) and parallel.manual's; every parameter after the step
    equal to f32 rounding (DDP_REL of its largest entry); then
    train_aa_mixer_accel.main on AA_FILES generated WAVs (batch AA_BATCH,
    2 epochs: 4 steps, the one-cycle schedule needs 4 updates) and the same
    flags resumed from its checkpoint for 4 more; the group destroyed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from audio_algebra_torch import train_aa_mixer_accel
    from audio_algebra_torch.aa_mixer import (AABundle, OneCycleAdam, as_tensors,
                                              encode_mixer_inputs, given_model_encode_fn,
                                              make_mixer_loss_fn, mixer_loss)
    from audio_algebra_torch.given_models import DVAEWrapper
    from audio_algebra_torch.parallel.manual import make_manual_ddp_step
    from audio_algebra_torch.parallel.mesh import make_mesh
    from audio_algebra_torch.parallel.train import make_data_parallel_step

    home = os.getcwd()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        world = make_mesh(device="cuda")
        wrapper = DVAEWrapper(args_dict={"latent_dim": AA_DIMS, "sample_size": CHUNK},
                              device="cuda")
        encode_fn = given_model_encode_fn(wrapper)
        rng = np.random.default_rng(50)
        stems = (0.3 * rng.standard_normal((2, AA_BATCH, 2, CHUNK))).astype(np.float32)
        faders = np.asarray(AA_FADERS, np.float32)
        batch = (0.3 * rng.standard_normal((AA_BATCH, 2, CHUNK))).astype(np.float32)
        stems_b = np.ascontiguousarray(np.swapaxes(stems, 0, 1))

        def fresh():
            aa = AABundle(dims=AA_DIMS, hidden_dims=AA_DIMS, seed=0, device="cuda")
            return aa.module, OneCycleAdam(aa.module, 8, 1e-3)

        def single(module, opt):
            y_all, y_batch = encode_mixer_inputs(encode_fn, *as_tensors("cuda", stems, faders,
                                                                        batch))
            loss, logs = mixer_loss(module, y_all, y_batch, stems.shape[0])
            loss.backward()
            opt.step()
            return logs

        def parallel(make):
            def run(module, opt):
                loss_fn = make_mixer_loss_fn(module, encode_fn)
                step = make(lambda sb, f, b, **kw: loss_fn(sb.transpose(0, 1), f, b, **kw),
                            opt, world)
                return step(stems_b, torch.from_numpy(faders), batch)
            return run

        arms, step_s, losses = {}, {}, {}
        _zero_all_counts()
        for name, fn in (("single", single), ("annotated", parallel(make_data_parallel_step)),
                         ("manual", parallel(make_manual_ddp_step))):
            module, opt = fresh()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = fn(module, opt)
            torch.cuda.synchronize()
            step_s[name] = time.perf_counter() - t0
            losses[name] = float(logs["train_loss"])
            arms[name] = {k: v.detach().clone() for k, v in module.state_dict().items()}
            del module, opt
        kernel_launches = _all_counts()
        diffs = {name: max(float((arms[name][k] - v).abs().max() / v.abs().max())
                           for k, v in arms["single"].items())
                 for name in ("annotated", "manual")}
        bit_equal = {name: all(torch.equal(arms[name][k], v) for k, v in arms["single"].items())
                     for name in ("annotated", "manual")}
        moved = max(float((arms["single"][k] - v).abs().max())
                    for k, v in fresh()[0].state_dict().items())
        del arms, stems, stems_b, batch
        torch.cuda.empty_cache()

        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            corpus_s = _write_corpus(tmp / "wavs", AA_FILES, 51)
            argv = ["--training_dir", str(tmp / "wavs"), "--batch_size", str(AA_BATCH),
                    "--sample_size", str(CHUNK), "--latent_dim", str(AA_DIMS),
                    "--hidden_dims", str(AA_DIMS), "--num_workers", "8", "--num_gpus", "1",
                    "--checkpoint_every", "0", "--seed", "0", "--load_frac", "1.0",
                    "--max_epochs", "2", "--device", "cuda"]
            os.chdir(tmp)
            try:
                t0 = time.perf_counter()
                accel = train_aa_mixer_accel.main([*argv, "--name", "accel"])
                accel_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                resumed = train_aa_mixer_accel.main([*argv, "--name", "resumed", "--ckpt_path",
                                                     f"{accel['run_dir']}/ckpt"])
                resumed_s = time.perf_counter() - t0
            finally:
                os.chdir(home)
    finally:
        dist.destroy_process_group()
    steps = 2 * AA_FILES // AA_BATCH
    row = {"phase": "ddp", "backend": "nccl", "world": [world.size, world.rank],
           "batch": [AA_BATCH, 2, CHUNK], "dtype": "float32", "allow_tf32": False,
           "step_s": step_s, "train_loss": losses, "rel_diff_vs_single": diffs,
           "bit_equal_to_single": bit_equal, "single_step_moved_max_abs": moved,
           "kernel_launches": kernel_launches, "corpus_s": corpus_s,
           "accel": {"seconds": accel_s, "steps": [accel["start_step"], accel["end_step"]],
                     "losses": [r["train_loss"] for r in accel["records"]]},
           "resumed": {"seconds": resumed_s, "steps": [resumed["start_step"],
                                                       resumed["end_step"]],
                       "losses": [r["train_loss"] for r in resumed["records"]],
                       "reproduces_saved_state":
                           resumed["start_digest"] == accel["end_digest"]},
           "card": card()}
    emit(row)
    faults = [f"{name}: {d}" for name, d in diffs.items() if not d <= DDP_REL]
    if not moved > 0:
        faults.append("the step moved no parameter")
    if any(kernel_launches.values()):
        faults.append(f"kernel launches in the mixer step: {kernel_launches}")
    if (accel["start_step"], accel["end_step"], resumed["start_step"], resumed["end_step"]) \
            != (0, steps, steps, 2 * steps) or not row["resumed"]["reproduces_saved_state"]:
        faults.append("train_aa_mixer_accel steps or resume")
    if not all(math.isfinite(x) for x in row["accel"]["losses"] + row["resumed"]["losses"]):
        faults.append("train_aa_mixer_accel losses")
    if not accel["ckpt"] or accel["end_digest"]["params"] == accel["start_digest"]["params"]:
        faults.append("train_aa_mixer_accel did not train or write its checkpoint")
    if faults:
        raise AssertionError(f"ddp: {faults}")
    return row


# K1 split around a reduce across ranks: the sequence-parallel decodes'
# GroupNorm, K1's two passes with a sum of the partials between; held here by
# cutting one tensor along T into S slabs in one process
SPLIT_SHAPE, SPLIT_SLABS = (4, 256, 65536), (2, 4, 8)
SEQPAR_REL_RMS = {"destructo": MODEL_REL_RMS_BOUND["bfloat16"],
                  "mirage": MIRAGE_REL_RMS_BOUND["bfloat16"]}
# FSDP at world 1: two trainer steps an arm; the sharded state within
# FSDP_SPREAD times the replicated step's own run-to-run difference
FSDP_STEPS, FSDP_SPREAD = 2, 4


def phase_kernels_split() -> dict:
    """K1 split at SPLIT_SHAPE in bf16 and f32, with and without a
    residual (GELU on, as the decodes run it): the tensor cut along T into S
    contiguous slabs, aa_groupnorm1_stats on each, the partials summed,
    aa_groupnorm1_apply on each with n_stats the whole row's count; the
    slabs' outputs joined against K1 on the whole tensor and against the
    twin, no element outside TOL. Timed: S stats + the sum + S applies
    against K1 whole, the twin (the same function on the same tensor), the
    library chain, and K1's byte bound (the same bytes move)."""
    import torch
    import torch.nn.functional as F
    from audio_algebra_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for res in (True, False):
            g = torch.Generator(device=dev).manual_seed(100 + len(rows))
            x = (torch.randn(SPLIT_SHAPE, generator=g, device=dev) * 1.5 + 0.2).to(dt)
            r = torch.randn(SPLIT_SHAPE, generator=g, device=dev).to(dt) if res else None
            scale = (torch.rand(SPLIT_SHAPE[1], generator=g, device=dev) + 0.5).to(dt)
            bias = (torch.rand(SPLIT_SHAPE[1], generator=g, device=dev) - 0.5).to(dt)
            whole = gn.groupnorm1_gelu(x, scale, bias, True, r)
            twin = gn.groupnorm1_gelu_ref(x, scale, bias, True, r)
            name = str(dt).removeprefix("torch.")
            atol, rtol = TOL[name]
            n_row = SPLIT_SHAPE[1] * SPLIT_SHAPE[2]
            for slabs in SPLIT_SLABS:
                xs = [c.contiguous() for c in x.chunk(slabs, dim=-1)]
                rs = [c.contiguous() for c in r.chunk(slabs, dim=-1)] if res else [None] * slabs

                def split():
                    total = torch.stack([gn.split_stats(xi) for xi in xs]).sum(0)
                    return [gn.split_apply(xi, scale, bias, True, ri, total, n_row)
                            for xi, ri in zip(xs, rs)]

                got = torch.cat(split(), dim=-1)
                torch.cuda.synchronize()
                err_whole = (got.float() - whole.float()).abs()
                err_twin = (got.float() - twin.float()).abs()
                bad = int((err_whole > atol + rtol * whole.float().abs()).sum()
                          + (err_twin > atol + rtol * twin.float().abs()).sum())

                def library():
                    y = F.gelu(F.group_norm(x, 1, scale, bias, 1e-6), approximate="tanh")
                    return y + r if res else y

                bound_ms, bound_by = gn_bound(SPLIT_SHAPE, dt, True, res)
                rows.append({
                    "shape": list(SPLIT_SHAPE), "dtype": name, "gelu": True, "residual": res,
                    "slabs": slabs, "max_abs_err": float(err_twin.max()),
                    "max_abs_err_vs_k1": float(err_whole.max()), "atol": atol, "rtol": rtol,
                    "n_outside_tol": bad, "kernel_ms": cuda_ms(split, 20),
                    "k1_whole_ms": cuda_ms(lambda: gn.groupnorm1_gelu(x, scale, bias, True, r),
                                           20),
                    "plain_ms": cuda_ms(lambda: gn.groupnorm1_gelu_ref(x, scale, bias, True, r),
                                        20),
                    "library_ms": cuda_ms(library, 20),
                    "bound_ms": bound_ms, "bound_by": bound_by})
                del got, err_whole, err_twin
            del x, r, whole, twin
    emit({"phase": "kernels", "kernel": "groupnorm1_gelu_split", "cases": rows,
          "card": card()})
    failed = [r for r in rows if r["n_outside_tol"]]
    if failed:
        raise AssertionError(f"K1 split disagrees with K1 whole or its twin: {failed}")
    return {"row": next(r for r in rows if r["dtype"] == "bfloat16" and r["residual"]
                        and r["slabs"] == 4), "cases": rows}


def _group_of_one():
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)


def _seqpar_op_ms(world) -> dict:
    """ms a call (CUDA events over 50 calls, so the host's share shows) of
    the sequence-parallel route's ops beside their unsharded twins at the
    MIRAGE outer UNet's level 0, (1, 512, 32768) bf16, on `world`: the
    split GroupNorm with its all_reduce against K1 whole, the halo conv5
    against the SAME conv, the partials' all_reduce alone."""
    import torch
    from audio_algebra_torch.models.blocks import conv1d
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.parallel.seq import conv1d_seq, groupnorm1_seq

    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((1, 512, 32768), generator=g, device="cuda").bfloat16()
    r = torch.randn((1, 512, 32768), generator=g, device="cuda").bfloat16()
    scale = torch.ones(512, device="cuda").bfloat16()
    bias = torch.zeros(512, device="cuda").bfloat16()
    w = (torch.randn((512, 512, 5), generator=g, device="cuda") * 0.02).bfloat16()
    partials = gn.split_stats(x)
    with torch.inference_mode():
        out = {"gn_split": cuda_ms(lambda: groupnorm1_seq(x, scale, bias, world, True, r), 50),
               "gn_whole": cuda_ms(lambda: gn.groupnorm1_gelu(x, scale, bias, True, r), 50),
               "conv5_halo": cuda_ms(lambda: conv1d_seq(x, w, None, world), 50),
               "conv5_same": cuda_ms(lambda: conv1d(x, w, None), 50),
               "all_reduce_partials": cuda_ms(lambda: world.all_reduce_sum_([partials]), 50)}
    del x, r, w
    return out


def phase_seqpar(model=None, destructo=None, mirage_ref=None) -> dict:
    """The sequence-parallel decodes over an nccl group of one (one card,
    one rank: NCCL takes one rank a card), through the entry points a user
    calls, against the unsharded routes on the same inputs: the destructo
    phase's DVAEWrapper() (bf16, B = 4 x 65536) decode_seqpar of its
    latents from its stored noise, 35 steps, against its decode (rel-RMS <
    SEQPAR_REL_RMS); the mirage phase's CLAPDAE() (22 s, bf16, batch 1, 150
    + 100 steps) generate_seqpar from the noises of its steady run, against
    that run. The seconds of each route, the split-K1 and K1-whole launches
    a forward (they sum to the unsharded forward's K1), and
    pick_sharded_levels' choice. Without the earlier phases' state (--only),
    it runs them first."""
    import torch
    import torch.distributed as dist
    from audio_algebra_torch.ops import groupnorm as gn
    from audio_algebra_torch.parallel.infer import pick_sharded_levels
    from audio_algebra_torch.parallel.mesh import make_mesh

    if destructo is None:
        destructo = phase_destructo()
    if model is None or mirage_ref is None:
        model, _, mirage_ref = phase_mirage()
    _group_of_one()
    try:
        world = make_mesh(axis_names=("seq",), shape=(1,), device="cuda")
        w = destructo["wrapper"]
        unet = w.model.diffusion
        levels = {"destructo": pick_sharded_levels(CHUNK, world.size, unet.depth,
                                                   unet.attn_start)}
        gn.launches = gn.split_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = w.decode_seqpar(destructo["z"], world, demo_steps=STEPS)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dvae_counts = {"k1_split": gn.split_launches, "k1_whole": gn.launches}
        dvae_rel = rel_rms(out, destructo["out"])

        outer = model.latent_diffae.diffusion
        levels["mirage_outer"] = pick_sharded_levels(
            MIRAGE_SAMPLES // model.latent_diffae.autoencoder.downsampling_ratio, world.size,
            outer.depth, outer.attn_start)
        gn.launches = gn.split_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fakes, lat = model.generate_seqpar(mirage_ref["emb"], world, cfg_scales=4,
                                           demo_steps=INNER_STEPS, outer_steps=OUTER_STEPS,
                                           batch_size=1, stage_times=True,
                                           **mirage_ref["noises"])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        stages = dict(model.last_stage_times)
        mirage_counts = {"k1_split": gn.split_launches, "k1_whole": gn.launches}
        mirage_rel = rel_rms(fakes, mirage_ref["fakes"])
        finite = bool(torch.isfinite(out).all() and torch.isfinite(fakes).all())
        ops_ms = _seqpar_op_ms(world)
    finally:
        dist.destroy_process_group()
    row = {"phase": "seqpar", "backend": "nccl", "world": [world.size, world.rank],
           "axis": world.axis, "sharded_levels": levels,
           "destructo": {"batch": [4, 2, CHUNK], "dtype": "bfloat16", "steps": STEPS,
                         "seqpar_decode_s": dec_s, "decode_s": destructo["decode_s"],
                         "rel_rms_vs_decode": dvae_rel,
                         "bound": SEQPAR_REL_RMS["destructo"],
                         "launches": dvae_counts,
                         "per_forward": {k: v / STEPS for k, v in dvae_counts.items()}},
           "mirage": {"samples": MIRAGE_SAMPLES, "dtype": "bfloat16", "batch": 1,
                      "steps": [INNER_STEPS, OUTER_STEPS],
                      "generate_seqpar_s": gen_s, "generate_s": mirage_ref["generate_s"],
                      "stages_s": stages, "rel_rms_vs_generate": mirage_rel,
                      "bound": SEQPAR_REL_RMS["mirage"], "launches": mirage_counts,
                      "per_outer_forward": {k: v / OUTER_STEPS
                                            for k, v in mirage_counts.items()}},
           "op_ms_outer_level0": ops_ms, "finite": finite, "card": card()}
    emit(row)
    faults = []
    if not dvae_rel < SEQPAR_REL_RMS["destructo"] or not mirage_rel < SEQPAR_REL_RMS["mirage"]:
        faults.append(f"rel-RMS destructo {dvae_rel}, mirage {mirage_rel}")
    if sum(dvae_counts.values()) != STEPS * GN_CALLS_PER_FORWARD or not dvae_counts["k1_split"]:
        faults.append(f"destructo launches {dvae_counts}")
    if sum(mirage_counts.values()) != OUTER_STEPS * K1_PER_OUTER \
            or not mirage_counts["k1_split"]:
        faults.append(f"mirage launches {mirage_counts}")
    if not finite or tuple(out.shape) != (2, 4 * CHUNK) \
            or tuple(fakes.shape) != (2, MIRAGE_SAMPLES):
        faults.append("outputs")
    if faults:
        raise AssertionError(f"seqpar: {faults}")
    return {"k1_split": dvae_counts["k1_split"] + mirage_counts["k1_split"],
            "k1_whole": dvae_counts["k1_whole"] + mirage_counts["k1_whole"],
            "by_path": {"destructo": dvae_counts["k1_split"],
                        "mirage": mirage_counts["k1_split"]}}


def phase_fsdp() -> dict:
    """FSDP over an nccl group of one: the songs UNetCFG1d trainer step
    (train_clapdae.make_train_step with its Adam, f32, TF32 off) on
    (TRAIN_BATCH, 32, 2048) latents (batch 8 x 1,048,576 samples) with
    seeded embeddings, t, noise and keep mask, FSDP_STEPS steps from the
    same seeded weights three times: replicated, sharded by
    parallel.fsdp.shard_state, and replicated again. The trainer's backward
    does not repeat its bits run to run (two replicated runs' Adam moments
    differed by 7e-6-8e-6 of their largest entries on the card), so the
    replicated pair's difference is the floor: every part of the sharded
    state (parameters, EMA, Adam's m and v) lies within FSDP_SPREAD times
    the pair's difference of it, and at least DDP_REL, of the replicated
    state (max abs difference over the largest entry). State bytes a rank
    (state_bytes_per_device against the shards held), the last step's ms
    and the peak memory of each arm."""
    import gc

    import torch
    import torch.distributed as dist
    from audio_algebra_torch.models.stacked import StackedAELatentDiffusionCond
    from audio_algebra_torch.parallel.fsdp import shard_state, state_bytes_per_device
    from audio_algebra_torch.parallel.mesh import make_mesh
    from audio_algebra_torch.train_clapdae import make_state, make_train_step, train_state_leaves
    from audio_algebra_torch.utils.params import random_init_

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(60)
    shape = (TRAIN_BATCH, 32, MIRAGE_SAMPLES // 512)
    emb = torch.randn((TRAIN_BATCH, 1, 512), generator=g, device=dev)
    batches = [(torch.tanh(torch.randn(shape, generator=g, device=dev)),
                emb / emb.norm(dim=-1, keepdim=True),
                torch.rand(TRAIN_BATCH, generator=g, device=dev),
                torch.randn(shape, generator=g, device=dev),
                torch.rand((TRAIN_BATCH, 1, 1), generator=g, device=dev) >= 0.1)
               for _ in range(FSDP_STEPS)]
    weights = random_init_(StackedAELatentDiffusionCond(), 5).state_dict()
    parts = ("params", "ema", "m", "v")

    _group_of_one()
    arms = {}
    try:
        world = make_mesh(device="cuda")
        for arm in ("replicated", "sharded", "replicated_again"):
            gc.collect()                   # the last arm's cycles hold device tensors
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start_mem = torch.cuda.memory_allocated()
            model = StackedAELatentDiffusionCond()
            model.load_state_dict(weights)
            state = make_state(model.to(dev).requires_grad_(True))
            if arm == "sharded":
                shard_state(state, world)
            step = make_train_step(state, world)
            times, losses = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(*batch)))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            leaves = train_state_leaves(state)
            held = sum((t.to_local() if hasattr(t, "to_local") else t).numel()
                       * t.element_size() for t in leaves.values())
            tree = state.tree()
            opt_state = tree["opt_state"]["state"]
            arms[arm] = {
                "params": {k: v.cpu() for k, v in tree["params"].items()},
                "ema": {k: v.cpu() for k, v in tree["ema_params"].items()},
                "m": {i: e["exp_avg"].cpu() for i, e in opt_state.items()},
                "v": {i: e["exp_avg_sq"].cpu() for i, e in opt_state.items()},
                "step_ms": times[-1] * 1e3, "first_step_ms": times[0] * 1e3,
                "losses": losses,
                "state_bytes_per_device": state_bytes_per_device(leaves, world),
                "state_bytes_held": held, "mem_at_start_gb": start_mem / 1e9,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_mem_above_start_gb": (torch.cuda.max_memory_allocated() - start_mem) / 1e9}
            del model, state, step, leaves, tree, opt_state
    finally:
        dist.destroy_process_group()

    def rel(arm, part):
        a, b = arms[arm][part], arms["replicated"][part]
        return max(float((a[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                   for k, v in b.items())

    diffs = {part: rel("sharded", part) for part in parts}
    floor = {part: rel("replicated_again", part) for part in parts}
    bounds = {part: max(DDP_REL, FSDP_SPREAD * floor[part]) for part in parts}
    row = {"phase": "fsdp", "backend": "nccl", "world": [world.size, world.rank],
           "batch": list(shape), "dtype": "float32", "allow_tf32": False, "steps": FSDP_STEPS,
           "n_params": sum(v.numel() for v in arms["replicated"]["params"].values()),
           "rel_diff_sharded_vs_replicated": diffs,
           "rel_diff_replicated_run_to_run": floor, "bounds": bounds,
           "arms": {arm: {k: a[k] for k in (
               "step_ms", "first_step_ms", "losses", "state_bytes_per_device",
               "state_bytes_held", "mem_at_start_gb", "peak_mem_gb",
               "peak_mem_above_start_gb")} for arm, a in arms.items()},
           "card": card()}
    emit(row)
    faults = [f"{part}: {diffs[part]} > {bounds[part]}" for part in parts
              if not diffs[part] <= bounds[part]]
    for arm, a in arms.items():
        if a["state_bytes_per_device"] != a["state_bytes_held"]:
            faults.append(f"{arm}: state_bytes_per_device is not the bytes held")
        if not all(math.isfinite(x) for x in a["losses"]):
            faults.append(f"{arm}: losses")
    if faults:
        raise AssertionError(f"fsdp: {faults}")
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "audio_algebra_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: audio_algebra_torch/ is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": False, "cudnn": False}})
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        for name in only:
            if name in ("clap", "serve", "mirage_cli"):
                raise SystemExit(f"--only: phase {name} needs the served model")
            if name in ("seqpar", "mirage_turbo"):   # run the phases they build on first
                globals()[f"phase_{name}"]()
                continue
            if name == "io":
                phase_io(tmp)
            elif name == "xae":
                _ensure_native_codec()
                phase_xae(tmp, _ogg_available(tmp)[0])
            else:
                globals()[f"phase_{name}"](*([None] if name == "train" else []))
        tmp_dir.cleanup()
        emit({"partial": True, "phases": only})
        return 0
    seconds = {}

    def run(phase, *args):
        """Run a phase and keep its seconds of wall time."""
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        return out

    run(phase_build)
    k1 = run(phase_kernels)
    k1_split = run(phase_kernels_split)
    k3 = run(phase_kernels_k3)
    k5 = run(phase_kernels_k5)
    run(phase_model)
    destructo = run(phase_destructo)
    k2 = run(phase_kernels_k2)
    turbo = run(phase_destructo_turbo)
    run(phase_mirage_model)
    model, counts, mirage_ref = run(phase_mirage)
    turbo_paths = run(phase_mirage_turbo, model, mirage_ref)
    k6, k6_short = run(phase_kernels_k6)
    spectrogram_k6, spectrogram_k6_routes = run(phase_spectrogram)
    clap_k6 = run(phase_clap, model)
    io_files = run(phase_io, tmp)
    serve_k6 = run(phase_serve, model, io_files)
    cli = run(phase_mirage_cli, model, io_files["flac"], tmp)
    seqpar = run(phase_seqpar, model, destructo, mirage_ref)
    clap_module = model.clap_module
    destructo_k1 = destructo["k1"]
    del model, destructo, mirage_ref
    torch.cuda.empty_cache()
    k4 = run(phase_kernels_k4)
    unet = run(phase_train_model)
    train_bf16 = run(phase_train_bf16, unet)
    del unet
    torch.cuda.empty_cache()
    train = run(phase_train, clap_module)
    del clap_module
    torch.cuda.empty_cache()
    run(phase_train_aa_model)
    train_aa = run(phase_train_aa)
    ckpt = run(phase_checkpoints)
    rec = run(phase_recurrence)
    fx_counts = run(phase_effects)
    xae = run(phase_xae, tmp, io_files["ogg"])
    apps = run(phase_apps)
    run(phase_ddp)
    run(phase_fsdp)
    tmp_dir.cleanup()

    def turbo_launches(k):
        return {"destructo_turbo": turbo[k], **{p: c[k] for p, c in turbo_paths.items()}}

    def entry(name, source, replaces, launches, row, **extra):
        """One kernel of the summary line; `row` from a kernels phase."""
        return {"name": name, "route": "cuda", "source": f"audio_algebra_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"], **extra}

    def rec_entry(name, replaces, key, rows, **extra):
        """A recurrence kernel of the summary line: its first row is its
        xae-path shape; `launches` the xae run's, beside the effects
        phase's sweep of every effect."""
        row = rows[0]
        return {"name": name, "route": "cuda", "source": "audio_algebra_torch/csrc/recurrence.cu",
                "replaces": replaces, "launches": xae[key], "max_abs_err": row["max_abs_err"],
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "launches_by_path": {"xae": xae[key], "effects": fx_counts[key],
                                     **({"apps": apps[key]} if key in apps else {})},
                "device_ms": row["kernel_device_ms"], "plain_shape": row["plain_shape"],
                "bound_kind": row["bound_kind"], "serial_chain_ms": row["serial_chain_ms"],
                "cases": [{k: r.get(k) for k in ("case", "shape", "sections", "chunk_len",
                                                  "chunks", "cuda_launches_a_call", "kernel_ms",
                                                  "kernel_device_ms", "bound_ms", "bound_share",
                                                  "serial_chain_ms", "max_abs_err",
                                                  "rel_rms_vs_f64", "twin_rel_rms_vs_f64",
                                                  "plain_ms", "rounds", "repaired",
                                                  "max_err_over_peak_vs_f64")}
                          for r in rows], **extra}

    emit({"kernels": [
        entry("groupnorm1_gelu", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:721", counts["k1"], k1,
              launches_by_path={"destructo": destructo_k1,
                                "destructo_turbo": turbo["k1"],
                                "mirage": counts["k1"], "train_aa": train_aa,
                                "mirage_turbo": turbo_paths["mirage_turbo"]["k1"],
                                "stacked_turbo": turbo_paths["stacked_turbo"]["k1"],
                                "mirage_turbo_carry": turbo_paths["mirage_turbo_carry"]["k1"],
                                "checkpoints": ckpt["k1"], "mirage_cli": cli["k1"],
                                "apps": apps["k1"], "seqpar": seqpar["k1_whole"]}),
        entry("groupnorm1_gelu_split", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:953", seqpar["k1_split"],
              k1_split["row"],
              replaces_also="audio_algebra_tpu/ops/pallas/groupnorm.py:1003, :1061 (K1's "
                            "apply); the psum of audio_algebra_tpu/parallel/infer.py:_gn1 and "
                            "parallel/seq.py:groupnorm1_seq between them",
              launches_by_path=seqpar["by_path"], k1_whole_ms=k1_split["row"]["k1_whole_ms"],
              cases=[{k: r[k] for k in ("dtype", "residual", "slabs", "max_abs_err",
                                        "max_abs_err_vs_k1", "kernel_ms", "k1_whole_ms",
                                        "plain_ms", "library_ms", "bound_ms")}
                     for r in k1_split["cases"]]),
        entry("groupnorm1_gelu_quant", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:107", turbo["k2a"], k2["quant"],
              launches_by_path=turbo_launches("k2a")),
        entry("groupnorm1_gelu_res_amax", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:298", turbo["k2b"], k2["res_amax"],
              launches_by_path=turbo_launches("k2b")),
        entry("groupnorm1_gelu_res_amax_q", "groupnorm.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm.py:321", turbo["k2c"],
              k2["res_amax_q"],
              launches_by_path=turbo_launches("k2c")),
        entry("flash_attention_relpos", "flash_attention.cu",
              "audio_algebra_tpu/ops/pallas/flash_attention.py:70", counts["k3"], k3,
              launches_by_path={"mirage": counts["k3"], "checkpoints": ckpt["k3"],
                                "mirage_cli": cli["k3"]},
              device_ms=k3["kernel_device_ms"]),
        *(entry(name, source, f"audio_algebra_tpu/ops/pallas/flash_attention.py:{line}",
                train[kern], k4[kern],
                bound_f32_cuda_cores_ms=k4[kern]["bound_f32_cuda_cores_ms"],
                launches_by_path={"train": train[kern], "train_bf16": train_bf16[kern]},
                bf16_route={key: k4[f"{kern}_bf16"][key] for key in (
                    "shape", "bias_dtype", "max_abs_err", "kernel_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "bound_share")},
                **({} if kern == "k4a" else {"plain_and_library_cover": "K4b + K4c"}))
          for name, source, line, kern in (
              ("flash_attention_relpos_train_fwd", "flash_attention.cu", 294, "k4a"),
              ("flash_attention_relpos_train_dkv", "flash_attention_dkv.cu", 170, "k4b"),
              ("flash_attention_relpos_train_dq", "flash_attention_dq.cu", 211, "k4c"))),
        entry("grouped_gn_film_silu", "grouped_gn.cu",
              "audio_algebra_tpu/ops/pallas/groupnorm_grouped.py:142", counts["k5"], k5,
              launches_by_path={"mirage": counts["k5"], "train": train["k5"],
                                "train_bf16": train_bf16["k5"],
                                "checkpoints": ckpt["k5"], "mirage_cli": cli["k5"]},
              launches_by_route={"cluster": counts["k5"] + train["k5_cluster"]
                                 + train_bf16["k5_cluster"],
                                 "two_pass": train["k5_two_pass"] + train_bf16["k5_two_pass"]},
              device_ms=k5["kernel_device_ms"], host_us=k5["host_us"],
              planner_route=k5["route"]),
        entry("stft", "stft.cu", "audio_algebra_tpu/ops/pallas/stft_kernel.py:35",
              spectrogram_k6 + clap_k6 + serve_k6 + train["k6"] + ckpt["k6"] + cli["k6"]
              + fx_counts["k6"] + xae["k6"] + apps["k6"], k6["fft"],
              launches_by_path={"spectrogram": spectrogram_k6, "clap": clap_k6,
                                "serve": serve_k6, "train": train["k6"],
                                "checkpoints": ckpt["k6"], "mirage_cli": cli["k6"],
                                "effects": fx_counts["k6"], "xae": xae["k6"],
                                "apps": apps["k6"]},
              dft_operations_ms=k6["fft"]["dft_operations_ms"],
              cases={case: {key: row[key] for key in (
                  "route", "radices", "shape", "n_fft", "hop", "center", "max_abs_err", "kernel_ms",
                  "plain_ms", "library_ms", "kernel_device_ms", "library_device_ms",
                  "bound_ms", "bound_by", "dft_operations_ms", "kernel_max_abs_err_vs_f64",
                  "plain_max_abs_err_vs_f64")}
                  for case, row in k6.items()},
              route_rule="fft: every even n_fft from 16 to 8192 whose half has no "
                         "prime factor above 13 (mixed radices 2-13); otherwise the "
                         "L-point DFT (L = n_fft / 2, or n_fft when odd) as an M-point "
                         "power-of-two FFT (M = L, or M >= 2 L - 1 by chirp-z): chirp "
                         "for M <= 4096 in one block, cluster for M <= 65536 on M / "
                         "4096 CTAs; dft: n_fft below 16 and larger frames",
              launches_by_route={"spectrogram_runs": spectrogram_k6_routes},
              short_clips={"rows": len(k6_short),
                           "shapes": sorted({(r["n_fft"], r["hop"]) for r in k6_short}),
                           "t_lens": sorted({r["t_len"] for r in k6_short}),
                           "max_abs_err": max(r["max_abs_err"] for r in k6_short),
                           "max_abs_err_vs_f64": max(r["max_abs_err_vs_f64"]
                                                     for r in k6_short)}),
        rec_entry("sosfilt", "audio_algebra_tpu/ops/filters.py:189", "r1", rec["sosfilt"],
                  replaces_also="audio_algebra_tpu/ops/filters.py:219 (sosfilt), :170 "
                                "(_biquad_scan)"),
        rec_entry("envelope", "audio_algebra_tpu/ops/effects.py:97", "r2", rec["envelope"]),
        rec_entry("freeverb_ir", "audio_algebra_tpu/ops/effects.py:178", "r3",
                  rec["freeverb_ir"])]})
    import resource
    emit({"phase_seconds": seconds,
          "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
          "io_fx_cli_phases_s": sum(seconds[k] for k in IO_FX_CLI_PHASES),
          "apps_ddp_phases_s": seconds["apps"] + seconds["ddp"],
          "split_seqpar_fsdp_phases_s": seconds["kernels_split"] + seconds["seqpar"]
          + seconds["fsdp"]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
