"""INI + CLI configuration layer (prefigure-equivalent).

The port's copy of audio_algebra_tpu/config.py (which imports no JAX; the
port keeps its own): a `[DEFAULTS]` INI section whose keys the command
line overrides with ``--key value``.

  * `get_all_args(defaults_file='defaults.ini')` parses the INI, then applies
    `--config-file` to switch INI files and `--key value` CLI overrides.
  * values are literal-eval'd so `batch_size = 1024` comes back as int and
    `start_method = 'spawn'` as str, matching prefigure semantics.

The default key schema mirrors the repository's defaults.ini; `device`
("cuda" unless `--device cpu`) is the port's one addition.
"""
from __future__ import annotations

import argparse
import ast
import configparser
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace


def _literal(v: str):
    """Parse an INI/CLI string into a Python literal when possible."""
    s = v.strip()
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


class ConfigNamespace(SimpleNamespace):
    """Attribute-style config holding literal-typed values."""

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def update(self, other: dict) -> None:
        for k, v in other.items():
            setattr(self, k, v)


def read_defaults_ini(path: str) -> dict:
    """Read the [DEFAULTS] section of an INI file into a literal-typed dict.

    Relative paths not found in the cwd fall back to the repo root (where
    the shipped defaults.ini / bdct-chunk-pca.ini live, reference parity).
    """
    cp = configparser.ConfigParser()
    read = cp.read(path)
    if not read and not os.path.isabs(path):
        fallback = Path(__file__).resolve().parents[1] / path
        read = cp.read(fallback)
    if not read:
        raise FileNotFoundError(f"config file not found: {path}")
    section = "DEFAULTS" if cp.has_section("DEFAULTS") else cp.default_section
    items = cp[section] if cp.has_section("DEFAULTS") else cp.defaults()
    return {k: _literal(v) for k, v in dict(items).items()}


def get_all_args(defaults_file: str = "defaults.ini", argv=None) -> ConfigNamespace:
    """prefigure-style config: INI `[DEFAULTS]` + `--key value` CLI overrides.

    `--config-file other.ini` (as the reference's bdct-chunk-pca.ini usage)
    switches which INI supplies the defaults before overrides are applied.
    """
    argv = list(sys.argv[1:] if argv is None else argv)

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config-file", type=str, default=defaults_file)
    pre_args, remaining = pre.parse_known_args(argv)

    conf = read_defaults_ini(pre_args.config_file)
    # rebuild-addition keys (max_epochs, max_lr, lr, ...) live in the
    # in-code DEFAULTS; register them too so `--max_epochs 1` works even
    # against an INI that predates them (unknown flags used to be silently
    # dropped by parse_known_args)
    extras = {k: v for k, v in DEFAULTS.items() if k not in conf}

    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", type=str, default=pre_args.config_file)
    for key in list(conf) + list(extras):
        parser.add_argument(f"--{key}", type=str, default=None)
    ns, unknown = parser.parse_known_args(argv)
    bad = [u for u in unknown if u.startswith("--")]
    if bad:
        print(f"get_all_args: ignoring unknown flags {bad}")
    for key, default in extras.items():
        conf[key] = default
    for key in conf:
        override = getattr(ns, key, None)
        if override is not None:
            conf[key] = _literal(override)
    return ConfigNamespace(**conf)


def load_model_config(path: str | None) -> tuple:
    """Read a model-config JSON -> (model_kwargs, args_dict).

    Accepts either the nested form {"model_kwargs": {...}, "args_dict":
    {...}} or a flat dict of model kwargs.
    """
    if not path:
        return None, {}
    with open(path) as f:
        cfg = json.load(f)
    if "model_kwargs" in cfg or "args_dict" in cfg:
        return cfg.get("model_kwargs"), cfg.get("args_dict", {})
    return cfg, {}


# the reference defaults.ini:1-84 schema, importable for programmatic use/tests
DEFAULTS = dict(
    name="aa-mixer",
    training_dir="~/datasets/BDCT-0-chunk-48000",
    load_frac=0.5,
    batch_size=1024,
    num_gpus=8,          # kept for INI compatibility; interpreted as device count
    num_nodes=1,
    num_workers=12,
    sample_size=65536,
    demo_every=50,
    num_demos=16,
    seed=42,
    accum_batches=1,
    sample_rate=48000,
    checkpoint_every=10000,
    ema_decay=0.995,
    latent_dim=64,
    num_quantizers=0,
    cache_training_data=False,
    pqmf_bands=1,
    random_crop=True,
    norm_inputs=False,
    jukebox_layer=0,
    ckpt_path="",
    dvae_ckpt_file="",
    model_config="",
    start_method="spawn",
    demo_steps=250,
    # rebuild additions (the reference hardcoded these in training code:
    # max_epochs=40 aa_mixer.py:371, max_lr=1e-3 :375, hidden 64 :384;
    # the CLAPDAE generator lr/T_max/cfg-dropout from
    # train_stacked_latent_clap_audio_all_wds.py)
    max_epochs=40,
    max_lr=1e-3,
    hidden_dims=64,
    steps_per_epoch=0,   # 0 = one pass over the DataLoader per epoch
    lr=4e-5,
    lr_t_max=500,
    cfg_dropout=0.1,
    fsdp=0,              # 1 = shard params/EMA/Adam state over the data
                         # axis (ZeRO-3): train_clapdae over more than one
                         # process (parallel/fsdp.py); one process keeps it whole
    device="cuda",       # the port's entry points run on the card unless asked
)
