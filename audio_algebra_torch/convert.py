"""Pouring the reference's torch checkpoints into the port's modules.

The port's copy of audio_algebra_tpu/convert.py, in numpy. A pour fills a
flax-layout template, `{"params": tree}` with `tree` a nested dict of
numpy arrays: the module's own view `utils/params.to_flax_params(module)`.
The port's modules keep the flax names, so this view holds the very paths
of the JAX package's params tree, and the pour pairs as JAX's does;
`utils/params.load_flax_params` then loads the result (`pour`).

Models and their converters:

  * LatentAudioDiffusionAutoencoder (StackedDiffAEWrapper, CLAPDAE's
    stage 1): `convert_stacked_state_dict`, the `*_ema` twins first;
  * StackedAELatentDiffusionCond (CLAPDAE's generator):
    `convert_ldm_state_dict`, preferring ema_pytorch's `ema_model`;
  * DiffusionAE1d (DMAE1d): `convert_dmae_state_dict`;
  * RAVE (.ckpt or TorchScript .ts): `convert_rave_state_dict` after
    `fuse_weight_norm`; `extract_rave_latent_transform` reads an export's
    latent PCA;
  * the CLAP towers: `convert_clap_state_dict`, an exact name map over the
    laion_clap / timm and the HF ClapModel dialects, with the tower sizes
    from `infer_clap_cfgs`.

Why shape signatures: the reference's models are recursive module nests
whose names do not map onto the flax level loops. Both sides are bucketed
by top-level module, ordered naturally (numeric-aware sort ~ definition
order) and paired greedily within a kind (weights, norm scales, conv
biases, norm biases) by shape after the torch -> flax transpose; a bias
follows the module its weight landed in. What pairs is poured, the rest
keeps the template's values (the reference's strict=False), and the hit
and miss counts are always printed. `convert_report()` lists the
same-shape groups that ordering alone decided.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .checkpoint import remap_ema_weights

# ------------------------------------------------------------ flax trees ---


def _leaves(tree, prefix=()) -> List[Tuple[tuple, np.ndarray]]:
    """(path, leaf) pairs of a nested dict in jax.tree_util's order (keys
    sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, (*prefix, str(k)))
        else:
            out.append(((*prefix, str(k)), v))
    return out


def _rebuild(tree, new: Dict[tuple, np.ndarray], prefix=()):
    """A copy of `tree` whose leaves at the paths of `new` are replaced."""
    return {k: _rebuild(v, new, (*prefix, str(k))) if isinstance(v, dict)
            else new.get((*prefix, str(k)), v) for k, v in tree.items()}


def _n_params(tree) -> int:
    return len(_leaves(tree))


# --------------------------------------------------------------- ordering ---

def _natkey(name: str):
    """Natural sort key: 'layers.10' sorts after 'layers.2'."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _flat_params(params) -> List[Tuple[str, tuple]]:
    """(path, shape) list of a flax params tree, naturally ordered."""
    out = [("/".join(path), tuple(np.shape(leaf))) for path, leaf in _leaves(params)]
    out.sort(key=lambda ps: _natkey(ps[0]))
    return out


def strip_prefixes(sd: Dict[str, np.ndarray],
                   prefixes: Iterable[str] = ("model.", "module.")) -> Dict[str, np.ndarray]:
    """Drop common wrapper prefixes (Lightning 'model.', DDP 'module.')."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


# ------------------------------------------------------ generic shape pour ---

def convert_by_shape(sd: Dict[str, np.ndarray], params_template,
                     buckets: Dict[str, Tuple[str, ...]], min_ndim: int = 1):
    """Pour a flat torch state dict into a flax params tree.

    buckets: {flax_path_token: (torch_name_prefixes...)}. A torch tensor
    goes to the first bucket whose prefix matches; a flax param belongs to
    a bucket when the token appears as a path component. Returns
    (new_params, hits, misses: list of unmatched torch names)."""
    pairs = []
    claimed: List[str] = []
    for b, prefixes in buckets.items():
        def torch_pred(n, prefixes=prefixes, prior=tuple(claimed)):
            return any(n.startswith(p) for p in prefixes) and \
                not any(n.startswith(p) for p in prior)
        pairs.append((lambda p, b=b: b in p.split("/"), torch_pred))
        claimed.extend(prefixes)
    return _pour_by_predicate(sd, params_template, pairs)


def report(name: str, hits: int, misses: List[str], total_slots: int) -> None:
    """The conversion summary, always printed (no silent partial loads)."""
    print(f"{name}: converted {hits} tensors "
          f"({len(misses)} unmatched torch tensors, "
          f"{max(total_slots - hits, 0)} flax params left at init)")
    if hits == 0 and misses:
        print(f"{name}: WARNING — checkpoint loaded but NO tensors matched; "
              "weights were NOT applied (model runs with random init)")


# ----------------------------------------------------------- per-model API ---

def convert_stacked_state_dict(sd: Dict[str, np.ndarray], params_template):
    """LatentAudioDiffusionAutoencoder checkpoints (autoencoder.,
    latent_encoder., diffusion. and their *_ema twins): the EMA tensors
    overwrite the mains first (the reference's setup swap). The AE's
    encoder and decoder are separate buckets: a decoder ConvTranspose
    weight is shape-identical to the encoder's strided down conv."""
    sd = remap_ema_weights(strip_prefixes(sd))
    new, hits, misses = convert_by_shape(
        sd, params_template,
        buckets={"encoder": ("autoencoder.encoder.",),
                 "decoder": ("autoencoder.decoder.",),
                 "latent_encoder": ("latent_encoder.",),
                 "diffusion": ("diffusion.",)})
    report("LatentAudioDiffusionAutoencoder", hits, misses, _n_params(params_template))
    return new, hits, misses


def convert_ldm_state_dict(sd: Dict[str, np.ndarray], params_template):
    """StackedAELatentDiffusionCond checkpoints: `diffusion` (UNetCFG1d)
    and `diffusion_ema`, either ema_pytorch's {online_model, ema_model} or
    a plain deepcopy twin. Inference pours the EMA copy."""
    sd = strip_prefixes(sd)
    if any(re.match(r"diffusion_ema\.(ema_model|online_model)\.", k) for k in sd):
        remapped = {}
        for k, v in sd.items():
            m = re.match(r"diffusion_ema\.ema_model\.(.*)", k)
            if m:
                remapped[f"diffusion.{m.group(1)}"] = v    # the EMA wins
        for k, v in sd.items():
            if not k.startswith("diffusion_ema."):
                remapped.setdefault(k, v)
    else:
        remapped = dict(sd)          # plain twins: remap_ema_weights folds them
    remapped = remap_ema_weights(remapped)
    new, hits, misses = convert_by_shape(
        remapped, params_template, buckets={"diffusion": ("diffusion.",)})
    report("StackedAELatentDiffusionCond", hits, misses, _n_params(params_template))
    return new, hits, misses


def convert_dmae_state_dict(sd: Dict[str, np.ndarray], params_template):
    """DMAE1d `model_state_dict`. Two buckets: tensors whose top-level
    component contains 'encoder' pour into the MelE1d tower; everything
    else (the learned-transform convs and UNetV0) into the rest, in
    natural order."""
    sd = strip_prefixes(sd)
    enc_names = tuple(
        {n.split(".")[0] + "." for n in sd if "encoder" in n.split(".")[0]}
    ) or ("encoder.",)

    def enc_torch(n):
        return any(n.startswith(p) for p in enc_names)

    new, hits, misses = _pour_by_predicate(
        sd, params_template,
        [(lambda p: "encoder" in p.split("/"), enc_torch),
         (lambda p: "encoder" not in p.split("/"), lambda n: not enc_torch(n))])
    report("DMAE1d", hits, misses, _n_params(params_template))
    return new, hits, misses


# ------------------------------------------------------- ambiguity audit ---

# Coarse semantic classes for name-hint cross-checking: a pairing whose
# torch and flax names fall in different classes is flagged.
_NAME_CLASSES = (
    ("attn", ("attn", "attention", "to_q", "to_k", "to_v", "to_qkv",
              "to_out", "qkv", "mha", "selfattention", "crossattention")),
    ("norm", ("norm", "groupnorm", "layernorm", "batchnorm", "ln_", "gn_")),
    ("embed", ("embed", "emb", "mapping", "time_mlp", "timestep",
               "fourier", "positional")),
    ("updown", ("downsample", "upsample", "down_", "up_", "resample",
                "pool", "stride")),
)


def _name_class(name: str):
    """Coarse class of a parameter name, or None when no hint appears."""
    low = name.lower().replace("/", ".")
    for cls, tokens in _NAME_CLASSES:
        if any(t in low for t in tokens):
            return cls
    return None


_LAST_REPORT: Dict = {}


def convert_report() -> Dict:
    """Audit of the most recent shape-signature pour:
    {"ambiguous_groups": [{"kind", "shape", "members": [(torch, flax)]}],
     "suspicious": [{"torch", "flax", "torch_class", "flax_class"}],
     "n_placed": int}. A group is ambiguous when more than one tensor of
    one (bucket, kind, shape) was paired by natural-sort order alone; a
    pairing is suspicious when its names' classes disagree."""
    return dict(_LAST_REPORT)


def _audit_placements(placements):
    """Group placements by (bucket, kind, shape); flag cross-class pairs."""
    groups: Dict[tuple, list] = {}
    for bucket_i, tname, fpath, kind, shape in placements:
        groups.setdefault((bucket_i, kind, shape), []).append((tname, fpath))
    ambiguous, suspicious = [], []
    for (bucket_i, kind, shape), members in groups.items():
        if len(members) < 2:
            continue
        ambiguous.append({"kind": kind, "shape": shape, "members": members})
        for tname, fpath in members:
            tc, fc = _name_class(tname), _name_class(fpath)
            if tc is not None and fc is not None and tc != fc:
                suspicious.append({"torch": tname, "flax": fpath,
                                   "torch_class": tc, "flax_class": fc})
    return ambiguous, suspicious


def _candidates(arr: np.ndarray) -> List[np.ndarray]:
    """A torch weight's flax orientations, first match wins: conv (O, I, K)
    -> (K, I, O), a 1x1 conv squeezed to a Dense (I, O), conv-transpose
    (I, O, K) -> (K, I, O); linear (O, I) -> (I, O), then raw (a
    FourierFeatures weight is stored as is)."""
    if arr.ndim == 3:
        a = np.transpose(arr, (2, 1, 0))
        out = [a]
        if a.shape[0] == 1:
            out.append(a[0])
        out.append(np.transpose(arr, (2, 0, 1)))
        return out
    if arr.ndim == 2:
        return [np.transpose(arr), arr]
    if arr.ndim == 1:
        return [arr]
    return [np.transpose(arr, tuple(reversed(range(arr.ndim)))), arr]


def _pour_by_predicate(sd: Dict[str, np.ndarray], params_template,
                       pairs: List[Tuple]) -> Tuple:
    """The shared pour: pairs = [(slot_pred(flax path), torch_pred(name)),
    ...], each an independently ordered bucket. Returns (new_params, hits,
    misses).

    Pairing is kind-aware: 'w' (>= 2-D weights), 'g' (norm scales), 'b'
    (conv / linear biases), 'gb' (norm biases) pair only within their
    kind. A torch bias's kind comes from its sibling weight's ndim, a flax
    bias's from whether its module has a 'scale'. Weights and scales pour
    first and anchor their modules; a bias then follows its weight's
    module before ordered pairing is tried."""
    leaves = _leaves(params_template)
    template = {"/".join(path): leaf for path, leaf in leaves}
    parents: Dict[str, set] = {}
    paths = []
    for key, leaf in template.items():
        paths.append((key, tuple(np.shape(leaf))))
        parent = key.rsplit("/", 1)[0] if "/" in key else ""
        parents.setdefault(parent, set()).add(key.rsplit("/", 1)[-1])
    paths.sort(key=lambda ps: _natkey(ps[0]))

    def flax_kind(path):
        last = path.rsplit("/", 1)[-1]
        parent = path.rsplit("/", 1)[0] if "/" in path else ""
        if last == "bias":
            return "gb" if "scale" in parents.get(parent, ()) else "b"
        return "g" if last == "scale" else "w"

    def torch_kind(name, arr):
        if name.rsplit(".", 1)[-1] == "bias":
            sib = sd.get(name[: -len("bias")] + "weight")
            return "gb" if sib is not None and np.asarray(sib).ndim == 1 else "b"
        return "g" if arr.ndim == 1 else "w"

    new: Dict[str, np.ndarray] = {}
    hits, misses = 0, []
    placements = []   # (bucket_i, torch_name, flax_path, kind, shape)

    def place(slot, arr):
        new[slot] = np.asarray(arr, dtype=np.asarray(template[slot]).dtype)

    for bucket_i, (slot_pred, torch_pred) in enumerate(pairs):
        slots = [(p, s, flax_kind(p)) for p, s in paths if slot_pred(p)]
        used = set()
        module_map = {}   # torch module prefix -> flax parent path

        def pour_one(tname, arr, kind):
            nonlocal hits
            if tname.endswith(".bias"):          # follow the weight's module
                parent = module_map.get(tname[: -len(".bias")])
                if parent is not None:
                    slot = parent + "/bias"
                    if slot not in used and slot in template and \
                            tuple(arr.shape) == tuple(np.shape(template[slot])):
                        used.add(slot)
                        place(slot, arr)
                        hits += 1
                        return True
            for cand in _candidates(arr):
                match = next((p for p, s, k in slots
                              if p not in used and k == kind and s == cand.shape), None)
                if match is not None:
                    used.add(match)
                    place(match, cand)
                    hits += 1
                    placements.append((bucket_i, tname, match, kind, cand.shape))
                    if tname.endswith(".weight"):
                        module_map[tname[: -len(".weight")]] = \
                            match.rsplit("/", 1)[0] if "/" in match else ""
                    return True
            return False

        deferred = []
        for tname in sorted(sd, key=_natkey):
            if not torch_pred(tname) or _is_buffer(tname):
                continue
            arr = np.asarray(sd[tname])
            if arr.ndim < 1:
                continue
            if tname.endswith(".bias"):
                deferred.append((tname, arr))
                continue
            if not pour_one(tname, arr, torch_kind(tname, arr)):
                misses.append(tname)
        for tname, arr in deferred:
            if not pour_one(tname, arr, torch_kind(tname, arr)):
                misses.append(tname)
    unclaimed = [n for n in sorted(sd, key=_natkey)
                 if not _is_buffer(n) and np.asarray(sd[n]).ndim >= 1
                 and not any(tp(n) for _, tp in pairs)]
    if unclaimed:
        print(f"convert: {len(unclaimed)} torch tensors outside every "
              f"bucket were not poured (e.g. {unclaimed[0]})")
    ambiguous, suspicious = _audit_placements(placements)
    _LAST_REPORT.clear()
    _LAST_REPORT.update({"ambiguous_groups": ambiguous,
                         "suspicious": suspicious, "n_placed": len(placements)})
    if ambiguous:
        n_mem = sum(len(g["members"]) for g in ambiguous)
        print(f"convert: {len(ambiguous)} same-shape groups ({n_mem} "
              f"tensors) paired by order alone — see convert_report()")
    for s in suspicious:
        print(f"convert: SUSPICIOUS pairing {s['torch']} "
              f"[{s['torch_class']}] -> {s['flax']} [{s['flax_class']}] — "
              "same shape, different name class; verify numerically")
    new_tree = _rebuild(params_template, {tuple(k.split("/")): v for k, v in new.items()})
    return new_tree, hits, misses


_BUFFER_MARKERS = ("kernel_1d", "num_batches_tracked", "position_ids",
                   "rng", "sobol", "pqmf", "latent_pca", "latent_mean",
                   "fidelity", "target_size", "receptive_field")


def _is_buffer(name: str) -> bool:
    """Non-parameter buffers that never enter the shape pour (fixed
    resampler taps, BN counters, cached PQMF filters, RNG state)."""
    low = name.lower()
    return any(m in low for m in _BUFFER_MARKERS)


def fuse_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fuse torch weight-norm pairs into plain weights: `<stem>.weight_g` +
    `<stem>.weight_v`, or the parametrize API's
    `<stem>.parametrizations.weight.original0/1`, become
    W = g * v / ||v|| (the norm over every axis but 0). Other keys pass
    through; a stray half passes through so that its miss shows."""
    out: Dict[str, np.ndarray] = {}
    pairs: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if k.endswith(".weight_g") or k.endswith(".weight_v"):
            stem, which = k[: -len(".weight_x")], k[-1]
            pairs.setdefault(stem, {})[which] = v
        elif ".parametrizations.weight.original" in k:
            stem = k.split(".parametrizations.weight.original")[0]
            which = "g" if k.endswith("0") else "v"
            pairs.setdefault(stem, {})[which] = v
        else:
            out[k] = v
    for stem, gv in pairs.items():
        if "g" in gv and "v" in gv:
            v = np.asarray(gv["v"], dtype=np.float32)
            g = np.asarray(gv["g"], dtype=np.float32)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v * v).sum(axis=axes, keepdims=True)) + 1e-12
            out[stem + ".weight"] = (g * v / norm).astype(np.float32)
        else:
            for which, v in gv.items():
                out[f"{stem}.weight_{which}"] = v
    return out


def extract_rave_latent_transform(sd: Dict[str, np.ndarray]):
    """(latent_pca, latent_mean) of a RAVE export, or (None, None). An
    export rotates its latents by a learned PCA (and crops to the
    informative dims): z' = P (z - mu)."""
    pca = mean = None
    for k, v in sd.items():
        if k.endswith("latent_pca"):
            pca = np.asarray(v, dtype=np.float32)
        elif k.endswith("latent_mean"):
            mean = np.asarray(v, dtype=np.float32)
    return pca, mean


def convert_rave_state_dict(sd: Dict[str, np.ndarray], params_template):
    """RAVE state dicts (a .ckpt or a TorchScript archive's): weight-norm
    pairs fused first; encoder.* pours into the enc* params, decoder.*
    into dec* (the variational wrapper's `encoder.encoder.net` included)."""
    sd = strip_prefixes(sd, ("model.", "module.", "_rave.", "pretrained."))
    sd = fuse_weight_norm(sd)
    new, hits, misses = _pour_by_predicate(
        sd, params_template,
        [(lambda p: p.split("/")[1].startswith("enc"), lambda n: n.startswith("encoder.")),
         (lambda p: p.split("/")[1].startswith("dec"), lambda n: n.startswith("decoder."))])
    report("RAVE", hits, misses, _n_params(params_template))
    return new, hits, misses


def load_torchscript_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A TorchScript archive's (.ts) state dict, on the host."""
    import torch

    mod = torch.jit.load(os.path.expanduser(path), map_location="cpu")
    return {k: v.detach().cpu().numpy() for k, v in mod.state_dict().items()}


# ----------------------------------------------------------------- CLAP ----
#
# The CLAP towers (models/clap.py) are architecture-faithful HTSAT + RoBERTa,
# so their pour is an exact name map. Two torch dialects:
#   * laion_clap / timm (real CLAP_CKPT files): audio_branch.* with fused
#     attn.qkv, norm1/norm2, mlp.fc1/fc2; text_branch.* (an HF RobertaModel);
#     audio/text_projection Sequential indices 0 and 2;
#   * HuggingFace transformers ClapModel: audio_model.audio_encoder.* with
#     separate query/key/value, layernorm_before/after,
#     intermediate/output; text_model.*; projection linear1/linear2.

_CLAP_SKIP_MARKERS = (
    "relative_position_index", "num_batches_tracked", "position_ids",
    "token_type_ids", "attn_mask", "logit_scale",
    # the analytic front end is ops/mel (torchaudio conv weights)
    "spectrogram_extractor", "logmel_extractor",
    # HTSAT's event-classification head, off the embedding path
    "tscam_conv", "head.",
)


def _canon_clap_names(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Both dialects to laion_clap-style canonical names, fused qkv split."""
    sd = strip_prefixes(sd, ("model.", "module.", "clap_model."))
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        k = k.replace("audio_model.audio_encoder.", "audio_branch.")
        k = k.replace("text_model.", "text_branch.")
        k = k.replace("audio_branch.batch_norm.", "audio_branch.bn0.")
        k = k.replace(".attention.self.relative_position_bias_table",
                      ".attn.relative_position_bias_table")
        k = k.replace(".attention.output.LayerNorm", ".attention_output_ln")
        k = k.replace(".attention.output.dense", ".attn.proj")
        k = k.replace(".attention.self.", ".attn.")
        if ".attn.qkv." in k:
            w = np.asarray(v)
            c = w.shape[0] // 3
            for part, sl in (("q", slice(0, c)), ("k", slice(c, 2 * c)),
                             ("v", slice(2 * c, 3 * c))):
                out[k.replace(".attn.qkv.", f".attn.{part}.")] = w[sl]
            continue
        k = k.replace(".attn.query.", ".attn.q.")
        k = k.replace(".attn.key.", ".attn.k.")
        k = k.replace(".attn.value.", ".attn.v.")
        out[k] = v
    return out


def _t_lin(a):
    a = np.asarray(a)
    return a.T if a.ndim == 2 else a


def _ident(a):
    return np.asarray(a)


def _conv2d(a):
    return np.asarray(a).transpose(2, 3, 1, 0)


_CLAP_BLOCK = {
    "norm1.weight": (("layernorm_before", "scale"), _ident),
    "norm1.bias": (("layernorm_before", "bias"), _ident),
    "layernorm_before.weight": (("layernorm_before", "scale"), _ident),
    "layernorm_before.bias": (("layernorm_before", "bias"), _ident),
    "norm2.weight": (("layernorm_after", "scale"), _ident),
    "norm2.bias": (("layernorm_after", "bias"), _ident),
    "layernorm_after.weight": (("layernorm_after", "scale"), _ident),
    "layernorm_after.bias": (("layernorm_after", "bias"), _ident),
    "attn.relative_position_bias_table": (("attn", "rel_pos_bias"), _ident),
    "attn.q.weight": (("attn", "query", "kernel"), _t_lin),
    "attn.q.bias": (("attn", "query", "bias"), _ident),
    "attn.k.weight": (("attn", "key", "kernel"), _t_lin),
    "attn.k.bias": (("attn", "key", "bias"), _ident),
    "attn.v.weight": (("attn", "value", "kernel"), _t_lin),
    "attn.v.bias": (("attn", "value", "bias"), _ident),
    "attn.proj.weight": (("attn", "out", "kernel"), _t_lin),
    "attn.proj.bias": (("attn", "out", "bias"), _ident),
    "mlp.fc1.weight": (("intermediate", "kernel"), _t_lin),
    "mlp.fc1.bias": (("intermediate", "bias"), _ident),
    "intermediate.dense.weight": (("intermediate", "kernel"), _t_lin),
    "intermediate.dense.bias": (("intermediate", "bias"), _ident),
    "mlp.fc2.weight": (("output", "kernel"), _t_lin),
    "mlp.fc2.bias": (("output", "bias"), _ident),
    "output.dense.weight": (("output", "kernel"), _t_lin),
    "output.dense.bias": (("output", "bias"), _ident),
}

_CLAP_TEXT_LAYER = {
    "attn.q.weight": ("query", "kernel", _t_lin),
    "attn.q.bias": ("query", "bias", _ident),
    "attn.k.weight": ("key", "kernel", _t_lin),
    "attn.k.bias": ("key", "bias", _ident),
    "attn.v.weight": ("value", "kernel", _t_lin),
    "attn.v.bias": ("value", "bias", _ident),
    "attn.proj.weight": ("attn_out", "kernel", _t_lin),
    "attn.proj.bias": ("attn_out", "bias", _ident),
    "attention_output_ln.weight": ("attn_norm", "scale", _ident),
    "attention_output_ln.bias": ("attn_norm", "bias", _ident),
    "intermediate.dense.weight": ("intermediate", "kernel", _t_lin),
    "intermediate.dense.bias": ("intermediate", "bias", _ident),
    "output.dense.weight": ("output", "kernel", _t_lin),
    "output.dense.bias": ("output", "bias", _ident),
    "output.LayerNorm.weight": ("out_norm", "scale", _ident),
    "output.LayerNorm.bias": ("out_norm", "bias", _ident),
}

_PROJ = {"0": "linear1", "2": "linear2", "linear1": "linear1", "linear2": "linear2"}


def _clap_audio_flax_path(name: str):
    """Canonical audio-branch torch name -> (flax path tuple, transform),
    or (None, None)."""
    m = re.match(r"audio_branch\.bn0\.(weight|bias|running_mean|running_var)$", name)
    if m:
        part = {"weight": "bn_scale", "bias": "bn_bias",
                "running_mean": "bn_mean", "running_var": "bn_var"}[m.group(1)]
        return ("audio_branch", part), _ident
    m = re.match(r"audio_branch\.patch_embed\.proj\.(weight|bias)$", name)
    if m:
        if m.group(1) == "weight":
            return ("audio_branch", "patch_proj", "kernel"), _conv2d
        return ("audio_branch", "patch_proj", "bias"), _ident
    m = re.match(r"audio_branch\.patch_embed\.norm\.(weight|bias)$", name)
    if m:
        return ("audio_branch", "patch_norm",
                "scale" if m.group(1) == "weight" else "bias"), _ident
    # the > 10 s fusion branch: the local-crop conv and the AFF block
    m = re.match(r"audio_branch\.patch_embed\.mel_conv2d\.(weight|bias)$", name)
    if m:
        if m.group(1) == "weight":
            return ("audio_branch", "mel_conv2d", "kernel"), _conv2d
        return ("audio_branch", "mel_conv2d", "bias"), _ident
    m = re.match(r"audio_branch\.patch_embed\.fusion_model\."
                 r"(local|global)_att\.(\d+)\.(weight|bias|running_mean|"
                 r"running_var)$", name)
    if m:
        side, idx, part = m.groups()
        # Sequential indices: local_att = [conv, bn, relu, conv, bn] ->
        # 0, 1, 3, 4; global_att = [pool, conv, bn, relu, conv, bn] -> 1, 2, 4, 5
        conv_idx = {"local": {"0": 1, "3": 2}, "global": {"1": 1, "4": 2}}[side]
        bn_idx = {"local": {"1": 1, "4": 2}, "global": {"2": 1, "5": 2}}[side]
        if idx in conv_idx and part in ("weight", "bias"):
            mod = f"{side}_conv{conv_idx[idx]}"
            if part == "weight":      # a 1x1 Conv2d (O, I, 1, 1) -> Dense (I, O)
                return ("audio_branch", "fusion_model", mod, "kernel"), \
                    lambda a: np.asarray(a)[:, :, 0, 0].T
            return ("audio_branch", "fusion_model", mod, "bias"), _ident
        if idx in bn_idx:
            mod = f"{side}_bn{bn_idx[idx]}"
            bn_part = {"weight": "scale", "bias": "bias",
                       "running_mean": "mean", "running_var": "var"}[part]
            return ("audio_branch", "fusion_model", mod, bn_part), _ident
        return None, None
    m = re.match(r"audio_branch\.layers\.(\d+)\.blocks\.(\d+)\.(.+)$", name)
    if m:
        i, j, rest = m.groups()
        if rest in _CLAP_BLOCK:
            sub, tr = _CLAP_BLOCK[rest]
            return ("audio_branch", f"layers_{i}_blocks_{j}") + sub, tr
        return None, None
    m = re.match(r"audio_branch\.layers\.(\d+)\.downsample\.(norm|reduction)\.(weight|bias)$",
                 name)
    if m:
        i, mod, part = m.groups()
        ds = f"layers_{i}_downsample"
        if mod == "reduction":
            return ("audio_branch", ds, "reduction", "kernel"), _t_lin
        return ("audio_branch", ds, "norm", "scale" if part == "weight" else "bias"), _ident
    m = re.match(r"audio_branch\.norm\.(weight|bias)$", name)
    if m:
        return ("audio_branch", "norm", "scale" if m.group(1) == "weight" else "bias"), _ident
    m = re.match(r"audio_projection\.(0|2|linear1|linear2)\.(weight|bias)$", name)
    if m:
        part = "kernel" if m.group(2) == "weight" else "bias"
        return ("audio_projection", _PROJ[m.group(1)], part), \
            (_t_lin if part == "kernel" else _ident)
    return None, None


def _clap_text_flax_path(name: str):
    """Canonical text-branch torch name -> (flax path tuple, transform),
    or (None, None)."""
    m = re.match(r"text_branch\.embeddings\.(word|position|token_type)_embeddings\.weight$",
                 name)
    if m:
        kind = m.group(1)
        if kind == "token_type":
            return ("text_branch", "token_type_embeddings"), _ident
        return ("text_branch", f"{kind}_embeddings", "embedding"), _ident
    m = re.match(r"text_branch\.embeddings\.LayerNorm\.(weight|bias)$", name)
    if m:
        return ("text_branch", "embeddings_norm",
                "scale" if m.group(1) == "weight" else "bias"), _ident
    m = re.match(r"text_branch\.encoder\.layer\.(\d+)\.(.+)$", name)
    if m:
        i, rest = m.groups()
        if rest in _CLAP_TEXT_LAYER:
            mod, part, tr = _CLAP_TEXT_LAYER[rest]
            return ("text_branch", f"layer_{i}_{mod}", part), tr
        return None, None
    m = re.match(r"text_branch\.pooler\.dense\.(weight|bias)$", name)
    if m:
        part = "kernel" if m.group(1) == "weight" else "bias"
        return ("text_branch", "pooler", part), (_t_lin if part == "kernel" else _ident)
    m = re.match(r"text_projection\.(0|2|linear1|linear2)\.(weight|bias)$", name)
    if m:
        part = "kernel" if m.group(2) == "weight" else "bias"
        return ("text_projection", _PROJ[m.group(1)], part), \
            (_t_lin if part == "kernel" else _ident)
    return None, None


def _pour_named(entries, template):
    """entries: {flax path tuple under 'params': np.ndarray}. Returns
    (new_params, hits, mismatches)."""
    index = {path: leaf for path, leaf in _leaves(template)}
    new, hits, mismatches = {}, 0, []
    for path, arr in entries.items():
        full = ("params",) + path
        leaf = index.get(full)
        if leaf is None:
            mismatches.append(("missing-slot",) + path)
            continue
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            mismatches.append(("shape",) + path)
            continue
        new[full] = np.asarray(arr, dtype=np.asarray(leaf).dtype)
        hits += 1
    return _rebuild(template, new), hits, mismatches


def convert_clap_state_dict(sd: Dict[str, np.ndarray], audio_template, text_template):
    """Pour a torch CLAP checkpoint into the HTSAT / RoBERTa towers by the
    exact name map of both dialects; the skipped classes (front-end convs,
    classifier head, buffers) are counted and reported. Returns
    (audio_params, text_params, hits, misses)."""
    sd = _canon_clap_names(sd)
    audio_entries, text_entries = {}, {}
    misses, skipped = [], 0
    for name, arr in sd.items():
        if any(mark in name for mark in _CLAP_SKIP_MARKERS):
            skipped += 1
            continue
        path, tr = _clap_audio_flax_path(name)
        if path is not None:
            audio_entries[path] = tr(arr)
            continue
        path, tr = _clap_text_flax_path(name)
        if path is not None:
            text_entries[path] = tr(arr)
            continue
        misses.append(name)
    new_audio, ha, mm_a = _pour_named(audio_entries, audio_template)
    new_text, ht, mm_t = _pour_named(text_entries, text_template)
    mm_a = ["/".join(m) for m in mm_a]
    mm_t = ["/".join(m) for m in mm_t]
    report("CLAP audio tower", ha, mm_a, _n_params(audio_template))
    report("CLAP text tower", ht, mm_t, _n_params(text_template))
    if misses:
        print(f"CLAP: {len(misses)} tensors matched neither tower's naming "
              f"scheme (e.g. {misses[0]})")
    misses += mm_a + mm_t
    if skipped:
        print(f"CLAP: skipped {skipped} non-embedding tensors "
              "(front-end/head/fusion/buffers — see convert._CLAP_SKIP_MARKERS)")
    return new_audio, new_text, ha + ht, misses


def infer_clap_cfgs(sd: Dict[str, np.ndarray], audio_default, text_default):
    """The tower hyperparameters from a CLAP state dict's shapes (laion_clap
    ships tiny / base / large audio towers under one naming), as
    dataclasses.replace of the defaults (models/clap.ClapAudioCfg,
    ClapTextCfg)."""
    sd = _canon_clap_names(sd)
    a_kw, t_kw = {}, {}
    pe = sd.get("audio_branch.patch_embed.proj.weight")
    if pe is not None:
        pe = np.asarray(pe)
        a_kw["patch_embed_hidden"] = int(pe.shape[0])
        a_kw["patch_size"] = int(pe.shape[-1])
    bn = sd.get("audio_branch.bn0.weight")
    if bn is not None:
        a_kw["num_mel_bins"] = int(np.asarray(bn).shape[0])
    # the fusion branch: a local-crop conv means enable_fusion; the AFF
    # bottleneck ratio falls out of its 1x1 conv shapes
    if sd.get("audio_branch.patch_embed.mel_conv2d.weight") is not None:
        a_kw["enable_fusion"] = True
        aff1 = sd.get("audio_branch.patch_embed.fusion_model.local_att.0.weight")
        if aff1 is not None:
            aff1 = np.asarray(aff1)          # (inter, channels, 1, 1)
            a_kw["aff_r"] = max(int(round(aff1.shape[1] / aff1.shape[0])), 1)
    blocks = {}
    for k in sd:
        m = re.match(r"audio_branch\.layers\.(\d+)\.blocks\.(\d+)\.", k)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            blocks[i] = max(blocks.get(i, 0), j + 1)
    if blocks:
        n_stages = max(blocks) + 1
        a_kw["depths"] = tuple(blocks.get(i, 1) for i in range(n_stages))
        heads = []
        for i in range(n_stages):
            t = sd.get(f"audio_branch.layers.{i}.blocks.0.attn.relative_position_bias_table")
            heads.append(int(np.asarray(t).shape[-1]) if t is not None
                         else audio_default.heads[min(i, len(audio_default.heads) - 1)])
        a_kw["heads"] = tuple(heads)
        t0 = sd.get("audio_branch.layers.0.blocks.0.attn.relative_position_bias_table")
        if t0 is not None:
            a_kw["window"] = (int(round(np.sqrt(np.asarray(t0).shape[0]))) + 1) // 2
    fc1 = sd.get("audio_branch.layers.0.blocks.0.mlp.fc1.weight")
    if fc1 is None:
        fc1 = sd.get("audio_branch.layers.0.blocks.0.intermediate.dense.weight")
    if fc1 is not None and "patch_embed_hidden" in a_kw:
        a_kw["mlp_ratio"] = int(np.asarray(fc1).shape[0] // a_kw["patch_embed_hidden"])
    proj2 = sd.get("audio_projection.2.weight", sd.get("audio_projection.linear2.weight"))
    if proj2 is not None:
        a_kw["projection_dim"] = int(np.asarray(proj2).shape[0])
        t_kw["projection_dim"] = int(np.asarray(proj2).shape[0])

    we = sd.get("text_branch.embeddings.word_embeddings.weight")
    if we is not None:
        we = np.asarray(we)
        t_kw["vocab"], t_kw["hidden"] = int(we.shape[0]), int(we.shape[1])
        # the head count is not in the shapes; hidden // 64 assumes
        # RoBERTa's head width of 64, and says so when it matters
        if t_kw["hidden"] % 64 == 0:
            t_kw["heads"] = max(t_kw["hidden"] // 64, 1)
            if t_kw["heads"] != text_default.heads:
                print(f"infer_clap_cfgs: text heads GUESSED as hidden//64 = "
                      f"{t_kw['heads']} (head_dim=64 assumption, unverifiable "
                      f"from shapes)")
        else:
            print(f"infer_clap_cfgs: WARNING text hidden={t_kw['hidden']} not "
                  f"divisible by 64; keeping default heads="
                  f"{text_default.heads} — head_dim=64 assumption does not "
                  f"hold, attention may be numerically wrong")
    pe_t = sd.get("text_branch.embeddings.position_embeddings.weight")
    if pe_t is not None:
        t_kw["max_pos"] = int(np.asarray(pe_t).shape[0])
    inter = sd.get("text_branch.encoder.layer.0.intermediate.dense.weight")
    if inter is not None:
        t_kw["intermediate"] = int(np.asarray(inter).shape[0])
    n_layers = -1
    for k in sd:
        m = re.match(r"text_branch\.encoder\.layer\.(\d+)\.", k)
        if m:
            n_layers = max(n_layers, int(m.group(1)))
    if n_layers >= 0:
        t_kw["layers"] = n_layers + 1
    return (dataclasses.replace(audio_default, **a_kw),
            dataclasses.replace(text_default, **t_kw))


# ------------------------------------------------------------ the modules ---

def pour(module, converter, sd: Dict[str, np.ndarray], init=None) -> Tuple[int, List[str]]:
    """Pour `sd` into a port module through one of the converters above:
    a tree of the module's leaf shapes is the template, and the poured tree
    is loaded back. A leaf the converter did not reach takes the module's
    own value, read after `init()` where `init` is given (a callable that
    gives the module its values, such as the seeded random init): a pour
    that reaches every leaf reads nothing of the module and runs no
    `init`. Returns (hits, misses)."""
    from .utils.params import flax_shapes, load_flax_params, to_flax_params

    template = {"params": flax_shapes(module)}
    new, hits, misses = converter(sd, template)
    left = [path for (path, leaf), (_, blank) in zip(_leaves(new), _leaves(template))
            if leaf is blank]
    if left:
        if init is not None:
            init()
        own = dict(_leaves({"params": to_flax_params(module)}))
        new = _rebuild(new, {path: own[path] for path in left})
    load_flax_params(module, new)
    return hits, misses
