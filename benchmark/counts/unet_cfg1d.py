"""UNetCFG1d (MIRAGE's inner UNet): the operations of one core forward
and its K5 launches. Under classifier-free guidance the core runs on the
doubled batch. A ResnetBlock is two conv3s, a FiLM dense from the time
features and a 1x1 skip where the width changes; a TransformerBlock is a
rel-pos self-attention (q, k, v, out projections; T x T scores and sum),
a cross-attention to one context token, and a 4x feed-forward."""
from __future__ import annotations


def _levels(cfg, t_len):
    """(stage, level, c_in, feats, t) of every level, in forward order."""
    ch, m, f = cfg["channels"], cfg["multipliers"], cfg["factors"]
    n = len(m)
    out, t, c = [], t_len, ch * m[0]
    for i in range(n - 1):
        out.append(("down", i, c, ch * m[i], t))
        c, t = ch * m[i + 1], t // f[i]
    out.append(("mid", n - 1, c, ch * m[n - 1], t))
    for i in reversed(range(n - 1)):
        t *= f[i]
        out.append(("up", i, 2 * ch * m[i], ch * m[i], t))
    return out


def _n_blocks(cfg, i):
    nb = cfg["num_blocks"]
    return nb[i] if i < len(nb) else 1


def core_flops(cfg, batch: int, t_len: int) -> float:
    ch, m, f = cfg["channels"], cfg["multipliers"], cfg["factors"]
    tf = 4 * ch
    inner = cfg["attention_heads"] * cfg["attention_features"]
    ctx, ctx_len = cfg["context_embedding_features"], cfg["context_embedding_max_length"]
    mult = cfg["attention_multiplier"]
    b = batch
    total = 2 * b * (ch * tf + tf * tf)                      # time MLP
    total += 2 * b * t_len * cfg["in_channels"] * ch * m[0] * 7
    for stage, i, c_in, feats, t in _levels(cfg, t_len):
        for _ in range(_n_blocks(cfg, i)):
            total += 2 * b * t * (c_in * feats * 3 + feats * feats * 3) + 2 * b * tf * 2 * feats
            if c_in != feats:
                total += 2 * b * t * c_in * feats
            c_in = feats
        for _ in range(cfg["attentions"][i]):
            c = feats
            total += 2 * b * t * c * inner * 4 + 4 * b * t * t * inner          # self
            total += 2 * b * t * c * inner * 2 + 2 * b * ctx_len * ctx * inner * 2 \
                + 4 * b * t * ctx_len * inner                                    # cross
            total += 2 * b * t * c * c * mult * 2                                # feed-forward
    t = t_len
    for i in range(len(m) - 1):                               # down convs
        k = f[i] * cfg["kernel_multiplier_downsample"] if f[i] > 1 else 3
        total += 2 * b * (t // f[i]) * ch * m[i] * ch * m[i + 1] * k
        t //= f[i]
    for i in reversed(range(len(m) - 1)):                     # up convs
        k = f[i] * cfg["kernel_multiplier_downsample"] if f[i] > 1 else 3
        total += 2 * b * t * ch * m[i + 1] * ch * m[i] * k
        t *= f[i]
    c_last = ch * m[0]
    return total + 2 * b * t_len * c_last * cfg["in_channels"] * 7


def k5_launches(cfg, batch: int, t_len: int):
    """[(shape, film)] of every K5 launch of one core forward."""
    out = []
    for stage, i, c_in, feats, t in _levels(cfg, t_len):
        for _ in range(_n_blocks(cfg, i)):
            out.append(((batch, c_in, t), False))
            out.append(((batch, feats, t), True))
            c_in = feats
    out.append(((batch, cfg["channels"] * cfg["multipliers"][0], t_len), False))
    return out
