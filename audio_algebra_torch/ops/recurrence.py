"""The effects bank's recurrences: kernels R1, R2 and R3.

The JAX package writes three recurrences of its effects bank as scans,
which torch does not have:
- R1 `sosfilt_rows`: a cascade of biquads in transposed direct form II
  (JAX `ops/filters.py:189-232`, `sosfilt` over `_biquad_assoc`), with
  coefficients per row;
- R2 `envelope`: the compressor's attack / release envelope follower (JAX
  `ops/effects.py:97-102`);
- R3 `freeverb_irs`: the impulse response of JUCE's Freeverb wet path (JAX
  `ops/effects.py:178-223`, `freeverb_ir`).

On a CUDA tensor each wrapper launches its hand-written kernel of
`csrc/recurrence.cu` (built for sm_90a at first use) or raises; on a CPU
tensor it takes its plain twin: R1 the log-depth associative scan of JAX's
default `_biquad_assoc`, written in torch; R2 and R3 step-by-step loops,
which the tests and `chip_smoke.py` hold at short lengths. R1 and R2 cut
time into chunks: R1 as a linear scan (`chunk_plan`), R2 by Newton rounds
over the chunks of its piecewise-affine step, run on the device in one
cluster launch (`envelope_plan`; `envelope_stats` reads the rounds of the
last call). `launches` counts each kernel's launches (R1: one a group of
at most MAX_SECTIONS sections); `cuda_launches` counts the CUDA launches
of R1 (three a group when it cuts time into more than one chunk) and R2
(one a call).
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "recurrence.cu"
MAX_SECTIONS = 8                # R1's sections a launch; more are split
MIN_CHUNK, MAX_CHUNK = 128, 1 << 16    # R1's chunk lengths: powers of two in between
MAX_SEGMENTS = 1 << 16          # R1's (row, chunk) threads a pass: ~15 warps an SM
MAX_ENV_CHUNKS = 2048           # R2's chunks a row: a cluster of 8 blocks of 8 warps
ENV_MAX_CLUSTER = 8             # R2's blocks a row (one cluster)
ENV_WARPS, ENV_STREAM_WARPS = 8, 4   # R2's warps a block, resident / streamed
ENV_SMEM_BYTES = 200 * 1024     # R2's shared memory a block: its chunks, or its tiles
ENV_TILE_BYTES = 2 * 32 * 132 * 4    # a streamed warp's double-buffered tile
ENV_MAX_ROUNDS = 32             # R2's carries before a row is repaired by a serial walk
ENV_TOL = 2.0 ** -19            # R2's check at the chunk ends, relative to the start
ENV_FLOOR = 1e-30               # starts below it are compared as 1e-30
COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNINGS = (556, 441, 341, 225)

launches = {"sosfilt": 0, "envelope": 0, "freeverb_ir": 0}
cuda_launches = {"sosfilt": 0, "envelope": 0}
_envelope_last: dict = {}       # the last call of `envelope` on the card


def _lib():
    from ._build import load
    lib = load(SOURCE)
    if lib.aa_sosfilt.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.aa_sosfilt.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.aa_sosfilt_scratch_bytes.argtypes = [ci, ci, ci, ci, ci]
        lib.aa_sosfilt_scratch_bytes.restype = ctypes.c_longlong
        lib.aa_envelope.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, vp]
        lib.aa_freeverb_ir.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        for fn in (lib.aa_sosfilt, lib.aa_envelope, lib.aa_freeverb_ir):
            fn.restype = ci
    return lib


def _check_device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (twin)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernel_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, T) f32 as R1 / R2 read it: contiguous, 16-byte aligned, T
    zero-padded to a multiple of 4 (the recurrences are causal, so the
    padding changes no sample before it)."""
    x = x.float().contiguous()
    pad = -x.shape[1] % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    if x.data_ptr() % 16:
        x = x.clone()
    return x


# ------------------------------------------------------------- R1 sosfilt ---

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to f32 (the f32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _combine(early, late):
    """The composition of two affine state maps (M, c): `late` after
    `early`, (M_l M_e, M_l c_e + c_l), as JAX's `_biquad_assoc` combines
    them; M as (m00, m01, m10, m11), c as (c0, c1). Each two-term sum is
    formed as XLA's CPU dot forms it, the first product rounded and the
    second added by a fused multiply-add, so that on the CPU the scan gives
    JAX's bits: the scan is ill-conditioned in f32 where a pole lies near
    1 (the K-weighting's 38 Hz high pass), and a plain product order moves
    a loudness by several thousandths of an LU."""
    e00, e01, e10, e11, ec0, ec1 = early
    l00, l01, l10, l11, lc0, lc1 = late
    return (_fma(l01, e10, l00 * e00), _fma(l01, e11, l00 * e01),
            _fma(l11, e10, l10 * e00), _fma(l11, e11, l10 * e01),
            _fma(l01, ec1, l00 * ec0) + lc0, _fma(l11, ec1, l10 * ec0) + lc1)


def _associative_scan(elems):
    """Inclusive prefix scan of `_combine` over the last axis, in the order
    of jax.lax.associative_scan: combine neighbouring pairs, scan the
    half-length result, fill in the even positions."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _associative_scan(_combine([e[..., 0:-1:2] for e in elems],
                                     [e[..., 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[..., :-1] for e in odd], [e[..., 2::2] for e in elems])
    else:
        even = _combine(odd, [e[..., 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full[..., 0::2] = torch.cat([e[..., :1], ev], -1)
        full[..., 1::2] = od
        out.append(full)
    return out


def _biquad_assoc(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One biquad over (rows, T) by JAX's `_biquad_assoc`: the state
    recurrence s_t = M s_{t-1} + c(x_t), with M = [[-a1, 1], [-a2, 0]] and
    c(x) = ((b1 - a1 b0) x, (b2 - a2 b0) x), is affine, and affine maps
    compose associatively, so a parallel prefix scan of (M, c) pairs takes
    O(log T) depth; y_t = b0 x_t + s1_{t-1}. c: (rows or 1, 6)."""
    b0, b1, b2 = c[:, 0:1], c[:, 1:2], c[:, 2:3]
    a1, a2 = c[:, 4:5], c[:, 5:6]
    pairs = [(-a1).expand_as(x), torch.ones_like(x), (-a2).expand_as(x),
             torch.zeros_like(x), (b1 - a1 * b0) * x, (b2 - a2 * b0) * x]
    s1 = _associative_scan(pairs)[4]
    return b0 * x + torch.cat([torch.zeros_like(s1[:, :1]), s1[:, :-1]], 1)


def sosfilt_rows_ref(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of R1: the sections in turn, each by the associative scan."""
    for i in range(sos.shape[1]):
        x = _biquad_assoc(x, sos[:, i])
    return x


def chunk_plan(rows: int, t_len: int) -> tuple[int, int]:
    """R1's chunk length L and chunk count C for (rows, t_len), t_len as the
    kernel takes it (a multiple of 4). The chunked scan's two passes over
    the samples each take about L dependent steps a thread (and each row's
    Phi L float64 steps) and its carry about C / 16 steps a row, so L is
    the least power of two from MIN_CHUNK with C <= 8 L and rows x C <=
    MAX_SEGMENTS (enough threads to fill the card, no more). One chunk (L
    = t_len, C = 1: a thread a row) where t_len <= MIN_CHUNK or where the
    rows alone fill half the threads."""
    if t_len <= MIN_CHUNK or 2 * rows > MAX_SEGMENTS:
        return t_len, 1
    length = MIN_CHUNK
    while length < MAX_CHUNK:
        chunks = -(-t_len // length)
        if chunks <= 8 * length and rows * chunks <= MAX_SEGMENTS:
            break
        length *= 2
    chunks = -(-t_len // length)
    return (length, chunks) if chunks > 1 else (t_len, 1)


def sosfilt_rows(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R1: second-order sections `sos` (rows or 1, n_sections, 6), each row
    (b0, b1, b2, 1, a1, a2), applied to x (rows, T) f32 along T from zero
    state. CPU tensors take the twin; CUDA tensors launch the kernel, at
    most MAX_SECTIONS sections a launch, time cut into chunks by
    `chunk_plan`."""
    if x.dim() != 2 or sos.dim() != 3 or sos.shape[-1] != 6 \
            or sos.shape[0] not in (1, x.shape[0]):
        raise ValueError(f"sosfilt_rows: sos {tuple(sos.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    sos = sos.to(x.device, torch.float32)
    x = x.float()
    if not _check_device(x, "sosfilt_rows"):
        return sosfilt_rows_ref(sos, x)
    lib = _lib()
    t_len = x.shape[1]
    x = _kernel_rows(x)
    rows = x.shape[0]
    length, chunks = chunk_plan(rows, x.shape[1])
    for s0 in range(0, sos.shape[1], MAX_SECTIONS):
        part = sos[:, s0:s0 + MAX_SECTIONS].contiguous()
        args = (rows, x.shape[1], part.shape[1], int(part.shape[0] != 1),
                length if chunks > 1 else 0)
        scratch = torch.empty(max(lib.aa_sosfilt_scratch_bytes(*args), 0), dtype=torch.uint8,
                              device=x.device)
        y = torch.empty_like(x)
        err = lib.aa_sosfilt(x.data_ptr(), part.data_ptr(), y.data_ptr(),
                             scratch.data_ptr() if chunks > 1 else None, *args, _stream(x))
        if err != 0:
            raise RuntimeError(f"sosfilt kernel launch failed: CUDA error {err}")
        launches["sosfilt"] += 1
        cuda_launches["sosfilt"] += 3 if chunks > 1 else 1
        x = y
    return x[:, :t_len]


# ------------------------------------------------------------ R2 envelope ---

def envelope_ref(x: torch.Tensor, a_att: float, a_rel: float) -> torch.Tensor:
    """Plain twin of R2, a step at a time: env = c env + (1 - c) |x| with
    c = a_att where |x| > env, else a_rel, from env = 0."""
    level = x.float().abs()
    att = torch.tensor(a_att, dtype=torch.float32)
    rel = torch.tensor(a_rel, dtype=torch.float32)
    env = torch.zeros_like(level[..., 0])
    out = torch.empty_like(level)
    for t in range(level.shape[-1]):
        l = level[..., t]
        coeff = torch.where(l > env, att, rel)
        env = coeff * env + (1 - coeff) * l
        out[..., t] = env
    return out


def envelope_blocks(chunk_len: int, chunks: int) -> tuple[bool, int] | None:
    """How R2's chunked route runs C chunks of L: (resident, warps a block),
    a cluster of at most ENV_MAX_CLUSTER blocks a row. Resident (each warp's
    32 chunks held in shared memory for every round) with the fewest warps
    that keep the cluster within ENV_MAX_CLUSTER blocks, where they fit
    ENV_SMEM_BYTES; else streamed from L2 through a tile a warp, at most
    ENV_STREAM_WARPS warps; None where neither fits."""
    warps = -(-chunks // (32 * ENV_MAX_CLUSTER))
    if warps <= ENV_WARPS and 32 * warps * (chunk_len + 4) * 4 <= ENV_SMEM_BYTES:
        return True, warps
    warps = min(ENV_STREAM_WARPS, -(-chunks // 32))
    if chunks <= 32 * warps * ENV_MAX_CLUSTER and warps * ENV_TILE_BYTES <= ENV_SMEM_BYTES:
        return False, warps
    return None


def envelope_plan(rows: int, t_len: int) -> tuple[int, int]:
    """R2's chunk length L and chunk count C for (rows, t_len), t_len as the
    kernel takes it (a multiple of 4). A row goes to one cluster, a thread
    a chunk, and every round runs each chunk's L dependent steps, so L is
    the least power of two from MIN_CHUNK with C <= MAX_ENV_CHUNKS, rows x
    C <= MAX_SEGMENTS and a launch that `envelope_blocks` can place. One
    chunk (L = t_len, C = 1: a thread a row) where t_len <= MIN_CHUNK or
    where the rows alone fill the card: a warp of chunks a row would then
    take more threads than MAX_SEGMENTS."""
    if t_len <= MIN_CHUNK or 32 * rows > MAX_SEGMENTS:
        return t_len, 1
    length = MIN_CHUNK
    while True:
        chunks = -(-t_len // length)
        if chunks <= MAX_ENV_CHUNKS and rows * chunks <= MAX_SEGMENTS \
                and envelope_blocks(length, chunks) is not None:
            break
        length *= 2
    return (length, chunks) if chunks > 1 else (t_len, 1)


def envelope(x: torch.Tensor, a_att: float, a_rel: float) -> torch.Tensor:
    """R2: the attack / release envelope of |x| for x (rows, T) f32. CPU
    tensors take the twin; CUDA tensors launch the kernel, time cut into
    chunks by `envelope_plan` and solved by Newton rounds on the device."""
    if x.dim() != 2:
        raise ValueError(f"envelope wants (rows, T), got {tuple(x.shape)}")
    x = x.float()
    if not _check_device(x, "envelope"):
        return envelope_ref(x, a_att, a_rel)
    t_len = x.shape[1]
    x = _kernel_rows(x)
    rows = x.shape[0]
    length, chunks = envelope_plan(rows, x.shape[1])
    resident, warps = envelope_blocks(length, chunks) if chunks > 1 else (False, 0)
    env = torch.empty_like(x)
    stats = torch.empty(2 * rows, dtype=torch.int32, device=x.device) if chunks > 1 else None
    err = _lib().aa_envelope(x.data_ptr(), env.data_ptr(),
                             stats.data_ptr() if stats is not None else None, rows, x.shape[1],
                             length if chunks > 1 else 0, warps, int(resident), float(a_att),
                             float(a_rel), _stream(x))
    if err != 0:
        raise RuntimeError(f"envelope kernel launch failed: CUDA error {err}")
    launches["envelope"] += 1
    cuda_launches["envelope"] += 1
    _envelope_last.clear()
    _envelope_last.update(shape=(rows, x.shape[1]), chunk_len=length, chunks=chunks,
                          resident=resident, warps=warps, stats=stats)
    return env[:, :t_len]


def envelope_stats() -> dict | None:
    """What the last `envelope` call on the card did: its chunk length and
    count, resident or streamed and its warps a block (`envelope_blocks`),
    and per row the carries its rounds ran and whether the repair
    (a serial walk from the first failing chunk) ran; None before any such
    call. Reading the round counts waits for the card: chip_smoke.py,
    profile_kernel.py and the CUDA tests call it, the effects never do."""
    if not _envelope_last:
        return None
    rows = _envelope_last["shape"][0]
    stats = _envelope_last["stats"]
    counts = stats.cpu().tolist() if stats is not None else [0] * (2 * rows)
    return {"chunk_len": _envelope_last["chunk_len"], "chunks": _envelope_last["chunks"],
            "resident": _envelope_last["resident"], "warps": _envelope_last["warps"],
            "rounds": counts[:rows], "repaired": [bool(r) for r in counts[rows:]],
            "cuda_launches_a_call": 1}


# --------------------------------------------------------- R3 freeverb_ir ---

def delay_sizes(sample_rate: int, spread: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The comb and allpass delay lengths at a rate and stereo spread,
    integer-rescaled from JUCE's 44.1 kHz tunings."""
    sr = int(sample_rate)
    combs = tuple(max(sr * (t + spread) // 44100, 1) for t in COMB_TUNINGS)
    allpasses = tuple(max(sr * (t + spread) // 44100, 1) for t in ALLPASS_TUNINGS)
    return combs, allpasses


def freeverb_irs_ref(feedback: torch.Tensor, damp: torch.Tensor, spreads, n: int,
                     sample_rate: int = 48000) -> torch.Tensor:
    """Plain twin of R3, a sample at a time, every impulse response of the
    batch at once: JUCE's comb
        out = buf[i % D]; last = out (1 - damp) + last damp;
        buf[i % D] = in + last feedback
    summed over the 8 combs, then the series allpass
        bufout = ap[i % d]; ap[i % d] = acc + bufout / 2; acc = bufout - acc."""
    feedback = feedback.float()
    damp = damp.float()
    r = feedback.shape[0]
    sizes = [delay_sizes(sample_rate, int(s)) for s in spreads]
    nb, na = len(COMB_TUNINGS), len(ALLPASS_TUNINGS)
    d_comb = max(max(c) for c, _ in sizes)
    d_ap = max(max(a) for _, a in sizes)
    comb_len = torch.tensor([c for c, _ in sizes])                # (R, 8)
    ap_len = torch.tensor([a for _, a in sizes])                  # (R, 4)
    buf = torch.zeros((r, nb, d_comb), dtype=torch.float32, device=feedback.device)
    apb = torch.zeros((r, na, d_ap), dtype=torch.float32, device=feedback.device)
    last = torch.zeros((r, nb), dtype=torch.float32, device=feedback.device)
    rows = torch.arange(r)[:, None]
    fb, dm = feedback[:, None], damp[:, None]
    ir = torch.empty((r, n), dtype=torch.float32, device=feedback.device)
    for i in range(n):
        idx = i % comb_len
        out = buf[rows, torch.arange(nb)[None, :], idx]           # (R, 8)
        last = out * (1.0 - dm) + last * dm
        buf[rows, torch.arange(nb)[None, :], idx] = (1.0 if i == 0 else 0.0) + last * fb
        acc = out[:, 0]
        for k in range(1, nb):
            acc = acc + out[:, k]
        for k in range(na):
            ai = (i % ap_len[:, k])
            bufout = apb[torch.arange(r), k, ai]
            apb[torch.arange(r), k, ai] = acc + bufout * 0.5
            acc = bufout - acc
        ir[:, i] = acc
    return ir


def freeverb_irs(feedback: torch.Tensor, damp: torch.Tensor, spreads, n: int,
                 sample_rate: int = 48000) -> torch.Tensor:
    """R3: the length-n impulse responses of Freeverb's wet path, one per
    entry of feedback (R,), damp (R,) and `spreads` (R Python ints: 0 for
    the left channel's tunings, 23 for the right's) -> (R, n) f32. CPU
    tensors take the twin; CUDA tensors launch the kernel, one block an
    impulse response (its damping chains as warp scans)."""
    spreads = [int(s) for s in spreads]
    if feedback.shape != damp.shape or feedback.dim() != 1 \
            or len(spreads) != feedback.shape[0] or min(spreads) < 0:
        raise ValueError("freeverb_irs: feedback, damp and spreads must be (R,)")
    if not _check_device(feedback, "freeverb_irs"):
        return freeverb_irs_ref(feedback, damp, spreads, n, sample_rate)
    lib = _lib()
    fb = feedback.float().contiguous()
    dm = damp.to(fb.device, torch.float32).contiguous()
    sp = torch.tensor(spreads, dtype=torch.int32, device=fb.device)
    ir = torch.empty((fb.shape[0], n), dtype=torch.float32, device=fb.device)
    err = lib.aa_freeverb_ir(fb.data_ptr(), dm.data_ptr(), sp.data_ptr(), ir.data_ptr(),
                             fb.shape[0], n, int(sample_rate), min(spreads), max(spreads),
                             _stream(fb))
    if err != 0:
        raise RuntimeError(f"freeverb_ir kernel launch failed at {sample_rate} Hz, spreads "
                           f"up to {max(spreads)}: CUDA error {err} (1: the delay lines "
                           "exceed a block's shared memory)")
    launches["freeverb_ir"] += 1
    return ir
