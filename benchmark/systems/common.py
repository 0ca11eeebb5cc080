"""Helpers shared by the systems: seeded inputs on the device, the distance
the checks compare, and the harness's own host spans."""
from __future__ import annotations

import contextlib
import math
import threading
import time

import torch


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS of a - b over the RMS of b (the reference), in f64."""
    a, b = a.double(), b.double()
    return float(((a - b).square().mean() / b.square().mean().clamp_min(1e-30)).sqrt())


def gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_audio(seed: int, batch: int, channels: int, samples: int, device,
               sample_rate: int = 48000) -> torch.Tensor:
    """(batch, channels, samples) f32 music-like test audio made on the
    device: per chunk six partials between 55 and 3,520 Hz with their own
    amplitudes, phases and a slow tremolo, the channels slightly detuned,
    under a -40 dB noise floor; peak about 0.6."""
    g = gen(seed, device)
    k = 6
    freq = 55.0 * torch.pow(2.0, 6.0 * torch.rand((batch, 1, k, 1), generator=g, device=device))
    detune = 1.0 + 0.002 * torch.randn((batch, channels, k, 1), generator=g, device=device)
    amp = 0.1 * torch.rand((batch, 1, k, 1), generator=g, device=device) + 0.02
    phase = 2 * math.pi * torch.rand((batch, channels, k, 1), generator=g, device=device)
    trem = 0.5 + 4.0 * torch.rand((batch, 1, k, 1), generator=g, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    env = 0.75 + 0.25 * torch.sin(2 * math.pi * trem * t)
    tone = (amp * env * torch.sin(2 * math.pi * freq * detune * t + phase)).sum(dim=2)
    return tone + 0.01 * torch.randn((batch, channels, samples), generator=g, device=device)


def unit_embeddings(seed: int, n: int, dim: int, device="cpu") -> torch.Tensor:
    """(n, 1, dim) unit vectors (CLAP embeddings' shape and norm), f32; on
    the host by default, as a client holds them."""
    e = torch.randn((n, 1, dim), generator=gen(seed, device), device=device)
    return e / e.norm(dim=-1, keepdim=True)


class HostSpans:
    """The harness's own host spans, (name, start ns, end ns) on the wall
    clock (time.time_ns, the clock of the profiler's events), so a trace's
    idle gaps can be charged to what the host was doing."""

    def __init__(self):
        self.rows = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str, record: dict | None = None, sync: bool = False):
        """Time the body into `record[name + '_s']` (seconds) and the span
        list; with `sync` the card is synchronised at both ends, so the span
        holds the body's device work."""
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.time_ns()
        try:
            yield
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.rows.append((name, t0, t1))
            if record is not None:
                record[f"{name}_s"] = record.get(f"{name}_s", 0.0) + (t1 - t0) * 1e-9


class BranchRecorder:
    """One ResConvBlock of the measured UNet watched through two forward
    hooks: armed with (call, row), they keep that row of the block's input
    and of its conv branch (conv5, GroupNorm(1) + GELU, conv5: the input of
    the block's GroupNorm_1) at that call of the unit (a sampler step), so
    the reference can run the branch on the program's own input. Unarmed,
    the hooks only return."""

    def __init__(self, block: torch.nn.Module):
        self.handles = (block.register_forward_hook(self._block, with_kwargs=True),
                        block.GroupNorm_1.register_forward_hook(self._branch, with_kwargs=True))
        self.armed = None
        self.calls = 0
        self.got = {}

    def arm(self, call: int, row: int) -> None:
        self.armed, self.calls, self.got = (call, row), 0, {}

    def _keep(self, key, t):
        if isinstance(t, tuple):              # the split skip join of an up stack
            t = torch.cat(t, dim=1)
        r = self.armed[1]
        self.got[key] = t[r:r + 1].detach().clone()

    def _branch(self, module, args, kwargs, out):
        if self.armed is not None and self.calls == self.armed[0]:
            self._keep("h", args[0])

    def _block(self, module, args, kwargs, out):
        if self.armed is None:
            return
        if self.calls == self.armed[0]:
            self._keep("x", args[0] if args else kwargs["x"])
        self.calls += 1

    def take(self):
        """(block input, branch output, step) on the host, or None;
        disarms. Call it once the unit's result is on its way to the host."""
        got, step = self.got, self.armed[0] if self.armed else None
        self.armed, self.got = None, {}
        if "x" not in got or "h" not in got:
            return None
        return got["x"].cpu(), got["h"].cpu(), step


def reference_mode():
    """The reference's precision: full f32 products (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def branch_ref(P, name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference of a ResConvBlock's conv branch on input x."""
    from ..reference.nn import conv1d, gn1_gelu
    h = conv1d(P, f"{name}.Conv1d_0", x)
    return conv1d(P, f"{name}.Conv1d_1", gn1_gelu(P, f"{name}.GroupNorm_0", h, gelu=True))
