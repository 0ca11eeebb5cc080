"""Spans of the port: named host intervals at its layer boundaries, timed
on the card by CUDA events where asked, nested per thread and tagged with
the request ids in force.

    from audio_algebra_torch import tracing
    tracing.enable()
    with tracing.request(7):
        audio = wrapper.decode(z).cpu()   # dvae.decode > vddim.step > unet.stack_NNN
    tracing.disable()
    rows = tracing.drain()                # after the .cpu(): the caller's synchronise

Off (the default), `span` reads one module flag and returns the shared
no-op context `NULL`: no row, no event, no clock read, no allocation. On,
each span keeps a row: its name, host start and end in ns (`time.time_ns`,
the clock of torch.profiler's device events), its parent (the innermost
span open in the same thread), the request ids in force (`request`) and
its sampler step, if any. A span given a CUDA `device` also records a
timing event on that device's current stream at each end; a span never
synchronises, never reads a device tensor and never waits on an event.
`drain` turns each event pair into `device_ms` (`Event.elapsed_time`), so
it belongs after a synchronise that covers the spans' work. A span's host
duration is the host's enqueue time for its body.

One rule besides the switch: a caller that reads its own spans hands
`span` a list as `into`, and the span is recorded, its row appended there,
whether tracing is on or off (CLAPDAE's `stage_times`); it is kept for
`drain` only while tracing is on.

The span names of the port, and what reads each (PERF.md, section 3):
`dvae.encode`, `dvae.decode`, `clapdae.generate`, `clapdae.inner`,
`clapdae.outer`, `clapdae.ae_decode`, `vddim.step`, `kdiff.step`,
`unet.stack_NNN`, `serve.request`, `serve.queue`, `serve.batch`,
`serve.wav`.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time

import torch

__all__ = ["NULL", "Row", "disable", "drain", "enable", "record", "request", "span"]

_on = False
_rows: list = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_requests: contextvars.ContextVar = contextvars.ContextVar("aa_tracing_requests", default=())


class _Null:
    """The context `span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Row:
    """One span: host start and end (ns), parent row id, request ids, the
    sampler step, and the CUDA events of a device span."""

    __slots__ = ("id", "name", "parent", "t0_ns", "t1_ns", "requests", "step", "events")

    def __init__(self, name: str, step=None, requests: tuple = ()):
        self.id, self.name, self.step = next(_ids), name, step
        self.requests = requests or _requests.get()
        self.parent = self.t0_ns = self.t1_ns = None
        self.events = None

    def device_ms(self):
        """The device interval between the span's two events, in ms; None
        for a host span. The events must have completed."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])

    def seconds(self) -> float:
        """The device interval where the span has one, else the host's."""
        ms = self.device_ms()
        return (self.t1_ns - self.t0_ns) * 1e-9 if ms is None else ms * 1e-3

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns, "requests": list(self.requests),
                "step": self.step, "device_ms": self.device_ms()}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stream(device):
    """The current CUDA stream of a tensor's or device's card; None off it."""
    if device is None:
        return None
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def _event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("row", "stream", "into")

    def __init__(self, name, device, step, into):
        self.row, self.stream, self.into = Row(name, step), _stream(device), into

    def __enter__(self) -> Row:
        row, stack = self.row, _stack()
        row.parent = stack[-1].id if stack else None
        stack.append(row)
        row.t0_ns = time.time_ns()
        if self.stream is not None:
            row.events = (_event(self.stream), None)
        return row

    def __exit__(self, *exc):
        row = self.row
        if self.stream is not None:
            row.events = (row.events[0], _event(self.stream))
        row.t1_ns = time.time_ns()
        _stack().pop()
        if self.into is not None:
            self.into.append(row)
        if _on:
            with _lock:
                _rows.append(row)
        return False


def span(name: str, device=None, step=None, into=None):
    """A context that records the span `name` while tracing is on, else
    `NULL`. `device` (a tensor or torch.device) on a card adds the device
    interval; `step` is a sampler's step index, kept with the row. With a
    list `into`, the span is recorded whatever the switch and its `Row`
    appended there (the caller reads `Row.seconds` after its synchronise)."""
    if not _on and into is None:
        return NULL
    return _Span(name, device, step, into)


def record(name: str, t0_ns: int, t1_ns: int, requests=()) -> None:
    """Keep a host span whose ends were read elsewhere (a wait that starts
    in one thread and ends in another) while tracing is on; `requests`
    defaults to the ids in force."""
    if not _on:
        return
    row = Row(name, None, tuple(requests))
    row.t0_ns, row.t1_ns = t0_ns, t1_ns
    with _lock:
        _rows.append(row)


class request:
    """Tag the spans opened inside with request ids (one id or several);
    a context variable, so it holds in the thread (or task) that enters it."""

    __slots__ = ("ids", "token")

    def __init__(self, ids):
        self.ids = tuple(ids) if isinstance(ids, (list, tuple)) else (ids,)

    def __enter__(self):
        self.token = _requests.set(self.ids)
        return self.ids

    def __exit__(self, *exc):
        _requests.reset(self.token)
        return False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list:
    """The rows kept so far, as dicts (with `device_ms` of device spans),
    and clear them. Call it after a synchronise that covers their work."""
    with _lock:
        rows = _rows[:]
        _rows.clear()
    return [r.as_dict() for r in rows]
