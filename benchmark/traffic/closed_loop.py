"""The general traffic generator: `clients` callers in a closed loop.

Each client sends its next request only when its previous answer came
back, until the window closes (client 0 runs in the harness's own thread,
where the set-up warmed the program up; the others in threads); a request
in flight at the close runs to its end and is recorded, but counts in no
rate. Request k of client c
carries the seed `seed_of(run seed, c, k)`, so one run seed gives every
client the same sequence of inputs whatever the timing. With a trace, the
window opens with a traced phase: each client sends `trace_requests`
requests and all wait at a barrier, so the profiler covers whole requests
(and, under a micro-batcher, whole shared calls); then the loop goes on
untraced to the close.

A mix file (`benchmark/traffic/<name>.json`) names this generator and
gives `clients`, `trace_requests` and the `request` parameters that the
configuration's system turns into calls.
"""
from __future__ import annotations

import threading
import time
import traceback

from ..weights import seed_of


class Record:
    """One request: who sent it, its seed, when it started and ended (host
    clock), whether it raised, and what the system kept for the check."""

    __slots__ = ("client", "index", "seed", "t0", "t1", "error", "out", "traced")

    def __init__(self, client, index, seed, traced):
        self.client, self.index, self.seed, self.traced = client, index, seed, traced
        self.t0 = self.t1 = None
        self.error = None
        self.out = None


def _call(system, params, rec):
    rec.t0 = time.perf_counter()
    try:
        rec.out = system.call(params, rec.seed, rec.client)
    except Exception:                  # a request that raises has failed
        rec.error = traceback.format_exc(limit=8)
    rec.t1 = time.perf_counter()


def run(system, mix: dict, run_seed: int, seconds: float, tracer=None,
        join_timeout: float = 180.0):
    """Drive `system.call(params, seed, client)` and return (records,
    window start, window end, traced span (t0, t1) or None)."""
    clients = int(mix["clients"])
    params = mix["request"]
    records: list[Record] = []
    lock = threading.Lock()
    counters = [0] * clients

    def next_record(c, traced):
        rec = Record(c, counters[c], seed_of(run_seed, c, counters[c]), traced)
        counters[c] += 1
        with lock:
            records.append(rec)
        return rec

    def traced_phase(c):
        for _ in range(int(mix.get("trace_requests", 1))):
            _call(system, params, next_record(c, True))

    def in_clients(target, timeout):
        """Run target(c) for every client: client 0 in this thread (the one
        that made the set-up and its warm-up), the others in threads."""
        threads = [threading.Thread(target=target, args=(c,), daemon=True)
                   for c in range(1, clients)]
        for th in threads:
            th.start()
        target(0)
        for th in threads:
            th.join(timeout)
        if any(th.is_alive() for th in threads):
            raise RuntimeError("a client did not come back within the join timeout")

    t_start = time.perf_counter()
    span = None
    if tracer is not None:
        tracer.start()
        t_tr = time.perf_counter()
        in_clients(traced_phase, join_timeout)
        span = (t_tr, tracer.stop())
    t_close = t_start + seconds

    def loop(c):
        while time.perf_counter() < t_close:
            _call(system, params, next_record(c, False))

    in_clients(loop, seconds + join_timeout)
    return records, t_start, t_close, span
