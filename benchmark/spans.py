"""The program's spans in a cell's traced jobs, and what recording them
costs. The harness does not turn audio_algebra_torch.tracing on; this
does what a traced harness run would do with it, beside the harness:

    python3 -m benchmark.spans --workload destructo_b16 --seed N [--pairs 3] [--jobs 4]
    python3 -m benchmark.spans --workload mirage_serve_c4 --seed N --pairs 0

Set-up as a harness run, then a traced phase: the mix's traced requests
under the device tracer with the spans on, the program's rows drained
after the tracer's synchronise and handed to trace.summarize with the
harness's own spans, so each idle gap goes to the innermost span open at
its start; the idle seconds by span. Then, per system:

- Destructo: on that Run the cell's per-layer readers and the span
  readers (`SPAN_METRICS`); the lead from each `dvae.encode` span's host
  start to the first device operation after it (the harness synchronises
  before each traced job, so the card is idle when the span opens; it
  should lie in `LEAD_MS`); the share of the idle time inside the
  harness's `decode` span that a program span took.
- MIRAGE (`MIRAGE_CELLS`: the cells PERF.md keeps out of BENCHMARK.json,
  on their files under benchmark/): each request's queue wait
  (`serve.queue`), host seconds (`serve.request`) and WAV encode
  (`serve.wav`), and `/health`'s `queue_wait_s` over the phase; each
  shared generate's device seconds (`serve.batch`, `clapdae.generate`,
  its stages `clapdae.inner` / `.outer` / `.ae_decode`) and the program's
  `last_stage_times` against the generate's wall seconds; the sampler
  steps' host enqueue ms against their device ms (`kdiff.step` inner,
  `vddim.step` outer), medians; the MIRAGE readers (`MIRAGE_METRICS`).

Then `--pairs` pairs of windows of `--jobs` requests from one client, the
spans off and on in turns (off, on, on, off, ...), each window's seconds
of audio a wall second; last, the check against the reference on the
traced requests. One JSON line at the end.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time
import traceback

from .harness import (FORBIDDEN, ROOT, Run, card_info, load_spec, metrics_of, reader,
                      resolve)
from .trace import Tracer, summarize
from .weights import seed_of

SPAN_METRICS = ("step_device_ms.destructo", "step_idle_ms.destructo",
                "encode_device_ms.destructo")
PROGRAM_DECODE = ("dvae.decode", "vddim.step", "unet.stack_")   # spans inside `decode`
LEAD_MS = (0.0, 5.0)
MIRAGE_CELLS = [
    {"name": "mirage_serve_c4", "config": "mirage_22s", "traffic": "mirage_clients4", "chips": 1},
    {"name": "mirage_single", "config": "mirage_22s", "traffic": "mirage_client1", "chips": 1}]
MIRAGE_METRICS = ("inner_step_ms", "outer_step_ms", "coalesced_per_run", "k5_roofline",
                  "idle_share", "mfu")
STAGES = ("clapdae.inner", "clapdae.outer", "clapdae.ae_decode")


def spec_with_mirage() -> dict:
    """BENCHMARK.json with the MIRAGE cells, on their files under benchmark/."""
    s = load_spec()
    s["configs"] = s["configs"] + [{"name": "mirage_22s",
                                    "file": "benchmark/configs/mirage_22s.json"}]
    s["workloads"] = s["workloads"] + MIRAGE_CELLS
    return s


class _SpanTracer:
    """The device tracer, with the program's spans on between its ends and
    the program's counters read at both."""

    def __init__(self, system, tracing):
        self.system, self.tracing, self.tracer = system, tracing, Tracer()
        self.before = self.after = self.rows = None

    def start(self):
        self.before = self.system.counters()
        self.tracer.start()
        self.tracing.enable()

    def stop(self) -> float:
        t = self.tracer.stop()                # after its synchronise
        self.tracing.disable()
        self.rows = self.tracing.drain()
        self.after = self.system.counters()
        return t


def encode_leads_ms(events, rows) -> list:
    """ms from each `dvae.encode` span's host start to the start of the
    first device operation not finished before it."""
    dev = sorted((s, e) for _, is_dev, s, e, ann in events if is_dev and not ann)
    leads = []
    for r in rows:
        if r["name"] == "dvae.encode":
            first = next((s for s, e in dev if e >= r["t0_ns"]), None)
            leads.append(None if first is None else (first - r["t0_ns"]) * 1e-6)
    return leads


def program_share(idle_by_host: dict) -> float | None:
    """The share of the idle seconds inside the harness's `decode` span
    that went to a program span (its own innermost spans)."""
    prog = sum(s for k, s in idle_by_host.items() if k.startswith(PROGRAM_DECODE))
    harness = sum(s for k, s in idle_by_host.items() if k.split("/")[0] == "decode")
    return prog / (prog + harness) if prog + harness > 0 else None


def _host_ms(rows, name) -> list:
    return [(r["t1_ns"] - r["t0_ns"]) * 1e-6 for r in rows if r["name"] == name]


def _device_ms(rows, name) -> list:
    return [r["device_ms"] for r in rows if r["name"] == name and r["device_ms"] is not None]


def _median(values):
    return statistics.median(values) if values else None


def mirage_report(rows, generates, queue_wait_s) -> dict:
    """What the serve, stage and step spans of a MIRAGE traced phase say:
    `rows` drained, `generates` the system's (t0, t1, rows, stage times,
    steps) a generate, `queue_wait_s` the micro-batcher counter's growth."""
    def seconds(name):
        return [ms * 1e-3 for ms in _device_ms(rows, name)]

    return {"queue_ms": _host_ms(rows, "serve.queue"), "queue_wait_s": queue_wait_s,
            "request_s": [ms * 1e-3 for ms in _host_ms(rows, "serve.request")],
            "wav_ms": _host_ms(rows, "serve.wav"),
            "batch_device_s": seconds("serve.batch"),
            "generate_device_s": seconds("clapdae.generate"),
            "stage_device_s": {name: sum(seconds(name)) for name in STAGES},
            "generates": [{"rows": n, "wall_s": t1 - t0, "stage_times": st,
                           "stages_over_wall": sum(st.values()) / (t1 - t0) if st else None}
                          for t0, t1, n, st, _ in generates],
            "step_ms": {name: {"n": len(_host_ms(rows, name)),
                               "host_median": _median(_host_ms(rows, name)),
                               "device_median": _median(_device_ms(rows, name))}
                        for name in ("kdiff.step", "vddim.step")}}


def _window(system, params, seeds, on: bool, tracing) -> dict:
    if on:
        tracing.enable()
    audio_s, t0 = 0.0, time.perf_counter()
    for s in seeds:
        audio_s += system.call(params, s, 0)["audio_s"]     # ends in the audio's .cpu()
    wall = time.perf_counter() - t0
    tracing.disable()
    return {"on": on, "audio_per_s": audio_s / wall, "rows": len(tracing.drain())}


def measure(workload: str, seed: int, pairs: int, jobs: int, device: str = "cuda",
            config: dict | None = None, mix: dict | None = None) -> dict:
    import torch

    from audio_algebra_torch import tracing
    spec = spec_with_mirage()
    cell, cfg, mx = resolve(spec, workload)
    config, mix = config or cfg, mix or mx
    destructo = config["system"] == "dvae"
    system = importlib.import_module(f"benchmark.systems.{config['system']}").System(
        config, mix, seed, True, device)
    generator = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    system.setup()
    cuda = torch.device(device).type == "cuda"
    c0 = system.counters()
    waited0 = None if destructo else system.service.batcher.queue_wait_s
    tracer = _SpanTracer(system, tracing)
    records, t_start, t_close, span = generator.run(system, mix, seed, 0.0, tracer)
    rows = tracer.rows
    summary = summarize(tracer.tracer.events,
                        system.spans.rows + [(r["name"], r["t0_ns"], r["t1_ns"]) for r in rows])
    run = Run(cell=cell, config=config, mix=mix, system=system, records=records,
              t_start=t_start, t_close=t_close, span=span, summary=summary, c0=c0,
              c1=system.counters(), ct0=tracer.before, ct1=tracer.after, setup_s=None,
              trace=True, program_spans=rows)
    counts, idle = {}, {}
    for r in rows:
        key = "unet.stack_*" if r["name"].startswith("unet.stack_") else r["name"]
        counts[key] = counts.get(key, 0) + 1
    for key, sec in summary["idle_by_host"].items():
        idle[key.split("/")[0]] = idle.get(key.split("/")[0], 0.0) + sec
    if destructo:
        names = [m["name"] for m in metrics_of(spec, workload, "per_layer")] + list(SPAN_METRICS)
        leads = encode_leads_ms(tracer.tracer.events, rows)
        for lead in leads:
            if lead is None or not LEAD_MS[0] <= lead <= LEAD_MS[1]:
                print(f"trace: dvae.encode's first device operation came {lead} ms after "
                      f"its host start, outside {LEAD_MS} ms", file=sys.stderr)
        extra = {"encode_lead_ms": leads,
                 "decode_idle_to_program": program_share(summary["idle_by_host"])}
    else:
        names = list(MIRAGE_METRICS)
        extra = {"mirage": mirage_report(rows, system.generates,
                                         system.service.batcher.queue_wait_s - waited0)}
    metrics = {n: reader(n)(run) for n in names}

    system.trace = False                 # the windows run as an untraced harness run does
    params = mix["request"]
    windows = []
    for p in range(pairs):
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            seeds = [seed_of(seed, 101, len(windows), j) for j in range(jobs)]
            windows.append(_window(system, params, seeds, on, tracing))
    rate = {on: statistics.median(w["audio_per_s"] for w in windows if w["on"] == on)
            for on in (False, True)} if windows else None
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    failed = [r for r in records if r.error is not None]
    try:
        checks = system.check([r for r in records if r.error is None], seed)
    except Exception:                  # a check that cannot run is not correct
        traceback.print_exc()
        checks = {}
    return {"workload": workload, "seed": seed, "device": torch.cuda.get_device_name(0)
            if cuda else "cpu", "card": card_info() if cuda else None, "metrics": metrics,
            **extra, "idle_s": sum(idle.values()),
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "busy_s": summary["busy_s"], "window_s": span[1] - span[0],
            "breakdown": summary["breakdown"], "span_rows": counts,
            "failed": [r.error for r in failed][:1], "windows": windows,
            "on_over_off": rate[True] / rate[False] - 1.0 if rate else None,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "correct": bool(checks) and not failed and all(v <= lim for v, lim in
                                                           checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the program's spans in a cell's traced jobs")
    p.add_argument("--workload", default="destructo_b16")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--jobs", type=int, default=4)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    cell, _, _ = resolve(spec_with_mirage(), args.workload)
    import torch
    torch.set_num_threads(1)             # as a harness run
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"spans: needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 3
    result = measure(args.workload, args.seed, args.pairs, args.jobs)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"spans: the process loaded {found}; the port must run without them",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
