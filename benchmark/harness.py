"""Run one cell of BENCHMARK.json once and print its result line.

Everything a cell needs is found by name: its configuration file (the
`file` of BENCHMARK.json's entry), its traffic mix
(`benchmark/traffic/<traffic>.json`, which names its generator module in
`benchmark/traffic/`), the system module its configuration names
(`benchmark/systems/<system>.py`) and a reader for each metric
(`benchmark/metrics/<name>.py`, else `benchmark/metrics/<name up to the
first dot>.py`). A reader's `read(run)` returns a number, or None when it
finds nothing to read; the metric is then left out of the line.

A run: set-up (the cell's kernels, weights made on the card from the seed,
a warm-up of the cell's shapes), `setup_s` from process start; the window
of `--seconds`, opened by a traced phase under `--trace 1`; the peak
memory; the program's state freed; the check against the plain reference;
the result as the last line of standard output, with the numbers compared
and their limits last, and again on standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_algebra_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: Path = ROOT):
    """(cell, configuration dict, traffic mix dict) of a workload name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, config, mix


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    """The `kind` ('end_to_end' or 'per_layer') metrics a cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """The `read` function of a metric's reader file."""
    for stem in (name, name.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH_DIR / 'metrics'}")


class Run:
    """What a reader reads: the cell, its records and window, the trace
    summary and the program's counters."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def completed(self):
        """Requests that ended without error inside the window."""
        return [r for r in self.records if r.error is None and r.t1 <= self.t_close]

    def traced(self):
        return [r for r in self.records if r.traced and r.error is None]

    def delta(self, key, before="c0", after="c1"):
        a, b = getattr(self, before), getattr(self, after)
        if a is None or b is None or key not in a:
            return None
        return b[key] - a[key]


class _CountingTracer:
    """The device tracer, with the program's counters read at both ends."""

    def __init__(self, system):
        from .trace import Tracer
        self.system, self.tracer = system, Tracer()
        self.before = self.after = None

    def start(self):
        self.before = self.system.counters()
        self.tracer.start()

    def stop(self) -> float:
        t = self.tracer.stop()
        self.after = self.system.counters()
        return t


def card_info() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
        return {"nvidia_smi": out}
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": None}


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda", variant: str | None = None,
             config: dict | None = None, mix: dict | None = None) -> dict:
    """One run of a cell; returns the result dict (without printing)."""
    import torch
    from .trace import summarize

    cell, cfg, mx = resolve(spec, workload)
    config, mix = config or cfg, mix or mx
    system_mod = importlib.import_module(f"benchmark.systems.{config['system']}")
    generator = importlib.import_module(f"benchmark.traffic.{mix['generator']}")
    system = system_mod.System(config, mix, seed, trace, device, variant)
    cuda = torch.device(device).type == "cuda"
    system.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    c0 = system.counters()
    tracer = _CountingTracer(system) if trace else None
    records, t_start, t_close, span = generator.run(system, mix, seed, seconds, tracer)
    if cuda:
        torch.cuda.synchronize()
    t_done = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    c1 = system.counters()
    summary = summarize(tracer.tracer.events, system.spans.rows) if trace else None
    if trace and summary["first_ns"] is not None \
            and abs(summary["first_ns"] - tracer.tracer.t_ns[0]) > 5e9:
        print("trace: the device's clock and the host spans' are apart; idle gaps "
              "are charged to no span", file=sys.stderr)
    run = Run(cell=cell, config=config, mix=mix, system=system, records=records,
              t_start=t_start, t_close=t_close, span=span, summary=summary, c0=c0, c1=c1,
              ct0=tracer.before if trace else None, ct1=tracer.after if trace else None,
              setup_s=setup_s, trace=trace)
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in metrics_of(spec, workload, kind):
        value = setup_s if m["name"] == "setup_s" else reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = [r for r in records if r.error is not None]
    for r in failed[:3]:
        print(f"request {r.client}/{r.index} failed:\n{r.error}", file=sys.stderr)
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    try:
        checks = system.check(records, seed)
    except Exception:                  # a check that cannot run is not correct
        traceback.print_exc()
        checks = {}
    print("requests: " + " ".join(f"{r.client}:{r.t1 - r.t0:.3f}" for r in records),
          file=sys.stderr)
    print(f"timing: setup {setup_s:.1f} s, window {t_close - t_start:.1f} s, in flight at the "
          f"close {max(t_done - t_close, 0.0):.1f} s, reading {t_check - t_done:.1f} s, "
          f"check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    answered = any(r.out is not None for r in records)
    correct = bool(checks) and not failed and answered and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = span[1] - span[0]
    result = {"correct": correct, "attempted": len(records), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    p = argparse.ArgumentParser(description="run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    spec = load_spec()
    cell, _, _ = resolve(spec, args.workload)
    import torch
    torch.set_num_threads(1)             # one process, few threads: no spinning pool
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_process)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"benchmark: the process loaded {found}; the port must run without them",
              file=sys.stderr)
        return 4
    print(f"card: {card_info()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
