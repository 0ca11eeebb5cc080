"""The control of a cell: the same run with the program's own lower
precision switched on (`variant="control"`: the turbo int8 routes of
DVAEWrapper and CLAPDAE, which take the place of bf16 on the decode's
convolutions), whose numbers have to fail the cell's limits.

    python3 -m benchmark.control --workload NAME --seeds 11 12 13 [--seconds 5]

One process a seed (set-up included), a short window at the cell's own
load, the check, one JSON line a seed with the numbers compared. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def one(workload: str, seed: int, seconds: float) -> dict:
    from .harness import load_spec, run_cell
    t0 = time.perf_counter()
    r = run_cell(load_spec(), workload, seed, seconds, False, t0, variant="control")
    return {"workload": workload, "seed": seed, "variant": "control",
            "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
            "checks": r["checks"], "device": r["device"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        import torch
        torch.set_num_threads(1)         # as the benchmark's own runs
        print(json.dumps(one(args.workload, args.seeds[0], args.seconds)), flush=True)
        return 0
    for seed in args.seeds:
        out = subprocess.run([sys.executable, "-m", "benchmark.control", "--one",
                              "--workload", args.workload, "--seeds", str(seed),
                              "--seconds", str(args.seconds)],
                             capture_output=True, text=True, timeout=900)
        line = out.stdout.strip().splitlines()[-1:] or ["{}"]
        print(line[0] if out.returncode == 0 else json.dumps(
            {"workload": args.workload, "seed": seed, "rc": out.returncode,
             "stderr": out.stderr[-2000:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
