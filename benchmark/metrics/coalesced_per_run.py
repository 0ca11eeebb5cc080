"""Requests a shared generate served: the micro-batcher's own counters
(`coalesced_requests / batched_runs`) over the run."""


def read(run):
    runs = run.delta("batched_runs")
    return run.delta("coalesced_requests") / runs if runs else None
