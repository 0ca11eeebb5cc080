"""Median device ms of a sampler step in the traced jobs: the program's
`vddim.step` spans (audio_algebra_torch.tracing), each timed on the card by
a CUDA event at either end, so the card's gaps inside a step count and no
synchronise does. Silent where the run holds no program spans."""
import statistics


def read(run):
    ms = [r["device_ms"] for r in getattr(run, "program_spans", None) or ()
          if r["name"] == "vddim.step" and r["device_ms"] is not None]
    return statistics.median(ms) if ms else None
