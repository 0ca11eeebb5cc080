"""Mean device ms of `DVAEWrapper.encode` in the traced jobs: the program's
`dvae.encode` spans, timed on the card by CUDA events, no synchronise.
Silent where the run holds no program spans."""


def read(run):
    ms = [r["device_ms"] for r in getattr(run, "program_spans", None) or ()
          if r["name"] == "dvae.encode" and r["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
