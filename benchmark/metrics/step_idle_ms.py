"""Idle ms of the card a sampler step in the traced jobs: the gaps that
trace.summarize charged to a `vddim.step` span or to a `unet.stack_NNN`
span under it (the innermost span open at a gap's start), over the traced
steps. Silent where the run holds no program spans or no device trace."""


def read(run):
    steps = sum(r["name"] == "vddim.step" for r in getattr(run, "program_spans", None) or ())
    if not steps or not run.summary["by_kind"]:
        return None
    idle = sum(s for key, s in run.summary["idle_by_host"].items()
               if key.split("/")[0] == "vddim.step" or key.startswith("unet.stack_"))
    return 1e3 * idle / steps
