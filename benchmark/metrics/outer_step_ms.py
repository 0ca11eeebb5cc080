"""Mean ms a step of the outer stage (v-DDIM over the stage-1 UNet, all
of a generate's micro-batches): `last_stage_times['outer_s']` over the
outer steps."""


def read(run):
    rows = [g[3]["outer_s"] / g[4]["outer_steps"] for g in run.system.generates
            if "outer_s" in g[3]]
    return 1e3 * sum(rows) / len(rows) if rows else None
