"""Mean ms a step of the inner stage (DPM++(2M) over the CFG UNet): the
program's own stage span (`CLAPDAE.last_stage_times['inner_s']`, asked
for in traced runs) over the inner steps, each generate alike."""


def read(run):
    rows = [g[3]["inner_s"] / g[4]["demo_steps"] for g in run.system.generates
            if "inner_s" in g[3]]
    return 1e3 * sum(rows) / len(rows) if rows else None
