"""Mean ms a sampler step of `DVAEWrapper.decode`: the harness's
synchronised span around decode (and the audio's copy to the host) over
its steps."""


def read(run):
    rows = [r.out["decode_s"] / r.out["steps"] for r in run.records if r.error is None]
    return 1e3 * sum(rows) / len(rows) if rows else None
