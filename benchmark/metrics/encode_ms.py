"""Mean ms of `DVAEWrapper.encode` a job: the harness's span around the
call, the card synchronised at both ends (traced runs only)."""


def read(run):
    spans = [r.out["encode_s"] for r in run.records if r.error is None]
    return 1e3 * sum(spans) / len(spans) if spans else None
