"""Operations of the traced requests (benchmark/counts, from the
configuration's shapes) over the traced span's wall time, as a share of
the card's bf16 peak."""
from benchmark.counts.peaks import BF16_FLOPS_PER_S


def read(run):
    done = run.traced()
    window = run.span[1] - run.span[0]
    if not done or window <= 0:
        return None
    flops = sum(run.system.work(r.out)["flops"] for r in done)
    return 100.0 * flops / (window * BF16_FLOPS_PER_S)
