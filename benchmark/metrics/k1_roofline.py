"""K1's share of its roofline in the traced jobs: the sum of its launches'
least times (benchmark/counts/k1.py; the launches from the UNet's shapes,
held to the program's own launch counter) over its kernels' device time
(statistics and apply). Silent where the counts disagree or K5 ran."""
import sys

from benchmark.counts import k1


def read(run):
    done = run.traced()
    expected = [c for r in done for c in run.system.work(r.out)["k1"]]
    counted = run.delta("k1_launches", "ct0", "ct1")
    if not expected or counted != len(expected) or run.delta("k5_launches", "ct0", "ct1"):
        print(f"k1_roofline: launches expected {len(expected)}, counted {counted}",
              file=sys.stderr)
        return None
    esize = 2 if "bfloat16" in str(run.system.work(done[0].out)["dtype"]) else 4
    bound = sum(k1.bound_s(shape, esize, gelu, res) for shape, gelu, res in expected)
    names = run.summary["by_name"]
    sec = sum(v[0] for n, v in names.items() if "gn_apply_kernel" in n or "gn_stats_kernel" in n)
    return 100.0 * bound / sec if sec else None
