"""K5's share of its roofline in the traced generates: the sum of its
launches' least times (benchmark/counts/k5.py; the launches from the CFG
UNet's shapes, held to the program's own launch counter) over its
kernels' device time. Silent where the counts disagree or where a launch
took the two-pass route (whose statistics kernel K1 shares)."""
import sys

from benchmark.counts import k5


def read(run):
    gens = [g for g in run.system.generates if run.span[0] <= g[0] <= run.span[1]]
    expected = [c for g in gens for c in run.system.k5_launches(g[2], g[4]["demo_steps"])]
    counted = run.delta("k5_launches", "ct0", "ct1")
    two_pass = run.delta("k5_two_pass_launches", "ct0", "ct1")
    if not expected or counted != len(expected) or two_pass:
        print(f"k5_roofline: launches expected {len(expected)}, counted {counted}, "
              f"two-pass {two_pass}", file=sys.stderr)
        return None
    esize = 2 if run.system.dtype.itemsize == 2 else 4
    bound = sum(k5.bound_s(shape, esize, film) for shape, film in expected)
    names = run.summary["by_name"]
    sec = sum(v[0] for n, v in names.items()
              if "ggn_cluster_kernel" in n or "ggn_apply_kernel" in n)
    return 100.0 * bound / sec if sec else None
