"""Share of the traced span in which no kernel or copy ran on the card."""


def read(run):
    window = run.span[1] - run.span[0]
    return 100.0 * (1.0 - run.summary["busy_s"] / window) if window > 0 else None
