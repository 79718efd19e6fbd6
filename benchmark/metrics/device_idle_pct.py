"""Share of the traced window in which no device operation (kernel, copy or
set) runs: 100 * (1 - union of their intervals / window)."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
