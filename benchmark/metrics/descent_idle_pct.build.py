"""Share of the ``phase/descent`` spans' host intervals in which no device
operation runs: 100 x (1 - the union of the trace's kernel, copy and set
intervals inside them / their length). The descent layer's host-bound share."""

from benchmark import spans


def read(run):
    return spans.idle_pct_inside(run, "phase/descent")
