"""Share of the rows the builds' global join joined whose candidate distances
the ``join_dists`` CUDA kernel measured (``ops/nndescent.py::
_descent_iteration``): the ``kernel_rows`` counter of the ``descent/join``
spans over their ``rows`` counter. A program whose spans carry no
``kernel_rows`` gives no reading."""

from benchmark import spans


def read(run):
    found = spans.in_window(run, "descent/join")
    if not any("kernel_rows" in s.counts for s in found):
        return None
    rows = spans.count(run, "descent/join", "rows")
    return spans.count(run, "descent/join", "kernel_rows") / rows if rows else None
