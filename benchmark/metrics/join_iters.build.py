"""Global join iterations a build runs: the ``iters`` counter of the
``descent/join`` span (``ops/nndescent.py::descent_loop``), a build of the
window."""

from benchmark import spans


def read(run):
    iters = spans.count(run, "descent/join", "iters")
    return iters / run.builds if iters is not None and run.builds else None
