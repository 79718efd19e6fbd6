"""Mean seconds a build spends in the ``descent/join`` span, the descent layer
(``ops/nndescent.py::descent_loop``): the global join iterations with their
delta exit. The span's device stretch, a build of the window."""

from benchmark import spans


def read(run):
    return spans.per_build(run, "descent/join")
