"""Mean seconds a build spends in the ``descent/init`` span, the descent
layer (``ops/nndescent.py::nn_descent``): the forest init (the leaf kernel or
the gather init) and the random fill. The span's device stretch, a build of
the window."""

from benchmark import spans


def read(run):
    return spans.per_build(run, "descent/init")
