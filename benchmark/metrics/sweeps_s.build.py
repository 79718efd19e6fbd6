"""Mean seconds a build spends in the ``descent/sweeps`` span, the descent
layer (``ops/nndescent.py::nn_descent``): the locality phases, each a tree
order's ``window_topm`` sweep and merge. None below 400,000 rows, where
``locality="auto"`` runs no phases. The span's device stretch, a build of
the window."""

from benchmark import spans


def read(run):
    return spans.per_build(run, "descent/sweeps")
