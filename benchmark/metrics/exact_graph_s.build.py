"""Mean seconds a build spends in the ``graph/exact`` span, the wide sparse
layer (``models/nndescent.py::NNDescent._exact_graph`` with
``ops/sparse_ell.py``): each row's sketch candidates reranked by the exact
metric from the padded ELL rows, when the harness reads
``neighbor_graph``. The span's device stretch, a build of the window."""

from benchmark import spans


def read(run):
    return spans.per_build(run, "graph/exact")
