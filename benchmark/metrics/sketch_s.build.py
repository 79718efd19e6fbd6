"""Mean seconds a build spends in the ``ingest/sketch`` span, the wide
sparse layer (``models/nndescent.py::NNDescent._route_wide_sparse`` with
``ops/sketch.py``): the packing of the CSR rows into padded ELL rows and
their feature-hash sketch, both on the host. The span's device stretch (the
device waits on the host meanwhile), a build of the window."""

from benchmark import spans


def read(run):
    return spans.per_build(run, "ingest/sketch")
