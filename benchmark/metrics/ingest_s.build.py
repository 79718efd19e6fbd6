"""Mean seconds a build spends in the program's ``ingest`` span, the index API
layer (``models/nndescent.py``, ``NNDescent._ingest``): the rows' sparse
routing, dtype conversion and finite check on the host, and their copy to
the device. The span's device stretch, a build of the window."""

from benchmark import spans


def read(run):
    return spans.per_build(run, "ingest")
