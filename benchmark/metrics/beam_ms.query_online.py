"""Mean milliseconds a query spends in the ``query/beam`` span, the beam search
layer (``models/search.py::search_block``): the step loop, one host sync a
step. The span's device stretch, a query of the window."""

from benchmark import spans


def read(run):
    return spans.ms_per_query(run, "query/beam")
