"""Share of the window's queries that the beam search layer
(``models/search.py::search_block``) ran on its CUDA kernels: the
``kernel_queries`` counter of the ``query/beam`` spans over their ``queries``
counter. A program whose spans carry no ``kernel_queries`` gives no reading."""

from benchmark import spans


def read(run):
    found = spans.in_window(run, "query/beam")
    if not any("kernel_queries" in s.counts for s in found):
        return None
    queries = spans.count(run, "query/beam", "queries")
    return spans.count(run, "query/beam", "kernel_queries") / queries if queries else None
