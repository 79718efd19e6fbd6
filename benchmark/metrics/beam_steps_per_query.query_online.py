"""Beam steps a query: the ``steps`` counter of the ``query/beam`` spans
(``models/search.py::search_block``) over their ``queries`` counter. A batch
steps in lockstep, so a step of a batch of b counts 1/b a query."""

from benchmark import spans


def read(run):
    steps = spans.count(run, "query/beam", "steps")
    queries = spans.count(run, "query/beam", "queries")
    return steps / queries if steps is not None and queries else None
