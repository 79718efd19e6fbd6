"""Mean milliseconds a query spends in the ``query/seed`` span, the beam
search layer (``models/search.py::search_block``): the search tree's
descent and the beam's seeding passes. The span's device stretch, a query of
the window."""

from benchmark import spans


def read(run):
    return spans.ms_per_query(run, "query/seed")
