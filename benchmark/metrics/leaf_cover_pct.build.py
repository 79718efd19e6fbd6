"""Share of the rows that the leaf kernel measures in the builds' forest init
(``ops/nndescent.py::kernel_forest_init``): 100 x the ``leaf_covered``
counter of the ``descent/init`` spans over their ``leaf_rows`` counter.
Each tree's rows past their leaf's first 64 (the kernel's tile) get only
the random fill. A program whose spans carry no ``leaf_rows``, or a build
that takes the gather init, gives no reading."""

from benchmark import spans


def read(run):
    found = spans.in_window(run, "descent/init")
    if not any("leaf_rows" in s.counts for s in found):
        return None
    rows = spans.count(run, "descent/init", "leaf_rows")
    return 100.0 * spans.count(run, "descent/init", "leaf_covered") / rows if rows else None
