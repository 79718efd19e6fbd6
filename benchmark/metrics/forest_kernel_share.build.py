"""Share of the keys the builds' init forest found the run bounds of whose
bounds the ``run_bounds`` CUDA kernel found (``ops/rp_trees.py::
_fast_forest_orders``): the ``kernel_keys`` counter of the ``forest/levels``
spans over their ``keys`` counter. A program whose spans carry no
``kernel_keys`` gives no reading."""

from benchmark import spans


def read(run):
    found = spans.in_window(run, "forest/levels")
    if not any("kernel_keys" in s.counts for s in found):
        return None
    keys = spans.count(run, "forest/levels", "keys")
    return spans.count(run, "forest/levels", "kernel_keys") / keys if keys else None
