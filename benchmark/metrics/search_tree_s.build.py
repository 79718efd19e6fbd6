"""Mean seconds a build spends in the ``prepare/search_tree`` phase, the search tree layer
(``ops/rp_trees.py::flatten_search_tree``): the program's own span, ``phase_times_`` of a
``profile=True`` build, which synchronises the device at the phase's edges,
so the span holds the phase's device work."""


def read(run):
    if not run.builds or not run.phases.get("prepare/search_tree"):
        return None
    return run.phases["prepare/search_tree"] / run.builds
