"""Mean seconds a build spends in the ``forest`` phase, the init forest layer
(``ops/rp_trees.py::build_forest_orders``): the program's own span, ``phase_times_`` of a
``profile=True`` build, which synchronises the device at the phase's edges,
so the span holds the phase's device work."""


def read(run):
    if not run.builds or not run.phases.get("forest"):
        return None
    return run.phases["forest"] / run.builds
