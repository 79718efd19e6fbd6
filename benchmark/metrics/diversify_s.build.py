"""Mean seconds a build spends in the ``prepare/diversify`` phase, the search graph layer
(``ops/prune.py``): the program's own span, ``phase_times_`` of a
``profile=True`` build, which synchronises the device at the phase's edges,
so the span holds the phase's device work."""


def read(run):
    if not run.builds or not run.phases.get("prepare/diversify"):
        return None
    return run.phases["prepare/diversify"] / run.builds
