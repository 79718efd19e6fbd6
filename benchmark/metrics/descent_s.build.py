"""Mean seconds a build spends in the ``descent`` phase, the descent layer
(``ops/nndescent.py with the kernels it launches``): the program's own span, ``phase_times_`` of a
``profile=True`` build, which synchronises the device at the phase's edges,
so the span holds the phase's device work."""


def read(run):
    if not run.builds or not run.phases.get("descent"):
        return None
    return run.phases["descent"] / run.builds
