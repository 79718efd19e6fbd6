"""Host waits for the device (stream, device and event synchronisations,
synchronous copies) in the traced window per query answered."""

from benchmark.trace import SYNC_CALLS


def read(run):
    if not run.trace or not run.queries:
        return None
    syncs = run.trace.count_calls(SYNC_CALLS)
    return syncs / run.queries
