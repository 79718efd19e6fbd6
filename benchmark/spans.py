"""The program's own spans and counters (``pynndescent_torch.utils.profiling``)
in a traced run's window, and the sums the per-layer readers make of them.

The program records spans only while a ``torch.profiler`` session is active,
which the traced window is. A span's host interval is on ``time.time_ns()``,
the clock of the profiler's events, so the window's spans are those whose
host interval lies inside the trace's range ``[t0, t1]`` (give or take
``SLACK_NS``), and the device's intervals of the trace can be laid over them.
Seconds are the spans' device stretches (CUDA events at their edges,
unsynchronised). A program that records no spans of a name gives no reading,
and its readers return None.
"""

from __future__ import annotations

import numpy as np

from benchmark.trace import _union

# the profiler's timestamps and time.time_ns() agree to tens of microseconds
SLACK_NS = 1_000_000


def recorded() -> list:
    """Every span the program has recorded in this process. A checkout of
    the program from before its spans has no ``profiling.spans``: it gives
    none, so a traced run of it leaves the span metrics out and still ends."""
    from pynndescent_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def in_window(run, name: str) -> list:
    """The spans named ``name`` whose host interval lies in the traced window."""
    if run.trace is None:
        return []
    lo, hi = run.trace.t0 - SLACK_NS, run.trace.t1 + SLACK_NS
    return [s for s in recorded() if s.name == name and lo <= s.start_ns and s.end_ns <= hi]


def device_seconds(run, name: str) -> float | None:
    """Summed device stretches of the window's spans named ``name``."""
    got = [s.device_s for s in in_window(run, name) if s.device_s is not None]
    return float(sum(got)) if got else None


def per_build(run, name: str) -> float | None:
    """Device seconds of the named spans, a build of the window."""
    sec = device_seconds(run, name)
    return sec / run.builds if sec is not None and run.builds else None


def ms_per_query(run, name: str) -> float | None:
    """Device milliseconds of the named spans, a query of the window."""
    sec = device_seconds(run, name)
    return 1e3 * sec / run.queries if sec is not None and run.queries else None


def count(run, name: str, key: str) -> int | None:
    """The counter ``key`` summed over the window's spans named ``name``."""
    found = in_window(run, name)
    if not found:
        return None
    return sum(int(s.counts.get(key, 0)) for s in found)


def idle_pct_inside(run, name: str) -> float | None:
    """100 x (1 - the device's busy time inside the named spans' host
    intervals / those intervals' length): the device's idle share while the
    host is inside them."""
    found = in_window(run, name)
    if not found or run.trace.dev_start.size == 0:
        return None
    tr = run.trace
    a, b = _union(np.array([s.start_ns for s in found], np.int64),
                  np.array([s.end_ns for s in found], np.int64), tr.t0, tr.t1)
    total = float((b - a).sum())
    if total <= 0:
        return None
    s, e = _union(tr.dev_start, tr.dev_end, tr.t0, tr.t1)
    busy = _covered_upto(s, e, b) - _covered_upto(s, e, a)
    return 100.0 * (1.0 - float(busy.sum()) / total)


def _covered_upto(s, e, x):
    """Length of the disjoint sorted intervals ``[s, e)`` that lies before
    each point of ``x``."""
    before = np.concatenate([[0], np.cumsum(e - s)])
    i = np.searchsorted(s, x, side="right")  # intervals that start at or before x
    last = np.maximum(i - 1, 0)
    part = np.where(i > 0, np.clip(x - s[last], 0, e[last] - s[last]), 0) if s.size else 0
    return before[last] + part


def idle_by_innermost(trace, records) -> dict:
    """Seconds the device idles in the traced window, summed by the name of
    the innermost span open on the host at the time (``"no span"`` outside
    every span), largest first: where the host keeps the device waiting."""
    s, e = _union(trace.dev_start, trace.dev_end, trace.t0, trace.t1)
    recs = sorted((r for r in records if r.end_ns > trace.t0 and r.start_ns < trace.t1),
                  key=lambda r: (r.start_ns, -r.end_ns))
    edges = np.unique(np.clip(np.array([trace.t0, trace.t1] + [r.start_ns for r in recs]
                                       + [r.end_ns for r in recs], np.int64), trace.t0, trace.t1))
    a, b = edges[:-1], edges[1:]
    idle = (b - a) - (_covered_upto(s, e, b) - _covered_upto(s, e, a))
    # spans nest, so of the spans open over a piece the last to start is innermost
    owner = np.full(a.shape, -1)
    for i, r in enumerate(recs):
        owner[np.searchsorted(a, r.start_ns):np.searchsorted(a, r.end_ns)] = i
    names = np.array(["no span"] + [r.name for r in recs], dtype=object)[owner + 1]
    out = {}
    for name, sec in zip(names, idle * 1e-9):
        out[name] = out.get(name, 0.0) + float(sec)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
