"""CPU tests of the readers of the program's spans (``benchmark/spans.py`` and
the per-layer metrics that use it), on synthetic spans and a synthetic trace.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_spans.py
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import spans
from benchmark.spec import Spec
from benchmark.trace import Trace

MS = 1_000_000  # ns


def _span(name, start, end, device_s=None, **counts):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, device_s=device_s,
                           counts=counts)


def _run(records, monkeypatch, dev=((0, 1, 0),), t0=100 * MS, t1=200 * MS, builds=0, queries=0):
    d = np.array(dev, dtype=np.int64).reshape(-1, 3)
    h = np.zeros((0, 3), np.int64)
    trace = Trace(t0, t1, ["kern"], d[:, 0], d[:, 1], d[:, 2], h[:, 0], h[:, 1], h[:, 2],
                  Counter())
    monkeypatch.setattr(spans, "recorded", lambda: list(records))
    return SimpleNamespace(trace=trace, builds=builds, queries=queries)


def test_only_spans_inside_the_traced_window_count(monkeypatch):
    records = [_span("descent/join", 90 * MS, 120 * MS, 5.0),  # began before the window
               _span("descent/join", 120 * MS, 150 * MS, 1.0),
               _span("descent/join", 160 * MS, 200 * MS + MS // 2, 2.0),  # inside the slack
               _span("descent/join", 190 * MS, 210 * MS, 7.0),  # ended after it
               _span("descent/init", 130 * MS, 140 * MS, 9.0)]
    run = _run(records, monkeypatch, builds=2)
    assert [s.device_s for s in spans.in_window(run, "descent/join")] == [1.0, 2.0]
    assert spans.device_seconds(run, "descent/join") == pytest.approx(3.0)
    assert spans.per_build(run, "descent/join") == pytest.approx(1.5)
    run.trace = None
    assert spans.in_window(run, "descent/join") == []


def test_seconds_divide_by_builds_and_queries(monkeypatch):
    records = [_span("query/seed", 110 * MS, 111 * MS, 0.002),
               _span("query/seed", 120 * MS, 121 * MS, 0.004),
               _span("query/beam", 111 * MS, 119 * MS, None)]  # not yet resolved
    run = _run(records, monkeypatch, queries=4)
    assert spans.ms_per_query(run, "query/seed") == pytest.approx(1.5)
    assert spans.ms_per_query(run, "query/beam") is None
    run.queries = 0
    assert spans.ms_per_query(run, "query/seed") is None


def test_counters_sum_over_the_window(monkeypatch):
    records = [_span("query/beam", 110 * MS, 111 * MS, 0.1, steps=20, queries=1),
               _span("query/beam", 112 * MS, 113 * MS, 0.1, steps=30, queries=1),
               _span("descent/join", 120 * MS, 150 * MS, 1.0, iters=2, changes=100),
               _span("descent/join", 150 * MS, 180 * MS, 1.0, iters=4, changes=50)]
    run = _run(records, monkeypatch, builds=2, queries=2)
    assert spans.count(run, "query/beam", "steps") == 50
    assert spans.count(run, "descent/join", "changes") == 150
    spec = Spec()
    assert spec.reader("beam_steps_per_query.query_online")(run) == pytest.approx(25.0)
    assert spec.reader("join_iters.build")(run) == pytest.approx(3.0)


@pytest.mark.parametrize("metric,name", [
    ("ingest_s.build", "ingest"), ("descent_init_s.build", "descent/init"),
    ("sweeps_s.build", "descent/sweeps"), ("join_s.build", "descent/join"),
    ("join_iters.build", "descent/join"), ("descent_idle_pct.build", "phase/descent"),
    ("seed_ms.query_online", "query/seed"), ("beam_ms.query_online", "query/beam"),
    ("beam_steps_per_query.query_online", "query/beam"),
    ("beam_idle_pct.query_online", "query/beam")])
def test_a_reader_reads_its_span_and_returns_none_without_it(monkeypatch, metric, name):
    read = Spec().reader(metric)
    # a 60k build runs no sweeps; the program before the spans records none
    run = _run([_span("other", 110 * MS, 120 * MS, 1.0)], monkeypatch, builds=1, queries=1)
    assert read(run) is None
    run = _run([_span(name, 110 * MS, 120 * MS, 0.01, iters=2, steps=3, queries=1)],
               monkeypatch, dev=((112 * MS, 114 * MS, 0),), builds=1, queries=1)
    assert read(run) > 0


def test_the_program_without_spans_gives_no_reading(monkeypatch):
    from pynndescent_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.recorded() == []


def test_idle_inside_spans_lays_the_device_over_their_host_intervals(monkeypatch):
    # spans [110, 130) and [150, 160) ms; the device runs [100, 115), [120, 125)
    # and [128, 152): busy 5 + 5 + 2 + 2 = 14 of 30 ms inside them
    dev = [(100 * MS, 115 * MS, 0), (120 * MS, 125 * MS, 0), (128 * MS, 140 * MS, 0),
           (135 * MS, 152 * MS, 0), (170 * MS, 180 * MS, 0)]
    records = [_span("query/beam", 110 * MS, 130 * MS), _span("query/beam", 150 * MS, 160 * MS),
               _span("query/seed", 170 * MS, 180 * MS)]
    run = _run(records, monkeypatch, dev=dev)
    assert spans.idle_pct_inside(run, "query/beam") == pytest.approx(100 * (1 - 14 / 30))
    assert spans.idle_pct_inside(run, "query/seed") == pytest.approx(0.0)
    assert spans.idle_pct_inside(run, "phase/descent") is None
    assert Spec().reader("beam_idle_pct.query_online")(run) == pytest.approx(100 * 16 / 30)


def test_covered_length_before_points():
    s = np.array([10, 30], np.int64)
    e = np.array([20, 35], np.int64)
    x = np.array([0, 10, 15, 25, 32, 99])
    assert spans._covered_upto(s, e, x).tolist() == [0, 0, 5, 10, 12, 15]
    assert np.all(spans._covered_upto(s[:0], e[:0], x) == 0)


def test_idle_time_goes_to_the_innermost_open_span(monkeypatch):
    # window [100, 200) ms; build [110, 190) holds descent [120, 160), which
    # holds join [130, 150); the device runs [100, 125) and [140, 170)
    dev = [(100 * MS, 125 * MS, 0), (140 * MS, 170 * MS, 0)]
    records = [_span("build", 110 * MS, 190 * MS), _span("phase/descent", 120 * MS, 160 * MS),
               _span("descent/join", 130 * MS, 150 * MS)]
    run = _run(records, monkeypatch, dev=dev)
    got = spans.idle_by_innermost(run.trace, records)
    assert got == pytest.approx({"build": 0.020, "no span": 0.010, "descent/join": 0.010,
                                 "phase/descent": 0.005})
    assert list(got)[0] == "build"
    assert sum(got.values()) == pytest.approx(run.trace.window_s - run.trace.busy_s())
