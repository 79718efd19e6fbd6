"""CPU test of the reader of ``beam_kernel_share.query_online`` on synthetic
spans (the helpers of ``test_bench_spans.py``).

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_kernel_share.py
"""

from __future__ import annotations

import pytest

from benchmark.spec import Spec
from benchmark.tests.test_bench_spans import MS, _run, _span


def test_kernel_share_is_kernel_queries_over_queries(monkeypatch):
    read = Spec().reader("beam_kernel_share.query_online")
    records = [_span("query/beam", 110 * MS, 111 * MS, 0.1, steps=20, queries=1,
                     kernel_queries=1),
               _span("query/beam", 112 * MS, 113 * MS, 0.1, steps=30, queries=3,
                     kernel_queries=0)]
    assert read(_run(records, monkeypatch, queries=4)) == pytest.approx(0.25)
    # a program whose spans have no such counter (the parent of the kernels)
    records = [_span("query/beam", 110 * MS, 111 * MS, 0.1, steps=20, queries=1)]
    assert read(_run(records, monkeypatch, queries=1)) is None
    assert read(_run([], monkeypatch, queries=1)) is None
