"""CPU test of the reader of ``join_kernel_share.build`` on synthetic spans
(the helpers of ``test_bench_spans.py``).

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_join_kernel_share.py
"""

from __future__ import annotations

import pytest

from benchmark.spec import Spec
from benchmark.tests.test_bench_spans import MS, _run, _span


def test_join_kernel_share_is_kernel_rows_over_rows(monkeypatch):
    read = Spec().reader("join_kernel_share.build")
    records = [_span("descent/join", 110 * MS, 120 * MS, 0.5, iters=4, changes=9, rows=4000,
                     kernel_rows=4000),
               _span("descent/join", 130 * MS, 140 * MS, 0.5, iters=2, changes=3, rows=2000,
                     kernel_rows=0),
               _span("descent/join", 90 * MS, 105 * MS, 0.5, iters=2, rows=8000,
                     kernel_rows=0)]  # began before the window
    assert read(_run(records, monkeypatch, builds=2)) == pytest.approx(4000 / 6000)
    # a program whose spans have no such counter (the parent of the kernel)
    records = [_span("descent/join", 110 * MS, 120 * MS, 0.5, iters=4, changes=9)]
    assert read(_run(records, monkeypatch, builds=1)) is None
    assert read(_run([], monkeypatch, builds=1)) is None
