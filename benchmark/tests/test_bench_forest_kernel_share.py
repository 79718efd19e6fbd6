"""CPU test of the reader of ``forest_kernel_share.build`` on synthetic spans
(the helpers of ``test_bench_spans.py``).

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_forest_kernel_share.py
"""

from __future__ import annotations

import pytest

from benchmark.spec import Spec
from benchmark.tests.test_bench_spans import MS, _run, _span


def test_forest_kernel_share_is_kernel_keys_over_keys(monkeypatch):
    read = Spec().reader("forest_kernel_share.build")
    records = [_span("forest/levels", 110 * MS, 120 * MS, 0.5, levels=16, keys=18_000,
                     kernel_keys=18_000),
               _span("forest/levels", 130 * MS, 140 * MS, 0.5, levels=16, keys=6_000,
                     kernel_keys=0),
               _span("forest/levels", 90 * MS, 105 * MS, 0.5, levels=16, keys=9_000,
                     kernel_keys=0)]  # began before the window
    assert read(_run(records, monkeypatch, builds=2)) == pytest.approx(18_000 / 24_000)
    # a program whose spans have no such counter (the parent of the kernel)
    records = [_span("forest/levels", 110 * MS, 120 * MS, 0.5, levels=16, keys=18_000)]
    assert read(_run(records, monkeypatch, builds=1)) is None
    assert read(_run([], monkeypatch, builds=1)) is None
