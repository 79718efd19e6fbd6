"""CPU tests of the ``glove25`` configuration's files: the word-vector
generator (``generators/glove_like.py``), the ``query-batch`` traffic mix
(which the configuration's probes read; no cell runs it yet), and the
reader this configuration's build cell adds, on synthetic spans.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_glove25.py
"""

from __future__ import annotations

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import data, spans
from benchmark.loops import BaseLoop
from benchmark.spec import BENCH_DIR, Spec
from benchmark.trace import Trace

MS = 1_000_000  # ns


def _small_cfg(rows=20000):
    cfg = json.loads((BENCH_DIR / "configs" / "glove25.json").read_text())
    cfg.update(rows=rows)
    return cfg


@pytest.fixture(scope="module")
def drawn():
    cfg = _small_cfg()
    mix = {"pool": 500, "judge": 100}
    gen = Spec().generator(cfg["generator"])
    return cfg, gen, data.make(gen, cfg, mix, 2**31 + 77, "cpu"), data.make(gen, cfg, mix, 5, "cpu")


def test_generator_rows_have_the_configured_shape(drawn):
    cfg, _, a, _ = drawn
    assert a.train.shape == (cfg["rows"], 25) and a.train.dtype == np.float32
    assert a.pool.shape == (500, 25) and np.isfinite(a.train).all()
    full = json.loads((BENCH_DIR / "configs" / "glove25.json").read_text())
    assert (full["rows"], full["dim"], full["queries"]) == (1183514, 25, 10000)
    assert full["metric"] == "cosine" and full["reduced"] == []
    assert full["index"] == {"n_neighbors": 30, "n_trees": 12, "leaf_size": 150}


def test_the_data_set_is_fixed_and_the_seed_orders_it(drawn):
    _, _, a, b = drawn
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(np.sort(a.pool, axis=0), np.sort(b.pool, axis=0))
    assert not np.array_equal(a.pool, b.pool)
    assert not np.array_equal(a.judged, b.judged)


def test_generator_rows_are_nonzero_and_distinct(drawn):
    _, _, a, _ = drawn
    norms = np.linalg.norm(a.train, axis=1)
    assert norms.min() > 0
    assert len(np.unique(a.train, axis=0)) == len(a.train)
    # a row's norm factor is log-normal: cosine ignores it, so norms spread
    assert np.quantile(norms, 0.95) / np.quantile(norms, 0.05) > 1.5


def test_generator_spectrum_is_full_rank_and_decays(drawn):
    cfg, gen, a, _ = drawn
    g = torch.Generator()
    g.manual_seed(0)
    p = gen.params(cfg, g)
    want = np.arange(1, 26, dtype=np.float64) ** -cfg["generator_args"]["spectrum_exp"]
    np.testing.assert_allclose(torch.linalg.svdvals(p["basis"]).numpy(), want, rtol=1e-5)
    eig = np.linalg.eigvalsh(np.cov(a.train.astype(np.float64), rowvar=False))
    assert np.linalg.matrix_rank(np.cov(a.train, rowvar=False)) == 25
    assert eig.min() / eig.max() > 1e-3
    # the shared mean direction: rows lean one way
    unit = a.train / np.linalg.norm(a.train, axis=1, keepdims=True)
    assert np.linalg.norm(unit.mean(0)) > 0.2


def test_generator_topics_follow_a_zipf_law():
    cfg = _small_cfg()
    gen = Spec().generator(cfg["generator"])
    g = torch.Generator()
    g.manual_seed(1)
    p = gen.params(cfg, g)
    w = p["weights"].numpy()
    assert len(w) == cfg["generator_args"]["topics"] and abs(w.sum() - 1) < 1e-5
    np.testing.assert_allclose(w[0] / w[9], 10.0, rtol=1e-4)  # exponent 1.0


def test_the_query_batch_mix_loads():
    spec = Spec()
    mix = spec.traffic("query-batch")
    assert mix["kind"] == "query" and issubclass(spec.loop(mix["kind"]), BaseLoop)
    assert mix["batch"] == mix["pool"] == 10000 and mix["pool"] % mix["batch"] == 0
    assert (mix["indexes"], mix["judge"], mix["warm"], mix["trace_seconds"]) == (2, 1000, 2, 10)
    assert spec.cell("glove25.build")["chips"] == 1
    assert spec.limits("glove25.build")["bad_rows"] == 0


def _span(name, start, end, device_s=None, **counts):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, device_s=device_s,
                           counts=counts)


def _run(records, monkeypatch, builds=0, queries=0):
    d = np.array([[110 * MS, 120 * MS, 0]], dtype=np.int64)
    h = np.zeros((0, 3), np.int64)
    trace = Trace(100 * MS, 200 * MS, ["kern"], d[:, 0], d[:, 1], d[:, 2], h[:, 0], h[:, 1],
                  h[:, 2], Counter())
    monkeypatch.setattr(spans, "recorded", lambda: list(records))
    return SimpleNamespace(trace=trace, builds=builds, queries=queries)


def test_leaf_cover_pct_is_covered_over_rows(monkeypatch):
    read = Spec().reader("leaf_cover_pct.build")
    assert read(_run([_span("descent/init", 110 * MS, 120 * MS, 1.0)], monkeypatch,
                     builds=1)) is None  # no counter: a program from before it
    assert read(_run([], monkeypatch, builds=1)) is None
    run = _run([_span("descent/init", 110 * MS, 120 * MS, 1.0, leaf_rows=1000, leaf_covered=700),
                _span("descent/init", 130 * MS, 140 * MS, 1.0, leaf_rows=1000, leaf_covered=900),
                _span("descent/init", 150 * MS, 250 * MS, 1.0, leaf_rows=1000, leaf_covered=0)],
               monkeypatch, builds=2)
    assert read(run) == pytest.approx(80.0)


def test_the_build_cell_reports_the_leaf_cover():
    spec = Spec()
    assert "leaf_cover_pct.build" in {m["name"] for m in spec.per_layer("glove25.build")}
