"""CPU tests of the benchmark's harness: lookups by name, the arithmetic of
its metrics, the trace reduction, the refusal without a card, and whole
cells of a small tree that a test adds as a later change would.

    python -m pytest -p no:cacheprovider benchmark/tests
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import benchmark.cell
from benchmark import data, stats, work
from benchmark.loops import BaseLoop
from benchmark.spec import ROOT, Spec
from benchmark.tests.bench_fixtures import TINY, make_tiny_root, run_tiny
from benchmark.trace import Trace, reduce_events

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def test_every_cell_finds_its_parts_by_name():
    spec = Spec()
    for cell in spec.doc["workloads"]:
        cfg = spec.config(cell["config"])
        assert cfg["name"] == cell["config"]
        mix = spec.traffic(cell["traffic"])
        assert issubclass(spec.loop(mix["kind"]), BaseLoop)
        ref = spec.reference(cfg["metric"])
        assert callable(ref.knn) and callable(ref.dist_gap)
        limits = spec.limits(cell["name"])
        assert limits["bad_rows"] == 0 and 0 < limits["dist_err"] < 1
        assert hasattr(spec.generator(cfg["generator"]), "rows")
        e2e = {m["name"] for m in spec.end_to_end(cell["name"])}
        assert "setup_s" in e2e and "recall10" in e2e and len(e2e) >= 3
        layers = spec.per_layer(cell["name"])
        assert layers and all(m["moves"] in e2e for m in layers)
        for m in layers:
            assert callable(spec.reader(m["name"]))


def test_benchmark_json_keeps_the_contract():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert doc["paths"] == ["benchmark"] and doc["command"][1] == "benchmark/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in doc[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    cells = {w["name"] for w in doc["workloads"]}
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in doc["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" for m in doc["end_to_end"])
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and set(m["workloads"]) <= cells
        assert callable(Spec().reader(m["name"]))


def test_rate_percentile_and_recall():
    assert stats.rate(300, 30.0) == 10.0
    lat = [float(x) for x in range(1, 101)]  # 1..100
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    found = np.array([[1, 2, 3, -1], [7, 8, 9, 10]])
    truth = np.array([[3, 2, 1, 0], [1, 2, 3, 4]])
    assert stats.recall_rows(found, truth).tolist() == [0.75, 0.0]
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_leaf_allpairs_work_counts_come_from_shapes():
    # per tree: rows read once (fp32), n_neighbors ids + distances written once
    assert work.leaf_allpairs_bytes(1_000_000, 128, 10, 12) == 12 * (512_000_000 + 80_000_000)
    assert work.leaf_allpairs_bytes(60_000, 784, 10, 10) == 10 * (188_160_000 + 4_800_000)
    least = work.least_seconds(nbytes=3.35e12)
    assert least == pytest.approx(1.0)
    assert work.least_seconds(flops=67e12, nbytes=1.0) == pytest.approx(1.0)
    assert work.roofline_pct(0.25, 1.0) == pytest.approx(25.0)
    assert work.roofline_pct(0.25, 0.0) is None


def _trace(dev, host=(), names=None, t0=0, t1=100):
    names = names or [f"op{i}" for i in range(8)]
    d = np.array(dev, dtype=np.int64).reshape(-1, 3)
    h = np.array(host, dtype=np.int64).reshape(-1, 3)
    return Trace(t0, t1, names, d[:, 0], d[:, 1], d[:, 2], h[:, 0], h[:, 1], h[:, 2],
                 Counter(names[c] for _, _, c in host))


def test_device_busy_is_the_union_of_intervals():
    # [10, 30) and [20, 40) overlap; [50, 60) apart; [95, 120) clipped to the window
    tr = _trace([(10, 30, 0), (20, 40, 1), (50, 60, 0), (95, 120, 2)])
    assert tr.busy_s() == pytest.approx((30 + 10 + 5) * 1e-9)
    assert tr.idle_pct() == pytest.approx(55.0)
    assert tr.device_s("op0") == pytest.approx(30e-9)
    assert _trace([]).idle_pct() is None


def test_breakdown_names_ops_and_gaps():
    names = ["kernA", "kernB", "cudaMemcpyAsync", "cudaLaunchKernel"]
    # gaps: [0,10) before kernA, [40,50) with a copy call live, [60,100) to the end
    tr = _trace([(10, 40, 0), (50, 60, 1)], host=[(7, 8, 3), (42, 48, 2)], names=names)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["kernA", pytest.approx(30e-9)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["host, to the window's end"] == pytest.approx(40e-9)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-9)
    assert gaps["host, before kernA"] == pytest.approx(10e-9)
    assert tr.count_calls({"cudaLaunchKernel"}) == 1


class _Ev:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"


def test_reduce_events_splits_device_and_runtime():
    evs = [_Ev("cudaLaunchKernel", 0, 5, "CPU"), _Ev("kern", 10, 20, "CUDA"),
           _Ev("aten::add", 1, 3, "CPU"), _Ev("cudaStreamSynchronize", 12, 30, "CPU")]
    tr = reduce_events(evs)
    assert tr.dev_start.tolist() == [10] and tr.names[tr.dev_name[0]] == "kern"
    assert tr.calls == Counter({"cudaLaunchKernel": 1, "cudaStreamSynchronize": 1})
    assert (tr.t0, tr.t1) == (0, 42)


def test_inputs_follow_the_seed(tiny_root):
    spec = Spec(tiny_root)
    cfg, mix = spec.config("tiny"), spec.traffic("tiny-batch")
    gen = spec.generator(cfg["generator"])
    big = 2**31 + 12345
    a, b = data.make(gen, cfg, mix, big, "cpu"), data.make(gen, cfg, mix, big, "cpu")
    c = data.make(gen, cfg, mix, big + 1, "cpu")
    assert np.array_equal(a.train, b.train) and np.array_equal(a.pool, b.pool)
    assert np.array_equal(a.judged, b.judged) and len(a.judged) == mix["judge"]
    # another seed: the same data set, its queries in another order
    assert np.array_equal(a.train, c.train) and not np.array_equal(a.pool, c.pool)
    assert np.array_equal(np.sort(a.pool, axis=0), np.sort(c.pool, axis=0))
    assert data.sub_seed(big, "x") != data.sub_seed(big + 1, "x") < 2**63


class _SyntheticTracer:
    """Stands in for the profiler, which traces a card: a traced run on the
    CPU gets a fixed Trace of two device operations and two runtime calls."""

    def __init__(self, enabled, device):
        self.enabled = enabled

    @contextlib.contextmanager
    def window(self):
        yield

    def extract(self):
        if not self.enabled:
            return None
        names = ["kernA", "kernB", "cudaLaunchKernel", "cudaStreamSynchronize"]
        return _trace([(10, 40, 0), (50, 60, 1)], host=[(5, 8, 2), (42, 48, 3)], names=names)


class _SparseRows:
    """A generator whose rows are not a dense tensor (CSR, as a sparse
    configuration's would be)."""

    @staticmethod
    def params(cfg, gen):
        return {}

    @staticmethod
    def rows(p, cfg, n, gen):
        import scipy.sparse as sp

        dense = (torch.rand(n, cfg["dim"], generator=gen) < 0.2).numpy().astype(np.float32)
        return sp.csr_matrix(dense)


def test_rows_that_are_not_a_tensor_pass_through():
    import scipy.sparse as sp

    cfg = dict(TINY, rows=50, dim=30)
    mix = {"pool": 20, "judge": 5}
    a = data.make(_SparseRows, cfg, mix, 3, "cpu")
    b = data.make(_SparseRows, cfg, mix, 3, "cpu")
    assert sp.issparse(a.train) and sp.issparse(a.pool) and a.pool.shape == (20, 30)
    assert (a.pool != b.pool).nnz == 0 and len(a.judged) == 5


def test_added_cell_mix_and_metric_run_from_new_files(tiny_root, monkeypatch):
    out = run_tiny(tiny_root, "tiny.build")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "build_s", "recall10"}
    assert list(out)[-1] == "checks"
    monkeypatch.setattr(benchmark.cell, "Tracer", _SyntheticTracer)
    traced = run_tiny(tiny_root, "tiny.build", trace=True)
    assert traced["correct"]
    m = traced["metrics"]
    assert m["builds.tiny"]["value"] >= 1  # the new reader, found by its name
    assert {"forest_s.build", "descent_s.build", "diversify_s.build",
            "search_tree_s.build"} <= set(m)
    assert m["device_idle_pct.build"]["value"] == pytest.approx(60.0)  # the shared reader
    assert "leaf_allpairs.roofline_pct" not in m  # no leaf kernel in the trace: no reading
    assert traced["device"]["window_s"] == pytest.approx(1e-7)
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    q = run_tiny(tiny_root, "tiny.single")
    assert q["correct"] and set(q["metrics"]) == {"setup_s", "qps", "query_p95_ms", "recall10"}
    assert q["attempted"] >= 1 and q["metrics"]["qps"]["value"] > 0


def test_a_new_kind_of_traffic_runs_from_its_own_loop_file(tiny_root):
    out = run_tiny(tiny_root, "tiny.whole")
    assert out["correct"], out["checks"]
    assert out["attempted"] % 300 == 0 and out["metrics"]["qps"]["value"] > 0


def test_a_query_cell_sends_its_calls_to_its_indexes_in_turn(tiny_root, capsys):
    run_tiny(tiny_root, "tiny.single")
    note = [x for x in capsys.readouterr().err.splitlines() if "by index" in x]
    assert len(note) == 1 and len(note[0].split(":")[1].split()) == 2


def test_a_metric_without_a_reference_file_is_refused(tiny_root, tmp_path):
    spec = Spec(tiny_root)
    with pytest.raises(LookupError, match="reference for the metric"):
        spec.reference("angular")
    with pytest.raises(LookupError, match="kind of traffic"):
        spec.loop("__init__")
    root = make_tiny_root(tmp_path)
    bench = root / "benchmark"
    (bench / "configs" / "tiny_cos.json").write_text(json.dumps(dict(TINY, metric="cosine")))
    (bench / "limits" / "tiny_cos.build.json").write_text(
        (bench / "limits" / "tiny.build.json").read_text())
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_cos", "source": "test", "reduced": [], "why": "test",
                           "file": "benchmark/configs/tiny_cos.json"})
    doc["workloads"].append({"name": "tiny_cos.build", "config": "tiny_cos",
                             "traffic": "tiny-build", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(LookupError, match="cosine"):
        run_tiny(root, "tiny_cos.build")


def test_run_refuses_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                        "fmnist784.build", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
