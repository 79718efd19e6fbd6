"""What decides ``correct`` has to fail what it is there to catch.

Whole runs of small cells on the CPU (the harness's look for a card left
out): the program passes; the control (the reference in TF32 put in the
program's place) fails; and so does each fault a cell can have, planted in
the program underneath the timed path: a step that returns its state
unchanged, half of a batch left out (its answers taken from the other
half), and an answer altered where it is produced. With one chip there is
no exchange between chips to leave out.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pynndescent_torch.models.search as search_mod
import pynndescent_torch.ops.nndescent as nnd_ops
from benchmark.control import control_verdict
from benchmark.spec import Spec
from benchmark.tests.bench_fixtures import make_tiny_root, run_tiny
from pynndescent_torch import NNDescent

BUILD, SINGLE, BATCH = "tiny.build", "tiny.single", "tiny.batch"


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def _halve(ids, dists):
    """The second half's answers replaced by the first half's."""
    ids, dists = ids.copy(), dists.copy()
    h = len(ids) // 2
    ids[h:2 * h], dists[h:2 * h] = ids[:h], dists[:h]
    return ids, dists


def _alter(ids, dists, n):
    """Each answer's last id moved to the next row; its distance kept."""
    ids = ids.copy()
    ids[:, -1] = (ids[:, -1] + 1) % n
    return ids, dists


@pytest.mark.parametrize("cell", [BUILD, SINGLE, BATCH])
def test_the_program_is_correct(tiny_root, cell):
    out = run_tiny(tiny_root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [BUILD, SINGLE, BATCH])
def test_the_control_is_not_correct(tiny_root, cell):
    v = control_verdict(Spec(tiny_root), cell, 2**31 + 3, "cpu")
    assert not v.correct
    assert v.checks["dist_err"]["value"] > v.checks["dist_err"]["max"]


def test_a_descent_step_that_changes_nothing_fails(tiny_root, monkeypatch):
    monkeypatch.setattr(nnd_ops, "_descent_iteration",
                        lambda state, *a, **k: (state, torch.zeros((), dtype=torch.int64)))
    out = run_tiny(tiny_root, BUILD)
    assert not out["correct"]
    assert out["checks"]["graph_recall"]["value"] < out["checks"]["graph_recall"]["min"]


@pytest.mark.parametrize("cell", [SINGLE, BATCH])
def test_a_beam_step_that_changes_nothing_fails(tiny_root, monkeypatch, cell):
    block = search_mod.search_block
    monkeypatch.setattr(search_mod, "search_block",
                        lambda *a, **k: block(*a, **{**k, "max_steps": 0}))
    out = run_tiny(tiny_root, cell)
    assert not out["correct"]
    assert out["checks"]["query_recall"]["value"] < out["checks"]["query_recall"]["min"]


def test_half_a_batch_left_out_fails(tiny_root, monkeypatch):
    query = NNDescent.query
    monkeypatch.setattr(NNDescent, "query", lambda self, *a, **k: _halve(*query(self, *a, **k)))
    assert not run_tiny(tiny_root, BATCH)["correct"]


def test_half_a_graph_left_out_fails(tiny_root, monkeypatch):
    graph = NNDescent.neighbor_graph
    monkeypatch.setattr(NNDescent, "neighbor_graph",
                        property(lambda self: _halve(*graph.fget(self))))
    assert not run_tiny(tiny_root, BUILD)["correct"]


@pytest.mark.parametrize("cell", [SINGLE, BATCH])
def test_an_altered_answer_fails(tiny_root, monkeypatch, cell):
    query = NNDescent.query
    monkeypatch.setattr(NNDescent, "query",
                        lambda self, *a, **k: _alter(*query(self, *a, **k), self._X.shape[0]))
    out = run_tiny(tiny_root, cell)
    assert not out["correct"]
    assert out["checks"]["dist_err"]["value"] > out["checks"]["dist_err"]["max"]


def test_an_altered_graph_fails(tiny_root, monkeypatch):
    graph = NNDescent.neighbor_graph
    monkeypatch.setattr(NNDescent, "neighbor_graph",
                        property(lambda self: _alter(*graph.fget(self), self._X.shape[0])))
    out = run_tiny(tiny_root, BUILD)
    assert not out["correct"]
    assert out["checks"]["dist_err"]["value"] > out["checks"]["dist_err"]["max"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tiny_root):
    """The control on the card, where the cells' controls were read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in (BUILD, BATCH):
        v = control_verdict(Spec(tiny_root), cell, 5, torch.device("cuda", 0))
        assert not v.correct and v.checks["dist_err"]["value"] > v.checks["dist_err"]["max"]
    assert np.isfinite(v.checks["dist_err"]["value"])
