"""What every traffic loop shares. A traffic mix's ``kind`` names its loop,
``loops/<kind>.py``, whose ``Loop`` class (a subclass of ``BaseLoop``) the
harness finds by that name (``spec.Spec.loop``); the mix's other keys size
it. A loop has four steps: ``warm()`` in set-up, ``window(seconds)`` the
measured window, ``after()`` the program's work that is judged but not
timed, ``free()`` before the reference runs.

Keys every kind reads: ``warm`` (calls or builds made in set-up),
``trace_seconds`` (caps the window of a traced run, read by the harness),
``index`` and ``query`` (override the configuration's keywords of
``NNDescent`` and of ``query()``). ``trace_phases`` builds with
``profile=True`` in a traced run: each build's ``phase_times_`` (seconds a
phase, the device synchronised at its edges) are summed for the per-layer
readers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import stats
from benchmark.data import Inputs, sub_seed


@dataclass
class Answers:
    """What the window produced, kept to be judged: per judged set the query
    rows (ids into the pool, or into ``train`` for a graph), the returned ids
    and distances, and the group each row belongs to (a build)."""
    rows: list = field(default_factory=list)
    ids: list = field(default_factory=list)
    dists: list = field(default_factory=list)
    group: list = field(default_factory=list)

    def add(self, rows, ids, dists, group=0):
        self.rows.append(np.asarray(rows))
        self.ids.append(np.asarray(ids))
        self.dists.append(np.asarray(dists))
        self.group.append(np.full(len(rows), group))

    def arrays(self):
        if not self.rows:
            return None
        return tuple(np.concatenate(a) for a in (self.rows, self.ids, self.dists, self.group))


@dataclass
class Window:
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    builds: int = 0
    queries: int = 0
    latencies: list = field(default_factory=list)
    phases: dict = field(default_factory=dict)  # phase -> seconds over the builds (profile=True)
    notes: list = field(default_factory=list)  # lines for standard error

    def values(self) -> dict:
        """The end-to-end readings this window gives."""
        out = {}
        if self.builds:
            out["build_s"] = self.seconds / self.builds
        if self.queries:
            out["qps"] = stats.rate(self.queries, self.seconds)
            out["query_p95_ms"] = 1e3 * stats.percentile(self.latencies, 95)
        return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def random_state(seed, *tags) -> int:
    """A ``random_state`` for ``NNDescent``, drawn from a seed and a name."""
    return sub_seed(seed, *tags) & 0x7FFFFFFF


class BaseLoop:
    def __init__(self, NNDescent, cfg: dict, mix: dict, inputs: Inputs, seed: int, device,
                 profile: bool = False):
        self.NNDescent = NNDescent
        self.cfg, self.mix, self.inputs, self.seed = cfg, mix, inputs, seed
        self.device = device
        self.profile = profile
        self.index_kw = {"metric": cfg["metric"], **cfg["index"], **mix.get("index", {})}
        self.query_kw = {**cfg["query"], **mix.get("query", {})}
        self.k = cfg["k"]
        self.answers = {}  # judged set -> Answers

    def build(self, state: int):
        """``NNDescent(train, random_state=state)`` + ``prepare()``, ended by
        a device synchronisation."""
        index = self.NNDescent(self.inputs.train, random_state=state, device=self.device,
                               profile=self.profile, **self.index_kw)
        index.prepare()
        sync(self.device)
        return index

    def warm(self):
        raise NotImplementedError

    def window(self, seconds: float) -> Window:
        raise NotImplementedError

    def after(self):
        """The program's work after the window (none unless a loop has some)."""

    def free(self):
        """Drop the program's state before the reference runs."""
