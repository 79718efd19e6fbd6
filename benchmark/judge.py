"""What decides ``correct``: the window's answers against the plain reference.

The reference is the configuration's metric's own file,
``reference/<metric>.py`` (``spec.Spec.reference``); a metric without one
is refused, never judged by another's. Every judged answer (a sampled row of
each build's graph, a check query, a query of the pool) is held to these
numbers:

- ``bad_rows``: answers with an id out of range or repeated, a distance that
  is not finite, or distances not in ascending order (limit 0);
- ``dist_err``: the widest gap between a returned distance and the pair's
  distance worked out again from the inputs, in the scale the reference's
  ``dist_gap`` gives (limit from ``limits/<cell>.json``);
- ``graph_recall`` (the least over the builds) and ``query_recall``: the
  share of the reference's exact top-k returned. ``query_recall`` is held
  to the configuration's ``recall_floor``; ``graph_recall`` to the cell's
  own ``graph_recall`` limit where ``limits/<cell>.json`` gives one, else
  to the same floor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark import stats


@dataclass
class Verdict:
    checks: dict  # name -> {"value": x, "max" or "min": limit}
    recall10: float | None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(_holds(c) for c in self.checks.values())


def _holds(c: dict) -> bool:
    v = c["value"]
    if v is None or v != v:
        return False
    return v <= c["max"] if "max" in c else v >= c["min"]


def _bad_rows(ids: np.ndarray, dists: np.ndarray, n: int) -> int:
    srt = np.sort(ids, axis=1)
    bad = (ids < 0).any(1) | (ids >= n).any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= ~np.isfinite(dists).all(1) | (np.diff(dists, axis=1) < 0).any(1)
    return int(bad.sum())


def _source(inputs, name: str):
    return inputs.train if name == "graph" else inputs.pool


def reference_answers(ref, answers: dict, inputs, k: int, device, control: bool = False) -> dict:
    """The reference's ids and distances for every judged row of
    ``answers`` ({set: (rows, ids, dists, group)}), in the same form: the
    truth or, with ``control``, the control put in the program's place."""
    out = {}
    for name, (rows, _, _, group) in answers.items():
        uniq, inv = np.unique(rows, return_inverse=True)
        ids, dists = ref.knn(inputs.train, _source(inputs, name)[uniq], k, device,
                             control=control)
        out[name] = (rows, ids[inv], dists[inv], group)
    return out


def judge(ref, answers: dict, inputs, cfg: dict, limits: dict, device) -> Verdict:
    """Hold every kept answer to the reference module ``ref``; ``answers``
    maps a judged set (``graph`` or ``query``) to its (rows, ids, dists,
    group) arrays."""
    k = cfg["k"]
    truth = reference_answers(ref, answers, inputs, k, device)
    n = inputs.train.shape[0]
    bad, err = 0, 0.0
    checks, recall10 = {}, None
    for name, (rows, ids, dists, group) in answers.items():
        ids = ids[:, :k].astype(np.int64)
        dists = dists[:, :k].astype(np.float64)
        bad += _bad_rows(ids, dists, n)
        gap = ref.dist_gap(inputs.train, _source(inputs, name)[rows], ids, dists, device)
        gap = gap[np.isfinite(gap)]  # pairs with an invalid id count in bad_rows
        err = max(err, float(gap.max())) if gap.size else float("nan")
        rec = stats.recall_rows(ids, truth[name][1])
        if name == "graph":
            per_build = [float(rec[group == g].mean()) for g in np.unique(group)]
            floor = limits.get("graph_recall", cfg["recall_floor"])
            checks["graph_recall"] = {"value": min(per_build), "min": floor}
            recall10 = float(rec.mean())
        else:
            checks["query_recall"] = {"value": float(rec.mean()), "min": cfg["recall_floor"]}
            if recall10 is None:
                recall10 = float(rec.mean())
    if checks:
        checks = {"bad_rows": {"value": bad, "max": limits["bad_rows"]},
                  "dist_err": {"value": err, "max": limits["dist_err"]}, **checks}
    return Verdict(checks, recall10)
