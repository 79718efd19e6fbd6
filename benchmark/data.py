"""A cell's inputs.

The data set is the configuration's: its rows and its query pool are drawn
from the configuration's ``dataset_seed``, as an ann-benchmarks data set is
one fixed file, so every seed sends the same set of queries, in another
order. ``--seed`` makes the rest: that order, which of the queries and
which rows of each graph are judged, and (``loops/``) the ``random_state``
of every build of a build cell. Every stream has a seed of its own, derived
from the seed and the stream's name, so the same seed gives the same inputs
and any whole number is a seed. The configuration's generator
(``generators/<name>.py``) draws the rows on the device with a
``torch.Generator`` there; they are handed to the program and to the
reference as the same host arrays (numpy, or what the generator gives for
rows that are not a dense tensor).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def torch_gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@dataclass
class Inputs:
    train: np.ndarray  # [n, d] the indexed rows
    pool: np.ndarray  # [m, d] the queries the traffic sends, in order
    judged: np.ndarray  # ids of the pool rows whose answers are judged
    graph_rows: np.ndarray | None  # build cells: the sampled rows of each graph judged


def make(generator, cfg: dict, mix: dict, seed: int, device) -> Inputs:
    """Rows from the configuration's generator module; the pool and the
    samples from the traffic mix's sizes."""
    data_seed = cfg["dataset_seed"]
    p = generator.params(cfg, torch_gen(sub_seed(data_seed, "params"), "cpu"))

    def draw(n, stream):
        rows = generator.rows(p, cfg, n, torch_gen(sub_seed(data_seed, stream), device))
        return rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows

    train = draw(cfg["rows"], "train")
    order = np.random.default_rng(sub_seed(seed, "order")).permutation(mix["pool"])
    pool = draw(mix["pool"], "queries")[order]
    if isinstance(pool, np.ndarray):
        pool = np.ascontiguousarray(pool)
    pick = np.random.default_rng(sub_seed(seed, "judged"))
    judge = mix.get("judge", "all")
    judged = (np.arange(mix["pool"]) if judge == "all"
              else np.sort(pick.choice(mix["pool"], int(judge), replace=False)))
    graph_rows = None
    if mix.get("graph_sample"):
        graph_rows = np.sort(np.random.default_rng(sub_seed(seed, "graph_rows")).choice(
            cfg["rows"], int(mix["graph_sample"]), replace=False))
    return Inputs(train, pool, judged, graph_rows)
