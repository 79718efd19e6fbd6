"""``build``: builds of the index back to back, each
``NNDescent(train, **index, random_state=<new, from the seed>)`` +
``prepare()``, ended by a device synchronisation; the harness then reads
``neighbor_graph`` and keeps the sampled rows (``graph_sample``) of each to
judge. Only whole builds count: the window ends at the first build that
ends after the run's seconds. After the window the last index answers the
``pool`` of check queries, which judges the search graph and tree it
prepared."""

from __future__ import annotations

import time
import traceback

import numpy as np

from benchmark.loops import Answers, BaseLoop, Window, random_state


class Loop(BaseLoop):
    index = None

    def warm(self):
        for i in range(int(self.mix.get("warm", 1))):
            index = self.build(random_state(self.seed, "warm", i))
            index.neighbor_graph
            del index

    def window(self, seconds: float) -> Window:
        w = Window()
        graph = self.answers["graph"] = Answers()
        rows = self.inputs.graph_rows
        t0 = time.perf_counter()
        while True:
            self.index = None
            w.attempted += 1
            try:
                self.index = self.build(random_state(self.seed, "build", w.builds))
                gi, gd = self.index.neighbor_graph
            except Exception:  # noqa: BLE001 - the window's boundary: count it, stop
                traceback.print_exc()
                w.failed += 1
                break
            graph.add(rows, gi[rows], gd[rows], group=w.builds)
            for phase, sec in self.index.phase_times_.items():
                w.phases[phase] = w.phases.get(phase, 0.0) + sec
            w.builds += 1
            if time.perf_counter() - t0 >= seconds:
                break
        w.seconds = time.perf_counter() - t0
        return w

    def after(self):
        """The last index answers the check queries."""
        if self.index is None:
            return
        pool = self.inputs.pool
        ids, dists = self.index.query(pool, k=self.k, **self.query_kw)
        self.answers["query"] = Answers()
        self.answers["query"].add(np.arange(len(pool)), ids, dists)

    def free(self):
        self.index = None
