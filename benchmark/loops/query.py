"""``query``: ``indexes`` indexes (default 1) are built and prepared in
set-up, each with its own ``random_state``, drawn from the configuration's
``dataset_seed``: every seed queries the same indexes, as it queries the
same data set. An index's search cost depends on its ``random_state``, so
a cell that serves several carries each one's share in every run. One
caller sends ``query(pool[i:i + batch], k, **query)`` calls back to back (a
closed loop), taking the pool in order and the indexes in turn, from one
the seed picks; each call is timed until its answers are numpy arrays on
the host. ``judge`` answers of the pool (a number drawn from the seed, or
``"all"``) are kept, every time they are answered."""

from __future__ import annotations

import time
import traceback

import numpy as np

from benchmark import stats
from benchmark.data import sub_seed
from benchmark.loops import Answers, BaseLoop, Window, random_state


class Loop(BaseLoop):
    indexes: list = ()

    def warm(self):
        n = int(self.mix.get("indexes", 1))
        self.indexes = [self.build(random_state(self.cfg["dataset_seed"], "index", i))
                        for i in range(n)]
        self.first = sub_seed(self.seed, "first index") % n
        batch, pool = int(self.mix["batch"]), self.inputs.pool
        for i in range(max(int(self.mix.get("warm", 1)), n)):
            s = (i * batch) % len(pool)
            self.indexes[i % n].query(pool[s:s + batch], k=self.k, **self.query_kw)

    def window(self, seconds: float) -> Window:
        w = Window()
        ans = self.answers["query"] = Answers()
        pool, batch = self.inputs.pool, int(self.mix["batch"])
        if len(pool) % batch:
            raise ValueError("the pool holds a whole number of calls")
        judged = np.zeros(len(pool), bool)
        judged[self.inputs.judged] = True
        n = len(self.indexes)
        by_index = [[] for _ in range(n)]
        pos, call = 0, 0
        t0 = time.perf_counter()
        while True:
            qb = pool[pos:pos + batch]
            at = (self.first + call) % n
            w.attempted += len(qb)
            t1 = time.perf_counter()
            try:
                ids, dists = self.indexes[at].query(qb, k=self.k, **self.query_kw)
            except Exception:  # noqa: BLE001 - the window's boundary: count it, stop
                traceback.print_exc()
                w.failed += len(qb)
                break
            t2 = time.perf_counter()
            w.latencies.append(t2 - t1)
            by_index[at].append(t2 - t1)
            w.queries += len(qb)
            sel = np.nonzero(judged[pos:pos + batch])[0]
            ans.add(pos + sel, ids[sel], dists[sel])
            pos = (pos + batch) % len(pool)
            call += 1
            if t2 - t0 >= seconds:
                break
        w.seconds = time.perf_counter() - t0
        w.notes.append("median call ms by index: " + " ".join(
            f"{1e3 * stats.percentile(v, 50):.3f}" if v else "-" for v in by_index))
        return w

    def free(self):
        self.indexes = []
