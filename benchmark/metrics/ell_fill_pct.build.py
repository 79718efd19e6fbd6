"""Share of the keys the exact rerank sorts that are real entries: 100 x
the ``stored`` counter over the ``padded`` counter of the window's
``graph/exact`` spans (``models/nndescent.py::NNDescent._exact_graph``).
Each reranked pair sorts both rows padded to the longest row's count of
stored values; the rest is padding."""

from benchmark import spans


def read(run):
    stored = spans.count(run, "graph/exact", "stored")
    padded = spans.count(run, "graph/exact", "padded")
    return 100.0 * stored / padded if stored is not None and padded else None
