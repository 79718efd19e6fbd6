"""The hand-written kernels at the ``glove25`` configuration's shape: rows
of 25 float32 values (100 bytes, so no row after the first is 16-byte
aligned and every kernel takes its narrow-row path) under
``alternative_cosine``, each against its plain PyTorch version, on rows of
the configuration's generator (``benchmark/generators/glove_like.py``).

Imports no JAX (the card's machine has none), so it runs there:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_glove25.py

Without a card every test skips. ``join_dists`` at d = 25 is held to its
plain version in ``tests/test_torch_join_kernels.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.spec import load_file
from pynndescent_torch import NNDescent
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops import rp_trees as tr
from _torch_parity import cuda_device, n, recall, t  # noqa: F401

pytestmark = pytest.mark.cuda

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CFG = json.loads((BENCH / "configs" / "glove25.json").read_text())
METRIC = "alternative_cosine"


def glove_rows(rows, seed):
    gen_mod = load_file(BENCH / "generators" / "glove_like.py", "test_cuda_glove_like")
    cfg = dict(CFG, rows=rows)
    g = torch.Generator()
    g.manual_seed(seed)
    return gen_mod.rows(gen_mod.params(cfg, g), cfg, rows, g)


@pytest.fixture(scope="module")
def forest_tree_order():
    """20,000 rows in the first tree's order of an angular forest at the
    configuration's ``leaf_size`` 150, with that tree's leaf table."""
    X = glove_rows(20000, seed=1)
    depth = tr.forest_depth(X.shape[0], CFG["index"]["leaf_size"])
    o, s, z = tr.build_forest_orders(X, [3, 4], CFG["index"]["leaf_size"], depth, angular=True)
    ls, lz = ik.leaf_tables_from_orders(s, z, X.shape[0])
    return X[o[0].long()].contiguous(), ls[0].contiguous(), lz[0].contiguous()


def test_leaf_allpairs_kernel_at_d25_cosine_with_leaves_past_the_tile(cuda_device,
                                                                       forest_tree_order):
    """Leaves of up to 150 rows: the kernel writes each row's distances to
    its leaf's first 64 members, +inf past the leaf, and +inf throughout for
    rows past the 64th, as the plain version does. Tolerance as for N(0, 1)
    rows (tests/test_torch_cuda.py): the two sum the gram in other orders."""
    X_t, ls, lz = forest_tree_order
    assert int(lz.max()) > ik.LEAF_CAP and X_t.shape[1] * 4 % 16
    X_t, ls, lz = X_t.to(cuda_device), ls.to(cuda_device), lz.to(cuda_device)
    ik.reset_launch_counts()
    got = ik.leaf_allpairs(X_t, ls, lz, metric=METRIC)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["leaf_allpairs"] == 1
    want = ik.leaf_allpairs_plain(X_t, ls, lz, metric=METRIC)
    got, want = n(got), n(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got).all(axis=1).sum() > 0  # rows past a leaf's 64th
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=2e-4)


def test_window_topm_kernel_at_d25_cosine(cuda_device, forest_tree_order):
    """The sweep's window (1,024 rows, top 32) over rows in tree order."""
    X_t = forest_tree_order[0].to(cuda_device)
    for offset in (0, 512):
        ik.reset_launch_counts()
        gi, gd = ik.window_topm(X_t, win=1024, m=32, metric=METRIC, offset=offset)
        torch.cuda.synchronize()
        assert ik.LAUNCHES["window_topm"] == 1
        wi, wd = ik.window_topm_plain(X_t, win=1024, m=32, metric=METRIC, offset=offset)
        np.testing.assert_allclose(n(gd), n(wd), rtol=1e-4, atol=1e-4)
        assert (n(gi) == n(wi)).mean() > 0.999


@pytest.mark.parametrize("beam_width", [48, 96])
def test_search_kernels_at_d25_on_an_angular_tree_track_the_torch_loop(cuda_device, beam_width,
                                                                        monkeypatch):
    """A 60,000-row cosine index at the configuration's settings, one block
    of 8,192 queries, from the port's default beam (48, which the
    configuration's queries grow past) and from 96: the kernels' ids equal
    the torch loop's on at least 99% of the queries and their recall is
    within 0.005 of it (the two sum in other orders on the bf16 rows)."""
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import search_kernels as sk

    data = glove_rows(60000 + 8192, seed=2).numpy()
    train, queries = data[:60000], data[60000:]
    index = NNDescent(train, metric="cosine", random_state=42, device="cuda", **CFG["index"])
    index.prepare()
    assert index._tree_dev["angular"] and index._search_graph.shape[1] > 30
    q = index._queries_to_device(queries)
    X = index._X_search
    assert X.dtype == torch.bfloat16 and X.shape[1] == 25
    fn = tnd._resolve_rowwise_metric(index._internal_metric, cast_candidates_f32=True)
    kw = dict(k=15, epsilon=CFG["query"]["epsilon"], min_distance=index._min_distance,
              beam_width=beam_width)
    args = (q, X, index._search_graph, index._tree_dev, 7)
    widths = []
    keep = ts._keep_admitted

    def spy(state, **kw_):
        out = keep(state, **kw_)
        widths.append(out[0].idx.shape[1])
        return out

    monkeypatch.setattr(ts, "_keep_admitted", spy)
    sk.reset_launch_counts()
    gi, _ = ts.search(*args, dist_rowwise=fn, **kw)
    wi, _ = ts.search(*args, dist_rowwise=lambda Q, C: fn(Q, C), **kw)
    assert sk.LAUNCHES == {"search_seed": 1, "beam_search": 1}
    assert max(widths) > beam_width  # the torch loop's beams grew, so the kernel's did
    gi, wi = n(gi), n(wi)
    assert np.mean(np.all(gi == wi, axis=1)) >= 0.99
    A, B = t(train).to(cuda_device), t(queries).to(cuda_device)
    A, B = A / A.norm(dim=1, keepdim=True), B / B.norm(dim=1, keepdim=True)
    truth = n(torch.topk(torch.cdist(B, A, compute_mode="donot_use_mm_for_euclid_dist"), 10,
                         largest=False).indices)
    assert abs(recall(gi[:, :10], truth) - recall(wi[:, :10], truth)) <= 0.005
