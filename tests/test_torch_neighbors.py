"""Parity of the port's neighbor state and merge with the JAX package.

merge_candidates is deterministic, so the comparison is exact: idx, dist,
flag and the change count must be equal element for element, including
duplicate ids, distance ties, -1 candidates, NaN distances and -0.0 (which
``lax.top_k`` ranks before +0.0 while ``lax.sort`` does not).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pynndescent_tpu.ops import neighbors as jn
from pynndescent_torch.ops import neighbors as tn
from _torch_parity import n, t

DIST_VALUES = np.array([0.0, -0.0, 0.5, 1.0, 2.0, -1.0, np.inf, np.nan], np.float32)


def _random_case(seed, k, m, rows=9):
    rs = np.random.RandomState(seed)
    ids = rs.randint(-1, 3 * k, (rows, k)).astype(np.int32)
    d = rs.choice(DIST_VALUES, (rows, k)).astype(np.float32)
    st = jn.state_from_graph(jnp.asarray(ids), jnp.asarray(d), k=k)
    flag = np.asarray(st.flag) & (rs.rand(rows, k) < 0.5)
    st = st._replace(flag=jnp.asarray(flag))
    ci = rs.randint(-1, 3 * k + 4, (rows, m)).astype(np.int32)
    cd = rs.choice(np.append(DIST_VALUES, 3.0), (rows, m)).astype(np.float32)
    return st, ci, cd


def _to_torch_state(st):
    return tn.NeighborState(t(st.idx), t(st.dist), t(st.flag))


def _assert_state_equal(j_state, t_state):
    np.testing.assert_array_equal(n(t_state.idx), n(j_state.idx))
    np.testing.assert_array_equal(n(t_state.dist), n(j_state.dist))
    np.testing.assert_array_equal(n(t_state.flag), n(j_state.flag))


# (k, m): the first two take the top-k branch (k <= 64 and 4k <= k + m), the
# others the sort branch (4k > width, and k > 64)
@pytest.mark.parametrize("k,m", [(3, 30), (8, 200), (8, 5), (40, 30), (70, 400)])
def test_merge_candidates_matches_jax(k, m):
    for seed in range(12):
        st, ci, cd = _random_case(seed, k, m)
        j_state, j_changes = jn.merge_candidates(st, jnp.asarray(ci), jnp.asarray(cd))
        t_state, t_changes = tn.merge_candidates(_to_torch_state(st), t(ci), t(cd))
        _assert_state_equal(j_state, t_state)
        assert int(t_changes) == int(j_changes)


def test_merge_incumbent_wins_exact_tie():
    st = tn.make_neighbor_state(1, 3)
    st, _ = tn.merge_candidates(st, t(np.array([[4]], np.int32)), t(np.array([[1.0]], np.float32)))
    st = st._replace(flag=st.flag & False)
    st2, changes = tn.merge_candidates(st, t(np.array([[4]], np.int32)),
                                       t(np.array([[1.0]], np.float32)))
    assert int(changes) == 0
    assert not bool(st2.flag[0, 0])


def test_merge_rows_in_place_matches_blocked_merge():
    st, ci, cd = _random_case(3, 6, 20, rows=10)
    j_state, _ = jn.merge_candidates(st, jnp.asarray(ci), jnp.asarray(cd))
    t_state = _to_torch_state(st)
    for s0 in tn.block_starts(10, 4):  # 0, 4, 6: the last block re-merges rows 6-7
        tn.merge_rows_(t_state, s0, t(ci[s0:s0 + 4]), t(cd[s0:s0 + 4]))
    _assert_state_equal(j_state, t_state)


def test_sort_by_distance_matches_jax():
    rs = np.random.RandomState(5)
    idx = rs.randint(-1, 20, (6, 9)).astype(np.int32)
    d = rs.choice(DIST_VALUES[DIST_VALUES == DIST_VALUES], (6, 9)).astype(np.float32)
    ji, jdist = jn.sort_by_distance(jnp.asarray(idx), jnp.asarray(d))
    ti, tdist = tn.sort_by_distance(t(idx), t(d))
    np.testing.assert_array_equal(n(tdist), n(jdist))
    np.testing.assert_array_equal(n(ti)[np.isfinite(n(tdist))], n(ji)[np.isfinite(n(jdist))])


def test_state_from_graph_matches_jax():
    rs = np.random.RandomState(6)
    idx = rs.randint(-1, 30, (8, 12)).astype(np.int32)
    d = rs.rand(8, 12).astype(np.float32)
    for k, flag_new in ((12, True), (5, False)):
        j_state = jn.state_from_graph(jnp.asarray(idx), jnp.asarray(d), k=k, flag_new=flag_new)
        t_state = tn.state_from_graph(t(idx), t(d), k=k, flag_new=flag_new)
        _assert_state_equal(j_state, t_state)


def test_float_order_key_orders_like_floats():
    v = np.array([-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.finfo(np.float32).max, np.inf],
                 np.float32)
    key = n(tn.float_order_key(t(v)))
    assert np.all(np.diff(key[[0, 1, 2, 3, 5, 6, 7, 8]]) > 0)
    assert key[3] == key[4]  # -0.0 and +0.0 alike (lax.sort)
    raw = n(tn.float_order_key(t(v), canonical_zero=False))
    assert np.all(np.diff(raw) > 0)  # -0.0 first (lax.top_k)
