"""The pruned (cell-screened) search of arrowspace_torch against the JAX
package's, in float64 on the CPU.

Each case of tests/test_pruned.py runs here in both packages on the same
numpy inputs: the cell layouts (host and device builds) are held unit
for unit, pruned_topk and pruned_topk_union output for output (ids and
flags equal), the sessions result for result, with their fallbacks and
auto-budget trajectories, and a .npz written by either package is
served by the other.  Session tests carry the JAX index across
(convert.from_jax_state), so both serve the same rows, graph and λ.

Two tests pin the port's deliberate divergences from the JAX package:
test_device_build_zero_row_is_sound (the device build's cos θr from the
least member dot, with the host build as the oracle) and
test_auto_budget_waits_for_a_full_window.

Tolerances: ids, flags and unit layouts exact; scores and bound
metadata within 1e-12 (float64; the packages sum products in another
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arrowspace_tpu import pruned as jp
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_torch import pruned as tp
from arrowspace_torch.convert import from_jax_state
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops.search import batched_lambda_aware_topk
from arrowspace_torch.taumode import TauMode
from helpers import oracle_adjacency, oracle_laplacian

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-12


def _clustered(n=600, f=24, centers=8, noise=0.03, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centers, f))
    return c[rng.integers(0, centers, n)] + rng.normal(0, noise, (n, f))


def _uniform(n=400, f=32, seed=5):
    return np.random.default_rng(seed).normal(size=(n, f))


def _cells(rows, lam, device_build=False, **kw):
    """(JAX cells, port cells) of one build on the same inputs."""
    jb = jp.build_cells_device if device_build else jp.build_cells
    tb = tp.build_cells_device if device_build else tp.build_cells
    return jb(rows, lam, **kw), tb(rows, lam, device="cpu", **kw)


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _assert_same_cells(tc, jc, skip_units=()):
    assert (tc.cap, tc.n_units) == (jc.cap, jc.n_units)
    np.testing.assert_array_equal(_np(tc.ids), _np(jc.ids))
    for name in ("x", "lam", "cent", "radius", "cosr", "sinr", "lam_lo",
                 "lam_hi"):
        t, j = _np(getattr(tc, name)), _np(getattr(jc, name))
        assert t.shape == j.shape and t.dtype == np.float64, name
        keep = np.ones(t.shape[0], dtype=bool)
        if name not in ("x", "lam"):
            keep[list(skip_units)] = False
        np.testing.assert_allclose(t[keep], j[keep], rtol=0, atol=TOL,
                                   err_msg=name)


def _arrays(c):
    return (c.x, c.lam, c.ids, c.cent, c.radius, c.cosr, c.sinr, c.lam_lo,
            c.lam_hi)


def _run_pruned(jc, tc, queries, qlam, alpha, k, m_cells, margin=1e-3,
                **kw):
    """pruned_topk in both packages: the port's (scores, ids, third),
    after holding it to the JAX package's."""
    js = jp.pruned_topk(jnp.asarray(queries), jnp.asarray(qlam),
                        *_arrays(jc), alpha, k=k, m_cells=m_cells,
                        cap=jc.cap, margin=margin, **kw)
    ts = tp.pruned_topk(torch.as_tensor(queries), torch.as_tensor(qlam),
                        *_arrays(tc), alpha, k=k, m_cells=m_cells,
                        cap=tc.cap, margin=margin, **kw)
    return _same_out(ts, js)


def _run_union(jc, tc, queries, qlam, alpha, k, m_vote, s_cells,
               margin=1e-3):
    js = jp.pruned_topk_union(jnp.asarray(queries), jnp.asarray(qlam),
                              *_arrays(jc), alpha, k=k, m_vote=m_vote,
                              s_cells=s_cells, cap=jc.cap, margin=margin)
    ts = tp.pruned_topk_union(torch.as_tensor(queries),
                              torch.as_tensor(qlam), *_arrays(tc), alpha,
                              k=k, m_vote=m_vote, s_cells=s_cells,
                              cap=tc.cap, margin=margin)
    return _same_out(ts, js)


def _same_out(ts, js):
    (s, i, third), (rs, ri, rthird) = [tuple(_np(a) for a in out)
                                       for out in (ts, js)]
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, rtol=0, atol=TOL)
    if third.dtype == bool:
        np.testing.assert_array_equal(third, rthird)
    else:
        np.testing.assert_allclose(third, rthird, rtol=0, atol=TOL)
    return s, i, third


def _oracle(queries, qlam, rows, lam, alpha, k):
    s, i = batched_lambda_aware_topk(
        torch.as_tensor(queries), torch.as_tensor(qlam),
        torch.as_tensor(rows), torch.as_tensor(lam), alpha, k=k)
    return s.numpy(), i.numpy()


def _assert_certified_exact(s, i, fl, so, io):
    for b in range(len(fl)):
        if not fl[b]:
            np.testing.assert_array_equal(i[b], io[b])
            np.testing.assert_allclose(s[b], so[b], rtol=TOL)


def _dominates(cells, rows, lam, alpha, slack):
    """Brute-force float64 check that each real unit's stored cap bound
    is at least every member's shifted score, for 5 random queries."""
    c1 = 1 - alpha
    rng = np.random.default_rng(9)
    f = rows.shape[1]
    queries = rng.normal(size=(5, f))
    qlam = rng.uniform(0, 2, 5)
    qhat = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    xhat = np.where(norms > 0, rows / np.where(norms > 0, norms, 1), 0)
    ids = _np(cells.ids)
    cent, cosr, sinr, lo, hi, rad = (_np(a) for a in (
        cells.cent, cells.cosr, cells.sinr, cells.lam_lo, cells.lam_hi,
        cells.radius))
    per_unit = ids.reshape(-1, cells.cap)
    for b in range(5):
        for u in range(per_unit.shape[0]):
            members = per_unit[u][per_unit[u] >= 0]
            if len(members) == 0:
                assert rad[u] == -2.0
                continue
            s = alpha * (xhat[members] @ qhat[b]) - c1 * np.minimum(
                np.abs(qlam[b] - lam[members]), 1.0)
            dmin = max(0.0, lo[u] - qlam[b], qlam[b] - hi[u])
            c = float(qhat[b] @ cent[u])
            capsup = 1.0 if c >= cosr[u] else \
                c * cosr[u] + np.sqrt(max(0.0, 1.0 - c * c)) * sinr[u]
            assert alpha * capsup - c1 * min(dmin, 1.0) >= s.max() - slack


# ---------------------------------------------------------------- cells


def test_build_cells_partitions_rows():
    rows = _clustered()
    lam = np.random.default_rng(0).uniform(0, 1, rows.shape[0])
    jc, tc = _cells(rows, lam, cap=32, seed=1, iters=4)
    _assert_same_cells(tc, jc)
    ids = _np(tc.ids)
    assert sorted(ids[ids >= 0].tolist()) == list(range(rows.shape[0]))
    xhat = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    pos = np.nonzero(ids >= 0)[0]
    np.testing.assert_allclose(_np(tc.x)[pos], xhat[ids[pos]], rtol=1e-12)
    np.testing.assert_allclose(_np(tc.lam)[pos], lam[ids[pos]], rtol=0)
    per_unit = ids.reshape(-1, tc.cap)
    rad = _np(tc.radius)
    for u in range(per_unit.shape[0]):
        if not (per_unit[u] >= 0).any():
            assert rad[u] == -2.0
            assert _np(tc.lam_lo)[u] == np.inf
            assert _np(tc.lam_hi)[u] == -np.inf


def test_cell_bounds_dominate_member_scores():
    rows = _clustered(n=300, f=16, seed=7)
    lam = np.random.default_rng(1).uniform(0, 2, 300)
    jc, tc = _cells(rows, lam, cap=16, seed=2, iters=4)
    _assert_same_cells(tc, jc)
    _dominates(tc, rows, lam, 0.8, 1e-12)


def test_build_cells_large_n_knobs():
    rows = _clustered(n=600, f=24, seed=71)
    lam = np.random.default_rng(40).uniform(0, 1, 600)
    jc, tc = _cells(rows, lam, cap=32, seed=1, iters=4, n_clusters=8,
                    lloyd_sample=200)
    _assert_same_cells(tc, jc)
    assert tc.n_units >= 8
    rng = np.random.default_rng(41)
    queries = rows[rng.integers(0, 600, 6)] * 1.02
    qlam = lam[rng.integers(0, 600, 6)]
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 10)
    s, i, fl = _run_pruned(jc, tc, queries, qlam, 0.9, 10, m_cells=10)
    _assert_certified_exact(s, i, fl, so, io)
    assert fl.sum() <= 2


def test_build_cells_device_partitions_and_bounds():
    rows = _clustered(n=500, f=16, centers=10, seed=73)
    lam = np.random.default_rng(42).uniform(0, 2, 500)
    jc, tc = _cells(rows, lam, device_build=True, cap=16, seed=2, iters=4)
    _assert_same_cells(tc, jc)
    ids = _np(tc.ids)
    assert sorted(ids[ids >= 0].tolist()) == list(range(500))
    _dominates(tc, rows, lam, 0.8, 1e-9)


def test_build_cells_device_edge_cases():
    """One unit (n < cap) equal to JAX's; with a zero row every unit but
    the zero row's equals JAX's, and that unit keeps a cap wide enough
    for the zero vector (cos θr <= 0, where JAX's 1 - d²/2 gives 0.5)."""
    rows = _clustered(n=40, f=8, centers=2, seed=79)
    lam = np.random.default_rng(50).uniform(0, 1, 40)
    jc, tc = _cells(rows, lam, device_build=True, cap=64, seed=1, iters=2)
    _assert_same_cells(tc, jc)
    assert tc.n_units == 1
    rows2 = _clustered(n=60, f=8, centers=2, seed=83)
    rows2[17] = 0.0
    lam2 = np.random.default_rng(51).uniform(0, 1, 60)
    jc2, tc2 = _cells(rows2, lam2, device_build=True, cap=8, seed=2,
                      iters=2)
    ids2 = _np(tc2.ids)
    assert sorted(ids2[ids2 >= 0].tolist()) == list(range(60))
    u0 = int(np.nonzero(ids2 == 17)[0][0]) // tc2.cap
    _assert_same_cells(tc2, jc2, skip_units=[u0])
    assert _np(tc2.radius)[u0] > 0.9
    assert _np(tc2.cosr)[u0] <= 0.0 < _np(jc2.cosr)[u0]
    _dominates(tc2, rows2, lam2, 0.8, 1e-9)


# ------------------------------------------------------------ pruned_topk


@pytest.mark.parametrize("alpha", [1.0, 0.9, 0.0])
def test_pruned_matches_oracle_on_clustered_data(alpha):
    rows = _clustered(n=800, f=24, seed=11)
    lam = np.random.default_rng(2).uniform(0, 1, 800)
    jc, tc = _cells(rows, lam, cap=32, seed=3)
    _assert_same_cells(tc, jc)
    rng = np.random.default_rng(4)
    queries = rows[rng.integers(0, 800, 6)] * 1.02
    qlam = lam[rng.integers(0, 800, 6)]
    so, io = _oracle(queries, qlam, rows, lam, alpha, 10)
    s, i, fl = _run_pruned(jc, tc, queries, qlam, alpha, 10, m_cells=12)
    _assert_certified_exact(s, i, fl, so, io)
    if alpha >= 0.9:
        assert fl.sum() <= 2, fl


def test_pruned_return_next_bound_matches_jax():
    """return_next_bound (the mesh callers' certificate input): the
    (M+1)-th bound on the shifted plane, -inf with every unit scanned."""
    rows = _clustered(n=800, f=24, seed=11)
    lam = np.random.default_rng(2).uniform(0, 1, 800)
    jc, tc = _cells(rows, lam, cap=32, seed=3)
    rng = np.random.default_rng(5)
    queries = rows[rng.integers(0, 800, 6)] * 1.02
    qlam = lam[rng.integers(0, 800, 6)]
    _, _, nb = _run_pruned(jc, tc, queries, qlam, 0.9, 10, m_cells=4,
                           return_next_bound=True)
    assert np.isfinite(nb).all()
    u = tc.cent.shape[0]
    _, _, nb_all = _run_pruned(jc, tc, queries, qlam, 0.9, 10, m_cells=u,
                               return_next_bound=True)
    assert (nb_all == -np.inf).all()


def test_pruned_scanning_all_units_is_exact_and_unflagged():
    rows = _clustered(n=300, f=16, seed=13)
    lam = np.random.default_rng(3).uniform(0, 1, 300)
    jc, tc = _cells(rows, lam, cap=16, seed=1)
    u = tc.cent.shape[0]
    queries = _uniform(4, 16, seed=6)
    qlam = np.random.default_rng(7).uniform(0, 1, 4)
    so, io = _oracle(queries, qlam, rows, lam, 0.7, 7)
    s, i, fl = _run_pruned(jc, tc, queries, qlam, 0.7, 7, m_cells=u)
    assert not fl.any()
    np.testing.assert_array_equal(i, io)
    np.testing.assert_allclose(s, so, rtol=TOL)


def test_pruned_flags_when_bounds_cannot_certify():
    rows = _uniform(n=512, f=64, seed=17)
    lam = np.random.default_rng(5).uniform(0, 1, 512)
    jc, tc = _cells(rows, lam, cap=32, seed=2)
    _assert_same_cells(tc, jc)
    queries = _uniform(3, 64, seed=19)
    qlam = np.random.default_rng(6).uniform(0, 1, 3)
    s, i, fl = _run_pruned(jc, tc, queries, qlam, 0.9, 10, m_cells=2)
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 10)
    _assert_certified_exact(s, i, fl, so, io)
    assert fl.any()


def test_pruned_duplicate_tie_order_matches_oracle():
    rows = _clustered(n=200, f=16, seed=23)
    rows[150] = rows[10]
    lam = np.random.default_rng(8).uniform(0, 1, 200)
    lam[150] = lam[10]
    jc, tc = _cells(rows, lam, cap=8, seed=4)
    q = rows[10:11] * 1.02
    qlam = lam[10:11]
    so, io = _oracle(q, qlam, rows, lam, 0.9, 6)
    s, i, fl = _run_pruned(jc, tc, q, qlam, 0.9, 6,
                           m_cells=tc.cent.shape[0])
    assert not fl[0]
    assert 10 in io[0] and 150 in io[0]
    np.testing.assert_array_equal(i[0], io[0])
    p10, p150 = list(i[0]).index(10), list(i[0]).index(150)
    assert s[0][p10] == s[0][p150]


def test_pruned_flags_underfilled_topk():
    rows = _clustered(n=100, f=16, seed=29)
    lam = np.random.default_rng(9).uniform(0, 1, 100)
    jc, tc = _cells(rows, lam, cap=4, seed=5)
    _assert_same_cells(tc, jc)
    _, i, fl = _run_pruned(jc, tc, rows[:1] * 1.01, lam[:1], 0.9, 8,
                           m_cells=1)
    assert fl[0] and (i[0] == -1).any()


def test_pruned_k_above_32_sort_fallback_matches_oracle():
    rows = _clustered(n=700, f=24, centers=10, seed=51)
    lam = np.random.default_rng(52).uniform(0, 1, 700)
    jc, tc = _cells(rows, lam, cap=64, seed=1, iters=4)
    rng = np.random.default_rng(53)
    qi = rng.integers(0, 700, 8)
    queries, qlam, k = rows[qi] * 1.02, lam[qi], 40
    so, io = _oracle(queries, qlam, rows, lam, 0.9, k)
    u = tc.cent.shape[0]
    s, i, fl = _run_pruned(jc, tc, queries, qlam, 0.9, k, m_cells=u)
    assert not fl.any()
    np.testing.assert_array_equal(i, io)
    np.testing.assert_allclose(s, so, rtol=TOL)
    _, ui, ufl = _run_union(jc, tc, queries, qlam, 0.9, k, m_vote=4,
                            s_cells=u)
    assert not ufl.any()
    np.testing.assert_array_equal(ui, io)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("k", [1, 8, 13, 40])
def test_extract_topk_lowest_id_matches_jax(k, shared):
    """The port's extraction (stable sorts) on quantised scores dense with
    exact ties and a padding-heavy row, with ids shared by every row (the
    union) or per row: equal to the JAX package's (masked passes up to
    k = 32, its sort above) and to a (-score, id) sort."""
    rng = np.random.default_rng(2)
    sc = rng.integers(0, 7, (5, 96)) / 7.0
    ids = rng.permutation(960)[:96].astype(np.int32)
    sc[0, :50] = -np.inf
    if not shared:
        ids = np.stack([rng.permutation(ids) for _ in range(5)])
    ts, ti = tp._extract_topk_lowest_id(torch.as_tensor(sc),
                                        torch.as_tensor(ids), k)
    js, ji = jp._extract_topk_lowest_id(jnp.asarray(sc), jnp.asarray(ids),
                                        k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for r in range(5):
        row_ids = ids if shared else ids[r]
        order = np.lexsort((row_ids, -sc[r]))[:k]
        np.testing.assert_array_equal(ti[r].numpy(), row_ids[order])


# ------------------------------------------------------------- sessions


def _pruned_index(n=700, f=24, seed=31, centers=8):
    rows = _clustered(n=n, f=f, centers=centers, seed=seed)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    a = j.aspace
    t = from_jax_state(rows, np.asarray(a.lambdas), np.asarray(j.gl.matrix),
                       a.taumode, **CPU64)
    return rows, j, t


def _same_results(res_t, res_j):
    (ts, ti), (js, ji) = res_t, res_j
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)


def _both_search(jsess, tsess, t, queries, k=5, alpha=0.9):
    """Both sessions on the same queries: equal to each other and to the
    port's full search."""
    res_t = tsess.search(queries)
    _same_results(res_t, jsess.search(queries))
    _same_results(res_t, t.search(queries, k=k, alpha=alpha))
    return res_t


def test_session_matches_full_search():
    rows, j, t = _pruned_index()
    kw = dict(batch_size=8, k=5, alpha=0.9, cap=32, seed=1)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    _assert_same_cells(ts.cells, js.cells)
    ts.warmup()
    js.warmup()
    rng = np.random.default_rng(12)
    _both_search(js, ts, t, rows[rng.integers(0, rows.shape[0], 8)] * 1.03)
    assert ts.queries_total >= 8
    assert (ts.m_cells, ts.union_cells, ts.m_vote) == \
        (js.m_cells, js.union_cells, js.m_vote)


def test_session_fallback_equals_oracle_on_adversarial_data():
    rows = _uniform(n=400, f=32, seed=37)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    t = from_jax_state(rows, np.asarray(j.aspace.lambdas),
                       np.asarray(j.gl.matrix), j.aspace.taumode, **CPU64)
    kw = dict(batch_size=4, k=6, alpha=0.9, cap=32, m_cells=1, seed=2)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    _both_search(js, ts, t, _uniform(4, 32, seed=41), k=6)
    assert ts.flag_rate > 0.5
    assert ts.flag_rate == js.flag_rate


def test_session_partial_batch_and_single_query():
    rows, j, t = _pruned_index(n=400)
    js = j.make_pruned_session(batch_size=8, k=5, seed=3)
    ts = t.make_pruned_session(batch_size=8, k=5, seed=3)
    s, i = _both_search(js, ts, t, rows[42] * 1.02)
    assert s.shape == (1, 5) and i[0][0] == 42
    s3, i3 = _both_search(js, ts, t, rows[:3] * 1.02)
    assert s3.shape == (3, 5)
    assert [i3[b][0] for b in range(3)] == [0, 1, 2]


def test_session_validation():
    _rows, _j, t = _pruned_index(n=300)
    with pytest.raises(ValueError, match=r"\[1, 512\]"):
        t.make_pruned_session(batch_size=1024)
    with pytest.raises(ValueError, match="engine"):
        t.make_pruned_session(batch_size=4, engine="tpu")
    sess = t.make_pruned_session(batch_size=4, seed=1)
    with pytest.raises(ValueError, match="batch"):
        sess.search(np.ones((5, 24)))
    with pytest.raises(ValueError, match="dim"):
        sess.search(np.ones((2, 7)))


def test_build_cells_device_session_matches_full_search():
    rows, j, t = _pruned_index(n=700)
    kw = dict(cap=32, seed=5, n_clusters=16, lloyd_sample=300)
    jc = jp.build_cells_device(j.aspace.data, j.aspace.lambdas, **kw)
    tc = tp.build_cells_device(t.aspace.data, t.aspace.lambdas, **kw)
    _assert_same_cells(tc, jc)
    js = jp.PrunedSearchSession(j, 8, k=5, alpha=0.9, cells=jc)
    ts = tp.PrunedSearchSession(t, 8, k=5, alpha=0.9, cells=tc)
    ts.warmup()
    rng = np.random.default_rng(44)
    _both_search(js, ts, t, rows[rng.integers(0, rows.shape[0], 8)] * 1.03)


def test_session_device_engine_and_knobs():
    rows, j, t = _pruned_index(n=600)
    kw = dict(batch_size=8, k=5, alpha=0.9, cap=32, seed=4, engine="device",
              n_clusters=24, lloyd_sample=300)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    _assert_same_cells(ts.cells, js.cells)
    rng = np.random.default_rng(45)
    _both_search(js, ts, t, rows[rng.integers(0, rows.shape[0], 8)] * 1.02)


def test_session_reuses_prebuilt_cells():
    rows, j, t = _pruned_index(n=300)
    cells = tp.build_cells(t.aspace.data, t.aspace.lambdas, cap=32, seed=9)
    s1 = tp.PrunedSearchSession(t, 4, k=5, cells=cells)
    s2 = t.make_pruned_session(batch_size=4, k=5, cap=32, seed=9)
    _assert_same_cells(s2.cells, cells)
    q = rows[5:9] * 1.01
    np.testing.assert_array_equal(s1.search(q)[1], s2.search(q)[1])


# ---------------------------------------------------- two-level (union)


@pytest.mark.parametrize("alpha", [1.0, 0.9])
def test_union_matches_oracle_on_hot_region_batch(alpha):
    rows = _clustered(n=900, f=24, seed=43)
    lam = np.random.default_rng(21).uniform(0, 1, 900)
    jc, tc = _cells(rows, lam, cap=32, seed=3)
    _assert_same_cells(tc, jc)
    rng = np.random.default_rng(22)
    queries = np.repeat(rows[[5, 300, 700]], 8, axis=0) \
        * (1.0 + 0.02 * rng.uniform(size=(24, 1)))
    qlam = lam[np.repeat([5, 300, 700], 8)]
    so, io = _oracle(queries, qlam, rows, lam, alpha, 10)
    s, i, fl = _run_union(jc, tc, queries, qlam, alpha, 10, m_vote=6,
                          s_cells=24)
    _assert_certified_exact(s, i, fl, so, io)
    assert fl.sum() <= 6, fl.sum()


def test_union_all_units_is_exact_and_unflagged():
    rows = _clustered(n=300, f=16, seed=47)
    lam = np.random.default_rng(23).uniform(0, 1, 300)
    jc, tc = _cells(rows, lam, cap=16, seed=1)
    queries = _uniform(20, 16, seed=48)
    qlam = np.random.default_rng(24).uniform(0, 1, 20)
    so, io = _oracle(queries, qlam, rows, lam, 0.7, 7)
    s, i, fl = _run_union(jc, tc, queries, qlam, 0.7, 7, m_vote=4,
                          s_cells=tc.cent.shape[0])
    assert not fl.any()
    np.testing.assert_array_equal(i, io)
    np.testing.assert_allclose(s, so, rtol=TOL)


def test_union_budget_overflow_flags_not_wrong():
    rows = _clustered(n=800, f=24, centers=20, seed=53)
    lam = np.random.default_rng(25).uniform(0, 1, 800)
    jc, tc = _cells(rows, lam, cap=16, seed=2)
    rng = np.random.default_rng(26)
    queries = rows[rng.integers(0, 800, 32)] * 1.02
    qlam = lam[rng.integers(0, 800, 32)]
    so, io = _oracle(queries, qlam, rows, lam, 0.9, 8)
    s, i, fl = _run_union(jc, tc, queries, qlam, 0.9, 8, m_vote=4,
                          s_cells=2)
    assert fl.any()
    _assert_certified_exact(s, i, fl, so, io)


def test_union_duplicate_tie_order_matches_oracle():
    rows = _clustered(n=240, f=16, seed=59)
    rows[190] = rows[12]
    lam = np.random.default_rng(27).uniform(0, 1, 240)
    lam[190] = lam[12]
    jc, tc = _cells(rows, lam, cap=8, seed=4)
    q = np.repeat(rows[12:13] * 1.02, 20, axis=0)
    qlam = np.repeat(lam[12:13], 20)
    so, io = _oracle(q, qlam, rows, lam, 0.9, 6)
    s, i, fl = _run_union(jc, tc, q, qlam, 0.9, 6, m_vote=4,
                          s_cells=tc.cent.shape[0])
    assert not fl.any()
    np.testing.assert_array_equal(i, io)
    assert 12 in i[0] and 190 in i[0]
    assert s[0][list(i[0]).index(12)] == s[0][list(i[0]).index(190)]


def test_union_kernel_large_batch_exactness():
    rows = _clustered(n=900, f=24, centers=12, seed=31)
    lam = np.random.default_rng(32).uniform(0, 1, 900)
    jc, tc = _cells(rows, lam, cap=32, seed=1, iters=4)
    rng = np.random.default_rng(33)
    qi = rng.integers(0, 900, 640)
    s, i, fl = _run_union(jc, tc, rows[qi] * 1.02, lam[qi], 0.9, 5,
                          m_vote=6, s_cells=tc.cent.shape[0])
    assert not fl.any()
    _, io = _oracle(rows[qi] * 1.02, lam[qi], rows, lam, 0.9, 5)
    np.testing.assert_array_equal(i, io)


def test_union_session_matches_full_search():
    rows, j, t = _pruned_index(n=900)
    kw = dict(batch_size=32, k=5, alpha=0.9, cap=32, seed=1, m_vote=6,
              union_cells=20)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    ts.warmup()
    js.warmup()
    rng = np.random.default_rng(28)
    queries = rows[rng.integers(0, rows.shape[0], 32)] * 1.03
    _both_search(js, ts, t, queries)
    _both_search(js, ts, t, queries[:5])
    assert ts.flagged_total == js.flagged_total


def test_union_partial_batch_pads_do_not_displace_votes():
    """Cyclic padding keeps the vote order: 2 real rows certify; pads of
    ones (the negative control) displace their units and flag both."""
    rows = _clustered(n=800, f=24, centers=20, seed=44)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    t = from_jax_state(rows, np.asarray(j.aspace.lambdas),
                       np.asarray(j.gl.matrix), j.aspace.taumode, **CPU64)
    kw = dict(batch_size=32, k=5, alpha=0.9, cap=16, seed=2, m_vote=4,
              union_cells=6)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    ts.warmup()
    js.warmup()
    base = rows[[5, 300]] * 1.01
    before = ts.flagged_total
    _both_search(js, ts, t, base)
    assert ts.flagged_total == before
    q_ones = np.pad(base, ((0, 30), (0, 0)), constant_values=1.0)
    fl_ones = ts._step(torch.as_tensor(q_ones))[2].numpy()
    assert int(fl_ones[:2].sum()) == 2
    np.testing.assert_array_equal(
        fl_ones, np.asarray(js._step(jnp.asarray(q_ones))[2]))


# ----------------------------------------------------------- auto-budget


def test_auto_budget_grows_union_until_flags_clear():
    """With auto_window equal to the batch, both packages grow the union
    along the same trajectory (flags and union_cells batch by batch), and
    every result equals the full search."""
    rows = _clustered(n=800, f=24, centers=20, seed=61)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    t = from_jax_state(rows, np.asarray(j.aspace.lambdas),
                       np.asarray(j.gl.matrix), j.aspace.taumode, **CPU64)
    kw = dict(batch_size=32, k=5, alpha=0.9, cap=16, seed=2, m_vote=4,
              union_cells=2, auto_budget=True)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    js.auto_window = ts.auto_window = 32
    rng = np.random.default_rng(30)
    base = rows[[5, 300, 700]]
    trajectory = []
    for _ in range(8):
        queries = np.repeat(base, 11, axis=0)[:32] \
            * (1.0 + 0.02 * rng.uniform(size=(32, 1)))
        before = ts.flagged_total
        _both_search(js, ts, t, queries)
        trajectory.append((ts.flagged_total - before, ts.union_cells))
        assert (ts.flagged_total, ts.union_cells) == \
            (js.flagged_total, js.union_cells)
    assert ts.budget_growths == js.budget_growths >= 1
    assert ts.union_cells * ts.cells.cap <= max(800 // 4, ts.cells.cap)
    assert trajectory[-1][0] <= 4, trajectory


def test_auto_budget_grows_m_cells_at_small_batch():
    rows = _uniform(n=1024, f=32, seed=67)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=7)
    t = from_jax_state(rows, np.asarray(j.aspace.lambdas),
                       np.asarray(j.gl.matrix), j.aspace.taumode, **CPU64)
    kw = dict(batch_size=4, k=5, alpha=0.9, cap=8, m_cells=1, seed=3,
              auto_budget=True)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    js.auto_window = ts.auto_window = 4
    rng = np.random.default_rng(31)
    for _ in range(12):
        _both_search(js, ts, t, rng.normal(size=(4, 32)))
        assert ts.m_cells == js.m_cells
    assert ts.budget_growths == js.budget_growths >= 1
    assert ts.m_cells == ts._budget_max == js._budget_max


def test_auto_budget_idle_below_target():
    rows, j, t = _pruned_index(n=700)
    sess = t.make_pruned_session(batch_size=32, k=5, alpha=0.9, cap=32,
                                 seed=1, m_vote=6, union_cells=24,
                                 auto_budget=True)
    sess.warmup()
    rng = np.random.default_rng(33)
    for _ in range(4):
        sess.search(np.repeat(rows[5][None, :], 32, axis=0)
                    * (1.0 + 0.01 * rng.uniform(size=(32, 1))))
    assert sess.budget_growths == 0 and sess.union_cells == 24
    assert sess.flagged_total == 0


def test_auto_budget_waits_for_a_full_window():
    """Divergence from the JAX package, whose window decides early: one
    16-query batch with a single flag (rate 1/16 > the 0.05 target) grows
    the JAX session's m_cells at once, though its window holds 16 of the
    256 queries it should judge; the port waits for a full window, and
    then grows when the rate over it stays above the target."""
    rows, j, t = _pruned_index(n=14_000, centers=400)
    kw = dict(batch_size=16, k=5, alpha=0.9, cap=16, seed=1, m_cells=6,
              auto_budget=True)
    js, ts = j.make_pruned_session(**kw), t.make_pruned_session(**kw)
    assert ts.auto_window == js.auto_window == 256
    # a batch with exactly one uncertifiable query
    rng = np.random.default_rng(34)
    queries = rows[rng.integers(0, rows.shape[0], 16)] * 1.02
    queries[0] = rng.normal(size=24)
    _both_search(js, ts, t, queries)
    assert ts.flagged_total == js.flagged_total == 1
    assert js.budget_growths == 1 and js.m_cells == 12
    assert ts.budget_growths == 0 and ts.m_cells == 6
    for _ in range(14):
        ts.search(queries)
    assert ts.budget_growths == 0            # 15 batches: 240 queries
    ts.search(queries)                       # the 256th query
    assert ts.budget_growths == 1 and ts.m_cells == 12


# ----------------------------------------------------- persistence


def test_cells_save_load_roundtrip(tmp_path):
    rows, j, t = _pruned_index(n=500)
    cells = tp.build_cells(t.aspace.data, t.aspace.lambdas, cap=32, seed=6)
    p = str(tmp_path / "cells")
    tp.save_cells(cells, p)
    loaded = tp.load_cells(p, device="cpu")
    assert loaded.cap == cells.cap and loaded.n_units == cells.n_units
    for name in tp._FIELDS:
        assert torch.equal(getattr(loaded, name), getattr(cells, name))
    q = rows[7:11] * 1.01
    s1 = tp.PrunedSearchSession(t, 4, k=5, cells=cells)
    s2 = tp.PrunedSearchSession(t, 4, k=5, cells=loaded)
    for a, b in zip(s1.search(q), s2.search(q)):
        np.testing.assert_array_equal(a, b)
    bad = dict(np.load(p + ".npz"))
    bad["format"] = np.int64(99)
    np.savez(p + "_bad", **bad)
    with pytest.raises(ValueError, match="format"):
        tp.load_cells(p + "_bad", device="cpu")


def test_jax_written_cells_serve_in_port(tmp_path):
    """A layout the JAX package saved loads into the port bitwise and
    serves the JAX session's results."""
    rows, j, t = _pruned_index(n=500)
    jc = jp.build_cells(j.aspace.data, j.aspace.lambdas, cap=32, seed=6)
    p = str(tmp_path / "jax_cells")
    jp.save_cells(jc, p)
    tc = tp.load_cells(p, device="cpu")
    for name in tp._FIELDS:
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      _np(getattr(jc, name)))
    js = jp.PrunedSearchSession(j, 8, k=5, cells=jc)
    ts = tp.PrunedSearchSession(t, 8, k=5, cells=tc)
    rng = np.random.default_rng(46)
    _both_search(js, ts, t, rows[rng.integers(0, 500, 8)] * 1.02)


def test_port_written_cells_serve_in_jax(tmp_path):
    rows, j, t = _pruned_index(n=500)
    tc = tp.build_cells_device(t.aspace.data, t.aspace.lambdas, cap=32,
                               seed=8)
    p = str(tmp_path / "port_cells")
    tp.save_cells(tc, p)
    jc = jp.load_cells(p)
    for name in tp._FIELDS:
        np.testing.assert_array_equal(_np(getattr(jc, name)),
                                      _np(getattr(tc, name)))
    js = jp.PrunedSearchSession(j, 8, k=5, cells=jc)
    ts = tp.PrunedSearchSession(t, 8, k=5, cells=tc)
    rng = np.random.default_rng(47)
    _both_search(js, ts, t, rows[rng.integers(0, 500, 8)] * 1.02)


# ----------------------------------------------------- divergences


def _zero_row_corpus():
    """Two tight clusters along unit directions u and w with
    cos(u, w) = 0.3, a zero row among u's, and the query -u: every real
    row scores about -0.3 or -1 against it, the zero row 0 (the true
    top-1).  In the zero row's unit the zero vector lies at d² = 1 from
    the centroid, so JAX's 1 - d²/2 puts cos θr near 0.5, where the
    least member dot is 0."""
    rng = np.random.default_rng(91)
    f = 8
    u = np.zeros(f)
    u[:4] = 0.5
    w = 0.3 * u + np.sqrt(1 - 0.09) * np.eye(f)[7]
    rows = np.vstack([u + rng.normal(0, 0.01, (30, f)),
                      w + rng.normal(0, 0.01, (30, f))])
    rows[5] = 0.0
    lam = rng.uniform(0, 1, 60)
    return rows, lam, -u[None, :]


def test_device_build_zero_row_is_sound():
    """Divergence from the JAX package's unsound device cap: on the
    zero-row corpus the port's device build keeps the zero row's unit in
    reach, so its certified top-1 is the host build's (and the full
    scan's), the zero row; the JAX device build certifies a wrong top-1
    there."""
    rows, lam, q = _zero_row_corpus()
    qlam = lam[:1]
    kw = dict(cap=64, seed=2, n_clusters=2, iters=4)
    host = tp.build_cells(rows, lam, device="cpu", **kw)
    dev = tp.build_cells_device(rows, lam, device="cpu", **kw)
    jdev = jp.build_cells_device(rows, lam, **kw)
    assert host.n_units == dev.n_units == 2
    np.testing.assert_array_equal(_np(dev.ids), _np(host.ids))
    so, io = _oracle(q, qlam, rows, lam, 1.0, 1)
    assert io[0, 0] == 5 and so[0, 0] == 0.0

    def run(c, pkg, conv):
        s, i, fl = pkg.pruned_topk(conv(q), conv(qlam), *_arrays(c), 1.0,
                                   k=1, m_cells=1, cap=c.cap, margin=1e-3)
        return _np(s), _np(i), _np(fl)

    hs, hi, hfl = run(host, tp, torch.as_tensor)
    ds, di, dfl = run(dev, tp, torch.as_tensor)
    assert not hfl[0] and hi[0, 0] == 5
    np.testing.assert_array_equal(di, hi)
    np.testing.assert_array_equal(dfl, hfl)
    np.testing.assert_allclose(ds, hs, rtol=0, atol=TOL)
    _, ji, jfl = run(jdev, jp, jnp.asarray)
    assert not jfl[0] and ji[0, 0] != 5       # certified, and wrong


def test_session_fallback_through_binned_engine():
    """A 70000-row index (above BINNED_MIN_ITEMS, narrow F): flagged rows
    re-run through the index's engine, K1's plain version with its
    repair here, and the session equals the plain full scan."""
    rng = np.random.default_rng(95)
    n, f = 70_000, 8
    rows = rng.normal(size=(n, f))
    lam = rng.uniform(0, 1, n)
    lap = oracle_laplacian(oracle_adjacency(rng.uniform(0.1, 1, (f, 6)),
                                            eps=1.0, topk=3, p=2.0,
                                            sigma=None))
    t = from_jax_state(rows, lam, lap, TauMode.median(), **CPU64)
    sess = tp.PrunedSearchSession(t, 4, k=6, alpha=0.9, cap=256,
                                  m_cells=1, seed=1, iters=2)
    calls = []
    pool = bt.binned_topk_pool

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return pool(*a, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(bt, "binned_topk_pool", counting)
    try:
        queries = rng.normal(size=(4, f))
        s, i = sess.search(queries)
    finally:
        mp.undo()
    assert sess.flagged_total >= 1 and calls
    assert sum(calls) == sess.flagged_total
    qlam = t.aspace.prepare_query_items_batch(queries, t.gl)
    so, io = batched_lambda_aware_topk(torch.as_tensor(queries), qlam,
                                       t.aspace.data, t.aspace.lambdas, 0.9,
                                       k=6)
    np.testing.assert_array_equal(i, io.numpy())
    np.testing.assert_allclose(s, so.numpy(), rtol=0, atol=TOL)
