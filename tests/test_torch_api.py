"""The search and mutation API of arrowspace_torch on a built index
(hybrid and λ-band range search, ArrowItem / ArrowFeature and item
mutation with the one-row λ refresh, GraphLaplacian's operations,
warmup, stats, the staged eigenmaps.search) against the JAX package, in
float64 on the CPU.

Tolerances: ids and ranges exact; scores and λ within 1e-12 where both
packages compute them from the same float64 inputs, 1e-10 where the
inputs are two builds' λ (the builds agree to 1e-10,
tests/test_torch_index.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowspace_tpu import eigenmaps as jem
from arrowspace_tpu.core import ArrowFeature as JFeature
from arrowspace_tpu.core import ArrowItem as JItem
from arrowspace_tpu.core import densematrix_to_vecvec as j_vecvec
from arrowspace_tpu.graph import GraphFactory as JFactory
from arrowspace_tpu.graph import GraphLaplacian as JGraph
from arrowspace_tpu.graph import GraphParams as JParams
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.ops.search import \
    hybrid_search_device_fused as j_hybrid
from arrowspace_torch import eigenmaps as tem
from arrowspace_torch.core import ArrowFeature, ArrowItem
from arrowspace_torch.core import densematrix_to_vecvec
from arrowspace_torch.graph import GraphFactory, GraphLaplacian, GraphParams
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops.search import hybrid_search_device_fused

CPU64 = dict(device="cpu", dtype=torch.float64)


def _clustered(seed, n, f, centres=12, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


@pytest.fixture(scope="module")
def built():
    rows = _clustered(7, 2000, 32)
    rows[[50, 900, 1500]] = rows[10]            # identical rows: ties
    j = JIndex.build(rows, eps=1.0, k=6, topk=3, seed=11)
    t = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11, **CPU64)
    return rows, j, t


def _fresh(built):
    """A new pair of indices (mutation tests must not share state)."""
    rows = built[0]
    return (JIndex.build(rows, eps=1.0, k=6, topk=3, seed=11),
            ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11, **CPU64))


@pytest.fixture(scope="module")
def carried(built):
    """The JAX index and a port index holding the JAX index's λ
    (update_lambdas), so that λ orders and band edges are the same
    floats in both."""
    j, t = _fresh(built)
    t.aspace.update_lambdas(np.asarray(j.lambdas))
    return j, t


# ---------------------------------------------------------------- hybrid

@pytest.mark.parametrize("alpha", [0.9, 0.5, 1.0, 0.0])
@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("which", ["row", "tied_row", "perturbed"])
def test_hybrid_op_matches_jax(alpha, k, which):
    """hybrid_search_device_fused on the same items, λ and query: ids
    exact, scores within 1e-12.  "row" is a query equal to a corpus row
    (high cosine), "tied_row" one equal to four identical rows (their
    tie goes to the lowest id), "perturbed" a row ×1.02 plus noise."""
    rng = np.random.default_rng(3)
    items = rng.uniform(0.1, 1.0, (600, 24))
    items[[7, 99, 300, 451]] = items[5]
    lam = rng.uniform(0.0, 1.5, 600)
    lam[[7, 99, 300, 451]] = lam[5]
    q = {"row": items[123], "tied_row": items[5],
         "perturbed": items[77] * 1.02 + rng.normal(0, 0.01, 24)}[which]
    qlam = 0.7
    ts, ti = hybrid_search_device_fused(torch.as_tensor(q), qlam,
                                        torch.as_tensor(items),
                                        torch.as_tensor(lam), alpha, k=k)
    js, ji = j_hybrid(jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(items),
                      jnp.asarray(lam), jnp.asarray(alpha), k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("pick", [10, 123, 1777])
@pytest.mark.parametrize("k", [0, 5, 20])
def test_search_hybrid_matches_jax(built, pick, k):
    """ArrowIndex.search_hybrid (query λ prepared, then the union) against
    the JAX index's, on a corpus row (row 10 has three copies)."""
    rows, j, t = built
    js = j.search_hybrid(rows[pick], k=k, alpha=0.8)
    ts = t.search_hybrid(rows[pick], k=k, alpha=0.8)
    assert [i for i, _ in ts] == [i for i, _ in js]
    np.testing.assert_allclose([s for _, s in ts], [s for _, s in js],
                               rtol=0, atol=1e-10)
    if k:
        assert ts[0][0] == (10 if pick == 10 else pick)


# ----------------------------------------------------------------- range

@pytest.mark.parametrize("band", [(0.0, 0.2), (0.1, 0.15), (-1.0, 5.0),
                                  (3.0, 4.0)])
@pytest.mark.parametrize("limit", [None, 7])
def test_range_search_sorted_matches_jax(carried, band, limit):
    """Bands by the sorted λ index, edges on λ values included."""
    j, t = carried
    lam = np.sort(t.lambdas)
    lo = band[0] if band[0] != 0.1 else float(lam[300])
    hi = band[1] if band[1] != 0.15 else float(lam[900])
    jr = j.range(lo, hi, limit)
    tr = t.range(lo, hi, limit)
    assert tr == jr
    order = t.aspace.lambda_sorted_index()[1]
    assert list(order) == list(np.argsort(t.lambdas, kind="stable"))


@pytest.mark.parametrize("qlam", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("eps", [-0.05, 0.0, 0.02])
def test_range_search_matches_jax(built, carried, qlam, eps):
    """The reference's signed one-sided test query.λ - item.λ <= eps; a
    query λ of 0 is prepared from the query first (λ within 1e-12 of
    JAX's; the hits then equal unless an item lies that close to the
    edge)."""
    j, t = carried
    q = built[0][321] * 1.01
    tr = t.aspace.range_search(ArrowItem(q, qlam), t.gl, eps)
    jr = j.aspace.range_search(JItem(q, qlam), j.gl, eps)
    if qlam:
        assert tr == jr
    else:
        assert [i for i, _ in tr] == [i for i, _ in jr]
        np.testing.assert_allclose([v for _, v in tr], [v for _, v in jr],
                                   rtol=0, atol=1e-12)


# ---------------------------------------------------- items and features

def test_arrow_item_methods_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=9), rng.normal(size=9)
    ta, tb = ArrowItem(a, 0.3), ArrowItem(b, 1.7)
    ja, jb = JItem(a, 0.3), JItem(b, 1.7)
    assert ta.is_empty() == ja.is_empty() is False
    assert ArrowItem([], 0.0).is_empty() and JItem([], 0.0).is_empty()
    assert ta.dot(tb) == ja.dot(jb)
    assert ArrowItem.norm(a) == JItem.norm(a)
    assert ta.cosine_similarity(b) == ja.cosine_similarity(b)
    assert ta.cosine_similarity(np.zeros(9)) == 0.0
    assert ta.euclidean_distance(tb) == ja.euclidean_distance(jb)
    assert ta.lambda_similarity(tb, 0.7) == ja.lambda_similarity(jb, 0.7)
    assert list(ta) == list(ja)
    ta.add_inplace(tb)
    ja.add_inplace(jb)
    np.testing.assert_array_equal(ta.item, ja.item)
    ta.mul_inplace(tb)
    ja.mul_inplace(jb)
    np.testing.assert_array_equal(ta.item, ja.item)
    ta.scale(-2.5)
    ja.scale(-2.5)
    np.testing.assert_array_equal(ta.item, ja.item)
    with pytest.raises(AssertionError):
        ta.dot(ArrowItem(np.ones(3), 0.0))
    f = ArrowFeature([1, 2, 3])
    assert f.feature.dtype == np.float64
    np.testing.assert_array_equal(f.feature, JFeature([1, 2, 3]).feature)
    m = rng.normal(size=(3, 4))
    assert densematrix_to_vecvec(m) == j_vecvec(m)
    assert densematrix_to_vecvec(torch.as_tensor(m)) == j_vecvec(m)


def test_access_methods_match_jax(built):
    _rows, j, t = built
    np.testing.assert_allclose(t.aspace.lambdas_list(),
                               j.aspace.lambdas_list(), rtol=1e-10,
                               atol=1e-12)
    for i in (0, 17, 1999, 5000):
        assert t.aspace.cluster_of(i) == j.aspace.cluster_of(i)
    np.testing.assert_array_equal(t.aspace.get_feature(3).feature,
                                  j.aspace.get_feature(3).feature)
    ti, ji = t.aspace.get_item(42), j.aspace.get_item(42)
    np.testing.assert_array_equal(ti.item, ji.item)
    assert ti.lambda_ == pytest.approx(ji.lambda_, abs=1e-10)
    with pytest.raises(AssertionError):
        t.aspace.get_item(2000)
    with pytest.raises(AssertionError):
        t.aspace.get_feature(32)


@pytest.mark.parametrize("op", ["add_items", "mul_items", "scale_item"])
@pytest.mark.parametrize("a,b", [(3, 8), (10, 50), (1999, 0)])
def test_mutation_matches_jax_and_full_recompute(built, op, a, b):
    """Each mutation gives JAX's row and λ (1e-12 on the same rows), the
    one-row refresh equals the full recompute, other rows' λ are
    untouched, and the set invalidates host_rows, the projected cache and
    the λ order."""
    j, t = _fresh(built)
    before = t.aspace.lambdas.clone()
    t.aspace.lambda_sorted_index()
    args = (a, b) if op != "scale_item" else (a, 1.7)
    getattr(t.aspace, op)(*args, t.gl)
    getattr(j.aspace, op)(*args, j.gl)
    np.testing.assert_array_equal(t.aspace.get_item(a).item,
                                  j.aspace.get_item(a).item)
    # the same row and graph in both packages: λ to 1e-12
    j_lam = j.aspace.lambdas_list()[a]
    assert abs(float(t.aspace.lambdas[a]) - float(j_lam)) <= 1e-10
    row = t.aspace.data[a].numpy()
    from arrowspace_torch.taumode import select_tau, synthetic_lambda_single
    from arrowspace_tpu.taumode import select_tau as j_tau
    from arrowspace_tpu.taumode import synthetic_lambda_single as j_single
    j_same = j_single(jnp.asarray(row), jnp.asarray(t.gl.matrix.numpy()),
                      j_tau(row, t.aspace.taumode))
    assert abs(float(t.aspace.lambdas[a]) - j_same) <= 1e-12
    assert synthetic_lambda_single(row, t.gl.matrix,
                                   select_tau(row, t.aspace.taumode)) == \
        float(t.aspace.lambdas[a])
    mask = torch.ones(t.nitems, dtype=torch.bool)
    mask[a] = False
    assert torch.equal(t.aspace.lambdas[mask], before[mask])
    assert t.aspace.host_rows is None and t.aspace._lambda_order is None
    refreshed = t.aspace.lambdas.clone()
    t.aspace.recompute_lambdas(t.gl)
    np.testing.assert_allclose(refreshed.numpy(), t.aspace.lambdas.numpy(),
                               rtol=0, atol=1e-12)


def test_set_item_and_feature_and_update_lambdas(built):
    j, t = _fresh(built)
    rng = np.random.default_rng(9)
    v = rng.uniform(0, 1, 32)
    t.aspace.set_item(5, ArrowItem(v, 0.0))
    j.aspace.set_item(5, JItem(v, 0.0))
    np.testing.assert_array_equal(t.aspace.data[5].numpy(), v)
    col = rng.uniform(0, 1, 2000)
    t.aspace.set_feature(4, ArrowFeature(col))
    j.aspace.set_feature(4, JFeature(col))
    np.testing.assert_array_equal(t.aspace.get_feature(4).feature,
                                  j.aspace.get_feature(4).feature)
    np.testing.assert_array_equal(t.aspace.data.numpy(),
                                  np.asarray(j.aspace.data))
    new = rng.uniform(0, 1, 2000)
    t.aspace.update_lambdas(new)
    np.testing.assert_array_equal(t.lambdas, new)
    assert list(t.aspace.lambda_sorted_index()[1]) == \
        list(np.argsort(new, kind="stable"))
    with pytest.raises(AssertionError):
        t.aspace.update_lambdas(new[:10])
    with pytest.raises(AssertionError):
        t.aspace.add_items(0, 2000, t.gl)


def test_f64_rescore_raises_after_mutation(built):
    """search(precision="f64_rescore") reads the original float64 rows; a
    set drops them, and the search then raises as the JAX package's."""
    j, t = _fresh(built)
    q = built[0][12] * 1.01
    t.search(q, k=5, precision="f64_rescore")
    t.aspace.scale_item(3, 2.0, t.gl)
    j.aspace.scale_item(3, 2.0, j.gl)
    for idx in (t, j):
        with pytest.raises(ValueError, match="f64_rescore"):
            idx.search(q, k=5, precision="f64_rescore")


def test_session_made_before_a_mutation_keeps_its_snapshot(built):
    """Mutation replaces the tensors: a session made before it serves the
    data it was made from."""
    _j, t = _fresh(built)
    q = built[0][:4] * 1.01
    sess = t.make_search_session(batch_size=4, k=5, alpha=0.9)
    (s0, i0), = list(sess.search_stream([q]))
    t.aspace.scale_item(int(i0[0, 0]), 3.0, t.gl)
    (s1, i1), = list(sess.search_stream([q]))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)


# ----------------------------------------------------------------- graph

def _graphs(nnodes):
    rng = np.random.default_rng(21)
    cent = rng.uniform(0.1, 1.0, (8, 9))
    args = (cent, 1.0, 6, 3, 2.0, None, False, False, nnodes)
    return (GraphFactory.build_laplacian_matrix_from_k_cluster(*args,
                                                               **CPU64),
            JFactory.build_laplacian_matrix_from_k_cluster(*args))


@pytest.mark.parametrize("nnodes", [9, 10, 500])
def test_graph_operations_match_jax(nnodes):
    """Every GraphLaplacian operation on graphs built from the same 8
    centroids (9 × 9 matrices); nnodes 10 and 500 exceed the dimension,
    and indices in [9, nnodes) read as 0.0; 500 also takes the long
    __str__."""
    tg, jg = _graphs(nnodes)
    assert tg.shape() == jg.shape() and tg.topk() == jg.topk()
    assert tg.nnz() == jg.nnz() and repr(tg.params()) == repr(jg.params())
    np.testing.assert_allclose(tg.matrix.numpy(), np.asarray(jg.matrix),
                               rtol=0, atol=1e-12)
    for i, j in ((0, 0), (2, 5), (8, 1), (nnodes - 1, 0), (3, nnodes - 1)):
        assert tg.get(i, j) == pytest.approx(jg.get(i, j), abs=1e-12)
    for i in (0, 4, nnodes - 1):
        np.testing.assert_allclose(tg.get_row(i), jg.get_row(i), atol=1e-12)
        np.testing.assert_allclose(tg.get_column(i), jg.get_column(i),
                                   atol=1e-12)
    with pytest.raises(AssertionError):
        tg.get(nnodes, 0)
    x = np.random.default_rng(2).normal(size=9)
    np.testing.assert_allclose(tg.multiply_vector(x), jg.multiply_vector(x),
                               rtol=0, atol=1e-12)
    assert tg.rayleigh_quotient(x) == pytest.approx(jg.rayleigh_quotient(x),
                                                    abs=1e-12)
    assert tg.rayleigh_quotient(np.zeros(9)) == 0.0 == \
        jg.rayleigh_quotient(np.zeros(9))
    for tol in (1e-12, 0.0):
        assert tg.is_symmetric(tol) == jg.is_symmetric(tol)
    np.testing.assert_allclose(tg.extract_adjacency(),
                               jg.extract_adjacency(), atol=1e-12)
    np.testing.assert_allclose(tg.degrees(), jg.degrees(), atol=1e-12)
    ts, js = tg.statistics(), jg.statistics()
    for name in ("nnodes", "nnz", "sparsity", "min_degree", "max_degree",
                 "mean_degree"):
        assert getattr(ts, name) == pytest.approx(getattr(js, name),
                                                  abs=1e-12)
    assert str(ts) == str(js)
    assert str(tg) == str(jg)
    assert GraphLaplacian.sparsity(tg.matrix) == \
        JGraph.sparsity(jg.matrix)


@pytest.mark.parametrize("tol", [1e-9, 1e-30])
def test_verify_properties_matches_jax(tol):
    tg, jg = _graphs(40)
    # break symmetry, a row sum and the diagonal sign alike in both
    for g in (tg, jg):
        g.set(1, 2, 5.0)
        g.set(3, 3, -1.0)
        with pytest.raises(IndexError):
            g.set(20, 1, 9.0)       # past the 9 x 9 matrix
    np.testing.assert_allclose(tg.matrix.numpy(), np.asarray(jg.matrix),
                               atol=1e-12)
    tv, jv = tg.verify_properties(tol), jg.verify_properties(tol)
    assert (tv.is_valid, tv.is_symmetric) == (jv.is_valid, jv.is_symmetric)
    assert tv.max_asymmetry == pytest.approx(jv.max_asymmetry, abs=1e-12)
    assert tv.max_row_sum_error == pytest.approx(jv.max_row_sum_error,
                                                 abs=1e-12)
    assert [i for i, _ in tv.row_sum_violations] == \
        [i for i, _ in jv.row_sum_violations]
    assert tv.negative_diagonal == jv.negative_diagonal
    assert not tv.is_valid
    good_t, good_j = _graphs(40)
    assert good_t.verify_properties(1e-9).is_valid == \
        good_j.verify_properties(1e-9).is_valid is True


def test_prepare_from_items_matches_jax():
    rng = np.random.default_rng(4)
    items = rng.uniform(0, 1, (30, 7))
    params = GraphParams(eps=1.0, k=4, topk=3, p=2.0, sigma=None,
                         normalise=False, sparsity_check=False)
    jparams = JParams(eps=1.0, k=4, topk=3, p=2.0, sigma=None,
                      normalise=False, sparsity_check=False)
    tg = GraphLaplacian.prepare_from_items(items, params, **CPU64)
    jg = JGraph.prepare_from_items(items, jparams)
    assert tg.nnodes == jg.nnodes == 30 and tg.shape() == (7, 7)
    np.testing.assert_allclose(tg.matrix.numpy(), np.asarray(jg.matrix),
                               atol=1e-12)
    assert tg.nnz() == jg.nnz()


# -------------------------------------------- warmup, stats, staged search

def test_stats_and_warmup_match_jax(built):
    _rows, j, t = built
    ts, js = t.stats(), j.stats()
    assert ts.keys() == js.keys()
    for key in ("n_items", "n_features", "n_clusters", "graph_nodes",
                "graph_nnz"):
        assert ts[key] == js[key]
    for key in ("graph_sparsity", "lambda_min", "lambda_max", "lambda_mean",
                "lambda_std"):
        assert ts[key] == pytest.approx(js[key], abs=1e-10)
    lam = t.aspace.lambdas.clone()
    t.warmup()
    t.warmup(batch_sizes=(3,), k=4000, alpha=0.5)
    assert torch.equal(lam, t.aspace.lambdas)


@pytest.mark.parametrize("pick", [0, 10, 640])
def test_staged_search_matches_jax(built, pick):
    """eigenmaps.search and the staged methods on ArrowSpace."""
    rows, j, t = built
    q = rows[pick] * 1.02
    tr = tem.search(t.aspace, q, t.gl, 7, 0.9)
    jr = jem.search(j.aspace, q, j.gl, 7, 0.9)
    assert [i for i, _ in tr] == [i for i, _ in jr]
    np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr],
                               rtol=0, atol=1e-10)
    assert t.aspace.search(q, t.gl, 7, 0.9) == tr
    for name in ("start_clustering", "eigenmaps", "compute_taumode",
                 "search"):
        assert hasattr(type(t.aspace), name)
