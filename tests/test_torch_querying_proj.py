"""tests/test_querying_proj.py (the projection-aware query path,
reference: src/tests/test_querying_proj.rs:30-723) run in both packages:
each case once on ``arrowspace_tpu`` and once on ``arrowspace_torch``
(CPU, float64), on the same numpy inputs.

The packages draw the JL matrix from different generators (threefry
against torch's, README divergence), so projected results are held to
the same properties in each, not to each other; the unprojected index
is also compared across packages (λ within 1e-10, ids exact)."""

import types

import numpy as np
import pytest
import torch

from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.core import ArrowItem as JItem
from arrowspace_torch.builder import ArrowSpaceBuilder as TBuilder
from arrowspace_torch.core import ArrowItem as TItem
from data import make_gaussian_hd
from helpers import cosine_topk

PKGS = {
    "jax": types.SimpleNamespace(Builder=JBuilder, ArrowItem=JItem),
    "torch": types.SimpleNamespace(
        Builder=lambda: TBuilder(device="cpu", dtype=torch.float64),
        ArrowItem=TItem),
}


def _split(n_train=99, n_query=18, seed=11):
    """create_test_data parity (test_querying_proj.rs:19-27)."""
    all_data = make_gaussian_hd(n_train + n_query, spread=0.6, dims=96,
                                seed=seed)
    return all_data[:n_train], all_data[n_train:]


def _build(pkg, data, *, projection: bool, rp_eps=0.3, seed=42):
    b = (pkg.Builder()
         .with_lambda_graph(1.0, 6, 2, 2.0, None)
         .with_normalisation(True)
         .with_dims_reduction(projection, rp_eps)
         .with_sparsity_check(False)
         .with_seed(seed))
    return b.build(data.tolist())


@pytest.fixture(scope="module", params=sorted(PKGS))
def projected(request):
    pkg = PKGS[request.param]
    data, queries = _split()
    aspace, gl = _build(pkg, data, projection=True)
    assert aspace.projection_matrix is not None
    return data, queries, aspace, gl, pkg


@pytest.fixture(scope="module", params=sorted(PKGS))
def unprojected(request):
    pkg = PKGS[request.param]
    data, queries = _split()
    aspace, gl = _build(pkg, data, projection=False)
    assert aspace.projection_matrix is None
    return data, queries, aspace, gl, pkg


def test_prepare_query_item_consistency(projected):
    """Same query -> same λ on repeated preparation
    (test_querying_proj.rs:144-172)."""
    _data, queries, aspace, gl, _pkg = projected
    q = queries[0]
    lams = [aspace.prepare_query_item(q, gl) for _ in range(3)]
    assert lams[0] != 0.0
    assert lams[0] == pytest.approx(lams[1], rel=1e-12)
    assert lams[1] == pytest.approx(lams[2], rel=1e-12)


def test_query_dimension_mismatch_raises(projected):
    """(test_querying_proj.rs:263-276)"""
    _data, _queries, aspace, gl, _pkg = projected
    with pytest.raises(AssertionError, match="dimension"):
        aspace.prepare_query_item(np.ones(7), gl)


def test_lambda_values_reasonable_range(projected):
    """Index and query λ live in a sane, finite, non-negative range
    (test_querying_proj.rs:336-366)."""
    _data, queries, aspace, gl, _pkg = projected
    lam = np.asarray(aspace.lambdas)
    assert np.all(np.isfinite(lam))
    assert np.all(lam >= 0.0)
    assert float(lam.max()) < 100.0
    for q in queries[:4]:
        ql = aspace.prepare_query_item(q, gl)
        assert np.isfinite(ql) and 0.0 <= ql < 100.0


def test_range_search_with_query_lambda(projected):
    """range_search auto-prepares a zero λ and applies the reference's
    signed one-sided test (test_querying_proj.rs:294-333)."""
    data, queries, aspace, gl, pkg = projected
    q = queries[2]
    qlam = aspace.prepare_query_item(q, gl)

    # λ=0 triggers auto-preparation: results match the prepared query
    auto = aspace.range_search(pkg.ArrowItem(q, 0.0), gl, eps=1e-3)
    manual = aspace.range_search(pkg.ArrowItem(q, qlam), gl, eps=1e-3)
    assert [i for i, _ in auto] == [i for i, _ in manual]

    # signed band: every hit satisfies qλ - itemλ <= eps
    lam = np.asarray(aspace.lambdas)
    for i, diff in manual:
        assert diff == pytest.approx(qlam - lam[i], rel=1e-9, abs=1e-12)
        assert diff <= 1e-3


def test_projection_preserves_relative_distances(projected):
    """JL: a near pair stays much nearer than a far pair after projection
    (test_querying_proj.rs:402-530)."""
    _data, _queries, aspace, _gl, _pkg = projected
    f = aspace.nfeatures
    q1 = np.full(f, 0.5)
    q2 = np.full(f, 0.51)   # very close to q1
    q3 = np.full(f, 5.0)    # far from q1

    p1 = aspace.project_query(q1)
    p2 = aspace.project_query(q2)
    p3 = aspace.project_query(q3)
    assert p1.shape[0] == aspace.reduced_dim

    d12_o, d13_o = np.linalg.norm(q1 - q2), np.linalg.norm(q1 - q3)
    d12_p, d13_p = np.linalg.norm(p1 - p2), np.linalg.norm(p1 - p3)
    # relative ordering and ratio scale preserved
    assert d12_p < d13_p
    ratio_o, ratio_p = d13_o / d12_o, d13_p / d12_p
    assert ratio_p > 0.5 * ratio_o


def test_project_query_no_projection(unprojected):
    """Without dims reduction project_query is the identity
    (test_querying_proj.rs:533-550)."""
    _data, queries, aspace, _gl, _pkg = unprojected
    q = queries[0]
    np.testing.assert_array_equal(aspace.project_query(q), q)


def test_project_query_consistency(projected):
    """(test_querying_proj.rs:553-575)"""
    _data, queries, aspace, _gl, _pkg = projected
    q = queries[1]
    p1 = aspace.project_query(q)
    p2 = aspace.project_query(q)
    np.testing.assert_allclose(p1, p2, rtol=0, atol=0)


def test_project_query_linearity(projected):
    """P(a + b) == P(a) + P(b) and P(c·a) == c·P(a)
    (test_querying_proj.rs:578-608)."""
    _data, queries, aspace, _gl, _pkg = projected
    a, b = queries[0], queries[1]
    pa, pb = aspace.project_query(a), aspace.project_query(b)
    np.testing.assert_allclose(aspace.project_query(a + b), pa + pb,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(aspace.project_query(3.5 * a), 3.5 * pa,
                               rtol=1e-9, atol=1e-12)


def test_project_query_zero_vector(projected):
    """(test_querying_proj.rs:611-631)"""
    _data, _queries, aspace, _gl, _pkg = projected
    p = aspace.project_query(np.zeros(aspace.nfeatures))
    np.testing.assert_allclose(p, 0.0, atol=1e-15)


def test_project_query_preserves_scale_approximately(projected):
    """JL norm ratio within [0.5, 2.0] (test_querying_proj.rs:634-666)."""
    _data, queries, aspace, _gl, _pkg = projected
    q = queries[1]
    ratio = np.linalg.norm(aspace.project_query(q)) / np.linalg.norm(q)
    assert 0.5 < ratio < 2.0


def test_project_query_different_queries_differ(projected):
    """(test_querying_proj.rs:669-694)"""
    _data, queries, aspace, _gl, _pkg = projected
    p0 = aspace.project_query(queries[0])
    p1 = aspace.project_query(queries[1])
    assert np.max(np.abs(p0 - p1)) > 1e-9


def test_project_query_preserves_dot_product_sign(projected):
    """Strongly aligned/anti-aligned pairs keep their dot-product sign
    through the projection (test_querying_proj.rs:697-723)."""
    _data, _queries, aspace, _gl, _pkg = projected
    rng = np.random.default_rng(3)
    f = aspace.nfeatures
    hits = 0
    trials = 20
    for _ in range(trials):
        a = rng.normal(size=f)
        b = a + 0.1 * rng.normal(size=f)   # strongly aligned
        pa, pb = aspace.project_query(a), aspace.project_query(b)
        if np.dot(pa, pb) > 0.0:
            hits += 1
        pn = aspace.project_query(-b)
        if np.dot(pa, pn) < 0.0:
            hits += 1
    assert hits >= 2 * trials - 2  # JL: overwhelming sign preservation


@pytest.mark.parametrize("name", sorted(PKGS))
def test_search_with_and_without_projection_overlap(name):
    """Projected and unprojected indexes over the same data agree on the
    cosine-dominated ranking (α=1 scores raw vectors in both)
    (test_querying_proj.rs:75-141)."""
    pkg = PKGS[name]
    data, queries = _split()
    a_p, gl_p = _build(pkg, data, projection=True)
    a_u, gl_u = _build(pkg, data, projection=False)
    q = queries[0]
    lam_p = a_p.prepare_query_item(q, gl_p)
    lam_u = a_u.prepare_query_item(q, gl_u)
    # α=1: ranking is pure cosine; the projected index scores the
    # projected query against projected items, so top-1 may differ but
    # overlap should be high on clustered data
    r_u = a_u.search_lambda_aware(pkg.ArrowItem(q, lam_u), 10, 1.0)
    oracle_ids, _ = cosine_topk(q, data, 10)
    assert [i for i, _ in r_u] == list(oracle_ids)
    assert lam_p != 0.0 and lam_u != 0.0


def test_unprojected_indexes_match_across_packages():
    data, queries = _split()
    (ja, jg), (ta, tg) = (_build(PKGS[n], data, projection=False)
                          for n in ("jax", "torch"))
    np.testing.assert_allclose(np.asarray(ta.lambdas), np.asarray(ja.lambdas),
                               rtol=1e-10, atol=1e-12)
    for q in queries[:4]:
        jl, tl = ja.prepare_query_item(q, jg), ta.prepare_query_item(q, tg)
        assert tl == pytest.approx(jl, rel=1e-10, abs=1e-12)
        jr = ja.search_lambda_aware(JItem(q, jl), 8, 0.8)
        tr = ta.search_lambda_aware(TItem(q, tl), 8, 0.8)
        assert [i for i, _ in tr] == [i for i, _ in jr]
