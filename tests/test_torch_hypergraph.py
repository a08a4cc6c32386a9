"""arrowspace_torch.hypergraph against arrowspace_tpu.hypergraph, in
float64 on the CPU.

Every case of tests/test_hypergraph.py runs here in both packages on the
same numpy inputs (the staged build: start_clustering, eigenmaps,
compute_taumode, seeded alike), and each port result is held against the
JAX one; one more case puts exact duplicate rows on both sides of an
ensemble_topk_batch chunk boundary, which must come back lowest id
first.  A projected index carries the JAX projection matrix across
(reduction.ImplicitProjection.from_matrix), since the packages draw
their Gaussians from different generators.

Tolerances: ids and tie order exact; float64 scores, λ and Laplacian
entries within 1e-10."""

import numpy as np
import pytest
import torch

from arrowspace_tpu import eigenmaps as jem
from arrowspace_tpu import hypergraph as jh
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.graph import GraphParams as JParams
from arrowspace_torch import eigenmaps as tem
from arrowspace_torch import hypergraph as th
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.graph import GraphParams
from arrowspace_torch.reduction import ImplicitProjection
from data import make_gaussian_hd, make_moons_hd

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-10


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _staged(rows, seed, monkeypatch=None, dims_reduction=None):
    """(JAX (aspace, centroids, gl), port (aspace, centroids, gl)) of the
    staged build with λ-graph (1.0, 5, 3, 2.0, None) on both sides."""
    jb = JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(seed)
    tb = ArrowSpaceBuilder(**CPU64).with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_seed(seed)
    if dims_reduction is not None:
        jb = jb.with_dims_reduction(True, dims_reduction)
        tb = tb.with_dims_reduction(True, dims_reduction)
    jb.define_result_k()
    tb.define_result_k()
    jc = jem.start_clustering(jb, rows.tolist())
    if jc.aspace.projection_matrix is not None:
        held = ImplicitProjection.from_matrix(
            np.asarray(jc.aspace.projection_matrix.matrix()))
        monkeypatch.setattr(tem, "ImplicitProjection",
                            lambda *a, **kw: held)
    tc = tem.start_clustering(tb, rows.tolist())
    jgl = jem.eigenmaps(jc.aspace, jb, jc.centroids, jc.n_items)
    tgl = tem.eigenmaps(tc.aspace, tb, tc.centroids, rows.shape[0])
    jem.compute_taumode(jc.aspace, jgl)
    tem.compute_taumode(tc.aspace, tgl)
    np.testing.assert_allclose(_np(tc.aspace.lambdas),
                               np.asarray(jc.aspace.lambdas), rtol=0,
                               atol=TOL)
    return (jc.aspace, jc.centroids, jgl), (tc.aspace, tc.centroids, tgl)


def _same_hits(t_res, j_res):
    assert [i for i, _ in t_res] == [i for i, _ in j_res]
    np.testing.assert_allclose([s for _, s in t_res],
                               [s for _, s in j_res], rtol=0, atol=TOL)


def _grids(jgl, tgl):
    """The (k-adjust 0, 1) x (ε-expand 1.0) grid of both packages."""
    jgrid = jh.ensemble_params(jgl.graph_params, k_adjust=(0, 1),
                               eps_expand=(1.0,))
    tgrid = th.ensemble_params(tgl.graph_params, k_adjust=(0, 1),
                               eps_expand=(1.0,))
    return jgrid, tgrid


def _same_ensembles(t_ens, j_ens):
    assert len(t_ens) == len(j_ens)
    for (tg, tl), (jg, jl) in zip(t_ens, j_ens):
        np.testing.assert_allclose(_np(tg.matrix), np.asarray(jg.matrix),
                                   rtol=0, atol=TOL)
        assert tg.nnz() == jg.nnz()
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                   atol=TOL)


def test_exports_cover_the_jax_module():
    for name in jh.__all__:
        assert hasattr(th, name), name
    assert set(jh.__all__) <= set(th.__all__)


def test_clique_expansion_weights():
    edges = [[0, 1, 2], [2, 3]]
    adj = th.clique_expansion_adjacency(edges, 5)
    np.testing.assert_array_equal(adj, jh.clique_expansion_adjacency(
        edges, 5))
    assert adj[0, 1] == pytest.approx(0.5)
    assert adj[1, 2] == pytest.approx(0.5)
    assert adj[2, 3] == pytest.approx(1.0)
    assert adj[0, 3] == 0.0
    np.testing.assert_allclose(adj, adj.T)
    assert np.all(np.diag(adj) == 0.0)
    adj2 = th.clique_expansion_adjacency([[1], []], 3)
    assert adj2.sum() == 0.0
    w = [0.5, 2.0]
    np.testing.assert_array_equal(
        th.clique_expansion_adjacency(edges, 5, weights=w),
        jh.clique_expansion_adjacency(edges, 5, weights=w))


def test_overlay_preserves_laplacian_properties():
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JB
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=1)
    _ja, jgl = JB().with_seed(3).build(rows.tolist())
    _ta, tgl = ArrowSpaceBuilder(**CPU64).with_seed(3).build(rows.tolist())
    n = tgl.shape()[0]
    assert n == jgl.shape()[0]
    hyper = th.clique_expansion_adjacency([[0, 1, 2], [3, 4]], n)
    tgl2 = th.overlay_laplacian(tgl, hyper, mix=0.5)
    jgl2 = jh.overlay_laplacian(jgl, hyper, mix=0.5)
    np.testing.assert_allclose(_np(tgl2.matrix), np.asarray(jgl2.matrix),
                               rtol=0, atol=TOL)
    assert tgl2.nnz() == jgl2.nnz()
    assert tgl2.matrix.device.type == "cpu"
    assert tgl2.matrix.dtype == torch.float64
    val = tgl2.verify_properties(1e-8)
    assert val.is_valid
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = rng.normal(size=n)
        assert tgl2.rayleigh_quotient(x) >= -1e-9
        assert tgl2.rayleigh_quotient(x) == pytest.approx(
            jgl2.rayleigh_quotient(x), abs=TOL)
    with pytest.raises(AssertionError, match="overlay shape"):
        th.overlay_laplacian(tgl, np.zeros((n + 1, n + 1)))


def test_ensemble_params_grid():
    base = GraphParams(eps=0.5, k=5, topk=3, p=2.0, sigma=None,
                       normalise=False, sparsity_check=False)
    jbase = JParams(eps=0.5, k=5, topk=3, p=2.0, sigma=None,
                    normalise=False, sparsity_check=False)
    grid, jgrid = th.ensemble_params(base), jh.ensemble_params(jbase)
    assert len(grid) == 6
    assert {p.k for p in grid} == {4, 5, 6}
    assert {round(p.eps, 6) for p in grid} == {0.5, 0.75}
    for p, jp in zip(grid, jgrid):
        assert (p.k, p.eps, p.topk) == (jp.k, jp.eps, jp.topk)
    # k_adjust moves topk too (the adjacency reads topk, never k)
    assert [p.topk for p in grid] == [2, 2, 3, 3, 4, 4]


def test_ensemble_search_fuses_rankings():
    rows = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=5)
    (ja, jcent, jgl), (ta, tcent, tgl) = _staged(rows, 11)
    jgrid, tgrid = _grids(jgl, tgl)
    q = rows[20] * 1.02
    res = th.ensemble_search(ta, tcent, q, tgrid, 10, 0.9)
    _same_hits(res, jh.ensemble_search(ja, jcent, q, jgrid, 10, 0.9))
    assert len(res) == 10
    scores = [s for _, s in res]
    assert scores == sorted(scores, reverse=True)
    assert res[0][0] == 20


def test_prebuilt_ensemble_matches_oneshot():
    rows = make_moons_hd(60, noise=0.08, hd_noise=0.04, dims=10, seed=9)
    (ja, jcent, jgl), (ta, tcent, tgl) = _staged(rows, 15)
    jgrid, tgrid = _grids(jgl, tgl)
    q = rows[12] * 1.01
    one = th.ensemble_search(ta, tcent, q, tgrid, 8, 0.9)
    ens = th.build_ensemble(ta, tcent, tgrid)
    _same_ensembles(ens, jh.build_ensemble(ja, jcent, jgrid))
    pre = th.ensemble_search_prebuilt(ta, ens, q, 8, 0.9)
    assert [i for i, _ in one] == [i for i, _ in pre]
    for (_, s1), (_, s2) in zip(one, pre):
        assert s1 == pytest.approx(s2, rel=1e-9)
    _same_hits(pre, jh.ensemble_search(ja, jcent, q, jgrid, 8, 0.9))


def test_ensemble_topk_batch_matches_prebuilt():
    """The chunked batch fusion reproduces ensemble_search_prebuilt per
    query and the JAX batch fusion; chunk < N runs the running merge."""
    import jax.numpy as jnp

    rows = make_moons_hd(90, noise=0.08, hd_noise=0.04, dims=10, seed=21)
    (ja, jcent, jgl), (ta, tcent, tgl) = _staged(rows, 17)
    jgrid, tgrid = _grids(jgl, tgl)
    jens = jh.build_ensemble(ja, jcent, jgrid)
    ens = th.build_ensemble(ta, tcent, tgrid)
    queries = rows[[3, 17, 40, 66]] * 1.01
    qdev = torch.as_tensor(queries)
    qlams = th.ensemble_query_lambdas(qdev, ens, ta.taumode)
    jqlams = jh.ensemble_query_lambdas(jnp.asarray(queries), jens,
                                       ja.taumode)
    np.testing.assert_allclose(_np(qlams), np.asarray(jqlams), rtol=0,
                               atol=TOL)
    lam_v = torch.stack([lam for _, lam in ens])
    bs, bi = th.ensemble_topk_batch(qdev, qlams, ta.data, lam_v, 0.9, k=8,
                                    chunk=32)
    jbs, jbi = jh.ensemble_topk_batch(
        jnp.asarray(queries), jqlams, ja.data,
        jnp.stack([lam for _, lam in jens]), 0.9, k=8, chunk=32)
    np.testing.assert_array_equal(_np(bi), np.asarray(jbi))
    np.testing.assert_allclose(_np(bs), np.asarray(jbs), rtol=0, atol=TOL)
    for qi, q in enumerate(queries):
        ref = th.ensemble_search_prebuilt(ta, ens, q, 8, 0.9)
        assert list(_np(bi[qi])) == [i for i, _ in ref]
        np.testing.assert_allclose(_np(bs[qi]), [s for _, s in ref],
                                   rtol=1e-9)


def test_normalized_clique_expansion():
    edges = [[0, 1, 2], [2, 3]]
    adj = th.clique_expansion_adjacency(edges, 5, normalized=True)
    np.testing.assert_array_equal(adj, jh.clique_expansion_adjacency(
        edges, 5, normalized=True))
    np.testing.assert_allclose(adj, adj.T)
    plain = th.clique_expansion_adjacency(edges, 5)
    assert adj[2, 3] < plain[2, 3]
    single = th.clique_expansion_adjacency([[0, 1, 2]], 5, normalized=True)
    np.testing.assert_allclose(single.sum(axis=1)[:3], 1.0)
    assert plain[2, 3] == pytest.approx(1.0)


def test_ensemble_search_with_projection(monkeypatch):
    """A dims-reduced index: the raw query scores the raw items, the
    projected one prepares τ and λ only (the JAX projection carried
    across)."""
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=17)
    (ja, jcent, jgl), (ta, tcent, tgl) = _staged(rows, 19, monkeypatch,
                                                 dims_reduction=0.5)
    assert ta.projection_matrix is not None
    assert ja.projection_matrix is not None
    jgrid, tgrid = _grids(jgl, tgl)
    ens = th.build_ensemble(ta, tcent, tgrid)
    _same_ensembles(ens, jh.build_ensemble(ja, jcent, jgrid))
    q = rows[4] * 1.02
    res = th.ensemble_search_prebuilt(ta, ens, q, 8, 0.9)
    _same_hits(res, jh.ensemble_search_prebuilt(
        ja, jh.build_ensemble(ja, jcent, jgrid), q, 8, 0.9))
    assert len(res) == 8
    assert res[0][0] == 4
    scores = [s for _, s in res]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("chunk", [16, 40, 64])
def test_ensemble_topk_batch_duplicates_across_chunks(chunk):
    """Exact copies of one row on both sides of a chunk boundary (and in
    the same chunk) tie in the fused score and come back lowest id first,
    in both packages, whatever the chunk size."""
    import jax.numpy as jnp

    rows = make_moons_hd(96, noise=0.08, hd_noise=0.04, dims=10, seed=23)
    copies = [5, 15, 17, 33, 47, 80]
    rows[copies[1:]] = rows[copies[0]]
    (ja, jcent, jgl), (ta, tcent, tgl) = _staged(rows, 29)
    lam = _np(ta.lambdas)
    assert np.all(lam[copies] == lam[copies[0]])
    jgrid, tgrid = _grids(jgl, tgl)
    jens = jh.build_ensemble(ja, jcent, jgrid)
    ens = th.build_ensemble(ta, tcent, tgrid)
    queries = rows[[copies[0], 60]] * 1.01
    qdev = torch.as_tensor(queries)
    qlams = th.ensemble_query_lambdas(qdev, ens, ta.taumode)
    lam_v = torch.stack([l for _, l in ens])
    s, i = th.ensemble_topk_batch(qdev, qlams, ta.data, lam_v, 0.8, k=8,
                                  chunk=chunk)
    js, ji = jh.ensemble_topk_batch(
        jnp.asarray(queries), jh.ensemble_query_lambdas(
            jnp.asarray(queries), jens, ja.taumode), ja.data,
        jnp.stack([l for _, l in jens]), 0.8, k=8, chunk=chunk)
    np.testing.assert_array_equal(_np(i), np.asarray(ji))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=TOL)
    assert list(_np(i[0])[:len(copies)]) == copies
    assert np.all(_np(s[0])[:len(copies)] == _np(s[0])[0])


def test_jax_ensemble_carried_across():
    """convert.ensemble_from_jax: a JAX ensemble (graphs and λ as numpy)
    served by the port's prebuilt and batched searches gives the JAX
    results."""
    import jax.numpy as jnp
    from arrowspace_torch.convert import ensemble_from_jax

    rows = make_moons_hd(70, noise=0.08, hd_noise=0.04, dims=10, seed=31)
    (ja, jcent, jgl), (ta, _tcent, tgl) = _staged(rows, 37)
    jgrid = jh.ensemble_params(jgl.graph_params)
    jens = jh.build_ensemble(ja, jcent, jgrid)
    ens = ensemble_from_jax(jens, device="cpu", dtype=torch.float64)
    _same_ensembles(ens, jens)
    assert [g.graph_params.topk for g, _ in ens] == [p.topk for p in jgrid]
    q = rows[9] * 1.03
    _same_hits(th.ensemble_search_prebuilt(ta, ens, q, 6, 0.7),
               jh.ensemble_search_prebuilt(ja, jens, q, 6, 0.7))
    queries = rows[[1, 9, 30]] * 1.01
    qt = torch.as_tensor(queries)
    s, i = th.ensemble_topk_batch(
        qt, th.ensemble_query_lambdas(qt, ens, ta.taumode), ta.data,
        torch.stack([lam for _, lam in ens]), 0.7, k=6, chunk=16)
    js, ji = jh.ensemble_topk_batch(
        jnp.asarray(queries), jh.ensemble_query_lambdas(
            jnp.asarray(queries), jens, ja.taumode), ja.data,
        jnp.stack([lam for _, lam in jens]), 0.7, k=6, chunk=16)
    np.testing.assert_array_equal(_np(i), np.asarray(ji))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=TOL)
