"""tests/test_laplacian.py (mirroring the reference's tests/test_laplacian.rs
and tests/test_graph_factory.rs) run in both packages: each case once as
the JAX package runs it (by calling the JAX test itself) and once on
``arrowspace_torch.laplacian`` / ``graph`` on the CPU in float64, on the
same rows.  Every port Laplacian is also held to the JAX package's on
the same rows.  The JAX case that compares its numpy micro-path with its
jitted stages holds the port's one path to both.

Tolerances: the JAX case's own (1e-9 against the oracle, 1e-8 and 1e-12
on properties); across packages the matrices within 1e-12 (float64, the
cosine products summed in another order) and the structural non-zero
counts equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_laplacian as J
from arrowspace_tpu.graph import GraphFactory as JFactory
from arrowspace_tpu.graph import GraphParams as JParams
from arrowspace_tpu.laplacian import build_laplacian_matrix as j_build
from arrowspace_torch.core import ArrowSpace
from arrowspace_torch.graph import GraphFactory, GraphLaplacian, GraphParams
from arrowspace_torch.laplacian import build_laplacian_matrix
from data import make_gaussian_blob
from helpers import oracle_adjacency, oracle_laplacian

F64 = dict(device="cpu", dtype=torch.float64)


def _kw(eps=0.7, k=3, topk=3, p=2.0, sigma=None, normalise=False,
        sparsity_check=False):
    return dict(eps=eps, k=k, topk=topk, p=p, sigma=sigma,
                normalise=normalise, sparsity_check=sparsity_check)


def _build(rows, n_items=None, **kw):
    """The port's Laplacian over the rows, held to the JAX package's."""
    gl = build_laplacian_matrix(torch.as_tensor(np.asarray(rows)),
                                GraphParams(**_kw(**kw)), n_items, **F64)
    jgl = j_build(jnp.asarray(rows), JParams(**_kw(**kw)), n_items=n_items)
    np.testing.assert_allclose(gl.matrix.numpy(), np.asarray(jgl.matrix),
                               rtol=0, atol=1e-12)
    assert gl.structural_nnz == jgl.structural_nnz
    return gl


def _factory(centroids, **kw):
    args = (kw.get("eps", 1.0), kw.get("k", 5), kw.get("topk", 3), 2.0, None,
            kw.get("normalise", False), kw.get("sparsity_check", False),
            kw["n_items"])
    gl = GraphFactory.build_laplacian_matrix_from_k_cluster(centroids, *args,
                                                            **F64)
    jgl = JFactory.build_laplacian_matrix_from_k_cluster(centroids, *args)
    np.testing.assert_allclose(gl.matrix.numpy(), np.asarray(jgl.matrix),
                               rtol=0, atol=1e-12)
    return gl


def test_doctest_shape_quirk():
    J.test_doctest_shape_quirk()
    items = np.array([[1.0, 0.0, 0.0], [0.8, 0.6, 0.0], [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0]])
    gl = _build(items.T, eps=0.5, sigma=0.1, normalise=True)
    assert gl.nnodes == 4 and gl.shape() == (3, 3)


def test_matches_bruteforce_oracle():
    J.test_matches_bruteforce_oracle()
    rows = make_gaussian_blob(24, dims=10, spread=0.4, seed=5)
    gl = _build(rows, n_items=99, eps=0.8, topk=4)
    np.testing.assert_allclose(
        gl.matrix.numpy(), oracle_laplacian(oracle_adjacency(
            rows, eps=0.8, topk=4, p=2.0, sigma=None)), atol=1e-9)
    assert gl.nnodes == 99


def test_laplacian_properties():
    J.test_laplacian_properties()
    gl = _build(make_gaussian_blob(30, dims=12, spread=0.5, seed=6),
                eps=1.0, topk=5)
    val = gl.verify_properties(1e-8)
    assert val.is_valid and val.is_symmetric
    assert val.max_row_sum_error < 1e-8


def test_offdiagonals_nonpositive_and_degrees_match():
    J.test_offdiagonals_nonpositive_and_degrees_match()
    m = _build(make_gaussian_blob(20, dims=8, seed=8), eps=1.0).matrix.numpy()
    off = m - np.diag(np.diag(m))
    assert np.all(off <= 1e-12)
    np.testing.assert_allclose(np.diag(m), -off.sum(axis=1), atol=1e-9)


def test_sigma_default_is_one():
    J.test_sigma_default_is_one()
    rows = make_gaussian_blob(16, dims=6, seed=9)
    gl_none, gl_one = _build(rows, sigma=None), _build(rows, sigma=1.0)
    assert torch.equal(gl_none.matrix, gl_one.matrix)
    assert not np.allclose(gl_none.matrix.numpy(),
                           _build(rows, sigma=0.7).matrix.numpy())


def test_eps_filter_disconnects():
    J.test_eps_filter_disconnects()
    np.testing.assert_allclose(_build(np.eye(4), eps=0.5).matrix.numpy(),
                               np.zeros((4, 4)))


def test_rayleigh_quotient_and_spmv():
    J.test_rayleigh_quotient_and_spmv()
    gl = _build(make_gaussian_blob(15, dims=7, seed=10), eps=1.0)
    x = np.ones(15)
    np.testing.assert_allclose(gl.multiply_vector(x), 0.0, atol=1e-9)
    assert gl.rayleigh_quotient(x) == pytest.approx(0.0, abs=1e-9)
    y = np.random.default_rng(0).normal(size=15)
    assert gl.rayleigh_quotient(y) >= -1e-9


def test_normalise_is_standard_scaling():
    J.test_normalise_is_standard_scaling()
    rows = make_gaussian_blob(12, dims=5, seed=11) * 10.0 + 3.0
    gl_raw, gl_norm = _build(rows), _build(rows, normalise=True)
    np.testing.assert_allclose(gl_norm.init_data.numpy().mean(axis=0), 0.0,
                               atol=1e-9)
    assert not np.allclose(gl_raw.matrix.numpy(), gl_norm.matrix.numpy())


def test_graph_factory_from_k_cluster():
    J.test_graph_factory_from_k_cluster()
    gl = _factory(make_gaussian_blob(9, dims=6, seed=12), n_items=100)
    assert gl.shape() == (6, 6) and gl.nnodes == 100


def test_sparsity_check_raises():
    J.test_sparsity_check_raises()
    with pytest.raises(ValueError, match="too sparse"):
        GraphFactory.build_laplacian_matrix_from_k_cluster(
            np.eye(32), 0.1, 3, 3, 2.0, None, False, True, 32, **F64)


def test_spectral_laplacian_shape():
    J.test_spectral_laplacian_shape()
    rows = make_gaussian_blob(20, dims=8, seed=13)
    aspace = ArrowSpace.new(rows, **F64)
    gl = _factory(rows[:10], topk=4, n_items=20)
    GraphFactory.build_spectral_laplacian(aspace, gl)
    assert tuple(aspace.signals.shape) == (8, 8)


def test_extract_adjacency_and_statistics():
    J.test_extract_adjacency_and_statistics()
    gl = _build(make_gaussian_blob(18, dims=9, seed=14), eps=1.0)
    adj = gl.extract_adjacency()
    assert np.all(adj >= 0.0)
    np.testing.assert_allclose(adj, adj.T, atol=1e-12)
    stats = gl.statistics()
    assert stats.nnz == gl.nnz() and 0.0 <= stats.sparsity <= 1.0


def test_prepare_from_items():
    J.test_prepare_from_items()
    gl = GraphLaplacian.prepare_from_items(
        make_gaussian_blob(10, dims=4, seed=15), GraphParams(**_kw(eps=1.0)),
        **F64)
    assert gl.shape() == (4, 4) and gl.nnodes == 10


def test_graph_params_approx_eq():
    J.test_graph_params_approx_eq()
    a = GraphParams(**_kw(eps=0.5))
    assert a == GraphParams(**_kw(eps=0.5 + 1e-12))
    assert a != GraphParams(**_kw(eps=0.6))


def test_accessors_over_nnodes_quirk():
    J.test_accessors_over_nnodes_quirk()
    gl = _factory(make_gaussian_blob(8, dims=5, seed=21), k=4, n_items=20)
    assert gl.shape() == (5, 5)
    deg = gl.degrees()
    assert deg.shape == (20,)
    np.testing.assert_array_equal(deg[5:], 0.0)
    assert gl.get(10, 10) == 0.0
    row = gl.get_row(2)
    assert row.shape == (20,)
    np.testing.assert_array_equal(row[5:], 0.0)
    with pytest.raises(AssertionError):
        gl.get(25, 0)


def test_numpy_micropath_equals_jit_path():
    """The port has one dense path; on the JAX case's rows it equals both
    of the JAX package's (the numpy micro-path and the jitted stages)."""
    from arrowspace_tpu.laplacian import (_build_dense_numpy,
                                          _build_dense_stages)
    from arrowspace_torch.laplacian import _build_dense
    J.test_numpy_micropath_equals_jit_path()
    rows = make_gaussian_blob(60, dims=12, spread=0.5, seed=33)
    params = GraphParams(**_kw(eps=1.0, topk=4))
    adj, lap, nnz = _build_dense(torch.from_numpy(rows), params)
    jp = JParams(**_kw(eps=1.0, topk=4))
    adj_np, lap_np, nnz_np = _build_dense_numpy(rows, jp, 5, 1.0)
    adj_j, lap_j, nnz_j = _build_dense_stages(jnp.asarray(rows), jp, 5, 1.0)
    for a, lp, z in ((adj_np, lap_np, nnz_np),
                     (np.asarray(adj_j), np.asarray(lap_j), int(nnz_j))):
        np.testing.assert_allclose(adj.numpy(), a, rtol=0, atol=1e-12)
        np.testing.assert_allclose(lap.numpy(), lp, rtol=0, atol=1e-12)
        assert nnz == z
