"""The cases of tests/test_eigenmaps.py (the staged EigenMaps pipeline
against the monolithic build, mirroring the reference's
tests/test_eigenmaps.rs:34-409) that no port test ran by name, in both
packages: each case once as the JAX package runs it (by calling the JAX
test itself) and once on ``arrowspace_torch.eigenmaps`` on the CPU in
float64, on the same rows.  The port's staged λ are also held to the
JAX package's monolithic build of the same rows.  The file's two
spectral cases run in tests/test_torch_builder.py under their own
names.

Tolerances: the JAX case's own (staged against monolithic 1e-12
relative, the Laplacian exact); across packages λ within 1e-10."""

import numpy as np
import pytest
import torch

import test_eigenmaps as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_torch import eigenmaps as em
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.taumode import TauMode
from data import make_moons_hd


def _builder(seed=77, mode=None):
    b = (ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
         .with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(seed))
    return b.with_synthesis(mode) if mode is not None else b


def _staged(b, rows):
    b.define_result_k()
    clustered = em.start_clustering(b, rows.tolist())
    aspace = clustered.aspace
    gl = em.eigenmaps(aspace, b, clustered.centroids, clustered.n_items)
    em.compute_taumode(aspace, gl)
    return aspace, gl


def test_staged_equals_monolithic():
    J.test_staged_equals_monolithic()
    rows = make_moons_hd(90, noise=0.08, hd_noise=0.05, dims=14, seed=6)
    aspace_mono, gl_mono = _builder().build(rows.tolist())
    aspace, gl = _staged(_builder(), rows)
    np.testing.assert_allclose(np.asarray(aspace.lambdas),
                               np.asarray(aspace_mono.lambdas), rtol=1e-12,
                               atol=0)
    assert aspace.n_clusters == aspace_mono.n_clusters
    np.testing.assert_array_equal(aspace.cluster_assignments,
                                  aspace_mono.cluster_assignments)
    assert aspace.cluster_radius == aspace_mono.cluster_radius
    assert gl.nnz() == gl_mono.nnz()
    assert torch.equal(gl.matrix, gl_mono.matrix)
    j_aspace, _ = (JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None)
                   .with_seed(77).build(rows.tolist()))
    np.testing.assert_allclose(np.asarray(aspace.lambdas),
                               np.asarray(j_aspace.lambdas), rtol=1e-10,
                               atol=1e-14)


def test_staged_search_equals_monolithic_search():
    J.test_staged_search_equals_monolithic_search()
    rows = make_moons_hd(70, noise=0.1, hd_noise=0.05, dims=10, seed=7)
    query = rows[5] * 1.02
    aspace_mono, gl_mono = _builder().build(rows.tolist())
    lam = aspace_mono.prepare_query_item(query, gl_mono)
    res_mono = aspace_mono.search_lambda_aware(ArrowItem(query, lam), 5, 0.7)
    aspace, gl = _staged(_builder(), rows)
    res_staged = em.search(aspace, query, gl, 5, 0.7)
    assert [i for i, _ in res_mono] == [i for i, _ in res_staged]
    for (_, s1), (_, s2) in zip(res_mono, res_staged):
        assert s1 == pytest.approx(s2, rel=1e-12)


def test_clustered_output_fields():
    J.test_clustered_output_fields()
    rows = make_moons_hd(50, noise=0.1, hd_noise=0.05, dims=8, seed=8)
    out = em.start_clustering(_builder(), rows.tolist())
    assert (out.n_items, out.n_features, out.reduced_dim) == (50, 8, 8)
    assert out.centroids.shape[1] == 8
    assert out.aspace.n_clusters == out.centroids.shape[0]


def test_staged_equals_monolithic_different_taumode():
    J.test_staged_equals_monolithic_different_taumode()
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=7)
    for mode in (TauMode.mean(), TauMode.percentile(0.75),
                 TauMode.fixed(0.3)):
        aspace_m, _ = _builder(33, mode).build(rows.tolist())
        aspace_s, _ = _staged(_builder(33, mode), rows)
        np.testing.assert_allclose(np.asarray(aspace_s.lambdas),
                                   np.asarray(aspace_m.lambdas), rtol=1e-12,
                                   err_msg=str(mode))


def test_eigenmaps_stages_produce_valid_state():
    J.test_eigenmaps_stages_produce_valid_state()
    rows = make_moons_hd(50, noise=0.1, hd_noise=0.05, dims=8, seed=8)
    b = (ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
         .with_lambda_graph(1.0, 4, 2, 2.0, None).with_seed(35))
    b.define_result_k()
    clustered = em.start_clustering(b, rows.tolist())
    assert clustered.aspace.nitems == 50
    assert clustered.aspace.n_clusters >= 1
    assert clustered.centroids.shape[1] == clustered.reduced_dim == 8
    assert np.all(np.asarray(clustered.aspace.lambdas) == 0.0)
    gl = em.eigenmaps(clustered.aspace, b, clustered.centroids,
                      clustered.n_items)
    assert gl.nnodes == 50 and gl.shape() == (8, 8)
    assert gl.is_symmetric(1e-9)
    em.compute_taumode(clustered.aspace, gl)
    lam = np.asarray(clustered.aspace.lambdas)
    assert np.all(np.isfinite(lam)) and np.all(lam >= 0.0) and lam.max() > 0
