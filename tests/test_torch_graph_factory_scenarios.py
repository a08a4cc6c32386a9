"""tests/test_graph_factory_scenarios.py (the reference's graph-factory
suite, test_graph_factory.rs:100-445: minimum datasets, scale
invariance under normalisation, dimensional sweeps, parameter
preservation, λ non-negativity, high noise, normalisation effects) run
in both packages: each case once as the JAX package runs it (by calling
the JAX test itself) and once on ``arrowspace_torch`` on the CPU in
float64, on the same rows.  Every build is seeded and unprojected, so
the port's cluster counts, graph sizes and λ are also held to the JAX
package's builds of the same rows.

Tolerances: the JAX case's own assertions; across packages, cluster
counts and node counts equal, the Laplacian (and the signals graph of a
spectral build) within 1e-12, and λ within 2e-6 absolute: the matmul
λ's moment expansion cancels on rows whose τ sits at the floor, and
there each package lands up to 1e-6 from the CSR oracle
(tests/oracle_csr.py), on either side of it (row 149 of the high-noise
build: oracle 0.50000000005, port 0.500000945, JAX 0.499999795)."""

import numpy as np
import torch

import test_graph_factory_scenarios as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_torch.builder import ArrowSpaceBuilder
from data import make_gaussian_blob, make_moons_hd


def _both(configure, rows):
    """(port (aspace, gl), JAX (aspace, gl)) of one builder recipe."""
    port = configure(ArrowSpaceBuilder(device="cpu", dtype=torch.float64))
    jax_ = configure(JBuilder())
    t = port.build(rows.tolist())
    j = jax_.build(rows.tolist())
    assert t[0].n_clusters == j[0].n_clusters
    assert t[1].nnodes == j[1].nnodes
    np.testing.assert_allclose(np.asarray(t[1].matrix),
                               np.asarray(j[1].matrix), rtol=0, atol=1e-12)
    if j[0].signals is not None:
        np.testing.assert_allclose(np.asarray(t[0].signals),
                                   np.asarray(j[0].signals), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(np.asarray(t[0].lambdas),
                               np.asarray(j[0].lambdas), rtol=0, atol=2e-6)
    return t


def test_builder_minimum_items():
    J.test_builder_minimum_items()
    items = make_moons_hd(20, 0.1, 0.6, 5, 42)
    aspace, gl = _both(lambda b: b.with_lambda_graph(0.5, 3, 2, 2.0, None)
                       .with_seed(1), items)
    assert aspace.n_clusters >= 1
    assert gl.nnodes == 20


def test_builder_scale_invariance_with_normalization():
    J.test_builder_scale_invariance_with_normalization()
    items = make_moons_hd(60, 0.15, 0.4, 8, 0)

    def cfg(b):
        return (b.with_lambda_graph(0.3, 4, 2, 2.0, None)
                .with_normalisation(True).with_seed(5))
    a1, gl1 = _both(cfg, items)
    a2, gl2 = _both(cfg, items * 5.7)
    assert abs(a1.n_clusters - a2.n_clusters) <= 3
    assert gl1.nnodes == gl2.nnodes


def test_builder_parameter_preservation():
    J.test_builder_parameter_preservation()
    items = make_moons_hd(50, 0.2, 0.4, 7, 321)
    _, gl = _both(lambda b: b.with_lambda_graph(0.123, 7, 3, 3.5, 0.456)
                  .with_normalisation(False).with_seed(2), items)
    gp = gl.graph_params
    assert (gp.eps, gp.k, gp.topk, gp.p, gp.sigma) == \
        (0.123, 7, 3 + 1, 3.5, 0.456)
    assert gp.normalise is False


def test_builder_with_different_dimensions():
    J.test_builder_with_different_dimensions()
    for n_samples, dims, desc in ((50, 3, "low"), (60, 10, "medium"),
                                  (70, 25, "high")):
        items = make_moons_hd(n_samples, 0.15, 0.4, dims, 42 + dims)
        aspace, gl = _both(lambda b: b.with_lambda_graph(0.3, 5, 2, 2.0, None)
                           .with_normalisation(True).with_spectral(True)
                           .with_sparsity_check(False).with_seed(3), items)
        assert aspace.n_clusters > 0, desc
        assert aspace.nfeatures == dims, desc
        assert gl.nnodes == n_samples, desc


def test_builder_lambda_values_are_nonnegative():
    J.test_builder_lambda_values_are_nonnegative()
    items = make_moons_hd(100, 0.2, 0.35, 11, 999)
    aspace, _ = _both(lambda b: b.with_lambda_graph(0.3, 5, 2, 2.0, None)
                      .with_normalisation(True).with_spectral(True)
                      .with_seed(4), items)
    lam = np.asarray(aspace.lambdas)
    assert np.all(lam >= 0.0) and np.all(np.isfinite(lam))


def test_builder_with_high_noise():
    J.test_builder_with_high_noise()
    items = make_gaussian_blob(300, dims=8, spread=0.9, seed=6)
    aspace, _ = _both(lambda b: b.with_lambda_graph(0.4, 6, 3, 2.0, None)
                      .with_normalisation(True).with_seed(6), items)
    assert aspace.n_clusters >= 2


def test_builder_normalization_effects():
    J.test_builder_normalization_effects()
    items = make_moons_hd(75, 0.14, 0.45, 8, 654)
    a_norm, gl_norm = _both(lambda b: b.with_lambda_graph(0.3, 5, 2, 2.0,
                                                          None)
                            .with_normalisation(True).with_seed(7), items)
    a_raw, gl_raw = _both(lambda b: b.with_lambda_graph(0.3, 5, 2, 2.0, None)
                          .with_normalisation(False).with_seed(7), items)
    assert gl_norm.graph_params.normalise is True
    assert gl_raw.graph_params.normalise is False
    assert a_norm.n_clusters > 0 and a_raw.n_clusters > 0
