"""tests/test_spectral_invariants.py (Rayleigh bounds, a PSD Laplacian,
superposition, k-capping, diffusion, random walks, quality metrics) run
in both packages: each case once as the JAX package runs it (by calling
the JAX test itself) and once on ``arrowspace_torch`` on the CPU in
float64, on the same numpy rows made from the case's own seeds.  The
port's Laplacians are also held to the JAX package's of the same rows,
and its quality metrics to the JAX package's of the same build.

Tolerances: the JAX case's own (1e-9 on eigenvalue bounds, 1e-12 on
edge weights, 1e-6 on the walk's mass); Laplacians across packages
within 1e-12, quality metrics within 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_spectral_invariants as J
from arrowspace_tpu.graph import GraphParams as JParams
from arrowspace_tpu.laplacian import build_laplacian_matrix as j_lap
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.energymaps import _diffuse
from arrowspace_torch.graph import GraphParams
from arrowspace_torch.laplacian import build_laplacian_matrix
from data import make_gaussian_blob, make_moons_hd


def _lap(n=20, dims=10, seed=3, topk=4):
    rows = make_gaussian_blob(n, dims=dims, spread=0.5, seed=seed)
    kw = dict(eps=1.0, k=6, topk=topk, p=2.0, sigma=None, normalise=False,
              sparsity_check=False)
    gl = build_laplacian_matrix(torch.from_numpy(rows), GraphParams(**kw),
                                device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(
        np.asarray(gl.matrix),
        np.asarray(j_lap(jnp.asarray(rows), JParams(**kw)).matrix),
        rtol=0, atol=1e-12)
    return gl


def test_rayleigh_bounded_by_eigenvalues():
    J.test_rayleigh_bounded_by_eigenvalues()
    gl = _lap()
    eig = np.linalg.eigvalsh(np.asarray(gl.matrix))
    rng = np.random.default_rng(0)
    for _ in range(20):
        r = gl.rayleigh_quotient(rng.normal(size=eig.shape[0]))
        assert eig[0] - 1e-9 <= r <= eig[-1] + 1e-9


def test_laplacian_positive_semidefinite():
    J.test_laplacian_positive_semidefinite()
    eig = np.linalg.eigvalsh(np.asarray(_lap(seed=5).matrix))
    assert eig[0] >= -1e-9
    assert abs(eig[0]) < 1e-9


def test_rayleigh_superposition_bound():
    J.test_rayleigh_superposition_bound()
    m = np.asarray(_lap(seed=7).matrix)
    rng = np.random.default_rng(1)
    for _ in range(10):
        x = rng.normal(size=m.shape[0])
        y = rng.normal(size=m.shape[0])
        assert (x + y) @ m @ (x + y) <= 2.0 * (x @ m @ x + y @ m @ y) + 1e-9


def test_k_capping_semantics():
    J.test_k_capping_semantics()
    topk = 3
    adj = _lap(n=30, seed=9, topk=topk).extract_adjacency()
    assert int((adj > 0).sum()) // 2 <= adj.shape[0] * topk
    assert adj.max() <= 1.0 + 1e-12


def test_diffusion_contracts_dirichlet_energy():
    J.test_diffusion_contracts_dirichlet_energy()
    m = _lap(n=16, dims=8, seed=11).matrix
    rng = np.random.default_rng(2)
    work = torch.from_numpy(rng.normal(size=(16, 8)))
    energies = []
    for _ in range(5):
        energies.append(float(torch.diagonal(work.T @ (m @ work)).sum()))
        work = _diffuse(work, m, 0.05, steps=1)
    assert all(energies[i + 1] <= energies[i] + 1e-9
               for i in range(len(energies) - 1))


def test_random_walk_converges_to_uniform():
    J.test_random_walk_converges_to_uniform()
    m = np.asarray(_lap(n=12, dims=6, seed=13).matrix)
    deg = np.diagonal(m).copy()
    deg[deg == 0] = 1.0
    p = np.eye(m.shape[0]) - m / deg[:, None]
    v = np.zeros(m.shape[0])
    v[0] = 1.0
    for _ in range(500):
        v = v @ p
    assert v.sum() == pytest.approx(1.0, rel=1e-6)
    assert v.max() < 0.9


def test_quality_metrics():
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
    from arrowspace_tpu.utils import quality as jq
    from arrowspace_torch.utils import quality as tq
    J.test_quality_metrics()
    rows = make_moons_hd(60, noise=0.08, hd_noise=0.04, dims=10, seed=17)

    def build(b):
        return (b.with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(19)
                .build(rows.tolist()))
    aspace, gl = build(ArrowSpaceBuilder(device="cpu", dtype=torch.float64))
    j_aspace, j_gl = build(JBuilder())
    got = [tq.graph_connectivity_ratio(gl.matrix),
           tq.lambda_distribution_quality(np.asarray(aspace.lambdas)),
           tq.edge_count_efficiency(gl.matrix),
           tq.evaluate_graph_quality(aspace, gl),
           tq.evaluate_parameter_quality(aspace, gl, rows[:5].tolist(),
                                         0.9, 0.1, 5)]
    for v in got:
        assert 0.0 <= v <= 1.0
    want = [jq.graph_connectivity_ratio(j_gl.matrix),
            jq.lambda_distribution_quality(np.asarray(j_aspace.lambdas)),
            jq.edge_count_efficiency(j_gl.matrix),
            jq.evaluate_graph_quality(j_aspace, j_gl),
            jq.evaluate_parameter_quality(j_aspace, j_gl, rows[:5].tolist(),
                                          0.9, 0.1, 5)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert tq.graph_connectivity_ratio(np.zeros((1, 1))) == 1.0
    assert tq.lambda_distribution_quality([]) == 0.0
    assert tq.jaccard_similarity([1, 2, 3], [2, 3, 4]) == 0.5
    assert tq.jaccard_similarity([], []) == 1.0
