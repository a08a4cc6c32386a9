"""tests/test_magnitude_sensitivity.py (the reference's unnormalised
Laplacian suite, test_laplacian_unnormalised.rs:37-377: parameter
preservation, deterministic clustering, cosine scale invariance against
the hybrid's magnitude terms, normalised against raw builds) run in both
packages: each case once as the JAX package runs it (by calling the JAX
test itself) and once on ``arrowspace_torch`` on the CPU in float64, on
the same rows.  The port's seeded, unprojected builds are also held to
the JAX package's builds of the same rows.

Tolerances: the JAX case's own (1e-10 on cosines and the hybrid's
decomposition, 1e-12 on repeated λ, 1e-6 on the spectra's difference);
clusters across packages equal, λ within 1e-10."""

import math

import numpy as np
import pytest
import torch

import test_magnitude_sensitivity as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from data import make_moons_hd


def _builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def _cosine(a, b) -> float:
    return ArrowItem(a, 1.0).cosine_similarity(b)


def _magnitude_penalty(a, b) -> float:
    n1, n2 = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if n1 > 1e-12 and n2 > 1e-12:
        return math.exp(-abs(math.log(n1 / n2)))
    return 0.0


def _hybrid(a, b, alpha, beta) -> float:
    n1, n2 = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    cos = _cosine(a, b)
    if n1 > 1e-12 and n2 > 1e-12:
        return alpha * cos + beta * _magnitude_penalty(a, b)
    return cos


def test_builder_graph_params_preservation():
    J.test_builder_graph_params_preservation()
    items = make_moons_hd(50, 0.18, 0.4, 7, 456)
    _, gl = (_builder().with_lambda_graph(0.25, 6, 3, 2.5, 0.15)
             .with_normalisation(False).build(items.tolist()))
    gp = gl.graph_params
    assert (gp.eps, gp.k, gp.topk, gp.p, gp.sigma) == \
        (0.25, 6, 3 + 1, 2.5, 0.15)
    assert gp.normalise is False


def test_with_deterministic_clustering():
    J.test_with_deterministic_clustering()
    items = make_moons_hd(80, 0.50, 0.50, 9, 789)

    def build(b):
        return (b.with_lambda_graph(0.3, 4, 2, 2.0, None).with_seed(42)
                .build(items.tolist()))[0]
    a1, a2, j = build(_builder()), build(_builder()), build(JBuilder())
    assert a1.n_clusters == a2.n_clusters == j.n_clusters
    np.testing.assert_array_equal(a1.cluster_assignments,
                                  a2.cluster_assignments)
    np.testing.assert_array_equal(a1.cluster_assignments,
                                  j.cluster_assignments)
    np.testing.assert_allclose(np.asarray(a1.lambdas),
                               np.asarray(a2.lambdas), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a1.lambdas),
                               np.asarray(j.lambdas), rtol=1e-10,
                               atol=1e-14)


def test_cosine_similarity_scale_invariance():
    J.test_cosine_similarity_scale_invariance()
    a, b = make_moons_hd(2, 0.0, 1.0, 13, 321)
    assert _cosine(a * 3.5, b * 0.2) == pytest.approx(_cosine(a, b),
                                                      abs=1e-10)


def test_hybrid_similarity_scale_sensitivity():
    J.test_hybrid_similarity_scale_sensitivity()
    a, b = make_moons_hd(2, 0.0, 1.0, 13, 654)
    assert abs(_hybrid(a, b, 0.7, 0.3)
               - _hybrid(a * 5.0, b * 0.1, 0.7, 0.3)) > 1e-6


def test_builder_normalized_vs_unnormalized_clustering():
    J.test_builder_normalized_vs_unnormalized_clustering()
    base = make_moons_hd(70, 0.16, 0.38, 11, 999)
    scales = np.array([1.0, 3.0, 0.5, 2.5, 1.5, 4.0, 0.8])
    unnorm = base * scales[np.arange(len(base)) % len(scales)][:, None]
    norms = np.linalg.norm(unnorm, axis=1, keepdims=True)
    normalized = np.where(norms > 1e-12, unnorm / norms, unnorm)
    for i in range(10):
        for j in range(i + 1, 10):
            assert _cosine(base[i], base[j]) == pytest.approx(
                _cosine(normalized[i], normalized[j]), abs=1e-10)


def test_builder_lambda_comparison_normalized_vs_unnormalized():
    J.test_builder_lambda_comparison_normalized_vs_unnormalized()
    base = make_moons_hd(60, 0.18, 0.35, 10, 555)
    scales = np.array([10.0, 0.1, 5.0, 2.0, 0.5])
    unnorm = base * scales[np.arange(len(base)) % len(scales)][:, None]

    def build(b, norm, rows):
        return np.asarray((b.with_lambda_graph(1.0, 5, 2, 2.0, None)
                           .with_normalisation(norm).with_seed(7)
                           .build(rows.tolist()))[0].lambdas)
    ln = build(_builder(), True, base)
    lu = build(_builder(), False, unnorm)
    assert np.all(np.isfinite(ln)) and np.all(np.isfinite(lu))
    assert np.all(ln >= 0.0) and np.all(lu >= 0.0)
    assert np.max(np.abs(ln - lu)) > 1e-6
    np.testing.assert_allclose(ln, build(JBuilder(), True, base),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(lu, build(JBuilder(), False, unnorm),
                               rtol=1e-10, atol=1e-14)


def test_magnitude_penalty_computation():
    J.test_magnitude_penalty_computation()
    item1 = np.array([1.0, 2.0, 3.0])
    same = np.array([1.5, 3.0, 4.5])
    diff = np.array([0.1, 0.2, 0.3])
    for other in (same, diff):
        r = np.linalg.norm(item1) / np.linalg.norm(other)
        assert _magnitude_penalty(item1, other) == pytest.approx(
            min(r, 1.0 / r), abs=1e-12)
    assert _magnitude_penalty(item1, same) > _magnitude_penalty(item1, diff)


def test_hybrid_similarity_components():
    J.test_hybrid_similarity_components()
    a, b = make_moons_hd(2, 0.0, 1.0, 10, 888)
    base_cos = _cosine(a, b)
    for s1 in (0.1, 0.5, 1.0, 2.0, 10.0):
        for s2 in (0.1, 0.5, 1.0, 2.0, 10.0):
            sa, sb = a * s1, b * s2
            cos = _cosine(sa, sb)
            assert _hybrid(sa, sb, 0.6, 0.4) == pytest.approx(
                0.6 * cos + 0.4 * _magnitude_penalty(sa, sb), abs=1e-10)
            assert cos == pytest.approx(base_cos, abs=1e-10)
