"""tests/test_reduction.py (JL projection, mirroring
tests/test_reduction.rs:12-126 of the reference) run in both packages:
each case once on ``arrowspace_tpu`` and once on ``arrowspace_torch``
(CPU, float64) on the same numpy inputs.  The packages' generators
differ (threefry against torch's), so each is held to the same
properties; compute_jl_dimension is also compared across packages, and
a matrix carried across (ImplicitProjection.from_matrix) projects as the
JAX one does within 1e-12."""

import types

import numpy as np
import pytest
import torch

from arrowspace_tpu import reduction as jred
from arrowspace_torch import reduction as tred


def _torch_project_matrix(data, projection):
    return tred.project_matrix(data, projection, device="cpu",
                               dtype=torch.float64)


PKGS = {
    "jax": types.SimpleNamespace(ImplicitProjection=jred.ImplicitProjection,
                                 compute_jl_dimension=jred.compute_jl_dimension,
                                 project_matrix=jred.project_matrix),
    "torch": types.SimpleNamespace(
        ImplicitProjection=tred.ImplicitProjection,
        compute_jl_dimension=tred.compute_jl_dimension,
        project_matrix=_torch_project_matrix),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_jl_dimension_formula(pkg):
    import math
    # r = max(32, ceil(8 ln n / eps^2))
    assert pkg.compute_jl_dimension(17, 0.3) == max(
        32, math.ceil(8 * math.log(17) / 0.09))
    assert pkg.compute_jl_dimension(3, 1.0) == 32  # floor at 32
    assert pkg.compute_jl_dimension(10000, 0.3) == math.ceil(
        8 * math.log(10000) / 0.09)


def test_projection_determinism(pkg):
    proj = pkg.ImplicitProjection(100, 40, seed=77)
    q = np.random.default_rng(0).normal(size=100)
    a = proj.project(q)
    b = proj.project(q)
    np.testing.assert_array_equal(a, b)
    # same seed -> same matrix
    proj2 = pkg.ImplicitProjection(100, 40, seed=77)
    np.testing.assert_array_equal(a, proj2.project(q))
    # different seed -> different projection
    proj3 = pkg.ImplicitProjection(100, 40, seed=78)
    assert not np.allclose(a, proj3.project(q))


def test_projection_linearity_and_scale(pkg):
    proj = pkg.ImplicitProjection(64, 32, seed=5)
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=64), rng.normal(size=64)
    px, py = proj.project(x), proj.project(y)
    np.testing.assert_allclose(proj.project(x + y), px + py, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(proj.project(3.0 * x), 3.0 * px, rtol=1e-6)


def test_projection_preserves_distances_statistically(pkg):
    """JL property: pairwise distances preserved within ~eps on average."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(20, 512))
    proj = pkg.ImplicitProjection(512, 128, seed=9)
    ppts = _np(pkg.project_matrix(pts, proj))
    orig = np.linalg.norm(pts[:, None] - pts[None, :], axis=2)
    red = np.linalg.norm(ppts[:, None] - ppts[None, :], axis=2)
    mask = orig > 0
    ratios = red[mask] / orig[mask]
    assert abs(np.mean(ratios) - 1.0) < 0.1
    assert np.all(ratios > 0.5) and np.all(ratios < 1.5)


def test_project_matrix_shape(pkg):
    pts = np.random.default_rng(3).normal(size=(10, 96))
    proj = pkg.ImplicitProjection(96, 48, seed=11)
    out = _np(pkg.project_matrix(pts, proj))
    assert out.shape == (10, 48)
    np.testing.assert_allclose(out[4], proj.project(pts[4]), rtol=1e-6)


def test_projection_zero_vector(pkg):
    """Zero in, zero out (test_reduction.rs:60-70)."""
    proj = pkg.ImplicitProjection(40, 10, seed=1)
    out = np.asarray(proj.project(np.zeros(40)))
    assert out.shape == (10,)
    assert np.all(np.abs(out) < 1e-10)


def test_projection_preserves_scale_and_nontrivial(pkg):
    """JL norm preservation within a loose band, and the projection of a
    non-zero vector is non-zero (test_reduction.rs:96-126)."""
    proj = pkg.ImplicitProjection(50, 15, seed=3)
    q = np.ones(50)
    out = np.asarray(proj.project(q))
    ratio = np.linalg.norm(out) / np.linalg.norm(q)
    assert 0.5 < ratio < 2.0
    assert np.any(np.abs(out) > 1e-10)


def test_project_matrix_zero_and_row_independence(pkg):
    """Zero matrix projects to zero; distinct rows project to distinct
    vectors (test_reduction.rs:151-187)."""
    proj = pkg.ImplicitProjection(20, 6, seed=4)
    zeros = _np(pkg.project_matrix(np.zeros((3, 20)), proj))
    assert np.all(np.abs(zeros) < 1e-10)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(4, 20))
    out = _np(pkg.project_matrix(pts, proj))
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.allclose(out[i], out[j])


def test_jl_dimension_bounds_and_monotonicity(pkg):
    """The r = max(32, ceil(8 ln n / eps^2)) formula's shape
    (test_reduction.rs:189-289): floor at 32, grows with n, shrinks with
    eps, and the reference's absolute anchors."""
    # minimum bound: n=2, eps=0.9 -> ~6.9 -> clamped to 32
    assert pkg.compute_jl_dimension(2, 0.9) == 32
    # grows with n
    assert pkg.compute_jl_dimension(10_000, 0.1) > pkg.compute_jl_dimension(100, 0.1)
    # inversely proportional to epsilon
    assert pkg.compute_jl_dimension(5000, 0.1) > pkg.compute_jl_dimension(5000, 0.2)
    # large dataset anchor: 1M rows at eps=0.1 -> 8 ln(1e6)/0.01 ~ 11k
    d = pkg.compute_jl_dimension(1_000_000, 0.1)
    assert 10_000 <= d < 20_000
    # tight epsilon anchor: 10k rows at eps=0.05 -> >= 25k
    assert pkg.compute_jl_dimension(10_000, 0.05) >= 25_000
    # very small epsilon: 500 rows at eps=0.01 -> >= 400k
    assert pkg.compute_jl_dimension(500, 0.01) >= 400_000
    # reasonable range sweep
    for n, eps in ((100, 0.2), (1000, 0.15), (10_000, 0.1)):
        d = pkg.compute_jl_dimension(n, eps)
        assert 32 <= d < 100_000


def test_full_pipeline_projection_finite(pkg):
    """Matrix -> project -> all values finite at the right shape
    (test_reduction.rs:291-318)."""
    data = (np.arange(20 * 100, dtype=np.float64) * 0.01).reshape(20, 100)
    proj = pkg.ImplicitProjection(100, 15, seed=6)
    out = _np(pkg.project_matrix(data, proj))
    assert out.shape == (20, 15)
    assert np.all(np.isfinite(out))


def test_projection_state_is_seed_only(pkg):
    """The persisted identity of a projection is (orig, reduced, seed) —
    the reference stores only those 24 bytes and regenerates the matrix
    (test_reduction.rs:320-333; reduction.rs:168-203).  This repo caches
    the regenerated matrix host-side for batch speed (a documented
    divergence), but the cache must be derived state: a fresh instance
    with the same triple projects identically."""
    a = pkg.ImplicitProjection(1000, 100, seed=9)
    q = np.ones(1000)
    out_a = np.asarray(a.project(q))
    assert out_a.shape == (100,)
    b = pkg.ImplicitProjection(1000, 100, seed=9)
    np.testing.assert_array_equal(out_a, np.asarray(b.project(q)))
    assert (a.original_dim, a.reduced_dim, a.seed) == (1000, 100, 9)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("n,eps", [(17, 0.3), (2, 0.9), (1_000_000, 0.1),
                                   (500, 0.01)])
def test_jl_dimension_equal_across_packages(n, eps):
    assert tred.compute_jl_dimension(n, eps) == \
        jred.compute_jl_dimension(n, eps)


def test_carried_matrix_projects_as_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(12, 96))
    jp = jred.ImplicitProjection(96, 48, seed=11)
    tp = tred.ImplicitProjection.from_matrix(np.asarray(jp.matrix()))
    np.testing.assert_allclose(
        _np(tred.project_matrix(pts, tp, device="cpu", dtype=torch.float64)),
        _np(jred.project_matrix(pts, jp)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp.project(pts[3]), jp.project(pts[3]),
                               rtol=0, atol=1e-12)
