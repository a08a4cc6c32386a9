"""JL projection of arrowspace_torch (reduction.py and the projection
branch of eigenmaps.start_clustering) against the JAX package.

The two packages draw the projection's Gaussians from different
generators (torch's against threefry), so the generated matrix is held
by property: determinism from the seed, shape, and the 1/√r scale (the
entries' standard deviation within 3 % of 1/√r over 32768 draws, where
the sampling error is 0.4 %).  A matrix carried across
(ImplicitProjection.from_matrix) must project exactly as the JAX one
does: 1e-12 in float64."""

import math

import numpy as np
import pytest
import torch

from arrowspace_tpu import eigenmaps as j_eigenmaps
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.reduction import ImplicitProjection as JProjection
from arrowspace_tpu.reduction import compute_jl_dimension as j_jl_dim
from arrowspace_torch import eigenmaps
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.reduction import ImplicitProjection, compute_jl_dimension

CPU64 = dict(device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("n,eps", [(17, 0.3), (3, 1.0), (10000, 0.3),
                                   (317, 0.5), (2, 0.9), (1_000_000, 0.1)])
def test_jl_dimension_matches_jax(n, eps):
    assert compute_jl_dimension(n, eps) == j_jl_dim(n, eps)
    assert compute_jl_dimension(n, eps) >= 32


def test_projection_is_deterministic_from_the_seed():
    q = np.random.default_rng(0).normal(size=100)
    a = ImplicitProjection(100, 40, seed=77).project(q)
    np.testing.assert_array_equal(a, ImplicitProjection(100, 40,
                                                        seed=77).project(q))
    assert not np.allclose(a, ImplicitProjection(100, 40, seed=78).project(q))
    # a seed past 2^63 is reduced, never refused
    big = ImplicitProjection(100, 40, seed=(1 << 64) - 1)
    assert big.project(q).shape == (40,)


@pytest.mark.parametrize("f,r", [(128, 64), (100, 40), (33, 2)])
def test_projection_shapes_and_dtypes(f, r):
    proj = ImplicitProjection(f, r, seed=3)
    rows = np.random.default_rng(1).normal(size=(5, f))
    assert proj.matrix().shape == (f, r)
    assert proj.matrix().dtype == torch.float64
    assert proj.project(rows[0]).shape == (r,)
    assert proj.project_batch_host(rows).shape == (5, r)
    dev = proj.project_device(torch.tensor(rows, dtype=torch.float32))
    assert dev.shape == (5, r) and dev.dtype == torch.float32
    # the host and device projections are one product
    np.testing.assert_allclose(
        proj.project_device(torch.tensor(rows)).numpy(),
        proj.project_batch_host(rows), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(proj.project_batch_host(rows)[2],
                               proj.project(rows[2]), rtol=1e-12, atol=1e-14)


def test_projection_scale_is_one_over_sqrt_r():
    """Entries are N(0, 1/r): std within 3 % of 1/√r, mean within four
    standard errors of 0, over a 256 x 128 matrix (as the JAX matrix)."""
    r = 128
    m = ImplicitProjection(256, r, seed=11).matrix().numpy()
    jm = np.asarray(JProjection(256, r, seed=11).matrix(), dtype=np.float64)
    for mat in (m, jm):
        assert abs(mat.std() * math.sqrt(r) - 1.0) < 0.03
        assert abs(mat.mean()) < 4.0 / math.sqrt(mat.size * r)


def test_projection_preserves_norms_on_average():
    """E|Px|² = |x|² for a JL projection: the mean ratio over 400 random
    vectors within 5 % of 1 (its standard error is ~0.6 % at r=64)."""
    proj = ImplicitProjection(128, 64, seed=5)
    x = np.random.default_rng(2).normal(size=(400, 128))
    ratio = (proj.project_batch_host(x) ** 2).sum(1) / (x ** 2).sum(1)
    assert abs(ratio.mean() - 1.0) < 0.05


def test_projection_is_linear():
    proj = ImplicitProjection(64, 32, seed=5)
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=64), rng.normal(size=64)
    np.testing.assert_allclose(proj.project(x + 2.0 * y),
                               proj.project(x) + 2.0 * proj.project(y),
                               rtol=1e-10, atol=1e-12)


def test_held_matrix_projects_as_jax():
    jp = JProjection(96, 48, seed=7)
    held = ImplicitProjection.from_matrix(np.asarray(jp.matrix()))
    assert (held.original_dim, held.reduced_dim) == (96, 48)
    rows = np.random.default_rng(4).normal(size=(6, 96))
    np.testing.assert_allclose(held.project_batch_host(rows),
                               jp.project_batch_host(rows), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(held.project(rows[0]), jp.project(rows[0]),
                               rtol=1e-12, atol=1e-14)


def _rows(f, n=600, seed=5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (30, f))
    return c[rng.integers(0, 30, n)] + rng.normal(0, 0.02, (n, f))


@pytest.mark.parametrize("f,enabled", [(96, True), (128, True), (48, True),
                                       (96, False)])
def test_start_clustering_projection_branch(monkeypatch, f, enabled):
    """Projection when enabled and F > 64, to min(jl_dim, F/2) dims; the
    JAX projection is carried across, so the projected centroids match
    to 1e-10 in float64 and the clustering exactly."""
    rows = _rows(f)
    jb = JBuilder().with_seed(7).with_dims_reduction(enabled, 0.3) \
        .with_inline_sampling(None)
    jc = j_eigenmaps.start_clustering(jb, rows)
    tb = ArrowSpaceBuilder(**CPU64).with_seed(7) \
        .with_dims_reduction(enabled, 0.3).with_inline_sampling(None)
    jproj = jc.aspace.projection_matrix
    if jproj is not None:
        held = ImplicitProjection.from_matrix(np.asarray(jproj.matrix()))
        monkeypatch.setattr(eigenmaps, "ImplicitProjection",
                            lambda *a, **kw: held)
    tc = eigenmaps.start_clustering(tb, rows)
    projected = enabled and f > 64
    assert (tc.aspace.projection_matrix is not None) == projected
    assert (jproj is not None) == projected
    assert tc.reduced_dim == jc.reduced_dim
    if projected:
        assert tc.reduced_dim == min(j_jl_dim(jc.aspace.n_clusters, 0.3),
                                     f // 2)
        assert tc.aspace.reduced_dim == tc.reduced_dim
    np.testing.assert_array_equal(tc.aspace.cluster_assignments,
                                  jc.aspace.cluster_assignments)
    np.testing.assert_allclose(np.asarray(tc.centroids),
                               np.asarray(jc.centroids), rtol=1e-10,
                               atol=1e-12)


def test_projected_query_lambda_matches_jax(monkeypatch):
    """A dims-reduced canonical build (ArrowIndex.build(dims_reduction=
    True)): corpus λ from the raw rows, query λ from the projected query,
    as the JAX package computes them; λ within 1e-10."""
    from arrowspace_tpu.index import ArrowIndex as JIndex
    from arrowspace_torch.index import ArrowIndex
    rows = _rows(96, n=900)
    j = JIndex.build(rows, eps=1.0, seed=7, dims_reduction=True, rp_eps=0.3)
    held = ImplicitProjection.from_matrix(
        np.asarray(j.aspace.projection_matrix.matrix()))
    monkeypatch.setattr(eigenmaps, "ImplicitProjection",
                        lambda *a, **kw: held)
    t = ArrowIndex.build(rows, eps=1.0, seed=7, dims_reduction=True,
                         rp_eps=0.3, **CPU64)
    assert t.aspace.reduced_dim == j.aspace.reduced_dim == 48
    np.testing.assert_allclose(t.lambdas, np.asarray(j.lambdas), rtol=1e-10,
                               atol=1e-12)
    q = rows[:5] * 1.02
    np.testing.assert_allclose(
        t.aspace.prepare_query_items_batch(q, t.gl).numpy(),
        np.asarray(j.aspace.prepare_query_items_batch(q, j.gl)), rtol=1e-10,
        atol=1e-12)
    assert t.aspace.prepare_query_item(q[0], t.gl) == pytest.approx(
        float(j.aspace.prepare_query_item(q[0], j.gl)), rel=1e-10, abs=1e-12)
