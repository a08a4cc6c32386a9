"""The energy build of arrowspace_torch (energymaps.py) against the JAX
package, stage by stage and end to end, in float64 on the CPU.

Inputs: a seeded clustered 6000 x 72 corpus, clustered with the JL
projection on (72 -> 36 dims) into 25 clusters, whose 75 sub-centroids
make a graph taller than the 72 item coordinates; and its centroids as
the JAX package makes them; where a stage draws a projection (start_clustering, the
optical compression's 2D map), the JAX matrix is carried across.

Tolerances: the bootstrap L₀, the diffusion, the node λ and the split
within 1e-10 (float64, products summed in another order); the
dispersion within 1e-9 (its pairwise d² cancels between close
sub-centroids).  The energy Laplacian divides the dispersion gaps by
their robust scale, which is ~1e-8 on this data, so a 1e-13 difference
of a dispersion is a 1e-5 difference of a distance: its values are held
within 1e-4 of the largest entry, and its edges exactly.  The same holds
for λ of the end-to-end build (1e-5)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowspace_tpu import eigenmaps as j_eigenmaps
from arrowspace_tpu import energymaps as jem
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.graph import GraphLaplacian as JGraphLaplacian
from arrowspace_torch import eigenmaps
from arrowspace_torch import energymaps as tem
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.graph import GraphLaplacian
from arrowspace_torch.reduction import ImplicitProjection

CPU64 = dict(device="cpu", dtype=torch.float64)


def _rows(seed=5, n=6000, f=72, centres=80):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, 0.02, (n, f))


def _jbuilder():
    return JBuilder().with_seed(7).with_dims_reduction(True, 0.3) \
        .with_inline_sampling(None)


def _tbuilder():
    return ArrowSpaceBuilder(**CPU64).with_seed(7) \
        .with_dims_reduction(True, 0.3).with_inline_sampling(None)


@pytest.fixture(scope="module")
def centroids():
    """The JAX package's projected centroids (X x 36) of the corpus."""
    return np.asarray(j_eigenmaps.start_clustering(_jbuilder(), _rows())
                      .centroids, dtype=np.float64)


def _l0(cent, k=8):
    return (jem.bootstrap_centroid_laplacian(cent, k, False, False),
            tem.bootstrap_centroid_laplacian(torch.as_tensor(cent), k, False,
                                             False))


def _carry(monkeypatch, module, jax_projection):
    held = ImplicitProjection.from_matrix(np.asarray(jax_projection.matrix()))
    monkeypatch.setattr(module, "ImplicitProjection", lambda *a, **kw: held)


def test_energy_params_defaults_match_jax():
    assert vars(tem.EnergyParams()) == vars(jem.EnergyParams())
    assert vars(tem.ProjectedEnergyParams()) == \
        vars(jem.ProjectedEnergyParams())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_robust_scale_and_bounded_l2_match_jax(seed):
    x = np.random.default_rng(seed).normal(size=37 + seed)
    assert tem.robust_scale(x) == jem.robust_scale(x)
    assert tem.bounded_l2_energy(x) == jem.bounded_l2_energy(x)
    assert tem.robust_scale([]) == jem.robust_scale(np.zeros(0))


@pytest.mark.parametrize("k,normalise", [(8, False), (12, False),
                                         (8, True)])
def test_bootstrap_laplacian_matches_jax(centroids, k, normalise):
    jl = jem.bootstrap_centroid_laplacian(centroids, k, normalise, False)
    tl = tem.bootstrap_centroid_laplacian(torch.as_tensor(centroids), k,
                                          normalise, False)
    assert tl.nnodes == jl.nnodes == centroids.shape[0]
    np.testing.assert_allclose(tl.matrix.numpy(), np.asarray(jl.matrix),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("eta,steps", [(0.1, 4), (0.3, 1), (0.05, 9)])
def test_diffusion_matches_jax(centroids, eta, steps):
    jl, tl = _l0(centroids)
    j = jem._diffuse(centroids, jl.matrix, np.float64(eta), steps=steps)
    t = tem._diffuse(torch.as_tensor(centroids), tl.matrix, eta, steps)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10,
                               atol=1e-12)


def _weighted_laplacian(x, seed=0):
    """A random symmetric graph Laplacian over x nodes, every edge
    weighted (the bootstrap graph's ε = 1e-3 leaves centroids this far
    apart without an edge, so its dispersion is 0)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (x, x)) * (rng.uniform(0, 1, (x, x)) < 0.5)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return np.diag(a.sum(1)) - a


@pytest.mark.parametrize("graph", ["bootstrap", "weighted"])
@pytest.mark.parametrize("bug", [False, True])
def test_node_energy_and_dispersion_matches_jax(centroids, bug, graph):
    if graph == "bootstrap":
        jl, tl = _l0(centroids)
    else:
        lap = _weighted_laplacian(centroids.shape[0])
        jl = SimpleNamespace(matrix=jnp.asarray(lap))
        tl = SimpleNamespace(matrix=torch.as_tensor(lap))
    j_lam, j_gini = jem.node_energy_and_dispersion(centroids, jl, 8,
                                                   bug_compat=bug)
    t_lam, t_gini = tem.node_energy_and_dispersion(
        torch.as_tensor(centroids), tl, 8, bug_compat=bug)
    np.testing.assert_allclose(t_lam, j_lam, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_gini, j_gini, rtol=0, atol=1e-9)
    # w = -(L_ij.max(0)) is zero off a true Laplacian's diagonal
    assert t_gini.any() == (graph == "weighted" and not bug)


@pytest.mark.parametrize("quantile,bug", [(0.9, False), (0.2, False),
                                          (0.9, True)])
def test_diffuse_and_split_matches_jax(centroids, quantile, bug):
    p_j = jem.EnergyParams(split_quantile=quantile,
                           reference_dispersion_bug=bug)
    p_t = tem.EnergyParams(split_quantile=quantile,
                           reference_dispersion_bug=bug)
    jl, tl = _l0(centroids)
    j = np.asarray(jem.diffuse_and_split_subcentroids(centroids, jl, p_j))
    t = tem.diffuse_and_split_subcentroids(torch.as_tensor(centroids), tl,
                                           p_t).numpy()
    assert t.shape == j.shape and t.shape[0] > centroids.shape[0]
    if bug:     # zero dispersion everywhere: every node splits
        assert t.shape[0] == 3 * centroids.shape[0]
    np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("lambda_k,bug", [(6, False), (10, False),
                                          (6, True)])
def test_energy_laplacian_matches_jax(centroids, lambda_k, bug):
    p_j = jem.EnergyParams(reference_dispersion_bug=bug)
    p_t = tem.EnergyParams(reference_dispersion_bug=bug)
    jl, _ = _l0(centroids)
    sub = np.asarray(jem.diffuse_and_split_subcentroids(centroids, jl, p_j))
    jb = _jbuilder().with_lambda_graph(1e-3, lambda_k, 3, 2.0, None)
    tb = _tbuilder().with_lambda_graph(1e-3, lambda_k, 3, 2.0, None)
    jg, j_lam, j_gini = jem.build_energy_laplacian(jb, sub, p_j)
    tg, t_lam, t_gini = tem.build_energy_laplacian(tb, sub, p_t)
    jm, tm = np.asarray(jg.matrix), tg.matrix.numpy()
    np.testing.assert_array_equal(tm != 0, jm != 0)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-4 * np.abs(jm).max())
    assert tg.nnz() == jg.nnz()
    np.testing.assert_allclose(tm.sum(axis=1), 0.0, atol=1e-12)   # L = D - A
    np.testing.assert_allclose(t_lam, j_lam, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_gini, j_gini, rtol=0, atol=1e-9)


@pytest.mark.parametrize("budget", [8, 20])
def test_optical_compression_matches_jax(monkeypatch, centroids, budget):
    """With the JAX 2D map carried across, the grid bins, the trim and
    the top-up pick the same rows; a budget at or above X is a no-op."""
    x, f = centroids.shape
    _carry(monkeypatch, tem, jem.ImplicitProjection(f, 2, seed=3))
    j = np.asarray(jem.optical_compress_centroids(centroids, budget, 0.1,
                                                  seed=3))
    t = tem.optical_compress_centroids(torch.as_tensor(centroids), budget,
                                       0.1, seed=3).numpy()
    assert t.shape == j.shape == (budget, f)
    np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-12)
    same = tem.optical_compress_centroids(torch.as_tensor(centroids), x,
                                          0.1, seed=3)
    np.testing.assert_array_equal(same.numpy(), centroids)


@pytest.fixture(scope="module")
def built():
    """build_energy of both packages, the JAX projection carried across."""
    rows = _rows()
    params = dict(split_quantile=0.2, allow_tall_graphs=True)
    ja, jg = jem.build_energy(_jbuilder(), rows, jem.EnergyParams(**params))
    held = ImplicitProjection.from_matrix(
        np.asarray(ja.projection_matrix.matrix()))
    mp = pytest.MonkeyPatch()
    mp.setattr(eigenmaps, "ImplicitProjection", lambda *a, **kw: held)
    tb = _tbuilder()
    try:
        ta, tg = tem.build_energy(tb, rows, tem.EnergyParams(**params))
    finally:
        mp.undo()
    return rows, (ja, jg), (ta, tg, tb)


def test_build_energy_matches_jax(built):
    _rows_, (ja, jg), (ta, tg, tb) = built
    assert ta.n_clusters == ja.n_clusters
    assert ta.reduced_dim == ja.reduced_dim == 36
    assert ta.pad_tall_graphs and ja.pad_tall_graphs
    jm, tm = np.asarray(jg.matrix), tg.matrix.numpy()
    assert tm.shape == jm.shape and tm.shape[0] > ta.nfeatures    # tall
    np.testing.assert_array_equal(tm != 0, jm != 0)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-4 * np.abs(jm).max())
    np.testing.assert_allclose(ta.lambdas.numpy(), np.asarray(ja.lambdas),
                               rtol=0, atol=1e-5)
    assert set(tb.stage_seconds) == {"clustering", "subcentroids",
                                     "energy_laplacian", "taumode"}


def test_build_energy_lambda_on_carried_laplacian(built):
    """λ of the raw rows against the JAX energy Laplacian itself: equal to
    the JAX λ within 1e-10 (no dispersion amplification left)."""
    from arrowspace_torch.taumode import compute_taumode_lambdas
    rows, (ja, jg), (ta, _tg, _tb) = built
    lam = compute_taumode_lambdas(torch.as_tensor(rows),
                                  torch.as_tensor(np.asarray(jg.matrix)),
                                  ta.taumode, pad_items=True)
    np.testing.assert_allclose(lam.numpy(), np.asarray(ja.lambdas),
                               rtol=1e-10, atol=1e-12)


def test_tall_graph_raises_without_allow_tall_graphs():
    """Default EnergyParams keep the reference's n <= F ceiling: a graph
    of more sub-centroids than item coordinates raises in both."""
    rows = _rows()
    with pytest.raises(ValueError):
        jem.build_energy(_jbuilder(), rows, jem.EnergyParams())
    with pytest.raises(ValueError):
        tem.build_energy(_tbuilder(), rows, tem.EnergyParams())


def test_build_energy_needs_dims_reduction():
    rows = _rows(n=300)
    with pytest.raises(AssertionError):
        jem.build_energy(JBuilder().with_seed(7), rows, jem.EnergyParams())
    with pytest.raises(AssertionError):
        tem.build_energy(ArrowSpaceBuilder(**CPU64).with_seed(7), rows,
                         tem.EnergyParams())


@pytest.mark.parametrize("wl,wd", [(1.0, 0.5), (0.0, 1.0), (2.0, 0.25)])
def test_search_energy_single_matches_jax(built, wl, wd):
    """search_energy (one query) over the JAX-built index carried across
    (convert.from_jax_state): ids exact, scores within 1e-10."""
    from arrowspace_torch.convert import from_jax_state
    rows, (ja, jg), _ = built
    t = from_jax_state(rows, np.asarray(ja.lambdas), np.asarray(jg.matrix),
                       ja.taumode, projection=np.asarray(
                           ja.projection_matrix.matrix()),
                       pad_tall_graphs=True, **CPU64)
    for q in (rows[3] * 1.02, rows[400]):
        j = jem.search_energy(ja, q, jg, 7, wl, wd)
        s = tem.search_energy(t.aspace, q, t.gl, 7, wl, wd)
        assert [i for i, _ in s] == [i for i, _ in j]
        np.testing.assert_allclose([v for _, v in s], [v for _, v in j],
                                   rtol=1e-10, atol=1e-12)


def test_graph_laplacian_types_carry_the_same_shape(built):
    _rows_, (_ja, jg), (_ta, tg, _tb) = built
    assert isinstance(tg, GraphLaplacian) and isinstance(jg, JGraphLaplacian)
    assert tg.shape() == tuple(jg.shape())
