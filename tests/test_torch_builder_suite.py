"""tests/test_builder.py (mirroring the reference's tests/test_builder.rs)
run in both packages: each case once as the JAX package runs it (by
calling the JAX test itself) and once on
``arrowspace_torch.builder.ArrowSpaceBuilder`` on the CPU in float64, on
the same rows.  Where a case builds without a projection, the port's
build is also held to the JAX package's: cluster count, the Laplacian
and λ.  The projected case draws its own Gaussians in each package and
is held to its properties only.

Tolerances: the JAX case's own; across packages the Laplacian within
1e-12 and λ within 1e-10 relative (float64, another summation order)."""

import numpy as np
import torch

import test_builder as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.taumode import TauMode as JMode
from arrowspace_torch.builder import ArrowSpaceBuilder, ConfigValue
from arrowspace_torch.sampling import SamplerType
from arrowspace_torch.taumode import TauMode
from data import make_gaussian_hd, make_moons_hd


def _builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def _same_build(t, j):
    (ta, tg), (ja, jg) = t, j
    assert ta.n_clusters == ja.n_clusters
    np.testing.assert_allclose(np.asarray(tg.matrix), np.asarray(jg.matrix),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ta.lambdas),
                               np.asarray(ja.lambdas), rtol=1e-10,
                               atol=1e-14)


def test_defaults_match_reference():
    J.test_defaults_match_reference()
    b = _builder()
    assert (b.lambda_eps, b.lambda_k, b.lambda_topk, b.lambda_p) == \
        (1e-3, 6, 3, 2.0)
    assert b.lambda_sigma is None
    assert b.normalise is False and b.sparsity_check is False
    assert b.sampling == SamplerType.simple(0.6)
    assert b.cluster_max_clusters is None and b.cluster_radius == 1.0
    assert b.clustering_seed is None and b.deterministic_clustering is False
    assert b.use_dims_reduction is False and b.rp_eps == 0.3
    assert b.synthesis == TauMode.median()


def test_define_result_k_heuristic():
    J.test_define_result_k_heuristic()
    for k, want in ((4, 3), (7, 4), (20, 9)):
        b = _builder().with_lambda_graph(0.5, k, 9, 2.0, None)
        b.define_result_k()
        assert b.lambda_topk == want


def test_with_seed_enables_deterministic():
    J.test_with_seed_enables_deterministic()
    b = _builder().with_seed(7)
    assert b.clustering_seed == 7 and b.deterministic_clustering is True


def test_build_end_to_end_shapes():
    J.test_build_end_to_end_shapes()
    rows = make_moons_hd(120, noise=0.08, hd_noise=0.05, dims=16, seed=1)

    def build(b):
        return (b.with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(42)
                .build(rows.tolist()))
    aspace, gl = t = build(_builder())
    assert (aspace.nitems, aspace.nfeatures) == (120, 16)
    assert gl.shape() == (16, 16) and gl.nnodes == 120
    lam = np.asarray(aspace.lambdas)
    assert lam.shape == (120,) and np.all(np.isfinite(lam))
    assert np.any(lam != 0.0)
    assert aspace.n_clusters >= 2 and aspace.cluster_radius > 0.0
    _same_build(t, build(JBuilder()))


def test_build_deterministic_with_seed():
    J.test_build_deterministic_with_seed()
    rows = make_moons_hd(100, noise=0.1, hd_noise=0.05, dims=10, seed=2)
    a1, _ = _builder().with_seed(5).build(rows.tolist())
    a2, _ = _builder().with_seed(5).build(rows.tolist())
    np.testing.assert_array_equal(np.asarray(a1.lambdas),
                                  np.asarray(a2.lambdas))
    assert a1.n_clusters == a2.n_clusters
    _same_build(_builder().with_seed(5).build(rows.tolist()),
                JBuilder().with_seed(5).build(rows.tolist()))


def test_build_with_dims_reduction():
    J.test_build_with_dims_reduction()
    rows = make_gaussian_hd(140, spread=0.5, dims=96, seed=3)
    aspace, gl = (_builder().with_lambda_graph(1.0, 6, 3, 2.0, None)
                  .with_dims_reduction(True, 1.0).with_seed(17)
                  .build(rows.tolist()))
    assert aspace.projection_matrix is not None
    assert aspace.reduced_dim is not None and aspace.reduced_dim <= 48
    assert gl.shape() == (aspace.reduced_dim, aspace.reduced_dim)


def test_build_no_sampling():
    J.test_build_no_sampling()
    rows = make_moons_hd(80, noise=0.1, hd_noise=0.05, dims=8, seed=4)
    t = _builder().with_inline_sampling(None).with_seed(3).build(
        rows.tolist())
    assert t[0].nitems == 80
    _same_build(t, JBuilder().with_inline_sampling(None).with_seed(3)
                .build(rows.tolist()))


def test_spectral_build():
    J.test_spectral_build()
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=12, seed=5)
    aspace, _ = _builder().with_spectral(True).with_seed(9).build(
        rows.tolist())
    assert aspace.signals is not None
    assert tuple(aspace.signals.shape) == (12, 12)
    j_aspace, _ = JBuilder().with_spectral(True).with_seed(9).build(
        rows.tolist())
    np.testing.assert_allclose(np.asarray(aspace.signals),
                               np.asarray(j_aspace.signals), rtol=0,
                               atol=1e-12)


def test_config_typed_roundtrip():
    J.test_config_typed_roundtrip()
    b = (_builder().with_lambda_graph(0.5, 8, 4, 3.0, 0.25)
         .with_synthesis(TauMode.percentile(0.75)).with_seed(11))
    cfg = b.builder_config_typed()
    assert cfg["lambda_eps"].as_f64() == 0.5
    assert cfg["lambda_k"].as_usize() == 8
    assert cfg["synthesis"].as_tau_mode() == TauMode.percentile(0.75)
    assert cfg["clustering_seed"].value == 11
    for key, val in cfg.items():
        assert ConfigValue.from_json(val.to_json()) == val, key


def test_display_cookie_format():
    J.test_display_cookie_format()
    s = str(_builder())
    for part in ("lambda_eps=0.001", "synthesis=Median",
                 "sampling=Simple(0.6)", "persistence=None"):
        assert part in s
    assert s == str(JBuilder())


def test_clustering_produces_valid_assignments():
    J.test_clustering_produces_valid_assignments()
    rows = make_moons_hd(90, noise=0.1, hd_noise=0.05, dims=10, seed=22)
    aspace, _ = (_builder().with_lambda_graph(1.0, 5, 3, 2.0, None)
                 .with_seed(7).build(rows.tolist()))
    assigned = 0
    for i in range(aspace.nitems):
        c = aspace.cluster_of(i)
        if c is not None:
            assert 0 <= c < aspace.n_clusters
            assigned += 1
    assert int(aspace.cluster_sizes.sum()) == assigned
    assert aspace.n_clusters == len(aspace.cluster_sizes)


def test_lambda_computation_with_different_tau_modes():
    J.test_lambda_computation_with_different_tau_modes()
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=23)
    lams = {}
    for name, kind, value in (("median", "median", 0.0),
                              ("mean", "mean", 0.0),
                              ("fixed", "fixed", 0.25),
                              ("p75", "percentile", 0.75)):
        def build(b, mode):
            return (b.with_lambda_graph(1.0, 5, 3, 2.0, None)
                    .with_synthesis(mode).with_seed(9).build(rows.tolist()))
        t = build(_builder(), TauMode(kind, value))
        lams[name] = np.asarray(t[0].lambdas)
        assert np.all(np.isfinite(lams[name]))
        _same_build(t, build(JBuilder(), JMode(kind, value)))
    assert not np.allclose(lams["median"], lams["fixed"])
    assert not np.allclose(lams["mean"], lams["p75"])


def test_normalisation_flag_changes_graph():
    J.test_normalisation_flag_changes_graph()
    rows = (make_moons_hd(50, noise=0.1, hd_noise=0.05, dims=8, seed=24)
            * 7.0 + 2.0)

    def build(b, norm):
        return (b.with_lambda_graph(1.0, 5, 3, 2.0, None)
                .with_normalisation(norm).with_seed(3).build(rows.tolist()))
    _a1, g1 = build(_builder(), False)
    t = build(_builder(), True)
    assert not np.allclose(np.asarray(g1.matrix), np.asarray(t[1].matrix))
    assert t[1].graph_params.normalise is True
    _same_build(t, build(JBuilder(), True))
