"""tests/test_sampling_scenarios.py (the sampler half of the reference's
builder suite, test_builder.rs:146-543: simple and density-adaptive
sampling, outliers, uniform data, duplicates, sampled against full
builds, λ under sampling) run in both packages: each case once as the
JAX package runs it (by calling the JAX test itself) and once on
``arrowspace_torch`` on the CPU in float64, on the same rows.  The
samplers are one numpy algorithm in both packages (the port carries a
copy of ``sampling.py``), so every seeded, unprojected build also keeps
the same rows for clustering as the JAX build of the same recipe.

Tolerances: the JAX case's own ratio and shape bounds; across packages
the kept-row count and the cluster count equal."""

import numpy as np
import torch

import test_sampling_scenarios as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.sampling import SamplerType as JSampler
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.sampling import SamplerType
from data import make_gaussian_blob, make_moons_hd


def _kept(aspace) -> int:
    return int(np.sum(np.asarray(aspace.cluster_sizes)))


def _both(configure, rows):
    """The port's (aspace, gl) of a recipe ``configure(builder,
    SamplerType)``, its kept rows and clusters held to the JAX build's."""
    t = configure(ArrowSpaceBuilder(device="cpu", dtype=torch.float64),
                  SamplerType).build(rows)
    j = configure(JBuilder(), JSampler).build(rows)
    assert _kept(t[0]) == _kept(j[0])
    assert t[0].n_clusters == j[0].n_clusters
    return t


def test_simple_random_high_rate():
    J.test_simple_random_high_rate()
    rows = make_gaussian_blob(297, dims=10, spread=0.8, seed=1)
    aspace, gl = _both(lambda b, S: b.with_inline_sampling(S.simple(0.8))
                       .with_lambda_graph(1.0, 3, 3, 2.0, None).with_seed(42),
                       rows.tolist())
    assert 0.70 <= _kept(aspace) / len(rows) <= 0.90
    assert tuple(aspace.data.shape) == (297, 10)
    assert gl.nnodes == 297


def test_simple_random_aggressive_sampling():
    J.test_simple_random_aggressive_sampling()
    rows = make_gaussian_blob(99, dims=10, spread=0.5, seed=2)
    aspace, _ = _both(lambda b, S: b.with_inline_sampling(S.simple(0.2))
                      .with_lambda_graph(1.0, 5, 5, 2.0, None).with_seed(7),
                      rows.tolist())
    assert 0.08 <= _kept(aspace) / len(rows) <= 0.35
    assert np.all(np.isfinite(np.asarray(aspace.lambdas)))


def test_simple_random_vs_density_adaptive():
    J.test_simple_random_vs_density_adaptive()
    rows = make_moons_hd(100, 0.10, 0.30, 10, 42)
    a_simple, _ = _both(lambda b, S: b.with_inline_sampling(S.simple(0.5))
                        .with_lambda_graph(1e-3, 3, 3, 2.0, None)
                        .with_seed(42), rows.tolist())
    a_adapt, _ = _both(lambda b, S: b.with_inline_sampling(
        S.density_adaptive(0.5)).with_lambda_graph(1e-3, 3, 3, 2.0, None)
        .with_seed(42), rows.tolist())
    assert 0.40 <= _kept(a_simple) / len(rows) <= 0.65
    assert 0.30 <= _kept(a_adapt) / len(rows) <= 0.70


def test_density_adaptive_sampling_basic():
    J.test_density_adaptive_sampling_basic()
    rows = [[1.0, 0.0, 0.0], [1.1, 0.1, 0.0], [1.0, 0.0, 0.1],
            [1.1, 0.1, 0.1], [5.0, 5.0, 5.0], [5.1, 5.0, 5.0],
            [5.0, 5.1, 5.0], [5.0, 5.0, 5.1]]
    aspace, gl = _both(lambda b, S: b.with_inline_sampling(
        S.density_adaptive(0.5)).with_lambda_graph(1.0, 3, 3, 2.0, None)
        .with_seed(3), rows)
    assert tuple(aspace.data.shape) == (8, 3)
    assert gl.nnodes == 8
    assert gl.matrix.shape[1] == 3


def test_constant_sampler_preserves_outliers():
    J.test_constant_sampler_preserves_outliers()
    rows = make_gaussian_blob(99, dims=3, spread=0.3, seed=4)
    rows = np.concatenate([rows, np.full((4, 3), 10.0)
                           + np.random.default_rng(4).normal(0, 0.1, (4, 3))])
    aspace, _ = _both(lambda b, S: b.with_lambda_graph(0.5, 3, 2, 2.0, 0.25)
                      .with_inline_sampling(S.simple(0.8)).with_seed(8),
                      rows.tolist())
    assert np.any(np.asarray(aspace.data).sum(axis=1) > 15.0)


def test_density_adaptive_with_uniform_data():
    J.test_density_adaptive_with_uniform_data()
    rows = make_moons_hd(50, 0.3, 0.52, 10, 42)
    aspace, gl = _both(lambda b, S: b.with_inline_sampling(
        S.density_adaptive(0.5)).with_lambda_graph(1.0, 5, 5, 2.0, None)
        .with_seed(9), rows.tolist())
    assert aspace.data.shape[1] == 10
    assert gl.nnodes == 50


def test_density_adaptive_aggressive_sampling():
    J.test_density_adaptive_aggressive_sampling()
    rows = make_moons_hd(50, 0.10, 0.40, 10, 42)
    aspace, gl = _both(lambda b, S: b.with_inline_sampling(
        S.density_adaptive(0.5)).with_lambda_graph(2.0, 5, 5, 2.0, None)
        .with_seed(10), rows.tolist())
    assert tuple(aspace.data.shape) == (50, 10)
    assert gl.nnodes == 50
    assert gl.matrix.shape[0] == 10
    assert _kept(aspace) >= 4


def test_density_adaptive_with_duplicates():
    J.test_density_adaptive_with_duplicates()
    rows = [[1.0, 2.0, 3.0], [1.0, 2.0, 3.0], [1.001, 2.001, 3.001],
            [1.0, 2.0, 3.0], [5.0, 6.0, 7.0], [5.0, 6.0, 7.0],
            [5.001, 6.001, 7.001]]
    aspace, gl = _both(lambda b, S: b.with_inline_sampling(
        S.density_adaptive(0.5)).with_lambda_graph(1.0, 3, 3, 2.0, None)
        .with_seed(11), rows)
    assert tuple(aspace.data.shape) == (7, 3)
    assert gl.nnodes > 0
    assert 1 <= aspace.n_clusters <= 5


def test_density_adaptive_sampling_statistics():
    J.test_density_adaptive_sampling_statistics()
    for i in range(1, 4):
        rows = make_moons_hd(50 * i, 0.5, 0.2, 10 * i, 42 * i)
        aspace, gl = _both(lambda b, S: b.with_inline_sampling(
            S.density_adaptive(0.5)).with_sparsity_check(False)
            .with_seed(i), rows.tolist())
        assert tuple(aspace.data.shape) == (50 * i, 10 * i)
        assert gl.nnodes == 50 * i


def test_density_adaptive_vs_no_sampling():
    J.test_density_adaptive_vs_no_sampling()
    rows = make_gaussian_blob(99, dims=10, spread=0.5, seed=5)
    a_full, gl_full = _both(lambda b, S: b.with_lambda_graph(1.0, 5, 5, 2.0,
                                                             None)
                            .with_inline_sampling(None).with_seed(12),
                            rows.tolist())
    a_sampled, gl_sampled = _both(lambda b, S: b.with_inline_sampling(
        S.density_adaptive(0.5)).with_lambda_graph(1.0, 5, 5, 2.0, None)
        .with_seed(12), rows.tolist())
    assert a_sampled.data.shape == a_full.data.shape
    assert _kept(a_sampled) < _kept(a_full)
    assert gl_sampled.nnodes > 0 and gl_full.nnodes > 0


def test_density_adaptive_maintains_lambda_quality():
    J.test_density_adaptive_maintains_lambda_quality()
    for i in (1, 2):
        rows = make_moons_hd(33 * i, 0.25 * i, 0.25 * i, 100 * i, 128 * i)
        aspace, _ = _both(lambda b, S: b.with_lambda_graph(1.0, 3, 3, 2.0, 0.5)
                          .with_inline_sampling(S.density_adaptive(0.4))
                          .with_sparsity_check(False).with_seed(128 * i),
                          rows.tolist())
        lam = np.asarray(aspace.lambdas)
        assert np.all(lam >= 0.0)
        assert np.any(np.abs(lam - lam.mean()) > 1e-12), i


def test_builder_unit_norm_build_works():
    J.test_builder_unit_norm_build_works()
    raw = make_moons_hd(80, 0.50, 0.50, 9, 789)
    norms = np.linalg.norm(raw, axis=1, keepdims=True)
    unit = np.where(norms > 1e-12, raw / norms, raw)

    def cfg(b, S):
        return (b.with_lambda_graph(0.3, 4, 2, 2.0, None)
                .with_normalisation(False).with_dims_reduction(False, None)
                .with_inline_sampling(None).with_seed(42))
    a_unit, _ = _both(cfg, unit.tolist())
    a_raw, _ = _both(cfg, raw.tolist())
    assert a_unit.data.shape == a_raw.data.shape
    assert a_unit.n_clusters >= 1 and a_raw.n_clusters >= 1
