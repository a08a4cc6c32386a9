"""arrowspace_torch.clustering against the JAX package: the seeded build's
host path (optimal K, radius, the ordered incremental scan) gives
identical K, radius, centroids, assignments and sizes on the same rows
and seed."""

import numpy as np
import pytest

from arrowspace_tpu import clustering as jc
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.sampling import SamplerType as JSampler
from arrowspace_torch import clustering as tc
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.sampling import SamplerType


def _clustered(seed, n=2000, f=32, centres=12, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


@pytest.mark.parametrize("seed,n,f", [(0, 2000, 32), (1, 600, 8),
                                      (2, 5000, 16)])
def test_compute_optimal_k_identical(seed, n, f):
    rows = _clustered(seed, n=n, f=f)
    assert tc.compute_optimal_k(rows, n, f, 11) == \
        jc.compute_optimal_k(rows, n, f, 11)


def test_pilot_helpers_identical():
    rows = _clustered(3, n=500, f=10)
    a_t = tc.kmeans_lloyd(rows, 7, 20, 5)
    a_j = jc.kmeans_lloyd(rows, 7, 20, 5)
    np.testing.assert_array_equal(a_t, a_j)
    assert tc.calinski_harabasz_score(rows, a_t, 7) == \
        jc.calinski_harabasz_score(rows, a_j, 7)
    assert tc.compute_threshold_from_pilot(rows, 7, 5) == \
        jc.compute_threshold_from_pilot(rows, 7, 5)
    assert tc.estimate_intrinsic_dimension(rows, 500, 10, 5) == \
        jc.estimate_intrinsic_dimension(rows, 500, 10, 5)


@pytest.mark.parametrize("rate", [0.6, None])
def test_seeded_scan_identical(rate):
    rows = _clustered(4)
    n, f = rows.shape
    k, radius, _ = tc.compute_optimal_k(rows, n, f, 11)
    tb = ArrowSpaceBuilder(device="cpu").with_seed(11) \
        .with_inline_sampling(SamplerType.simple(rate) if rate else None)
    jb = JBuilder().with_seed(11).with_inline_sampling(
        JSampler.simple(rate) if rate else None)
    t_s = tb.sampling.make(seed=11) if rate else None
    j_s = jb.sampling.make(seed=11) if rate else None
    c_t, a_t, s_t = tc.run_incremental_clustering_with_sampling(
        tb, rows, f, k, radius, t_s)
    c_j, a_j, s_j = jc._incremental_clustering_numpy(
        jb, rows, f, k, radius, j_s)
    np.testing.assert_array_equal(c_t, c_j)
    assert list(a_t) == list(a_j)
    assert s_t == s_j


@pytest.mark.parametrize("rate", [0.6, None])
def test_unseeded_large_takes_chunked_scan(rate, monkeypatch):
    """An unseeded run of 4096 rows takes the chunked scan (host BLAS
    below the engine's gate) and equals the JAX package's result under
    samplers seeded alike."""
    rows = _clustered(5, n=4096, f=4)
    calls = []
    inner = tc._incremental_clustering_chunked
    monkeypatch.setattr(tc, "_incremental_clustering_chunked",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    tb = ArrowSpaceBuilder(device="cpu").with_inline_sampling(
        SamplerType.simple(rate) if rate else None)
    jb = JBuilder().with_inline_sampling(JSampler.simple(rate) if rate
                                         else None)
    t_s = SamplerType.simple(rate or 1.0).make(seed=3)
    j_s = JSampler.simple(rate or 1.0).make(seed=3)
    c_t, a_t, s_t = tc.run_incremental_clustering_with_sampling(
        tb, rows, 4, 8, 0.5, t_s)
    c_j, a_j, s_j = jc.run_incremental_clustering_with_sampling(
        jb, rows, 4, 8, 0.5, j_s)
    assert calls == [1]
    np.testing.assert_allclose(c_t, c_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(a_t.array, a_j.array)
    assert s_t == s_j
    assert t_s.get_stats() == j_s.get_stats()
