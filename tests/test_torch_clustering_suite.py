"""The cases of tests/test_clustering.py (mirroring the reference's
tests/test_clustering.rs) that no port test ran by name, in both
packages: each case once as the JAX package runs it (by calling the JAX
test itself) and once on ``arrowspace_torch.clustering``, on the same
rows.  The port's seeded helpers are copies of the JAX package's numpy
code, so their results are also held to the JAX package's on the same
inputs: equal K, radius, labels, centroids and assignments.

The JAX file's other cases map in tests/test_torch_parity_map.py: the
engine, tail, at-cap and Two-NN cases to
tests/test_torch_chunked_clustering.py, the native scan's to
tests/test_torch_native_clustering.py, and ``test_bucket_rows_schedule``
(an XLA recompile bucket) to ``NOT_PORTED``.

Tolerances: exact where the JAX case is exact; centroids across
packages within 1e-12 (float64, the same numpy arithmetic)."""

import numpy as np
import pytest
import torch

import test_clustering as J
from arrowspace_tpu import clustering as jc
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.sampling import SamplerType as JSampler
from arrowspace_torch import clustering as tc
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.sampling import SamplerType
from data import make_gaussian_blob, make_moons_hd


def test_assignments_sequence_semantics():
    J.test_assignments_sequence_semantics()
    a = tc.Assignments(np.asarray([0, -1, 2, 1]))
    assert len(a) == 4
    assert a[0] == 0 and a[1] is None and a[3] == 1
    assert list(a) == [0, None, 2, 1]
    assert a == [0, None, 2, 1]
    assert a[1:3] == [None, 2]
    np.testing.assert_array_equal(np.asarray(a), [0, -1, 2, 1])
    assert sum(1 for x in a if x is not None) == 3


def test_assignments_eq_and_hash_semantics():
    J.test_assignments_eq_and_hash_semantics()
    a = tc.Assignments(np.array([0, -1, 2]))
    assert a == np.array([0, -1, 2])
    assert not (a == np.array([0, 1, 2]))
    assert a == [0, None, 2]
    assert a == tc.Assignments(np.array([0, -1, 2]))
    with pytest.raises(TypeError):
        hash(a)


def test_euclidean_and_nearest_centroid():
    J.test_euclidean_and_nearest_centroid()
    assert tc.euclidean_dist([1.0, 1.0], [4.0, 5.0]) == pytest.approx(5.0)
    idx, d2 = tc.nearest_centroid([9.0, 0.0], [[0.0, 0.0], [10.0, 0.0]])
    assert idx == 1 and d2 == pytest.approx(1.0)


def test_kmeans_basic_and_edge_cases():
    J.test_kmeans_basic_and_edge_cases()
    rows = np.concatenate([
        make_gaussian_blob(20, dims=4, spread=0.1, seed=1),
        make_gaussian_blob(20, dims=4, spread=0.1, seed=2) + 10.0])
    labels = tc.kmeans_lloyd(rows, 2, 20, seed=7)
    np.testing.assert_array_equal(labels, jc.kmeans_lloyd(rows, 2, 20,
                                                          seed=7))
    assert set(labels) == {0, 1}
    assert len(set(labels[:20])) == 1 and len(set(labels[20:])) == 1
    assert len(tc.kmeans_lloyd(rows[:3], 10, 5, seed=1)) == 3
    assert tc.kmeans_lloyd([], 3, 5, seed=1).size == 0


def test_kmeans_k_zero_and_k_equals_n():
    J.test_kmeans_k_zero_and_k_equals_n()
    rows = make_gaussian_blob(10, dims=3, seed=50)
    assert tc.kmeans_lloyd(rows, 0, 10, 128).size == 0
    assert len(set(tc.kmeans_lloyd(rows, 10, 10, 128))) == 10


def test_calinski_harabasz_separated_blobs():
    J.test_calinski_harabasz_separated_blobs()
    rows = np.concatenate([
        make_gaussian_blob(30, dims=3, spread=0.05, seed=3),
        make_gaussian_blob(30, dims=3, spread=0.05, seed=4) + 20.0])
    good = np.array([0] * 30 + [1] * 30)
    bad = np.array([0, 1] * 30)
    assert tc.calinski_harabasz_score(rows, good, 2) > \
        tc.calinski_harabasz_score(rows, bad, 2)
    assert tc.calinski_harabasz_score(rows, good, 2) == \
        jc.calinski_harabasz_score(rows, good, 2)
    assert tc.calinski_harabasz_score(rows, good, 1) == 0.0


def test_intrinsic_dimension_line_plane_full():
    J.test_intrinsic_dimension_line_plane_full()
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 10, 200)
    line = np.stack([t, 2 * t, -t, 0.5 * t], axis=1)
    assert tc.estimate_intrinsic_dimension(line, 200, 4, 128) <= 2
    full = rng.normal(size=(200, 6))
    assert tc.estimate_intrinsic_dimension(full, 200, 6, 128) >= 3
    assert tc.estimate_intrinsic_dimension(full, 200, 6, 128) == \
        jc.estimate_intrinsic_dimension(full, 200, 6, 128)
    assert tc.estimate_intrinsic_dimension(full[:5], 5, 6, 128) == 2


def test_compute_optimal_k_bounds_and_determinism():
    J.test_compute_optimal_k_bounds_and_determinism()
    rows = make_moons_hd(300, noise=0.05, hd_noise=0.02, dims=12, seed=9)
    out1 = tc.compute_optimal_k(rows, 300, 12, 42)
    assert out1 == tc.compute_optimal_k(rows, 300, 12, 42)
    assert out1 == jc.compute_optimal_k(rows, 300, 12, 42)
    assert 2 <= out1[0] <= 150 and out1[1] > 0


def test_degenerate_identical_rows():
    J.test_degenerate_identical_rows()
    k, radius, ident = tc.compute_optimal_k(np.ones((30, 4)), 30, 4, 128)
    assert k >= 2 and radius == pytest.approx(1e-6) and ident >= 1


def test_threshold_zero_variance_clusters():
    J.test_threshold_zero_variance_clusters()
    rows = np.array([[0.0, 0.0]] * 10 + [[100.0, 100.0]] * 10)
    r = tc.compute_threshold_from_pilot(rows, 2, 128)
    assert r == pytest.approx(20000 * 0.15, rel=0.2) or r >= 1e-6
    assert r == jc.compute_threshold_from_pilot(rows, 2, 128)


def test_single_feature_dataset():
    J.test_single_feature_dataset()
    rows = np.random.default_rng(60).normal(size=(50, 1))
    k, radius, ident = tc.compute_optimal_k(rows, 50, 1, 128)
    assert k >= 2 and radius > 0 and ident == 1


def test_threshold_pilot_scenarios():
    J.test_threshold_pilot_scenarios()
    rows = [[0.0, 0.0]] * 50 + [[10.0, 10.0]] * 50
    assert 1.0 < tc.compute_threshold_from_pilot(rows, 2, 42) < 80.0
    rows = [[(i - 50.0) * 0.5] * 2 for i in range(100)]
    assert tc.compute_threshold_from_pilot(rows, 3, 42) > 1.0
    assert tc.compute_threshold_from_pilot([[5.0, 5.0]] * 10, 3, 42) >= 1e-6
    rng = np.random.default_rng(0)
    rows = ([[rng.random() * 1e-4, 0.0] for _ in range(20)]
            + [[100.0 + rng.random() * 1e-4, 0.0] for _ in range(20)])
    assert tc.compute_threshold_from_pilot(rows, 2, 42) > 0.01
    assert tc.compute_threshold_from_pilot(rows, 2, 42) == \
        jc.compute_threshold_from_pilot(rows, 2, 42)


def test_step1_bounds_scenarios():
    J.test_step1_bounds_scenarios()
    rng = np.random.default_rng(1)
    for n, f in ((60, 4), (5000, 3), (200, 512)):
        rows = rng.normal(size=(n, f))
        k_min, k_max, id_est = tc._step1_bounds(rows, n, f, 128)
        assert (k_min, k_max, id_est) == jc._step1_bounds(rows, n, f, 128)
        assert k_min == max(int(np.ceil(np.sqrt(n / 10.0))), 2)
        assert k_min < k_max <= max(
            min(f, n // 10, 5 * id_est, int(n ** 0.5)), k_min + 1)
        assert k_max <= n // 2 and 1 <= id_est <= f


def test_optimal_k_heuristic_scenarios():
    J.test_optimal_k_heuristic_scenarios()
    rng = np.random.default_rng(2)
    centers = rng.uniform(-5, 5, (4, 8))
    cases = [(np.vstack([c + rng.normal(0, 0.1, (40, 8)) for c in centers]),
              None)]
    cases.append((rng.normal(size=(120, 64)), 60))
    cases.append((np.column_stack([rng.normal(0, 1000, 90),
                                   rng.normal(0, 0.001, 90),
                                   rng.normal(0, 1, 90)]), 45))
    cases.append((rng.normal(size=(20, 2)), 10))
    for rows, cap in cases:
        n, f = rows.shape
        k, r, _ = tc.compute_optimal_k(rows, n, f, 42)
        assert 2 <= k <= (cap or n // 2) and r > 0
        assert (k, r) == jc.compute_optimal_k(rows, n, f, 42)[:2]


def _scan(pkg, rows, max_clusters, radius, sampling=None, seed=None):
    """The JAX case's _run_incremental on either package."""
    builder, sampler_type, mod = pkg
    b = builder()
    b.sampling = sampling
    if seed is not None:
        b.with_seed(seed)
    sampler = (sampling or sampler_type.simple(1.0)).make(seed=seed)
    return mod.run_incremental_clustering_with_sampling(
        b, rows, rows.shape[1], max_clusters, radius, sampler)


PORT = (lambda: ArrowSpaceBuilder(device="cpu", dtype=torch.float64),
        SamplerType, tc)
JAX = (JBuilder, JSampler, jc)


def _sentinel(assigns):
    """Assignments as an int array, -1 for a dropped row (the private
    scans return the sentinel array, the public one Assignments)."""
    return np.asarray([-1 if v is None else int(v) for v in assigns])


def _same_scan(a, b):
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(_sentinel(a[1]), _sentinel(b[1]))
    assert list(a[2]) == list(b[2])


def test_incremental_clustering_no_sampling():
    J.test_incremental_clustering_no_sampling()
    rows = np.concatenate([
        make_gaussian_blob(25, dims=5, spread=0.05, seed=5),
        make_gaussian_blob(25, dims=5, spread=0.05, seed=6) + 5.0])
    out = _scan(PORT, rows, 10, 1.0)
    cents, assigns, sizes = out
    assert cents.shape[1] == 5 and 2 <= cents.shape[0] <= 10
    assert len(assigns) == 50
    assert sum(sizes) == sum(1 for a in assigns if a is not None)
    _same_scan(out, _scan(JAX, rows, 10, 1.0))


def test_incremental_clustering_seeded_deterministic():
    J.test_incremental_clustering_seeded_deterministic()
    rows = make_moons_hd(200, noise=0.1, hd_noise=0.05, dims=8, seed=21)
    out1 = _scan(PORT, rows, 15, 0.5, SamplerType.simple(0.6), seed=99)
    out2 = _scan(PORT, rows, 15, 0.5, SamplerType.simple(0.6), seed=99)
    _same_scan(out1, out2)
    _same_scan(out1, _scan(JAX, rows, 15, 0.5, JSampler.simple(0.6),
                           seed=99))


def test_incremental_clustering_respects_cap():
    J.test_incremental_clustering_respects_cap()
    rows = np.random.default_rng(11).uniform(-100, 100, (300, 4))
    out = _scan(PORT, rows, 7, 1.0)
    assert out[0].shape[0] <= 7
    _same_scan(out, _scan(JAX, rows, 7, 1.0))


def _chunked_rows(seed, centres, n, f, noise):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


def _port_builder(sampling):
    b = ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
    b.sampling = sampling
    return b


def test_chunked_parallel_mode():
    J.test_chunked_parallel_mode()
    rows = _chunked_rows(17, 6, 6000, 10, 0.05)
    cents, assigns, sizes = tc._incremental_clustering_chunked(
        _port_builder(SamplerType.simple(0.6)), rows, 10, 12, 0.3,
        SamplerType.simple(0.6).make(seed=3))
    assert 1 <= cents.shape[0] <= 12 and len(assigns) == 6000
    assert sum(sizes) == sum(1 for a in assigns if a is not None)
    assert all(a is None or 0 <= a < cents.shape[0] for a in assigns)
    cents_seq, _, _ = tc._incremental_clustering_numpy(
        _port_builder(SamplerType.simple(0.6)), rows, 10, 12, 0.3,
        SamplerType.simple(0.6).make(seed=3))
    assert abs(cents.shape[0] - cents_seq.shape[0]) <= 6


def test_chunked_mode_speed_sanity():
    import time
    J.test_chunked_mode_speed_sanity()
    rows = np.random.default_rng(23).uniform(0, 1, (100_000, 32))
    t0 = time.perf_counter()
    cents, _a, _s = tc._incremental_clustering_chunked(
        _port_builder(None), rows, 32, 64, 0.5,
        SamplerType.simple(1.0).make(seed=1))
    assert time.perf_counter() - t0 < 10.0
    assert cents.shape[0] >= 1


def test_chunked_drift_from_sequential_characterized():
    J.test_chunked_drift_from_sequential_characterized()
    rows = _chunked_rows(53, 8, 20000, 24, 0.03)
    c_seq, a_seq, _ = tc._incremental_clustering_numpy(
        _port_builder(None), rows, 24, 16, 0.35,
        SamplerType.simple(1.0).make(seed=1))
    c_chk, a_chk, _ = tc._incremental_clustering_chunked(
        _port_builder(None), rows, 24, 16, 0.35,
        SamplerType.simple(1.0).make(seed=1), chunk=4096)
    assert abs(c_seq.shape[0] - c_chk.shape[0]) <= 2
    d = np.linalg.norm(c_seq[:, None, :] - c_chk[None, :, :], axis=2)
    assert d.min(axis=1).max() < 0.35 * 0.5
    assert d.min(axis=0).max() < 0.35 * 0.5
    match = np.argmin(d, axis=0)
    a_seq_arr = np.asarray([-1 if a is None else a for a in a_seq])
    a_chk_arr = np.asarray([-1 if a is None else match[a] for a in a_chk])
    both = (a_seq_arr >= 0) & (a_chk_arr >= 0)
    assert np.mean(a_seq_arr[both] == a_chk_arr[both]) > 0.95


def test_native_density_adaptive_matches_numpy():
    """The port's native density-adaptive scan against its numpy path and
    the JAX package's numpy path (the JAX case compares the JAX native
    library, which this machine may not have built, and skips then)."""
    from arrowspace_torch.native import native_incremental_clustering
    rows = make_moons_hd(150, noise=0.08, hd_noise=0.04, dims=6, seed=41)

    def builder():
        b = _port_builder(SamplerType.density_adaptive(0.7))
        return b.with_seed(321)
    s1 = SamplerType.density_adaptive(0.7).make(seed=321)
    out_native = native_incremental_clustering(builder(), rows, 6, 12, 0.4,
                                               s1)
    s2 = SamplerType.density_adaptive(0.7).make(seed=321)
    out_numpy = tc._incremental_clustering_numpy(builder(), rows, 6, 12, 0.4,
                                                 s2)
    _same_scan(out_native, out_numpy)
    assert s1.get_stats() == s2.get_stats()
    jb = JBuilder()
    jb.sampling = JSampler.density_adaptive(0.7)
    jb.with_seed(321)
    s3 = JSampler.density_adaptive(0.7).make(seed=321)
    _same_scan(out_native, jc._incremental_clustering_numpy(
        jb, rows, 6, 12, 0.4, s3))
    assert s1.get_stats() == s3.get_stats()


def test_device_chunk_clamped_to_short_wide_corpus():
    """The port's engine on a CPU tensor (its device path, keyed on size
    alone): 4500 × 1024 is over the gate and under the 8192-row floor."""
    J.test_device_chunk_clamped_to_short_wide_corpus()
    n, f = 4500, 1024
    assert n * f >= tc.DEVICE_CLUSTERING_MIN_ELEMS
    assert tc._device_chunk_for(n) == n
    rows = _chunked_rows(61, 6, n, f, 0.03)
    cents, assigns, _sizes = tc._incremental_clustering_chunked(
        _port_builder(None), rows, f, 16, 2.0,
        SamplerType.simple(1.0).make(seed=1),
        device_data=torch.from_numpy(rows))
    assert cents.shape[1] == f and cents.shape[0] >= 1
    assert len(assigns) == n
