"""The unseeded build's clustering (the chunked scan and its engine) and
the Two-NN estimate's device tile in arrowspace_torch, against the JAX
package, in float64 on the CPU.

The JAX engine runs on its CPU backend with device_data=jnp.asarray(rows)
and both packages' DEVICE_CLUSTERING_MIN_ELEMS lowered to 0, so small
corpora take the engine (as tests/test_clustering.py does).  Tolerances:
centroids rtol 1e-9 / atol 1e-12 (grouped sums add in another order);
assignments, sizes and sampler counts equal; the two smallest Two-NN d²
rtol 1e-10 and the estimate equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowspace_tpu import clustering as jc
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.sampling import SamplerType as JSampler
from arrowspace_torch import clustering as tc
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.sampling import SamplerType

CPU64 = dict(device="cpu", dtype=torch.float64)


def _clustered(seed, n, f, centres, noise=0.04):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


def _builders(sampling, seed):
    """(torch builder, torch sampler, JAX builder, JAX sampler), unseeded
    builders with samplers seeded alike."""
    kinds = {"none": (None, 1.0), "simple": ("simple", 0.6),
             "density": ("density_adaptive", 0.7)}
    kind, rate = kinds[sampling]
    tb, jb = ArrowSpaceBuilder(**CPU64), JBuilder()
    if kind is None:
        tb.sampling = jb.sampling = None
        return (tb, SamplerType.simple(1.0).make(seed=seed), jb,
                JSampler.simple(1.0).make(seed=seed))
    tb.sampling = getattr(SamplerType, kind)(rate)
    jb.sampling = getattr(JSampler, kind)(rate)
    return tb, tb.sampling.make(seed=seed), jb, jb.sampling.make(seed=seed)


def _assert_same(t_out, j_out, ts, js):
    (c_t, a_t, z_t), (c_j, a_j, z_j) = t_out, j_out
    assert c_t.shape == c_j.shape
    np.testing.assert_allclose(c_t, c_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(a_t.array, a_j.array)
    assert z_t == z_j
    assert ts.get_stats() == js.get_stats()


@pytest.fixture
def engine_everywhere(monkeypatch):
    monkeypatch.setattr(tc, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
    monkeypatch.setattr(jc, "DEVICE_CLUSTERING_MIN_ELEMS", 0)


@pytest.fixture
def tail_calls(monkeypatch):
    """Start rows of each at-cap tail call of the port's scan."""
    calls = []
    inner = tc._apply_atcap_tail

    def counted(engine, c0, *a, **k):
        calls.append(c0)
        return inner(engine, c0, *a, **k)

    monkeypatch.setattr(tc, "_apply_atcap_tail", counted)
    return calls


@pytest.mark.parametrize("sampling", ["none", "simple", "density"])
@pytest.mark.parametrize("path", ["host", "engine"])
@pytest.mark.parametrize("cap", [6, 64])
def test_chunked_scan_matches_jax(sampling, path, cap, monkeypatch,
                                  tail_calls):
    """9777 rows (a misaligned last chunk of 1585 at chunk 2048): a cap of
    6 is reached in the first chunk, so the engine runs the at-cap tail
    over most of the scan; a cap of 64 is never reached."""
    if path == "engine":
        monkeypatch.setattr(tc, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
        monkeypatch.setattr(jc, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
    rows = _clustered(61, 9777, 16, 10)
    tb, ts, jb, js = _builders(sampling, 5)
    dev_t = torch.as_tensor(rows) if path == "engine" else None
    dev_j = jnp.asarray(rows) if path == "engine" else None
    t_out = tc._incremental_clustering_chunked(tb, rows, 16, cap, 0.3, ts,
                                               chunk=2048, device_data=dev_t)
    j_out = jc._incremental_clustering_chunked(jb, rows, 16, cap, 0.3, js,
                                               chunk=2048, device_data=dev_j)
    _assert_same(t_out, j_out, ts, js)
    if path == "engine" and cap == 6:
        assert len(tail_calls) == 1 and tail_calls[0] <= len(rows) // 2
    else:
        assert tail_calls == []


@pytest.mark.parametrize("path", ["host", "engine"])
def test_chunked_scan_misaligned_tail(path, monkeypatch, tail_calls):
    """5777 uniform rows at chunk 2048 (the last window clamped to
    n - chunk, its first 271 rows masked), no sampling, cap 32."""
    if path == "engine":
        monkeypatch.setattr(tc, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
        monkeypatch.setattr(jc, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
    rows = np.random.default_rng(43).uniform(0, 1, (5777, 16))
    tb, ts, jb, js = _builders("none", 1)
    dev_t = torch.as_tensor(rows) if path == "engine" else None
    dev_j = jnp.asarray(rows) if path == "engine" else None
    t_out = tc._incremental_clustering_chunked(tb, rows, 16, 32, 0.4, ts,
                                               chunk=2048, device_data=dev_t)
    j_out = jc._incremental_clustering_chunked(jb, rows, 16, 32, 0.4, js,
                                               chunk=2048, device_data=dev_j)
    assert len(t_out[1]) == rows.shape[0]
    _assert_same(t_out, j_out, ts, js)
    assert len(tail_calls) == (1 if path == "engine" else 0)


@pytest.mark.parametrize("sampling", ["none", "simple", "density"])
def test_engine_equals_host_path(sampling, engine_everywhere, tail_calls):
    """The port's engine (float64 CPU tensor) and its host-BLAS path give
    the same scan at the same chunking: decisions, centroids, sampler
    draws."""
    rows = _clustered(41, 9000, 16, 8)
    tb1, ts1, _, _ = _builders(sampling, 7)
    tb2, ts2, _, _ = _builders(sampling, 7)
    host = tc._incremental_clustering_chunked(tb1, rows, 16, 5, 0.3, ts1,
                                              chunk=2048)
    eng = tc._incremental_clustering_chunked(
        tb2, rows, 16, 5, 0.3, ts2, chunk=2048,
        device_data=torch.as_tensor(rows))
    assert len(tail_calls) == 1
    _assert_same(eng, host, ts2, ts1)
    assert set(tb2.clustering_seconds) >= {"scan_pre_cap", "scan_tail"}


def test_engine_chunk_and_bucket_helpers():
    for n in (4500, 8192, 50_000, 131072, 1 << 22, 10_000_000):
        assert tc._device_chunk_for(n) == jc._device_chunk_for(n)
    for k in (1, 127, 128, 129, 600):
        assert tc._bucket_centroid_cap(k) == jc._bucket_centroid_cap(k)


def test_unseeded_build_matches_jax(monkeypatch):
    """ArrowIndex.build without a seed (default sampling simple(0.6)) at
    5000 x 24 in float64: with both packages' samplers seeded alike, the
    same clusters, assignments, sizes and λ as the JAX package's build."""
    for cls in (SamplerType, JSampler):
        orig = cls.make
        monkeypatch.setattr(cls, "make",
                            lambda self, seed=None, _o=orig: _o(self, seed=3))
    rows = _clustered(8, 5000, 24, 12, noise=0.05)
    t = ArrowIndex.build(rows, eps=1.0, **CPU64)
    j = JIndex.build(rows, eps=1.0)
    assert not t.builder.deterministic_clustering
    assert t.aspace.n_clusters == j.aspace.n_clusters
    np.testing.assert_array_equal(t.aspace.cluster_assignments,
                                  j.aspace.cluster_assignments)
    np.testing.assert_array_equal(t.aspace.cluster_sizes,
                                  j.aspace.cluster_sizes)
    np.testing.assert_allclose(t.lambdas, np.asarray(j.lambdas), rtol=1e-9,
                               atol=1e-12)
    assert set(t.builder.clustering_seconds) >= {
        "twonn", "optimal_k", "scan", "scan_pre_cap", "scan_tail"}


@pytest.mark.parametrize("win", [300, 512, 2000])
@pytest.mark.parametrize("n_sample", [500, 256, 37])
def test_twonn_device_tile_matches_jax(win, n_sample, monkeypatch):
    """The port's tile with its corpus window forced small (several
    windows; 2000 % 300 and 2000 % 512 leave a clamped tail window)
    against the JAX tile on the same indices (a sample count that is and
    is not a multiple of the 256-row block)."""
    monkeypatch.setattr(tc, "TWONN_CORPUS_WIN", win)
    rng = np.random.default_rng(47)
    rows = rng.normal(size=(2000, 3)) @ rng.normal(size=(3, 32))
    idx = np.random.default_rng(8).permutation(2000)[:n_sample]
    t = tc._twonn_two_smallest_device(torch.as_tensor(rows), idx)
    j = jc._twonn_two_smallest_device(jnp.asarray(rows), idx)
    assert t.shape == (n_sample, 2)
    np.testing.assert_allclose(t, j, rtol=1e-10)
    assert (t[:, 0] <= t[:, 1]).all()
    # the host tiles, float32, on the same sample: the same estimate
    h = tc._twonn_two_smallest_host(rows, idx)
    assert tc._twonn_dimension(t, 32) == tc._twonn_dimension(h, 32)


@pytest.mark.parametrize("seed,n,f", [(0, 3000, 32), (2, 5000, 16)])
def test_estimate_and_optimal_k_on_device_data_match_jax(seed, n, f,
                                                         engine_everywhere):
    """estimate_intrinsic_dimension and compute_optimal_k with device_data
    (gates at 0, so the tile runs) equal the JAX package's; the host
    estimate equals them too."""
    rows = _clustered(seed, n, f, 12, noise=0.05)
    dt, dj = torch.as_tensor(rows), jnp.asarray(rows)
    est = tc.estimate_intrinsic_dimension(rows, n, f, 11, device_data=dt)
    assert est == jc.estimate_intrinsic_dimension(rows, n, f, 11,
                                                  device_data=dj)
    assert est == tc.estimate_intrinsic_dimension(rows, n, f, 11)
    seconds = {}
    assert tc.compute_optimal_k(rows, n, f, 11, device_data=dt,
                                seconds=seconds) == \
        jc.compute_optimal_k(rows, n, f, 11, device_data=dj)
    assert seconds["twonn"] >= 0.0


def test_host_twonn_estimate_unchanged():
    """The host tiles (now shared with the smoke's comparison) give the
    JAX package's host estimate."""
    rows = _clustered(4, 2000, 10, 6, noise=0.05)
    for base in (0, 11, 128):
        assert tc.estimate_intrinsic_dimension(rows, 2000, 10, base) == \
            jc.estimate_intrinsic_dimension(rows, 2000, 10, base)
