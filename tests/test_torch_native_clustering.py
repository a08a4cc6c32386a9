"""arrowspace_torch's native clustering scan (native/clustering.cpp, built
with the host C++ compiler) against the JAX package's numpy scan
(``arrowspace_tpu.clustering._incremental_clustering_numpy``) on the same
rows and seed: no sampling, the simple sampler and the density-adaptive
one.  Centroids within rtol 1e-12 (the C++ distance sums its squares in
eight lanes, numpy pairwise; the running means are the same operations),
assignments, sizes and the samplers' counts equal.  The certified
blocked scan is bit-identical to the one-shot scan across block
boundaries."""

import numpy as np
import pytest

from arrowspace_tpu import clustering as jc
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.sampling import SamplerType as JSampler
from arrowspace_torch import clustering as tc
from arrowspace_torch import native
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.sampling import SamplerType


def _clustered(seed, n, f, centres=12, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


def _builders(kind, rate, seed):
    tb = ArrowSpaceBuilder(device="cpu").with_seed(seed)
    jb = JBuilder().with_seed(seed)
    if kind is None:
        return tb.with_inline_sampling(None), jb.with_inline_sampling(None)
    mk_t = getattr(SamplerType, kind)
    mk_j = getattr(JSampler, kind)
    return (tb.with_inline_sampling(mk_t(rate)),
            jb.with_inline_sampling(mk_j(rate)))


def _samplers(tb, jb, seed):
    if tb.sampling is None:
        return (SamplerType.simple(1.0).make(seed=seed),
                JSampler.simple(1.0).make(seed=seed))
    return tb.sampling.make(seed=seed), jb.sampling.make(seed=seed)


@pytest.mark.parametrize("kind,rate", [(None, None), ("simple", 0.6),
                                       ("density_adaptive", 0.7)])
@pytest.mark.parametrize("n,f,max_k,radius", [(1500, 24, 20, 0.3),
                                              (400, 6, 12, 0.05)])
def test_native_scan_matches_jax_numpy_scan(kind, rate, n, f, max_k, radius):
    rows = _clustered(n + f, n, f)
    tb, jb = _builders(kind, rate, 123)
    ts, js = _samplers(tb, jb, 123)
    c_t, a_t, s_t = native.native_incremental_clustering(
        tb, rows, f, max_k, radius, ts)
    c_j, a_j, s_j = jc._incremental_clustering_numpy(
        jb, rows, f, max_k, radius, js)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-12)
    assert a_t.tolist() == [-1 if a is None else a for a in a_j]
    assert s_t == s_j
    assert ts.get_stats() == js.get_stats()


def test_native_scan_matches_its_plain_version():
    """The port's own numpy scan is the native scan's plain version."""
    rows = _clustered(7, 2000, 16)
    tb, _ = _builders("simple", 0.6, 9)
    out_n = native.native_incremental_clustering(
        tb, rows, 16, 24, 0.2, tb.sampling.make(seed=9))
    out_p = tc._incremental_clustering_numpy(
        tb, rows, 16, 24, 0.2, tb.sampling.make(seed=9))
    np.testing.assert_allclose(out_n[0], out_p[0], rtol=1e-12)
    assert list(tc.Assignments(out_n[1])) == out_p[1]
    assert out_n[2] == out_p[2]


@pytest.mark.parametrize("kind,rate", [(None, None), ("simple", 0.6),
                                       ("density_adaptive", 0.7)])
def test_certified_scan_bitwise_equals_one_shot(kind, rate, monkeypatch):
    """30000 rows span several 8192-row blocks of the certified scan."""
    rng = np.random.default_rng(17)
    centres = rng.uniform(0, 1, (24, 32))
    n = 30_000
    x = np.ascontiguousarray(centres[rng.integers(0, 24, n)]
                             + rng.normal(0, 0.05, (n, 32)))

    def run(certified):
        tb, _ = _builders(kind, rate, 9)
        s = tb.sampling.make(seed=9) if tb.sampling is not None \
            else SamplerType.simple(1.0).make(seed=9)
        monkeypatch.setattr(native, "CERTIFIED_MIN_ROWS",
                            0 if certified else 10 ** 12)
        return native.native_incremental_clustering(tb, x, 32, 64, 0.3, s), \
            s.get_stats()

    (c1, a1, z1), st1 = run(False)
    (c2, a2, z2), st2 = run(True)
    assert np.array_equal(c1, c2)
    assert np.array_equal(a1, a2)
    assert z1 == z2 and st1 == st2


def test_seeded_build_takes_the_native_scan(monkeypatch):
    calls = []
    real = native.native_incremental_clustering

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(native, "native_incremental_clustering", counted)
    rows = _clustered(3, 600, 8)
    b = ArrowSpaceBuilder(device="cpu").with_seed(11) \
        .with_inline_sampling(None)
    cent, assign, sizes = tc.run_incremental_clustering_with_sampling(
        b, rows, 8, 10, 0.2, SamplerType.simple(1.0).make(seed=11))
    assert calls == [1]
    assert isinstance(assign, tc.Assignments) and len(assign) == 600
    assert sum(sizes) == sum(a is not None for a in assign)


def test_zero_clusters_raises():
    b = ArrowSpaceBuilder(device="cpu").with_seed(1) \
        .with_inline_sampling(SamplerType.simple(0.0))
    rows = _clustered(1, 20, 3)
    with pytest.raises(RuntimeError, match="No clusters created"):
        tc.run_incremental_clustering_with_sampling(
            b, rows, 3, 5, 1.0, b.sampling.make(seed=1))


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "clustering.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native clustering scan failed"):
        native.build()
