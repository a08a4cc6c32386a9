"""tests/test_querying.py (the query path, mirroring
tests/test_querying_proj.rs:30-723 of the reference, and the α=1 ≡
brute-cosine anchor) run in both packages: each case once on
``arrowspace_tpu`` and once on ``arrowspace_torch`` (CPU, float64) on
the same numpy inputs, and the two packages' rankings against each
other where the builds are deterministic.

Tolerances: ids exact; λ across packages within 1e-10, scores within
1e-9 relative (float64, summed in another order)."""

import types

import numpy as np
import pytest
import torch

from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.core import ArrowItem as JItem
from arrowspace_torch.builder import ArrowSpaceBuilder as TBuilder
from arrowspace_torch.core import ArrowItem as TItem
from data import make_gaussian_hd, make_moons_hd, protein_like_block
from helpers import cosine_topk


def _jax_hybrid(q, qlam, aspace, alpha, k):
    import jax.numpy as jnp
    from arrowspace_tpu.ops.search import hybrid_search_device
    dt = aspace.data.dtype
    out = hybrid_search_device(
        jnp.asarray(q, dtype=dt), jnp.asarray(qlam, dtype=dt), aspace.data,
        aspace.lambdas, jnp.asarray(alpha, dtype=dt), k=k)
    return [np.asarray(v) for v in out]


def _torch_hybrid(q, qlam, aspace, alpha, k):
    from arrowspace_torch.ops.search import hybrid_search_device
    out = hybrid_search_device(torch.from_numpy(np.asarray(q)), qlam,
                               aspace.data, aspace.lambdas, alpha, k=k)
    return [v.numpy() for v in out]


PKGS = {
    "jax": types.SimpleNamespace(Builder=JBuilder, ArrowItem=JItem,
                                 hybrid=_jax_hybrid),
    "torch": types.SimpleNamespace(
        Builder=lambda: TBuilder(device="cpu", dtype=torch.float64),
        ArrowItem=TItem, hybrid=_torch_hybrid),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _build(pkg, rows, **kw):
    b = (pkg.Builder()
         .with_lambda_graph(kw.get("eps", 1.0), kw.get("k", 5),
                            kw.get("topk", 3), 2.0, kw.get("sigma"))
         .with_seed(kw.get("seed", 42)))
    if kw.get("normalise"):
        b = b.with_normalisation(True)
    if kw.get("dims_reduction"):
        b = b.with_dims_reduction(True, kw.get("rp_eps", 1.0))
    return b.build(rows.tolist() if hasattr(rows, "tolist") else rows)


def test_query_without_projection(pkg):
    data = make_gaussian_hd(117, spread=0.6, dims=32, seed=1)
    train, queries = data[:99], data[99:]
    aspace, gl = _build(pkg, train, normalise=True)
    qlam = aspace.prepare_query_item(queries[0], gl)
    assert np.isfinite(qlam)
    res = aspace.search_lambda_aware(pkg.ArrowItem(queries[0], qlam), 5, 0.7)
    assert len(res) == 5
    scores = [s for _, s in res]
    assert scores == sorted(scores, reverse=True)


def test_query_with_projection_enabled(pkg):
    data = make_gaussian_hd(117, spread=0.6, dims=96, seed=2)
    train, queries = data[:99], data[99:]
    aspace, gl = _build(pkg, train, dims_reduction=True)
    assert aspace.projection_matrix is not None
    assert aspace.reduced_dim is not None
    q = queries[1]
    qproj = aspace.project_query(q)
    assert qproj.shape[0] == aspace.reduced_dim
    qlam = aspace.prepare_query_item(q, gl)
    assert np.isfinite(qlam)
    # search uses the ORIGINAL query vs raw F-dim items (reference test:
    # test_query_with_projection_enabled builds ArrowItem(query_original,..))
    res = aspace.search_lambda_aware(pkg.ArrowItem(q, qlam), 5, 0.7)
    assert len(res) == 5


def test_alpha_one_equals_brute_cosine(pkg):
    """alpha=1.0 must return exactly the brute-force cosine top-k
    (index_compute_bench.rs:174-178; paper.md:123-143)."""
    db = protein_like_block()
    query = db[3] * 1.02
    aspace, gl = _build(pkg, db, eps=1e-3, k=20, topk=3, sigma=0.00075,
                        dims_reduction=True)
    qlam = aspace.prepare_query_item(query, gl)
    res = aspace.search_lambda_aware(pkg.ArrowItem(query, qlam), 4, 1.0)
    arrow_ids = [i for i, _ in res]
    oracle_ids, _ = cosine_topk(query, db, 4)
    assert arrow_ids == list(oracle_ids)


def test_alpha_sweep_monotone_mixing(pkg):
    data = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=3)
    q = data[10] * 1.05
    aspace, gl = _build(pkg, data)
    qlam = aspace.prepare_query_item(q, gl)
    item = pkg.ArrowItem(q, qlam)
    res_high = aspace.search_lambda_aware(item, 5, 0.9)
    res_low = aspace.search_lambda_aware(item, 5, 0.1)
    assert len(res_high) == len(res_low) == 5
    # both well-ordered
    for res in (res_high, res_low):
        scores = [s for _, s in res]
        assert scores == sorted(scores, reverse=True)


def test_search_requires_prepared_lambda(pkg):
    data = make_moons_hd(40, noise=0.1, hd_noise=0.05, dims=8, seed=4)
    aspace, gl = _build(pkg, data)
    with pytest.raises(AssertionError, match="prepare the item"):
        aspace.search_lambda_aware(pkg.ArrowItem(data[0], 0.0), 3, 0.7)


def test_nan_query_raises(pkg):
    data = make_moons_hd(40, noise=0.1, hd_noise=0.05, dims=8, seed=5)
    aspace, gl = _build(pkg, data)
    q = data[0].copy()
    q[3] = np.nan
    with pytest.raises(AssertionError, match="finite"):
        aspace.prepare_query_item(q, gl)


def test_search_returns_exactly_k(pkg):
    data = make_moons_hd(30, noise=0.1, hd_noise=0.05, dims=8, seed=6)
    aspace, gl = _build(pkg, data)
    q = data[2]
    qlam = aspace.prepare_query_item(q, gl)
    item = pkg.ArrowItem(q, qlam)
    for k in (1, 3, 10, 30):
        assert len(aspace.search_lambda_aware(item, k, 0.5)) == min(k, 30)
    # k beyond N clamps to N
    assert len(aspace.search_lambda_aware(item, 100, 0.5)) == 30


def test_hybrid_search_contains_semantic_top1(pkg):
    data = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=7)
    q = data[25] * 1.01
    aspace, gl = _build(pkg, data)
    qlam = aspace.prepare_query_item(q, gl)
    item = pkg.ArrowItem(q, qlam)
    res = aspace.search_lambda_aware_hybrid(item, 10, 0.7)
    ids = [i for i, _ in res]
    oracle_ids, _ = cosine_topk(q, data, 1)
    assert oracle_ids[0] in ids
    assert len(res) <= 10
    scores = [s for _, s in res]
    assert scores == sorted(scores, reverse=True)
    # k=0 -> empty
    assert aspace.search_lambda_aware_hybrid(item, 0, 0.7) == []


def test_range_search_signed_band(pkg):
    """range_search keeps the reference's signed one-sided test
    query.λ - item.λ <= eps (core.rs:961-968)."""
    data = make_moons_hd(50, noise=0.1, hd_noise=0.05, dims=8, seed=8)
    aspace, gl = _build(pkg, data)
    q = data[7]
    qlam = aspace.prepare_query_item(q, gl)
    res = aspace.range_search(pkg.ArrowItem(q, qlam), gl, 0.05)
    lam = np.asarray(aspace.lambdas)
    expected = {i for i in range(50) if qlam - lam[i] <= 0.05}
    assert {i for i, _ in res} == expected
    # auto-prepares when query lambda ~ 0
    res2 = aspace.range_search(pkg.ArrowItem(q, 0.0), gl, 0.05)
    assert {i for i, _ in res2} == expected


def test_batched_search_matches_single(pkg):
    data = make_moons_hd(64, noise=0.1, hd_noise=0.05, dims=12, seed=9)
    aspace, gl = _build(pkg, data)
    queries = data[:8] * 1.03
    qlams = np.array([aspace.prepare_query_item(q, gl) for q in queries])
    scores, idx = aspace.search_lambda_aware_batch(queries, qlams, 5, 0.8)
    for b in range(8):
        single = aspace.search_lambda_aware(
            pkg.ArrowItem(queries[b], qlams[b]), 5, 0.8)
        assert [i for i, _ in single] == list(np.asarray(idx[b]))


def test_prepare_query_items_batch_matches_single(pkg):
    data = make_moons_hd(50, noise=0.1, hd_noise=0.05, dims=10, seed=11)
    aspace, gl = _build(pkg, data)
    queries = data[:6] * 1.05
    batch = np.asarray(aspace.prepare_query_items_batch(queries, gl))
    for i, q in enumerate(queries):
        assert batch[i] == pytest.approx(aspace.prepare_query_item(q, gl),
                                         rel=1e-12)
    # NaN queries rejected
    bad = queries.copy()
    bad[2, 0] = np.nan
    with pytest.raises(AssertionError, match="finite"):
        aspace.prepare_query_items_batch(bad, gl)


def test_range_search_sorted_band(pkg):
    """ZSET-style two-sided band: O(log N + M) sorted-lambda lookup
    (paper.md:147; examples/02)."""
    data = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=12)
    aspace, gl = _build(pkg, data)
    lam = np.asarray(aspace.lambdas)
    lo, hi = np.quantile(lam, 0.25), np.quantile(lam, 0.75)
    hits = aspace.range_search_sorted(lo, hi)
    expected = {i for i in range(60) if lo <= lam[i] <= hi}
    assert {i for i, _ in hits} == expected
    # ascending by lambda
    vals = [v for _, v in hits]
    assert vals == sorted(vals)
    # limit applies
    assert len(aspace.range_search_sorted(lo, hi, limit=3)) == 3
    # cache invalidation on lambda update
    aspace.update_lambdas(np.zeros(60))
    assert len(aspace.range_search_sorted(-0.1, 0.1)) == 60


def test_hybrid_fused_matches_host_union_oracle(pkg):
    """The device-side hybrid union must reproduce the host dict-union
    semantics (high-cos keeps cosine score and beats λ-top-k membership,
    which beats the semantic top-1; sorted desc, truncated k) — forced
    high-cosine duplicates included."""
    data = make_moons_hd(80, noise=0.1, hd_noise=0.05, dims=12, seed=17)
    # two exact duplicates of the query direction -> high-cos set
    data[40] = data[3] * 2.0
    data[61] = data[3] * 0.5
    aspace, gl = _build(pkg, data)
    q = data[3]
    qlam = aspace.prepare_query_item(q, gl)
    item = pkg.ArrowItem(q, qlam)
    k = 10
    res = aspace.search_lambda_aware_hybrid(item, k, 0.7)

    # host oracle from the raw components (the round-2 implementation)
    top_scores, top_idx, sem_idx, cos, high_mask = pkg.hybrid(
        q, qlam, aspace, 0.7, k)
    score_map = {}
    cos_np = np.asarray(cos)
    for i in np.nonzero(np.asarray(high_mask))[0]:
        score_map[int(i)] = float(cos_np[i])
    for i, s in zip(np.asarray(top_idx), np.asarray(top_scores)):
        score_map.setdefault(int(i), float(s))
    score_map.setdefault(int(sem_idx), float(cos_np[int(sem_idx)]))
    oracle = sorted(score_map.items(), key=lambda t: -t[1])[:k]

    assert {i for i, _ in res} == {i for i, _ in oracle}
    for (i1, s1), (i2, s2) in zip(res, oracle):
        assert s1 == pytest.approx(s2, rel=1e-9)
    # high-cos duplicates surface with their cosine scores
    got = dict(res)
    assert 40 in got and 61 in got
    assert got[40] == pytest.approx(1.0, abs=1e-6)


def test_search_one_delegates_to_batched_engine(pkg, monkeypatch):
    """search_lambda_aware must route through search_lambda_aware_batch
    so BOTH single-query APIs share one engine selection (small-scan
    gate included): it previously dispatched straight to the device and
    could disagree with a B=1 batched search on near-ties at sub-gate
    corpus sizes (measured on chip, r4)."""
    data = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=10, seed=13)
    aspace, gl = _build(pkg, data)
    q = data[5] * 1.02
    qlam = aspace.prepare_query_item(q, gl)

    calls = []
    orig = aspace.search_lambda_aware_batch

    def spy(queries, qlams, k, alpha, **kw):
        calls.append(np.shape(queries))
        return orig(queries, qlams, k, alpha, **kw)

    monkeypatch.setattr(aspace, "search_lambda_aware_batch", spy)
    res = aspace.search_lambda_aware(pkg.ArrowItem(q, qlam), 5, 0.8)
    assert calls == [(1, 10)]
    s, i = orig(q[None, :], np.asarray([qlam]), 5, 0.8)
    assert [(j, v) for j, v in res] == \
        [(int(j), float(v)) for j, v in zip(np.asarray(i[0]),
                                            np.asarray(s[0]))]


@pytest.mark.parametrize("alpha", [1.0, 0.9, 0.5])
def test_the_packages_rank_alike(alpha):
    """One moons build in each package: λ, the prepared query λ, the
    single, batched and hybrid rankings equal across packages."""
    data = make_moons_hd(64, noise=0.1, hd_noise=0.05, dims=12, seed=9)
    out = {}
    for name, pkg in PKGS.items():
        aspace, gl = _build(pkg, data)
        queries = data[:6] * 1.03
        qlams = np.array([aspace.prepare_query_item(q, gl) for q in queries])
        _s, idx = aspace.search_lambda_aware_batch(queries, qlams, 7, alpha)
        hyb = aspace.search_lambda_aware_hybrid(
            pkg.ArrowItem(queries[0], qlams[0]), 7, alpha)
        out[name] = (np.asarray(aspace.lambdas), qlams, np.asarray(idx),
                     [i for i, _ in hyb])
    j, t = out["jax"], out["torch"]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(t[2], j[2])
    assert t[3] == j[3]
