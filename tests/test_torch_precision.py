"""tests/test_precision.py (the float32 budgets against float64, the
f64_rescore path, and the duplicate-row tie order of single-query
scoring) run in both packages: each case once on ``arrowspace_tpu`` and
once on ``arrowspace_torch`` (CPU), on the same numpy inputs.

The JAX package's two cases on its TPU query pad (_pad_query_rows) run
as they are; the port has no pad (its CPU plane is a product-sum that
reduces every corpus row alike, ops/search.dot_plane), so its
counterpart holds a single query's plane equal to that query's row of a
batch plane, bitwise.

Budgets, as the JAX suite's: float32 λ within 1e-6 median, 1e-5 at the
99.9th percentile and 1e-4 at most of float64's, relatively; float32
top-10 overlap with float64 at least 0.95; f64_rescore ids exact."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu import taumode as jtm
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.ops import search as js
from arrowspace_torch import taumode as ttm
from arrowspace_torch.index import ArrowIndex as TIndex
from arrowspace_torch.ops import search as ts
from helpers import oracle_adjacency, oracle_laplacian


def _jax_lambdas(rows, lap, dt):
    d = {np.float64: jnp.float64, np.float32: jnp.float32}[dt]
    return np.asarray(jtm.compute_taumode_lambdas(
        jnp.asarray(rows, d), jnp.asarray(lap, d), jtm.TauMode.median()))


def _torch_lambdas(rows, lap, dt):
    d = {np.float64: torch.float64, np.float32: torch.float32}[dt]
    return ttm.compute_taumode_lambdas(
        torch.tensor(rows, dtype=d), torch.tensor(lap, dtype=d),
        ttm.TauMode.median()).numpy()


def _jax_topk(q, ql, x, xl, alpha, k, dt):
    d = {np.float64: jnp.float64, np.float32: jnp.float32}[dt]
    s, i = js.batched_lambda_aware_topk(
        jnp.asarray(q, d), jnp.asarray(ql, d), jnp.asarray(x, d),
        jnp.asarray(xl, d), jnp.asarray(alpha, d), k=k)
    return np.asarray(s), np.asarray(i)


def _torch_topk(q, ql, x, xl, alpha, k, dt):
    d = {np.float64: torch.float64, np.float32: torch.float32}[dt]
    s, i = ts.batched_lambda_aware_topk(
        *(torch.tensor(np.asarray(a), dtype=d) for a in (q, ql, x, xl)),
        alpha, k=k)
    return s.numpy(), i.numpy()


PKGS = {
    "jax": types.SimpleNamespace(lambdas=_jax_lambdas, topk=_jax_topk,
                                 rescore=js.rescore_topk_f64, Index=JIndex,
                                 kw={}),
    "torch": types.SimpleNamespace(lambdas=_torch_lambdas, topk=_torch_topk,
                                   rescore=ts.rescore_topk_f64, Index=TIndex,
                                   kw=dict(device="cpu",
                                           dtype=torch.float64)),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_f32_lambda_within_budget(pkg):
    rng = np.random.default_rng(0)
    n_items, f = 5000, 96
    centers = rng.uniform(0.2, 0.8, (8, f))
    rows = centers[rng.integers(0, 8, n_items)] \
        + rng.normal(0, 0.05, (n_items, f))
    adj = oracle_adjacency(rows[:64][:, :32], eps=1.0, topk=5, p=2.0,
                           sigma=None)
    lap = oracle_laplacian(adj)
    lam64 = pkg.lambdas(rows, lap, np.float64)
    lam32 = pkg.lambdas(rows, lap, np.float32)
    rel = np.abs(lam32.astype(np.float64) - lam64) / (np.abs(lam64) + 1e-12)
    assert np.median(rel) < 1e-6
    assert np.quantile(rel, 0.999) < 1e-5, float(np.quantile(rel, 0.999))
    assert rel.max() < 1e-4, float(rel.max())
    if pkg is PKGS["torch"]:
        np.testing.assert_allclose(lam64, _jax_lambdas(rows, lap, np.float64),
                                   rtol=1e-10, atol=1e-12)


def test_f32_search_ranking_stable(pkg):
    rng = np.random.default_rng(1)
    n, f, b = 20000, 64, 16
    items = rng.uniform(0.1, 1.0, (n, f))
    lams = rng.uniform(0, 1, n)
    q, qlam = items[:b] * 1.01, lams[:b]
    _, i64 = pkg.topk(q, qlam, items, lams, 0.9, 10, np.float64)
    _, i32 = pkg.topk(q, qlam, items, lams, 0.9, 10, np.float32)
    overlap = np.mean([len(set(i64[r]) & set(i32[r])) / 10.0
                       for r in range(b)])
    assert overlap >= 0.95, overlap
    if pkg is PKGS["torch"]:
        np.testing.assert_array_equal(
            i64, _jax_topk(q, qlam, items, lams, 0.9, 10, np.float64)[1])


def _near_tie_corpus(n_ties=15, n_fill=500, f=64, seed=4):
    """Top cosines ~1e-9 apart: below float32 resolution, ordered in
    float64."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=f)
    base /= np.linalg.norm(base)
    orth = rng.normal(size=f)
    orth -= (orth @ base) * base
    orth /= np.linalg.norm(orth)
    ties = []
    for i in range(n_ties):
        v = base + 1e-4 * np.sqrt(i + 1.0) * orth
        ties.append(v / np.linalg.norm(v))
    fillers = rng.normal(size=(n_fill, f))
    fillers /= np.linalg.norm(fillers, axis=1, keepdims=True)
    return base, np.concatenate([np.asarray(ties), 0.2 * fillers
                                 + 0.1 * base])


def test_f64_rescore_recovers_exact_ties(pkg):
    q, items = _near_tie_corpus()
    lams = np.full(items.shape[0], 0.5)
    qlam = np.asarray([0.5])
    k, m = 10, 42
    _, i64 = pkg.topk(q[None, :], qlam, items, lams, 1.0, k, np.float64)
    want = list(i64[0])
    assert want == list(range(k))
    _, cand32 = pkg.topk(q[None, :], qlam, items, lams, 1.0, m, np.float32)
    s_r, i_r = pkg.rescore(q[None, :], qlam, items, lams, 1.0, cand32, k)
    assert list(i_r[0]) == want
    assert list(s_r[0]) == sorted(s_r[0], reverse=True)


def test_f64_rescore_matches_plain_topk_away_from_ties(pkg):
    rng = np.random.default_rng(7)
    items = rng.uniform(0.1, 1.0, (5000, 32))
    lams = rng.uniform(0, 1, 5000)
    q, qlam = items[:4] * 1.02, lams[:4]
    _, i64 = pkg.topk(q, qlam, items, lams, 0.9, 40, np.float64)
    _s_r, i_r = pkg.rescore(q, qlam, items, lams, 0.9, i64, 10)
    np.testing.assert_array_equal(i_r, i64[:, :10])


def test_index_f64_rescore_api(pkg):
    q, items = _near_tie_corpus(seed=9)
    idx = pkg.Index.build(items.tolist(), eps=1.0, k=5, seed=3, **pkg.kw)
    _s1, i1 = idx.search(q, k=10, alpha=1.0, precision="f64_rescore")
    cos = items @ q / np.linalg.norm(items, axis=1)
    np.testing.assert_array_equal(i1[0], np.argsort(-cos, kind="stable")[:10])


def _dup_pair():
    rng = np.random.default_rng(11)
    items = rng.normal(size=(40, 384))
    items[27] = items[3]          # an exact duplicate pair, far apart in N
    lams = rng.uniform(0, 1, 40)
    lams[27] = lams[3]
    return items[3:4] * 1.02, lams[3:4], items, lams


def test_single_query_duplicate_tie_order_cpu_jax():
    """The JAX case as it is: no TPU pad on the CPU, the matvec ties the
    duplicate pair bitwise and lax.top_k orders it lowest id first."""
    assert jax.default_backend() == "cpu"
    assert js._pad_query_rows(1) == 0
    q, ql, items, lams = _dup_pair()
    s, _c1 = js._shifted_lambda_plane(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(items),
        jnp.asarray(lams), jnp.float64(0.9))
    s = np.asarray(s)
    assert s[0, 3] == s[0, 27]
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray(s), 2)[1][0]), [3, 27])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_query_duplicate_tie_order_cpu_torch(dtype):
    """The port's plane (a product-sum on the CPU) ties the duplicate
    pair bitwise at B=1, and exact_topk orders it lowest id first, as
    the JAX package's lax.top_k does."""
    q, ql, items, lams = (torch.tensor(a, dtype=dtype) for a in _dup_pair())
    s, _c1 = ts.shifted_lambda_plane(q, ql, items, lams, 0.9)
    assert s.shape == (1, 40)
    assert s[0, 3] == s[0, 27]
    assert ts.exact_topk(s, 2)[1][0].tolist() == [3, 27]


def test_pad_skipped_under_default_device_cpu_jax(monkeypatch):
    """The JAX case as it is: its pad keys on the device override."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert js._pad_query_rows(1) == 15
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        assert js._pad_query_rows(1) == 0


def test_forced_query_pad_slices_back_jax(monkeypatch):
    rng = np.random.default_rng(13)
    items = rng.normal(size=(64, 48))
    lams = rng.uniform(0, 1, 64)
    args = (jnp.asarray(items[:3] * 1.02), jnp.asarray(lams[:3]),
            jnp.asarray(items), jnp.asarray(lams), jnp.float64(0.8))
    s0, c0 = js._shifted_lambda_plane(*args)
    monkeypatch.setattr(js, "_pad_query_rows", lambda b: max(0, 16 - b))
    s1, c1 = js._shifted_lambda_plane(*args)
    assert s1.shape == s0.shape == (3, 64) and float(c0) == float(c1)
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=1e-12)


def test_single_query_plane_is_its_batch_row_torch():
    """The port needs no pad: a query's plane alone equals its row of a
    batch plane bitwise, so B=1 and a batch rank alike."""
    rng = np.random.default_rng(13)
    items = torch.tensor(rng.normal(size=(64, 48)))
    lams = torch.tensor(rng.uniform(0, 1, 64))
    q = items[:3] * 1.02
    s_all, c_all = ts.shifted_lambda_plane(q, lams[:3], items, lams, 0.8)
    for b in range(3):
        s_one, c_one = ts.shifted_lambda_plane(q[b:b + 1], lams[b:b + 1],
                                               items, lams, 0.8)
        assert c_one == c_all
        assert torch.equal(s_one[0], s_all[b])
