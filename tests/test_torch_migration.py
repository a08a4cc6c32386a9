"""The JAX package's names that the port adds for a caller moving from
``arrowspace_tpu`` to ``arrowspace_torch``, each against its JAX
counterpart on the same numpy inputs, on the CPU in float64:
ops.search's planes, masked top-k and hybrid components, the spectral
build, the staged eigenmaps pipeline with ClusteredOutput's sizes,
ArrowSpace.from_items, reduction.project_matrix,
laplacian.adjacency_from_knn, clustering.euclidean_dist and
nearest_centroid, the kernel modules' JAX names, and precompile.warm's λ
engine.

Tolerances: ids exact (ties to the lowest id), values within 1e-12
(float64, summed in another order), λ within 1e-10 as in
tests/test_torch_index.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu import clustering as jcl
from arrowspace_tpu import eigenmaps as jem
from arrowspace_tpu import laplacian as jlap
from arrowspace_tpu import reduction as jred
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.core import ArrowSpace as JSpace
from arrowspace_tpu.graph import GraphParams as JGraphParams
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.ops import pallas_taulambda as jtl
from arrowspace_tpu.ops import search as js
from arrowspace_tpu.taumode import TauMode as JTauMode
from arrowspace_torch import clustering as tcl
from arrowspace_torch import eigenmaps as tem
from arrowspace_torch import laplacian as tlap
from arrowspace_torch import ops as tops
from arrowspace_torch import precompile
from arrowspace_torch import reduction as tred
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowSpace, TAUDEFAULT
from arrowspace_torch.graph import GraphParams
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops import search as ts
from arrowspace_torch.ops import select_tau as tst
from arrowspace_torch.ops import taulambda as ttl
from arrowspace_torch.taumode import TauMode
from data import make_moons_hd
from helpers import oracle_adjacency

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-12


def _planes(n=300, f=12, b=4, seed=0):
    """Queries, λ and a corpus with an exact duplicate pair, a zero row
    and a row parallel to query 0."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, f))
    ql = rng.uniform(0, 1, b)
    x = rng.normal(size=(n, f))
    xl = rng.uniform(0, 1, n)
    x[41], xl[41] = x[40], xl[40]
    x[7] = 0.0
    x[99] = q[0] * 3.0
    q[1] = x[40] * 0.5
    ql[1] = xl[40]
    return q, ql, x, xl


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]


def _j(*a):
    return [jnp.asarray(v) for v in a]


def test_ops_reexports_what_jax_ops_does():
    import arrowspace_tpu.ops as jops
    for name in ("lambda_aware_scores", "batched_lambda_aware_topk",
                 "cosine_scores"):
        assert getattr(tops, name) is getattr(ts, name)
        assert hasattr(jops, name)


def test_cosine_scores_match_jax():
    q, _ql, x, _xl = _planes()
    got = ts.cosine_scores(*_t(q, x)).numpy()
    want = np.asarray(js.cosine_scores(*_j(q, x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got[:, 7] == 0.0).all()           # a zero row scores 0


@pytest.mark.parametrize("alpha", [1.0, 0.7, 0.0])
def test_lambda_aware_scores_match_jax(alpha):
    q, ql, x, xl = _planes(seed=1)
    got = ts.lambda_aware_scores(*_t(q, ql, x, xl), alpha).numpy()
    want = np.asarray(js.lambda_aware_scores(*_j(q, ql, x, xl),
                                             jnp.float64(alpha)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    plane, c1 = ts.shifted_lambda_plane(*_t(q, ql, x, xl), alpha)
    np.testing.assert_array_equal(got, (plane + c1).numpy())


@pytest.mark.parametrize("n_live", [300, 200, 41, 5])
def test_masked_topk_matches_jax(n_live):
    q, ql, x, xl = _planes(seed=2)
    x[250:] = np.nan                          # stale rows past n_live
    k = 10
    gs, gi = ts.masked_lambda_aware_topk(*_t(q, ql, x, xl), 0.8,
                                         n_live if n_live < 250 else 250,
                                         k=k)
    ws, wi = js.masked_lambda_aware_topk(
        *_j(q, ql, x, xl), jnp.float64(0.8),
        jnp.int32(n_live if n_live < 250 else 250), k=k)
    live = min(n_live, 250)
    valid = np.asarray(ws) > -np.inf
    assert valid.sum(axis=1).tolist() == [min(k, live)] * q.shape[0]
    np.testing.assert_array_equal(gi.numpy()[valid], np.asarray(wi)[valid])
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=TOL)
    assert (gi.numpy()[valid] < live).all()
    if live > 41:                              # the duplicate pair, in order
        row = gi[1].tolist()
        assert row.index(40) + 1 == row.index(41)
    # a full live count is the plain scan
    if n_live == 300:
        x2 = x.copy()
        x2[250:] = x2[:50]
        a = ts.masked_lambda_aware_topk(*_t(q, ql, x2, xl), 0.8, 300, k=k)
        b = ts.batched_lambda_aware_topk(*_t(q, ql, x2, xl), 0.8, k=k)
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize("alpha", [0.9, 0.5])
def test_hybrid_components_match_jax(alpha):
    q, ql, x, xl = _planes(seed=3)
    k = 8
    got = ts.hybrid_search_device(torch.from_numpy(q[0]), float(ql[0]),
                                  *_t(x, xl), alpha, k=k)
    want = js.hybrid_search_device(jnp.asarray(q[0]), jnp.float64(ql[0]),
                                   *_j(x, xl), jnp.float64(alpha), k=k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=TOL)
    assert int(got[2]) == int(want[2]) == 99
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    # the fused union is built from the same components
    fs, fi = ts.hybrid_search_device_fused(torch.from_numpy(q[0]),
                                           float(ql[0]), *_t(x, xl), alpha,
                                           k=k)
    ws, wi = js.hybrid_search_device_fused(
        jnp.asarray(q[0]), jnp.float64(ql[0]), *_j(x, xl),
        jnp.float64(alpha), k=k)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(wi))


def test_pallas_binned_topk_with_repair_is_the_repaired_k1():
    from arrowspace_tpu.ops.search import pallas_binned_topk_with_repair
    q, ql, x, xl = [a.astype(np.float32) for a in _planes(n=3000, seed=4)]
    x[7] = 0.5
    gs, gi = ts.pallas_binned_topk_with_repair(*_t(q, ql, x, xl), 0.9, 10)
    ws, wi = pallas_binned_topk_with_repair(*_j(q, ql, x, xl), 0.9, 10,
                                            interpret=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
    bs, bi = ts.binned_topk_with_repair(*_t(q, ql, x, xl), 0.9, k=10)
    np.testing.assert_array_equal(gi.numpy(), bi.numpy())


@pytest.fixture(scope="module")
def spectral_pair():
    rng = np.random.default_rng(9)
    c = rng.uniform(0.2, 0.8, (8, 20))
    rows = c[rng.integers(0, 8, 1500)] + rng.normal(0, 0.05, (1500, 20))
    j = JIndex.build(rows, eps=1.0, seed=11, spectral=True)
    t = ArrowIndex.build(rows, eps=1.0, seed=11, spectral=True, **CPU64)
    return rows, j, t


def test_spectral_build_matches_jax_and_the_builder_route(spectral_pair):
    rows, j, t = spectral_pair
    assert t.builder.prebuilt_spectral and t.aspace.signals is not None
    np.testing.assert_allclose(t.aspace.signals.numpy(),
                               np.asarray(j.aspace.signals), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(t.lambdas, np.asarray(j.lambdas), rtol=1e-10,
                               atol=1e-12)
    # the same index as the builder with with_spectral(True)
    aspace, gl = (ArrowSpaceBuilder(**CPU64).with_lambda_graph(
        1.0, 6, 3, 2.0, None).with_spectral(True).with_seed(11)
        .build(rows))
    np.testing.assert_array_equal(t.lambdas, aspace.lambdas.numpy())
    q = rows[[3, 900]] * 1.02
    ts_, ti = t.search(q, k=6, alpha=0.8)
    js_, ji = j.search(q, k=6, alpha=0.8)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    plain = ArrowIndex.build(rows, eps=1.0, seed=11, **CPU64)
    assert plain.aspace.signals is None
    assert not np.allclose(plain.lambdas, t.lambdas)


def test_staged_pipeline_as_the_jax_suite_writes_it():
    """tests/test_eigenmaps.py:27-29 on the port, ClusteredOutput's
    n_items and n_features included, against the JAX stages."""
    rows = make_moons_hd(90, noise=0.08, hd_noise=0.05, dims=14, seed=6)
    out = {}
    for name, em, b in (
            ("jax", jem, JBuilder().with_lambda_graph(
                1.0, 5, 3, 2.0, None).with_seed(77)),
            ("torch", tem, ArrowSpaceBuilder(**CPU64).with_lambda_graph(
                1.0, 5, 3, 2.0, None).with_seed(77))):
        b.define_result_k()
        clustered = em.start_clustering(b, rows.tolist())
        aspace = clustered.aspace
        gl = em.eigenmaps(aspace, b, clustered.centroids, clustered.n_items)
        em.compute_taumode(aspace, gl)
        assert (clustered.n_items, clustered.n_features) == (90, 14)
        lam = aspace.lambdas
        out[name] = (np.asarray(lam.numpy() if torch.is_tensor(lam)
                                else lam), clustered.reduced_dim)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=1e-10,
                               atol=1e-12)
    assert out["torch"][1] == out["jax"][1] == 14
    mono, _gl = ArrowSpaceBuilder(**CPU64).with_lambda_graph(
        1.0, 5, 3, 2.0, None).with_seed(77).build(rows.tolist())
    np.testing.assert_allclose(out["torch"][0], mono.lambdas.numpy(),
                               rtol=1e-12, atol=0)


def test_from_items_aliases():
    rows = np.random.default_rng(0).normal(size=(5, 3))
    assert ArrowSpace.from_items is ArrowSpace.new
    a = ArrowSpace.from_items(rows, device="cpu", dtype=torch.float64)
    b = ArrowSpace.from_items_default(rows, device="cpu",
                                      dtype=torch.float64)
    c = JSpace.from_items_default(rows)
    assert b.taumode == TAUDEFAULT and str(b.taumode) == str(c.taumode)
    np.testing.assert_array_equal(a.data.numpy(), rows)
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(c.data))


@pytest.mark.parametrize("f,r", [(40, 12), (96, 48)])
def test_project_matrix_matches_jax(f, r):
    rows = np.random.default_rng(f).normal(size=(50, f))
    jp = jred.ImplicitProjection(f, r, seed=5)
    tp = tred.ImplicitProjection.from_matrix(np.asarray(jp.matrix()))
    want = np.asarray(jred.project_matrix(jnp.asarray(rows), jp))
    got = tred.project_matrix(rows, tp, **CPU64)
    assert got.shape == (50, r) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # a tensor keeps its own device and dtype
    got32 = tred.project_matrix(torch.from_numpy(rows).float(), tp)
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("eps,topk,sigma", [(0.5, 3, None), (1.0, 5, 0.4),
                                            (0.05, 2, None)])
def test_adjacency_from_knn_matches_jax_and_the_oracle(eps, topk, sigma):
    rows = make_moons_hd(40, noise=0.1, hd_noise=0.05, dims=6, seed=2)
    jp = JGraphParams(eps=eps, k=topk, topk=topk, p=2.0, sigma=sigma,
                      normalise=False, sparsity_check=False)
    tp = GraphParams(eps=eps, k=topk, topk=topk, p=2.0, sigma=sigma,
                     normalise=False, sparsity_check=False)
    want = np.asarray(jlap.adjacency_from_knn(jnp.asarray(rows), jp))
    got = tlap.adjacency_from_knn(rows, tp, **CPU64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               oracle_adjacency(rows, eps, topk, 2.0, sigma),
                               rtol=0, atol=TOL)
    # the Laplacian the port builds is D - A of the same adjacency
    lap = tlap.build_laplacian_matrix(rows, tp, **CPU64).matrix.numpy()
    adj = got.numpy()
    np.testing.assert_allclose(lap, np.diag(adj.sum(axis=1)) - adj,
                               rtol=0, atol=TOL)


def test_euclidean_dist_and_nearest_centroid_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=7), rng.normal(size=7)
    assert tcl.euclidean_dist(a, b) == jcl.euclidean_dist(a, b)
    cents = rng.normal(size=(9, 7))
    cents[5] = cents[2]                       # equal distances: the first
    for row in (rng.normal(size=7), cents[2] + 1e-3, cents[5]):
        assert tcl.nearest_centroid(row, cents) == \
            jcl.nearest_centroid(row, cents)
    assert tcl.nearest_centroid(cents[5], cents)[0] == 2


def test_kernel_modules_export_the_jax_names():
    rng = np.random.default_rng(2)
    x = rng.uniform(0.1, 1.0, (64, 16)).astype(np.float32)
    adj = oracle_adjacency(x[:16].T.copy(), 1.0, 3, 2.0, None)
    lap = (np.diag(adj.sum(axis=1)) - adj).astype(np.float32)
    assert tst.fused_select_tau_fits is tst.select_tau_fits
    assert ttl.fused_taulambda_fits(64, 16, 16) == \
        ttl.taulambda_fits(16, 16)
    assert not ttl.fused_taulambda_fits(64, 300, 8)
    for kind, pct, fixed, mode in (
            ("median", 0.5, 0.0, TauMode.median()),
            ("percentile", 0.25, 0.0, TauMode.percentile(0.25)),
            ("fixed", 0.5, 0.3, TauMode.fixed(0.3))):
        got = ttl.fused_taulambda_batch(torch.from_numpy(x),
                                        torch.from_numpy(lap), kind=kind,
                                        pct=pct, fixed=fixed)
        want = np.asarray(jtl.fused_taulambda_batch(
            jnp.asarray(x), jnp.asarray(lap), kind=kind, pct=pct,
            fixed=fixed, interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(
            got.numpy(), ttl.fused_taulambda(torch.from_numpy(x),
                                              torch.from_numpy(lap),
                                              mode)[0].numpy())
    tau = tst.fused_select_tau(torch.from_numpy(x), kind="percentile",
                               pct=0.25)
    np.testing.assert_array_equal(
        tau.numpy(),
        tst.fused_select_tau(torch.from_numpy(x),
                             TauMode.percentile(0.25)).numpy())


def test_warm_launches_the_build_lambda_engine(monkeypatch):
    """warm(taumode=, graph_nodes=) runs one window of the build's λ pass
    (compute_taumode_lambdas), whose gates pick K2 or K4 + K5."""
    from arrowspace_torch import taumode as ttm
    seen = []
    orig = ttm.compute_taumode_lambdas

    def spy(items, lap, mode, **kw):
        seen.append((tuple(items.shape), tuple(lap.shape), mode))
        return orig(items, lap, mode, **kw)
    monkeypatch.setattr(ttm, "compute_taumode_lambdas", spy)
    t1 = precompile.warm(3000, 12, batch_sizes=(4,), device="cpu",
                         taumode=TauMode.percentile(0.3))
    t2 = precompile.warm(3000, 64, batch_sizes=(4,), device="cpu",
                         graph_nodes=16)
    t3 = precompile.warm(3000, 12, batch_sizes=(4,), device="cpu")
    assert t1["lambda_build"] >= 0 and t2["lambda_build"] >= 0
    assert "lambda_build" not in t3
    assert seen == [((3000, 12), (12, 12), TauMode.percentile(0.3)),
                    ((3000, 64), (16, 16), TauMode.median())]
    assert precompile._window_rows(10 ** 7, 128, 4) < 10 ** 7
    assert JTauMode.median().kind == TauMode.median().kind
