"""K5's plain version (ops/lambda_batch.py) and the JL-projected canonical
build that reaches it, against the JAX package, on the CPU.

- ``lambda_batch_plain`` in float32 against the JAX Pallas kernel
  ``fused_lambda_batch`` run in interpret mode (tile=256), within 1e-5
  relative (float32 products summed in another order); in float64
  against JAX ``synthetic_lambda_batch`` within 1e-10.  Inputs include
  all-zero rows, rows whose graph coordinates are all 0 (S = 0) and a
  row count that is not a multiple of the tile.
- The routing: a float32 batch whose rows are wider than K2's gate
  (F = 300 > 256) over a graph at most half as wide takes K4's and K5's
  wrappers (their plain versions here) and never K2's, in each 2 GiB-style
  window, and its λ equals JAX ``compute_taumode_lambdas``.
- The slice: a seeded float32 build with dims reduction (F = 320, so the
  JL graph has 2n <= F and K2's gate fails) against the JAX build with
  the same projection: the same clusters, item and query λ within 1e-5
  of the float64 JAX build (float32 projection, Laplacian and λ; the
  errors seen are below 2e-7), and session ids equal to the plain full
  scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowspace_tpu import taumode as jtm
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.ops.pallas_lambda import fused_lambda_batch as j_k5
from arrowspace_torch import eigenmaps, native
from arrowspace_torch import taumode as ttm
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops import lambda_batch as lb
from arrowspace_torch.ops import select_tau as st
from arrowspace_torch.ops import taulambda as tl
from arrowspace_torch.ops.search import batched_lambda_aware_topk
from arrowspace_torch.reduction import ImplicitProjection


def _laplacian(n, seed, density=0.2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < density)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return np.diag(a.sum(1)) - a


def _items(n_rows, f, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 1.0, (n_rows, f))
    x[3] = 0.0                       # xᵀx = 0: E = 0, S = 0
    x[10, :n] = 0.0                  # graph coordinates 0: S = 0, G = 0
    x[11, :n] = 0.0
    x[20, n:] = 0.0                  # nothing beyond the graph
    taus = rng.uniform(0.01, 1.0, n_rows)
    return x, taus


@pytest.mark.parametrize("n", [24, 48])
def test_plain_matches_jax_pallas_kernel_interpret(n):
    f, n_rows = 96, 1000                  # 1000 rows: a ragged last tile
    x, taus = _items(n_rows, f, n, seed=n)
    lap = _laplacian(n, seed=n)
    x32, lap32, t32 = (a.astype(np.float32) for a in (x, lap, taus))
    ref = np.asarray(j_k5(jnp.asarray(x32), jnp.asarray(lap32),
                          jnp.asarray(t32), tile=256, interpret=True))
    got = lb.lambda_batch_plain(torch.from_numpy(x32),
                                torch.from_numpy(lap32),
                                torch.from_numpy(t32)).numpy()
    assert got.dtype == np.float32 and got.shape == (n_rows,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert got[3] == 0.0 and got[10] == 0.0 and got[11] == 0.0
    assert np.unique(got).size > n_rows // 2


@pytest.mark.parametrize("n", [24, 48])
def test_plain_matches_jax_synthetic_float64(n):
    f, n_rows = 96, 1000
    x, taus = _items(n_rows, f, n, seed=100 + n)
    lap = _laplacian(n, seed=100 + n)
    ref = np.asarray(jtm.synthetic_lambda_batch(
        jnp.asarray(x), jnp.asarray(lap), jnp.asarray(taus)))
    got = lb.lambda_batch_plain(torch.from_numpy(x), torch.from_numpy(lap),
                                torch.from_numpy(taus)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_fits_gate():
    assert lb.lambda_batch_fits(768, 185)
    assert lb.lambda_batch_fits(768, 384)
    assert lb.lambda_batch_fits(420, 420)
    assert lb.lambda_batch_fits(768, 680)
    assert not lb.lambda_batch_fits(768, 681)
    assert not lb.lambda_batch_fits(100, 101)
    assert not lb.lambda_batch_fits(64, 0)


def test_k2_plain_is_tau_then_k5_plain():
    x, _ = _items(500, 40, 16, seed=3)
    lap = torch.from_numpy(_laplacian(16, seed=3)).float()
    xt = torch.from_numpy(x).float()
    lam, tau = tl.taulambda_plain(xt, lap, ttm.TauMode.median())
    assert torch.equal(lam, lb.lambda_batch_plain(xt, lap, tau))


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("windowed", [False, True])
def test_wide_float32_batch_routes_to_k4_and_k5(monkeypatch, windowed):
    f, n = 300, 150
    n_rows = 32_768 if windowed else 20_000
    rng = np.random.default_rng(8)
    x = rng.uniform(0.1, 1.0, (n_rows, f))
    lap = _laplacian(n, seed=8, density=0.05)
    k2 = _count_calls(monkeypatch, tl, "fused_taulambda")
    k4 = _count_calls(monkeypatch, st, "fused_select_tau")
    k5 = _count_calls(monkeypatch, lb, "fused_lambda_batch")
    if windowed:                      # two windows of 16384 rows
        monkeypatch.setattr(ttm, "TAUMODE_WINDOW_BYTES", (1 << 14) * f * 4)
    lam = ttm.compute_taumode_lambdas(torch.tensor(x, dtype=torch.float32),
                                      torch.tensor(lap, dtype=torch.float32),
                                      ttm.TauMode.median())
    assert (len(k2), len(k4), len(k5)) == ((0, 2, 2) if windowed
                                           else (0, 1, 1))
    ref = np.asarray(jtm.compute_taumode_lambdas(
        jnp.asarray(x, dtype=jnp.float32), jnp.asarray(lap,
                                                       dtype=jnp.float32),
        jtm.TauMode.median()))
    np.testing.assert_allclose(lam.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_narrow_rows_keep_the_product_chain(monkeypatch):
    """2n > F: neither K2 (F > 256) nor K5 applies."""
    k5 = _count_calls(monkeypatch, lb, "fused_lambda_batch")
    x = torch.rand(300, 300)
    lam = ttm.compute_taumode_lambdas(
        x, torch.tensor(_laplacian(151, seed=1), dtype=torch.float32),
        ttm.TauMode.median())
    assert k5 == [] and lam.shape == (300,)


def _clustered(seed, n, f, centres=16, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


@pytest.fixture(scope="module")
def projected():
    """A seeded 8192 x 320 build with dims reduction, in the JAX package
    (float64) and in the port (float32 on the CPU) with the JAX
    projection carried across; the port's clustering runs the certified
    blocked scan (its row floor lowered to this corpus)."""
    rows = _clustered(21, 8192, 320)
    j = JIndex.build(rows, eps=1.0, dims_reduction=True, seed=11)
    held = ImplicitProjection.from_matrix(
        np.asarray(j.aspace.projection_matrix.matrix()))
    mp = pytest.MonkeyPatch()
    k5 = _count_calls(mp, lb, "fused_lambda_batch")
    k2 = _count_calls(mp, tl, "fused_taulambda")
    scans = _count_calls(mp, native, "_certified_scan")
    mp.setattr(native, "CERTIFIED_MIN_ROWS", 4096)
    mp.setattr(eigenmaps, "ImplicitProjection", lambda *a, **kw: held)
    try:
        t = ArrowIndex.build(rows, eps=1.0, dims_reduction=True, seed=11,
                             device="cpu", dtype=torch.float32)
    finally:
        mp.undo()
    return rows, j, t, (len(k2), len(k5), len(scans))


def test_projected_build_takes_k5_and_matches_jax(projected):
    _rows, j, t, (k2, k5, scans) = projected
    n = t.gl.matrix.shape[0]
    assert t.aspace.reduced_dim == n and 2 * n <= 320
    assert (k2, k5, scans) == (0, 1, 1)
    assert t.aspace.n_clusters == j.aspace.n_clusters
    np.testing.assert_array_equal(t.aspace.cluster_assignments,
                                  j.aspace.cluster_assignments)
    lam_t, lam_j = t.lambdas, np.asarray(j.lambdas)
    assert np.unique(lam_t).size > 1000
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-5)


def test_projected_session_equals_plain_full_scan(projected):
    rows, _j, t, _ = projected
    rng = np.random.default_rng(4)
    q = rows[rng.integers(0, rows.shape[0], 64)] * 1.02
    sess = t.make_search_session(batch_size=64, k=10, alpha=0.9)
    (s, i), = list(sess.search_stream([q]))
    qlam = t.aspace.prepare_query_items_batch(q, t.gl)
    ps, pi = batched_lambda_aware_topk(
        torch.tensor(q, dtype=torch.float32), qlam, t.aspace.data,
        t.aspace.lambdas, 0.9, k=10)
    np.testing.assert_array_equal(i, pi.numpy())
    np.testing.assert_allclose(s, ps.numpy(), rtol=0, atol=1e-6)


def test_projected_query_lambda_matches_jax(projected):
    """The session's query λ comes from the projected query (q @ P), as
    the JAX package prepares it; item λ came from the raw rows."""
    from arrowspace_torch.index import _query_prep
    rows, j, t, _ = projected
    q = rows[:32] * 1.02
    q_prep, qlam = _query_prep(t.aspace, t.gl)[1](
        torch.tensor(q, dtype=torch.float32))
    assert q_prep.shape == (32, t.gl.matrix.shape[0])
    ref = np.asarray(j.aspace.prepare_query_items_batch(q, j.gl))
    np.testing.assert_allclose(qlam.numpy(), ref, rtol=0, atol=1e-5)
