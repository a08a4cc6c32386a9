"""tests/test_taumode.py (mirroring the reference's tests/test_taumode.rs)
run in both packages: each case once as the JAX package runs it (by
calling the JAX test itself) and once on ``arrowspace_torch`` on the CPU
in float64, on the same numpy inputs made from the case's own seeds.
Where a case builds without a projection, the port's λ are also held to
the JAX package's on the same rows.  The windowed λ pass runs with the
port's TAUMODE_WINDOW_BYTES (arrowspace_torch/config.py) monkeypatched
to one byte, as the JAX case patches its own.

This file sits beside tests/test_torch_taumode.py (the port's own τ and
K2 tests), whose cases are not these.
``test_query_prep_precision_plumbing`` (an XLA matmul precision for the
TPU) stands in tests/test_torch_parity_map.py ``NOT_PORTED``.

Tolerances: τ exact where the JAX case asserts equality, else within its
own relative 1e-12; λ within the case's rtol (1e-9 against the oracle);
λ across packages within 1e-12 relative (float64, another summation
order); seeded builds bitwise repeatable inside each package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_taumode as J
from arrowspace_tpu import taumode as jt
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_torch import config as tconfig
from arrowspace_torch import taumode as tt
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.taumode import (TAU_FLOOR, TauMode,
                                      compute_taumode_lambdas, select_tau,
                                      select_tau_batch,
                                      synthetic_lambda_batch)
from data import make_gaussian_blob, make_moons_hd
from helpers import (oracle_adjacency, oracle_laplacian,
                     oracle_select_tau_median, oracle_synthetic_lambda)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def test_select_tau_fixed():
    J.test_select_tau_fixed()
    assert select_tau([1.0, 2.0], TauMode.fixed(0.5)) == 0.5
    assert select_tau([], TauMode.fixed(-1.0)) == TAU_FLOOR
    assert select_tau([], TauMode.fixed(float("nan"))) == TAU_FLOOR
    assert select_tau([], TauMode.fixed(0.0)) == TAU_FLOOR


def test_select_tau_mean_filters_nonfinite():
    J.test_select_tau_mean_filters_nonfinite()
    vals = [1.0, 2.0, float("nan"), 3.0, float("inf")]
    assert select_tau(vals, TauMode.mean()) == pytest.approx(2.0)
    assert select_tau([float("nan")], TauMode.mean()) == TAU_FLOOR


def test_select_tau_median_even_odd():
    J.test_select_tau_median_even_odd()
    assert select_tau([3.0, 1.0, 2.0], TauMode.median()) == 2.0
    assert select_tau([4.0, 1.0, 3.0, 2.0], TauMode.median()) == 2.5
    assert select_tau([], TauMode.median()) == TAU_FLOOR
    assert select_tau([-5.0, -1.0, -3.0], TauMode.median()) == TAU_FLOOR


def test_select_tau_percentile():
    J.test_select_tau_percentile()
    vals = list(range(11))
    assert select_tau(vals, TauMode.percentile(0.0)) == TAU_FLOOR
    assert select_tau(vals, TauMode.percentile(1.0)) == 10.0
    assert select_tau(vals, TauMode.percentile(0.5)) == 5.0
    assert select_tau(vals, TauMode.percentile(2.0)) == 10.0


def test_select_tau_batch_matches_scalar():
    J.test_select_tau_batch_matches_scalar()
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 1.0, (32, 17))
    x[3, 5] = np.nan
    x[7, 0] = np.inf
    for kind, value in (("median", 0.0), ("mean", 0.0), ("percentile", 0.3),
                        ("fixed", 0.2)):
        batch = select_tau_batch(_t(x), TauMode(kind, value)).numpy()
        for i in range(x.shape[0]):
            assert batch[i] == pytest.approx(
                select_tau(x[i], TauMode(kind, value)), rel=1e-12), (kind, i)
        want = np.asarray(jt.select_tau_batch(jnp.asarray(x),
                                              jt.TauMode(kind, value)))
        np.testing.assert_allclose(batch, want, rtol=1e-12, err_msg=kind)


def test_select_tau_median_matches_oracle():
    J.test_select_tau_median_matches_oracle()
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 2.0, (10, 9))
    batch = select_tau_batch(_t(x), TauMode.median()).numpy()
    for i in range(10):
        assert batch[i] == pytest.approx(oracle_select_tau_median(x[i]))


def _small_graph(n=12, f=12, seed=3):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(0.1, 1.0, (n, f))
    return rows, oracle_laplacian(oracle_adjacency(rows, eps=1.0, topk=3,
                                                   p=2.0, sigma=None))


def _jax_lam(rows, lap, taus, **kw):
    return np.asarray(jt.synthetic_lambda_batch(
        jnp.asarray(rows), jnp.asarray(lap), jnp.asarray(taus), **kw))


def test_synthetic_lambda_matches_oracle_both_methods():
    J.test_synthetic_lambda_matches_oracle_both_methods()
    rows, lap = _small_graph()
    taus = np.array([oracle_select_tau_median(r) for r in rows])
    for method in ("matmul", "direct"):
        lam = synthetic_lambda_batch(_t(rows), _t(lap), _t(taus),
                                     method=method).numpy()
        for i in range(rows.shape[0]):
            assert lam[i] == pytest.approx(
                oracle_synthetic_lambda(rows[i], lap, taus[i]), rel=1e-9)
        np.testing.assert_allclose(
            lam, _jax_lam(rows, lap, taus, method=method), rtol=1e-12)


def test_synthetic_lambda_partial_coordinate_quirk():
    J.test_synthetic_lambda_partial_coordinate_quirk()
    rng = np.random.default_rng(5)
    rows = rng.uniform(0.1, 1.0, (8, 20))
    lap = oracle_laplacian(oracle_adjacency(rows[:6, :6], eps=1.0, topk=2,
                                            p=2.0, sigma=None))
    taus = np.array([oracle_select_tau_median(r) for r in rows])
    lam = synthetic_lambda_batch(_t(rows), _t(lap), _t(taus)).numpy()
    for i in range(8):
        assert lam[i] == pytest.approx(
            oracle_synthetic_lambda(rows[i], lap, taus[i]), rel=1e-9)
    np.testing.assert_allclose(lam, _jax_lam(rows, lap, taus), rtol=1e-12)


def test_synthetic_lambda_graph_larger_than_items_errors():
    J.test_synthetic_lambda_graph_larger_than_items_errors()
    with pytest.raises(ValueError):
        synthetic_lambda_batch(torch.ones((2, 4), dtype=torch.float64),
                               torch.eye(10, dtype=torch.float64),
                               torch.ones((2,), dtype=torch.float64))


def test_lambda_nonnegative_and_bounded_for_laplacian():
    J.test_lambda_nonnegative_and_bounded_for_laplacian()
    rows, lap = _small_graph(n=20, f=20, seed=11)
    lam = compute_taumode_lambdas(_t(rows), _t(lap), TauMode.median()).numpy()
    assert np.all(np.isfinite(lam))
    assert np.all(lam >= 0.0) and np.all(lam <= 2.0)


def test_lambda_scale_invariance_of_rayleigh():
    J.test_lambda_scale_invariance_of_rayleigh()
    rows, lap = _small_graph(n=10, f=10, seed=13)
    tau = TauMode.fixed(0.5)
    lam1 = compute_taumode_lambdas(_t(rows), _t(lap), tau).numpy()
    lam2 = compute_taumode_lambdas(_t(rows * 3.0), _t(lap), tau).numpy()
    np.testing.assert_allclose(lam1, lam2, rtol=1e-9)


def test_lambda_recomputation_deterministic():
    J.test_lambda_recomputation_deterministic()
    rows, lap = _small_graph(n=16, f=16, seed=17)
    a = compute_taumode_lambdas(_t(rows), _t(lap), TauMode.median())
    b = compute_taumode_lambdas(_t(rows), _t(lap), TauMode.median())
    assert torch.equal(a, b)


def test_zero_vector_gives_zero_lambda():
    J.test_zero_vector_gives_zero_lambda()
    rows, lap = _small_graph(n=6, f=6, seed=19)
    rows = rows.copy()
    rows[2] = 0.0
    taus = np.array([oracle_select_tau_median(r) for r in rows])
    lam = synthetic_lambda_batch(_t(rows), _t(lap), _t(taus)).numpy()
    assert np.isfinite(lam[2])
    np.testing.assert_allclose(lam, _jax_lam(rows, lap, taus), rtol=1e-12)


def test_tau_floor_constant():
    J.test_tau_floor_constant()
    assert 0.0 < TAU_FLOOR < 1e-6 and np.isfinite(TAU_FLOOR)
    assert TAU_FLOOR == jt.TAU_FLOOR


def test_builder_lambdas_invariants():
    J.test_builder_lambdas_invariants()
    items = make_gaussian_blob(500, dims=10, spread=0.9, seed=21)
    aspace, _ = (_builder()
                 .with_lambda_graph(0.3, 6, 2, 2.0, 0.12)
                 .with_normalisation(False)
                 .with_spectral(True)
                 .with_synthesis(TauMode.median())
                 .with_seed(17).build(items.tolist()))
    lam = np.asarray(aspace.lambdas)
    assert np.all((lam >= 0.0) & (lam <= 1.0))
    assert lam.var() >= 0.0 and lam.max() >= lam.min()


def test_builder_lambdas_consistency_properties():
    """Seeded builds bitwise repeatable in the port, and equal to the JAX
    package's build of the same rows."""
    J.test_builder_lambdas_consistency_properties()
    items = make_moons_hd(80, 0.15, 0.4, 11, 789)

    def build(b):
        return (b.with_lambda_graph(0.3, 5, 2, 2.0, None)
                .with_normalisation(False)
                .with_synthesis(TauMode.median())
                .with_seed(23).build(items.tolist()))

    l1 = np.asarray(build(_builder())[0].lambdas)
    l2 = np.asarray(build(_builder())[0].lambdas)
    np.testing.assert_array_equal(l1, l2)
    assert l1.shape == (80,) and np.all(np.isfinite(l1))
    assert 0.0 <= l1.min() <= l1.max() <= 1.0
    jl = np.asarray(
        (JBuilder().with_lambda_graph(0.3, 5, 2, 2.0, None)
         .with_normalisation(False).with_synthesis(jt.TauMode.median())
         .with_seed(23).build(items.tolist()))[0].lambdas)
    np.testing.assert_allclose(l1, jl, rtol=1e-12, atol=1e-15)


def test_builder_lambdas_with_larger_dataset():
    J.test_builder_lambdas_with_larger_dataset()
    items = make_gaussian_blob(999, dims=10, spread=0.75, seed=25)
    aspace, gl = (_builder()
                  .with_lambda_graph(0.1, 6, 2, 2.0, 0.50)
                  .with_normalisation(False)
                  .with_synthesis(TauMode.fixed(0.8))
                  .with_sparsity_check(False)
                  .with_seed(19).build(items.tolist()))
    lam = np.asarray(aspace.lambdas)
    assert lam.shape[0] == aspace.nitems == 999
    assert gl.nnodes == 999
    assert np.all(np.isfinite(lam)) and np.all((lam >= 0.0) & (lam <= 1.0))
    for mode in (TauMode.fixed(0.45), TauMode.fixed(0.6), TauMode.mean(),
                 TauMode.median()):
        a, _ = (_builder()
                .with_lambda_graph(0.1, 6, 2, 2.0, 0.50)
                .with_synthesis(mode)
                .with_sparsity_check(False)
                .with_seed(19).build(items.tolist()))
        lm = np.asarray(a.lambdas)
        assert np.all(np.isfinite(lm)) and np.all(lm >= 0.0), str(mode)


def test_taumode_windowed_matches_single_shot(monkeypatch):
    """40000 rows in 16384-row windows (three, the tail clamped) equal
    the single pass."""
    J.test_taumode_windowed_matches_single_shot(monkeypatch)
    monkeypatch.undo()
    rng = np.random.default_rng(3)
    n, f, g = 40_000, 24, 24
    items = _t(rng.normal(size=(n, f)))
    a = rng.uniform(0, 1, (g, g))
    a = np.maximum(a, a.T) * (a > 0.6)
    np.fill_diagonal(a, 0)
    lap = _t(np.diag(a.sum(1)) - a)
    ref = compute_taumode_lambdas(items, lap, TauMode.median())
    calls = []
    inner = tt.compute_taumode_lambdas

    def counted(x, *args, **kw):
        calls.append(x.shape[0])
        return inner(x, *args, **kw)

    monkeypatch.setattr(tconfig, "TAUMODE_WINDOW_BYTES", 1)
    monkeypatch.setattr(tt, "TAUMODE_WINDOW_BYTES", 1)
    monkeypatch.setattr(tt, "compute_taumode_lambdas", counted)
    out = tt.compute_taumode_lambdas(items, lap, TauMode.median())
    assert calls == [n, 16384, 16384, n - 2 * 16384]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert out.shape == (n,)
