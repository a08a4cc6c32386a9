"""arrowspace_torch.taumode and the K2 (fused τ+λ) plain version against
the JAX package, on the same numpy inputs.

Tolerances: τ as an order statistic (median, percentile) or a fixed
value must match bitwise; the mean τ is a sum whose order XLA and PyTorch
choose differently, so it agrees to a few ulps (1e-14 relative in
float64, 1e-6 relative and 1e-7 absolute in float32); λ in float64
agrees to 1e-12 relative (only the summation order of the small
products differs); the float32 K2 plain version agrees with
the JAX kernel run in interpret mode to 1e-5 relative (float32 sums in a
different order, with the cancellation of the quartic G expansion)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu import taumode as jt
from arrowspace_tpu.ops.pallas_taulambda import fused_taulambda_batch
from arrowspace_torch import taumode as tt
from arrowspace_torch.ops import taulambda as tl
from helpers import oracle_adjacency, oracle_laplacian

MODES = [("median", 0.0), ("percentile", 0.3), ("percentile", 0.75),
         ("mean", 0.0), ("fixed", 0.4)]


def _rows(seed: int, n: int = 300, f: int = 24, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.0, (n, f))
    x[3, 5] = np.nan
    x[7, 0] = np.inf
    x[8, :4] = -np.inf
    x[9] = np.nan                                     # all non-finite
    x[10] = rng.choice([-1.0, 0.25, 2.0], size=f)     # heavy duplicates
    x[11, : f // 2] = -0.0
    x[11, f // 2:] = 0.0                              # signed zeros
    x[12, ::3] = np.nan                               # odd/even counts
    return x.astype(dtype)


def _graph(seed: int, nodes: int, width: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.uniform(0.1, 1.0, (nodes, width))
    return oracle_laplacian(oracle_adjacency(rows, eps=1.0, topk=4, p=2.0,
                                             sigma=None))


def _modes(kind, value):
    return jt.TauMode(kind, value), tt.TauMode(kind, value)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind,value", MODES)
def test_select_tau_batch_bitwise(kind, value, dtype):
    x = _rows(1, dtype=dtype)
    jm, tm = _modes(kind, value)
    want = np.asarray(jt.select_tau_batch(jnp.asarray(x), jm))
    got = tt.select_tau_batch(torch.from_numpy(x), tm).numpy()
    assert got.dtype == want.dtype
    if kind == "mean":
        tol = (1e-14, 1e-16) if dtype == np.float64 else (1e-6, 1e-7)
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,value", MODES)
def test_select_tau_host_scalar_bitwise(kind, value):
    x = _rows(2, n=40)
    jm, tm = _modes(kind, value)
    for row in x:
        assert tt.select_tau(row, tm) == jt.select_tau(row, jm)  # same code


@pytest.mark.parametrize("method", ["matmul", "direct"])
def test_synthetic_lambda_batch_matches(method):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.1, 1.0, (200, 30))
    lap = _graph(4, 24)                      # n < F: graph reads x[:, :24]
    taus = rng.uniform(0.05, 0.9, 200)
    want = np.asarray(jt.synthetic_lambda_batch(
        jnp.asarray(x), jnp.asarray(lap), jnp.asarray(taus), method=method))
    got = tt.synthetic_lambda_batch(
        torch.from_numpy(x), torch.from_numpy(lap), torch.from_numpy(taus),
        method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_synthetic_lambda_tall_graph_padding():
    rng = np.random.default_rng(5)
    x = rng.uniform(0.1, 1.0, (50, 10))
    lap = _graph(6, 16)                      # n > F
    taus = rng.uniform(0.05, 0.9, 50)
    with pytest.raises(ValueError):
        tt.synthetic_lambda_batch(torch.from_numpy(x), torch.from_numpy(lap),
                                  torch.from_numpy(taus))
    want = np.asarray(jt.synthetic_lambda_batch(
        jnp.asarray(x), jnp.asarray(lap), jnp.asarray(taus), pad_items=True))
    got = tt.synthetic_lambda_batch(
        torch.from_numpy(x), torch.from_numpy(lap), torch.from_numpy(taus),
        pad_items=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("kind,value", MODES)
def test_compute_taumode_lambdas_matches(kind, value):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.1, 1.0, (300, 32))
    lap = _graph(8, 32)
    jm, tm = _modes(kind, value)
    want = np.asarray(jt.compute_taumode_lambdas(jnp.asarray(x),
                                                 jnp.asarray(lap), jm))
    got = tt.compute_taumode_lambdas(torch.from_numpy(x),
                                     torch.from_numpy(lap), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_synthetic_lambda_single_matches():
    rng = np.random.default_rng(9)
    lap = _graph(10, 20)
    for _ in range(5):
        item = rng.uniform(0.1, 1.0, 20)
        tau = tt.select_tau(item, tt.TauMode.median())
        want = jt.synthetic_lambda_single(jnp.asarray(item), jnp.asarray(lap),
                                          tau)
        got = tt.synthetic_lambda_single(item, torch.from_numpy(lap), tau)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("kind,value", MODES)
def test_k2_plain_matches_jax_kernel_interpret(kind, value):
    """The K2 plain version in float32 against the Pallas kernel in
    interpret mode: τ bitwise (against select_tau_batch, which the kernel
    computes inside), λ to 1e-5 relative."""
    rng = np.random.default_rng(13)
    x = rng.uniform(0.1, 1.0, (700, 40)).astype(np.float32)
    x[5, 2] = np.inf
    lap = _graph(14, 24).astype(np.float32)
    jm, tm = _modes(kind, value)
    want_lam = np.asarray(fused_taulambda_batch(
        jnp.asarray(x), jnp.asarray(lap), kind=kind,
        pct=value if kind == "percentile" else 0.5,
        fixed=value if kind == "fixed" else 0.0, tile=256, interpret=True))
    want_tau = np.asarray(jt.select_tau_batch(jnp.asarray(x), jm))
    got_lam, got_tau = tl.taulambda_plain(torch.from_numpy(x),
                                          torch.from_numpy(lap), tm)
    assert got_lam.dtype == torch.float32
    if kind == "mean":
        np.testing.assert_allclose(got_tau.numpy(), want_tau, rtol=1e-6,
                                   atol=1e-7)
    else:
        np.testing.assert_array_equal(got_tau.numpy(), want_tau)
    fin = np.isfinite(want_lam)
    np.testing.assert_array_equal(np.isfinite(got_lam.numpy()), fin)
    np.testing.assert_allclose(got_lam.numpy()[fin], want_lam[fin],
                               rtol=1e-5, atol=1e-7)


def test_k2_wrapper_on_cpu_takes_plain_version():
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.uniform(0.1, 1.0, (64, 16)).astype(np.float32))
    lap = torch.from_numpy(_graph(16, 16).astype(np.float32))
    before = tl.fused_taulambda.launches
    lam, tau = tl.fused_taulambda(x, lap, tt.TauMode.median())
    lam2, tau2 = tl.taulambda_plain(x, lap, tt.TauMode.median())
    assert tl.fused_taulambda.launches == before
    assert torch.equal(lam, lam2) and torch.equal(tau, tau2)


def test_k2_gate():
    assert tl.taulambda_fits(128, 128)
    assert tl.taulambda_fits(40, 24)
    assert not tl.taulambda_fits(768, 768)
    assert not tl.taulambda_fits(16, 24)     # tall graph: plain path
