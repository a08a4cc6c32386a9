"""tests/test_csr_oracle.py run four ways: the JAX package's matmul and
direct λ, the port's λ (``arrowspace_torch.taumode.synthetic_lambda_batch``
by matmul and by direct sums, float64 on the CPU) and the CSR-loop port
of the reference's sparse two-pass algorithm (tests/oracle_csr.py,
taumode.rs:552-660), which shares no code with either package, on the
reference's 384-d embedding fixtures and the JAX case's synthetic edges
(partial coordinates, a zero row, an isolated node, constant rows).

Each JAX case runs as the JAX package runs it (by calling the JAX test
itself); then the port's builds and λ are held to the oracle.

Tolerances: every λ within 1e-12 relative (1e-13 absolute) of the CSR
oracle in float64, as the JAX case holds its own; the port's end-to-end
build λ within the JAX case's 1e-10 of the oracle chain; the port's
Laplacian of the fixtures within 1e-12 of the JAX package's."""

import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_csr_oracle as J
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.taumode import synthetic_lambda_batch as j_lam
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.taumode import (TauMode, select_tau,
                                      synthetic_lambda_batch)
from oracle_csr import dense_to_csr, synthetic_lambda_csr_oracle

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
DATA = np.load(FIXTURES / "reference_embeddings.npz")


def test_fixture_integrity():
    """tests/test_reference_parity.py's check of the fixtures every λ
    oracle here reads: 15 unit-norm quora embeddings and 10 protein
    embeddings, 384-d (the reference's test_data.rs:1-6, :5801)."""
    assert DATA["quora"].shape == (15, 384)
    assert DATA["proteins"].shape == (10, 384)
    np.testing.assert_allclose(np.linalg.norm(DATA["quora"], axis=1), 1.0,
                               rtol=1e-6)


def _four_way(rows, lap, taus, rtol=1e-12, atol=1e-13):
    """JAX matmul == JAX direct == port matmul == port direct == the CSR
    oracle, per item."""
    indptr, indices, data = dense_to_csr(lap)
    lam_csr = np.array([
        synthetic_lambda_csr_oracle(rows[i], indptr, indices, data,
                                    float(taus[i]))
        for i in range(rows.shape[0])])
    x, L, t = (torch.from_numpy(np.ascontiguousarray(a))
               for a in (rows, lap, taus))
    jx, jl, jt = jnp.asarray(rows), jnp.asarray(lap), jnp.asarray(taus)
    for method in ("matmul", "direct"):
        got = synthetic_lambda_batch(x, L, t, method=method).numpy()
        np.testing.assert_allclose(got, lam_csr, rtol=rtol, atol=atol,
                                   err_msg=f"port {method}")
        jax_lam = np.asarray(j_lam(jx, jl, jt, method=method))
        np.testing.assert_allclose(jax_lam, lam_csr, rtol=rtol, atol=atol,
                                   err_msg=f"jax {method}")
    return lam_csr


@pytest.mark.parametrize("tag", ["quora", "proteins"])
def test_three_way_on_reference_fixtures(tag):
    J.test_three_way_on_reference_fixtures(tag)
    rows = np.asarray(DATA[tag], dtype=np.float64)

    def build(builder):
        return (builder.with_lambda_graph(1.0, 6, 3, 2.0, None)
                .with_inline_sampling(None).with_seed(42)
                .build(rows.tolist()))
    aspace, gl = build(ArrowSpaceBuilder(device="cpu", dtype=torch.float64))
    lap = np.asarray(gl.matrix, dtype=np.float64)
    _j_aspace, j_gl = build(JBuilder())
    np.testing.assert_allclose(lap, np.asarray(j_gl.matrix), rtol=0,
                               atol=1e-12)
    n = lap.shape[0]
    taus = np.array([select_tau(rows[i][:n], TauMode.median())
                     for i in range(rows.shape[0])])
    lam_csr = _four_way(rows, lap, taus)
    np.testing.assert_allclose(np.asarray(aspace.lambdas), lam_csr,
                               rtol=1e-10)


def test_three_way_partial_coordinates():
    J.test_three_way_partial_coordinates()
    rng = np.random.default_rng(5)
    n, full_f = 12, 48
    rows = rng.normal(size=(20, full_f))
    a = rng.uniform(0, 1, (n, n))
    a = np.maximum(a, a.T) * (a > 0.55)
    np.fill_diagonal(a, 0)
    _four_way(rows, np.diag(a.sum(1)) - a, rng.uniform(0.1, 0.9, 20))


def test_three_way_zero_vector_and_disconnected():
    J.test_three_way_zero_vector_and_disconnected()
    rng = np.random.default_rng(7)
    n = 8
    a = rng.uniform(0, 1, (n, n))
    a = np.maximum(a, a.T) * (a > 0.5)
    np.fill_diagonal(a, 0)
    a[3, :] = 0.0
    a[:, 3] = 0.0
    rows = rng.normal(size=(5, n))
    rows[2] = 0.0
    lam = _four_way(rows, np.diag(a.sum(1)) - a, np.full(5, 0.4))
    assert lam[2] == pytest.approx(0.0, abs=1e-15)


def test_three_way_zero_edge_energy_skips_dispersion():
    J.test_three_way_zero_edge_energy_skips_dispersion()
    n = 6
    a = np.ones((n, n)) - np.eye(n)
    rows = np.tile(np.array([2.0]), (3, n))
    lam = _four_way(rows, np.diag(a.sum(1)) - a, np.array([0.2, 0.5, 0.9]))
    np.testing.assert_allclose(lam, 0.0, atol=1e-14)
