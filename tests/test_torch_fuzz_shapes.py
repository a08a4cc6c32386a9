"""tests/test_fuzz_shapes.py run in both packages: each case once as the
JAX package runs it (by calling the JAX test itself) and once on
``arrowspace_torch`` on the CPU in float64, on the same numpy draws from
the case's own seeds: the Laplacian, τ and λ, and the search top-k
against the numpy oracles at random tiny N, F and k, zero rows
included.  The port's results are also held to the JAX package's on the
same draw.

Tolerances (float64): the Laplacian within the JAX case's 1e-9 of the
oracle and 1e-12 of the JAX matrix; τ within 1e-12 relative of the
scalar τ; λ within the case's 1e-8 relative of the oracle and 1e-12 of
the JAX λ; top-k scores within 1e-9 relative of numpy, ids equal to the
JAX package's.  A draw that the JAX case skips (the sparsification
regime, which the oracle does not model) skips in the port too."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_fuzz_shapes as J
from arrowspace_tpu.graph import GraphParams as JParams
from arrowspace_tpu.laplacian import build_laplacian_matrix as j_lap
from arrowspace_tpu.ops.search import batched_lambda_aware_topk as j_scan
from arrowspace_tpu.taumode import synthetic_lambda_batch as j_lam
from arrowspace_torch import taumode as tt
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.graph import GraphParams
from arrowspace_torch.laplacian import build_laplacian_matrix
from arrowspace_torch.ops.search import batched_lambda_aware_topk
from helpers import (oracle_adjacency, oracle_laplacian,
                     oracle_synthetic_lambda)

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_laplacian_vs_oracle(seed):
    J.test_fuzz_laplacian_vs_oracle(seed)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    f = int(rng.integers(2, 30))
    topk = int(rng.integers(1, 8))
    eps = float(rng.uniform(0.05, 1.0))
    p = float(rng.choice([1.0, 2.0, 3.0]))
    sigma = None if rng.random() < 0.5 else float(rng.uniform(0.1, 2.0))
    rows = rng.normal(size=(n, f))
    if rng.random() < 0.2:
        rows[0] = 0.0
    kw = dict(eps=eps, k=6, topk=topk, p=p, sigma=sigma, normalise=False,
              sparsity_check=False)
    gl = build_laplacian_matrix(torch.from_numpy(rows), GraphParams(**kw),
                                **F64)
    got = np.asarray(gl.matrix)
    np.testing.assert_allclose(
        got, oracle_laplacian(oracle_adjacency(rows, eps=eps, topk=topk, p=p,
                                               sigma=sigma)), atol=1e-9)
    np.testing.assert_allclose(
        got, np.asarray(j_lap(jnp.asarray(rows), JParams(**kw)).matrix),
        rtol=0, atol=1e-12)
    assert gl.verify_properties(1e-8).is_symmetric


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_lambda_vs_oracle(seed):
    from arrowspace_tpu.taumode import TauMode as JMode
    from arrowspace_tpu.taumode import select_tau_batch as j_tau
    J.test_fuzz_lambda_vs_oracle(seed)
    rng = np.random.default_rng(100 + seed)
    n_nodes = int(rng.integers(2, 25))
    f = int(rng.integers(n_nodes, n_nodes + 20))
    n_items = int(rng.integers(2, 50))
    graph_rows = rng.normal(size=(n_nodes, max(2, n_nodes // 2 + 1)))
    lap = oracle_laplacian(oracle_adjacency(graph_rows, eps=1.0, topk=3,
                                            p=2.0, sigma=None))
    items = rng.normal(size=(n_items, f))
    if rng.random() < 0.3:
        items[1] = 0.0
    pct = float(rng.uniform(0, 1))
    kind, value = [("median", 0.0), ("mean", 0.0), ("fixed", 0.4),
                   ("percentile", pct)][seed % 4]
    mode = tt.TauMode(kind, value)
    x, L = torch.from_numpy(items), torch.from_numpy(lap)
    taus = tt.select_tau_batch(x, mode)
    lam = tt.synthetic_lambda_batch(x, L, taus).numpy()
    taus = taus.numpy()
    for i in range(n_items):
        tau_i = tt.select_tau(items[i], mode)
        assert taus[i] == pytest.approx(tau_i, rel=1e-12)
        assert lam[i] == pytest.approx(
            oracle_synthetic_lambda(items[i], lap, tau_i),
            rel=1e-8, abs=1e-12), (i, kind)
    jt = j_tau(jnp.asarray(items), JMode(kind, value))
    np.testing.assert_allclose(taus, np.asarray(jt), rtol=1e-12)
    np.testing.assert_allclose(
        lam, np.asarray(j_lam(jnp.asarray(items), jnp.asarray(lap), jt)),
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_search_topk_vs_numpy(seed):
    J.test_fuzz_search_topk_vs_numpy(seed)
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(2, 200))
    f = int(rng.integers(1, 40))
    b = int(rng.integers(1, 6))
    k = int(rng.integers(1, min(n, 12) + 1))
    alpha = float(rng.uniform(0, 1))
    items = rng.normal(size=(n, f))
    lams = rng.uniform(0, 2, n)
    q = rng.normal(size=(b, f))
    qlam = rng.uniform(0, 2, b)
    s, i = batched_lambda_aware_topk(
        *[torch.from_numpy(a) for a in (q, qlam, items, lams)], alpha, k=k)
    s, i = s.numpy(), i.numpy()
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    xn = np.linalg.norm(items, axis=1, keepdims=True)
    cos = (q / np.where(qn > 0, qn, 1.0)) @ (
        items / np.where(xn > 0, xn, 1.0)).T
    ref = alpha * cos + (1 - alpha) * (
        1.0 - np.minimum(np.abs(qlam[:, None] - lams[None, :]), 1.0))
    for bb in range(b):
        order = np.argsort(-ref[bb], kind="stable")[:k]
        np.testing.assert_allclose(s[bb], ref[bb][order], rtol=1e-9)
    _js, ji = j_scan(jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(items),
                     jnp.asarray(lams), jnp.asarray(alpha), k=k)
    np.testing.assert_array_equal(i, np.asarray(ji))


def test_tiny_extremes():
    J.test_tiny_extremes()
    rows = [[0.3, 0.7], [0.6, 0.4], [0.2, 0.9]]
    aspace, gl = (ArrowSpaceBuilder(**F64)
                  .with_lambda_graph(1.0, 2, 1, 2.0, None)
                  .with_inline_sampling(None)
                  .with_seed(1).build(rows))
    assert gl.shape() == (2, 2)
    qlam = aspace.prepare_query_item([0.5, 0.5], gl)
    res = aspace.search_lambda_aware(ArrowItem([0.5, 0.5], qlam or 1e-9), 3,
                                     0.5) if qlam != 0.0 else []
    assert isinstance(res, list)
