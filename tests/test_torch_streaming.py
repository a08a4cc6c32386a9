"""Out-of-core streaming of arrowspace_torch (ops/streaming) against the
JAX package's, on the CPU.

The cases of tests/test_distributed.py::test_streamed_matches_in_memory
run in both packages on the same numpy inputs (float32, as both stream),
with edge cases: a last chunk shorter than k, chunks at or above
BINNED_MIN_ITEMS (K1's plain version with its repair in every chunk),
exact ties across chunk borders (the lowest global id first), and a
narrow graph over wide rows (K4's and K5's plain versions per chunk).

Tolerances: streamed λ within 1e-5 relative of the JAX package's
(float32; both sum the λ products in their own order), and within 1e-5
absolute through K5's plain version, as tests/test_torch_lambda_batch.py
holds that route (its five float32 products cancel on some rows: 1.1e-5
relative seen at λ = 0.054); top-k ids equal, scores within 1e-5
relative; in float64 the streamed results equal the port's in-memory
scan bitwise (scores) and within 1e-12 (λ)."""

import numpy as np
import pytest
import torch

from arrowspace_tpu.ops import streaming as jst
from arrowspace_tpu.taumode import TauMode as JTauMode
from arrowspace_torch import taumode as ttaumode
from arrowspace_torch.core import BINNED_MIN_ITEMS
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import lambda_batch as lb
from arrowspace_torch.ops import select_tau as st
from arrowspace_torch.ops import streaming as tst
from arrowspace_torch.ops import taulambda as tl
from arrowspace_torch.ops.search import batched_lambda_aware_topk
from arrowspace_torch.taumode import TauMode, compute_taumode_lambdas
from helpers import oracle_adjacency, oracle_laplacian

CPU = dict(device="cpu")


def _corpus(n, f, seed=5, graph_nodes=None):
    rng = np.random.default_rng(seed)
    items = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    graph_rows = rng.uniform(0.1, 1.0, (graph_nodes or f, 8))
    lap = oracle_laplacian(oracle_adjacency(graph_rows, eps=1.0, topk=4,
                                            p=2.0, sigma=None))
    return items, lap


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def _assert_topk_equal(ts, js):
    np.testing.assert_array_equal(ts[1], np.asarray(js[1]))
    np.testing.assert_allclose(ts[0], np.asarray(js[0]), rtol=1e-5)


@pytest.mark.parametrize("chunk", [256, 1000, 4096])
def test_streamed_matches_jax_and_in_memory(chunk):
    """tests/test_distributed.py:300-328 in both packages: streamed λ and
    top-k against the JAX package's streamed functions, and the streamed
    top-k against the port's in-memory plain scan."""
    items, lap = _corpus(1000, 16)
    lam_t = tst.streamed_taumode_lambdas(items, lap, TauMode.median(),
                                         chunk=chunk, **CPU)
    lam_j = jst.streamed_taumode_lambdas(items, lap, JTauMode.median(),
                                         chunk=chunk)
    assert lam_t.dtype == np.float32 and lam_t.shape == (1000,)
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-5)
    lam_ref = compute_taumode_lambdas(
        torch.as_tensor(items), torch.as_tensor(lap, dtype=torch.float32),
        TauMode.median()).numpy()
    np.testing.assert_array_equal(lam_t, lam_ref)

    q = items[:4] * 1.01
    qlam = lam_j[:4]
    ts = tst.streamed_lambda_topk(q, qlam, items, lam_j, 0.9, 10,
                                  chunk=chunk, **CPU)
    js = jst.streamed_lambda_topk(q, qlam, items, lam_j, 0.9, 10,
                                  chunk=chunk)
    _assert_topk_equal(ts, js)
    assert ts[1].dtype == np.int64
    s_ref, i_ref = batched_lambda_aware_topk(
        torch.as_tensor(q), torch.as_tensor(qlam), torch.as_tensor(items),
        torch.as_tensor(lam_j), 0.9, k=10)
    np.testing.assert_array_equal(ts[1], i_ref.numpy())
    np.testing.assert_array_equal(ts[0], s_ref.numpy())


def test_last_chunk_shorter_than_k():
    """1000 rows in chunks of 995: the last chunk's 5 rows give a (B, 5)
    top-k, merged into the running (B, 10)."""
    items, lap = _corpus(1000, 16, seed=6)
    lam = jst.streamed_taumode_lambdas(items, lap, JTauMode.median(),
                                       chunk=995)
    # queries near the last rows, so the short chunk holds top-k rows
    q = items[-3:] * 1.01
    ts = tst.streamed_lambda_topk(q, lam[-3:], items, lam, 0.9, 10,
                                  chunk=995, **CPU)
    js = jst.streamed_lambda_topk(q, lam[-3:], items, lam, 0.9, 10,
                                  chunk=995)
    _assert_topk_equal(ts, js)
    assert (ts[1][:, 0] == np.arange(997, 1000)).all()


def test_corpus_smaller_than_k():
    """Fewer rows than k: the last slots stay -inf with id 0, as the JAX
    package's host merge leaves them."""
    items, lap = _corpus(7, 16, seed=7)
    lam = np.random.default_rng(7).uniform(0, 1, 7).astype(np.float32)
    ts = tst.streamed_lambda_topk(items[:2], lam[:2], items, lam, 0.9, 10,
                                  chunk=3, **CPU)
    js = jst.streamed_lambda_topk(items[:2], lam[:2], items, lam, 0.9, 10,
                                  chunk=3)
    np.testing.assert_array_equal(ts[1], np.asarray(js[1]))
    np.testing.assert_array_equal(np.isinf(ts[0]), np.isinf(js[0]))
    assert (ts[0][:, 7:] == -np.inf).all() and (ts[1][:, 7:] == 0).all()


def test_chunks_at_binned_size_run_k1_per_chunk(monkeypatch):
    """Chunks of BINNED_MIN_ITEMS rows take the binned engine (K1's plain
    version here, with its repair) and the 100-row tail the plain scan;
    the ids equal the JAX package's (its plain scan off a TPU)."""
    n = 2 * BINNED_MIN_ITEMS + 100
    items, lap = _corpus(n, 8, seed=8)
    lam = np.random.default_rng(8).uniform(0, 1, n).astype(np.float32)
    rng = np.random.default_rng(9)
    q = items[rng.integers(0, n, 4)] * 1.02
    qlam = lam[:4]
    calls = _counting(monkeypatch, bt, "binned_topk_pool")
    ts = tst.streamed_lambda_topk(q, qlam, items, lam, 0.9, 10,
                                  chunk=BINNED_MIN_ITEMS, **CPU)
    assert calls == [4, 4]
    js = jst.streamed_lambda_topk(q, qlam, items, lam, 0.9, 10,
                                  chunk=BINNED_MIN_ITEMS)
    _assert_topk_equal(ts, js)


@pytest.mark.parametrize("chunk", [100, 128, 333])
def test_ties_across_chunk_borders_go_to_the_lowest_id(chunk):
    """Exact copies of one row in several chunks (and twice inside one)
    tie bitwise; the merged top-k lists them in ascending global id,
    as the JAX package's stable host merge and the full scan do."""
    items, lap = _corpus(1000, 16, seed=10)
    copies = [777, 42, 130, 520, 521, 999]
    items[copies] = items[300]
    lam = np.random.default_rng(10).uniform(0, 1, 1000).astype(np.float32)
    lam[copies] = lam[300]
    q = items[300:301] * 1.01
    qlam = lam[300:301]
    ts = tst.streamed_lambda_topk(q, qlam, items, lam, 0.9, 10,
                                  chunk=chunk, **CPU)
    js = jst.streamed_lambda_topk(q, qlam, items, lam, 0.9, 10,
                                  chunk=chunk)
    _assert_topk_equal(ts, js)
    assert ts[1][0, :7].tolist() == sorted(copies + [300])
    assert len(set(ts[0][0, :7].tolist())) == 1


def test_narrow_graph_over_wide_rows_runs_k4_then_k5(monkeypatch):
    """A graph of 16 nodes over 64-wide rows with K2's gate off and K4's
    size gate at 0: every chunk's τ takes K4's plain version and its λ
    K5's, as the 1536-wide corpus does on the card; λ equals the JAX
    package's streamed λ."""
    items, lap = _corpus(3000, 64, seed=11, graph_nodes=16)
    monkeypatch.setattr(tl, "taulambda_fits", lambda f, n: False)
    monkeypatch.setattr(ttaumode, "SELECT_TAU_KERNEL_MIN_ELEMS", 0)
    k4 = _counting(monkeypatch, st, "fused_select_tau")
    k5 = _counting(monkeypatch, lb, "fused_lambda_batch")
    lam_t = tst.streamed_taumode_lambdas(items, lap, TauMode.median(),
                                         chunk=1024, **CPU)
    assert k4 == [1024, 1024, 952] and k5 == [1024, 1024, 952]
    lam_j = jst.streamed_taumode_lambdas(items, lap, JTauMode.median(),
                                         chunk=1024)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-5)


def test_float64_streaming_equals_the_in_memory_scan():
    """In float64 the streamed results are the in-memory ones: top-k
    scores bitwise (each row's score is reduced alike in any chunk), λ
    within 1e-12."""
    items, lap = _corpus(1500, 16, seed=12)
    items = items.astype(np.float64) + np.random.default_rng(12).normal(
        0, 1e-3, items.shape)
    lam = tst.streamed_taumode_lambdas(items, lap, TauMode.median(),
                                       chunk=400, dtype=torch.float64, **CPU)
    ref = compute_taumode_lambdas(torch.as_tensor(items),
                                  torch.as_tensor(lap), TauMode.median())
    np.testing.assert_allclose(lam, ref.numpy(), rtol=0, atol=1e-12)
    q = items[::300] * 1.02
    s, i = tst.streamed_lambda_topk(q, lam[::300], items, lam, 0.8, 12,
                                    chunk=400, dtype=torch.float64, **CPU)
    rs, ri = batched_lambda_aware_topk(
        torch.as_tensor(q), torch.as_tensor(lam[::300]),
        torch.as_tensor(items), torch.as_tensor(lam), 0.8, k=12)
    np.testing.assert_array_equal(i, ri.numpy())
    np.testing.assert_array_equal(s, rs.numpy())
