"""The arrowspace_torch CUDA kernels (K1 binned top-k, K2 fused τ+λ, K3
merge top-k) against their plain PyTorch versions on the card, at small
edge shapes: ragged corpora and query blocks, F not a multiple of the
32-feature staging slice, every bin count and depth, non-finite rows.

These tests need an NVIDIA card and nvcc, and skip without them.  This
file imports no JAX, so on a machine without JAX run it alone:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: float32 scores and λ within 1e-5 (the kernel and the card's
matmul sum the F products in another order); ids equal the plain
version's wherever scores are not tied within that tolerance, which is
checked by recomputing every returned id's score in float64; τ of an
order statistic (median, percentile) or a fixed τ bitwise."""

import numpy as np
import pytest
import torch

from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import taulambda as tl
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops.search import (INT_MAX, batched_lambda_aware_topk,
                                         binned_topk_with_repair,
                                         prepare_query)
from arrowspace_torch.taumode import TauMode

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(dev, n, f, b, seed):
    rng = np.random.default_rng(seed)
    t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.uniform(0.1, 1.0, (b, f)), rng.uniform(0, 1, b),
        rng.uniform(0.1, 1.0, (n, f)), rng.uniform(0, 1, n))]
    q, ql, x, xl = t
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(q, 0.9, dtype=torch.float32)
    return qh, ql, xh, xlh, c1


def _f64_scores(qh, ql, xh, xlh, c1, ids):
    """Float64 shifted scores of ids (any shape after the query axis);
    INT_MAX slots read row 0 and are masked by the caller."""
    flat = ids.reshape(ids.shape[0], -1).long().clamp_max(xh.shape[0] - 1)
    rows = xh[flat].double()
    acos = (rows * qh.double()[:, None, :]).sum(-1)
    dl = (ql.double()[:, None] - xlh[flat].double()).abs().clamp_max(1.0)
    return (acos - c1 * dl).reshape(ids.shape)


def _assert_scored_ids(s, i, ref_s, args):
    assert float((s.double() - ref_s.double()).abs().max()) <= TOL
    live = i != INT_MAX
    exact = _f64_scores(*args, i)
    assert float((exact - s.double())[live].abs().max()) <= TOL


@pytest.mark.parametrize("f", [128, 40, 7])
@pytest.mark.parametrize("bins,depth", [(128, 3), (256, 2), (512, 4),
                                        (128, 2), (512, 3)])
def test_k1_pool_matches_plain(dev, f, bins, depth):
    n, b = 5003, 37
    args = _inputs(dev, n, f, b, seed=f + bins)
    before = bt.binned_topk_pool.launches
    kw = dict(depth=depth, bins=bins, chunks=3)
    ps, pi, det = bt.binned_topk_pool(*args, n, **kw)
    rs, ri, rdet = bt.binned_topk_pool_plain(*args, n, **kw)
    torch.cuda.synchronize()
    assert bt.binned_topk_pool.launches == before + 1
    assert ps.shape == rs.shape and det.shape == rdet.shape
    _assert_scored_ids(ps, pi, rs, args)
    assert torch.equal(pi == INT_MAX, ri == INT_MAX)
    assert float((det - rdet).abs().max()) <= TOL


@pytest.mark.parametrize("k", [1, 10, 64, 128])
@pytest.mark.parametrize("rows_per_chunk", [128, 1280, 6000])
def test_k3_partial_matches_plain(dev, k, rows_per_chunk):
    n, b, f = 5003, 19, 40
    args = _inputs(dev, n, f, b, seed=k)
    before = tk.merge_topk_partial.launches
    s, i = tk.merge_topk_partial(*args, n, k=k, rows_per_chunk=rows_per_chunk)
    rs, ri = tk.merge_topk_partial_plain(*args, n, k=k,
                                         rows_per_chunk=rows_per_chunk)
    torch.cuda.synchronize()
    assert tk.merge_topk_partial.launches == before + 1
    _assert_scored_ids(s, i, rs, args)
    assert torch.equal(i == INT_MAX, ri == INT_MAX)


@pytest.mark.parametrize("f,n", [(128, 128), (40, 24), (33, 33)])
@pytest.mark.parametrize("mode", [TauMode.median(), TauMode.percentile(0.3),
                                  TauMode.percentile(0.75), TauMode.mean(),
                                  TauMode.fixed(0.2)])
def test_k2_matches_plain(dev, f, n, mode):
    rng = np.random.default_rng(f + n)
    x = torch.tensor(rng.uniform(0.1, 1.0, (3001, f)), dtype=torch.float32,
                     device=dev)
    x[5, 3] = float("nan")
    x[7, :] = float("inf")
    x[8, ::2] = float("-inf")
    a = rng.uniform(0, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.1)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    lap = torch.tensor(np.diag(a.sum(1)) - a, dtype=torch.float32,
                       device=dev)
    before = tl.fused_taulambda.launches
    lam, tau = tl.fused_taulambda(x, lap, mode)
    rlam, rtau = tl.taulambda_plain(x, lap, mode)
    torch.cuda.synchronize()
    assert tl.fused_taulambda.launches == before + 1
    if mode.kind == "mean":                  # a sum: order differs
        assert float((tau - rtau).abs().max()) <= TOL
    else:
        assert torch.equal(tau, rtau)
    fin = torch.isfinite(rlam)
    assert torch.equal(torch.isfinite(lam), fin)
    err = (lam - rlam)[fin].abs() / rlam[fin].abs().clamp_min(1.0)
    assert float(err.max()) <= TOL


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qh, ql, xh, xlh, c1 = _inputs(dev, 600, 16, 4, seed=1)
    with pytest.raises(ValueError):
        bt.binned_topk_pool(qh.double(), ql, xh, xlh, c1, 600, depth=3,
                            bins=128, chunks=1)
    with pytest.raises(ValueError):
        bt.binned_topk_pool(qh, ql, xh, xlh, c1, 600, depth=5, bins=128,
                            chunks=1)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh, ql, xh, xlh, c1, 600, k=129,
                              rows_per_chunk=256)
    with pytest.raises(ValueError):              # graph taller than F
        tl.fused_taulambda(xh[:, :8].contiguous(), torch.eye(16, device=dev),
                           TauMode.median())


def test_binned_search_with_forced_repair_equals_full_scan(dev):
    """Duplicate storms in one bin (strided repair) and in three bins (K3
    fallback) on a 70000-row corpus: the repaired top-k equals the plain
    full scan."""
    rng = np.random.default_rng(3)
    n, f, k = 70_000, 24, 10
    x = torch.tensor(rng.uniform(0.1, 1.0, (n, f)), dtype=torch.float32,
                     device=dev)
    xl = torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32, device=dev)
    q = torch.tensor(rng.uniform(0.1, 1.0, (6, f)), dtype=torch.float32,
                     device=dev)
    ql = torch.tensor(rng.uniform(0, 1, 6), dtype=torch.float32, device=dev)
    for j in range(5):
        x[77 + 128 * (j + 1)] = q[0]
        xl[77 + 128 * (j + 1)] = ql[0]
    for b in (5, 17, 29):
        for j in range(4):
            x[b + 128 * (j + 1)] = q[1]
            xl[b + 128 * (j + 1)] = ql[1]
    k1, k3 = bt.binned_topk_pool.launches, tk.merge_topk_partial.launches
    s, i = binned_topk_with_repair(q, ql, x, xl, 0.9, k=k)
    assert bt.binned_topk_pool.launches > k1
    assert tk.merge_topk_partial.launches > k3
    ps, pi = batched_lambda_aware_topk(q, ql, x, xl, 0.9, k=k)
    assert float((s - ps).abs().max()) <= TOL
    assert torch.equal(i[:2], pi[:2])


def test_cuda_session_matches_cpu_float64_build(dev):
    """A seeded 70000 x 16 build on the card (K2 in the build, K1 in the
    session) against the same build in float64 on the CPU."""
    rng = np.random.default_rng(5)
    c = rng.uniform(0.2, 0.8, (24, 16))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05, (70_000, 16))
    k2 = tl.fused_taulambda.launches
    gpu = ArrowIndex.build(rows, eps=1.0, seed=5, sampling=None, device=dev)
    assert tl.fused_taulambda.launches > k2
    cpu = ArrowIndex.build(rows, eps=1.0, seed=5, sampling=None,
                           device="cpu", dtype=torch.float64)
    assert gpu.aspace.n_clusters == cpu.aspace.n_clusters
    assert float(np.abs(gpu.lambdas - cpu.lambdas).max()) <= 1e-4
    sess = gpu.make_search_session(batch_size=64, k=10, alpha=0.9)
    assert sess.kernel == "binned"
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    k1 = bt.binned_topk_pool.launches
    (gs, gi), = list(sess.search_stream([queries]))
    assert bt.binned_topk_pool.launches > k1
    cs, ci = cpu.search(queries, k=10, alpha=0.9)
    assert float(np.abs(gs - cs).max()) <= 1e-4
    assert float(np.mean(gi == ci)) >= 0.99
