"""The arrowspace_torch CUDA kernels (K1 binned top-k, K2 fused τ+λ, K3
merge top-k, K4 τ selection, K5 λ given τ, K6 binned energy top-k, K7
chord-surrogate energy fold) against their plain PyTorch versions on the
card, at small edge shapes: ragged corpora and query blocks, F not a
multiple of the 32-feature staging slice, every bin count and depth,
non-finite rows, and the 768-wide rows of the projected build.  Then the
pruned screens on the card against their CPU run (ties among identical
rows bitwise, the zero-row device build, the graph-replayed step against
the step op by op), the double-buffered streaming against a copy on
the compute stream, and the mesh: four shards on the card against one
shard and the float64 CPU mesh, the strided mesh repairs included.
Last, the bf16 modes of K1 and K3 against their plain versions (the
same bf16 operands, a float32 product), both TMA rings at their edges
(ragged last slices, partial query blocks, fewer rows than a stage or a
tile, chunks without tiles, poisoned rows past n; K3's at F up to 3072
and k up to 128, its query block resident or streamed), bf16 rows tied
by id, each kernel's launch account against its wrapper's rule, and the
bf16 static, live and "merge" sessions on the card.

These tests need an NVIDIA card and nvcc, and skip without them.  This
file imports no JAX, so on a machine without JAX run it alone:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: float32 scores and λ within 1e-5 (the kernel and the card's
matmul sum the F products in another order); ids equal the plain
version's wherever scores are not tied within that tolerance, which is
checked by recomputing every returned id's score in float64; τ of an
order statistic (median, percentile) or a fixed τ bitwise; the d² each
K7 pool entry carries within 1e-4 of its float64 value (a difference of
squared norms near 10 at G <= 64, rounded in float32), scaled by G/64
above (the squared norms grow with G).  K1, K6 and K7 run their products
on the tensor cores as 3×TF32, not in the plain version's order, so a
flushed row's flag may differ from the plain version's only where its
k-th score and its largest det lie within twice the measured score
error."""

import numpy as np
import pytest
import torch

from arrowspace_torch.energymaps import EnergyParams
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import energy_approx as ea
from arrowspace_torch.ops import energy_bintopk as eb
from arrowspace_torch.ops import lambda_batch as lb
from arrowspace_torch.ops import select_tau as st
from arrowspace_torch.ops import taulambda as tl
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops._build import lib
from arrowspace_torch.ops.search import (INT_MAX, NEG_INF,
                                         batched_lambda_aware_topk,
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


@pytest.mark.parametrize("f", [128, 40, 7, 768])
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


@pytest.mark.parametrize("f", [128, 768])
@pytest.mark.parametrize("bins,depth", [(128, 3), (256, 2), (512, 4)])
def test_k1_identical_rows_score_bitwise_alike(dev, f, bins, depth):
    """Copies of query 0 in bins of every warp's 32-bin range (and, at 256
    and 512 bins, of another bin group), in all three chunks, two of them
    in one bin: the tensor-core products give them bitwise equal scores,
    and the flush returns them first, in ascending id order."""
    n, b, chunks = 5003, 19, 3
    rng = np.random.default_rng(f + bins)
    q, ql = rng.uniform(0.1, 1.0, (b, f)), rng.uniform(0, 1, b)
    x, xl = rng.uniform(0.1, 1.0, (n, f)), rng.uniform(0, 1, n)
    n_tiles = -(-n // bins)
    tiles_per_chunk = -(-n_tiles // chunks)
    spots = [(0, 3), (1, 38), (2, 70), (0, 101), (1, bins - 2), (2, 3)]
    ids = sorted(c * tiles_per_chunk * bins + bn for c, bn in spots)
    x[ids], xl[ids] = q[0], ql[0]
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in (q, ql, x, xl))
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(q, 0.9, dtype=torch.float32)
    args = (qh, ql, xh, xlh, c1, n)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    ps, pi, det = bt.binned_topk_pool(*args, **kw)
    torch.cuda.synchronize()
    copies = torch.isin(pi, torch.tensor(ids, device=dev, dtype=pi.dtype))
    assert int(copies[0].sum()) == len(ids)
    for r in range(b):
        found = ps[r][copies[r]]
        assert found.numel() == 0 or bool((found == found[0]).all())
    s, i, _, _ = bt.flush_pool(ps, pi, det, 10, c1)
    assert i[0, :len(ids)].tolist() == ids
    assert bool((s[0, :len(ids)] == s[0, 0]).all())
    _, ri, _, _ = bt.flush_pool(*bt.binned_topk_pool_plain(*args, **kw), 10,
                                c1)
    assert i[0, :len(ids)].tolist() == ri[0, :len(ids)].tolist()


@pytest.mark.parametrize("b,n,bins", [(1, 131, 128), (17, 4099, 256),
                                      (45, 70001, 512), (33, 1000, 128)])
def test_k1_ragged_query_block_and_tile_at_f768(dev, b, n, bins):
    """F = 768 with B not a multiple of 16 (a ragged m16 tile) and n not a
    multiple of bins (a ragged last tile), at the wrapper's own chunk
    count."""
    args = _inputs(dev, n, 768, b, seed=b + n)
    chunks = bt._default_chunks(bt.grid_ctas(b, bins, 768), -(-n // bins),
                                dev)
    kw = dict(depth=3, bins=bins, chunks=chunks)
    ps, pi, det = bt.binned_topk_pool(*args, n, **kw)
    rs, ri, rdet = bt.binned_topk_pool_plain(*args, n, **kw)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("f,n", [(128, 128), (40, 24), (33, 33),
                                 (256, 256)])
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


def test_k3_partial_matches_plain_at_f768(dev):
    n, b, f, k = 5003, 19, 768, 10
    args = _inputs(dev, n, f, b, seed=768)
    s, i = tk.merge_topk_partial(*args, n, k=k, rows_per_chunk=1280)
    rs, ri = tk.merge_topk_partial_plain(*args, n, k=k, rows_per_chunk=1280)
    torch.cuda.synchronize()
    _assert_scored_ids(s, i, rs, args)
    assert torch.equal(i == INT_MAX, ri == INT_MAX)


@pytest.mark.parametrize("f", [40, 768, 1272, 1536])
@pytest.mark.parametrize("k", [1, 10, 64, 128])
def test_k3_partial_matches_plain_at_every_width(dev, f, k):
    """The tensor-core K3 at the widths it serves, B = 70 (a ragged 64-
    query block) and n = 5003 (a ragged 64-row tile), at the wrapper's
    own chunking."""
    n, b = 5003, 70
    args = _inputs(dev, n, f, b, seed=f + k)
    rpc = tk._chunk_rows(b, n, dev, k)
    before = tk.merge_topk_partial.launches
    s, i = tk.merge_topk_partial(*args, n, k=k, rows_per_chunk=rpc)
    rs, ri = tk.merge_topk_partial_plain(*args, n, k=k, rows_per_chunk=rpc)
    torch.cuda.synchronize()
    assert tk.merge_topk_partial.launches == before + 1
    assert s.shape == rs.shape == (b, -(-n // rpc), k)
    _assert_scored_ids(s, i, rs, args)
    assert torch.equal(i == INT_MAX, ri == INT_MAX)


@pytest.mark.parametrize("f,b", [(128, 70), (768, 19), (1536, 64)])
def test_k3_identical_rows_score_bitwise_alike(dev, f, b):
    """Copies of query 0 in several tiles, warps and chunks, two of them
    adjacent: bitwise equal partial scores, and fused_lambda_topk returns
    them first in ascending id order."""
    n = 9001
    rng = np.random.default_rng(f)
    q, ql = rng.uniform(0.1, 1.0, (b, f)), rng.uniform(0, 1, b)
    x, xl = rng.uniform(0.1, 1.0, (n, f)), rng.uniform(0, 1, n)
    ids = [3, 4, 70, 101, 2049, 4500, 8999]
    x[ids], xl[ids] = q[0], ql[0]
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in (q, ql, x, xl))
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(q, 0.9, dtype=torch.float32)
    s, i = tk.merge_topk_partial(qh, ql, xh, xlh, c1, n, k=10,
                                 rows_per_chunk=2048)
    torch.cuda.synchronize()
    copies = torch.isin(i, torch.tensor(ids, device=dev, dtype=i.dtype))
    assert int(copies[0].sum()) == len(ids)
    found = s[0][copies[0]]
    assert bool((found == found[0]).all())
    fs, fi = tk.fused_lambda_topk(q, ql, x, xl, 0.9, k=10)
    assert fi[0, :len(ids)].tolist() == ids
    assert bool((fs[0, :len(ids)] == fs[0, 0]).all())


@pytest.mark.parametrize("f", [128, 768])
def test_k1_and_k3_score_a_pair_bitwise_alike(dev, f):
    """K1 and K3 run one 3×TF32 instruction sequence a (query, row) pair,
    so every row both return for a query has bitwise equal scores (the
    repair merges K3's rows with K1's)."""
    n, b = 20_000, 64
    args = _inputs(dev, n, f, b, seed=f)
    pool_s, pool_i, _ = bt.binned_topk_pool(*args, n, depth=3, bins=128,
                                            chunks=2)
    s, i = tk.merge_topk_partial(*args, n, k=128,
                                 rows_per_chunk=tk._chunk_rows(b, n, dev,
                                                               128))
    torch.cuda.synchronize()
    dense = torch.full((b, n + 1), float("nan"), device=dev)
    pi = pool_i.reshape(b, -1).long().clamp_max(n)
    dense.scatter_(1, pi, pool_s.reshape(b, -1))
    got = dense.gather(1, i.reshape(b, -1).long().clamp_max(n))
    both = ~torch.isnan(got) & (i.reshape(b, -1) != INT_MAX)
    assert int(both.sum()) >= b * 100
    assert torch.equal(got[both], s.reshape(b, -1)[both])


def test_merge_session_at_f1536_equals_plain_scan(dev):
    """A 70000 x 1536 projected build on the card: the session resolves
    "merge" (K1's gate does not admit F = 1536), launches K3 once per
    batch, and equals the plain full scan: scores within 1e-5, ids equal
    outside near-ties within twice the score error."""
    rng = np.random.default_rng(9)
    c = rng.uniform(0.2, 0.8, (24, 1536))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05,
                                                       (70_000, 1536))
    rows[[11, 500, 501]] = rows[10]
    idx = ArrowIndex.build(rows, eps=1.0, dims_reduction=True, seed=9,
                           device=dev)
    sess = idx.make_search_session(batch_size=64, k=10, alpha=0.9)
    assert sess.kernel == "merge"
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    queries[0] = rows[10] * 1.02
    k3, k1 = tk.merge_topk_partial.launches, bt.binned_topk_pool.launches
    (gs, gi), = list(sess.search_stream([queries]))
    assert tk.merge_topk_partial.launches == k3 + 1
    assert bt.binned_topk_pool.launches == k1
    from arrowspace_torch.index import _query_prep
    q = torch.tensor(queries, dtype=torch.float32, device=dev)
    _, qlam = _query_prep(idx.aspace, idx.gl)[1](q)
    ps, pi = batched_lambda_aware_topk(q, qlam, idx.aspace.data,
                                       idx.aspace.lambdas, 0.9, k=10)
    ps, pi = ps.cpu().numpy(), pi.cpu().numpy()
    err = float(np.abs(gs - ps).max())
    assert err <= TOL
    copies = [gi[0].tolist().index(v) for v in (10, 11, 500, 501)]
    assert copies == list(range(copies[0], copies[0] + 4))
    for r, j in zip(*np.nonzero(gi != pi)):
        pos = np.nonzero(pi[r] == gi[r, j])[0]
        other = ps[r, pos[0]] if pos.size else ps[r, -1]
        assert abs(other - ps[r, j]) <= 2.0 * err


def test_k3_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    qh, ql, xh, xlh, c1 = _inputs(dev, 600, 16, 4, seed=1)
    kw = dict(k=10, rows_per_chunk=256)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh, ql, xh, xlh, c1, 600, k=129,
                              rows_per_chunk=256)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh.double(), ql, xh, xlh, c1, 600, **kw)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh, ql, xh.half(), xlh, c1, 600, **kw)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh.t().contiguous().t(), ql, xh, xlh, c1, 600,
                              **kw)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh, ql, xh[:, ::2], xlh, c1, 600, **kw)


def _graph(n, seed, density=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < density)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return np.diag(a.sum(1)) - a


@pytest.mark.parametrize("f,n", [(768, 185), (768, 384), (300, 150),
                                 (64, 32), (1024, 680), (1536, 185)])
def test_k5_matches_plain(dev, f, n):
    """3001 rows (not a multiple of the CTA's 128), an all-zero row and
    a row whose graph coordinates are all 0 (S = 0)."""
    rng = np.random.default_rng(f + n)
    x = torch.tensor(rng.uniform(0.1, 1.0, (3001, f)), dtype=torch.float32,
                     device=dev)
    x[5] = 0.0
    x[6, :n] = 0.0
    tau = torch.tensor(rng.uniform(0.01, 1.0, 3001), dtype=torch.float32,
                       device=dev)
    lap = torch.tensor(_graph(n, seed=n), dtype=torch.float32, device=dev)
    before = lb.fused_lambda_batch.launches
    lam = lb.fused_lambda_batch(x, lap, tau)
    ref = lb.lambda_batch_plain(x, lap, tau)
    torch.cuda.synchronize()
    assert lb.fused_lambda_batch.launches == before + 1
    assert float(lam[5]) == 0.0 and float(lam[6]) == 0.0
    err = (lam - ref).abs() / ref.abs().clamp_min(1.0)
    assert float(err.max()) <= TOL
    assert int(torch.unique(ref).numel()) > 1000


@pytest.mark.parametrize("cols", [24, 33, 128, 185, 256, 680, 1536])
def test_lambda_tile_floats_mirrors_the_kernels_shared_memory(dev, cols):
    """The wrappers' gates read the λ tile's shared memory from
    lambda_tile_floats; it equals the kernels' own smem_bytes."""
    for row_scalars in (3, 4):   # K5, K2
        assert lb.lambda_tile_floats(cols, row_scalars) * 4 == \
            lib().asp_lambda_tile_bytes(cols, row_scalars)


def test_k2_and_k5_share_the_lambda_body(dev):
    """K5 given K2's τ computes K2's λ."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(0.1, 1.0, (3001, 200)), dtype=torch.float32,
                     device=dev)
    lap = torch.tensor(_graph(100, seed=2), dtype=torch.float32, device=dev)
    lam2, tau = tl.fused_taulambda(x, lap, TauMode.median())
    lam5 = lb.fused_lambda_batch(x, lap, tau)
    torch.cuda.synchronize()
    assert float((lam2 - lam5).abs().max()) <= TOL


def test_k2_k5_identical_rows_get_bitwise_identical_lambda(dev):
    """Copies of one row at every place of the 64-row CTA (both rows of a
    thread's C fragment, every m-tile, another CTA, the ragged last CTA)
    get the same λ bits from K5 and from K2."""
    rng = np.random.default_rng(5)
    for f, n in ((768, 185), (128, 128)):
        x = torch.tensor(rng.uniform(0.1, 1.0, (3001, f)),
                         dtype=torch.float32, device=dev)
        copies = [0, 7, 8, 15, 16, 33, 63, 64, 200, 2999, 3000]
        x[copies] = x[1234].clone()
        lap = torch.tensor(_graph(n, seed=n, density=0.3),
                           dtype=torch.float32, device=dev)
        lams = [lb.fused_lambda_batch(x, lap, torch.full(
            (3001,), 0.4, device=dev))]
        if tl.taulambda_fits(f, n):
            lams.append(tl.fused_taulambda(x, lap, TauMode.median())[0])
        torch.cuda.synchronize()
        for lam in lams:
            assert torch.equal(lam[copies],
                               lam[1234].expand(len(copies)))


@pytest.mark.parametrize("spread", [0.05, 0.01])
@pytest.mark.parametrize("f,n", [(768, 185), (128, 128)])
def test_k2_k5_cancellation_rows(dev, f, n, spread):
    """Rows 0.5 ± spread over a dense graph: S and G's numerator are small
    differences of large moments.  Each kernel's λ is no further from
    float64 than 3 times the plain float32 version's distance (the CPU
    emulation, tests/test_torch_lambda_tc.py, reads at most 1.8); at ±0.05
    it is also within TOL of the plain version.  At ±0.01 the plain
    float32 λ is itself about 1e-3 from float64, so no other summation
    order agrees with it within TOL: the fp32 CUDA-core body that the
    tensor-core one replaced read 6.1e-4 (K5) and 9.3e-4 (K2) from the
    plain version there, as this one reads 6.6e-4 and 9.2e-4
    (tools/kernel_ablation.py on an H100)."""
    rng = np.random.default_rng(f + n)
    x = torch.tensor(0.5 + rng.uniform(-spread, spread, (3001, f)),
                     dtype=torch.float32, device=dev)
    lap = torch.tensor(_graph(n, seed=n, density=1.0), dtype=torch.float32,
                       device=dev)
    tau = torch.tensor(rng.uniform(0.01, 1.0, 3001), dtype=torch.float32,
                       device=dev)
    if tl.taulambda_fits(f, n):
        lam, tau = tl.fused_taulambda(x, lap, TauMode.median())
    else:
        lam = lb.fused_lambda_batch(x, lap, tau)
    ref = lb.lambda_batch_plain(x, lap, tau)
    ref64 = lb.lambda_batch_plain(x.double(), lap.double(), tau.double())
    torch.cuda.synchronize()
    err64 = float((lam.double() - ref64).abs().max())
    plain_err64 = float((ref.double() - ref64).abs().max())
    assert err64 <= 3.0 * plain_err64 + 1e-7
    if spread == 0.05:
        assert float((lam - ref).abs().max()) <= TOL


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
    tau = torch.ones(xh.shape[0], device=dev)
    with pytest.raises(ValueError):              # n above the gate
        lb.fused_lambda_batch(torch.zeros(4, 1024, device=dev),
                              torch.eye(681, device=dev), tau[:4])
    with pytest.raises(ValueError):              # one τ per row
        lb.fused_lambda_batch(xh, torch.eye(8, device=dev), tau[:3])
    with pytest.raises(ValueError):              # F above K4's gate
        st.fused_select_tau(torch.zeros(4, st.MAX_F + 1, device=dev),
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


def awkward_rows(f: int, seed: int) -> np.ndarray:
    """23 rows of F float32 values that stress an order statistic:
    random, constant, negative, ±0.0, denormal, duplicates, sorted,
    reversed, one finite value, all NaN, ±inf, sums that overflow, the
    full float32 range, and values that share every radix digit but the
    last (tests/test_torch_tau_select.py emulates K4 on them)."""
    rng = np.random.default_rng(seed)
    rows = [rng.normal(0.5, 1.0, f), rng.uniform(0.2, 0.8, f)]
    rows.append(np.full(f, 0.7))                              # constant
    rows.append(rng.uniform(-3.0, -1.0, f))                   # negative
    z = np.where(rng.uniform(size=f) < 0.5, -0.0, 0.0)        # ±0 and some
    z[rng.uniform(size=f) < 0.3] = 0.25
    rows.append(z)
    den = rng.integers(-2**23 + 1, 2**23, f).astype(np.int32)  # denormals
    rows.append(np.abs(den).view(np.float32) * np.sign(den))
    rows.append(rng.choice([0.1, 0.2, 0.3], f))               # duplicates
    rows.append(np.sort(rng.normal(size=f)))                  # sorted
    rows.append(np.sort(rng.normal(size=f))[::-1])            # reversed
    one = np.full(f, np.nan)                                  # one finite
    one[rng.integers(f)] = 0.4
    rows.append(one)
    rows.append(np.full(f, np.nan))                           # all NaN
    pm = rng.uniform(0.1, 1.0, f)                             # ±inf
    pm[rng.uniform(size=f) < 0.3] = np.inf
    pm[rng.uniform(size=f) < 0.2] = -np.inf
    rows.append(pm)
    rows.append(np.where(rng.uniform(size=f) < 0.5, np.inf, -np.inf))
    rows.append(rng.uniform(3.0e38, 3.4e38, f))               # sums overflow
    rows.append(rng.choice([-3.0e38, 3.0e38, 1e-30, 0.5], f))  # full range
    one_bin = (np.float32(1.0).view(np.int32)                 # one digit
               + rng.permutation(f)).astype(np.int32).view(np.float32)
    one_bin[rng.integers(f)] = 1e6
    rows.append(one_bin)
    rows.extend(rng.uniform(0.0, 1.0, (6, f)))
    return np.asarray(rows, dtype=np.float32)



@pytest.mark.parametrize("f", [128, 64, 7, 300, 1024, 768, 1025, 1536])
@pytest.mark.parametrize("mode", [TauMode.median(), TauMode.percentile(0.3),
                                  TauMode.percentile(0.75)])
def test_k4_matches_plain(dev, f, mode):
    rng = np.random.default_rng(f)
    x = torch.tensor(rng.normal(0.5, 1.0, (3001, f)), dtype=torch.float32,
                     device=dev)
    x[5, min(3, f - 1)] = float("nan")
    x[7, :] = float("inf")
    x[8, ::2] = float("-inf")
    x[9, :] = float("nan")
    x[10, :] = 0.0
    awk = awkward_rows(f, seed=f)
    x[11:11 + len(awk)] = torch.from_numpy(awk).to(dev)
    before = st.fused_select_tau.launches
    tau = st.fused_select_tau(x, mode)
    ref = st.select_tau_plain(x, mode)
    torch.cuda.synchronize()
    assert st.fused_select_tau.launches == before + 1
    assert torch.equal(tau, ref)


@pytest.mark.parametrize("f", [128, 768, 1536])
def test_k4_scalar_and_vector_loads_agree(dev, f):
    """Rows 16-byte aligned take 16-byte loads, others one value a lane
    at a time: the same τ, bitwise, as the sort."""
    rng = np.random.default_rng(f + 1)
    rows = np.concatenate([rng.uniform(0.15, 0.85, (2000, f)),
                           awkward_rows(f, seed=f + 1)]).astype(np.float32)
    buf = torch.empty(rows.size + 1, device=dev)
    shifted = buf[1:].view(rows.shape)          # 4 bytes past alignment
    shifted.copy_(torch.from_numpy(rows))
    aligned = shifted.clone()
    assert shifted.data_ptr() % 16 == 4 and aligned.data_ptr() % 16 == 0
    for mode in (TauMode.median(), TauMode.percentile(0.3)):
        ref = st.select_tau_plain(aligned, mode)
        assert torch.equal(st.fused_select_tau(aligned, mode), ref)
        assert torch.equal(st.fused_select_tau(shifted, mode), ref)


@pytest.mark.parametrize("f", [128, 33, 256])
@pytest.mark.parametrize("mode", [TauMode.median(), TauMode.percentile(0.0),
                                  TauMode.percentile(0.3),
                                  TauMode.percentile(1.0)])
def test_k2_tau_bitwise_on_awkward_rows(dev, f, mode):
    """K2's τ phase runs the same selection as K4: bitwise equal to the
    sort on the same awkward rows, beside random ones in every CTA."""
    rng = np.random.default_rng(f + 7)
    rows = rng.uniform(0.1, 1.0, (1000, f))
    awk = awkward_rows(f, seed=f)
    rows[::40][:len(awk)] = awk
    x = torch.tensor(rows, dtype=torch.float32, device=dev)
    a = rng.uniform(0, 1, (f, f)) * (rng.uniform(0, 1, (f, f)) < 0.1)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    lap = torch.tensor(np.diag(a.sum(1)) - a, dtype=torch.float32,
                       device=dev)
    _, tau = tl.fused_taulambda(x, lap, mode)
    _, rtau = tl.taulambda_plain(x, lap, mode)
    assert torch.equal(tau, rtau)


def _energy_inputs(dev, n, g, b, seed):
    rng = np.random.default_rng(seed)
    zq, ql, z, xl = [torch.tensor(a, dtype=torch.float32, device=dev)
                     for a in (rng.uniform(0.1, 1.0, (b, g)),
                               rng.uniform(0, 1, b),
                               rng.uniform(0.1, 1.0, (n, g)),
                               rng.uniform(0, 1, n))]
    zx, xlam, xn = eb.prepare_binned_energy_corpus(z, xl)
    return zq, (zq * zq).sum(dim=1), ql, zx, xn, xlam


def _f64_energy(zq, ql, zx, xlam, wl, wd, ids):
    """Float64 shifted energy scores of ids; INT_MAX slots read row 0."""
    flat = ids.reshape(ids.shape[0], -1).long().clamp_max(zx.shape[0] - 1)
    d = zq.double()[:, None, :] - zx[flat].double()
    num = torch.sqrt((d * d).sum(-1))
    dl = (ql.double()[:, None] - xlam[flat].double()).abs()
    return (wd / (1.0 + num) - wl * dl).reshape(ids.shape)


def _flags_agree(fl, rfl, s, det, err):
    """Flags equal the plain version's except where the row's k-th score
    and its largest det lie within 2·err (a near-tie that another
    rounding of the product can turn); returns the number of such rows."""
    diff = fl != rfl
    if bool(diff.any()):
        gap = (s[:, -1] - det.amax(dim=1)).abs()
        assert float(gap[diff].max()) <= 2.0 * err
    return int(diff.sum())


# The energy tile's z-widths: within one slice (ragged, 40, one whole
# slice), several slices, and the widest the fp32 fold admitted (at 512
# bins; the tile's gate admits any G).
ENERGY_G = [64, 40, 7, 384, 2652]


@pytest.mark.parametrize("g", ENERGY_G)
@pytest.mark.parametrize("bins,depth", [(128, 3), (256, 2), (512, 4)])
def test_k6_pool_matches_plain(dev, g, bins, depth):
    """B = 37 (a ragged query block) and n = 5003 (a ragged last tile)."""
    n, b, wl, wd = 5003, 37, 1.0, 0.5
    zq, qn, ql, zx, xn, xlam = _energy_inputs(dev, n, g, b, seed=g + bins)
    kw = dict(depth=depth, bins=bins, chunks=3)
    before = eb.binned_energy_pool.launches
    ps, pi, det = eb.binned_energy_pool(zq, qn, ql, zx, xn, xlam, wl, wd, n,
                                        **kw)
    rs, ri, rdet = eb.binned_energy_pool_plain(zq, qn, ql, zx, xn, xlam, wl,
                                               wd, n, **kw)
    torch.cuda.synchronize()
    assert eb.binned_energy_pool.launches == before + 1
    assert ps.shape == rs.shape and det.shape == rdet.shape
    assert float((ps - rs).abs().max()) <= TOL
    assert float((det - rdet).abs().max()) <= TOL
    live = pi != INT_MAX
    assert torch.equal(live, ri != INT_MAX)
    exact = _f64_energy(zq, ql, zx, xlam, wl, wd, pi)
    assert float((exact - ps.double())[live].abs().max()) <= TOL


@pytest.mark.parametrize("k", [10, 64])
def test_k6_topk_and_flags_match_plain(dev, k):
    """The flushed top-k at k=10 and k=64 over a 33-row query block (a
    partial block of the kernel), with depth+2 copies of query 0's
    nearest row (query 0 + 0.125 in every coordinate, d² = 1; random rows
    lie at d² ≈ 9) planted in one bin of one corpus chunk (two chunks, so
    the copies cannot spread over chunks): the same flags as the plain
    version, query 0 among them, and ids equal outside near-ties.  The
    wrapper, at its own chunk count, equals the plain chunked scan on
    unflagged rows.  (Copies at d² → 0, where u's slope grows without
    bound: test_k6_exact_copies_of_the_query and chip_smoke.py.)"""
    n, g, b = 9000, 64, 33
    zq, qn, ql, zx, xn, xlam = _energy_inputs(dev, n, g, b, seed=k)
    bins, depth = bt.bins_target(k), bt.binned_topk_depth_for(k)
    for j in range(depth + 2):
        zx[5 + bins * (j + 1)] = zq[0] + 0.125
        xlam[5 + bins * (j + 1)] = ql[0]
    xn = (zx * zx).sum(dim=1)
    kw = dict(depth=depth, bins=bins, chunks=2)
    s, i, fl, det = bt.flush_pool(*eb.binned_energy_pool(
        zq, qn, ql, zx, xn, xlam, 1.0, 0.5, n, **kw), k, -0.5)
    rs, ri, rfl, rdet = bt.flush_pool(*eb.binned_energy_pool_plain(
        zq, qn, ql, zx, xn, xlam, 1.0, 0.5, n, **kw), k, -0.5)
    err = float((s - rs).abs().max())
    assert err <= TOL
    assert bool(fl[0]) and bool(rfl[0])
    _flags_agree(fl, rfl, s, det, err)
    assert float((det - rdet).abs().max()) <= TOL
    # an id may differ only where float64 scores tie within 2·TOL
    diff = (i != ri) & ~fl[:, None]
    a = _f64_energy(zq, ql, zx, xlam, 1.0, 0.5, i)
    r = _f64_energy(zq, ql, zx, xlam, 1.0, 0.5, ri)
    gap = torch.where(diff, (a - r).abs(), torch.zeros_like(a))
    assert float(gap.max()) <= 2 * TOL
    ws, wi, wfl, _ = eb.binned_energy_topk(zq, ql, zx, xlam, xn, 1.0, 0.5,
                                           k=k, n=n)
    es, ei = eb.energy_topk_chunked(zq, ql, zx[:n], xlam[:n], 1.0, 0.5, k=k)
    ok = ~wfl
    assert float((ws - es)[ok].abs().max()) <= TOL


@pytest.mark.parametrize("g", [64, 384])
def test_k6_exact_copies_of_the_query(dev, g):
    """Exact copies of query 0 (d² = 0 in float64, score w_D): u's slope
    w_D/(2√d²) is unbounded there, so the float32 d² = |q|² + |x|² -
    2·q·x of the kernel and of the plain version (each off by a few ulps
    of 2|q|², in another order) give scores that may differ from w_D, and
    from each other, by w_D·√(d² error).  Held: the copies come first, in
    ascending id order, with bitwise equal scores, in both; each side's
    score within w_D·√(2·G·ε·2|q|²) of float64 (ε = 2⁻²⁴: a G-term dot
    product's rounding bound)."""
    n, b, k, wl, wd = 9000, 33, 10, 1.0, 0.5
    zq, qn, ql, zx, xn, xlam = _energy_inputs(dev, n, g, b, seed=g)
    depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
    ids = [7 + bins * j + j for j in range(depth)]   # distinct bins
    for c in ids:
        zx[c], xlam[c] = zq[0], ql[0]
    xn = (zx * zx).sum(dim=1)
    kw = dict(depth=depth, bins=bins, chunks=2)
    bound = wd * float(2.0 * g * 2.0 ** -24 * 2.0 * qn[0]) ** 0.5
    for pool in (eb.binned_energy_pool, eb.binned_energy_pool_plain):
        s, i, fl, _ = bt.flush_pool(*pool(zq, qn, ql, zx, xn, xlam, wl, wd,
                                          n, **kw), k, -wd)
        assert not bool(fl[0])
        assert i[0, :depth].tolist() == ids
        assert bool((s[0, :depth] == s[0, 0]).all())
        assert abs(float(s[0, 0])) <= bound


def _k7_pool_vs_plain(dev, n, b, g, depth, bins, chunks, seed, wl=1.0,
                      wd=0.5):
    zq, qn, ql, zx, xn, xlam = _energy_inputs(dev, n, g, b, seed=seed)
    z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, n)
    ca, cb = ea._fit_chords(zq, qn, z_s, xn_s, wd)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    before = ea.binned_energy_approx_pool.launches
    out = ea.binned_energy_approx_pool(zq, qn, ql, ca, cb, zx, xn, xlam, wl,
                                       n, **kw)
    ref = ea.binned_energy_approx_pool_plain(zq, qn, ql, ca, cb, zx, xn,
                                             xlam, wl, n, **kw)
    torch.cuda.synchronize()
    assert ea.binned_energy_approx_pool.launches == before + 1
    (ps, pi, pd, det), (rs, ri, rd, rdet) = out, ref
    assert ps.shape == rs.shape and det.shape == rdet.shape
    assert float((ps - rs).abs().max()) <= TOL
    assert float((det - rdet).abs().max()) <= TOL
    live = pi != INT_MAX
    assert torch.equal(live, ri != INT_MAX)
    flat = pi.reshape(b, -1).long().clamp_max(n - 1)
    d = zq.double()[:, None, :] - zx[flat].double()
    d2 = (d * d).sum(-1).reshape(pd.shape)
    assert float((d2 - pd.double())[live].abs().max()) <= 1e-4 * max(
        1.0, g / 64)
    return zq, ql, zx, xn, xlam, z_s, xn_s


@pytest.mark.parametrize("g,k", [(64, 10), (40, 64), (7, 5)])
def test_k7_pool_matches_plain(dev, g, k):
    n, b, wl, wd = 5003, 37, 1.0, 0.5
    depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
    zq, ql, zx, xn, xlam, z_s, xn_s = _k7_pool_vs_plain(
        dev, n, b, g, depth, bins, 2, seed=g + k)
    s, i, fl = ea.binned_energy_topk_approx(zq, ql, zx, xlam, xn, z_s, xn_s,
                                            wl, wd, k=k, n=n)
    es, ei = eb.energy_topk_chunked(zq, ql, zx[:n], xlam[:n], wl, wd, k=k)
    ok = ~fl
    assert bool(ok.any())
    assert float((s - es)[ok].abs().max()) <= TOL


@pytest.mark.parametrize("g", ENERGY_G)
@pytest.mark.parametrize("bins,depth", [(128, 3), (256, 2), (512, 4)])
def test_k7_pool_matches_plain_at_every_width(dev, g, bins, depth):
    """K7's pool, det and d² payload against its plain version at every
    z-width and (depth, bins) K6 is tested at, with B = 37 (a ragged
    query block) and n = 5003 (a ragged last tile), three chunks."""
    _k7_pool_vs_plain(dev, 5003, 37, g, depth, bins, 3, seed=g + bins)


def _planted_copies(dev, g, bins, chunks, seed):
    """Copies of query 0 (z row and λ) in bins of every warp's bin range
    and of another bin group, in all three chunks, two of them in one
    bin; returns the inputs and the sorted copy ids."""
    n, b = 5003, 19
    rng = np.random.default_rng(seed)
    zq, ql = rng.uniform(0.1, 1.0, (b, g)), rng.uniform(0, 1, b)
    z, xl = rng.uniform(0.1, 1.0, (n, g)), rng.uniform(0, 1, n)
    n_tiles = -(-n // bins)
    tiles_per_chunk = -(-n_tiles // chunks)
    spots = [(0, 3), (1, 38), (2, 70), (0, 101), (1, bins - 2), (2, 3)]
    ids = sorted(c * tiles_per_chunk * bins + bn for c, bn in spots)
    z[ids], xl[ids] = zq[0], ql[0]
    zq, ql, z, xl = (torch.tensor(a, dtype=torch.float32, device=dev)
                     for a in (zq, ql, z, xl))
    zx, xlam, xn = eb.prepare_binned_energy_corpus(z, xl)
    return (zq, (zq * zq).sum(dim=1), ql, zx, xn, xlam, n), ids


def _copies_alike(ps, pi, ids, dev):
    copies = torch.isin(pi, torch.tensor(ids, device=dev, dtype=pi.dtype))
    assert int(copies[0].sum()) == len(ids)
    for r in range(ps.shape[0]):
        found = ps[r][copies[r]]
        assert found.numel() == 0 or bool((found == found[0]).all())


@pytest.mark.parametrize("g", [64, 384])
@pytest.mark.parametrize("bins,depth", [(128, 3), (256, 2), (512, 4)])
def test_k6_k7_identical_rows_score_bitwise_alike(dev, g, bins, depth):
    """The tensor-core products give identical rows bitwise equal scores
    (K6) and d² (K7) across bins, warps and chunks, and both flushes
    return them first, in ascending id order, as the plain versions do."""
    chunks, k, wl, wd = 3, 10, 1.0, 0.5
    (zq, qn, ql, zx, xn, xlam, n), ids = _planted_copies(dev, g, bins,
                                                         chunks, g + bins)
    kw = dict(depth=depth, bins=bins, chunks=chunks)
    ps, pi, det = eb.binned_energy_pool(zq, qn, ql, zx, xn, xlam, wl, wd, n,
                                        **kw)
    torch.cuda.synchronize()
    _copies_alike(ps, pi, ids, dev)
    s, i, _, _ = bt.flush_pool(ps, pi, det, k, -wd)
    assert i[0, :len(ids)].tolist() == ids
    assert bool((s[0, :len(ids)] == s[0, 0]).all())
    _, ri, _, _ = bt.flush_pool(*eb.binned_energy_pool_plain(
        zq, qn, ql, zx, xn, xlam, wl, wd, n, **kw), k, -wd)
    assert i[0, :len(ids)].tolist() == ri[0, :len(ids)].tolist()

    z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, n)
    ca, cb = ea._fit_chords(zq, qn, z_s, xn_s, wd)
    pool = ea.binned_energy_approx_pool(zq, qn, ql, ca, cb, zx, xn, xlam, wl,
                                        n, **kw)
    torch.cuda.synchronize()
    _copies_alike(pool[0], pool[1], ids, dev)
    _copies_alike(pool[2], pool[1], ids, dev)
    s, i, _ = ea._flush_rescore_certify(*pool, ql, xlam, wl, wd, k)
    assert i[0, :len(ids)].tolist() == ids
    assert bool((s[0, :len(ids)] == s[0, 0]).all())


def test_rsqrt_of_the_kernels_is_torch_rsqrt(dev):
    """K6 and K7 call rsqrtf; their plain versions call torch.rsqrt."""
    x = torch.cat([torch.logspace(-37, 38, 200001, device=dev),
                   torch.rand(100000, device=dev) * 4.0 + 1e-30])
    assert torch.equal(eb.rsqrt_probe(x), torch.rsqrt(x))


def test_cuda_energy_session_matches_cpu_float64(dev):
    """A seeded 70000 x 96 energy build on the card (K4 in its tall λ
    pass, never K2) and its exact and approx sessions (K6, K7) against
    the same index served in float64 on the CPU.  The card's projection,
    energy Laplacian and λ are carried across (convert.from_jax_state):
    a float32 and a float64 build pick different neighbours for the
    energy graph, so two builds would not index the same thing.  λ is
    held against a float64 λ pass over the card's Laplacian within 1e-5,
    scores within 1e-4 (float32 query λ and d² against float64), ids in
    99 % of the slots."""
    from arrowspace_torch.convert import from_jax_state
    from arrowspace_torch.taumode import compute_taumode_lambdas
    rng = np.random.default_rng(5)
    c = rng.uniform(0.2, 0.8, (24, 96))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05, (70_000, 96))
    k4, k2 = st.fused_select_tau.launches, tl.fused_taulambda.launches
    gpu = ArrowIndex.build_energy(rows, EnergyParams(allow_tall_graphs=True),
                                  seed=5, device=dev)
    assert st.fused_select_tau.launches > k4
    assert tl.fused_taulambda.launches == k2
    lap = gpu.gl.matrix.double().cpu()
    assert lap.shape[0] > 48                      # a tall graph: X > r
    cpu = from_jax_state(rows, gpu.lambdas, lap.numpy(), gpu.aspace.taumode,
                         projection=gpu.aspace.projection_matrix.matrix()
                         .numpy(), pad_tall_graphs=True, device="cpu",
                         dtype=torch.float64)
    lam64 = compute_taumode_lambdas(cpu.aspace.data, lap, cpu.aspace.taumode,
                                    pad_items=True)
    assert float(np.abs(gpu.lambdas - lam64.numpy()).max()) <= TOL
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    cs, ci = cpu.search_energy(queries, k=10)
    for approx in (False, True):
        counter = ea.binned_energy_approx_pool if approx \
            else eb.binned_energy_pool
        before = counter.launches
        sess = gpu.make_energy_session(batch_size=64, k=10, approx=approx)
        (gs, gi), = list(sess.search_stream([queries]))
        assert counter.launches > before
        assert float(np.abs(gs - cs).max()) <= 1e-4
        assert float(np.mean(gi == ci)) >= 0.99


# ----------------------------------------------------------------------
# The unseeded build's scan and Two-NN tile on the card, and the search
# and mutation API, against the CPU float64 port.
# ----------------------------------------------------------------------

def _blobs(seed, n, f, centres):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, 0.05, (n, f))


def _scan(rows, k_cap, radius, chunk, device_data, sampling="simple"):
    """One run of the chunked scan with an unseeded builder and a sampler
    seeded alike every time."""
    from arrowspace_torch import clustering as cl
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.sampling import SamplerType
    kind = SamplerType.simple(0.6) if sampling == "simple" \
        else SamplerType.density_adaptive(0.7)
    b = ArrowSpaceBuilder(device="cpu").with_inline_sampling(kind)
    return cl._incremental_clustering_chunked(
        b, rows, rows.shape[1], k_cap, radius, kind.make(seed=3),
        chunk=chunk, device_data=device_data)


def test_chunked_engine_on_card_matches_cpu_float64(dev, monkeypatch):
    """The chunked scan's engine on the card (float32) against the CPU
    float64 engine on 100000 x 32 clustered rows at chunk 16384, the cap
    reached in the first chunk: n_c equal; a row may be assigned
    differently only where its float64 d² at decision time lies within
    tol of radius/2, radius or 1.5·radius, its two nearest centroids lie
    within 2·tol, or its draw within float32 rounding of the keep rate
    (tol: the float32 d² error measured on the snapshots, plus the reach
    2·√d²·Δ + Δ² of the final centroid difference Δ).  The CPU engine
    equals the host path, whose per-chunk snapshots give the decision-
    time distances."""
    from arrowspace_torch import clustering as cl
    from arrowspace_torch.sampling import SamplerType
    rows = _blobs(17, 100_000, 32, 24)
    n = rows.shape[0]
    monkeypatch.setattr(cl, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
    k_cap, radius, _ = cl.compute_optimal_k(rows, n, 32, 7)
    tails = []
    tail = cl._apply_atcap_tail
    monkeypatch.setattr(cl, "_apply_atcap_tail", lambda e, c0, *a, **k:
                        tails.append(c0) or tail(e, c0, *a, **k))
    card = _scan(rows, k_cap, radius, 16384,
                 torch.as_tensor(rows, dtype=torch.float32, device=dev))
    cpu = _scan(rows, k_cap, radius, 16384, torch.as_tensor(rows))
    assert tails == [16384, 16384]
    records = []
    decide = cl._apply_chunk_decisions

    def record(rows_c, best, best_d2, offset, *a, **k):
        records.append((offset, best_d2.copy(), a[4][:a[7]["n_c"]].copy()))
        return decide(rows_c, best, best_d2, offset, *a, **k)
    monkeypatch.setattr(cl, "_apply_chunk_decisions", record)
    host = _scan(rows, k_cap, radius, 16384, None)
    np.testing.assert_allclose(cpu[0], host[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(cpu[1].array, host[1].array)
    assert card[0].shape == host[0].shape

    bd, d2nd, f32_err = np.full(n, np.nan), np.full(n, np.nan), 0.0
    for off, best_d2, snap in records:
        x = torch.as_tensor(rows[off:off + best_d2.shape[0]], device=dev)
        c = torch.as_tensor(snap, device=dev)

        def plane(x, c):
            return ((x * x).sum(1)[:, None] - 2.0 * (x @ c.T)
                    + (c * c).sum(1)[None, :]).clamp_min(0.0)
        p64 = plane(x, c)
        f32_err = max(f32_err, float((plane(x.float(), c.float()).double()
                                      - p64).abs().max()))
        bd[off:off + best_d2.shape[0]] = best_d2
        if p64.shape[1] > 1:
            d2nd[off:off + best_d2.shape[0]] = p64.topk(
                2, dim=1, largest=False).values[:, 1].cpu().numpy()
    delta = float(np.linalg.norm(card[0] - host[0], axis=1).max())
    diff = np.nonzero(card[1].array != host[1].array)[0]
    b, d = bd[diff], d2nd[diff]
    rule = np.min(np.abs(b[:, None] - radius * np.array([0.5, 1.0, 1.5])),
                  axis=1) <= f32_err + 2.0 * np.sqrt(b) * delta + delta ** 2
    tie = d - b <= 2.0 * (f32_err + 2.0 * np.sqrt(d) * delta + delta ** 2)
    draws = SamplerType.simple(0.6).make(seed=3)._rng.random(n)[diff]
    edge = (draws.astype(np.float32) < np.float32(0.6)) != (draws < 0.6)
    assert diff.size <= n // 100
    assert (rule | tie | edge).all(), diff[~(rule | tie | edge)][:5]


@pytest.mark.parametrize("sampling", ["simple", "density"])
def test_chunked_tail_reads_nothing_back(dev, monkeypatch, sampling):
    """decide_tail's loop over the at-cap windows runs with
    torch.cuda.set_sync_debug_mode("error"): a read-back inside it
    (.item(), .cpu(), bool(tensor), a boolean mask) would raise."""
    from arrowspace_torch import clustering as cl
    x = torch.ones(3, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            x.sum().item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    inner = cl._ChunkDistances._tail_windows
    calls = []

    def guarded(self, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out
    monkeypatch.setattr(cl._ChunkDistances, "_tail_windows", guarded)
    monkeypatch.setattr(cl, "DEVICE_CLUSTERING_MIN_ELEMS", 0)
    rows = _blobs(23, 40_000, 16, 12)
    cent, assign, sizes = _scan(
        rows, 8, 0.05, 4096,
        torch.as_tensor(rows, dtype=torch.float32, device=dev), sampling)
    assert calls == [1]
    assert cent.shape == (8, 16) and sum(sizes) == int((assign.array >= 0)
                                                       .sum())


def test_unseeded_build_on_card(dev):
    """ArrowIndex.build without a seed on the card at 200000 x 32 (above
    the engine's gate, and two of its 131072-row windows): the chunked
    scan's tail on the card, sizes that sum to the assigned rows, finite
    λ, a search that finds corpus rows."""
    rows = _blobs(29, 200_000, 32, 20)
    idx = ArrowIndex.build(rows, eps=1.0, device=dev)
    a, cs = idx.aspace, idx.builder.clustering_seconds
    assert not idx.builder.deterministic_clustering
    assert cs["scan_tail"] > 0.0
    assert int(a.cluster_sizes.sum()) == int((a.cluster_assignments >= 0)
                                             .sum())
    assert np.isfinite(idx.lambdas).all()
    s, i = idx.search(rows[[5, 777]], k=5, alpha=0.9)
    assert i[:, 0].tolist() == [5, 777]


def test_twonn_card_tile_matches_host_tiles(dev, monkeypatch):
    """The Two-NN tile on the card (float32) against the host tiles
    (float32) on the same sample rows, in one corpus window and in four
    with a clamped tail: the two smallest d² within 1e-3 relative and the
    estimate equal, through estimate_intrinsic_dimension's gate too."""
    from arrowspace_torch import clustering as cl
    rows = _blobs(19, 150_000, 64, 30)
    idx = cl._twonn_indices(150_000, 11)
    host = cl._twonn_two_smallest_host(rows, idx)
    data = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    for win in (1 << 20, 40_000):
        monkeypatch.setattr(cl, "TWONN_CORPUS_WIN", win)
        card = cl._twonn_two_smallest_device(data, idx)
        np.testing.assert_allclose(card, host, rtol=1e-3, atol=1e-5)
        assert cl._twonn_dimension(card, 64) == cl._twonn_dimension(host, 64)
    assert cl.estimate_intrinsic_dimension(rows, 150_000, 64, 11,
                                           device_data=data) == \
        cl.estimate_intrinsic_dimension(rows, 150_000, 64, 11)


def test_api_on_card_matches_cpu_float64(dev):
    """Hybrid search, λ-band range search and item mutation on a seeded
    70000 x 16 index on the card against the same index (its λ and
    Laplacian carried across) in float64 on the CPU: hybrid scores within
    1e-5 and ids equal outside near-ties; ranges equal; each mutation's
    row and λ within 1e-5, the one-row refresh within 1e-5 of the card's
    recompute_lambdas (K2), every other λ bitwise unchanged."""
    from arrowspace_torch.convert import from_jax_state
    from arrowspace_torch.core import ArrowItem
    rows = _blobs(5, 70_000, 16, 24)
    rows[[100, 2000]] = rows[7]
    gpu = ArrowIndex.build(rows, eps=1.0, seed=5, device=dev)
    cpu = from_jax_state(rows, gpu.lambdas, gpu.gl.matrix.double().cpu()
                         .numpy(), gpu.aspace.taumode, device="cpu",
                         dtype=torch.float64)
    for pick in (7, 11, 4321, 69_999):
        g = gpu.search_hybrid(rows[pick] * 1.02, k=10, alpha=0.8)
        c = cpu.search_hybrid(rows[pick] * 1.02, k=10, alpha=0.8)
        gs, cs = np.array([s for _, s in g]), np.array([s for _, s in c])
        assert float(np.abs(gs - cs).max()) <= TOL
        cids = [i for i, _ in c]
        for j, (i, s) in enumerate(g):
            if i != cids[j]:
                other = cs[cids.index(i)] if i in cids else cs[-1]
                assert abs(other - cs[j]) <= 2 * TOL
    lam = np.sort(gpu.lambdas)
    for lo, hi in ((lam[0], lam[500]), (lam[30_000], lam[40_000])):
        assert gpu.range(float(lo), float(hi)) == cpu.range(float(lo),
                                                            float(hi))
    q = ArrowItem(rows[3] * 1.01, float(lam[35_000]))
    assert gpu.aspace.range_search(q, gpu.gl, 0.001) == \
        cpu.aspace.range_search(q, cpu.gl, 0.001)
    before = gpu.aspace.lambdas.clone()
    for op, args in (("add_items", (40, 41)), ("mul_items", (50, 51)),
                     ("scale_item", (60, 1.5))):
        getattr(gpu.aspace, op)(*args, gpu.gl)
        getattr(cpu.aspace, op)(*args, cpu.gl)
        a = args[0]
        assert np.allclose(gpu.aspace.get_item(a).item,
                           cpu.aspace.get_item(a).item, atol=1e-6)
        assert abs(float(gpu.aspace.lambdas[a])
                   - float(cpu.aspace.lambdas[a])) <= TOL
    touched = torch.zeros(70_000, dtype=torch.bool, device=dev)
    touched[[40, 50, 60]] = True
    assert torch.equal(gpu.aspace.lambdas[~touched], before[~touched])
    refreshed = gpu.aspace.lambdas[touched].clone()
    k2 = tl.fused_taulambda.launches
    gpu.aspace.recompute_lambdas(gpu.gl)
    assert tl.fused_taulambda.launches == k2 + 1
    assert float((refreshed - gpu.aspace.lambdas[touched]).abs().max()) \
        <= TOL
    with pytest.raises(ValueError):
        gpu.search(rows[:2], k=5, precision="f64_rescore")


# ---------------------------------------------------------------------------
# K1, K3 and K6 at a row count n below the buffer's rows, as the live
# sessions launch them: the rows at and past n are poisoned with exact
# copies of the queries (they would win if scored) or with NaN.
# ---------------------------------------------------------------------------

CAP, N_LIVE = 8192, 5003


def _poison(t, n, src, fill):
    """t[n:] := the rows of ``src`` repeated, or NaN."""
    if fill == "nan":
        t[n:] = float("nan")
        return
    idx = torch.arange(t.shape[0] - n, device=t.device) % src.shape[0]
    t[n:] = src[idx]


def _poisoned_cosine(dev, f, b, fill, seed):
    rng = np.random.default_rng(seed)
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev) for a in
                    (rng.uniform(0.1, 1.0, (b, f)), rng.uniform(0, 1, b),
                     rng.uniform(0.1, 1.0, (CAP, f)), rng.uniform(0, 1, CAP)))
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(q, 0.9, dtype=torch.float32)
    _poison(xh, N_LIVE, qh / qh.norm(dim=1, keepdim=True), fill)
    _poison(xlh, N_LIVE, ql, fill)
    return q, ql, x, xl, qh, xh, xlh, c1


def _no_row_past_n(i):
    live = i != INT_MAX
    assert bool(live.any()) and int(i[live].max()) < N_LIVE


@pytest.mark.parametrize("fill", ["copies", "nan"])
@pytest.mark.parametrize("f,bins,depth", [(128, 128, 3), (40, 256, 2),
                                          (768, 512, 4)])
def test_k1_never_scores_a_row_past_n(dev, fill, f, bins, depth):
    q, ql, x, xl, qh, xh, xlh, c1 = _poisoned_cosine(dev, f, 37, fill, f)
    kw = dict(depth=depth, bins=bins, chunks=3)
    ps, pi, det = bt.binned_topk_pool(qh, ql, xh, xlh, c1, N_LIVE, **kw)
    rs, ri, rdet = bt.binned_topk_pool_plain(qh, ql, xh, xlh, c1, N_LIVE,
                                             **kw)
    torch.cuda.synchronize()
    _no_row_past_n(pi)
    assert not bool(torch.isnan(ps).any() or torch.isnan(det).any())
    _assert_scored_ids(ps, pi, rs, (qh, ql, xh, xlh, c1))
    assert torch.equal(pi == INT_MAX, ri == INT_MAX)
    assert float((det - rdet).abs().max()) <= TOL
    # the flushed top-k against the plain scan of the first n raw rows
    s, i, fl, _ = bt.binned_lambda_topk(q, ql, xh, xlh, 0.9, k=10,
                                        prepared=True, n_items=N_LIVE)
    es, ei = batched_lambda_aware_topk(q, ql, x[:N_LIVE], xl[:N_LIVE], 0.9,
                                       k=10)
    _no_row_past_n(i)
    ok = ~fl
    assert float((s - es)[ok].abs().max()) <= TOL


@pytest.mark.parametrize("fill", ["copies", "nan"])
@pytest.mark.parametrize("f,k,rows_per_chunk", [(40, 10, 1280),
                                                (128, 64, 6000),
                                                (1536, 10, 128),
                                                (128, 10, 8192)])
def test_k3_never_scores_a_row_past_n(dev, fill, f, k, rows_per_chunk):
    """K3 clamps its last chunk at n (the staged tile is zero-filled past
    it, and its candidates are masked), whatever the chunk's length."""
    q, ql, x, xl, qh, xh, xlh, c1 = _poisoned_cosine(dev, f, 19, fill, f + k)
    s, i = tk.merge_topk_partial(qh, ql, xh, xlh, c1, N_LIVE, k=k,
                                 rows_per_chunk=rows_per_chunk)
    rs, ri = tk.merge_topk_partial_plain(qh, ql, xh, xlh, c1, N_LIVE, k=k,
                                         rows_per_chunk=rows_per_chunk)
    torch.cuda.synchronize()
    _no_row_past_n(i)
    assert not bool(torch.isnan(s).any())
    _assert_scored_ids(s, i, rs, (qh, ql, xh, xlh, c1))
    assert torch.equal(i == INT_MAX, ri == INT_MAX)
    fs, fi = tk.fused_lambda_topk(q, ql, xh, xlh, 0.9, k=k, prepared=True,
                                  n_items=N_LIVE)
    es, _ = batched_lambda_aware_topk(q, ql, x[:N_LIVE], xl[:N_LIVE], 0.9,
                                      k=k)
    _no_row_past_n(fi)
    assert float((fs - es).abs().max()) <= TOL


@pytest.mark.parametrize("fill", ["copies", "nan"])
@pytest.mark.parametrize("g,bins,depth", [(64, 128, 3), (40, 256, 2),
                                          (384, 512, 4)])
def test_k6_never_scores_a_row_past_n(dev, fill, g, bins, depth):
    zq, qn, ql, zx, xn, xlam = _energy_inputs(dev, CAP, g, 37, seed=g + bins)
    _poison(zx, N_LIVE, zq, fill)
    _poison(xn, N_LIVE, qn, fill)
    _poison(xlam, N_LIVE, ql, fill)
    kw = dict(depth=depth, bins=bins, chunks=3)
    ps, pi, det = eb.binned_energy_pool(zq, qn, ql, zx, xn, xlam, 1.0, 0.5,
                                        N_LIVE, **kw)
    rs, ri, rdet = eb.binned_energy_pool_plain(zq, qn, ql, zx, xn, xlam, 1.0,
                                               0.5, N_LIVE, **kw)
    torch.cuda.synchronize()
    _no_row_past_n(pi)
    assert not bool(torch.isnan(ps).any() or torch.isnan(det).any())
    assert float((ps - rs).abs().max()) <= TOL
    assert float((det - rdet).abs().max()) <= TOL
    assert torch.equal(pi == INT_MAX, ri == INT_MAX)
    live = pi != INT_MAX
    exact = _f64_energy(zq, ql, zx, xlam, 1.0, 0.5, pi)
    assert float((exact - ps.double())[live].abs().max()) <= TOL
    s, i, fl, _ = eb.binned_energy_topk(zq, ql, zx, xlam, xn, 1.0, 0.5, k=10,
                                        n=N_LIVE)
    es, _ = eb.energy_topk_chunked(zq, ql, zx[:N_LIVE], xlam[:N_LIVE], 1.0,
                                   0.5, k=10)
    _no_row_past_n(i)
    assert float((s - es)[~fl].abs().max()) <= TOL


def _live_blobs(seed):
    rows = _blobs(seed, 70_000, 16, 24)
    rows[[100, 2000]] = rows[7]
    return rows


def test_live_session_on_card_after_mutations(dev):
    """A live cosine session on the card (K1 at n_live below the buffer's
    rows; the strided repair and K3 on flagged rows): an added copy of a
    row gets its prepared row bitwise and, at α = 1, its score bitwise;
    after deletes the rows past n_live are stale and then poisoned with
    copies of the queries, and the results still equal the plain scan of
    the live rows through the external ids."""
    rows = _live_blobs(31)
    idx = ArrowIndex.build(rows, eps=1.0, seed=5, device=dev)
    sess = idx.make_live_session(batch_size=64, k=10, alpha=1.0,
                                 capacity=70_000 + 4096)
    assert sess.kernel == "binned"
    (cid,) = sess.add(rows[1234])
    pc = sess._pos[int(cid)]
    assert torch.equal(sess._xhat[pc], sess._xhat[1234])
    s, i = sess.search(rows[1234] * 1.01)
    hit = list(i[0])
    assert hit.index(1234) < hit.index(int(cid))
    assert s[0][hit.index(1234)] == s[0][hit.index(int(cid))]
    k1 = bt.binned_topk_pool.launches
    sess.delete(list(range(0, 70_000, 7)))
    n = sess.nitems
    q = rows[np.random.default_rng(3).integers(0, 70_000, 64)] * 1.02
    _poison(sess._xhat, n, torch.nn.functional.normalize(
        torch.as_tensor(q, dtype=torch.float32, device=dev)), "copies")
    s, i = sess.search(q)
    assert bt.binned_topk_pool.launches > k1
    qt = torch.as_tensor(q, dtype=torch.float32, device=dev)
    _, qlam = sess._prepare(qt)
    es, ei = batched_lambda_aware_topk(qt, qlam, sess._raw[:n],
                                       sess._lam[:n], 1.0, k=10)
    assert float(np.abs(s - es.cpu().numpy()).max()) <= TOL

    def cos64(ext):
        pos = torch.as_tensor([[sess._pos[int(e)] for e in r] for r in ext],
                              device=dev)
        assert int(pos.max()) < n
        x = torch.nn.functional.normalize(sess._raw[pos].double(), dim=-1)
        qn = torch.nn.functional.normalize(qt.double(), dim=-1)
        return (x * qn[:, None, :]).sum(-1)
    ref = sess._ids[ei.cpu().numpy()]
    gap = (cos64(i) - cos64(ref)).abs()[torch.as_tensor(i != ref,
                                                        device=dev)]
    assert gap.numel() == 0 or float(gap.max()) <= 2 * TOL


def test_live_energy_session_on_card_after_mutations(dev):
    """A live energy session on the card (K6 at n_live below the buffer's
    rows) over a 16-wide energy index (no projection): with w_λ = 0 an
    added copy of row r scores bitwise as row r; after deletes, poisoned
    rows past n_live change nothing and the results equal the plain
    chunked scan of the live rows."""
    rows = _live_blobs(37)
    idx = ArrowIndex.build_energy(rows, EnergyParams(allow_tall_graphs=True),
                                  seed=5, device=dev)
    assert idx.aspace.projection_matrix is None
    sess = idx.make_live_energy_session(batch_size=64, k=10, w_lambda=0.0,
                                        capacity=70_000 + 4096)
    assert sess.kernel == "binned"
    (cid,) = sess.add(rows[4321])
    e, pc = sess.engine, sess._pos[int(cid)]
    assert torch.equal(e.zx[pc], e.zx[4321]) and torch.equal(e.xn[pc],
                                                             e.xn[4321])
    s, i = sess.search(rows[4321])
    hit = list(i[0])
    assert hit.index(4321) < hit.index(int(cid))
    assert s[0][hit.index(4321)] == s[0][hit.index(int(cid))]
    sess.delete(list(range(0, 70_000, 5)))
    n = sess.nitems
    q = rows[np.random.default_rng(4).integers(0, 70_000, 64)] * 1.02
    qt = torch.as_tensor(q, dtype=torch.float32, device=dev)
    z_q, qlam = sess._prepare(qt)
    zc = e.centred(z_q)
    _poison(e.zx, n, zc, "copies")
    _poison(e.xn, n, (zc * zc).sum(dim=1), "copies")
    _poison(e.xlam, n, qlam, "copies")
    k6 = eb.binned_energy_pool.launches
    s, i = sess.search(q)
    assert eb.binned_energy_pool.launches > k6
    es, ei = eb.energy_topk_chunked(zc, qlam, e.zx[:n], e.xlam[:n], 0.0, 0.5,
                                    k=10)
    e_tol = 5e-5          # d² of near duplicates, as chip_smoke.py's E_TOL
    assert float(np.abs(s - es.cpu().numpy()).max()) <= e_tol

    def u64(ext):
        pos = torch.as_tensor([[sess._pos[int(e)] for e in r] for r in ext],
                              device=dev)
        assert int(pos.max()) < n
        d = (zc.double()[:, None, :] - e.zx[pos].double()).norm(dim=-1)
        return 0.5 / (1.0 + d)
    ref = sess._ids[ei.cpu().numpy()]
    gap = (u64(i) - u64(ref)).abs()[torch.as_tensor(i != ref, device=dev)]
    assert gap.numel() == 0 or float(gap.max()) <= 2 * e_tol


# ----------------------------------------------------------------------
# The pruned sessions' screens and the out-of-core streaming on the card.
# ----------------------------------------------------------------------

def _cell_arrays(c):
    return (c.x, c.lam, c.ids, c.cent, c.radius, c.cosr, c.sinr, c.lam_lo,
            c.lam_hi)


def _cells_to(cells, dev):
    from arrowspace_torch.pruned import PrunedCells
    return PrunedCells(*(getattr(cells, f).to(dev) for f in (
        "x", "lam", "ids", "cent", "radius", "cosr", "sinr", "lam_lo",
        "lam_hi")), cap=cells.cap, n_units=cells.n_units)


def _screen_inputs(seed, n=6000, f=40, centres=40):
    """Float32 rows, λ, their host-built cells (cap 32, on the CPU), and
    two query batches with λ: 16 perturbed corpus rows and 64 around three
    hot rows (the union's regime), each led by 4 Gaussian queries, which
    flag."""
    from arrowspace_torch.pruned import build_cells
    rng = np.random.default_rng(seed)
    rows = _blobs(seed, n, f, centres).astype(np.float32)
    lam = rng.uniform(0, 1, n).astype(np.float32)
    cells = build_cells(rows, lam, cap=32, seed=1, iters=4, device="cpu")
    q16 = rows[rng.integers(0, n, 16)] * 1.02
    hot = [5, n // 2, n - 7]
    q64 = np.repeat(rows[hot], 22, axis=0)[:64] \
        * (1.0 + 0.02 * rng.uniform(size=(64, 1)))
    batches = []
    for q in (q16, q64):
        q[:4] = rng.normal(size=(4, f))
        batches.append((torch.as_tensor(q.astype(np.float32)),
                        torch.as_tensor(lam[:q.shape[0]])))
    return rows, lam, cells, batches


def _same_screen(out, ref, xhat, xlam, q, ql):
    """A screen's card output against its CPU run.  Rows certified on
    both sides: scores within TOL, and an id may differ only where both
    ids' float64 scores lie within 2·TOL (a near-tie).  Returns the
    number of rows flagged on one side only (bound or k-th score near
    the margin, or a near-tie in the unit order)."""
    s, i, fl = (t.cpu() for t in out)
    rs, ri, rfl = ref
    both = ~fl & ~rfl
    assert float((s - rs)[both].abs().max()) <= TOL
    qh = torch.nn.functional.normalize(q.double(), dim=-1)

    def f64(ids):
        ids = ids.long()
        return 0.9 * (xhat[ids] * qh[:, None, :]).sum(-1) - 0.1 * (
            ql.double()[:, None] - xlam[ids]).abs().clamp_max(1.0)
    gap = (f64(i) - f64(ri)).abs()[both[:, None] & (i != ri)]
    assert gap.numel() == 0 or float(gap.max()) <= 2 * TOL
    return int((fl != rfl).sum())


def test_pruned_screens_on_card_match_cpu(dev):
    """pruned_topk (B = 16) and pruned_topk_union (B = 64) on the card
    (the batched product, the unit gather, the extraction) against their
    CPU run on the same float32 cells and queries."""
    from arrowspace_torch.pruned import pruned_topk, pruned_topk_union
    rows, lam, cells, batches = _screen_inputs(41)
    xhat = torch.nn.functional.normalize(torch.as_tensor(rows).double(),
                                         dim=-1)
    xlam = torch.as_tensor(lam).double()
    gc = _cells_to(cells, dev)
    for (q, ql), fn, kw in zip(batches, (pruned_topk, pruned_topk_union),
                               (dict(m_cells=8), dict(m_vote=6,
                                                      s_cells=60))):
        ref = fn(q, ql, *_cell_arrays(cells), 0.9, k=10, cap=32,
                 margin=1e-3, **kw)
        out = fn(q.to(dev), ql.to(dev), *_cell_arrays(gc), 0.9, k=10,
                 cap=32, margin=1e-3, **kw)
        assert _same_screen(out, ref, xhat, xlam, q, ql) <= 1
        assert bool(ref[2][:4].all())               # the Gaussian queries
        assert int(ref[2][4:].sum()) <= 2           # the rest certify


def test_pruned_duplicate_rows_tie_bitwise_on_card(dev):
    """Copies of a row in several units of a gathered set score bitwise
    alike in the per-query product (bmm) and the union's (matmul), and
    come back in ascending id order (cap 4 spreads them over units)."""
    from arrowspace_torch.pruned import (build_cells, pruned_topk,
                                         pruned_topk_union)
    rows = _blobs(43, 4000, 40, 160).astype(np.float32)
    copies = [17, 900, 1800, 2500, 3999]
    rows[copies] = rows[321]
    lam = np.random.default_rng(43).uniform(0, 1, 4000).astype(np.float32)
    lam[copies] = lam[321]
    cells = _cells_to(build_cells(rows, lam, cap=4, seed=2, iters=4,
                                  device="cpu"), dev)
    units = {int(u) for u in torch.nonzero(torch.isin(
        cells.ids, torch.tensor(copies + [321], device=dev,
                                dtype=torch.int32)))[:, 0] // 4}
    assert len(units) >= 2
    u = cells.cent.shape[0]
    q = torch.as_tensor(np.repeat(rows[321:322] * 1.01, 20, axis=0),
                        device=dev)
    ql = torch.as_tensor(np.repeat(lam[321:322], 20), device=dev)
    arrays = _cell_arrays(cells)
    for s, i, fl in (
            pruned_topk(q[:8], ql[:8], *arrays, 0.9, k=10, m_cells=u,
                        cap=4, margin=1e-3),
            pruned_topk_union(q, ql, *arrays, 0.9, k=10, m_vote=8,
                              s_cells=u, cap=4, margin=1e-3)):
        assert not bool(fl.any())
        top = i[0, :6].tolist()
        assert top == sorted(copies + [321])
        assert bool((s[0, :6] == s[0, 0]).all())


def test_device_build_zero_row_on_card(dev):
    """The device build on the card, float32, of a corpus with a zero row
    and an anti-aligned query (the zero row is the true top-1): its cap
    keeps the zero vector, and the certified top-1 is the host build's
    and the full scan's."""
    from arrowspace_torch.pruned import (build_cells, build_cells_device,
                                         pruned_topk)
    rng = np.random.default_rng(91)
    f = 8
    u = np.zeros(f)
    u[:4] = 0.5
    w = 0.3 * u + np.sqrt(1 - 0.09) * np.eye(f)[7]
    rows = np.vstack([u + rng.normal(0, 0.01, (30, f)),
                      w + rng.normal(0, 0.01, (30, f))]).astype(np.float32)
    rows[5] = 0.0
    lam = rng.uniform(0, 1, 60).astype(np.float32)
    kw = dict(cap=64, seed=2, n_clusters=2, iters=4)
    host = build_cells(rows, lam, device=dev, **kw)
    card = build_cells_device(torch.as_tensor(rows, device=dev),
                              torch.as_tensor(lam, device=dev), **kw)
    assert torch.equal(card.ids, host.ids)
    q = torch.as_tensor(-u[None, :], dtype=torch.float32, device=dev)
    ql = torch.as_tensor(lam[:1], device=dev)
    for c in (host, card):
        s, i, fl = pruned_topk(q, ql, *_cell_arrays(c), 1.0, k=1,
                               m_cells=1, cap=64, margin=1e-3)
        assert not bool(fl[0]) and int(i[0, 0]) == 5
    zero_unit = int(torch.nonzero(card.ids == 5)[0, 0]) // 64
    assert float(card.cosr[zero_unit]) <= 0.0


def test_pruned_session_on_card_matches_full_scan(dev):
    """A B = 16 and a B = 64 (union) session on a 70000-row card index:
    flagged rows re-run through K1 with its repair (the launches grow),
    and every result equals the plain full scan within TOL, ids outside
    near-ties."""
    rows = _blobs(47, 70_000, 16, 24)
    idx = ArrowIndex.build(rows, eps=1.0, seed=5, device=dev)
    a = idx.aspace
    rng = np.random.default_rng(47)
    for b in (16, 64):
        sess = idx.make_pruned_session(batch_size=b, k=10, alpha=0.9,
                                       engine="device")
        q = rows[rng.integers(0, 70_000, b)] * 1.02
        q[0] = rng.normal(size=16)
        k1 = bt.binned_topk_pool.launches
        s, i = sess.search(q)
        assert sess.flagged_total >= 1
        assert bt.binned_topk_pool.launches > k1 or dev.type == "cpu"
        qt = torch.as_tensor(q, dtype=torch.float32, device=dev)
        _, qlam = sess._prepare(qt)
        es, ei = batched_lambda_aware_topk(qt, qlam, a.data, a.lambdas, 0.9,
                                           k=10)
        assert float(np.abs(s - es.cpu().numpy()).max()) <= TOL
        xh = torch.nn.functional.normalize(a.data.double(), dim=-1)
        qh = torch.nn.functional.normalize(qt.double(), dim=-1)

        def score(ids):
            ids = torch.as_tensor(ids, device=dev)
            return 0.9 * (xh[ids] * qh[:, None, :]).sum(-1) - 0.1 * (
                qlam.double()[:, None] - a.lambdas[ids].double()
            ).abs().clamp_max(1.0)
        diff = torch.as_tensor(i != ei.cpu().numpy(), device=dev)
        gap = (score(i) - score(ei.cpu().numpy())).abs()[diff]
        assert gap.numel() == 0 or float(gap.max()) <= 2 * TOL


def test_double_buffered_streaming_matches_single_stream(dev):
    """The streamed λ (K2 per chunk) and top-k (K1 with its repair per
    chunk, the 2464-row tail through the plain scan) with the copies on a
    side stream equal, bitwise, the same calls copying on the compute
    stream; the profile covers every chunk."""
    from arrowspace_torch.ops.streaming import (streamed_lambda_topk,
                                                streamed_taumode_lambdas)
    rows = _blobs(53, 3 * 65_536 + 2464, 64, 24).astype(np.float32)
    rng = np.random.default_rng(53)
    w = np.triu(rng.uniform(0.1, 1, (64, 64)) * (rng.uniform(
        size=(64, 64)) < 0.1), 1)
    lap = np.diag((w + w.T).sum(axis=1)) - (w + w.T)
    q = rows[rng.integers(0, rows.shape[0], 32)] * 1.02
    runs = []
    for double in (True, False):
        prof = {}
        lam = streamed_taumode_lambdas(rows, lap, TauMode.median(),
                                       chunk=65_536, device=dev,
                                       double_buffer=double, profile=prof)
        s, i = streamed_lambda_topk(q, lam[:32], rows, lam, 0.9, 10,
                                    chunk=65_536, device=dev,
                                    double_buffer=double)
        runs.append((lam, s, i))
        if double and dev.type == "cuda":
            assert prof["chunks"] == 4 and prof["bytes"] == rows.nbytes
            assert 0.0 <= prof["hidden_share"] <= 1.0 + 1e-6
            assert prof["upload_gb_s"] > 0
    for a, b in zip(*runs):
        assert np.array_equal(a, b)
    es, ei = batched_lambda_aware_topk(
        torch.as_tensor(q, device=dev), torch.as_tensor(runs[0][0][:32],
                                                        device=dev),
        torch.as_tensor(rows, device=dev),
        torch.as_tensor(runs[0][0], device=dev), 0.9, k=10)
    assert float(np.abs(runs[0][1] - es.cpu().numpy()).max()) <= TOL


def test_pruned_graph_replay_matches_eager(dev):
    """The session's step replayed as a CUDA graph gives bitwise the
    eager step's results, at B = 16 and through the union at B = 64,
    and again after an auto-budget growth recaptures it."""
    from arrowspace_torch.pruned import PrunedSearchSession
    rows = _blobs(59, 70_000, 16, 24)
    idx = ArrowIndex.build(rows, eps=1.0, seed=5, device=dev)
    rng = np.random.default_rng(59)
    for b, kw in ((16, {}), (64, dict(union_cells=2, auto_budget=True))):
        graph = idx.make_pruned_session(batch_size=b, k=10, **kw)
        eager = PrunedSearchSession(idx, b, k=10, cells=graph.cells,
                                    cuda_graph=False, **kw)
        assert graph.cuda_graph == (dev.type == "cuda")
        graph.auto_window = eager.auto_window = b
        for _ in range(3):
            q = rows[rng.integers(0, 70_000, b)] * 1.02
            for a, e in zip(graph.search(q), eager.search(q)):
                assert np.array_equal(a, e)
            assert (graph.m_cells, graph.union_cells) == \
                (eager.m_cells, eager.union_cells)
        if kw:
            assert graph.budget_growths >= 1


# ------------------------------------------------------------------ mesh

def _mesh_storm(f=32, shard_n=65536, shards=4, seed=53):
    """A clustered corpus of shards x shard_n rows with the copies that
    make batch row 0 flag on shard 1 (depth + 2 copies in one local bin:
    the strided mesh repair) and row 1 overflow MAX_FIRED (depth + 1
    copies in three bins of shards 2 and 3: the exact pass, K3)."""
    from arrowspace_torch.ops.bin_repair import MAX_FIRED
    rows = _blobs(seed, shards * shard_n, f, 32)
    bins, depth = bt.bins_target(10), bt.binned_topk_depth_for(10)
    for j in range(depth + 2):
        rows[shard_n + 7 + j * bins] = rows[0]
    for s, b in ((2, 11), (2, 90), (3, 11))[:MAX_FIRED + 1]:
        for j in range(depth + 1):
            rows[s * shard_n + b + j * bins] = rows[1]
    return rows


def _same_or_near(s, i, ref_s, ref_i, score):
    """Scores within TOL; ids equal wherever the two sides' float64
    scores are not tied within 2·TOL."""
    assert float(np.abs(s - ref_s).max()) <= TOL
    diff = i != ref_i
    if diff.any():
        gap = np.abs(score(i) - score(ref_i))[diff]
        assert float(gap.max()) <= 2 * TOL


@pytest.mark.parametrize("kernel", ["binned", "merge"])
def test_mesh_session_on_card_matches_one_shard_and_cpu(dev, kernel):
    """A 4-shard mesh on cuda:0 (K1 or K3 per shard, the binned one's
    flagged rows through the strided mesh repair and its K3 exact pass)
    against a 1-shard mesh on the card and the same 4-shard session in
    float64 on the CPU."""
    from arrowspace_torch import parallel as par
    from arrowspace_torch.ops import bin_repair as br
    from arrowspace_torch.taumode import (select_tau_batch,
                                          synthetic_lambda_batch)
    rows = _mesh_storm()
    idx = ArrowIndex.build(rows, eps=1.0, seed=5, device=dev)
    a = idx.aspace
    q = rows[[0, 1] + list(range(2, 2 * 64, 2))[:62]] * 1.02
    outs = {}
    for name, mesh_devs, device, dt in (
            ("card4", [dev] * 4, dev, torch.float32),
            ("card1", [dev], dev, torch.float32),
            ("cpu64", ["cpu"] * 4, "cpu", torch.float64)):
        mesh = par.make_mesh(devices=mesh_devs)
        x = a.data.to(device=device, dtype=dt)
        lam = a.lambdas.to(device=device, dtype=dt)
        sess = par.DistributedSearchSession(
            x, lam, idx.gl.matrix.to(device=device, dtype=dt), mesh,
            batch_size=64, k=10, alpha=0.9, taumode=a.taumode,
            kernel=kernel)
        k1, k3 = bt.binned_topk_pool.launches, tk.merge_topk_partial.launches
        rep = br.strided_lambda_repair.calls
        (s, i), = list(sess.search_stream([q]))
        outs[name] = (s, i, bt.binned_topk_pool.launches - k1,
                      tk.merge_topk_partial.launches - k3,
                      br.strided_lambda_repair.calls - rep)
    s4, i4, l1, l3, reps = outs["card4"]
    if kernel == "binned":
        # the overflowing row's exact pass is K3 per shard
        assert l1 == 4 and reps == 1 and l3 == 4
    else:
        assert l1 == 0 and l3 == 4
    qt = torch.as_tensor(q, dtype=torch.float64)
    lap = idx.gl.matrix.double().cpu()
    qlam = synthetic_lambda_batch(qt, lap, select_tau_batch(qt, a.taumode))
    xh = torch.nn.functional.normalize(a.data.double().cpu(), dim=-1)
    qh = torch.nn.functional.normalize(qt, dim=-1)
    lam64 = a.lambdas.double().cpu()

    def score(ids):
        ids = torch.as_tensor(ids)
        return (0.9 * (xh[ids] * qh[:, None, :]).sum(-1) + 0.1 * (
            1.0 - (qlam[:, None] - lam64[ids]).abs().clamp_max(1.0))).numpy()
    for ref in ("card1", "cpu64"):
        _same_or_near(s4, i4, outs[ref][0], outs[ref][1], score)
    assert list(i4[0][:5]) == [0] + [65536 + 7 + j * 128 for j in range(4)]


def test_mesh_energy_session_on_card_matches_cpu(dev):
    """A 4-shard energy mesh session on cuda:0 (K6 per shard, the mesh
    energy repair) against the same session in float64 on the CPU."""
    from arrowspace_torch import parallel as par
    from arrowspace_torch.ops import bin_repair as br
    rows = _mesh_storm(f=32)
    lam = np.full(rows.shape[0], 0.3)          # rank by distance alone
    lap = torch.as_tensor(_graph(32, 5), dtype=torch.float64)
    q = rows[[0, 1] + list(range(3, 3 * 128, 3))[:126]] * 1.02
    outs = {}
    for name, mesh_devs, dt in (("card4", [dev] * 4, torch.float32),
                                ("cpu64", ["cpu"] * 4, torch.float64)):
        mesh = par.make_mesh(devices=mesh_devs)
        d = mesh.first_device
        sess = par.DistributedEnergySearchSession(
            torch.as_tensor(rows).to(d, dt), torch.as_tensor(lam).to(d, dt),
            lap.to(d, dt), mesh, batch_size=128, k=10, kernel="binned",
            taumode=TauMode.median())
        k6 = eb.binned_energy_pool.launches
        rep = br.strided_energy_repair.calls
        (s, i), = list(sess.search_stream([q]))
        outs[name] = (s, i, eb.binned_energy_pool.launches - k6,
                      br.strided_energy_repair.calls - rep)
    s4, i4, l6, reps = outs["card4"]
    assert l6 == 4 and reps == 1
    s64, i64, _, _ = outs["cpu64"]
    assert float(np.abs(s4 - s64).max()) <= 5e-5
    assert float(np.mean(i4 == i64)) >= 0.99
    assert list(i4[0][:5]) == list(i64[0][:5])


# bf16 modes of K1 and K3 (asp_bintopk_bf16, asp_merge_topk_bf16): the
# kernels multiply bf16 operands, exact products accumulated in float32,
# so they are held to their plain versions (the same bf16 operands in a
# float32 product) and to float64 scores of those operands within TOL.

def _inputs_bf16(dev, n, f, b, seed):
    """The bf16 operands of a random corpus and batch, as the wrappers
    make them: (qhat, qlam, xhat, xlam, c1), F padded to a multiple of
    8."""
    from arrowspace_torch.ops.search import operand_query
    rng = np.random.default_rng(seed)
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in (rng.uniform(0.1, 1.0, (b, f)),
                              rng.uniform(0, 1, b),
                              rng.uniform(0.1, 1.0, (n, f)),
                              rng.uniform(0, 1, n)))
    xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    return qh, ql, xh, xlh, c1


@pytest.mark.parametrize("f", [128, 40, 7, 768, 1536, 8, 72, 136, 1000])
@pytest.mark.parametrize("bins,depth", [(128, 3), (256, 2), (512, 4)])
def test_k1_bf16_pool_matches_plain(dev, f, bins, depth):
    n, b = 5003, 37
    args = _inputs_bf16(dev, n, f, b, seed=f + bins)
    assert args[0].dtype == torch.bfloat16 and args[0].shape[1] % 8 == 0
    f32, b16 = bt.binned_topk_pool.launches, bt.binned_topk_pool.launches_bf16
    kw = dict(depth=depth, bins=bins, chunks=3)
    ps, pi, det = bt.binned_topk_pool(*args, n, **kw)
    rs, ri, rdet = bt.binned_topk_pool_plain(*args, n, **kw)
    torch.cuda.synchronize()
    assert bt.binned_topk_pool.launches_bf16 == b16 + 1
    assert bt.binned_topk_pool.launches == f32
    assert ps.dtype == torch.float32 and ps.shape == rs.shape
    _assert_scored_ids(ps, pi, rs, args)
    assert torch.equal(pi == INT_MAX, ri == INT_MAX)
    assert float((det - rdet).abs().max()) <= TOL


def _k1_bf16_vs_plain(args, n, **kw):
    ps, pi, det = bt.binned_topk_pool(*args, n, **kw)
    rs, ri, rdet = bt.binned_topk_pool_plain(*args, n, **kw)
    torch.cuda.synchronize()
    assert ps.shape == rs.shape and det.shape == rdet.shape
    _assert_scored_ids(ps, pi, rs, args)
    assert torch.equal(pi == INT_MAX, ri == INT_MAX)
    assert float((det - rdet).abs().max()) <= TOL
    return ps, pi, det


@pytest.mark.parametrize("f", [136, 768, 1536])
@pytest.mark.parametrize("b", [1, 63, 2048])
def test_k1_bf16_partial_and_full_query_blocks(dev, f, b):
    """A batch below one query block (the rows past B arrive as zeros
    from the query map and are never written), one short of 64, and a
    full 2048-query batch, at F on both sides of the 128-query block's
    limit (768: 128, 8 stages; 1536: 64, 4 stages)."""
    n = 5003
    args = _inputs_bf16(dev, n, f, b, seed=f + b)
    cfg = bt.bf16_config(f, b, 3)
    assert cfg["query_block"] == bt.query_block(f, b, True)
    _k1_bf16_vs_plain(args, n, depth=3, bins=128, chunks=3)


@pytest.mark.parametrize("n", [1, 31, 33, 130])
@pytest.mark.parametrize("f", [72, 1536])
def test_k1_bf16_fewer_rows_than_a_stage(dev, n, f):
    """A corpus of fewer rows than one stage's 32 or 64 bins (and than
    one tile): the stage's rows past n arrive as zeros and never enter a
    pool."""
    args = _inputs_bf16(dev, n, f, 70, seed=n + f)
    for bins, depth in ((128, 3), (512, 4)):
        _k1_bf16_vs_plain(args, n, depth=depth, bins=bins, chunks=2)


def test_k1_bf16_chunks_without_tiles(dev):
    """Chunks past the last tile (steps == 0: no copy is started) hold
    empty pools, NEG_INF det and INT_MAX ids; the others equal the plain
    version's pools at their own chunking."""
    n, b, f, bins, depth = 300, 40, 136, 128, 3
    qh, ql, xh, xlh, c1 = _inputs_bf16(dev, n, f, b, seed=5)
    chunks = 5                          # 3 tiles, one a chunk, 2 empty
    shape = (b, chunks, depth, bins)
    ps = torch.empty(shape, device=dev)
    pi = torch.empty(shape, device=dev, dtype=torch.int32)
    det = torch.empty((b, chunks, bins), device=dev)
    rc = lib().asp_bintopk_bf16(
        qh.data_ptr(), ql.data_ptr(), xh.data_ptr(), xlh.data_ptr(), c1, n,
        b, f, bins, depth, chunks, 1, ps.data_ptr(), pi.data_ptr(),
        det.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    rs, ri, rdet = bt.binned_topk_pool_plain(qh, ql, xh, xlh, c1, n,
                                             depth=depth, bins=bins,
                                             chunks=3)
    _assert_scored_ids(ps[:, :3], pi[:, :3], rs, (qh, ql, xh, xlh, c1))
    assert torch.equal(pi[:, :3] == INT_MAX, ri == INT_MAX)
    assert float((det[:, :3] - rdet).abs().max()) <= TOL
    assert bool((ps[:, 3:] == NEG_INF).all())
    assert bool((pi[:, 3:] == INT_MAX).all())
    assert bool((det[:, 3:] == NEG_INF).all())


@pytest.mark.parametrize("fill", ["copies", "nan", "huge"])
@pytest.mark.parametrize("f,bins,depth", [(136, 128, 3), (40, 256, 2),
                                          (1536, 512, 4)])
def test_k1_bf16_never_scores_a_row_past_n(dev, fill, f, bins, depth):
    """A capacity buffer whose rows past n hold copies of the queries,
    NaN or 1e30 (in bf16): the corpus map ends at row n, so none of them
    reaches a score, a pool or det."""
    from arrowspace_torch.ops.search import operand_query
    rng = np.random.default_rng(f + bins)
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev) for a in
                    (rng.uniform(0.1, 1.0, (37, f)), rng.uniform(0, 1, 37),
                     rng.uniform(0.1, 1.0, (CAP, f)), rng.uniform(0, 1, CAP)))
    xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    if fill == "huge":
        xh[N_LIVE:], xlh[N_LIVE:] = 1e30, 1e30
    else:
        _poison(xh, N_LIVE, qh / qh.float().norm(dim=1, keepdim=True).to(
            qh.dtype), fill)
        _poison(xlh, N_LIVE, ql, fill)
    ps, pi, det = _k1_bf16_vs_plain((qh, ql, xh, xlh, c1), N_LIVE,
                                    depth=depth, bins=bins, chunks=3)
    _no_row_past_n(pi)
    assert bool(torch.isfinite(ps).all() and torch.isfinite(det).all())


def test_k1_bf16_config_matches_the_wrapper_rule(dev):
    """The library's account of each launch (query block, stages, shared
    bytes) is the wrapper's rule, every instantiation keeps its state in
    registers (no spilled bytes) with 256 threads, and a launch that the
    rule refuses (F = 2048: no 3-stage ring beside the 64-query block)
    raises from the wrapper instead of falling back."""
    for f in (8, 136, 768, 832, 896, 1536):
        for b in (1, 2048):
            for depth in (2, 3, 4):
                cfg = bt.bf16_config(f, b, depth)
                qb = bt.query_block(f, b, True)
                assert cfg["query_block"] == qb
                assert cfg["stages"] == bt.bf16_stages(f, qb)
                assert cfg["smem_bytes"] == bt._bintopk_smem(f, qb, True)
                assert cfg["spill_bytes"] == 0
                assert cfg["max_threads"] >= 256
    args = _inputs_bf16(dev, 600, 2048, 4, seed=3)
    assert bt.bf16_config(2048, 4, 3)["stages"] < 3
    with pytest.raises(ValueError):          # the wrapper's gate
        bt.binned_topk_pool(*args, 600, depth=3, bins=128, chunks=1)
    mp = pytest.MonkeyPatch()                # past the gate: the library's
    mp.setattr(bt, "bintopk_fits", lambda f, use_bf16=False: True)
    try:
        with pytest.raises(RuntimeError):
            bt.binned_topk_pool(*args, 600, depth=3, bins=128, chunks=1)
    finally:
        mp.undo()


@pytest.mark.parametrize("f", [128, 768])
def test_k1_bf16_rows_rounding_alike_tie_by_id(dev, f):
    """Distinct float32 rows whose bf16 unit rows are equal score bitwise
    alike in K1's bf16 mode and come back in ascending id order, as in
    its plain version."""
    n, b, chunks = 5003, 19, 3
    rng = np.random.default_rng(f)
    q, ql = rng.uniform(0.1, 1.0, (b, f)), rng.uniform(0, 1, b)
    x, xl = rng.uniform(0.1, 1.0, (n, f)), rng.uniform(0, 1, n)
    ids = [3, 38, 1700, 1828, 4000, 4999]
    x[ids] = q[0] * (1.0 + 1e-6 * rng.standard_normal((len(ids), f)))
    xl[ids] = ql[0]
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in (q, ql, x, xl))
    xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
    from arrowspace_torch.ops.search import operand_query
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    assert not torch.equal(x[ids[0]], x[ids[1]])
    assert bool((xh[ids] == xh[ids[0]]).all())
    args = (qh, ql, xh, xlh, c1, n)
    kw = dict(depth=3, bins=128, chunks=chunks)
    s, i, _, _ = bt.flush_pool(*bt.binned_topk_pool(*args, **kw), 10, c1)
    rs, ri, _, _ = bt.flush_pool(*bt.binned_topk_pool_plain(*args, **kw),
                                 10, c1)
    torch.cuda.synchronize()
    assert i[0, :len(ids)].tolist() == ids == ri[0, :len(ids)].tolist()
    assert bool((s[0, :len(ids)] == s[0, 0]).all())


@pytest.mark.parametrize("f", [8, 40, 768, 1536, 1544, 2048, 3072])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_k3_bf16_partial_matches_plain(dev, f, k):
    """K3's bf16 mode with the query block resident or streamed with
    each stage, rings of 3 to 8 stages, B = 70 (a ragged 64-query block),
    n = 5003 (a ragged tile), at the wrapper's own chunking."""
    n, b = 5003, 70
    args = _inputs_bf16(dev, n, f, b, seed=f + k)
    rpc = tk._chunk_rows(b, n, dev, k, True, f)
    f32, b16 = (tk.merge_topk_partial.launches,
                tk.merge_topk_partial.launches_bf16)
    s, i = tk.merge_topk_partial(*args, n, k=k, rows_per_chunk=rpc)
    rs, ri = tk.merge_topk_partial_plain(*args, n, k=k, rows_per_chunk=rpc)
    torch.cuda.synchronize()
    assert tk.merge_topk_partial.launches_bf16 == b16 + 1
    assert tk.merge_topk_partial.launches == f32
    assert s.shape == rs.shape == (b, -(-n // rpc), k)
    _assert_scored_ids(s, i, rs, args)
    assert torch.equal(i == INT_MAX, ri == INT_MAX)


@pytest.mark.parametrize("f", [128, 768, 1536])
def test_k1_and_k3_bf16_score_a_pair_bitwise_alike(dev, f):
    """K1's and K3's bf16 modes run one step a 64-feature slice (a wgmma
    chain into a zeroed partial, joined by one rounded add; K1 on 32 rows
    a warpgroup, K3 on 64), so every row both return for a query scores
    bitwise alike, at k = 10 and k = 128."""
    n, b = 20_000, 64
    args = _inputs_bf16(dev, n, f, b, seed=f)
    pool_s, pool_i, _ = bt.binned_topk_pool(*args, n, depth=3, bins=128,
                                            chunks=2)
    for k in (10, 128):
        s, i = tk.merge_topk_partial(*args, n, k=k, rows_per_chunk=(
            tk._chunk_rows(b, n, dev, k, True, f)))
        torch.cuda.synchronize()
        _same_pair_scores(pool_s, pool_i, s, i, n, b * min(k, 100))


def _same_pair_scores(pool_s, pool_i, s, i, n, least):
    """Every row in both K1's pool and K3's partials scores bitwise
    alike, over at least ``least`` (query, row) pairs."""
    b = s.shape[0]
    dense = torch.full((b, n + 1), float("nan"), device=s.device)
    pi = pool_i.reshape(b, -1).long().clamp_max(n)
    dense.scatter_(1, pi, pool_s.reshape(b, -1))
    got = dense.gather(1, i.reshape(b, -1).long().clamp_max(n))
    both = ~torch.isnan(got) & (i.reshape(b, -1) != INT_MAX)
    assert int(both.sum()) >= least
    assert torch.equal(got[both], s.reshape(b, -1)[both])


def _k3_bf16_vs_plain(args, n, k, rows_per_chunk):
    s, i = tk.merge_topk_partial(*args, n, k=k, rows_per_chunk=rows_per_chunk)
    rs, ri = tk.merge_topk_partial_plain(*args, n, k=k,
                                         rows_per_chunk=rows_per_chunk)
    torch.cuda.synchronize()
    assert s.shape == rs.shape
    _assert_scored_ids(s, i, rs, args)
    assert torch.equal(i == INT_MAX, ri == INT_MAX)
    return s, i


@pytest.mark.parametrize("f", [136, 1544])
@pytest.mark.parametrize("b", [1, 63, 64, 97, 2048])
def test_k3_bf16_partial_and_full_query_blocks(dev, f, b):
    """A batch below one 64-query block (the rows past B arrive as zeros
    from the query map and are never written), one short of it, exactly
    one, a ragged second block and a full 2048-query batch, with the
    query block resident (F = 136) and streamed (F = 1544)."""
    n = 5003
    args = _inputs_bf16(dev, n, f, b, seed=f + b)
    _k3_bf16_vs_plain(args, n, 10, tk._chunk_rows(b, n, dev, 10, True, f))


@pytest.mark.parametrize("n", [1, 31, 100, 130])
@pytest.mark.parametrize("f,k", [(72, 10), (2048, 128)])
def test_k3_bf16_fewer_rows_than_a_tile(dev, n, f, k):
    """A corpus of fewer rows than one 128-row tile or than one
    warpgroup's 64: the tile's rows past n arrive as zeros and never
    become candidates; slots no row fills hold NEG_INF, INT_MAX."""
    args = _inputs_bf16(dev, n, f, 70, seed=n + f)
    s, i = _k3_bf16_vs_plain(args, n, k, 4096)
    assert int((i != INT_MAX).sum(dim=-1).max()) == min(n, k)


def test_k3_bf16_chunks_without_tiles(dev):
    """Chunks past the last tile (no slice is loaded) hold NEG_INF and
    INT_MAX; the others equal the plain version's partials at their own
    chunking."""
    n, b, f, k = 300, 40, 136, 10
    qh, ql, xh, xlh, c1 = _inputs_bf16(dev, n, f, b, seed=5)
    rpc = tk.merge_tile_rows(b, k, True, f)
    chunks = -(-n // rpc) + 2
    s = torch.empty((b, chunks, k), device=dev)
    i = torch.empty((b, chunks, k), device=dev, dtype=torch.int32)
    rc = lib().asp_merge_topk_bf16(
        qh.data_ptr(), ql.data_ptr(), xh.data_ptr(), xlh.data_ptr(), c1, n,
        b, f, k, chunks, rpc, s.data_ptr(), i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    rs, ri = tk.merge_topk_partial_plain(qh, ql, xh, xlh, c1, n, k=k,
                                         rows_per_chunk=rpc)
    _assert_scored_ids(s[:, :-2], i[:, :-2], rs, (qh, ql, xh, xlh, c1))
    assert torch.equal(i[:, :-2] == INT_MAX, ri == INT_MAX)
    assert bool((s[:, -2:] == NEG_INF).all())
    assert bool((i[:, -2:] == INT_MAX).all())


@pytest.mark.parametrize("fill", ["copies", "nan", "huge"])
@pytest.mark.parametrize("f,k,rows_per_chunk", [(40, 10, 1280),
                                                (136, 128, 6000),
                                                (1536, 10, 128),
                                                (2048, 64, 8192)])
def test_k3_bf16_never_scores_a_row_past_n(dev, fill, f, k, rows_per_chunk):
    """A capacity buffer whose rows past n hold copies of the queries,
    NaN or 1e30 (in bf16): the corpus map ends at row n, so none of them
    reaches a score, whatever the chunk's length."""
    from arrowspace_torch.ops.search import operand_query
    rng = np.random.default_rng(f + k)
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev) for a in
                    (rng.uniform(0.1, 1.0, (37, f)), rng.uniform(0, 1, 37),
                     rng.uniform(0.1, 1.0, (CAP, f)), rng.uniform(0, 1, CAP)))
    xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    if fill == "huge":
        xh[N_LIVE:], xlh[N_LIVE:] = 1e30, 1e30
    else:
        _poison(xh, N_LIVE, qh / qh.float().norm(dim=1, keepdim=True).to(
            qh.dtype), fill)
        _poison(xlh, N_LIVE, ql, fill)
    s, i = _k3_bf16_vs_plain((qh, ql, xh, xlh, c1), N_LIVE, k,
                             rows_per_chunk)
    _no_row_past_n(i)
    assert bool(torch.isfinite(s).all())
    fs, fi = tk.fused_lambda_topk(q, ql, xh, xlh, 0.9, k=k, prepared=True,
                                  n_items=N_LIVE)
    _no_row_past_n(fi)


@pytest.mark.parametrize("f", [128, 2048])
def test_k3_bf16_identical_rows_tie_by_id(dev, f):
    """Copies of query 0 in several tiles, warpgroups and chunks, two of
    them adjacent, score bitwise alike in K3's bf16 mode and come back
    from fused_lambda_topk first, in ascending id order."""
    n, b = 9001, 19
    rng = np.random.default_rng(f)
    q, ql = rng.uniform(0.1, 1.0, (b, f)), rng.uniform(0, 1, b)
    x, xl = rng.uniform(0.1, 1.0, (n, f)), rng.uniform(0, 1, n)
    ids = [3, 4, 70, 101, 2049, 4500, 8999]
    x[ids], xl[ids] = q[0], ql[0]
    q, ql, x, xl = (torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in (q, ql, x, xl))
    xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=True)
    assert bool((xh[ids] == xh[ids[0]]).all())
    from arrowspace_torch.ops.search import operand_query
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    s, i = tk.merge_topk_partial(qh, ql, xh, xlh, c1, n, k=10,
                                 rows_per_chunk=2048)
    torch.cuda.synchronize()
    copies = torch.isin(i, torch.tensor(ids, device=dev, dtype=i.dtype))
    assert int(copies[0].sum()) == len(ids)
    found = s[0][copies[0]]
    assert bool((found == found[0]).all())
    fs, fi = tk.fused_lambda_topk(q, ql, xh, xlh, 0.9, k=10, prepared=True,
                                  n_items=n)
    assert fi[0, :len(ids)].tolist() == ids
    assert bool((fs[0, :len(ids)] == fs[0, 0]).all())


def test_k3_bf16_config_matches_the_wrapper_rule(dev):
    """The library's account of each launch (query block, tile rows,
    stages, shared bytes, query residency, CTAs an SM) is the wrapper's
    rule, with a ring of at least 3 stages, within 232,448 bytes, and no
    spilled register, at F up to 4096 and k up to 128."""
    for f in (8, 136, 768, 1536, 1544, 2048, 3072, 4096):
        for k in (1, 10, 49, 50, 64, 128):
            cfg = tk.merge_bf16_config(f, k)
            resident, stages = tk.merge_bf16_plan(f, k)
            assert cfg["query_block"] == tk.merge_query_block(2048, True)
            assert cfg["tile_rows"] == tk.merge_tile_rows(2048, k, True, f)
            assert cfg["stages"] == stages >= 3
            assert cfg["resident"] == int(resident)
            assert cfg["smem_bytes"] == tk.merge_smem_bytes(2048, k, True, f)
            assert cfg["smem_bytes"] <= 232_448
            assert cfg["ctas_per_sm"] == tk.merge_ctas_per_sm(2048, k, True,
                                                              f)
            assert cfg["spill_bytes"] == 0


def test_bf16_merge_session_above_the_gate(dev):
    """A 70000 x 2048 projected build on the card: a bf16 session
    resolves "merge" (above K1's bf16 gate), launches K3's bf16 mode once
    a batch and no other top-k kernel, and equals the plain bf16 full
    scan: scores within 1e-5, ids equal outside near-ties, the copies of
    a row first in ascending id order."""
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops.search import (dot_plane, exact_topk,
                                             lambda_term, operand_query)
    rng = np.random.default_rng(21)
    c = rng.uniform(0.2, 0.8, (24, 2048))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05,
                                                       (70_000, 2048))
    rows[[11, 500, 501]] = rows[10]
    idx = ArrowIndex.build(rows, eps=1.0, dims_reduction=True, seed=21,
                           device=dev)
    sess = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                   precision="bf16")
    assert sess.kernel == "merge" and sess.precision == "bf16"
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    queries[0] = rows[10] * 1.02
    counts = lambda: (bt.binned_topk_pool.launches,          # noqa: E731
                      bt.binned_topk_pool.launches_bf16,
                      tk.merge_topk_partial.launches,
                      tk.merge_topk_partial.launches_bf16)
    before = counts()
    (gs, gi), = list(sess.search_stream([queries]))
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 1]
    q = torch.tensor(queries, dtype=torch.float32, device=dev)
    _, qlam = _query_prep(idx.aspace, idx.gl)[1](q)
    xh, xlh = bt.prepare_binned_corpus(idx.aspace.data, idx.aspace.lambdas,
                                       use_bf16=True)
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    n = idx.nitems
    ps, pi = exact_topk(dot_plane(qh, xh[:n])
                        - lambda_term(qlam.float(), xlh[:n], c1), 10)
    ps, pi = (ps + c1).cpu().numpy(), pi.cpu().numpy()
    err = float(np.abs(gs - ps).max())
    assert err <= TOL
    copies = [gi[0].tolist().index(v) for v in (10, 11, 500, 501)]
    assert copies == list(range(copies[0], copies[0] + 4))
    for r, j in zip(*np.nonzero(gi != pi)):
        pos = np.nonzero(pi[r] == gi[r, j])[0]
        other = ps[r, pos[0]] if pos.size else ps[r, -1]
        assert abs(other - ps[r, j]) <= 2.0 * err


def test_bf16_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qh, ql, xh, xlh, c1 = _inputs_bf16(dev, 600, 16, 4, seed=1)
    kw = dict(depth=3, bins=128, chunks=1)
    with pytest.raises(ValueError):          # mixed operand dtypes
        bt.binned_topk_pool(qh.float(), ql, xh, xlh, c1, 600, **kw)
    with pytest.raises(ValueError):          # F not a multiple of 8
        bt.binned_topk_pool(qh[:, :12].contiguous(), ql,
                            xh[:, :12].contiguous(), xlh, c1, 600, **kw)
    with pytest.raises(ValueError):          # rows not 16-byte aligned
        rows = xh.shape[0] - 1
        bt.binned_topk_pool(qh, ql, xh.reshape(-1)[4:4 + rows * 16].reshape(
            rows, 16), xlh, c1, 600, **kw)
    with pytest.raises(ValueError):          # above the bf16 gate
        big = _inputs_bf16(dev, 600, 1544, 4, seed=2)
        bt.binned_topk_pool(*big, 600, **kw)
    with pytest.raises(ValueError):
        tk.merge_topk_partial(qh, ql.double(), xh, xlh, c1, 600, k=10,
                              rows_per_chunk=256)


def test_bf16_sessions_on_card(dev):
    """A 70000 x 128 build on the card: the bf16 session launches K1's
    bf16 mode a batch (and its repair K3's, for a query with copies in
    three bins), never the float32 kernels, and equals the plain bf16
    full scan; a live bf16 session returns the static session's results
    bitwise, and an added copy of a row scores bitwise as that row."""
    from arrowspace_torch.index import _query_prep
    from arrowspace_torch.ops.search import operand_query
    rng = np.random.default_rng(12)
    c = rng.uniform(0.2, 0.8, (24, 128))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05,
                                                       (70_000, 128))
    for b in (5, 17, 29):                    # 4 copies of row 0 a bin
        rows[b + 128 * (2 + np.arange(4))] = rows[0]
    idx = ArrowIndex.build(rows, eps=1.0, seed=12, device=dev)
    sess = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                   precision="bf16")
    assert sess.kernel == "binned" and sess.precision == "bf16"
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    queries[0] = rows[0] * 1.02
    counts = lambda: (bt.binned_topk_pool.launches,          # noqa: E731
                      bt.binned_topk_pool.launches_bf16,
                      tk.merge_topk_partial.launches,
                      tk.merge_topk_partial.launches_bf16)
    before = counts()
    (gs, gi), = list(sess.search_stream([queries]))
    after = counts()
    assert (after[0] - before[0], after[2] - before[2]) == (0, 0)
    assert after[1] - before[1] == 1 and after[3] - before[3] >= 1
    q = torch.tensor(queries, dtype=torch.float32, device=dev)
    _, qlam = _query_prep(idx.aspace, idx.gl)[1](q)
    xh, xlh = bt.prepare_binned_corpus(idx.aspace.data, idx.aspace.lambdas,
                                       use_bf16=True)
    qh, c1 = operand_query(q, 0.9, torch.float32, xh)
    from arrowspace_torch.ops.search import exact_topk, dot_plane, \
        lambda_term
    n = idx.nitems
    ps, pi = exact_topk(dot_plane(qh, xh[:n])
                        - lambda_term(qlam, xlh[:n], c1), 10)
    ps, pi = (ps + c1).cpu().numpy(), pi.cpu().numpy()
    err = float(np.abs(gs - ps).max())
    assert err <= TOL
    for r, j in zip(*np.nonzero(gi != pi)):
        pos = np.nonzero(pi[r] == gi[r, j])[0]
        other = ps[r, pos[0]] if pos.size else ps[r, -1]
        assert abs(other - ps[r, j]) <= 2.0 * err
    live = idx.make_live_session(batch_size=64, k=10, alpha=0.9,
                                 capacity=n + 4096, precision="bf16")
    assert live.precision == "bf16"
    ls, li = live.search(queries)
    assert np.array_equal(ls, gs) and np.array_equal(li, gi)
    live = idx.make_live_session(batch_size=64, k=10, alpha=1.0,
                                 capacity=n + 4096, precision="bf16")
    new = live.add(rows[[7, 8]])
    assert torch.equal(live._xhat[n:n + 2], xh[[7, 8]])
    ls, li = live.search(rows[[7]] * 1.02)
    hit = list(li[0])
    a, b = hit.index(7), hit.index(int(new[0]))
    assert ls[0][a] == ls[0][b] and a < b


def _near_ties_only(gs, gi, ps, pi):
    """Scores within TOL of the reference's; ids equal outside near-ties
    (within twice the measured score error)."""
    err = float(np.abs(gs - ps).max())
    assert err <= TOL
    for r, j in zip(*np.nonzero(gi != pi)):
        pos = np.nonzero(pi[r] == gi[r, j])[0]
        other = ps[r, pos[0]] if pos.size else ps[r, -1]
        assert abs(other - ps[r, j]) <= 2.0 * err


@pytest.fixture(scope="module")
def migration_index(dev):
    """A 70000 x 128 build on the card, row 0 with 4 copies in each of
    three bins of K1 (its repair overflows to K3), row 1 with 5 in one
    (the strided repair alone)."""
    rng = np.random.default_rng(21)
    c = rng.uniform(0.2, 0.8, (24, 128))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05,
                                                       (70_000, 128))
    for b in (5, 17, 29):
        rows[b + 128 * (2 + np.arange(4))] = rows[0]
    rows[77 + 128 * (2 + np.arange(5))] = rows[1]
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    queries[:2] = rows[:2] * 1.02
    return rows, queries, ArrowIndex.build(rows, eps=1.0, seed=21,
                                           device=dev)


def test_use_pallas_true_below_the_row_floor(dev, migration_index):
    """use_pallas=True on a 60000-row slice (below BINNED_MIN_ITEMS)
    launches K1 (and the repair's K3 for row 0) and agrees with the plain
    full scan; None and False launch neither there."""
    from arrowspace_torch import core
    from arrowspace_torch.core import ArrowSpace
    rows, queries, idx = migration_index
    a = idx.aspace
    n = 60_000
    assert not core.merge_fits(n, 10)
    sub = ArrowSpace(nfeatures=128, nitems=n,
                     data=a.data[:n].contiguous(),
                     lambdas=a.lambdas[:n].contiguous(), taumode=a.taumode)
    qlam = a.prepare_query_items_batch(queries, idx.gl)
    q = torch.tensor(queries, dtype=torch.float32, device=dev)
    ps, pi = batched_lambda_aware_topk(q, qlam, sub.data, sub.lambdas, 0.9,
                                       k=10)
    for mode, want in ((True, 1), (None, 0), (False, 0)):
        before = (bt.binned_topk_pool.launches, tk.merge_topk_partial.launches)
        gs, gi = sub.search_lambda_aware_batch(q, qlam, 10, 0.9,
                                               use_pallas=mode)
        k1 = bt.binned_topk_pool.launches - before[0]
        k3 = tk.merge_topk_partial.launches - before[1]
        assert k1 == want and (k3 >= 1 if want else k3 == 0), (mode, k1, k3)
        _near_ties_only(gs.cpu().numpy(), gi.cpu().numpy(),
                        ps.cpu().numpy(), pi.cpu().numpy())


def test_unprepared_cosine_session_bitwise(dev, migration_index):
    """prepare_corpus=False at 70000 rows: K1 once a batch, the strided
    repair and K3 for the copies, results bitwise the prepared
    session's, and no prepared copy resident."""
    from arrowspace_torch.ops import bin_repair as br
    rows, queries, idx = migration_index
    prep = idx.make_search_session(batch_size=64, k=10, alpha=0.9)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    raw = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                  prepare_corpus=False)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) - before < 70_000 * 128 * 4 // 100
    assert raw.kernel == "binned"
    batches = [queries, rows[100:164] * 1.01]
    want = list(prep.search_stream(batches))
    counts = (bt.binned_topk_pool.launches, tk.merge_topk_partial.launches,
              br.strided_lambda_repair.calls)
    got = list(raw.search_stream(batches))
    assert bt.binned_topk_pool.launches - counts[0] == 2
    assert tk.merge_topk_partial.launches - counts[1] >= 1
    assert br.strided_lambda_repair.calls - counts[2] >= 1
    for (gs, gi), (ws, wi) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)


def test_unprepared_energy_session_bitwise(dev):
    """prepare_corpus=False on a 70000-row energy index: K6 once a batch,
    results bitwise the prepared session's, no centred plane resident;
    approx=True refuses it."""
    rng = np.random.default_rng(22)
    c = rng.uniform(0.2, 0.8, (24, 128))
    rows = c[rng.integers(0, 24, 70_000)] + rng.normal(0, 0.05,
                                                       (70_000, 128))
    rows[7 + 128 * (2 + np.arange(5))] = rows[0]
    idx = ArrowIndex.build_energy(rows, EnergyParams(allow_tall_graphs=True),
                                  seed=22, device=dev)
    prep = idx.make_energy_session(batch_size=64, k=10)
    raw = idx.make_energy_session(batch_size=64, k=10, prepare_corpus=False)
    assert raw.kernel == "binned" and raw.engine.zx is None
    queries = rows[rng.integers(0, 70_000, 64)] * 1.02
    queries[0] = rows[0] * 1.02
    batches = [queries, rows[200:264] * 1.01]
    want = list(prep.search_stream(batches))
    k6 = eb.binned_energy_pool.launches
    got = list(raw.search_stream(batches))
    assert eb.binned_energy_pool.launches - k6 == 2
    for (gs, gi), (ws, wi) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
    with pytest.raises(ValueError):
        idx.make_energy_session(batch_size=64, k=10, approx=True,
                                prepare_corpus=False)


@pytest.mark.parametrize("name", [
    "torch_01_compare_cosine", "torch_02_proteins_lookup",
    "torch_03_compare_energy_cosine", "torch_04_hypergraph_ensembles",
    "torch_05_serving", "torch_06_live_mutation", "torch_07_multiprocess",
    "torch_08_pruned_lowlat"])
def test_examples_run_on_the_card(dev, name):
    """Each example of the port on the card (its default device)."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, f"examples/{name}.py"], cwd=root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
