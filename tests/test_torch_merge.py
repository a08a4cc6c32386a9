"""The exact merge route of arrowspace_torch (K3, ops/topk.py) against
the JAX package's Pallas kernel in interpret mode.

Where core.binned_fits fails on F alone (float32 F above 352, the width
K1's wgmma route holds; bf16 F above 1536) and core.merge_fits holds (N
>= BINNED_MIN_ITEMS, k <= 128), both the λ-aware search and the serving
session take K3, as the JAX package's search does above its own binned
limit (core.py:429-439 there); on the CPU K3's wrapper runs its plain
version.  The tests lower the row gate so that a small wide corpus
takes the route, count the plain version's calls, and hold ids and tie
order equal to ``fused_lambda_topk(..., interpret=True)`` (float32), the
scores within float64 tolerance of a float64 numpy scan and within 1e-6
of the JAX kernel's float32 scores."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu.ops.pallas_topk import fused_lambda_topk as j_merge
from arrowspace_torch import core
from arrowspace_torch.core import ArrowSpace
from arrowspace_torch.index import (ArrowIndex, _query_prep,
                                    session_kernel_kind)
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops.search import (batched_lambda_aware_topk,
                                         binned_topk_with_repair)
from test_torch_bintopk import _THREE_TF32, _tensor_core_dot


@pytest.mark.parametrize("args,kind", [((1_000_000, 10, 1536), "merge"),
                                       ((1_000_000, 129, 1536), "plain"),
                                       ((60_000, 10, 1536), "plain"),
                                       ((1_000_000, 10, 128), "binned"),
                                       ((1_000_000, 128, 1265), "merge"),
                                       ((65_536, 1, 3072), "merge"),
                                       ((1_000_000, 10, 352), "binned"),
                                       ((1_000_000, 10, 353), "merge"),
                                       ((1_000_000, 10, 356), "merge"),
                                       ((1_000_000, 100, 768), "merge"),
                                       ((1_000_000, 10, 1264), "merge"),
                                       ((1_000_000, 10, 768, True),
                                        "binned")])
def test_session_kernel_kind(args, kind):
    assert session_kernel_kind(*args) == kind
    assert core.merge_fits(args[0], args[1]) == (kind != "plain")


@pytest.mark.parametrize("f,use_bf16", [(352, False), (356, False),
                                        (768, False), (768, True)])
def test_search_takes_the_session_engine(monkeypatch, f, use_bf16):
    """core.lambda_aware_topk (search) runs the engine that
    session_kernel_kind gives a session of the same size and dtype, both
    through the size gates and under use_pallas=True: K1 with its repair
    up to float32 F = 352 (bf16 up to 1536), K3 above; the float32 ids
    equal the plain scan's."""
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1024)
    q, ql, x, xl, _ = _corpus(1100, f, 4, seed=f)
    args = [torch.from_numpy(a) for a in (q, ql, x, xl)]
    ran = []
    for name in ("binned_topk_with_repair", "fused_lambda_topk"):
        real = getattr(core, name)
        monkeypatch.setattr(core, name, lambda *a, _n=name, _r=real, **kw:
                            ran.append(_n) or _r(*a, **kw))
    want = {"binned": "binned_topk_with_repair",
            "merge": "fused_lambda_topk"}[session_kernel_kind(1100, 10, f,
                                                             use_bf16)]
    assert want == ("binned_topk_with_repair" if f == 352 or use_bf16
                    else "fused_lambda_topk")
    _, pi = batched_lambda_aware_topk(*args, 0.9, k=10)
    for use_pallas in (None, True):
        s, i = core.lambda_aware_topk(*args, 0.9, k=10, use_bf16=use_bf16,
                                      use_pallas=use_pallas)
        assert ran.pop() == want and not ran
        if not use_bf16:
            assert torch.equal(i, pi)


def _corpus(n, f, b, seed):
    """Uniform rows and λ; 12 exact copies of query 0 (more than k = 10)
    at scattered ids, with query 0's λ."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, (b, f))
    ql = rng.uniform(0, 1, b)
    x = rng.uniform(0.1, 1.0, (n, f))
    xl = rng.uniform(0, 1, n)
    dup = np.sort(rng.choice(n, 12, replace=False))
    x[dup], xl[dup] = q[0], ql[0]
    return q, ql, x, xl, dup


def _f64_scan(q, ql, x, xl, alpha, k):
    """Float64 numpy λ-aware scores of every row, best k by (-score, id)."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    s = alpha * (qn @ xn.T) + (1 - alpha) * (
        1 - np.minimum(np.abs(ql[:, None] - xl[None, :]), 1.0))
    order = np.stack([np.lexsort((np.arange(x.shape[0]), -r))[:k]
                      for r in s])
    return np.take_along_axis(s, order, 1), order


def _count_plain(monkeypatch):
    calls, plain = [], tk.merge_topk_partial_plain
    monkeypatch.setattr(tk, "merge_topk_partial_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    return calls


def _check(s, i, q, ql, x, xl, alpha, k):
    js, ji = j_merge(*(jnp.asarray(a, dtype=jnp.float32)
                       for a in (q, ql, x, xl)), alpha, k=k, interpret=True)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(s), np.asarray(js), atol=1e-6)
    ref_s, ref_i = _f64_scan(q, ql, x, xl, alpha, k)
    np.testing.assert_array_equal(np.asarray(i), ref_i)
    np.testing.assert_allclose(np.asarray(s), ref_s, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f,k", [(1272, 10), (1536, 10), (1536, 3)])
def test_search_routes_wide_corpus_to_merge(monkeypatch, f, k):
    """ArrowSpace.search_lambda_aware_batch on a 1100-row corpus above
    K1's gate: one K3 call (its plain version on the CPU), equal to the
    JAX kernel and the float64 scan, the copies of query 0 first in
    ascending id order."""
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1024)
    q, ql, x, xl, dup = _corpus(1100, f, 5, seed=f + k)
    a = ArrowSpace(nfeatures=f, nitems=x.shape[0],
                   data=torch.from_numpy(x), lambdas=torch.from_numpy(xl))
    assert not core.binned_fits(a.nitems, k, f) and core.merge_fits(
        a.nitems, k)
    calls = _count_plain(monkeypatch)
    s, i = a.search_lambda_aware_batch(q, ql, k, 0.9)
    assert len(calls) == 1
    assert i[0].tolist() == dup[:k].tolist()
    _check(s, i, q, ql, x, xl, 0.9, k)


def test_merge_session_streams_through_k3(monkeypatch):
    """A "merge" SearchSession on a small wide projected build: the
    corpus is prepared once, K3 runs once per batch (a full batch and a
    short tail batch, padded and sliced back), nothing is flagged or
    repaired, and every row equals the JAX kernel and the float64 scan
    under the session's own query λ."""
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1024)
    f, k, bsz = 1536, 10, 4
    rng = np.random.default_rng(7)
    centres = rng.uniform(0.2, 0.8, (6, f))
    x = centres[rng.integers(0, 6, 1100)] + rng.normal(0, 0.05, (1100, f))
    x[[40, 300, 301, 777]] = x[5]                   # identical rows
    idx = ArrowIndex.build(x, eps=1.0, dims_reduction=True, seed=7,
                           device="cpu", dtype=torch.float64)
    sess = idx.make_search_session(batch_size=bsz, k=k, alpha=0.9)
    assert sess.kernel == "merge" and sess._repair is None
    queries = x[[5, 40, 901, 17, 300, 640]] * 1.02
    calls = _count_plain(monkeypatch)
    out = list(sess.search_stream([queries[:bsz], queries[bsz:]]))
    assert len(calls) == 2
    assert [o[1].shape for o in out] == [(bsz, k), (2, k)]
    s = np.concatenate([o[0] for o in out])
    i = np.concatenate([o[1] for o in out])
    assert i[0, :5].tolist() == [5, 40, 300, 301, 777]
    _, qlam = _query_prep(idx.aspace, idx.gl)[1](torch.from_numpy(queries))
    _check(s, i, queries, qlam.numpy(), x, idx.lambdas, 0.9, k)


def test_merge_chunk_rule_fills_whole_waves():
    """K3's one chunking, float32 and bf16 alike: 64 queries × 128 rows a
    CTA, one CTA an SM (the ring fills its shared memory at every k),
    the chunk count from ops.bintopk.wave_chunks over ceil(B / 64) CTAs
    a chunk and the SMs, at most one chunk an SM, of whole 128-row
    tiles.  A batch of one query block (B = 1, 63 and 64 alike: a
    repair's rows) spreads over 119 chunks on 132 SMs and 36 on 40, a
    2048 batch's 32 CTAs over 4 chunks; the CPU's one "SM" takes one
    chunk."""
    assert (tk.QUERY_BLOCK, tk.TILE_ROWS) == (64, 128)
    n = 1_000_000
    for bsz, chunks in ((1, 119), (63, 119), (64, 119), (65, 60),
                        (2048, 4)):
        rpc = tk.merge_rows_per_chunk(bsz, n, 132)
        assert rpc % 128 == 0 and -(-n // rpc) == chunks
        ctas = -(-bsz // 64) * chunks
        assert ctas / (-(-ctas // 132) * 132) >= 0.9
    assert -(-n // tk.merge_rows_per_chunk(1, n, 40)) == 36
    assert tk._chunk_rows(2048, n, torch.device("cpu")) == \
        -(-n // 128) * 128
    for f in (4, 100, 1536, 4096):
        for k in (1, 10, 64, 128):
            for bf16 in (False, True):
                smem = tk.merge_smem_bytes(f, k, bf16)
                assert smem <= 227 * 1024
                assert 2 * (smem + 1024) > 228 * 1024   # one CTA an SM


def test_merge_partial_plain_chunks_at_the_wrapper_rule():
    """fused_lambda_topk's default chunking (one chunk on the CPU) and an
    explicit one give the same top-k: the partial layout and the two-key
    merge of the chunks are exact."""
    q, ql, x, xl, dup = _corpus(1500, 64, 3, seed=1)
    t = [torch.from_numpy(a) for a in (q, ql, x, xl)]
    s1, i1 = tk.fused_lambda_topk(*t, 0.9, k=10)
    s2, i2 = tk.fused_lambda_topk(*t, 0.9, k=10, rows_per_chunk=128)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    assert i1[0].tolist() == dup[:10].tolist()


@pytest.mark.parametrize("f", [1272, 1536])
def test_three_tf32_truncating_k_step_within_tolerance_at_wide_f(f):
    """K3's product (K1's 3×TF32 k-step, truncating accumulate, a zeroed
    partial per 64-feature slice) on clustered unit rows at the widths K3
    serves: within 2e-6 of float64 in this emulation, under the 1e-5
    score tolerance; identical rows bitwise alike."""
    rng = np.random.default_rng(f)
    centres = rng.uniform(0.2, 0.8, (64, f))
    x = centres[rng.integers(0, 64, 256)] + rng.normal(0, 0.05, (256, f))
    x[200] = x[3]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, 256, 16)] * 1.02
    q = 0.9 * q / np.linalg.norm(q, axis=1, keepdims=True)
    qt, xt = (torch.tensor(a, dtype=torch.float32) for a in (q, x))
    dot = _tensor_core_dot(qt, xt, _THREE_TF32, truncate=True, partial=64)
    err = float((dot.double() - qt.double() @ xt.double().T).abs().max())
    assert err <= 2e-6
    assert torch.equal(dot[:, 200], dot[:, 3])


# Float32 K3 (csrc/merge_topk_tf32.cu): ring stages by k
_TF32_STAGES = {1: 5, 10: 4, 24: 4, 64: 4, 66: 4, 67: 3, 100: 3, 128: 3}


@pytest.mark.parametrize("k", sorted(_TF32_STAGES))
@pytest.mark.parametrize("f,bsz", [(1536, 2048), (128, 64), (3072, 65),
                                   (1536, 63), (1534, 2048), (124, 2048),
                                   (3076, 2048), (768, 1)])
def test_k3_tf32_route_rule(k, f, bsz):
    """Float32 K3's one plan at every (F, B, k): 64 queries × 128 corpus
    rows a CTA, a ring of as many 32-feature stages (128 corpus rows and
    both query planes' 64 rows, 128 bytes a row: 32 KB, and two 8-byte
    barriers) as fit beside 1024 aligning bytes and the selection state
    (a k-th word, a top-k list and a one-tile candidate buffer of 8-byte
    entries and a count a query), at most 8; shared memory that leaves
    room for one CTA an SM, and chunks of whole 128-row tiles that fill
    132 SMs in whole waves.  The kernel reads F at its operand width
    (whole 16-byte rows): 1534 as 1536, 124, 3076 and 768 as they
    are."""
    stages = _TF32_STAGES[k]
    assert tk.merge_tf32_stages(k) == stages
    smem = 1024 + stages * 32_784 + 64 * (8 + 8 * k + 8 * 128 + 4)
    assert tk._tf32_smem(k, stages) == smem <= 232_448
    assert stages == 8 or smem + 32_784 > 232_448
    width = bt.operand_width(f, torch.float32)
    assert width == -(-f // 4) * 4 and width * 4 % 16 == 0
    assert tk.merge_smem_bytes(width, k) == smem
    assert 2 * (smem + 1024) > 228 * 1024
    n = 1_000_000
    rpc = tk.merge_rows_per_chunk(bsz, n, 132)
    assert rpc % tk.TILE_ROWS == 0 and tk.TILE_ROWS == 128
    ctas = -(-bsz // tk.QUERY_BLOCK) * -(-n // rpc)
    assert ctas / (-(-ctas // 132) * 132) >= 0.9


def test_k3_tf32_route_edges():
    """The one plan's edges: the dbpedia cell's launch (B = 2048, F =
    1536, k = 10) runs 4 chunks of 1954 tiles on 132 SMs; B = 1, 63 and
    64 are one query block each and take the same 119 chunks; F = 100
    and 4096 (widths outside the range first timed) plan as any other F;
    k = 128 fits a ring of 3 stages in the 227 KB a block may use and k
    = 67 the last depth of 3, k = 66 a ring of 4; the bf16 kernel's plan
    shares the query block and tile rows."""
    n = 1_000_000
    rpc = tk.merge_rows_per_chunk(2048, n, 132)
    assert rpc == 1954 * 128 and -(-n // rpc) == 4
    assert len({tk.merge_rows_per_chunk(b, n, 132) for b in (1, 63, 64)}) \
        == 1
    assert -(-n // tk.merge_rows_per_chunk(1, n, 132)) == 119
    for f in (100, 4096):
        assert tk.merge_smem_bytes(f, 10) == tk.merge_smem_bytes(1536, 10)
    assert [tk.merge_tf32_stages(k) for k in (66, 67, 128)] == [4, 3, 3]
    assert tk.merge_smem_bytes(1536, 128) <= 227 * 1024
    assert tk.merge_smem_bytes(1536, 128) + 32_784 > 227 * 1024
    for f in (128, 1536, 3072):
        plan = tk.merge_bf16_plan(f, 10)
        assert tk.merge_smem_bytes(f, 10, True) == \
            tk._bf16_smem(f, 10, *plan)


def _dyadic_unit_rows(rng, n, f):
    """Unit rows whose products and sums are exact in float32 in any
    order: one ±1 feature where F < 4, else four ±1/2 features."""
    m = 1 if f < 4 else 4
    rows = np.zeros((n, f), dtype=np.float32)
    for r in range(n):
        cols = rng.choice(f, m, replace=False)
        rows[r, cols] = rng.choice([-1.0, 1.0], m) / np.sqrt(m)
    return torch.from_numpy(rows)


@pytest.mark.parametrize("f", [1, 3, 5, 99, 1537])
def test_plain_k1_and_k3_on_a_padded_corpus_equal_the_unpadded_scan(f):
    """The plain K1 (with its repair) and K3 serve a float32 corpus
    prepared at its operand width (F zero-padded to whole 16 bytes) and
    return scores and ids torch.equal to the plain full scan of the
    unpadded rows.  The rows are chosen so that every dot product is
    exact in float32 (α = 1: no λ term), since the CPU's product-sum
    rounds in an order that depends on the row width; their many exact
    ties are held to the scan's lowest-id order."""
    rng = np.random.default_rng(f)
    n, b, k = 3000, 8, 10
    x = _dyadic_unit_rows(rng, n, f)
    q = x[rng.integers(0, n, b)].clone()
    xl = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    ql = torch.from_numpy(rng.uniform(0, 1, b).astype(np.float32))
    xh, _ = bt.prepare_binned_corpus(x, xl)
    assert xh.shape[1] == bt.operand_width(f, torch.float32) == \
        -(-f // 4) * 4
    ps, pi = batched_lambda_aware_topk(q, ql, x, xl, 1.0, k=k)
    for s, i in (binned_topk_with_repair(q, ql, x, xl, 1.0, k=k),
                 tk.fused_lambda_topk(q, ql, x, xl, 1.0, k=k)):
        assert torch.equal(i, pi) and torch.equal(s, ps)
