"""The exact merge route of arrowspace_torch (K3, ops/topk.py) against
the JAX package's Pallas kernel in interpret mode.

Where core.binned_fits fails on F alone (F above K1's gate of 1264) and
core.merge_fits holds (N >= BINNED_MIN_ITEMS, k <= 128), both the
λ-aware search and the serving session take K3, as the JAX package's
search does (core.py:429-439 there); on the CPU K3's wrapper runs its
plain version.  The tests lower the row gate so that a small wide corpus
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
from arrowspace_torch.ops import topk as tk
from test_torch_bintopk import _THREE_TF32, _tensor_core_dot


@pytest.mark.parametrize("args,kind", [((1_000_000, 10, 1536), "merge"),
                                       ((1_000_000, 129, 1536), "plain"),
                                       ((60_000, 10, 1536), "plain"),
                                       ((1_000_000, 10, 128), "binned"),
                                       ((1_000_000, 128, 1265), "merge"),
                                       ((65_536, 1, 3072), "merge")])
def test_session_kernel_kind(args, kind):
    assert session_kernel_kind(*args) == kind
    assert core.merge_fits(args[0], args[1]) == (kind != "plain")


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
    """K3's query block and chunking: 64 queries × 64 rows a CTA where
    the batch fills it (32 × 128 below: the chunks hold whole tiles of
    64 and 128 rows); two CTAs an SM where their
    shared memory fits (k <= 24 at 64 queries); the chunk count from
    ops.bintopk.wave_chunks over ceil(B / block) CTAs a chunk and the
    SMs' resident slots, whole tiles a chunk; shared memory within a
    block's budget at every k <= 128."""
    assert [tk.merge_query_block(b) for b in (1, 32, 33, 64, 2048)] == \
        [32, 32, 64, 64, 64]
    assert [tk.merge_ctas_per_sm(2048, k) for k in (1, 10, 24, 25, 128)] \
        == [2, 2, 2, 1, 1]
    assert tk.merge_ctas_per_sm(1, 10) == 1
    assert tk.merge_smem_bytes(2048, 10) == 4 * (
        2 * 128 * 68 + 2 * 64 * 10 + 2 * 64 * 64 + 3 * 64)
    n = 1_000_000
    for k, chunks in ((10, 8), (64, 4)):    # 256 / 128 CTAs, 264 / 132 slots
        rpc = tk.merge_rows_per_chunk(2048, n, 132, k)
        assert rpc % 64 == 0 and -(-n // rpc) == chunks
    assert tk.merge_rows_per_chunk(1, n, 132, 10) == \
        -(-(-(-n // 128)) // 64) * 128                # 64 chunks of one CTA
    assert tk._chunk_rows(2048, n, torch.device("cpu"), 10) == \
        -(-n // 64) * 64
    assert all(tk.merge_smem_bytes(b, k) <= 227 * 1024 for b in (1, 2048)
               for k in (1, 10, 64, 128))


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


# K3's float32 wgmma route (csrc/merge_topk_tf32.cu): ring stages by k
_TF32_STAGES = {1: 5, 10: 4, 24: 4, 64: 4, 66: 4, 67: 3, 100: 3, 128: 3}


@pytest.mark.parametrize("k", sorted(_TF32_STAGES))
@pytest.mark.parametrize("f,bsz", [(1536, 2048), (128, 64), (3072, 65),
                                   (1536, 63), (1534, 2048), (124, 2048),
                                   (3076, 2048), (768, 1)])
def test_k3_tf32_route_rule(k, f, bsz):
    """K3's float32 wgmma kernel: 64 queries × 128 corpus rows a CTA, a
    ring of as many 32-feature stages (128 corpus rows and both query
    planes' 64 rows, 128 bytes a row: 32 KB, and two 8-byte barriers) as
    fit beside 1024 aligning bytes and the selection state (a k-th word,
    a top-k list and a one-tile candidate buffer of 8-byte entries and a
    count a query), at most 8.  It runs where F is a multiple of 4 from
    128 to 3072 and the batch fills the 64-query block; there its plan
    gives K3's tile rows, shared bytes, one CTA an SM and chunks of whole
    128-row tiles; elsewhere the mma.sync kernel's rule holds."""
    stages = _TF32_STAGES[k]
    assert tk.merge_tf32_stages(k) == stages
    smem = 1024 + stages * 32_784 + 64 * (8 + 8 * k + 8 * 128 + 4)
    assert tk._tf32_smem(k, stages) == smem <= 232_448
    assert stages == 8 or smem + 32_784 > 232_448
    route = f % 4 == 0 and 128 <= f <= 3072 and bsz >= 64
    assert tk.merge_tf32_route(bsz, f, k) == route
    n = 1_000_000
    rpc = tk.merge_rows_per_chunk(bsz, n, 132, k, False, f)
    if route:
        assert tk.merge_tile_rows(bsz, k, False, f) == 128
        assert tk.merge_smem_bytes(bsz, k, False, f) == smem
        assert tk.merge_ctas_per_sm(bsz, k, False, f) == 1
        assert rpc % 128 == 0
        chunks = -(-n // rpc)
        ctas = -(-bsz // 64) * chunks
        assert ctas / (-(-ctas // 132) * 132) >= 0.9
    else:   # the mma.sync kernel's rule, as without F
        assert tk.merge_tile_rows(bsz, k, False, f) == \
            tk.merge_tile_rows(bsz, k)
        assert tk.merge_smem_bytes(bsz, k, False, f) == \
            tk.merge_smem_bytes(bsz, k)
        assert rpc == tk.merge_rows_per_chunk(bsz, n, 132, k)


def test_k3_tf32_route_edges():
    """The dbpedia cell's launch (B = 2048, F = 1536, k = 10) takes the
    wgmma route in 4 chunks of whole tiles on 132 SMs; a batch one query
    short of the block (the repair's fallbacks, the wide repair at B = 1),
    F not a multiple of 4, F past either end of the measured range and k
    past 128 keep the mma.sync kernel; k = 128 fits a ring of 3 stages in
    the 227 KB a block may use; bf16 operands never take the route, their
    kernel's plan standing where the route would admit F."""
    assert tk.merge_tf32_route(2048, 1536, 10)
    rpc = tk.merge_rows_per_chunk(2048, 1_000_000, 132, 10, False, 1536)
    assert rpc == 1954 * 128 and -(-1_000_000 // rpc) == 4
    assert tk.merge_tf32_route(64, 1536, 10)
    assert not tk.merge_tf32_route(63, 1536, 10)
    for bsz in (1, 16, 32):
        assert not tk.merge_tf32_route(bsz, 1536, 10)
    for f in (1534, 1538, 1537, 130, 3070):
        assert not tk.merge_tf32_route(2048, f, 10)
    assert tk.merge_tf32_route(2048, 128, 10)
    assert tk.merge_tf32_route(2048, 3072, 10)
    for f in (124, 100, 3076, 4096):
        assert not tk.merge_tf32_route(2048, f, 10)
    assert tk.merge_tf32_route(2048, 1536, 128)
    assert tk.merge_tf32_stages(128) == 3
    assert tk.merge_smem_bytes(2048, 128, False, 1536) <= 227 * 1024
    assert tk.merge_smem_bytes(2048, 128, False, 1536) + 32_784 \
        > 227 * 1024
    for k in (0, 129):
        assert not tk.merge_tf32_route(2048, 1536, k)
    for f in (128, 1536, 3072):
        plan = tk.merge_bf16_plan(f, 10)
        assert tk.merge_smem_bytes(2048, 10, True, f) == \
            tk._bf16_smem(f, 10, *plan)
        assert tk.merge_tile_rows(2048, 10, True, f) == 128
    # the mma.sync kernel's plan at the same shapes is unchanged by F
    assert tk.merge_smem_bytes(2048, 10) == 4 * (
        2 * 128 * 68 + 2 * 64 * 10 + 2 * 64 * 64 + 3 * 64)
    assert tk.merge_tile_rows(63, 10, False, 1536) == 64
