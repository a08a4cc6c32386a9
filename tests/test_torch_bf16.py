"""bf16 serving of arrowspace_torch (the bf16 modes of K1 and K3, the
strided repair on a bf16 corpus, the static and live sessions and
``search(precision="bf16")``) against the JAX package's Pallas kernels
run with ``use_bf16=True`` in interpret mode, on the CPU, where every
wrapper takes its plain version.

Tolerances.  The bf16 operands (the unit corpus rows and the α-prescaled
unit query, cast from float32) are the JAX package's cast of the port's
float32 operands bitwise, and JAX's own within one bf16 ulp where a
float32 norm, summed in another order, differs by one ulp
(_same_operands).  Every
product of two bf16 values is exact in float32, so the port's plain
versions and the JAX kernels differ only in the order of their float32
sums: scores within 1e-5, ids equal (an id may trade places only with a
score tied within that tolerance).  A bf16 score lies within
α·(2u + u²) + 1e-5 of the float32 score, u = 2^-9 the bf16 unit
roundoff: each operand element is off by at most u relatively, so the
dot product of two unit rows by at most (2u + u²)·Σ|q_i||x_i| ≤ 2u + u²
(Cauchy-Schwarz), scaled by α; 1e-5 covers the float32 sums of both.
The same holds between the i-th scores of two top-k lists."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu.ops.bin_repair import \
    strided_lambda_repair as j_repair
from arrowspace_tpu.ops.pallas_bintopk import _unit_padded
from arrowspace_tpu.ops.pallas_bintopk import binned_lambda_topk as j_binned
from arrowspace_tpu.ops.pallas_topk import fused_lambda_topk as j_merge
from arrowspace_tpu.ops.search import pallas_binned_topk_with_repair
from arrowspace_torch import core
from arrowspace_torch.index import ArrowIndex, _query_prep, \
    session_kernel_kind
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops.search import (INT_MAX, NEG_INF, operand_query,
                                         two_key_topk)

U_BF16 = 2.0 ** -9
TOL = 1e-5
CPU32 = dict(device="cpu", dtype=torch.float32)


def _data(n, f, b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (b, f)).astype(np.float32),
            rng.uniform(0, 1, (b,)).astype(np.float32),
            rng.uniform(0.1, 1.0, (n, f)).astype(np.float32),
            rng.uniform(0, 1, (n,)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _bits(a):
    """The bit patterns of a bf16 tensor or array, as int16."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _bf16_bound(alpha):
    return alpha * (2 * U_BF16 + U_BF16 ** 2) + TOL


def _near_tie_ids(s, i, ref_s, ref_i):
    """ids equal the reference's, or trade places only with a reference
    score within twice the largest score difference."""
    s, ref_s = np.asarray(s, np.float64), np.asarray(ref_s, np.float64)
    err = float(np.abs(s - ref_s).max())
    assert err <= TOL
    for r, j in zip(*np.nonzero(np.asarray(i) != np.asarray(ref_i))):
        pos = np.nonzero(np.asarray(ref_i)[r] == np.asarray(i)[r, j])[0]
        other = ref_s[r, pos[0]] if pos.size else ref_s[r, -1]
        assert abs(other - ref_s[r, j]) <= 2.0 * err


def _same_operands(port_bf16, port_f32, jax_f32):
    """The port's bf16 operand is JAX's round-to-nearest cast of the
    port's float32 unit rows, bitwise; it is JAX's bf16 operand bitwise
    in every row whose float32 unit row equals JAX's, and within one bf16
    ulp elsewhere: the two packages sum |x|² in different orders, which
    can move a norm by one float32 ulp (about half the rows here), and
    that ulp crosses a bf16 rounding boundary in about 1e-5 of the
    values."""
    cast = jnp.asarray(port_f32.numpy()).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(port_bf16), _bits(cast))
    want = _bits(jnp.asarray(jax_f32).astype(jnp.bfloat16))
    same = (port_f32.numpy() == np.asarray(jax_f32)).all(axis=1)
    np.testing.assert_array_equal(_bits(port_bf16)[same], want[same])
    assert int(np.abs(_bits(port_bf16).astype(np.int32)
                      - want.astype(np.int32)).max()) <= 1


@pytest.mark.parametrize("n,f", [(1000, 32), (777, 12), (2048, 128)])
def test_bf16_operands_match_jax(n, f):
    """The prepared bf16 corpus is JAX's _unit_padded(..., bfloat16) and
    the query operand JAX's (unit(q)·α).astype(bfloat16), both from
    float32 (_same_operands); the port pads F to a multiple of 8 with
    zeros."""
    from arrowspace_torch.ops.search import prepare_query, safe_unit
    q, ql, x, xl = _data(n, f, 5, seed=f)
    q[3] = 0.0                                     # a zero row stays zero
    xh, xlh = bt.prepare_binned_corpus(*_t(x, xl), use_bf16=True)
    assert xh.dtype == torch.bfloat16 and xlh.dtype == torch.float32
    width = -(-f // 8) * 8
    assert xh.shape == (-(-n // bt.CORPUS_ALIGN) * bt.CORPUS_ALIGN, width)
    _same_operands(xh[:n, :f], safe_unit(torch.from_numpy(x)),
                   _unit_padded(jnp.asarray(x), 0, jnp.float32))
    assert not xh[:, f:].float().any() and not xh[n:].float().any()
    qh, c1 = operand_query(torch.from_numpy(q), 0.9, torch.float32, xh)
    _same_operands(qh[:, :f], prepare_query(torch.from_numpy(q), 0.9)[0],
                   _unit_padded(jnp.asarray(q), 0, jnp.float32)
                   * jnp.float32(0.9))
    assert qh.shape == (5, width) and not qh[:, f:].float().any()
    assert not qh[3].float().any()
    assert c1 == float(np.float32(1.0) - np.float32(0.9))


def _pool_reference(qh, ql, xh, xlh, c1, n, depth, bins, chunks):
    """Per (query, chunk, bin) the top-depth of the bin's rows by
    (-score, id) and the (depth+1)-th score, in float64 numpy from the
    bf16 operands."""
    plane = (qh.double().numpy() @ xh[:n].double().numpy().T
             - c1 * np.minimum(np.abs(ql.double().numpy()[:, None]
                                      - xlh[:n].double().numpy()[None]),
                               1.0))
    n_tiles = -(-n // bins)
    chunk_rows = -(-n_tiles // chunks) * bins
    chunks = -(-n // chunk_rows)
    bsz = plane.shape[0]
    top_s = np.full((bsz, chunks, depth, bins), NEG_INF)
    top_i = np.full((bsz, chunks, depth, bins), INT_MAX, dtype=np.int64)
    det = np.full((bsz, chunks, bins), NEG_INF)
    for c in range(chunks):
        for b in range(bins):
            g = np.arange(c * chunk_rows + b, min(n, (c + 1) * chunk_rows),
                          bins)
            for r in range(bsz):
                order = np.lexsort((g, -plane[r, g]))
                m = min(depth, g.size)
                top_s[r, c, :m, b] = plane[r, g[order[:m]]]
                top_i[r, c, :m, b] = g[order[:m]]
                if g.size > depth:
                    det[r, c, b] = plane[r, g[order[depth]]]
    return top_s, top_i, det


@pytest.mark.parametrize("n,k", [(1000, 8), (2048, 10), (777, 5),
                                 (4096, 64)])
def test_k1_bf16_plain_matches_jax_kernel(n, k):
    """K1's bf16 plain version: its pool against a float64 reference of
    the same bf16 operands, its flush (scores, ids, flags) against the
    JAX kernel with use_bf16=True in interpret mode."""
    q, ql, x, xl = _data(n, 32, 4, seed=k)
    tq, tql, tx, txl = _t(q, ql, x, xl)
    xh, xlh = bt.prepare_binned_corpus(tx, txl, use_bf16=True)
    qh, c1 = operand_query(tq, 0.9, torch.float32, xh)
    depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
    ps, pi, det = bt.binned_topk_pool(qh, tql, xh, xlh, c1, n, depth=depth,
                                      bins=bins, chunks=2)
    want_s, want_i, want_det = _pool_reference(qh, tql, xh, xlh, c1, n,
                                               depth, bins, 2)
    np.testing.assert_array_equal(pi.numpy(), want_i)
    np.testing.assert_allclose(ps.numpy(), want_s, atol=TOL, rtol=0)
    np.testing.assert_allclose(det.numpy(), want_det, atol=TOL, rtol=0)

    js, ji, jf = j_binned(*_j(q, ql, x, xl), 0.9, k=k, tile=512,
                          interpret=True, block_b=4, use_bf16=True)
    s, i, flags, _ = bt.binned_lambda_topk(tq, tql, tx, txl, 0.9, k=k,
                                           use_bf16=True)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jf) != 0)
    _near_tie_ids(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))
    # prepared and unprepared calls are one computation
    s2, i2, _, _ = bt.binned_lambda_topk(tq, tql, xh, xlh, 0.9, k=k,
                                         prepared=True, n_items=n)
    assert torch.equal(s, s2) and torch.equal(i, i2)


@pytest.mark.parametrize("n,k,rows_per_chunk,f", [
    pytest.param(1000, 8, 256, 32, id="1000-8-256"),
    pytest.param(2048, 8, 512, 32, id="2048-8-512"),
    pytest.param(777, 8, 128, 32, id="777-8-128"),
    pytest.param(300, 20, 64, 32, id="300-20-64"),
    pytest.param(300, 10, 128, 1544, id="300-10-128-f1544"),
    pytest.param(400, 20, 0, 2048, id="400-20-rule-f2048")])
def test_k3_bf16_plain_matches_jax_kernel(n, k, rows_per_chunk, f):
    """K3's bf16 plain version against the JAX kernel in interpret mode,
    at F = 32 and above K1's bf16 gate (F = 1544, 2048; rows_per_chunk 0
    takes the wrapper's rule)."""
    q, ql, x, xl = _data(n, f, 4)
    js, ji = j_merge(*_j(q, ql, x, xl), 0.9, k=k, tile=256, interpret=True,
                     use_bf16=True)
    s, i = tk.fused_lambda_topk(*_t(q, ql, x, xl), 0.9, k=k,
                                rows_per_chunk=rows_per_chunk, use_bf16=True)
    _near_tie_ids(s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji))


def _deep_collision(copies_per_bin, bin_positions, seed=5):
    """> depth copies of query 0 at one bin position of consecutive
    128-row tiles (k = 8: 128 bins, depth 3), for each listed position."""
    rng = np.random.default_rng(seed)
    n, f, k = 3000, 48, 8
    q = rng.uniform(0.1, 1.0, (2, f)).astype(np.float32)
    ql = rng.uniform(0, 1, (2,)).astype(np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    for binpos in bin_positions:
        for j in range(copies_per_bin):
            x[j * 128 + binpos] = q[0]
    return q, ql, x, xl, k


@pytest.mark.parametrize("prepared", [False, True])
def test_strided_repair_bf16_matches_jax(prepared):
    """A planted deep collision flags query 0 in K1's bf16 mode; the
    strided repair on the bf16 corpus (prepared, or raw rows with
    use_bf16) equals JAX's strided_lambda_repair(use_bf16=True) fed the
    same det rows, and the bf16 full scan."""
    q, ql, x, xl, k = _deep_collision(6, [37])
    tq, tql, tx, txl = _t(q, ql, x, xl)
    s, i, flags, det = bt.binned_lambda_topk(tq, tql, tx, txl, 1.0, k=k,
                                             use_bf16=True)
    assert bool(flags[0])
    rows = np.nonzero(flags.numpy())[0]
    args = (det.numpy()[rows], s.numpy()[rows, k - 1], i.numpy()[rows])
    items = bt.prepare_binned_corpus(tx, txl, use_bf16=True) if prepared \
        else (tx, txl)
    calls = br.strided_lambda_repair.calls
    rs, ri = br.strided_lambda_repair(
        tq[rows], tql[rows], *args, *items, 1.0, k=k, n=x.shape[0],
        prepared=prepared, use_bf16=True)
    assert br.strided_lambda_repair.calls == calls + 1
    js, ji = j_repair(q[rows], ql[rows], *args, jnp.asarray(x),
                      jnp.asarray(xl), 1.0, k=k, n=x.shape[0],
                      prepared=False, use_bf16=True)
    _near_tie_ids(rs, ri, np.asarray(js), np.asarray(ji))
    fs, fi = tk.fused_lambda_topk(tq[rows], tql[rows], tx, txl, 1.0, k=k,
                                  use_bf16=True)
    _near_tie_ids(rs, ri, fs.numpy(), fi.numpy())
    assert ri[0, :6].tolist() == [37 + 128 * j for j in range(6)]


def _clustered(n, f, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (12, f))
    return c[rng.integers(0, 12, n)] + rng.normal(0, 0.05, (n, f))


@pytest.fixture
def small_gate(monkeypatch):
    """The streaming kernels' size gate lowered to 1000 rows, so a small
    CPU index serves through K1's (and K3's) plain versions."""
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1000)


@pytest.fixture(scope="module")
def served():
    """A 3000 x 24 float32 CPU index whose row 0 has 4 copies in each of
    three bins (its repair overflows to K3) and row 1 5 copies in one
    (the strided repair alone), and a batch of 64 perturbed rows."""
    rows = _clustered(3000, 24, 4)
    for src, bins_at in ((0, (5, 17, 29)), (1, (77,))):
        for b in bins_at:
            rows[b + 128 * (2 + np.arange(4 + src))] = rows[src]
    idx = ArrowIndex.build(rows, eps=1.0, seed=4, **CPU32)
    rng = np.random.default_rng(6)
    queries = rows[rng.integers(0, 3000, 64)] * 1.02
    queries[:2] = rows[:2] * 1.02
    q = torch.tensor(queries, dtype=torch.float32)
    _, qlam = _query_prep(idx.aspace, idx.gl)[1](q)
    return idx, rows, queries, qlam


def test_bf16_session_and_search_match_jax(small_gate, served):
    """A bf16 SearchSession and search(precision="bf16") serve K1's bf16
    mode with its repair (strided, and K3's bf16 mode for the overflowing
    row), equal to JAX's pallas_binned_topk_with_repair(use_bf16=True) in
    interpret mode on the same query λ."""
    idx, rows, queries, qlam = served
    sess = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                   precision="bf16")
    assert (sess.kernel, sess.precision) == ("binned", "bf16")
    repairs = br.strided_lambda_repair.calls
    (gs, gi), = list(sess.search_stream([queries]))
    assert br.strided_lambda_repair.calls == repairs + 1
    a = idx.aspace
    js, ji = pallas_binned_topk_with_repair(
        jnp.asarray(queries, dtype=jnp.float32), jnp.asarray(qlam.numpy()),
        jnp.asarray(a.data.numpy()), jnp.asarray(a.lambdas.numpy()), 0.9,
        k=10, use_bf16=True, interpret=True)
    _near_tie_ids(gs, gi, np.asarray(js), np.asarray(ji))
    copies = sorted([0] + [b + 128 * (2 + j) for b in (5, 17, 29)
                           for j in range(4)])
    assert gi[0].tolist() == copies[:10]
    ss, si = idx.search(queries, k=10, alpha=0.9, precision="bf16")
    np.testing.assert_array_equal(si, gi)
    np.testing.assert_allclose(ss, gs, atol=TOL, rtol=0)


def test_bf16_merge_route_matches_jax(small_gate, served, monkeypatch):
    """Above K1's bf16 gate (lowered here to F = 16) the bf16 session and
    search take K3's bf16 mode, equal to JAX's fused_lambda_topk with
    use_bf16=True."""
    monkeypatch.setattr(bt, "BF16_MAX_F", 16)
    idx, rows, queries, qlam = served
    assert session_kernel_kind(3000, 10, 24, True) == "merge"
    assert session_kernel_kind(3000, 10, 24) == "binned"
    sess = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                   precision="bf16")
    assert (sess.kernel, sess.precision) == ("merge", "bf16")
    (gs, gi), = list(sess.search_stream([queries]))
    a = idx.aspace
    js, ji = j_merge(jnp.asarray(queries, dtype=jnp.float32),
                     jnp.asarray(qlam.numpy()), jnp.asarray(a.data.numpy()),
                     jnp.asarray(a.lambdas.numpy()), 0.9, k=10, tile=256,
                     interpret=True, use_bf16=True)
    _near_tie_ids(gs, gi, np.asarray(js), np.asarray(ji))
    ss, si = idx.search(queries, k=10, alpha=0.9, precision="bf16")
    np.testing.assert_array_equal(si, gi)


def test_bf16_plain_route_serves_float32(served):
    """Below the streaming kernels' size the bf16 request serves the
    plain scan in the index dtype, as the JAX package's "xla" route."""
    idx, rows, queries, qlam = served
    sess = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                   precision="bf16")
    assert (sess.kernel, sess.precision) == ("plain", "f32")
    (gs, gi), = list(sess.search_stream([queries]))
    fs, fi = idx.search(queries, k=10, alpha=0.9)
    bs, bi = idx.search(queries, k=10, alpha=0.9, precision="bf16")
    np.testing.assert_array_equal(bi, fi)
    np.testing.assert_array_equal(bs, fs)
    np.testing.assert_array_equal(gi, fi)


def test_live_bf16_session_equals_static(small_gate, served):
    """A live bf16 session holds a bf16 capacity buffer and returns the
    static bf16 session's results bitwise; a row added through it is
    written by prepared_rows, bitwise the prepared row it copies, and at
    α = 1 (no λ term) ties with it, the lower id first."""
    idx, rows, queries, qlam = served
    static = idx.make_search_session(batch_size=64, k=10, alpha=0.9,
                                     precision="bf16")
    (ss, si), = list(static.search_stream([queries]))
    live = idx.make_live_session(batch_size=64, k=10, alpha=0.9,
                                 capacity=4000, precision="bf16")
    assert (live.kernel, live.precision) == ("binned", "bf16")
    assert live._xhat.dtype == torch.bfloat16
    ls, li = live.search(queries)
    np.testing.assert_array_equal(li, si)
    np.testing.assert_array_equal(ls, ss)
    live = idx.make_live_session(batch_size=64, k=10, alpha=1.0,
                                 capacity=4000, precision="bf16")
    new = live.add(rows[[7, 900]])
    xh, _ = bt.prepare_binned_corpus(idx.aspace.data, idx.aspace.lambdas,
                                     use_bf16=True)
    n = idx.nitems
    assert torch.equal(live._xhat[n:n + 2], xh[[7, 900]])
    ls, li = live.search(rows[[7]] * 1.02)
    hit = list(li[0])
    a, b = hit.index(7), hit.index(int(new[0]))
    assert ls[0][a] == ls[0][b] and a < b
    live.update([int(new[1])], rows[[3]])
    assert torch.equal(live._xhat[n + 1], xh[3])


def test_bf16_ties_lowest_id_first():
    """Two distinct float32 rows whose bf16 unit rows are equal tie: K1's
    and K3's bf16 plain versions return them with equal scores, the
    lower id first."""
    q, ql, x, xl = _data(2000, 32, 3, seed=21)
    rng = np.random.default_rng(3)
    ids = [40, 41, 1333]
    x[ids] = q[0] * (1.0 + 1e-6 * rng.standard_normal((3, 32)))
    xl[ids] = ql[0]
    tq, tql, tx, txl = _t(q, ql, x, xl)
    assert not torch.equal(tx[40], tx[41])
    xh, _ = bt.prepare_binned_corpus(tx, txl, use_bf16=True)
    assert torch.equal(xh[40], xh[41]) and torch.equal(xh[40], xh[1333])
    for s, i in (bt.binned_lambda_topk(tq, tql, tx, txl, 0.9, k=5,
                                       use_bf16=True)[:2],
                 tk.fused_lambda_topk(tq, tql, tx, txl, 0.9, k=5,
                                      use_bf16=True, rows_per_chunk=512)):
        assert i[0, :3].tolist() == ids
        assert bool((s[0, :3] == s[0, 0]).all())


def test_bf16_gates_and_precision_names():
    """K1's bf16 gate admits F = 1536 (the JAX session's binned limit);
    float32 serves K1 only up to F = 352 (its wgmma route) and K3 above,
    F = 1264 included.  Above 1536 bf16 serves K3.  An unknown precision
    raises ValueError in every entry point."""
    n = 1_000_000
    assert session_kernel_kind(n, 10, 1536, True) == "binned"
    assert session_kernel_kind(n, 10, 1536) == "merge"
    assert session_kernel_kind(n, 10, 1537, True) == "merge"
    assert session_kernel_kind(n, 10, 1544, True) == "merge"
    assert session_kernel_kind(n, 10, 1264) == "merge"
    assert session_kernel_kind(n, 129, 128, True) == "plain"
    assert bt.query_block(1536, 2048, True) == 64
    assert bt.query_block(768, 2048, True) == 128
    assert bt.query_block(768, 2048) == 64
    assert bt._bintopk_smem(1536, 64, True) == 230_472
    idx = ArrowIndex.build(_clustered(300, 8, 1), eps=1.0, seed=1, **CPU32)
    for make in (idx.make_search_session, idx.make_live_session):
        with pytest.raises(ValueError):
            make(batch_size=4, precision="fp8")
    with pytest.raises(ValueError):
        idx.search(np.ones((1, 8)), precision="fp8")


@pytest.mark.parametrize("f,qb,stages", [(8, 128, 16), (72, 128, 16),
                                          (128, 128, 16), (136, 128, 16),
                                          (768, 128, 8), (832, 128, 4),
                                          (896, 64, 14), (1000, 64, 12),
                                          (1536, 64, 4)])
def test_k1_bf16_ring_rule(f, qb, stages):
    """K1's bf16 kernel keeps its query block resident and unpadded:
    ceil(F/64) tiles of qb rows × 128 bytes (one 64-feature bf16 row is
    the 128-byte swizzle), after 1024 bytes that align them; beside it a
    ring of as many stages of 4096/qb corpus rows × 128 bytes as fit
    (at most 16), each with two 8-byte barriers, plus the query block's.
    The query block is 128 where that ring has 3 stages, else 64; the
    shared memory stays within 232,448 bytes; the grid has one CTA per
    query block and group of 4096/qb bins."""
    assert bt.query_block(f, 2048, True) == qb
    assert bt.bf16_stages(f, qb) == stages >= 3
    smem = bt._bintopk_smem(f, qb, True)
    assert smem == (1024 + -(-f // 64) * qb * 128
                    + stages * ((4096 // qb) * 128 + 16) + 8)
    assert smem <= 232_448 and bt.bintopk_fits(f, True)
    if qb == 64:     # the 128-query block's ring would hold fewer than 3
        assert bt.bf16_stages(f, 128) < 3
        assert bt._bintopk_smem(f, 128, True) > 232_448
    for bsz in (1, 63, 64, 96, 97, 2048):
        want = 128 if qb == 128 and bsz > 96 else 64
        assert bt.query_block(f, bsz, True) == want
        for bins in (128, 256, 512):
            assert bt.grid_ctas(bsz, bins, f, True) == \
                -(-bsz // want) * (bins // (4096 // want))


def test_k1_bf16_gate_and_the_float32_rule():
    """The bf16 gate stops at BF16_MAX_F = 1536 (the JAX session's binned
    limit), though a 3-stage ring would still fit at 1544; the float32
    rule is the tensor-core layout's (rows at stride ceil8(F) + 4, two
    slices of 4096/qb rows at stride 68), untouched by the bf16
    kernel's."""
    assert bt.bintopk_fits(1536, True) and bt.bintopk_fits(1530, True)
    assert not bt.bintopk_fits(1544, True)
    assert bt.bf16_stages(1544, 64) == 3
    assert bt.bintopk_fits(1) and bt.bintopk_fits(1264)
    assert not bt.bintopk_fits(1265)
    for f, qb in ((128, 128), (768, 64), (1264, 32)):
        assert bt.query_block(f, 2048) == qb
        assert bt._bintopk_smem(f, qb) == (
            qb * (-(-f // 8) * 8 + 4) + 2 * (4096 // qb) * 68) * 4
    assert bt.query_block(768, 1) == 32 and bt.query_block(768, 1, True) == 64


@pytest.mark.parametrize("f,k,resident,stages", [
    (8, 10, True, 8), (128, 10, True, 8), (128, 64, True, 7),
    (128, 128, True, 5), (136, 128, True, 4), (768, 1, True, 4),
    (768, 10, True, 3), (768, 64, False, 5), (1536, 10, False, 6),
    (1536, 128, False, 4), (3072, 10, False, 6), (4096, 128, False, 4)])
def test_k3_bf16_merge_rule(f, k, resident, stages):
    """K3's bf16 kernel: 64 queries × 128 corpus rows a CTA (two
    warpgroups of wgmma m64n64k16); its shared memory is 1024 bytes to
    align the 128-byte-swizzled tiles, the resident query block
    (ceil(F/64) slices of 64 rows × 128 bytes), a ring of stages (the
    tile's 128 rows × 128 bytes, and the query slice where it is not
    resident) with two 8-byte barriers each plus the query block's, and
    per query its k-th word, top-k list and candidate buffer of one tile
    as (score, id) and its count.  The query block is resident where a
    3-stage ring fits beside it; the ring is as deep as fits, at most 8;
    one CTA an SM; rows per chunk are whole tiles, the chunk count whole
    waves of the grid's CTAs, up to one chunk an SM (the float32 kernel's
    one chunking)."""
    assert tk.merge_bf16_plan(f, k) == (resident, stages)
    smem = tk.merge_smem_bytes(f, k, True)
    assert smem == (1024 + (-(-f // 64) * 8192 if resident else 0)
                    + stages * (128 * 128 + (0 if resident else 8192))
                    + (2 * stages + 1) * 8 + 64 * 8 + 64 * k * 8
                    + 64 * 128 * 8 + 64 * 4)
    assert smem <= 232_448 and 3 <= stages <= 8
    if not resident:
        assert tk._bf16_smem(f, k, True, 3) > 232_448
    if stages < 8:
        assert tk._bf16_smem(f, k, resident, stages + 1) > 232_448
    assert 2 * (smem + 1024) > 228 * 1024      # one CTA an SM
    for bsz, n, sms in ((2048, 1_000_000, 132), (1, 1_000_000, 132),
                        (97, 5003, 132), (1, 1, 1)):
        rpc = tk.merge_rows_per_chunk(bsz, n, sms)
        n_tiles = -(-n // 128)
        chunks = bt.wave_chunks(-(-bsz // 64), n_tiles, sms, sms)
        assert rpc % 128 == 0 and rpc == -(-n_tiles // chunks) * 128
    # a single query block fills the card: 119 chunks of 66 tiles
    assert tk.merge_rows_per_chunk(1, 1_000_000, 132) == 66 * 128


def test_k3_bf16_rule_admits_every_shape():
    """Every shape the bf16 merge admits, k = 1..128 at F = 8..4096 (a
    multiple of 8): a ring of at least 3 stages within 232,448 bytes, so
    the wrapper refuses none of them."""
    for f in range(8, 4097, 8):
        for k in range(1, 129):
            resident, stages = tk.merge_bf16_plan(f, k)
            assert stages >= 3
            assert tk._bf16_smem(f, k, resident, stages) <= 232_448


def test_k3_float32_merge_rule_unchanged():
    """K3's float32 and bf16 kernels share their plan's block: 64
    queries (QUERY_BLOCK) × 128 corpus rows (TILE_ROWS, two warpgroups of
    64) a CTA, their stages built from the same 128-byte rows, their
    selection state the same at each k, and shared memory that leaves
    one CTA an SM at every F and k, so one chunking (merge_rows_per_chunk,
    which takes neither F nor the dtype) serves both."""
    assert (tk.QUERY_BLOCK, tk.TILE_ROWS) == (64, 128)
    assert tk._bf16_stage(True) == tk.TILE_ROWS * 128
    assert tk._bf16_stage(False) == (tk.TILE_ROWS + tk.QUERY_BLOCK) * 128
    assert tk._TF32_STAGE == (tk.TILE_ROWS + 2 * tk.QUERY_BLOCK) * 128
    for k in (1, 10, 64, 128):
        sel = tk._select_smem(k)
        assert tk._tf32_smem(k, 0) == 1024 + sel
        assert tk._bf16_smem(128, k, False, 0) == 1024 + 8 + sel
        for f in (8, 128, 1536, 4096):
            for bf16 in (False, True):
                assert 2 * (tk.merge_smem_bytes(f, k, bf16) + 1024) \
                    > 228 * 1024


@pytest.mark.parametrize("alpha", [0.9, 1.0])
def test_bf16_scores_within_bound_of_float32(small_gate, served, alpha):
    """bf16 top-k scores lie within α·(2u + u²) + 1e-5 of float32's, rank
    by rank, and within the same bound of the float32 scores of the ids
    bf16 returns."""
    idx, rows, queries, qlam = served
    q = torch.tensor(queries, dtype=torch.float32)
    a = idx.aspace
    s16, i16 = core.lambda_aware_topk(q, qlam, a.data, a.lambdas, alpha,
                                      k=10, use_bf16=True)
    s32, i32 = core.lambda_aware_topk(q, qlam, a.data, a.lambdas, alpha,
                                      k=10)
    bound = _bf16_bound(alpha)
    assert float((s16 - s32).abs().max()) <= bound
    xh, xlh = bt.prepare_binned_corpus(a.data, a.lambdas)
    qh, c1 = operand_query(q, alpha, torch.float32, xh)
    rows32 = xh[i16]
    at16 = (rows32 * qh[:, None, :]).sum(-1) - c1 * (
        qlam[:, None] - xlh[i16]).abs().clamp_max(1.0) + c1
    assert float((s16 - at16).abs().max()) <= bound
    assert float((s16 - s32).abs().max()) > 1e-4      # bf16 did round
