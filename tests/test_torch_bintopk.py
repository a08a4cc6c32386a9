"""K1 (binned top-k), K3 (merge top-k) and the strided repair of
arrowspace_torch against the JAX package's Pallas kernels run in
interpret mode, the plain full scan, and a per-bin numpy reference.

Ids must match exactly; float32 scores agree to 1e-6 (one dot product,
summed in a different order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arrowspace_tpu.ops.pallas_bintopk import binned_lambda_topk as j_binned
from arrowspace_tpu.ops.pallas_topk import fused_lambda_topk as j_merge
from arrowspace_tpu.ops.search import batched_lambda_aware_topk as j_plain
from arrowspace_torch.energymaps import energy_binned_fits
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import energy_approx as ea
from arrowspace_torch.ops import energy_bintopk as eb
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops.search import (INT_MAX, NEG_INF,
                                         batched_lambda_aware_topk,
                                         binned_topk_with_repair,
                                         operand_query, prepare_query,
                                         safe_unit, two_key_topk)


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


def _pool_reference(plane, n, depth, bins, tiles_per_chunk):
    """Per (query, chunk, bin): the top-depth of the bin's rows by
    (-score, id) and the (depth+1)-th score, in numpy."""
    bsz = plane.shape[0]
    chunk_rows = tiles_per_chunk * bins
    chunks = -(-n // chunk_rows)
    top_s = np.full((bsz, chunks, depth, bins), NEG_INF)
    top_i = np.full((bsz, chunks, depth, bins), INT_MAX, dtype=np.int64)
    det = np.full((bsz, chunks, bins), NEG_INF)
    for c in range(chunks):
        for b in range(bins):
            g = np.arange(c * chunk_rows + b, min(n, (c + 1) * chunk_rows),
                          bins)
            for q in range(bsz):
                order = np.lexsort((g, -plane[q, g]))
                m = min(depth, g.size)
                top_s[q, c, :m, b] = plane[q, g[order[:m]]]
                top_i[q, c, :m, b] = g[order[:m]]
                if g.size > depth:
                    det[q, c, b] = plane[q, g[order[depth]]]
    return top_s, top_i, det


@pytest.mark.parametrize("n,bins,depth,chunks", [(1000, 128, 3, 1),
                                                 (1000, 128, 3, 3),
                                                 (2000, 256, 2, 2),
                                                 (777, 512, 4, 1)])
def test_k1_plain_pool_and_det_contract(n, bins, depth, chunks):
    q, ql, x, xl = _t(*_data(n, 16, 3, seed=n))
    q, ql, x, xl = q.double(), ql.double(), x.double(), xl.double()
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(q, 0.8)
    ps, pi, det = bt.binned_topk_pool_plain(qh, ql, xh, xlh, c1, n,
                                            depth=depth, bins=bins,
                                            chunks=chunks)
    plane = (qh.numpy() @ xh[:n].numpy().T
             - c1 * np.minimum(np.abs(ql.numpy()[:, None]
                                      - xlh[:n].numpy()[None, :]), 1.0))
    n_tiles = -(-n // bins)
    want_s, want_i, want_det = _pool_reference(plane, n, depth, bins,
                                               -(-n_tiles // chunks))
    np.testing.assert_array_equal(pi.numpy(), want_i)
    np.testing.assert_allclose(ps.numpy(), want_s, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(det.numpy(), want_det, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n,k", [(1000, 8), (2048, 10), (777, 5),
                                 (4096, 64)])
def test_k1_flush_matches_jax_kernel_and_plain_scan(n, k):
    q, ql, x, xl = _data(n, 32, 4, seed=k)
    js, ji, jf = j_binned(*_j(q, ql, x, xl), 0.9, k=k, tile=512,
                          interpret=True, block_b=4)
    ps, pi = j_plain(*_j(q, ql, x, xl), jnp.float32(0.9), k=k)
    s, i, flags, det = bt.binned_lambda_topk(*_t(q, ql, x, xl), 0.9, k=k)
    assert not np.asarray(jf).any() and not flags.any()
    assert det.shape == (4, bt.bins_target(k))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), atol=1e-6)


def test_k1_duplicate_tie_order_across_bins():
    """Copies of the query at consecutive ids (distinct bins) come back
    in id order, unflagged."""
    q, ql, x, xl = _data(2000, 32, 1, seed=11)
    xl[:] = 0.5
    ql[:] = 0.5
    for j in range(4):
        x[700 + j] = q[0]
    s, i, flags, _ = bt.binned_lambda_topk(*_t(q, ql, x, xl), 1.0, k=6)
    assert i[0, :4].tolist() == [700, 701, 702, 703]
    assert not flags.any()
    ps, pi = j_plain(*_j(q, ql, x, xl), jnp.float32(1.0), k=6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))


def _deep_collision(copies_per_bin, bin_positions, seed=5):
    """The fixture of test_pallas_kernels.py (deep collision): > depth
    copies of query 0 in the same bin, for each listed bin position."""
    rng = np.random.default_rng(seed)
    n, f, tile, k = 3000, 48, 256, 8
    q = rng.uniform(0.1, 1.0, (2, f)).astype(np.float32)
    ql = rng.uniform(0, 1, (2,)).astype(np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    for binpos in bin_positions:
        for j in range(copies_per_bin):
            x[j * tile + binpos] = q[0]
    return q, ql, x, xl, k


def test_deep_collision_flagged_and_strided_repair_exact():
    q, ql, x, xl, k = _deep_collision(6, [37])       # one fired bin
    jf = np.asarray(j_binned(*_j(q, ql, x, xl), 1.0, k=k, tile=256,
                             interpret=True, block_b=2)[2])
    assert jf[0] == 1
    s, i, flags, det = bt.binned_lambda_topk(*_t(q, ql, x, xl), 1.0, k=k)
    assert bool(flags[0]), "deep collision must be flagged"
    calls, k3 = br.strided_lambda_repair.calls, tk.merge_topk_partial.launches
    rs, ri = binned_topk_with_repair(*_t(q, ql, x, xl), 1.0, k=k)
    assert br.strided_lambda_repair.calls == calls + 1
    assert tk.merge_topk_partial.launches == k3        # CPU: plain version
    ps, pi = j_plain(*_j(q, ql, x, xl), jnp.float32(1.0), k=k)
    np.testing.assert_array_equal(ri.numpy(), np.asarray(pi))
    np.testing.assert_allclose(rs.numpy(), np.asarray(ps), atol=1e-6)


def test_repair_overflow_falls_back_to_merge_topk():
    """More than MAX_FIRED fired bins: the repair hands the row to its
    fallback (K3 through fused_lambda_topk) and the result is exact."""
    q, ql, x, xl, k = _deep_collision(4, [37, 61, 90])
    s, i, flags, det = bt.binned_lambda_topk(*_t(q, ql, x, xl), 1.0, k=k)
    fired, ok = br.fired_bins_host(det.numpy(), s[:, k - 1].numpy())
    assert bool(flags[0]) and not ok[0]
    used = []

    def fallback(rows):
        used.extend(rows.tolist())
        tq, tql, tx, txl = _t(q, ql, x, xl)
        rs, ri = tk.fused_lambda_topk(tq[rows], tql[rows], tx, txl, 1.0, k=k)
        return rs.numpy(), ri.numpy()

    tq, tql, tx, txl = _t(q, ql, x, xl)
    rows = np.nonzero(flags.numpy())[0]
    rs, ri = br.strided_lambda_repair(
        tq[rows], tql[rows], det.numpy()[rows], s.numpy()[rows, k - 1],
        i.numpy()[rows], tx, txl, 1.0, k=k, n=x.shape[0], prepared=False,
        fallback=fallback, cur_scores=s.numpy()[rows])
    assert used == [0]
    ps, pi = j_plain(*_j(q, ql, x, xl), jnp.float32(1.0), k=k)
    np.testing.assert_array_equal(ri, np.asarray(pi)[rows])
    np.testing.assert_allclose(rs, np.asarray(ps)[rows], atol=1e-6)
    # the same row through the engine's own repair (repair_flagged)
    calls = br.strided_lambda_repair.calls
    ws, wi = binned_topk_with_repair(tq, tql, tx, txl, 1.0, k=k)
    assert br.strided_lambda_repair.calls == calls + 1
    np.testing.assert_array_equal(wi.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ws.numpy(), np.asarray(ps), atol=1e-6)


def test_engine_repairs_flagged_rows_in_stream(monkeypatch):
    """The session's pieces, BinnedTopK.step and .repair driven by
    stream_search: query 0 collides in three bins (its repair falls back
    to K3), query 1 in one bin (the strided repair alone); both come back
    equal to the full scan."""
    from arrowspace_torch.index import stream_search
    q, ql, x, xl, k = _deep_collision(4, [37, 61, 90])
    x[1000 + 128 * np.arange(5)] = q[1]
    tq, tql, tx, txl = _t(q, ql, x, xl)
    eng = br.BinnedTopK(tx, txl, 1.0, k)
    merged, plain = [], tk.merge_topk_partial_plain
    monkeypatch.setattr(tk, "merge_topk_partial_plain",
                        lambda *a, **kw: merged.append(1) or plain(*a, **kw))

    def step(qb):
        s, i, flags, det = eng.step(qb, tql)
        assert flags.all()
        return s, i, flags, tql, det

    calls = br.strided_lambda_repair.calls
    (s, i), = list(stream_search(step, [q], 2, 1, "cpu", torch.float32,
                                 repair=eng.repair))
    assert br.strided_lambda_repair.calls == calls + 1 and merged
    ps, pi = j_plain(*_j(q, ql, x, xl), jnp.float32(1.0), k=k)
    np.testing.assert_array_equal(i, np.asarray(pi))
    np.testing.assert_allclose(s, np.asarray(ps), atol=1e-6)


@pytest.mark.parametrize("n,k,rows_per_chunk", [(1000, 8, 256),
                                                (2048, 8, 512),
                                                (777, 8, 128),
                                                (300, 20, 64)])
def test_k3_plain_matches_jax_kernel_interpret(n, k, rows_per_chunk):
    q, ql, x, xl = _data(n, 32, 4)
    js, ji = j_merge(*_j(q, ql, x, xl), 0.9, k=k, tile=256, interpret=True)
    s, i = tk.fused_lambda_topk(*_t(q, ql, x, xl), 0.9, k=k,
                                rows_per_chunk=rows_per_chunk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


def test_wrappers_on_cpu_take_plain_versions():
    q, ql, x, xl = _t(*_data(900, 16, 3, seed=2))
    xh, xlh = bt.prepare_binned_corpus(x, xl)
    qh, c1 = prepare_query(q, 0.7)
    k1, k3 = bt.binned_topk_pool.launches, tk.merge_topk_partial.launches
    a = bt.binned_topk_pool(qh, ql, xh, xlh, c1, 900, depth=3, bins=128,
                            chunks=2)
    b = bt.binned_topk_pool_plain(qh, ql, xh, xlh, c1, 900, depth=3,
                                  bins=128, chunks=2)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    c = tk.merge_topk_partial(qh, ql, xh, xlh, c1, 900, k=5,
                              rows_per_chunk=256)
    d = tk.merge_topk_partial_plain(qh, ql, xh, xlh, c1, 900, k=5,
                                    rows_per_chunk=256)
    assert all(torch.equal(u, v) for u, v in zip(c, d))
    assert (bt.binned_topk_pool.launches, tk.merge_topk_partial.launches) \
        == (k1, k3)


def test_two_key_topk_ties_to_lowest_id():
    s = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]], dtype=torch.float64)
    ids = torch.tensor([[40, 7, 3, 2, 0]])
    out_s, out_i = two_key_topk(s, ids, 4)
    assert out_i.tolist() == [[2, 7, 3, 40]]
    assert out_s.tolist() == [[0.9, 0.9, 0.5, 0.5]]


def test_plain_scan_matches_jax_f64():
    rng = np.random.default_rng(8)
    q, ql = rng.normal(size=(5, 12)), rng.uniform(0, 1, 5)
    x, xl = rng.normal(size=(400, 12)), rng.uniform(0, 1, 400)
    x[17] = x[3]                               # exact duplicate rows
    s, i = batched_lambda_aware_topk(*_t(q, ql, x, xl), 0.8, k=9)
    js, ji = j_plain(*_j(q, ql, x, xl), jnp.float64(0.8), k=9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-12)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 values: round to the nearest value with
    10 mantissa bits, ties away from zero (add 0x1000 to the bits, clear
    the low 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _trunc32(v: torch.Tensor) -> torch.Tensor:
    """float64 values rounded toward zero to float32."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _tensor_core_dot(q, x, terms, *, truncate=False, partial=None):
    """The dot products of K1 (csrc/bintopk.cu) and the energy tile
    (csrc/energy_tile.cuh): F padded with zeros to whole 8-feature
    k-steps; at each step the listed TF32 products, in order, each summed
    exactly into the float32 accumulator as one m16n8k8 mma.sync does,
    and rounded to nearest or, with ``truncate``, toward zero (the tensor
    core's accumulate truncates).  With ``partial``, every run of that
    many features sums into a zeroed partial that one rounded float32 add
    joins to the dot product (both kernels: 64)."""
    fp = -(-q.shape[1] // 8) * 8
    q = torch.nn.functional.pad(q, (0, fp - q.shape[1]))
    x = torch.nn.functional.pad(x, (0, fp - x.shape[1]))
    qh, xh = _tf32_rna(q), _tf32_rna(x)
    parts = {"qh": qh, "ql": _tf32_rna(q - qh), "xh": xh,
             "xl": _tf32_rna(x - xh)}
    rnd = _trunc32 if truncate else (lambda v: v.float())
    step = partial or fp
    acc = torch.zeros(q.shape[0], x.shape[0], dtype=torch.float32)
    for p0 in range(0, fp, step):
        part = torch.zeros_like(acc)
        for k0 in range(p0, min(fp, p0 + step), 8):
            for qp, xp in terms:
                a = parts[qp][:, k0:k0 + 8].double()
                b = parts[xp][:, k0:k0 + 8].double()
                part = rnd(part.double() + a @ b.T)
        acc = (acc.double() + part.double()).float()
    return acc


_THREE_TF32 = (("ql", "xh"), ("qh", "xl"), ("qh", "xh"))


@pytest.mark.parametrize("f", [128, 768])
def test_k1_three_tf32_split_keeps_float32_accuracy(f):
    """On the smoke run's corpus (64 centres in [0.2, 0.8], noise 0.05,
    unit rows; queries perturbed ×1.02, α-prescaled with α = 0.9) the
    3×TF32 product stays within 2e-6 of float64, under the 1e-5 score
    tolerance, where one TF32 product does not; identical rows get
    bitwise identical scores."""
    rng = np.random.default_rng(f)
    centres = rng.uniform(0.2, 0.8, (64, f))
    x = centres[rng.integers(0, 64, 512)] + rng.normal(0, 0.05, (512, f))
    x[300] = x[7]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, 512, 16)] * 1.02
    q = 0.9 * q / np.linalg.norm(q, axis=1, keepdims=True)
    qt, xt = (torch.tensor(a, dtype=torch.float32) for a in (q, x))
    ref = qt.double() @ xt.double().T
    three = _tensor_core_dot(qt, xt, _THREE_TF32)
    one = _tensor_core_dot(qt, xt, (("qh", "xh"),))
    assert float((three.double() - ref).abs().max()) <= 2e-6
    assert float((one.double() - ref).abs().max()) > 1e-5
    assert torch.equal(three[:, 300], three[:, 7])


def test_tf32_rna_rounds_to_nearest_ties_away():
    """Also bit-exact against a float64 rounding to 11 significant bits,
    ties away from zero: on exact ties of both signs, and where rounding
    carries into the exponent."""
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11],
                     dtype=torch.float32)
    assert _tf32_rna(v).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                     1.0, 1.0 + 2.0 ** -9]
    rng = np.random.default_rng(22)
    bits = rng.integers(0x3F000000, 0x3F800000, 2000).astype(np.uint32)
    ties = ((bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)).view(np.float32)
    carry = np.array([np.nextafter(np.float32(1.0), np.float32(0.0)),
                      1.0 - 2.0 ** -12, -0.999999], dtype=np.float32)
    v = np.concatenate([ties, -ties, carry])
    m, e = np.frexp(v.astype(np.float64))      # v = m · 2^e, |m| in [.5, 1)
    ref = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5), e - 11)
    np.testing.assert_array_equal(_tf32_rna(torch.from_numpy(v)).numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("bins", [128, 256, 512])
@pytest.mark.parametrize("f,qs,qb", [(7, 12, 128), (40, 44, 128),
                                     (128, 132, 128), (416, 420, 128),
                                     (417, 428, 64), (768, 772, 64),
                                     (769, 780, 32), (1264, 1268, 32)])
def test_k1_gate_for_the_tensor_core_layout(bins, f, qs, qb):
    """K1's CTA holds 4096 (query, bin) pairs: the largest query block of
    128, 64, 32 whose shared memory fits (the block's rows at stride
    ceil8(F) + 4, two slices of 4096/qb rows × 64 features at stride 68)
    and a grid axis over the groups of 4096/qb bins.  The gate is the
    32-query block's, the same at every bin count.  The energy tile (K6,
    K7) stages a query slice beside each corpus slice, so its gate admits
    every z-width, those the fp32 fold admitted among them, and its
    query block is 128 only where the z-plane is one 64-feature slice."""
    smem = (qb * qs + 2 * (4096 // qb) * 68) * 4
    assert smem <= 227 * 1024 and bt.bintopk_fits(f)
    assert bt.query_block(f, 2048) == qb
    if qb < 128:   # the next larger block does not fit
        assert (2 * qb * qs + 2 * (4096 // (2 * qb)) * 68) * 4 > 227 * 1024
    assert bt.query_block(f, 37) == min(qb, 64)
    assert bt.query_block(f, 1) == 32
    assert not bt.bintopk_fits(1265)
    # B = 2048 always gives 64 CTAs per 128 bins, whatever the block
    assert bt.grid_ctas(2048, bins, f) == 64 * (bins // 128)
    assert bt.grid_ctas(37, bins, f) == -(-37 // min(qb, 64)) * (
        bins * min(qb, 64) // 4096)
    # the fp32 fold's widest z-plane at this bin count, and wider
    widest = {128: 1268, 256: 1452, 512: 2652}[bins]
    k = {128: 10, 256: 20, 512: 64}[bins]
    assert bt.bins_target(k) == bins
    for g in (1, f, widest, widest + 1, 4 * widest):
        assert energy_binned_fits(1_000_000, k, g)
    eqb = 128 if f <= 64 else 64
    assert eb.energy_query_block(f, 2048) == eqb
    assert eb.energy_query_block(f, 37) == 64
    assert eb.energy_query_block(f, 1) == 32
    # B = 2048: K6 64 CTAs per 128 bins, as K1; K7 (8 pairs a thread) 128
    assert eb.energy_grid_ctas(2048, bins, f, eb.K6_PAIRS) == bins // 2
    assert eb.energy_grid_ctas(2048, bins, f, ea.K7_PAIRS) == bins
    assert eb.energy_grid_ctas(37, bins, f, ea.K7_PAIRS) == bins * 64 // 2048
    # whole waves on 132 SMs at B = 2048 and 1M rows
    n_tiles = -(-1_000_000 // bins)
    want = {128: 2, 256: 1, 512: 1}[bins]
    ctas = bt.grid_ctas(2048, bins, f)
    assert bt.wave_chunks(ctas, n_tiles, 132) == want
    assert bt._default_chunks(ctas, n_tiles, torch.device("cpu")) == 1


# K1's float32 wgmma route (csrc/bintopk_tf32.cu): ring stages by F
_TF32_STAGES = {8: 13, 72: 11, 100: 10, 128: 10, 256: 6, 352: 3, 356: 2,
                768: 0, 1264: 0}


@pytest.mark.parametrize("f", sorted(_TF32_STAGES))
@pytest.mark.parametrize("bsz", [1, 16, 63, 64, 2048])
def test_k1_tf32_route_rule(f, bsz):
    """K1's float32 wgmma kernel keeps its 64-query block split into a hi
    and a lo plane of ceil(ceil8(F)/32) boxes of 64 rows × 128 bytes,
    after 1024 bytes that align them, beside a ring of as many stages of
    64 corpus rows × 64 float32 features as fit (at most 16), each with
    two 8-byte barriers.  It runs where that ring has 3 stages (F <= 352)
    and the batch fills the 64-query block;
    elsewhere the mma.sync kernel runs at its own query block.  The grid
    has one CTA per query block and group of 4096 / query block bins."""
    boxes = -(-(-(-f // 8) * 8) // 32)
    stages = _TF32_STAGES[f]
    assert bt.tf32_stages(f) == stages
    smem = 1024 + 2 * boxes * 64 * 128 + stages * 16_400
    if stages:
        assert bt._tf32_smem(f, stages) == smem <= 232_448
        assert stages == 16 or smem + 16_400 > 232_448
    else:   # not even one stage fits beside the planes
        assert 1024 + 2 * boxes * 64 * 128 + 16_400 > 232_448
    route = stages >= 3 and bsz >= 64
    assert bt.tf32_route(f, bsz) == route
    qb = 64 if route else bt.query_block(f, bsz)
    for bins in (128, 256, 512):
        assert bt.grid_ctas(bsz, bins, f) == -(-bsz // qb) * (bins * qb
                                                             // 4096)


def test_k1_tf32_route_edges():
    """The glove cell's launch (F = 100, B = 2048) takes the wgmma route;
    the cohere cell's (F = 768) and the widest float32 K1 (F = 1264) keep
    the mma.sync kernel, as do F past the 3-stage edge at 352 and batches
    below one 64-query block (the pruned B = 16 sessions).  The route
    reads F at its operand width (whole 16-byte rows), so F not a
    multiple of 4 takes it at the next multiple."""
    assert bt.tf32_route(100, 2048) and bt.tf32_route(352, 64)
    assert bt.tf32_route(4, 64) and bt.tf32_stages(352) == 3
    assert not bt.tf32_route(356, 2048)
    for f in (768, 1264):
        assert not bt.tf32_route(f, 2048)
    for f, width in ((7, 8), (99, 100), (101, 104), (102, 104),
                     (126, 128), (353, 356)):
        assert bt.operand_width(f, torch.float32) == width
        assert bt.tf32_route(width, 2048) == (width <= 352)
    for bsz in (1, 16, 63):
        assert not bt.tf32_route(100, bsz)
    assert bt.bintopk_fits(768) and bt.query_block(768, 2048) == 64
    # B = 2048 keeps 64 CTAs per 128 bins (the mma.sync kernel's 16 query
    # blocks × 4 bin groups; here 32 × 2), so the chunking is unchanged
    assert bt.grid_ctas(2048, 128, 100) == 64


@pytest.mark.parametrize("f,bsz,qb,smem", [
    (7, 2048, 128, 23_552), (100, 2048, 128, 72_704), (100, 64, 64, 62_464),
    (100, 16, 32, 83_456), (128, 2048, 128, 84_992),
    (416, 2048, 128, 232_448), (417, 2048, 64, 144_384),
    (768, 2048, 64, 232_448), (1264, 2048, 32, 231_936),
    (1264, 1, 32, 231_936)])
def test_k1_float32_mma_sync_rule_unchanged(f, bsz, qb, smem):
    """The mma.sync kernel's rule, which every launch the wgmma route
    refuses keeps: the largest query block of 128, 64 and 32 that the
    batch fills and whose shared memory (the unsplit block at stride
    ceil8(F) + 4, two slices of 4096/qb rows at stride 68, float32) fits."""
    assert bt.query_block(f, bsz) == qb
    assert bt._bintopk_smem(f, qb) == smem == (
        qb * (-(-f // 8) * 8 + 4) + 2 * (4096 // qb) * 68) * 4
    assert smem <= 232_448 and bt.bintopk_fits(f)


def test_repair_helpers():
    det = np.array([[0.1, 0.9, NEG_INF], [0.95, 0.96, 0.97]], np.float32)
    fired, ok = br.fired_bins_host(det, np.array([0.5, 0.5], np.float32))
    assert fired[0].tolist() == [1, -1] and ok.tolist() == [True, False]
    assert bt.binned_topk_depth_for(10) == 3 and bt.bins_target(64) == 512


@pytest.mark.parametrize("f", [1, 3, 5, 99, 1537])
@pytest.mark.parametrize("use_bf16", [False, True])
def test_prepared_rows_are_whole_16_bytes(f, use_bf16):
    """prepare_binned_corpus pads every prepared row, float32 or bf16,
    with zero features to whole 16 bytes (operand_width: 4 float32
    features, 8 bf16), after the unit scaling; the query operand and a
    row written later (prepared_rows) follow the corpus width, and the
    kernels' operand rule admits that width."""
    rng = np.random.default_rng(f)
    x = torch.tensor(rng.uniform(0.1, 1.0, (37, f)), dtype=torch.float32)
    xl = torch.tensor(rng.uniform(0, 1, 37), dtype=torch.float32)
    dt = torch.bfloat16 if use_bf16 else torch.float32
    per = 8 if use_bf16 else 4
    width = -(-f // per) * per
    assert bt.operand_width(f, dt) == width
    assert width * dt.itemsize % 16 == 0
    assert bt.operand_width(width, dt) == width
    xh, xlh = bt.prepare_binned_corpus(x, xl, use_bf16=use_bf16)
    assert xh.dtype == dt and xh.shape == (bt.CORPUS_ALIGN, width)
    assert xlh.dtype == torch.float32 and xlh.shape == (bt.CORPUS_ALIGN,)
    assert not bool(xh[:, f:].any()) and not bool(xh[37:].any())
    assert torch.equal(xh[:37, :f], safe_unit(x).to(dt))
    assert torch.equal(bt.prepared_rows(x[:5], xh), xh[:5])
    qh, _ = operand_query(x[:3] * 1.02, 0.9, torch.float32, xh)
    assert qh.dtype == dt and qh.shape == (3, width)
    assert bt.bintopk_fits(f, use_bf16) == bt.bintopk_fits(width, use_bf16)
