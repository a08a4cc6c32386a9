"""tests/test_bin_repair.py run in both packages: each case once as the
JAX package runs it (its Pallas kernels in interpret mode, by calling
the JAX test itself) and once on ``arrowspace_torch`` on the CPU, where
K1 and K6 take their plain versions, on the same numpy inputs made from
the case's own seeds.  The port side is held to its own full scan and
to the JAX package's XLA (or chunked energy) oracle.

The storms are planted at the JAX case's bin stride.  The fixed cases'
strides (256, 512 / 4 = 128) are multiples of the port's bins at their
k (128 for k <= 12), so each of those storms lands in one bin of the
port's too; the fuzz's strides (64-512) land in one bin or spread over
two.  The storm fuzz runs whole: every row of the repaired result
equals the full scan, flagged rows included.
``test_warm_step_compiles_repair_program`` (an XLA compile sweep)
stands in tests/test_torch_parity_map.py ``NOT_PORTED``.

Tolerances: ids exact; float32 scores within the JAX case's atol (1e-6,
2e-5 in the fuzz) against the port's scan and within 1e-5 against the
JAX oracle (another summation order); the row dots of the repair bitwise
the block diagonal of the full product."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_bin_repair as J
from arrowspace_tpu.ops.search import batched_lambda_aware_topk as j_scan
from arrowspace_torch.index import stream_search
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import energy_bintopk as eb
from arrowspace_torch.ops.search import (NEG_INF, batched_lambda_aware_topk,
                                         binned_topk_with_repair, dot_plane,
                                         row_dots)
from suite_draws import storms

XTOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scans(q, ql, x, xl, alpha, k):
    ps, pi = batched_lambda_aware_topk(*_t(q, ql, x, xl), alpha, k=k)
    js, ji = j_scan(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(x),
                    jnp.asarray(xl), jnp.float32(alpha), k=k)
    return ps.numpy(), pi.numpy(), np.asarray(js), np.asarray(ji)


def _exact(s, i, args, alpha, k, atol, rows=slice(None)):
    ps, pi, js, ji = _scans(*args, alpha, k)
    np.testing.assert_array_equal(i, pi[rows])
    np.testing.assert_array_equal(i, ji[rows])
    np.testing.assert_allclose(s, ps[rows], atol=atol, rtol=0)
    np.testing.assert_allclose(s, js[rows], atol=max(atol, XTOL), rtol=0)


def _collision(seed, n, f, stride, copies, binpos=37):
    """The JAX case's _collision_corpus plus its λ draws, in its order."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, (2, f)).astype(np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    for j in range(copies):
        x[binpos + j * stride] = q[0]
    ql = rng.uniform(0, 1, (2,)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    return q, ql, x, xl


def test_fired_bins_host_basic_and_overflow():
    J.test_fired_bins_host_basic_and_overflow()
    det = np.full((3, 8), NEG_INF, np.float32)
    det[0, 5] = 2.0
    det[1, [1, 3, 6]] = 4.0
    det[2, 2] = 0.5
    fired, ok = br.fired_bins_host(det, np.asarray([1.0, 1.0, 1.0],
                                                   np.float32))
    assert ok.tolist() == [True, False, True]
    assert fired[0].tolist() == [5, -1]
    assert fired[2].tolist() == [-1, -1]


def _flagged_repair(args, alpha, k, prepared):
    q, ql, x, xl = _t(*args)
    n = x.shape[0]
    if prepared:
        x, xl = bt.prepare_binned_corpus(x, xl)
    s, i, fl, det = bt.binned_lambda_topk(q, ql, x, xl, alpha, k=k,
                                          prepared=prepared, n_items=n)
    assert det.shape == (2, bt.bins_target(k))
    flags = fl.numpy()
    assert flags[0], "deep collision must be flagged"
    rows = np.nonzero(flags)[0]
    rs, ri = br.strided_lambda_repair(
        args[0][rows], args[1][rows], det.numpy()[rows],
        s.numpy()[rows, k - 1], i.numpy()[rows], x, xl, alpha, k=k, n=n,
        prepared=prepared, use_bf16=False)
    return rs, ri, rows


@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_strided_lambda_repair_restores_exactness(alpha):
    J.test_strided_lambda_repair_restores_exactness(alpha)
    k = 8
    args = _collision(17, 3000, 48, 256, bt.binned_topk_depth_for(k) + 3)
    rs, ri, rows = _flagged_repair(args, alpha, k, prepared=False)
    _exact(rs, ri, args, alpha, k, 1e-6, rows)


def test_strided_lambda_repair_prepared_corpus():
    """The port's session corpus (prepare_binned_corpus), the storm at
    the port's own bins for k = 8 (128), as the JAX case plants it at
    its auto layout's."""
    J.test_strided_lambda_repair_prepared_corpus()
    k, n = 8, 6000
    bins = bt.bins_target(k)
    depth = bt.binned_topk_depth_for(k)
    assert 11 + (depth + 1) * bins < n
    args = _collision(23, n, 48, bins, depth + 2, binpos=11)
    rs, ri, rows = _flagged_repair(args, 1.0, k, prepared=True)
    _exact(rs, ri, args, 1.0, k, 1e-6, rows)


def test_strided_repair_overflow_falls_back():
    J.test_strided_repair_overflow_falls_back()
    rng = np.random.default_rng(31)
    n, f, k = 3000, 48, 8
    depth = bt.binned_topk_depth_for(k)
    bins = 256                               # a multiple of the port's 128
    q = rng.uniform(0.1, 1.0, (1, f)).astype(np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    for pos in (10, 20, 30):
        for j in range(depth + 1):
            x[pos + j * bins] = q[0]
    ql = np.asarray([0.5], np.float32)
    xl = np.full(n, 0.5, np.float32)
    s, i, fl, det = bt.binned_lambda_topk(*_t(q, ql, x, xl), 1.0, k=k)
    assert fl.numpy()[0]
    det_h, s_h, i_h = det.numpy(), s.numpy(), i.numpy()
    _fired, ok = br.fired_bins_host(det_h, s_h[:, k - 1])
    assert not ok[0], "3 fired bins must overflow MAX_FIRED=2"
    xt, xlt = _t(x, xl)
    with pytest.raises(RuntimeError, match="MAX_FIRED"):
        br.strided_lambda_repair(q, ql, det_h, s_h[:, k - 1], i_h, xt, xlt,
                                 1.0, k=k, n=n, prepared=False,
                                 use_bf16=False)
    ps, pi, _js, ji = _scans(q, ql, x, xl, 1.0, k)
    calls = []

    def fallback(rel_rows):
        calls.append(np.asarray(rel_rows).copy())
        return ps[rel_rows], pi[rel_rows]

    _rs, ri = br.strided_lambda_repair(q, ql, det_h, s_h[:, k - 1], i_h, xt,
                                       xlt, 1.0, k=k, n=n, prepared=False,
                                       use_bf16=False, fallback=fallback)
    assert len(calls) == 1 and calls[0].tolist() == [0]
    np.testing.assert_array_equal(ri, pi)
    np.testing.assert_array_equal(ri, ji)


def test_repair_wrapper_uses_strided_path():
    J.test_repair_wrapper_uses_strided_path()
    k = 8
    args = _collision(41, 3000, 48, 256, bt.binned_topk_depth_for(k) + 3)
    before = br.strided_lambda_repair.calls
    rs, ri = binned_topk_with_repair(*_t(*args), 1.0, k=k)
    assert br.strided_lambda_repair.calls == before + 1
    _exact(rs.numpy(), ri.numpy(), args, 1.0, k, 1e-6)
    copies = [37 + j * 256 for j in range(bt.binned_topk_depth_for(k) + 3)]
    assert ri.numpy()[0, :len(copies)].tolist() == copies


def test_repair_wrapper_strided_under_lane_split_fold():
    """The JAX case's storm at stride 512 / 4 = 128 is one bin of the
    port's 128 at k = 6; the port has no lane split, and its repair of
    the flag is the same strided path."""
    J.test_repair_wrapper_strided_under_lane_split_fold()
    k = 6
    args = _collision(43, 4096, 32, 128, bt.binned_topk_depth_for(k) + 3,
                      binpos=99)
    _s, _i, fl, det = bt.binned_lambda_topk(*_t(*args), 1.0, k=k)
    assert det.shape == (2, 128) and fl.numpy()[0]
    before = br.strided_lambda_repair.calls
    rs, ri = binned_topk_with_repair(*_t(*args), 1.0, k=k)
    assert br.strided_lambda_repair.calls == before + 1
    _exact(rs.numpy(), ri.numpy(), args, 1.0, k, 1e-6)


def test_strided_energy_repair_restores_exactness():
    from arrowspace_tpu.energymaps import _energy_score_topk_chunked
    J.test_strided_energy_repair_restores_exactness()
    rng = np.random.default_rng(13)
    n, g, bins, k = 1100, 16, 256, 8
    depth = bt.binned_topk_depth_for(k)
    z = rng.normal(size=(n, g)) * 5.0
    dup_rows = [9 + d * bins for d in range(depth + 2)]
    for j in dup_rows:
        z[j] = z[9]
    z = z.astype(np.float32)
    zq = z[9][None, :].copy()
    ql = np.asarray([0.5], np.float32)
    xl = np.full(n, 0.5, np.float32)
    zx, xlam, xn = eb.prepare_binned_energy_corpus(*_t(z, xl))
    wl, wd = eb.dtype_scalar(1.0, zx.dtype), eb.dtype_scalar(0.5, zx.dtype)
    s, i, fl, det = eb.binned_energy_topk(*_t(zq, ql), zx, xlam, xn, wl, wd,
                                          k=k, n=n)
    assert fl.numpy()[0]
    rs, ri = br.strided_energy_repair(zq, ql, det.numpy(),
                                      s.numpy()[:, k - 1], i.numpy(), zx,
                                      xlam, xn, wl, wd, k=k, n=n)
    ps, pi = eb.energy_topk_chunked(*_t(zq, ql, z, xl), wl, wd, k=k)
    js, ji = _energy_score_topk_chunked(
        jnp.asarray(zq), jnp.asarray(ql), jnp.asarray(z), jnp.asarray(xl),
        jnp.float32(1.0), jnp.float32(0.5), k=k, chunk=128)
    np.testing.assert_array_equal(ri, pi.numpy())
    np.testing.assert_array_equal(ri, np.asarray(ji))
    np.testing.assert_allclose(rs, ps.numpy(), atol=1e-6)
    np.testing.assert_allclose(rs, np.asarray(js), atol=XTOL)
    assert ri[0, :depth + 2].tolist() == sorted(dup_rows)


def test_strided_repair_fuzz_full_equality(monkeypatch):
    """Every row equal to both full scans, flagged rows included; the
    storms make the port's K1 flag too, so the repair runs.  The JAX
    case's calls are recorded and held to the replayed draws."""
    import arrowspace_tpu.ops.search as jsearch
    calls = []
    inner = jsearch.pallas_binned_topk_with_repair

    def record(q, ql, x, xl, alpha, **kw):
        calls.append(([np.asarray(a) for a in (q, ql, x, xl)], alpha, kw))
        return inner(q, ql, x, xl, alpha, **kw)
    monkeypatch.setattr(jsearch, "pallas_binned_topk_with_repair", record)
    J.test_strided_repair_fuzz_full_equality()
    monkeypatch.undo()
    draws = list(storms())
    assert len(calls) == len(draws)
    for (arrays, alpha, kw), (_trial, *want, w_alpha, k, _stride,
                              _n) in zip(calls, draws):
        assert (alpha, kw["k"]) == (w_alpha, k)
        for a, w in zip(arrays, want):
            np.testing.assert_array_equal(a, w)
    flagged = 0
    for trial, q, ql, x, xl, alpha, k, bins, n_storms in storms():
        _s, _i, fl, _det = bt.binned_lambda_topk(*_t(q, ql, x, xl), alpha,
                                                 k=k)
        flagged += int(fl.sum())
        rs, ri = binned_topk_with_repair(*_t(q, ql, x, xl), alpha, k=k)
        ps, pi, js, ji = _scans(q, ql, x, xl, alpha, k)
        msg = (f"trial {trial} (k={k} a={alpha} stride={bins} "
               f"storms={n_storms})")
        np.testing.assert_array_equal(ri.numpy(), pi, err_msg=msg)
        np.testing.assert_array_equal(ri.numpy(), ji, err_msg=msg)
        np.testing.assert_allclose(rs.numpy(), ps, atol=2e-5, err_msg=msg)
        np.testing.assert_allclose(rs.numpy(), js, atol=2e-5, err_msg=msg)
    assert flagged > 0


def test_stream_driver_routes_det_plane_to_repair():
    """The port's stream driver hands the repair the step's qlam and det
    tensors and the host scores, ids and flags of the batch."""
    J.test_stream_driver_routes_det_plane_to_repair()
    bsz, k, bins = 4, 3, 8

    def step(q):
        s = torch.arange(k, 0, -1, dtype=torch.float32).repeat(bsz, 1)
        i = torch.arange(k).repeat(bsz, 1)
        fl = torch.tensor([False, True, False, False])
        qlam = torch.full((bsz,), 0.25)
        det = torch.full((bsz, bins), NEG_INF)
        det[1, 5] = 9.0
        return s, i, fl, qlam, det

    seen = {}

    def repair(q_block, qlam, det, scores, ids, flags):
        rows = np.nonzero(flags)[0]
        seen["rows"] = rows
        seen["det_rows"] = det[torch.as_tensor(rows)].numpy()
        seen["kth"] = scores[rows, k - 1].copy()
        scores, ids = scores.copy(), ids.copy()
        scores[rows], ids[rows] = 9.0, 77
        return scores, ids

    out = list(stream_search(step, [np.ones((bsz, 8))], bsz, 1, "cpu",
                             torch.float32, repair=repair))
    s0, i0 = out[0]
    assert seen["rows"].tolist() == [1]
    assert seen["det_rows"].shape == (1, bins)
    assert seen["det_rows"][0, 5] == 9.0
    np.testing.assert_allclose(seen["kth"], [1.0])
    assert (i0[1] == 77).all() and (i0[0] == [0, 1, 2]).all()


def test_block_diag_dot_matches_batched():
    """The port's repair dots (row_dots) equal the block diagonal of the
    full product by the same rule (dot_plane) bitwise, at every row
    count, and a float64 product to float32 rounding."""
    J.test_block_diag_dot_matches_batched()
    rng = np.random.default_rng(5)
    for r in (1, 2, 3, 16, 20):
        for f in (8, 33):
            q = rng.normal(size=(r, f)).astype(np.float32)
            rows = rng.normal(size=(r, 7, f)).astype(np.float32)
            got = row_dots(*_t(q, rows)).numpy()
            full = dot_plane(*_t(q, rows.reshape(r * 7, f))).numpy()
            want = np.stack([full[i, i * 7:(i + 1) * 7] for i in range(r)])
            np.testing.assert_array_equal(got, want, err_msg=f"r={r} f={f}")
            f64 = np.einsum("rcf,rf->rc", rows.astype(np.float64),
                            q.astype(np.float64))
            np.testing.assert_allclose(got, f64, rtol=2e-6, atol=2e-6,
                                       err_msg=f"r={r} f={f}")
