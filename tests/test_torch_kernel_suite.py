"""tests/test_pallas_kernels.py run in both packages: each case once as
the JAX package runs it (its Pallas kernel in interpret mode against the
XLA oracle, by calling the JAX test itself) and once on
``arrowspace_torch`` on the CPU, on the same numpy inputs made from the
case's own seeds, where each kernel wrapper takes its plain version.
The port side is held to the port's own full scan and to the JAX
package's XLA oracle on the same inputs.

The JAX case's draw (n, F, B, k, α, and its depth where it pins one)
runs on the port as it is; the Pallas layout knobs it also draws (tile,
query block, lane split, pre-reduce) have no counterpart: the port's
engine picks bins from k and chunks from the grid.  Where a case plants
a storm at a stride of its own bins, the port's bins (128, 256 or 512)
divide that stride or not, and the case says which.  Cases whose only
subject is a TPU layout stand in tests/test_torch_parity_map.py
``NOT_PORTED``; where such a case also asserts exactness, that assertion
runs here at the port's defaults.

Tolerances: float32 ids exact against the port's full scan and against
the JAX oracle wherever the JAX case asserts them exact; scores within
the JAX case's own atol (1e-5 / 2e-5 for the λ-aware score, 1e-6 for the
energy score against the port's chunked scan, 1e-5 across packages,
where the two float32 products sum F terms in another order); the α = 1
anchor bitwise inside the port; τ of an order statistic bitwise; λ
within the JAX case's rtol 2e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_pallas_kernels as J
from arrowspace_tpu.energymaps import _energy_score_topk_chunked
from arrowspace_tpu.ops.search import batched_lambda_aware_topk as j_scan
from arrowspace_torch import taumode as tt
from arrowspace_torch.index import session_kernel_kind
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import energy_bintopk as eb
from arrowspace_torch.ops import lambda_batch as lb
from arrowspace_torch.ops import select_tau as st
from arrowspace_torch.ops import taulambda as tl
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops.search import (batched_lambda_aware_topk,
                                         binned_topk_with_repair)
from helpers import oracle_adjacency, oracle_laplacian
from suite_draws import anchor, data as _data, energy_data as _energy_data
from suite_draws import KBAND, k1_deep, k1_fuzz, k6_fuzz, tau_rows

XTOL = 1e-5      # λ-aware scores across packages (float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(*tensors):
    return [t.numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in tensors]


def jax_scan(q, ql, x, xl, alpha, k):
    s, i = j_scan(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(x),
                  jnp.asarray(xl), jnp.float32(alpha), k=k)
    return np.asarray(s), np.asarray(i)


def port_scan(q, ql, x, xl, alpha, k):
    return _np(*batched_lambda_aware_topk(*_t(q, ql, x, xl), alpha, k=k))


def port_binned(q, ql, x, xl, alpha, k, depth=0):
    return _np(*bt.binned_lambda_topk(*_t(q, ql, x, xl), alpha, k=k,
                                      depth=depth))


def port_repair(q, ql, x, xl, alpha, k):
    return _np(*binned_topk_with_repair(*_t(q, ql, x, xl), alpha, k=k))


def port_merge(q, ql, x, xl, alpha, k):
    return _np(*tk.fused_lambda_topk(*_t(q, ql, x, xl), alpha, k=k))


def _agree(s, i, s2, i2, atol, rows=None):
    rows = slice(None) if rows is None else rows
    np.testing.assert_array_equal(i[rows], i2[rows])
    np.testing.assert_allclose(s[rows], s2[rows], atol=atol, rtol=0)


def _port_vs_both(s, i, args, alpha, k, atol, rows=None):
    """Port result (s, i) against the port's full scan (atol) and the JAX
    package's XLA oracle (ids exact, scores within XTOL)."""
    ps, pi = port_scan(*args, alpha, k)
    js, ji = jax_scan(*args, alpha, k)
    _agree(s, i, ps, pi, atol, rows)
    _agree(s, i, js, ji, max(atol, XTOL), rows)
    return ps, pi


# --- K3, the merge top-k ----------------------------------------------------

@pytest.mark.parametrize("n,tile", [(1000, 256), (2048, 512), (777, 256)])
def test_fused_topk_matches_xla(n, tile):
    J.test_fused_topk_matches_xla(n, tile)
    args = _data(n, 64, 4)
    s, i = port_merge(*args, 0.9, 8)
    _port_vs_both(s, i, args, 0.9, 8, 1e-5)


def test_fused_topk_query_chunking():
    J.test_fused_topk_query_chunking()
    args = _data(512, 32, 130)
    s, i = port_merge(*args, 0.7, 5)
    _port_vs_both(s, i, args, 0.7, 5, 1e-5)


def test_fused_topk_wide_features_many_blocks():
    J.test_fused_topk_wide_features_many_blocks()
    args = _data(600, 1024, 700, seed=3)
    s, i = port_merge(*args, 0.8, 6)
    ps, pi = port_scan(*args, 0.8, 6)
    # the port's plain merge and its full scan share one product: exact
    _agree(s, i, ps, pi, 1e-5)
    # across packages the rule of the JAX case: rare flips inside f32
    # rounding only
    js, ji = jax_scan(*args, 0.8, 6)
    np.testing.assert_allclose(s, js, atol=1e-5)
    flips = i != ji
    assert flips.mean() < 0.01, f"{flips.sum()} index mismatches"
    np.testing.assert_allclose(s[flips], js[flips], atol=2e-5)


def test_fused_topk_k_larger_than_tile_tail():
    J.test_fused_topk_k_larger_than_tile_tail()
    args = _data(300, 16, 2)
    s, i = port_merge(*args, 1.0, 20)
    assert i.max() < 300
    _port_vs_both(s, i, args, 1.0, 20, 1e-5)


# --- K5, K4, K2 ---------------------------------------------------------------

def _lambda_graph(seed, n_items, f, n_nodes, inf_at=None):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(0.1, 1.0, (n_items, f)).astype(np.float32)
    if inf_at is not None:
        rows[inf_at] = np.inf
    graph_rows = rng.uniform(0.1, 1.0, (n_nodes, 8))
    lap = oracle_laplacian(oracle_adjacency(
        graph_rows, eps=1.0, topk=4, p=2.0, sigma=None)).astype(np.float32)
    return rows, lap


def test_fused_lambda_batch_matches_xla():
    from arrowspace_tpu import taumode as jtm
    J.test_fused_lambda_batch_matches_xla()
    rows, lap = _lambda_graph(3, 700, 40, 24)
    x, L = _t(rows, lap)
    taus = tt.select_tau_batch(x, tt.TauMode.median())
    got = lb.fused_lambda_batch(x, L, taus).numpy()
    want = tt.synthetic_lambda_batch(x, L, taus).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    jx = jnp.asarray(rows)
    jl = np.asarray(jtm.synthetic_lambda_batch(
        jx, jnp.asarray(lap), jtm.select_tau_batch(jx, jtm.TauMode.median())))
    np.testing.assert_allclose(got, jl, rtol=2e-5, atol=1e-7)


def test_fused_lambda_batch_rejects_oversized_graph():
    J.test_fused_lambda_batch_rejects_oversized_graph()
    with pytest.raises(ValueError):
        lb.fused_lambda_batch(torch.ones((4, 3)), torch.eye(5),
                              torch.ones((4,)))


def test_fused_select_tau_matches_scalar_oracle():
    J.test_fused_select_tau_matches_scalar_oracle()
    rng = np.random.default_rng(11)
    x = rng.normal(0.5, 1.0, (300, 77)).astype(np.float64)
    x[3, 5] = np.nan
    x[7, 0] = np.inf
    x[9] = np.nan
    for kind, pct, mode in (("median", 0.5, tt.TauMode.median()),
                            ("percentile", 0.3, tt.TauMode.percentile(0.3)),
                            ("mean", 0.5, tt.TauMode.mean())):
        out = st.fused_select_tau(torch.from_numpy(x), kind=kind,
                                  pct=pct).numpy()
        for i in range(x.shape[0]):
            assert out[i] == pytest.approx(tt.select_tau(x[i], mode),
                                           rel=1e-9), (kind, i)


def test_fused_taulambda_matches_two_pass():
    from arrowspace_tpu.ops.pallas_taulambda import fused_taulambda_batch
    J.test_fused_taulambda_matches_two_pass()
    rows, lap = _lambda_graph(13, 700, 40, 24, inf_at=(5, 2))
    x, L = _t(rows, lap)
    for kind, pct, fixed, mode in (
            ("median", 0.5, 0.0, tt.TauMode.median()),
            ("percentile", 0.7, 0.0, tt.TauMode.percentile(0.7)),
            ("mean", 0.5, 0.0, tt.TauMode.mean()),
            ("fixed", 0.5, 0.3, tt.TauMode.fixed(0.3))):
        out = tl.fused_taulambda_batch(x, L, kind=kind, pct=pct,
                                       fixed=fixed).numpy()
        ref = tt.synthetic_lambda_batch(
            x, L, tt.select_tau_batch(x, mode)).numpy()
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-7,
                                   err_msg=kind)
        jout = np.asarray(fused_taulambda_batch(
            jnp.asarray(rows), jnp.asarray(lap), kind=kind, pct=pct,
            fixed=fixed, tile=256, interpret=True))
        np.testing.assert_allclose(out, jout, rtol=2e-5, atol=1e-7,
                                   err_msg=kind)


# --- K1, the binned top-k ---------------------------------------------------

@pytest.mark.parametrize("n,tile,k", [(1000, 256, 8), (2048, 512, 10),
                                      (777, 256, 5)])
def test_binned_topk_matches_xla(n, tile, k):
    J.test_binned_topk_matches_xla(n, tile, k)
    args = _data(n, 64, 4)
    s, i, fl, _det = port_binned(*args, 0.9, k)
    assert not fl.any(), "random data should not collide deeper than D"
    _port_vs_both(s, i, args, 0.9, k, 1e-5)


def test_binned_topk_block_padding():
    J.test_binned_topk_block_padding()
    args = _data(900, 32, 5)
    s, i, fl, _det = port_binned(*args, 0.8, 6)
    assert fl.shape == (5,)
    _port_vs_both(s, i, args, 0.8, 6, 1e-5)


def _query_storm(seed, n, f, stride, copies, binpos):
    """The JAX cases' deep collision: ``copies`` copies of query 0 at
    binpos + j·stride."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, (2, f)).astype(np.float32)
    ql = rng.uniform(0, 1, (2,)).astype(np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    for j in range(copies):
        x[j * stride + binpos] = q[0]
    return q, ql, x, xl


def test_binned_topk_flags_deep_collision_and_repair_restores_exactness():
    J.test_binned_topk_flags_deep_collision_and_repair_restores_exactness()
    k = 8
    depth = bt.binned_topk_depth_for(k)
    # stride 256 is a multiple of the port's 128 bins at k = 8: one bin
    args = _query_storm(5, 3000, 48, 256, depth + 3, 37)
    _s, _i, fl, _det = port_binned(*args, 1.0, k)
    assert fl[0], "deep collision must be flagged"
    rs, ri = port_repair(*args, 1.0, k)
    _port_vs_both(rs, ri, args, 1.0, k, 1e-6)


def test_binned_topk_duplicate_tie_order_within_pool():
    J.test_binned_topk_duplicate_tie_order_within_pool()
    rng = np.random.default_rng(11)
    n, f, k = 2000, 32, 6
    q = rng.uniform(0.1, 1.0, (1, f)).astype(np.float32)
    ql = np.asarray([0.5], np.float32)
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = np.full(n, 0.5, np.float32)
    x[700:704] = q[0]
    s, i, fl, _det = port_binned(q, ql, x, xl, 1.0, k)
    np.testing.assert_array_equal(i[0, :4], [700, 701, 702, 703])
    assert not fl[0]
    _port_vs_both(s, i, (q, ql, x, xl), 1.0, k, 1e-6)


def test_binned_topk_bucket_padding_masked():
    """The Pallas bucket padding has no counterpart (the port pads a
    prepared corpus to CORPUS_ALIGN rows); the case's exactness runs at
    the port's defaults: no padding row returns, ids equal the scan."""
    J.test_binned_topk_bucket_padding_masked()
    args = _data(1500, 16, 2, seed=9)
    s, i, _fl, _det = port_binned(*args, 0.5, 12)
    assert i.max() < 1500
    rs, ri = port_repair(*args, 0.5, 12)
    _port_vs_both(rs, ri, args, 0.5, 12, 1e-5)


def test_fused_select_tau_wide_f_subblocked():
    """The sub-block layout and its fit gate are Pallas layout (the
    port's K4 takes rows of up to 1536 values, select_tau_fits); the
    case's exactness runs at F = 768 against the scalar oracle."""
    J.test_fused_select_tau_wide_f_subblocked()
    assert st.select_tau_fits(768) and st.select_tau_fits(1536)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1100, 768)).astype(np.float32)
    x[3, 5] = np.nan
    out = st.fused_select_tau(torch.from_numpy(x), kind="median").numpy()
    ref = np.array([tt.select_tau(x[i], tt.TauMode.median())
                    for i in range(x.shape[0])], dtype=np.float32)
    np.testing.assert_allclose(out, ref, rtol=5e-5, atol=1e-9)


def _recorded(monkeypatch, module, name):
    """Replace module.name by a wrapper that records each call's array
    arguments (as numpy) and keywords; returns the record.  A call made
    while tracing (the kernel's own re-entry through the module name)
    is not the case's and is not recorded."""
    import jax
    calls = []
    inner = getattr(module, name)

    def record(*args, **kw):
        arrays = [a for a in args if hasattr(a, "shape") and np.ndim(a) >= 1]
        if not any(isinstance(a, jax.core.Tracer) for a in arrays):
            calls.append(([np.asarray(a) for a in arrays], kw))
        return inner(*args, **kw)
    monkeypatch.setattr(module, name, record)
    return calls


def _same_draws(calls, draws):
    """Each JAX call's arrays and k equal tests/suite_draws.py's replay
    of that draw: the port runs the JAX case's own inputs."""
    assert len(calls) == len(draws)
    for (arrays, kw), (want, k) in zip(calls, draws):
        assert kw["k"] == k
        for a, w in zip(arrays, want):
            np.testing.assert_array_equal(a, w)


def test_binned_topk_fuzz_shapes_and_k(monkeypatch):
    """Unflagged rows exact against both scans; the port also repairs
    the flagged rows, so every row of the repaired result is exact.  The
    JAX case's calls are recorded and held to the replayed draws."""
    import arrowspace_tpu.ops.pallas_bintopk as jbk
    calls = _recorded(monkeypatch, jbk, "binned_lambda_topk")
    J.test_binned_topk_fuzz_shapes_and_k()
    monkeypatch.undo()
    _same_draws(calls, [(_data(n, f, b, seed=t), k)
                        for t, n, f, b, k, _a in k1_fuzz()])
    for trial, n, f, b, k, alpha in k1_fuzz():
        args = _data(n, f, b, seed=trial)
        s, i, fl, _det = port_binned(*args, alpha, k)
        ok = ~fl
        _port_vs_both(s, i, args, alpha, k, 2e-5, rows=ok)
        rs, ri = port_repair(*args, alpha, k)
        _port_vs_both(rs, ri, args, alpha, k, 2e-5)


def test_binned_topk_deep_split_deep_depth_fuzz(monkeypatch):
    """The JAX draw's depth (3 or 4) runs on the port as drawn."""
    import arrowspace_tpu.ops.pallas_bintopk as jbk
    calls = _recorded(monkeypatch, jbk, "binned_lambda_topk")
    J.test_binned_topk_deep_split_deep_depth_fuzz()
    monkeypatch.undo()
    _same_draws(calls, [(_data(n, f, b, seed=100 + t), k)
                        for t, n, f, b, k, _a, _d in k1_deep()])
    assert [kw["depth"] for _, kw in calls] == [d for *_, d in k1_deep()]
    for trial, n, f, b, k, alpha, depth in k1_deep():
        args = _data(n, f, b, seed=100 + trial)
        s, i, fl, _det = port_binned(*args, alpha, k, depth=depth)
        _port_vs_both(s, i, args, alpha, k, 2e-5, rows=~fl)


@pytest.mark.parametrize("k", KBAND)
def test_binned_topk_kband_matches_xla(k):
    J.test_binned_topk_kband_matches_xla(k)
    assert bt.binned_topk_depth_for(k) == 4
    args = _data(2048, 32, 3, seed=k)
    s, i, fl, _det = port_binned(*args, 0.9, k)
    assert not fl.any()
    _port_vs_both(s, i, args, 0.9, k, 1e-5)


def test_binned_topk_kband_deep_collision_repairs():
    """Stride 512 equals the port's bins at k = 64: one bin."""
    J.test_binned_topk_kband_deep_collision_repairs()
    k = 64
    assert bt.bins_target(k) == 512
    args = _query_storm(64, 4096, 32, 512, 6, 11)
    _s, _i, fl, _det = port_binned(*args, 1.0, k)
    assert fl[0]
    rs, ri = port_repair(*args, 1.0, k)
    _port_vs_both(rs, ri, args, 1.0, k, 1e-6)


def test_kband_auto_layout_fits_and_dispatches_binned():
    """The Pallas auto layout has no counterpart; the case's dispatch
    contract runs on the port, whose gate is keyed on size, not on the
    backend: the (48, 128] band serves binned at depth 4, k = 129 not."""
    J.test_kband_auto_layout_fits_and_dispatches_binned()
    for k in (64, 100, 128):
        assert bt.binned_topk_depth_for(k) == 4
        assert k <= 4 * bt.bins_target(k)
        assert session_kernel_kind(1_000_000, k, 128) == "binned"
    assert session_kernel_kind(1_000_000, 129, 128) != "binned"


def test_binned_topk_prepared_corpus_matches_raw():
    J.test_binned_topk_prepared_corpus_matches_raw()
    for n, f, b, k in ((3000, 32, 4, 7), (900, 16, 5, 3)):
        q, ql, x, xl = _t(*_data(n, f, b, seed=n))
        raw = bt.binned_lambda_topk(q, ql, x, xl, 0.9, k=k)
        xh, xlh = bt.prepare_binned_corpus(x, xl)
        prep = bt.binned_lambda_topk(q, ql, xh, xlh, 0.9, k=k,
                                     prepared=True, n_items=n)
        for a, b_ in zip(raw, prep):
            assert torch.equal(a, b_)


# --- K6, the binned energy top-k -------------------------------------------

def _energy_port(zq, ql, z, xl, wl, wd, k, depth=0):
    zx, xlam, xn = eb.prepare_binned_energy_corpus(*_t(z, xl))
    wl_, wd_ = eb.dtype_scalar(wl, zx.dtype), eb.dtype_scalar(wd, zx.dtype)
    return _np(*eb.binned_energy_topk(*_t(zq, ql), zx, xlam, xn, wl_, wd_,
                                      k=k, n=z.shape[0], depth=depth))


def _energy_port_scan(zq, ql, z, xl, wl, wd, k):
    dt = torch.float32
    return _np(*eb.energy_topk_chunked(
        *_t(zq, ql, z, xl), eb.dtype_scalar(wl, dt),
        eb.dtype_scalar(wd, dt), k=k, chunk=128))


def _energy_jax_scan(zq, ql, z, xl, wl, wd, k):
    s, i = _energy_score_topk_chunked(
        jnp.asarray(zq), jnp.asarray(ql), jnp.asarray(z), jnp.asarray(xl),
        jnp.float32(wl), jnp.float32(wd), k=k, chunk=128)
    return np.asarray(s), np.asarray(i)


def _energy_vs_both(s, i, args, wl, wd, k, atol, rows=None):
    ps, pi = _energy_port_scan(*args, wl, wd, k)
    js, ji = _energy_jax_scan(*args, wl, wd, k)
    _agree(s, i, ps, pi, atol, rows)
    _agree(s, i, js, ji, max(atol, XTOL), rows)
    return ps, pi


@pytest.mark.parametrize("n,tile,k", [(1000, 256, 8), (2048, 512, 10),
                                      (777, 256, 5)])
def test_binned_energy_matches_chunked(n, tile, k):
    J.test_binned_energy_matches_chunked(n, tile, k)
    args = _energy_data(n, 48, 4, seed=n)
    s, i, fl, _det = _energy_port(*args, 1.0, 0.5, k)
    assert not fl.any(), "random data should not collide deeper than D"
    _energy_vs_both(s, i, args, 1.0, 0.5, k, 1e-6)


def test_binned_energy_block_padding_and_chunking():
    J.test_binned_energy_block_padding_and_chunking()
    args = _energy_data(900, 32, 5, seed=7)
    s, i, fl, _det = _energy_port(*args, 0.7, 1.3, 6)
    assert fl.shape == (5,)
    _energy_vs_both(s, i, args, 0.7, 1.3, 6, 1e-6)


def test_binned_energy_prepared_corpus_matches_raw():
    """The port's counterpart of the raw path is an engine that keeps no
    prepared plane (prepare_corpus=False prepares it per step): bitwise
    the resident engine's scores, ids, flags and det."""
    J.test_binned_energy_prepared_corpus_matches_raw()
    for n, g, b, k in ((2048, 48, 4, 8), (900, 32, 5, 6)):
        zq, ql, z, xl = _t(*_energy_data(n, g, b, seed=n))
        res = br.BinnedEnergyTopK(z, xl, 1.0, 0.5, k).step(zq, ql)
        raw = br.BinnedEnergyTopK(z, xl, 1.0, 0.5, k,
                                  prepare_corpus=False).step(zq, ql)
        for a, b_ in zip(res, raw):
            assert torch.equal(a, b_)


def test_binned_energy_duplicate_tie_order():
    J.test_binned_energy_duplicate_tie_order()
    rng = np.random.default_rng(11)
    n, g, tile, k = 900, 16, 256, 6
    z = rng.normal(size=(n, g))
    for j in (5, 5 + tile, 5 + 2 * tile, 300):
        z[j] = z[5]
    z = z.astype(np.float32)
    args = (z[5][None, :], np.asarray([0.4], np.float32), z,
            np.full(n, 0.4, np.float32))
    s, i, fl, _det = _energy_port(*args, 1.0, 0.5, k)
    if not fl.any():
        _energy_vs_both(s, i, args, 1.0, 0.5, k, 1e-6)
        assert list(i[0][:4]) == [5, 5 + tile, 300, 5 + 2 * tile]
    ps, pi = _energy_port_scan(*args, 1.0, 0.5, k)
    assert list(pi[0][:4]) == [5, 5 + tile, 300, 5 + 2 * tile]


def test_binned_energy_flags_deep_collision():
    """Stride 256 is a multiple of the port's 128 bins at k = 8."""
    J.test_binned_energy_flags_deep_collision()
    rng = np.random.default_rng(13)
    n, g, tile, k = 1100, 16, 256, 8
    depth = bt.binned_topk_depth_for(k)
    z = rng.normal(size=(n, g)) * 5.0
    dup_rows = [9 + d * tile for d in range(depth + 1)]
    for j in dup_rows:
        z[j] = z[9]
    z = z.astype(np.float32)
    args = (z[9][None, :], np.asarray([0.5], np.float32), z,
            np.full(n, 0.5, np.float32))
    _s, _i, fl, _det = _energy_port(*args, 1.0, 0.5, k)
    assert fl[0], "depth+1 same-bin top rows must raise the miss flag"
    _ps, pi = _energy_port_scan(*args, 1.0, 0.5, k)
    assert list(pi[0][:depth + 1]) == dup_rows


def test_binned_energy_fuzz_shapes_and_k(monkeypatch):
    import arrowspace_tpu.ops.pallas_bintopk as jbk
    calls = _recorded(monkeypatch, jbk, "binned_energy_topk")
    J.test_binned_energy_fuzz_shapes_and_k()
    monkeypatch.undo()
    _same_draws(calls, [(_energy_data(n, g, b, seed=100 + t), k)
                        for t, n, g, b, k, _wl, _wd in k6_fuzz()])
    for trial, n, g, b, k, wl, wd in k6_fuzz():
        args = _energy_data(n, g, b, seed=100 + trial)
        s, i, fl, _det = _energy_port(*args, wl, wd, k)
        _energy_vs_both(s, i, args, wl, wd, k, 2e-5, rows=~fl)


def test_fused_select_tau_matches_lane_layout():
    """The exactness that test_fused_select_tau_sublane_layouts_match_lane
    asserts between Pallas layouts, at the port's defaults: the port's τ
    on the same rows equals the lane layout's bitwise for the order
    statistics, and the mean within float32 summation order."""
    from arrowspace_tpu.ops.pallas_tau import fused_select_tau as j_tau
    for name, x in list(tau_rows())[1:]:
        for kind, pct in (("median", 0.5), ("percentile", 0.25),
                          ("mean", 0.5)):
            want = np.asarray(j_tau(jnp.asarray(x), kind=kind, pct=pct,
                                    tile=256, interpret=True, layout="lane"))
            got = st.fused_select_tau(torch.from_numpy(x), kind=kind,
                                      pct=pct).numpy()
            if kind == "mean":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name} {kind}")


def test_binned_topk_alpha1_bitwise_cosine_anchor():
    J.test_binned_topk_alpha1_bitwise_cosine_anchor()
    args = anchor()
    s, i, fl, _det = port_binned(*args, 1.0, 5)
    ps, pi = _port_vs_both(s, i, args, 1.0, 5, 0.0, rows=~fl)
    np.testing.assert_array_equal(s[~fl], ps[~fl])


def test_bisect_tau_duplicates_and_signed_zero():
    """Duplicates, an all-equal row, signed zeros across the median and
    odd/even counts: the port's τ equals the JAX lane layout's and the
    port's own row sort bitwise."""
    from arrowspace_tpu.ops.pallas_tau import fused_select_tau as j_tau
    J.test_bisect_tau_duplicates_and_signed_zero()
    _name, x = next(tau_rows())
    for kind, pct in (("median", 0.5), ("percentile", 0.5)):
        want = np.asarray(j_tau(jnp.asarray(x), kind=kind, pct=pct,
                                tile=256, interpret=True, layout="lane"))
        got = st.fused_select_tau(torch.from_numpy(x), kind=kind,
                                  pct=pct).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kind)
        mode = tt.TauMode(kind, pct if kind == "percentile" else 0.0)
        srt = tt.select_tau_sorted(torch.from_numpy(x), mode).numpy()
        np.testing.assert_array_equal(got, srt, err_msg=kind)


@pytest.mark.parametrize("lane_split", [2, 4])
def test_binned_topk_lane_split_matches_xla(lane_split):
    """The lane split has no counterpart; the case's exactness and its
    storm at stride 512 / lane_split (256 or 128, multiples of the port's
    128 bins at k = 9: one bin) run at the port's defaults."""
    J.test_binned_topk_lane_split_matches_xla(lane_split)
    q, ql, x, xl = _data(3000, 64, 6, seed=11)
    s, i, fl, _det = port_binned(q, ql, x, xl, 0.9, 9)
    assert not fl.any()
    _port_vs_both(s, i, (q, ql, x, xl), 0.9, 9, 1e-5)
    xs = x.copy()
    bins = 512 // lane_split
    top = xs[7] / np.linalg.norm(xs[7])
    for j in range(6):
        xs[7 + j * bins] = top * (1.0 + 1e-7)
    args = (q[:6], ql[:6], xs, xl)
    rs, ri = port_repair(*args, 1.0, 9)
    _port_vs_both(rs, ri, args, 1.0, 9, 1e-5)


@pytest.mark.parametrize("lane_split", [2, 4, 8])
def test_binned_topk_pre_reduce_matches_xla(lane_split):
    """The pre-reduce fold and its loser-max detector have no
    counterpart (the port folds every row of a bin); the case's
    exactness runs at the port's defaults, and its planted top pair
    (rows 7 and 7 + 512 / lane_split, one bin of the port's where the
    stride is a multiple of 128) repairs exactly."""
    J.test_binned_topk_pre_reduce_matches_xla(lane_split)
    q, ql, x, xl = _data(3000, 64, 6, seed=13)
    s, i, fl, _det = port_binned(q, ql, x, xl, 0.9, 9)
    _port_vs_both(s, i, (q, ql, x, xl), 0.9, 9, 1e-5, rows=~fl)
    bins = 512 // lane_split
    xs = x.copy()
    top = xs[7] / np.linalg.norm(xs[7])
    xs[7] = top * 2.0
    xs[7 + bins] = top * 3.0
    qt = np.tile(top, (6, 1)).astype(np.float32)
    args = (qt, ql[:6], xs, xl)
    s, i, fl, _det = port_binned(*args, 1.0, 9)
    _port_vs_both(s, i, args, 1.0, 9, 1e-5, rows=~fl)
    assert (i[:, :2] == [7, 7 + bins]).all()
    rs, ri = port_repair(*args, 1.0, 9)
    _port_vs_both(rs, ri, args, 1.0, 9, 1e-5)


def test_binned_topk_auto_pre_reduce_exact_at_gate():
    """At n = 65536 the port's default engine: unflagged rows bitwise
    its full scan, every repaired row equal to both scans' ids."""
    J.test_binned_topk_auto_pre_reduce_exact_at_gate()
    rng = np.random.default_rng(29)
    n, f, b = 65536, 8, 4
    x = rng.uniform(0.1, 1.0, (n, f)).astype(np.float32)
    xl = rng.uniform(0, 1, (n,)).astype(np.float32)
    q = rng.uniform(0.1, 1.0, (b, f)).astype(np.float32)
    ql = rng.uniform(0, 1, (b,)).astype(np.float32)
    args = (q, ql, x, xl)
    s, i, fl, _det = port_binned(*args, 0.9, 5)
    ps, pi = _port_vs_both(s, i, args, 0.9, 5, 0.0, rows=~fl)
    np.testing.assert_array_equal(s[~fl], ps[~fl])
    rs, ri = port_repair(*args, 0.9, 5)
    np.testing.assert_array_equal(ri, pi)
    np.testing.assert_array_equal(ri, jax_scan(*args, 0.9, 5)[1])


@pytest.mark.parametrize("lane_split", [2, 4])
def test_binned_energy_pre_reduce_matches_chunked(lane_split):
    """As the λ-aware pre-reduce case: exactness at the port's defaults,
    and the planted tie (z row and λ of row 7 copied to 7 + 512 /
    lane_split) returns lowest id first through the repaired engine."""
    J.test_binned_energy_pre_reduce_matches_chunked(lane_split)
    zq, ql, z, xl = _energy_data(2048, 32, 5, seed=23)
    s, i, fl, _det = _energy_port(zq, ql, z, xl, 1.0, 0.5, 9)
    _energy_vs_both(s, i, (zq, ql, z, xl), 1.0, 0.5, 9, 1e-6, rows=~fl)
    bins = 512 // lane_split
    zs, ls = z.copy(), xl.copy()
    zs[7 + bins] = zs[7]
    ls[7 + bins] = ls[7]
    args = (zs[7][None, :], ls[7:8].copy(), zs, ls)
    eng = br.BinnedEnergyTopK(*_t(zs, ls), 1.0, 0.5, 9)
    _es, ei = eng(*_t(args[0], args[1]))
    ps, pi = _energy_port_scan(*args, 1.0, 0.5, 9)
    assert list(pi[0][:2]) == [7, 7 + bins]
    np.testing.assert_array_equal(ei, pi)
    _js, ji = _energy_jax_scan(*args, 1.0, 0.5, 9)
    np.testing.assert_array_equal(ei, ji)
