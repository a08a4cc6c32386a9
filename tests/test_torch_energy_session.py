"""EnergySearchSession and search_energy_batch of arrowspace_torch against
the JAX package's, in float64 on the CPU.

One energy index is built by the JAX package (a seeded clustered
70000 x 72 corpus, JL-projected to 36 dims, EnergyParams(
allow_tall_graphs=True)) and carried into the port with
convert.from_jax_state, so both packages serve the same projection,
graph and λ.  At N > 65536 the port serves through its binned energy
engine (K6, or K7 with approx=True; their plain versions on the CPU)
while the JAX package on the CPU serves through its chunked scorer: the
two engines are held against each other.

Tolerances: ids exact (ties to the lowest id), scores within 1e-10
(float64; d² and the rsqrt form rounded in another order)."""

import numpy as np
import pytest
import torch

from arrowspace_tpu.energymaps import EnergyParams as JEnergyParams
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_torch import eigenmaps
from arrowspace_torch.convert import from_jax_state
from arrowspace_torch.energymaps import (ENERGY_CHUNK, EnergyParams,
                                         energy_binned_fits)
from arrowspace_torch.index import ArrowIndex, energy_session_config
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.reduction import ImplicitProjection

CPU64 = dict(device="cpu", dtype=torch.float64)
N, F = 70_000, 72


def _rows(n=N, f=F, seed=5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (80, f))
    return c[rng.integers(0, 80, n)] + rng.normal(0, 0.02, (n, f))


def _carry(j, rows):
    return from_jax_state(
        rows, np.asarray(j.aspace.lambdas), np.asarray(j.gl.matrix),
        j.aspace.taumode, projection=np.asarray(
            j.aspace.projection_matrix.matrix()),
        pad_tall_graphs=j.aspace.pad_tall_graphs, **CPU64)


@pytest.fixture(scope="module")
def pair():
    """(rows, JAX index, port index) over one JAX-built energy index; rows
    0 and 1 have depth+2 exact copies in one bin of the binned engine."""
    rows = _rows()
    depth, bins = bt.binned_topk_depth_for(10), bt.bins_target(10)
    for src in (0, 1):
        rows[src + 7 + bins * (2 + np.arange(depth + 2))] = rows[src]
    j = JIndex.build_energy(rows, JEnergyParams(allow_tall_graphs=True),
                            seed=5)
    return rows, j, _carry(j, rows)


def _queries(rows, seed, b):
    rng = np.random.default_rng(seed)
    return rows[rng.integers(0, rows.shape[0], b)] * 1.02


def _stream(sess, batches):
    got = list(sess.search_stream(batches))
    return (np.concatenate([s for s, _ in got]),
            np.concatenate([i for _, i in got]), got)


def test_carried_index_is_tall_and_projected(pair):
    rows, j, t = pair
    assert t.aspace.pad_tall_graphs and j.aspace.pad_tall_graphs
    assert t.aspace.reduced_dim == j.aspace.reduced_dim == F // 2
    assert t.gl.matrix.shape[0] > F
    np.testing.assert_array_equal(
        t.aspace.projection_matrix.matrix().numpy(),
        np.asarray(j.aspace.projection_matrix.matrix()))
    np.testing.assert_allclose(
        t.aspace.projected_items().numpy(),
        rows @ np.asarray(j.aspace.projection_matrix.matrix()), rtol=0,
        atol=1e-12)


def test_search_energy_batch_matches_jax(pair):
    rows, j, t = pair
    q = _queries(rows, 1, 12)
    js, ji = j.search_energy(q, k=10)
    ts, ti = t.search_energy(q, k=10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-10)


def test_session_matches_jax_session_with_a_partial_tail(pair):
    rows, j, t = pair
    q = _queries(rows, 2, 40)
    batches = [q[:16], q[16:32], q[32:]]            # tail of 8
    sess = t.make_energy_session(batch_size=16, k=10)
    assert sess.kernel == "binned"
    sess.warmup()
    ts, ti, got = _stream(sess, batches)
    assert [g[1].shape for g in got] == [(16, 10), (16, 10), (8, 10)]
    jsess = j.make_energy_session(batch_size=16, k=10)
    js, ji, _ = _stream(jsess, batches)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-10)


def test_session_repairs_the_duplicated_rows(pair):
    """Rows 0 and 1 collide deeper than the bin depth: the stream flags
    them and the strided repair returns the JAX ranking, the copies in id
    order."""
    rows, j, t = pair
    q = np.concatenate([rows[:2] * 1.02, _queries(rows, 3, 14)])
    sess = t.make_energy_session(batch_size=16, k=10)
    before = br.strided_energy_repair.calls
    ts, ti, _ = _stream(sess, [q])
    assert sess.engine.flagged_rows >= 1
    assert br.strided_energy_repair.calls > before
    js, ji = j.search_energy(q, k=10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-10)
    copies = [int(c) for c in ti[0] if np.array_equal(rows[c], rows[0])]
    assert copies == sorted(copies) and len(copies) >= 3


@pytest.mark.parametrize("wl,wd", [(1.0, 0.5), (0.3, 1.7), (0.0, 1.0),
                                   (2.0, 0.0)])
def test_session_weight_sweep_matches_jax(pair, wl, wd):
    rows, j, t = pair
    q = _queries(rows, 4, 8)
    sess = t.make_energy_session(batch_size=8, k=5, w_lambda=wl,
                                 w_dirichlet=wd)
    (s, i), = list(sess.search_stream([q]))
    js, ji = j.search_energy(q, k=5, w_lambda=wl, w_dirichlet=wd)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-10)


@pytest.mark.parametrize("k", [10, 64])
def test_approx_session_equals_the_exact_session(pair, k):
    """approx=True (K7 with the exact re-run of uncertified rows) returns
    what the exact session returns, and the JAX ranking."""
    rows, j, t = pair
    q = np.concatenate([rows[:2] * 1.02, _queries(rows, 5, 30)])
    batches = [q[:16], q[16:]]
    approx = t.make_energy_session(batch_size=16, k=k, approx=True)
    assert approx.kernel == "binned_approx"
    approx.warmup()
    a_s, a_i, _ = _stream(approx, batches)
    e_s, e_i, _ = _stream(t.make_energy_session(batch_size=16, k=k),
                          batches)
    np.testing.assert_array_equal(a_i, e_i)
    np.testing.assert_allclose(a_s, e_s, rtol=0, atol=1e-10)
    js, ji = j.search_energy(q, k=k)
    np.testing.assert_array_equal(a_i, np.asarray(ji))


def test_session_dim_mismatch_raises(pair):
    rows, j, t = pair
    bad = np.ones((4, F + 3))
    for idx in (t, j):
        sess = idx.make_energy_session(batch_size=4, k=3)
        with pytest.raises(ValueError, match="features"):
            list(sess.search_stream([bad]))
    with pytest.raises(AssertionError):
        t.search_energy(bad, k=3)


def test_approx_needs_the_binned_engine():
    """Below N = 65536 the session resolves the chunked scan, and
    approx=True raises as the JAX package's does off its binned path."""
    rows = _rows(n=6000)
    j = JIndex.build_energy(rows, JEnergyParams(allow_tall_graphs=True),
                            seed=5)
    t = _carry(j, rows)
    assert t.make_energy_session(batch_size=8, k=5).kernel == "chunked"
    with pytest.raises(ValueError, match="approx"):
        t.make_energy_session(batch_size=8, k=5, approx=True)
    with pytest.raises(ValueError, match="approx"):
        j.make_energy_session(batch_size=8, k=5, approx=True)
    q = _queries(rows, 6, 10)
    (s, i), = list(t.make_energy_session(batch_size=10, k=5)
                   .search_stream([q]))
    js, ji = j.search_energy(q, k=5)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,k,g,kernel", [
    (ENERGY_CHUNK + 1, 10, 64, "binned"), (ENERGY_CHUNK, 10, 64, "chunked"),
    (1_000_000, 128, 64, "binned"), (1_000_000, 129, 64, "chunked"),
    (1_000_000, 10, 4096, "binned"), (1_000_000, 64, 2652, "binned"),
    (1_000_000, 10, 1268, "binned")])
def test_energy_session_gate_is_keyed_on_size(n, k, g, kernel):
    """The energy tile takes any z-width (its shared memory does not grow
    with G), so only N and k choose the engine: every width the fp32
    fold's gate admitted (G <= 1268 at 128 bins, 2652 at 512) and wider
    ones take the binned engine."""
    assert energy_session_config(n, k, g) == kernel
    assert energy_binned_fits(n, k, g) == (kernel == "binned")


def test_build_energy_entry_point_matches_jax(monkeypatch):
    """ArrowIndex.build_energy of both packages, the JAX projection
    carried across: the same builder settings (dims reduction with the
    default rp_eps, the λ-graph keywords) and λ within 1e-5 (see
    tests/test_torch_energy.py for why)."""
    rows = _rows(n=6000)
    kw = dict(eps=0.5, k=7, topk=3)
    j = JIndex.build_energy(rows, JEnergyParams(allow_tall_graphs=True),
                            seed=5, **kw)
    held = ImplicitProjection.from_matrix(
        np.asarray(j.aspace.projection_matrix.matrix()))
    monkeypatch.setattr(eigenmaps, "ImplicitProjection",
                        lambda *a, **k_: held)
    t = ArrowIndex.build_energy(rows, EnergyParams(allow_tall_graphs=True),
                                seed=5, **kw, **CPU64)
    for name in ("use_dims_reduction", "rp_eps", "lambda_eps", "lambda_k",
                 "lambda_topk", "clustering_seed"):
        assert getattr(t.builder, name) == getattr(j.builder, name), name
    assert t.gl.matrix.shape == tuple(np.shape(j.gl.matrix))
    np.testing.assert_allclose(t.lambdas, np.asarray(j.lambdas), rtol=0,
                               atol=1e-5)
