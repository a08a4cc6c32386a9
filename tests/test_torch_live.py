"""LiveSearchSession and LiveEnergySearchSession of arrowspace_torch
against the JAX package's live sessions, in float64 on the CPU.

Every test of tests/test_live.py runs here on the port, with the JAX
live session (its masked XLA scan on the CPU) fed the same index, the
same queries and the same mutations as the oracle; the index is built
by the JAX package and carried across (convert.from_jax_state), so both
sessions start from the same rows, graph and λ.  Then the engines the
port serves a large corpus with, on a capacity buffer whose rows past
the live count hold stale data: the binned engine (K1's plain version,
the strided repair, K3's plain version for overflowing rows), the
"merge" engine (K3's plain version; K1's gate turned off), and the
binned energy engine (K6's plain version) with its centre frozen.

Tolerances: ids are external ids and exact (ties to the lowest
position); scores within 1e-12 (float64; the port's plain scan and the
JAX scan sum the products in another order), and within 1e-10 on the
binned energy engine, which serves the z-plane centred on its mean (d²
rounds differently there, as in tests/test_torch_energy_session.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arrowspace_tpu.core import ArrowSpace as JSpace
from arrowspace_tpu.eigenmaps import compute_taumode as jcompute_taumode
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.ops.search import masked_lambda_aware_topk
from arrowspace_torch import index as tindex
from arrowspace_torch.convert import from_jax_state
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.live import LiveEnergySearchSession, LiveSearchSession
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import topk as tk
from arrowspace_torch.ops.bin_repair import strided_lambda_repair
from arrowspace_torch.ops.search import batched_lambda_aware_topk
from arrowspace_torch.taumode import (select_tau, select_tau_batch,
                                      synthetic_lambda_batch,
                                      synthetic_lambda_single)
from data import make_moons_hd

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-12


def _carry(j, rows, **kw):
    a = j.aspace
    proj = None if a.projection_matrix is None \
        else np.asarray(a.projection_matrix.matrix())
    return from_jax_state(rows, np.asarray(a.lambdas), np.asarray(j.gl.matrix),
                          a.taumode, pad_tall_graphs=a.pad_tall_graphs,
                          projection=proj, **kw, **CPU64)


def _index(n=80, dims=12, seed=42):
    rows = make_moons_hd(n, noise=0.08, hd_noise=0.04, dims=dims, seed=1)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=seed)
    return rows, j, _carry(j, rows)


def _sessions(j, t, **kw):
    return j.make_live_session(**kw), t.make_live_session(**kw)


def _assert_same(res_t, res_j, tol=TOL):
    (ts, ti), (js, ji) = res_t, res_j
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=tol)


def _both(pair, fn):
    """fn applied to the JAX and the port session: (port's, JAX's)."""
    js, ts = pair
    return fn(ts), fn(js)


def test_add_then_search_exact_oracle_parity():
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=8, k=5, alpha=0.9, capacity=200)
    new_rows = np.random.default_rng(7).uniform(0.1, 1.0,
                                                (10, rows.shape[1]))
    new_t, new_j = _both(pair, lambda s: s.add(new_rows))
    assert list(new_t) == list(new_j) == list(range(80, 90))
    assert pair[1].nitems == 90
    queries = np.concatenate([rows[:2] * 1.01, new_rows[:2] * 1.01])
    res_t, res_j = _both(pair, lambda s: s.search(queries))
    _assert_same(res_t, res_j)
    assert res_t[1][2][0] == 80 and res_t[1][3][0] == 81


def test_added_lambda_matches_core_refresh_semantics():
    """Ingest λ equals what ArrowSpace.set_item + _refresh_lambda_row
    assigns (the reference's λ maintenance), and the JAX session's."""
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=4, k=3, capacity=200)
    new_row = np.abs(np.sin(np.arange(rows.shape[1]) + 1.0)) + 0.05
    (nid,), _ = _both(pair, lambda s: s.add(new_row))
    js, ts = pair
    lam_t = float(ts._lam[ts._pos[int(nid)]])
    lam_j = float(np.asarray(js._lam[js._pos[int(nid)]]))
    lam_core = synthetic_lambda_single(new_row, t.gl.matrix,
                                       select_tau(new_row, t.aspace.taumode))
    assert abs(lam_t - lam_core) < TOL and abs(lam_t - lam_j) < TOL


def test_update_refreshes_lambda_and_scores():
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=4, k=5, capacity=200)
    new_vec = np.roll(rows[10], 3) + 0.2
    _both(pair, lambda s: s.update([5], new_vec[None, :]))
    lam_exp = synthetic_lambda_single(new_vec, t.gl.matrix,
                                      select_tau(new_vec, t.aspace.taumode))
    assert abs(float(pair[1]._lam[5]) - lam_exp) < TOL
    res_t, res_j = _both(pair, lambda s: s.search(new_vec * 1.01))
    assert res_t[1][0][0] == 5
    _assert_same(res_t, res_j)


def test_delete_swap_compaction_and_stable_ids():
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=4, k=5, capacity=200)
    added = np.random.default_rng(3).uniform(0.1, 1.0, (5, rows.shape[1]))
    aids, _ = _both(pair, lambda s: s.add(added))
    _both(pair, lambda s: s.delete([2, 40, 83]))
    assert pair[1].nitems == 82
    res_t, res_j = _both(pair, lambda s: s.search(added[4] * 1.01))
    assert res_t[1][0][0] == aids[4]
    assert not {2, 40, 83} & set(res_t[1].ravel().tolist())
    _assert_same(res_t, res_j)
    # the swap moved tail rows into the holes; the id table follows
    ts = pair[1]
    for ext, pos in ts._pos.items():
        assert ts._ids[pos] == ext
        assert torch.equal(ts._raw[pos],
                           torch.as_tensor(np.concatenate([rows, added])[ext]))


def test_delete_then_add_reuses_slots():
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=4, k=3, capacity=200)
    _both(pair, lambda s: s.delete(list(range(70, 80))))
    assert pair[1].nitems == 70
    new = np.random.default_rng(11).uniform(0.1, 1.0, (15, rows.shape[1]))
    new_t, new_j = _both(pair, lambda s: s.add(new))
    assert pair[1].nitems == 85
    assert list(new_t) == list(new_j) == list(range(80, 95))
    _assert_same(*_both(pair, lambda s: s.search(rows[:3])))


def test_capacity_enforced_and_grow():
    """Capacity rounds up to whole CORPUS_ALIGN rows in the port (the JAX
    package rounds to its compile buckets): the rounded capacity is
    usable, a row past it raises, and grow() makes room."""
    rows, _j, t = _index()
    sess = t.make_live_session(batch_size=4, k=3, capacity=100)
    assert sess.capacity == bt.CORPUS_ALIGN
    rng = np.random.default_rng(0)
    free = sess.capacity - sess.nitems
    with pytest.raises(ValueError, match="live corpus full"):
        sess.add(rng.uniform(0.1, 1.0, (free + 1, rows.shape[1])))
    sess.add(rng.uniform(0.1, 1.0, (free, rows.shape[1])))
    assert sess.nitems == sess.capacity
    sess.grow(sess.capacity + 1)
    assert sess.capacity == 2 * bt.CORPUS_ALIGN
    ids = sess.add(rng.uniform(0.1, 1.0, (30, rows.shape[1])))
    assert len(ids) == 30 and sess.nitems == bt.CORPUS_ALIGN + 30
    s, _ = sess.search(rows[:2])
    assert s.shape == (2, 3)
    sess.grow(10)                      # never shrinks
    assert sess.capacity == 2 * bt.CORPUS_ALIGN


def test_stream_sees_mutations_between_batches():
    rows, _j, t = _index()
    sess = t.make_live_session(batch_size=4, k=5, capacity=200)
    marker = np.random.default_rng(9).uniform(0.4, 0.6, (1, rows.shape[1]))
    q = marker * 1.01

    def batches():
        yield q
        (mid,) = sess.add(marker)
        batches.mid = mid
        yield q

    outs = list(sess.search_stream(batches()))
    assert len(outs) == 2
    # the second batch is enqueued after the add ran
    assert outs[1][1][0][0] == batches.mid
    assert batches.mid not in outs[0][1][0]
    _s, ids = sess.search(q)
    assert ids[0][0] == batches.mid


def test_unknown_id_errors():
    rows, _j, t = _index()
    sess = t.make_live_session(batch_size=4, k=3, capacity=120)
    with pytest.raises(KeyError, match="unknown or deleted external id"):
        sess.delete([999])
    (nid,) = sess.add(rows[0][None, :] * 1.1)
    sess.delete([nid])
    with pytest.raises(KeyError, match="unknown or deleted"):
        sess.update([nid], rows[0][None, :])


def test_warmup_and_empty_add():
    rows, _j, t = _index()
    sess = t.make_live_session(batch_size=4, k=3, capacity=120)
    sess.warmup()
    assert sess.nitems == 80
    assert sess.add(np.empty((0, rows.shape[1]))).shape == (0,)


def test_warmup_sweeps_mutation_buckets_and_compacting_delete():
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=4, k=3, capacity=120)
    _both(pair, lambda s: s.warmup(mutation_buckets=(1, 2, 4)))
    assert pair[1].nitems == 80
    res_t, res_j = _both(pair, lambda s: s.search(rows[3][None, :]))
    assert res_t[1][0, 0] < 80
    _assert_same(res_t, res_j)
    pair[1].warmup(mutation_buckets=(4096,))
    assert pair[1].nitems == 80


def test_update_duplicate_ids_raise():
    rows, _j, t = _index()
    sess = t.make_live_session(batch_size=4, k=3, capacity=120)
    with pytest.raises(ValueError, match="duplicate external ids"):
        sess.update([5, 5], np.stack([rows[0], rows[1]]))
    with pytest.raises(ValueError, match="ids but"):
        sess.update([5], np.stack([rows[0], rows[1]]))


def test_k_clamps_to_capacity_not_initial_size():
    rows = make_moons_hd(24, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=42)
    pair = _sessions(j, _carry(j, rows), batch_size=4, k=30, capacity=200)
    assert pair[1].k == pair[0].k == 30
    with pytest.raises(ValueError, match="exceeds the live corpus size"):
        pair[1].search(rows[0][None, :])
    new = np.random.default_rng(7).uniform(0.1, 1.0, (10, rows.shape[1]))
    _both(pair, lambda s: s.add(new))
    res_t, res_j = _both(pair, lambda s: s.search(rows[0][None, :]))
    assert res_t[0].shape == (1, 30) and len(set(res_t[1][0].tolist())) == 30
    _assert_same(res_t, res_j)


def test_search_below_k_after_delete_raises_not_assert():
    rows = make_moons_hd(12, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    j = JIndex.build(rows.tolist(), eps=1.0, k=5, topk=3, seed=42)
    sess = _carry(j, rows).make_live_session(batch_size=4, k=10, capacity=64)
    sess.delete(list(range(5)))
    with pytest.raises(ValueError, match="exceeds the live corpus size"):
        sess.search(rows[0][None, :])
    with pytest.raises(ValueError, match="exceeds the live corpus size"):
        next(iter(sess.search_stream([rows[:4]])))


def test_snapshot_to_index_roundtrip(tmp_path):
    rows, j, t = _index()
    pair = _sessions(j, t, batch_size=4, k=5, capacity=200)
    added = np.random.default_rng(5).uniform(0.1, 1.0, (6, rows.shape[1]))
    _both(pair, lambda s: s.add(added))
    _both(pair, lambda s: s.delete([0, 81]))
    (snap, ext), (jsnap, jext) = _both(pair, lambda s: s.to_index())
    assert snap.nitems == pair[1].nitems == 84
    assert snap.gl.nnodes == 84
    np.testing.assert_array_equal(ext, jext)
    assert len(set(ext.tolist())) == 84
    np.testing.assert_array_equal(snap.aspace.host_rows,
                                  np.asarray(jsnap.aspace.host_rows))
    q = added[3] * 1.02
    s_live, i_live = pair[1].search(q)
    s_snap, i_snap = snap.search(np.atleast_2d(q), k=5, alpha=0.9)
    np.testing.assert_allclose(s_live, s_snap, rtol=0, atol=TOL)
    np.testing.assert_array_equal(i_live[0], ext[i_snap[0]])
    snap.save(tmp_path, "live-snap")
    back = ArrowIndex.load(tmp_path, "live-snap", **CPU64)
    np.testing.assert_array_equal(back.lambdas, snap.lambdas)
    jback = JIndex.load(tmp_path, "live-snap")
    np.testing.assert_array_equal(np.asarray(jback.lambdas), snap.lambdas)


def _energy_index():
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
    from arrowspace_tpu.energymaps import EnergyParams, build_energy
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 400)] + rng.normal(0, 0.02,
                                                          (400, 16))
    b = (JBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    j = JIndex(aspace, gl, b)
    return rows, j, _carry(j, rows)


def test_live_energy_pre_mutation_matches_static_api():
    rows, j, t = _energy_index()
    sess = t.make_live_energy_session(batch_size=8, k=5, capacity=600)
    assert isinstance(sess, LiveEnergySearchSession)
    assert sess.kernel == "chunked"
    q = rows[:8] * 1.01
    s_live, i_live = sess.search(q)
    s_ref, i_ref = t.search_energy(q, k=5, w_lambda=1.0, w_dirichlet=0.5)
    np.testing.assert_array_equal(i_live, i_ref)
    np.testing.assert_allclose(s_live, s_ref, rtol=0, atol=TOL)
    _assert_same((s_live, i_live), j.search_energy(q, k=5, w_lambda=1.0,
                                                   w_dirichlet=0.5))


def test_live_energy_add_delete_oracle_parity():
    rows, j, t = _energy_index()
    pair = (j.make_live_energy_session(batch_size=8, k=5, capacity=600),
            t.make_live_energy_session(batch_size=8, k=5, capacity=600))
    added = np.random.default_rng(13).uniform(0.0, 1.0, (7, rows.shape[1]))
    aids, _ = _both(pair, lambda s: s.add(added))
    _both(pair, lambda s: s.delete([3, int(aids[2])]))
    assert pair[1].nitems == 405
    q = np.concatenate([rows[:2] * 1.01, added[:1] * 1.01])
    res_t, res_j = _both(pair, lambda s: s.search(q))
    _assert_same(res_t, res_j)
    assert not {3, 402} & set(res_t[1].ravel().tolist())
    # added rows take λ as queries do: zero-padded to the tall graph
    lam = t.aspace.prepare_query_items_batch(added, t.gl)
    ts = pair[1]
    for r, ext in enumerate(aids):
        if ext in ts._pos:
            assert float(ts._lam[ts._pos[int(ext)]]) == pytest.approx(
                float(lam[r]), abs=TOL)


def test_dynamic_n_binned_kernel_one_program_many_counts():
    """K1's plain version over one prepared capacity buffer at several
    live counts (the rows past each count hold other data): every count
    matches the masked scan of the JAX package over its first n rows."""
    rng = np.random.default_rng(21)
    cap, f, k = 2048, 32, 6
    x = rng.uniform(0.1, 1.0, (cap, f))
    xlam = rng.uniform(0, 1, (cap,))
    q = rng.uniform(0.1, 1.0, (4, f))
    qlam = rng.uniform(0, 1, (4,))
    xhat, xl = bt.prepare_binned_corpus(torch.as_tensor(x),
                                        torch.as_tensor(xlam))
    for n_live in (100, 700, 1500, cap):
        s1, i1, fl, _det = bt.binned_lambda_topk(
            torch.as_tensor(q), torch.as_tensor(qlam), xhat, xl, 0.9, k=k,
            prepared=True, n_items=n_live)
        s2, i2 = masked_lambda_aware_topk(
            jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(x),
            jnp.asarray(xlam), jnp.float64(0.9),
            jnp.asarray(n_live, jnp.int32), k=k)
        assert not fl.any()
        assert int(i1.max()) < n_live
        np.testing.assert_allclose(s1.numpy(), np.asarray(s2), rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))


# ---------------------------------------------------------------------------
# The port's engines over a capacity buffer at a runtime row count
# ---------------------------------------------------------------------------

N_BIG, F_BIG = 70_000, 8


def _big_rows(seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (24, F_BIG))
    rows = c[rng.integers(0, 24, N_BIG)] + rng.normal(0, 0.05,
                                                     (N_BIG, F_BIG))
    # rows 0 and 1 with depth+2 exact copies in one bin of K1 at k=10:
    # queries near them flag, and the strided repair runs at n_live
    depth, bins = bt.binned_topk_depth_for(10), bt.bins_target(10)
    for src in (0, 1):
        rows[src + 9 + bins * (3 + np.arange(depth + 2))] = rows[src]
    return rows


@pytest.fixture(scope="module")
def big():
    """A 70000-row JAX index over the graph of a 2000-row seeded build
    (the live sessions never rebuild the graph), carried into the port."""
    rows = _big_rows()
    small = JIndex.build(rows[:2000].tolist(), eps=1.0, k=5, topk=3, seed=11)
    a = JSpace.new(rows, small.aspace.taumode)
    jcompute_taumode(a, small.gl)
    j = JIndex(a, small.gl)
    return rows, j, _carry(j, rows)


def _mutate_and_compare(pair, rows, rng, check=None):
    """The same add / update / delete on both sessions, each followed by
    a search of queries near corpus rows (rows 0 and 1 among them: their
    duplicate storms flag on K1) and near added rows."""
    f = rows.shape[1]
    added = rows[rng.integers(0, rows.shape[0], 300)] + rng.normal(
        0, 0.01, (300, f))
    q_base = np.concatenate([rows[[0, 1]], rows[rng.integers(0, len(rows),
                                                             14)]])
    steps = [
        lambda s: s.add(added),
        lambda s: s.update([5, 77, 70_010, 69_999],
                           rows[[9, 10, 11, 12]] * 1.03),
        lambda s: s.delete(list(range(0, 70_300, 997)) + [70_299, 70_298]
                           + list(range(69_900, 70_000))),
    ]
    for step in steps:
        _both(pair, step)
        q = np.concatenate([q_base * 1.01, added[:4] * 1.02])
        res_t, res_j = _both(pair, lambda s: s.search(q))
        _assert_same(res_t, res_j)
        if check is not None:
            check(pair[1])
    return res_t


def _poison(sess, queries):
    """Rows past the live count become copies of the queries (each would
    win if it were scored), in every buffer the engine reads."""
    n = sess.nitems
    q = torch.as_tensor(queries)
    m = min(q.shape[0], sess.capacity - n)
    for t in (sess._raw, sess._xhat):
        if t is not None:
            src = q if t is sess._raw else q / q.norm(dim=1, keepdim=True)
            t[n:n + m] = src[:m].to(t.dtype)
    for t in (sess._lam, sess._xlam):
        if t is not None:
            t[n:n + m] = 0.5


def test_binned_engine_at_live_count_below_capacity(big):
    """At 70000 rows the port serves through K1 (its plain version here)
    with the strided repair; after adds, updates and deletes the buffer
    holds stale rows past the live count, and the results still equal
    the JAX session's masked scan over the live rows."""
    rows, j, t = big
    pair = _sessions(j, t, batch_size=32, k=10, alpha=0.9,
                     capacity=N_BIG + 1024)
    assert pair[1].kernel == "binned"
    before = strided_lambda_repair.calls

    def stale_rows_remain(s):
        past = s._xhat[s.nitems:s.capacity]
        assert s.nitems < s.capacity and s._engine.n == s.nitems
        return past

    _mutate_and_compare(pair, rows, np.random.default_rng(4),
                        check=stale_rows_remain)
    ts = pair[1]
    assert strided_lambda_repair.calls > before
    assert int((ts._xhat[ts.nitems:].abs().sum(dim=1) > 0).sum()) > 100
    # poisoned rows past the live count change nothing
    q = rows[[3, 400, 5000]] * 1.01
    clean = ts.search(q)
    _poison(ts, q)
    poisoned = ts.search(q)
    np.testing.assert_array_equal(poisoned[1], clean[1])
    np.testing.assert_array_equal(poisoned[0], clean[0])


def test_binned_engine_bitwise_as_static_session_before_mutation(big):
    """Before any mutation the live binned session serves bitwise as the
    static SearchSession (K1 tiles rows by bins, whatever the
    capacity)."""
    rows, _j, t = big
    live = t.make_live_session(batch_size=32, k=10, capacity=N_BIG + 4096)
    static = t.make_search_session(batch_size=32, k=10)
    q = rows[np.random.default_rng(8).integers(0, N_BIG, 64)] * 1.02
    for (ls, li), (ss, si) in zip(live.search_stream([q[:32], q[32:]]),
                                  static.search_stream([q[:32], q[32:]])):
        np.testing.assert_array_equal(li, si)
        np.testing.assert_array_equal(ls, ss)


def test_added_copy_scores_bitwise_as_its_row(big):
    """An added copy of row r gets a bitwise copy of its prepared row
    (the arithmetic of prepare_binned_corpus), so at α = 1 (no λ term) a
    query scores the two bitwise alike, the lower position first."""
    rows, _j, t = big
    sess = t.make_live_session(batch_size=8, k=10, alpha=1.0,
                               capacity=N_BIG + 512)
    (cid,) = sess.add(rows[1234])
    assert torch.equal(sess._xhat[sess._pos[int(cid)]], sess._xhat[1234])
    s, i = sess.search(rows[1234] * 1.01)
    hit = list(i[0])
    a, b = hit.index(1234), hit.index(int(cid))
    assert s[0][a] == s[0][b] and a < b


def test_merge_engine_at_live_count_below_capacity(big, monkeypatch):
    """With K1's gate turned off the live session resolves "merge" (K3,
    its plain version here) over the prepared capacity buffer at the live
    count, and equals the JAX session through the same mutations."""
    monkeypatch.setattr(tindex, "binned_fits", lambda *a: False)
    rows, j, t = big
    before = tk.merge_topk_partial.launches
    pair = _sessions(j, t, batch_size=32, k=10, alpha=0.85,
                     capacity=N_BIG + 1024)
    assert pair[1].kernel == "merge" and pair[1]._engine is None
    _mutate_and_compare(pair, rows, np.random.default_rng(6))
    assert tk.merge_topk_partial.launches == before   # plain on the CPU
    ts = pair[1]
    q = rows[[7, 70]] * 1.01
    clean = ts.search(q)
    _poison(ts, q)
    np.testing.assert_array_equal(ts.search(q)[1], clean[1])


def test_plain_engine_below_the_gate(big, monkeypatch):
    """Below the streaming kernels' gate the live session scans its
    first n rows plainly."""
    monkeypatch.setattr(tindex, "binned_fits", lambda *a: False)
    monkeypatch.setattr(tindex, "merge_fits", lambda *a: False)
    rows, j, t = big
    pair = _sessions(j, t, batch_size=16, k=7, capacity=N_BIG + 600)
    assert pair[1].kernel == "plain" and pair[1]._xhat is None
    _mutate_and_compare(pair, rows, np.random.default_rng(12))


@pytest.fixture(scope="module")
def big_energy():
    """A 70000-row energy index over the energy graph of the 400-row JAX
    energy build (tall: λ zero-pads the rows), carried into the port."""
    rows_small, j_small, _t = _energy_index()
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, N_BIG)] + rng.normal(0, 0.02,
                                                           (N_BIG, 16))
    a = JSpace.new(rows, j_small.aspace.taumode)
    a.pad_tall_graphs = True
    jcompute_taumode(a, j_small.gl)
    j = JIndex(a, j_small.gl)
    return rows, j, _carry(j, rows)


def test_energy_binned_engine_frozen_centre(big_energy):
    """The live energy session at 70000 rows serves through K6's plain
    version on a centred plane: the centre is fixed at construction, and
    each ingested row is written as z - centre with its squared norm.
    Through adds, updates and deletes it equals the JAX session."""
    rows, j, t = big_energy
    pair = (j.make_live_energy_session(batch_size=16, k=8, capacity=N_BIG
                                       + 1024),
            t.make_live_energy_session(batch_size=16, k=8, capacity=N_BIG
                                       + 1024))
    ts = pair[1]
    assert ts.kernel == "binned"
    centre = ts.engine.centre.clone()
    np.testing.assert_allclose(centre.numpy(), rows.mean(axis=0), rtol=1e-12)
    rng = np.random.default_rng(2)
    added = rows[rng.integers(0, N_BIG, 200)] + rng.normal(0, 0.01, (200, 16))
    aids, _ = _both(pair, lambda s: s.add(added))
    assert torch.equal(ts.engine.centre, centre)
    pos = ts._pos[int(aids[5])]
    zc = torch.as_tensor(added[5]) - torch.as_tensor(rows.mean(axis=0))
    np.testing.assert_allclose(ts.engine.zx[pos].numpy(), zc.numpy(),
                               rtol=0, atol=1e-12)
    assert float(ts.engine.xn[pos]) == float((ts.engine.zx[pos] ** 2).sum())
    q = np.concatenate([rows[:6] * 1.01, added[:4] * 1.01])
    _assert_same(*_both(pair, lambda s: s.search(q)), tol=1e-10)
    _both(pair, lambda s: s.update([10, int(aids[0])], added[[7, 8]] * 0.97))
    _both(pair, lambda s: s.delete(list(range(0, N_BIG, 1013))
                                   + [int(aids[-1])]))
    assert torch.equal(ts.engine.centre, centre)
    assert ts.engine.n == ts.nitems < ts.capacity
    _assert_same(*_both(pair, lambda s: s.search(q)), tol=1e-10)


def test_live_sessions_exported():
    import arrowspace_torch
    assert arrowspace_torch.LiveSearchSession is LiveSearchSession
    assert arrowspace_torch.LiveEnergySearchSession is LiveEnergySearchSession


def test_ingest_is_the_query_preparation(big):
    """A block of added rows takes τ from select_tau_batch and λ from
    synthetic_lambda_batch against the build graph, as a query batch."""
    rows, _j, t = big
    sess = t.make_live_session(batch_size=8, k=5, capacity=N_BIG + 512)
    new = rows[:50] * 1.3
    ids = sess.add(new)
    x = torch.as_tensor(new)
    lam = synthetic_lambda_batch(x, t.gl.matrix,
                                 select_tau_batch(x, t.aspace.taumode))
    got = sess._lam[[sess._pos[int(i)] for i in ids]]
    np.testing.assert_allclose(got.numpy(), lam.numpy(), rtol=0, atol=TOL)
    ref = batched_lambda_aware_topk(x[:4], lam[:4], sess._raw[:sess.nitems],
                                    sess._lam[:sess.nitems], 0.9, k=5)
    s, i = sess.search(new[:4])
    np.testing.assert_array_equal(i, sess._ids[ref[1].numpy()])


@pytest.mark.parametrize("kind", ["binned", "merge"])
def test_live_rows_are_written_at_the_corpus_width(monkeypatch, kind):
    """A live session over 13 float64 features keeps its prepared buffer
    at the operand width, 14 (whole 16-byte rows), and the rows ``add``
    and ``update`` write there are zero-padded to it: the live buffer
    equals a fresh prepare_binned_corpus of the live rows bitwise, and
    its search the plain scan of the live rows."""
    from arrowspace_torch import core, live
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1)
    if kind == "merge":
        monkeypatch.setattr(live, "session_kernel_kind",
                            lambda *a, **kw: "merge")
    rows, _j, t = _index(dims=13)
    sess = t.make_live_session(batch_size=4, k=5, capacity=200)
    assert sess.kernel == kind
    width = bt.operand_width(13, torch.float64)
    assert width == 14 and sess._xhat.shape[1] == width
    rng = np.random.default_rng(3)
    ids = sess.add(rng.uniform(0.1, 1.0, (20, 13)))
    sess.update(ids[:3], rng.uniform(0.1, 1.0, (3, 13)))
    n = sess.nitems
    fresh, _ = bt.prepare_binned_corpus(sess._raw[:n], sess._lam[:n])
    assert torch.equal(sess._xhat[:n], fresh[:n])
    assert not bool(sess._xhat[:, 13:].any())
    q = rows[:4] * 1.02
    s, i = sess.search(q)
    _, qlam = sess._prepare(torch.as_tensor(q))
    ps, pi = batched_lambda_aware_topk(torch.as_tensor(q), qlam,
                                       sess._raw[:n], sess._lam[:n], 0.9,
                                       k=5)
    np.testing.assert_array_equal(sess._ids[pi.numpy()], i)
    np.testing.assert_allclose(s, ps.numpy(), rtol=0, atol=TOL)
