"""tests/test_index.py (the ArrowIndex facade) run in both packages: each
case once on ``arrowspace_tpu`` and once on ``arrowspace_torch`` (CPU,
float64), on the same numpy inputs, and where both are deterministic
the two packages' results against each other.

Cases that pin the JAX package's stream loop by stubbing its jitted
step (the flag column, the host cast, warm_step's program sweep) run as
they are on the JAX side and against the port's own stream loop
(index.stream_search: a step returning (scores, ids, flags, λ, det),
the repair called with the batch's host arrays).

Tolerances: ids exact; scores within 1e-9 relative (the facade's own
budget), λ across packages within 1e-10."""

import types

import numpy as np
import pytest
import torch

from arrowspace_tpu import energymaps as jen
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.taumode import TauMode as JTauMode
from arrowspace_torch import energymaps as ten
from arrowspace_torch.builder import ArrowSpaceBuilder as TBuilder
from arrowspace_torch.index import ArrowIndex as TIndex
from arrowspace_torch.taumode import TauMode as TTauMode
from data import make_gaussian_hd, make_moons_hd
from helpers import cosine_topk

CPU64 = dict(device="cpu", dtype=torch.float64)
PKGS = {
    "jax": types.SimpleNamespace(Index=JIndex, Builder=JBuilder, kw={},
                                 energymaps=jen, TauMode=JTauMode),
    "torch": types.SimpleNamespace(Index=TIndex,
                                   Builder=lambda: TBuilder(**CPU64),
                                   kw=CPU64, energymaps=ten,
                                   TauMode=TTauMode),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _index(pkg, seed=42, **kw):
    rows = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=1)
    return rows, pkg.Index.build(rows.tolist(), eps=1.0, k=5, topk=3,
                                 seed=seed, **kw, **pkg.kw)


def _load(pkg, path, name):
    return pkg.Index.load(path, name, **pkg.kw)


def test_build_and_search_batch(pkg):
    rows, idx = _index(pkg)
    scores, ids = idx.search(rows[:4] * 1.02, k=5, alpha=0.9)
    assert scores.shape == (4, 5) and ids.shape == (4, 5)
    for b in range(4):
        assert ids[b][0] == b


def test_the_packages_build_and_search_alike():
    (rows, j), (_r, t) = _index(PKGS["jax"]), _index(PKGS["torch"])
    np.testing.assert_allclose(t.lambdas, np.asarray(j.lambdas), rtol=1e-10,
                               atol=1e-12)
    q = rows[:6] * 1.02
    js, ji = j.search(q, k=5, alpha=0.9)
    ts, ti = t.search(q, k=5, alpha=0.9)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-9)
    assert t.stats() == pytest.approx(j.stats(), rel=1e-9)


def test_search_one_matches_batch(pkg):
    rows, idx = _index(pkg)
    q = rows[7] * 1.03
    single = idx.search_one(q, k=5, alpha=0.8)
    _scores, ids = idx.search(q, k=5, alpha=0.8)
    assert [i for i, _ in single] == list(ids[0])


def test_alpha1_matches_cosine(pkg):
    rows, idx = _index(pkg)
    q = rows[9] * 1.01
    _, ids = idx.search(q, k=5, alpha=1.0)
    oracle_ids, _ = cosine_topk(q, rows, 5)
    assert list(ids[0]) == list(oracle_ids)


def test_save_load_roundtrip(pkg, tmp_path):
    rows, idx = _index(pkg)
    idx.save(tmp_path, "facade")
    idx2 = _load(pkg, tmp_path, "facade")
    np.testing.assert_allclose(idx2.lambdas, idx.lambdas, rtol=1e-12)
    q = rows[3] * 1.02
    s1, i1 = idx.search(q, k=5, alpha=0.9)
    s2, i2 = idx2.search(q, k=5, alpha=0.9)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-9)


def test_range_and_stats(pkg):
    _rows, idx = _index(pkg)
    lam = idx.lambdas
    assert len(idx.range(float(lam.min()), float(lam.max()))) == idx.nitems
    st = idx.stats()
    assert st["n_items"] == 80
    assert st["graph_nodes"] == 12
    assert st["lambda_min"] <= st["lambda_mean"] <= st["lambda_max"]


def test_build_energy_facade(pkg):
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=2)
    idx = pkg.Index.build_energy(rows.tolist(), seed=5, **pkg.kw)
    assert idx.nitems == 90
    assert np.all(np.isfinite(idx.lambdas))


def test_facade_search_energy(pkg):
    rows = make_gaussian_hd(70, spread=0.5, dims=96, seed=3)
    idx = pkg.Index.build_energy(rows.tolist(), seed=9, **pkg.kw)
    scores, _ids = idx.search_energy(rows[:2] * 1.01, k=5)
    assert scores.shape == (2, 5)
    assert np.all(scores <= 0.0)


def test_loaded_index_resave_preserves_config(pkg, tmp_path):
    rows = make_moons_hd(80, noise=0.08, hd_noise=0.04, dims=12, seed=4)
    idx = pkg.Index.build(rows.tolist(), eps=0.7, k=5, topk=3, seed=42,
                          taumode=pkg.TauMode.mean(), **pkg.kw)
    idx.save(tmp_path, "a")
    idx2 = _load(pkg, tmp_path, "a")
    assert idx2.builder is None
    idx2.save(tmp_path, "b")
    idx3 = _load(pkg, tmp_path, "b")
    assert idx3.aspace.taumode == idx.aspace.taumode
    assert idx3.gl.graph_params.eps == idx.gl.graph_params.eps
    assert idx3.gl.graph_params.k == idx.gl.graph_params.k
    q = rows[5] * 1.02
    lam1 = idx.aspace.prepare_query_item(q, idx.gl)
    lam3 = idx3.aspace.prepare_query_item(q, idx3.gl)
    assert lam1 == pytest.approx(lam3, rel=1e-9)
    np.testing.assert_array_equal(idx.search(q, k=5, alpha=0.9)[1],
                                  idx3.search(q, k=5, alpha=0.9)[1])


def test_projected_facade_roundtrip(pkg, tmp_path):
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=8)
    idx = pkg.Index.build(rows.tolist(), eps=1.0, k=5, seed=13,
                          dims_reduction=True, rp_eps=0.5, **pkg.kw)
    assert idx.aspace.projection_matrix is not None
    idx.save(tmp_path, "proj")
    idx2 = _load(pkg, tmp_path, "proj")
    assert idx2.aspace.projection_matrix is not None
    q = rows[2] * 1.01
    s1, i1 = idx.search(q, k=5, alpha=0.9)
    s2, i2 = idx2.search(q, k=5, alpha=0.9)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-9)


def test_search_session_matches_search(pkg):
    rows, idx = _index(pkg)
    rng = np.random.default_rng(5)
    batches = [rows[rng.integers(0, 80, 4)] * 1.02 for _ in range(6)]
    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9, depth=2)
    sess.warmup()
    got = list(sess.search_stream(batches))
    assert len(got) == 6
    for qb, (s, i) in zip(batches, got):
        s_ref, i_ref = idx.search(qb, k=5, alpha=0.9)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, rtol=1e-9)


def test_search_session_dim_mismatch_raises(pkg):
    rows, idx = _index(pkg)
    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    with pytest.raises(ValueError, match="features"):
        list(sess.search_stream([np.ones((4, rows.shape[1] + 3))]))


def test_search_session_bf16_precision_option(pkg):
    """Below the kernels' row floor both packages serve bf16 sessions
    through the plain engine in the index dtype (identical results); an
    unknown precision is refused."""
    rows, idx = _index(pkg)
    rng = np.random.default_rng(6)
    batches = [rows[rng.integers(0, 80, 4)] * 1.02 for _ in range(3)]
    ref = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    bf = idx.make_search_session(batch_size=4, k=5, alpha=0.9,
                                 precision="bf16")
    for (s_r, i_r), (s_b, i_b) in zip(ref.search_stream(batches),
                                      bf.search_stream(batches)):
        np.testing.assert_array_equal(i_r, i_b)
        np.testing.assert_allclose(s_r, s_b, rtol=1e-9)
    with pytest.raises(ValueError):
        idx.make_search_session(batch_size=4, k=5, precision="fp8")


def test_search_session_with_projection(pkg):
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=21)
    idx = pkg.Index.build(rows.tolist(), eps=1.0, k=5, seed=23,
                          dims_reduction=True, rp_eps=0.5, **pkg.kw)
    assert idx.aspace.projection_matrix is not None
    batches = [rows[i * 3:(i + 1) * 3] * 1.01 for i in range(4)]
    sess = idx.make_search_session(batch_size=3, k=5, alpha=0.9)
    got = list(sess.search_stream(batches))
    assert len(got) == 4
    for qb, (s, i) in zip(batches, got):
        s_ref, i_ref = idx.search(qb, k=5, alpha=0.9)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, rtol=1e-6)


def test_search_session_partial_batch(pkg):
    rows, idx = _index(pkg)
    sess = idx.make_search_session(batch_size=8, k=5, alpha=0.9)
    batches = [rows[:8] * 1.01, rows[8:11] * 1.01]
    got = list(sess.search_stream(batches))
    assert got[0][1].shape == (8, 5)
    assert got[1][1].shape == (3, 5)
    np.testing.assert_array_equal(
        got[1][1], idx.search(batches[1], k=5, alpha=0.9)[1])


def test_search_session_tall_graph_index(pkg):
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02, (800, 16))
    b = (pkg.Builder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = pkg.energymaps.build_energy(
        b, rows.tolist(),
        pkg.energymaps.EnergyParams(split_quantile=0.2,
                                    allow_tall_graphs=True))
    assert gl.shape()[0] > aspace.nfeatures
    idx = pkg.Index(aspace, gl, b)
    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    sess.warmup()
    (s, i), = list(sess.search_stream([rows[:4] * 1.01]))
    assert s.shape == (4, 5)
    np.testing.assert_array_equal(
        i, idx.search(rows[:4] * 1.01, k=5, alpha=0.9)[1])


def test_stream_loop_repairs_flagged_rows_jax():
    """tests/test_index.py's stub of the JAX stream loop (flags in the id
    block's last column)."""
    import jax.numpy as jnp
    from arrowspace_tpu.index import stream_search
    bsz, k = 4, 3

    def step(q):
        s = jnp.tile(jnp.arange(k, 0, -1, dtype=jnp.float32), (bsz, 1))
        i = jnp.tile(jnp.arange(k, dtype=jnp.int32), (bsz, 1))
        fl = jnp.asarray([0, 1, 0, 1], dtype=jnp.int32)
        qlam = jnp.full((bsz,), 0.25, dtype=jnp.float32)
        return s, jnp.concatenate([i, fl[:, None]], axis=1), qlam

    calls = []

    def repair(q_block, qlam, rows):
        calls.append(rows.copy())
        return (np.full((len(rows), k), 9.0, np.float32),
                np.full((len(rows), k), 77, np.int32))

    out = list(stream_search(step, [np.ones((bsz, 8)), np.ones((2, 8))],
                             bsz, 1, np.float32, repair=repair))
    np.testing.assert_array_equal(calls[0], [1, 3])
    assert (out[0][1][1] == 77).all() and (out[0][1][0] == [0, 1, 2]).all()
    np.testing.assert_array_equal(calls[1], [1])


def test_stream_loop_repairs_flagged_rows_torch():
    """The port's stream loop: a step's flags route the batch through
    ``repair`` with its host arrays; a tail batch is padded and its
    flags sliced to the real rows."""
    from arrowspace_torch.index import stream_search
    bsz, k = 4, 3

    def step(q):
        s = torch.arange(k, 0, -1, dtype=torch.float32).repeat(bsz, 1)
        i = torch.arange(k).repeat(bsz, 1)
        fl = torch.tensor([False, True, False, True])
        return s, i, fl, torch.full((bsz,), 0.25), torch.zeros(bsz, 16)

    calls = []

    def repair(qb, qlam, det, s, i, flags):
        rows = np.nonzero(flags)[0]
        calls.append((rows, qb.shape, float(qlam[0])))
        s, i = s.copy(), i.copy()
        s[rows], i[rows] = 9.0, 77
        return s, i

    out = list(stream_search(step, [np.ones((bsz, 8)), np.ones((2, 8))],
                             bsz, 1, "cpu", torch.float32, repair=repair))
    np.testing.assert_array_equal(calls[0][0], [1, 3])
    assert calls[0][1] == (bsz, 8) and calls[0][2] == 0.25
    assert (out[0][1][1] == 77).all() and (out[0][1][0] == [0, 1, 2]).all()
    np.testing.assert_array_equal(calls[1][0], [1])
    assert out[1][0].shape == (2, 3)


def test_stream_loop_host_casts_batches_jax():
    import jax.numpy as jnp
    from arrowspace_tpu.index import stream_search
    seen = []

    def step(q):
        seen.append((q.dtype, np.asarray(q)))
        return jnp.zeros((4, 3), jnp.float32), jnp.zeros((4, 3), jnp.int32)

    list(stream_search(step, [np.ones((4, 8)) * 0.1,
                              np.ones((4, 8), dtype=np.int32)],
                       4, 1, np.float32))
    assert [d for d, _ in seen] == [jnp.float32, jnp.float32]
    np.testing.assert_array_equal(
        seen[0][1], (np.ones((4, 8)) * 0.1).astype(np.float32))


def test_stream_loop_host_casts_batches_torch():
    """The port's stream loop casts each batch to the session dtype on the
    host, once, before the copy to the device."""
    from arrowspace_torch.index import stream_search
    seen = []

    def step(q):
        seen.append((q.dtype, q.numpy().copy()))
        return (torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.long),
                None, None, None)

    list(stream_search(step, [np.ones((4, 8)) * 0.1,
                              np.ones((4, 8), dtype=np.int32)],
                       4, 1, "cpu", torch.float32))
    assert [d for d, _ in seen] == [torch.float32, torch.float32]
    np.testing.assert_array_equal(
        seen[0][1], (np.ones((4, 8)) * 0.1).astype(np.float32))


def test_warmup_drives_the_production_path(pkg, monkeypatch):
    """A session's warmup pushes one full batch through the production
    stream loop (the JAX package's warm_step; the port's
    SearchSession.warmup)."""
    rows, idx = _index(pkg)
    sess = idx.make_search_session(batch_size=4, k=5, alpha=0.9)
    seen = []
    orig = sess.search_stream

    def spy(batches):
        batches = list(batches)
        seen.append([np.shape(b) for b in batches])
        return orig(batches)
    monkeypatch.setattr(sess, "search_stream", spy)
    if pkg is PKGS["jax"]:
        import arrowspace_tpu.index as jidx
        calls = []
        real = jidx.stream_search
        monkeypatch.setattr(jidx, "stream_search", lambda *a, **kw: (
            calls.append(1), real(*a, **kw))[1])
        sess.warmup()
        assert calls
    else:
        sess.warmup()
        assert seen == [[(4, 12)]]


def test_f64_rescore_pool_parameter(pkg):
    rng = np.random.default_rng(3)
    base = rng.uniform(0.1, 1.0, (5, 24))
    rows = base[rng.integers(0, 5, 2000)] + rng.normal(0, 1e-3, (2000, 24))
    idx = pkg.Index.build(rows, eps=1.0, k=4, topk=3, seed=3, **pkg.kw)
    q = rows[77] * 1.001
    _s1, i1 = idx.search(q, k=5, alpha=1.0, precision="f64_rescore",
                         rescore_pool=1000)
    qn = rows @ q / (np.linalg.norm(rows, axis=1) * np.linalg.norm(q))
    np.testing.assert_array_equal(i1[0], np.lexsort((np.arange(2000),
                                                     -qn))[:5])
