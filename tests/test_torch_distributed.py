"""arrowspace_torch.parallel (the sharded build, λ, top-k merges and the
mesh cosine sessions) against arrowspace_tpu.parallel, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py
(Pallas kernels in interpret mode); the port runs on an 8-shard CPU mesh
(make_mesh(devices=["cpu"] * 8)), or a (2, 4) one where the JAX test is
2-D.  Both get the same seeded numpy inputs (tests/test_distributed.py's
cases).  JAX indexes are carried across with convert.from_jax_state /
sharded_from_jax_state, so both serve the same rows, graph and λ.

Tolerances: ids, flags and tie order exact; float64 scores and λ within
1e-10; float32 (the fused kernels, as the JAX test holds its interpret
run) within 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arrowspace_tpu import parallel as jpar
from arrowspace_tpu.graph import GraphParams as JParams
from arrowspace_tpu.taumode import TauMode as JTau
from arrowspace_tpu.taumode import compute_taumode_lambdas as j_lambdas
from arrowspace_torch import parallel as tpar
from arrowspace_torch.convert import from_jax_state, sharded_from_jax_state
from arrowspace_torch.graph import GraphParams
from arrowspace_torch.ops.bintopk import binned_topk_depth_for, bins_target
from arrowspace_torch.ops.search import batched_lambda_aware_topk
from arrowspace_torch.parallel import ShardedTensor
from arrowspace_torch.taumode import TauMode, compute_taumode_lambdas
from data import make_moons_hd
from helpers import oracle_adjacency, oracle_laplacian

TOL = 1e-10
TOL32 = 2e-5


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jpar.make_mesh(8), tpar.make_mesh(devices=["cpu"] * 8)


def _np(a):
    if isinstance(a, ShardedTensor):
        return a.numpy()
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _setup(n=128, f=16, seed=0):
    """tests/test_distributed.py's corpus and feature-graph Laplacian."""
    rows = make_moons_hd(n, noise=0.08, hd_noise=0.05, dims=f, seed=seed)
    adjf = oracle_adjacency(rows.T[:, :32], eps=1.0, topk=4, p=2.0,
                            sigma=None)
    return rows, oracle_laplacian(adjf)


def _lambdas(rows, lap):
    """(JAX λ, port λ) of the rows (float64, median τ)."""
    jl = np.asarray(j_lambdas(jnp.asarray(rows), jnp.asarray(lap),
                              JTau.median()))
    tl = compute_taumode_lambdas(torch.as_tensor(rows), torch.as_tensor(lap),
                                 TauMode.median())
    np.testing.assert_allclose(_np(tl), jl, rtol=0, atol=TOL)
    return jl, tl


def _same(t_s, t_i, j_s, j_i, tol=TOL):
    np.testing.assert_array_equal(_np(t_i), np.asarray(j_i))
    np.testing.assert_allclose(_np(t_s), np.asarray(j_s), rtol=0, atol=tol)


def _clustered_rows(rng, n, f, centers):
    c = rng.uniform(0.2, 0.8, (centers, f))
    return c[rng.integers(0, centers, n)] + rng.normal(0, 0.03, (n, f))


def test_exports_cover_the_jax_package():
    for name in dir(jpar):
        if not name.startswith("_") and callable(getattr(jpar, name)):
            assert hasattr(tpar, name), name
    for name in jpar.distributed.__all__:
        assert hasattr(tpar, name), name


def test_mesh_shapes_and_row_split():
    mesh = tpar.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == (1, 8) and mesh.size == 8 and not mesh.grouped
    assert tpar.make_mesh(4, devices=["cpu"] * 8).size == 4
    m2 = tpar.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    assert m2.shape == (2, 4) and m2.n_local == 8
    x = np.arange(64.0).reshape(32, 2)
    st = tpar.shard_rows(x, mesh)
    assert st.shard_n == 4 and len(st.shards) == 8
    assert all(s.device.type == "cpu" for s in st.shards)
    np.testing.assert_array_equal(st.numpy(), x)
    t = torch.as_tensor(x)
    views = tpar.shard_rows(t, mesh)
    assert views.shards[3].data_ptr() == t[12:16].data_ptr()   # no copy
    assert tpar.local_row_range(tpar.items_sharding(mesh), 4096) == (0, 4096)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sharded_lambdas_match(meshes, use_pallas):
    """Sharded λ on both routes: the port's own route (float64) against
    the JAX sharded λ and the single-device λ; K2 per shard (float32,
    its plain version here) against the JAX K2 in interpret mode."""
    jm, tm = meshes
    rows, lap = _setup()
    if use_pallas:
        r32, l32 = rows.astype(np.float32), lap.astype(np.float32)
        jl = jpar.sharded_compute_taumode_lambdas(
            jnp.asarray(r32), jnp.asarray(l32), JTau.median(), jm,
            use_pallas=True)
        tl = tpar.sharded_compute_taumode_lambdas(
            torch.as_tensor(r32), torch.as_tensor(l32), TauMode.median(), tm,
            use_pallas=True)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=TOL32,
                                   atol=1e-7)
        single = compute_taumode_lambdas(torch.as_tensor(r32),
                                         torch.as_tensor(l32),
                                         TauMode.median())
        np.testing.assert_allclose(_np(tl), _np(single), rtol=TOL32,
                                   atol=1e-7)
        return
    jl = jpar.sharded_compute_taumode_lambdas(jnp.asarray(rows),
                                              jnp.asarray(lap),
                                              JTau.median(), jm)
    tl = tpar.sharded_compute_taumode_lambdas(rows, lap, TauMode.median(),
                                              tm)
    assert isinstance(tl, ShardedTensor) and len(tl.shards) == 8
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _jl, single = _lambdas(rows, lap)
    np.testing.assert_array_equal(_np(tl), _np(single))


@pytest.mark.parametrize("kernel", ["xla", "merge", "binned"])
def test_distributed_topk_matches_jax(meshes, kernel):
    """1-D top-k for each kernel (float64): equal to the JAX mesh top-k
    and the single-device top-k, ties included."""
    jm, tm = meshes
    rows, lap = _setup(n=256)
    rows[[40, 200]] = rows[3]                  # cross-shard exact ties
    jl, tl = _lambdas(rows, lap)
    q = rows[[3, 0, 1, 2]] * 1.01
    qlam = compute_taumode_lambdas(torch.as_tensor(q), torch.as_tensor(lap),
                                   TauMode.median())
    js, ji = jpar.distributed_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(_np(qlam)), jnp.asarray(rows),
        jnp.asarray(jl), 0.8, 10, jm)
    out = tpar.distributed_lambda_aware_topk(q, qlam, rows, tl, 0.8, 10, tm,
                                             kernel=kernel)
    _same(out[0], out[1], js, ji)
    assert list(_np(out[1])[0][:3]) == [3, 40, 200]
    if kernel == "binned":
        assert _np(out[2]).dtype == np.int32 and _np(out[2]).sum() == 0
    s1, i1 = batched_lambda_aware_topk(torch.as_tensor(q), qlam,
                                       torch.as_tensor(rows), tl, 0.8, k=10)
    _same(out[0], out[1], _np(s1), _np(i1))


def test_distributed_merge_float32_matches_jax_pallas(meshes):
    """K3 per shard (float32, plain here) against the JAX Pallas merge
    per shard in interpret mode, as tests/test_distributed.py holds it."""
    jm, tm = meshes
    rows, lap = _setup(n=256)
    r32, l32 = rows.astype(np.float32), lap.astype(np.float32)
    lam = _np(compute_taumode_lambdas(torch.as_tensor(r32),
                                      torch.as_tensor(l32), TauMode.median()))
    q = r32[:4] * np.float32(1.01)
    ql = _np(compute_taumode_lambdas(torch.as_tensor(q), torch.as_tensor(l32),
                                     TauMode.median()))
    js, ji = jpar.distributed_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r32), jnp.asarray(lam),
        0.8, 10, jm, use_pallas=True)
    ts, ti = tpar.distributed_lambda_aware_topk(q, ql, r32, lam, 0.8, 10, tm,
                                                use_pallas=True)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-5)


def test_distributed_binned_flags_shard_collision(meshes):
    """More than depth same-bin copies of a query inside ONE shard flag it
    (max over shards); the exact distributed pass restores every copy,
    lowest id first, as the JAX exact pass does."""
    jm, tm = meshes
    rng = np.random.default_rng(5)
    shard_n, f, k = 2048, 16, 6
    n = 8 * shard_n
    bins, depth = bins_target(k), binned_topk_depth_for(k)
    items = rng.uniform(0.1, 1.0, (n, f))
    q = rng.uniform(0.1, 1.0, (2, f))
    base = 3 * shard_n
    dups = [base + 37 + j * bins for j in range(depth + 2)]
    items[dups] = q[0]
    lam = np.full(n, 0.5)
    qlam = np.asarray([0.5, 0.5])
    s, i, fl = tpar.distributed_lambda_aware_topk(q, qlam, items, lam, 1.0, k,
                                                  tm, kernel="binned")
    assert _np(fl)[0] == 1 and _np(fl)[1] == 0
    xs, xi = tpar.distributed_lambda_aware_topk(q, qlam, items, lam, 1.0, k,
                                                tm, kernel="xla")
    js, ji = jpar.distributed_lambda_aware_topk(
        jnp.asarray(q), jnp.asarray(qlam), jnp.asarray(items),
        jnp.asarray(lam), 1.0, k, jm, kernel="xla")
    _same(xs, xi, js, ji)
    assert list(_np(xi)[0][:len(dups)]) == dups


def test_hierarchical_2d_topk_matches(meshes):
    """(dcn=2, ici=4): the hierarchical merge equals the JAX 2-D merge,
    the port's 1-D merge and the single-device top-k."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jm2 = jpar.make_mesh_2d(2, 4)
    tm2 = tpar.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    rows, lap = _setup(n=256)
    jl, tl = _lambdas(rows, lap)
    q = rows[:4] * 1.01
    ql = _np(compute_taumode_lambdas(torch.as_tensor(q), torch.as_tensor(lap),
                                     TauMode.median()))
    js, ji = jpar.distributed_lambda_aware_topk_2d(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(rows), jnp.asarray(jl),
        0.8, 10, jm2)
    ts, ti = tpar.distributed_lambda_aware_topk_2d(q, ql, rows, tl, 0.8, 10,
                                                   tm2)
    _same(ts, ti, js, ji)
    s1, i1 = tpar.distributed_lambda_aware_topk(q, ql, rows, tl, 0.8, 10,
                                                meshes[1])
    _same(ts, ti, _np(s1), _np(i1))


def test_distributed_pruned_matches_jax(meshes):
    """The mesh cell screen: flags and ids equal the JAX mesh screen's;
    unflagged rows equal the full scan."""
    from arrowspace_tpu.pruned import build_cells as j_cells
    from arrowspace_torch.pruned import build_cells as t_cells
    jm, tm = meshes
    rng = np.random.default_rng(11)
    cents = rng.uniform(0.2, 0.8, (8, 24))
    rows = cents[rng.integers(0, 8, 768)] + rng.normal(0, 0.03, (768, 24))
    lam = rng.uniform(0, 1, 768)
    jc = j_cells(rows, lam, cap=16, seed=3, iters=4)
    tc = t_cells(rows, lam, cap=16, seed=3, iters=4, device="cpu")
    assert tc.cent.shape[0] % 8 == 0
    qi = rng.integers(0, 768, 12)
    q, ql = rows[qi] * 1.02, lam[qi]
    js, ji, jf = jpar.distributed_pruned_topk(jnp.asarray(q), jnp.asarray(ql),
                                              jc, 0.9, 10, jm, m_cells=4)
    ts, ti, tf = tpar.distributed_pruned_topk(q, ql, tc, 0.9, 10, tm,
                                              m_cells=4)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    _same(ts, ti, js, ji, tol=1e-12)
    so, io = batched_lambda_aware_topk(
        torch.as_tensor(q), torch.as_tensor(ql), torch.as_tensor(rows),
        torch.as_tensor(lam), 0.9, k=10)
    certified = 0
    for b in range(12):
        if not _np(tf)[b]:
            certified += 1
            np.testing.assert_array_equal(_np(ti)[b], _np(io)[b])
            np.testing.assert_allclose(_np(ts)[b], _np(so)[b], rtol=0,
                                       atol=1e-12)
    assert certified >= 8, (certified, _np(tf))


def test_distributed_pruned_duplicate_cross_shard_tie(meshes):
    """Exact duplicates in different shards resolve to the lowest global
    id after the mesh merge, in both packages."""
    from arrowspace_tpu.pruned import build_cells as j_cells
    from arrowspace_torch.pruned import build_cells as t_cells
    jm, tm = meshes
    rng = np.random.default_rng(13)
    rows = _clustered_rows(rng, n=512, f=16, centers=6)
    rows[400] = rows[7]
    lam = rng.uniform(0, 1, 512)
    lam[400] = lam[7]
    jc = j_cells(rows, lam, cap=8, seed=5, iters=4)
    tc = t_cells(rows, lam, cap=8, seed=5, iters=4, device="cpu")
    u = tc.cent.shape[0]
    q, ql = rows[7:8] * 1.01, lam[7:8]
    ts, ti, tf = tpar.distributed_pruned_topk(q, ql, tc, 0.9, 6, tm,
                                              m_cells=u // 8)
    js, ji, jf = jpar.distributed_pruned_topk(jnp.asarray(q), jnp.asarray(ql),
                                              jc, 0.9, 6, jm, m_cells=u // 8)
    _same(ts, ti, js, ji, tol=1e-12)
    assert not _np(tf)[0] and not np.asarray(jf)[0]
    i0 = list(_np(ti)[0])
    assert 7 in i0 and 400 in i0 and i0.index(7) < i0.index(400)


def test_uneven_shard_raises(meshes):
    _jm, tm = meshes
    rows, lap = _setup(n=130)
    _jl, tl = _lambdas(rows, lap)
    with pytest.raises(AssertionError, match="padded"):
        tpar.distributed_lambda_aware_topk(rows[:2], tl[:2], rows, tl, 0.8, 5,
                                           tm)
    with pytest.raises(AssertionError, match="padded"):
        tpar.DistributedSearchSession(rows, tl, lap, tm, 4, k=5)


def test_distributed_search_session_matches(meshes):
    """The plain mesh session, a partial tail batch included: equal to the
    JAX mesh session and to the single-device top-k."""
    jm, tm = meshes
    rows, lap = _setup(n=256)
    jl, tl = _lambdas(rows, lap)
    jsess = jpar.DistributedSearchSession(
        jnp.asarray(rows), jnp.asarray(jl), jnp.asarray(lap), jm,
        batch_size=8, k=10, alpha=0.8, taumode=JTau.median(), depth=2)
    tsess = tpar.DistributedSearchSession(rows, tl, lap, tm, batch_size=8,
                                          k=10, alpha=0.8,
                                          taumode=TauMode.median(), depth=2)
    assert tsess.kernel == "plain"
    tsess.warmup()
    rng = np.random.default_rng(11)
    batches = [rows[rng.integers(0, 256, 8)] * 1.01 for _ in range(5)] \
        + [rows[:3] * 1.02]
    got = list(tsess.search_stream(batches))
    ref = list(jsess.search_stream(batches))
    assert len(got) == 6 and got[-1][1].shape == (3, 10)
    for qb, (s, i), (rs, ri) in zip(batches, got, ref):
        _same(s, i, rs, ri)
        qlam = compute_taumode_lambdas(torch.as_tensor(qb),
                                       torch.as_tensor(lap), TauMode.median())
        s1, i1 = batched_lambda_aware_topk(torch.as_tensor(qb), qlam,
                                           torch.as_tensor(rows), tl, 0.8,
                                           k=10)
        _same(s, i, _np(s1), _np(i1))


def test_distributed_session_projected_index(meshes):
    """from_index over a dims-reduced index carried across from the JAX
    package: the projected query prepares λ, the raw query scores raw
    items; equal to the JAX mesh session and to ArrowIndex.search."""
    from arrowspace_tpu.index import ArrowIndex as JIndex
    jm, tm = meshes
    rng = np.random.default_rng(17)
    centers = rng.uniform(0.2, 0.8, (6, 96))
    rows = centers[rng.integers(0, 6, 512)] + rng.normal(0, 0.05, (512, 96))
    jidx = JIndex.build(rows, eps=1.0, k=5, topk=3, seed=9, sampling=None,
                        dims_reduction=True, rp_eps=0.9)
    ja = jidx.aspace
    assert ja.projection_matrix is not None
    tidx = from_jax_state(np.asarray(ja.data), np.asarray(ja.lambdas),
                          np.asarray(jidx.gl.matrix), ja.taumode,
                          projection=np.asarray(ja.projection_matrix.matrix()),
                          device="cpu", dtype=torch.float64)
    tsess = tpar.DistributedSearchSession.from_index(tidx, tm, batch_size=8,
                                                     k=7, alpha=0.85)
    jsess = jpar.DistributedSearchSession.from_index(jidx, jm, batch_size=8,
                                                     k=7, alpha=0.85)
    tsess.warmup()
    q = rows[:8] * 1.01
    (s, i), = tuple(tsess.search_stream([q]))
    (js, ji), = tuple(jsess.search_stream([q]))
    _same(s, i, js, ji)
    rs, ri = tidx.search(q, k=7, alpha=0.85)
    _same(s, i, rs, ri)
    with pytest.raises(ValueError, match="projection"):
        tpar.DistributedSearchSession(tidx.aspace.data, tidx.aspace.lambdas,
                                      tidx.gl.matrix, tm, batch_size=8, k=7)


def test_distributed_session_tall_graph_index(meshes):
    """from_index over an allow_tall_graphs energy index (graph nodes >
    F), carried across: query λ pads instead of raising; equal to the JAX
    mesh session."""
    from arrowspace_tpu import energymaps as jen
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
    from arrowspace_tpu.energymaps import EnergyParams as JEP
    from arrowspace_tpu.index import ArrowIndex as JIndex
    jm, tm = meshes
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02, (800, 16))
    b = (JBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    ja, jg = jen.build_energy(b, rows.tolist(),
                              JEP(split_quantile=0.2, allow_tall_graphs=True))
    assert jg.shape()[0] > ja.nfeatures
    jidx = JIndex(ja, jg, b)
    tidx = from_jax_state(np.asarray(ja.data), np.asarray(ja.lambdas),
                          np.asarray(jg.matrix), ja.taumode,
                          pad_tall_graphs=True, device="cpu",
                          dtype=torch.float64)
    tsess = tpar.DistributedSearchSession.from_index(tidx, tm, batch_size=4,
                                                     k=5, alpha=0.9)
    tsess.warmup()
    jsess = jpar.DistributedSearchSession.from_index(jidx, jm, batch_size=4,
                                                     k=5, alpha=0.9)
    q = rows[:4] * 1.01
    (s, i), = tuple(tsess.search_stream([q]))
    (js, ji), = tuple(jsess.search_stream([q]))
    _same(s, i, js, ji)


def _uniform_case(seed, n=8 * 1024, f=16, b=4, n_batches=3, lap_seed=2):
    rng = np.random.default_rng(seed)
    items = rng.uniform(0.1, 1.0, (n, f))
    lam = rng.uniform(0, 1, n)
    _, lap = _setup(64, f, seed=lap_seed)
    batches = [rng.uniform(0.1, 1.0, (b, f)) for _ in range(n_batches)]
    return items, lam, np.asarray(lap)[:f, :f], batches


def test_distributed_session_binned_parity_and_repair_wiring(meshes):
    """The binned mesh session equals the JAX "xla" mesh session on
    collision-free data, and the stream routes a flagged row through the
    session's repair (a flag injected into the step: the row has no
    fired bin, so the strided repair passes it through exact)."""
    jm, tm = meshes
    items, lam, lap, batches = _uniform_case(7)
    ref = jpar.DistributedSearchSession(
        jnp.asarray(items), jnp.asarray(lam), jnp.asarray(lap), jm, 4, k=5,
        kernel="xla")
    bn = tpar.DistributedSearchSession(items, lam, lap, tm, 4, k=5,
                                       kernel="binned")
    assert bn.kernel == "binned" and bn._repair is not None
    ref_out = list(ref.search_stream(batches))
    for (s_b, i_b), (s_r, i_r) in zip(bn.search_stream(batches), ref_out):
        _same(s_b, i_b, s_r, i_r)

    calls = []
    inner, orig = bn._repair, bn._step

    def spy(q, qlam, det, scores, ids, flags):
        calls.append((np.nonzero(flags)[0], det))
        return inner(q, qlam, det, scores, ids, flags)

    def step_with_flag(q):
        s, i, flags, qlam, det = orig(q)
        flags = flags.clone()
        flags[0] = True
        return s, i, flags, qlam, det

    bn._repair, bn._step = spy, step_with_flag
    (s_out, i_out), = list(bn.search_stream(batches[:1]))
    assert calls and list(calls[0][0]) == [0]
    assert calls[0][1].shape == (4, 8 * bins_target(5))
    _same(s_out, i_out, ref_out[0][0], ref_out[0][1])


@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_distributed_session_strided_repair_restores_exactness(meshes,
                                                               alpha):
    """More than depth copies of query 0 in ONE local bin of shard 3 flag
    it, and the strided repair over the gathered det plane (the fired
    (shard, bin) column rescored against the shards) restores the exact
    result: equal to the JAX "xla" mesh session, the copies lowest id
    first.  α < 1 exercises the λ term of the repair score."""
    from arrowspace_torch.ops import bin_repair
    jm, tm = meshes
    rng = np.random.default_rng(11)
    shard_n, f, b, k = 8192, 16, 4, 6
    n = 8 * shard_n
    bins, depth = bins_target(k), binned_topk_depth_for(k)
    items = rng.uniform(0.1, 1.0, (n, f))
    q0 = rng.uniform(0.1, 1.0, (b, f))
    base = 3 * shard_n
    dup_rows = [base + 5 + j * bins for j in range(depth + 2)]
    items[dup_rows] = q0[0]
    lam = np.full(n, 0.5)
    _, lap = _setup(64, f, seed=3)
    lap = np.asarray(lap)[:f, :f]
    ref = jpar.DistributedSearchSession(
        jnp.asarray(items), jnp.asarray(lam), jnp.asarray(lap), jm, b, k=k,
        alpha=alpha, kernel="xla")
    bn = tpar.DistributedSearchSession(items, lam, lap, tm, b, k=k,
                                       alpha=alpha, kernel="binned")
    calls = []
    inner = bn._repair

    def spy(q, qlam, det, scores, ids, flags):
        calls.append((np.nonzero(flags)[0], det))
        return inner(q, qlam, det, scores, ids, flags)

    bn._repair = spy
    before = bin_repair.strided_lambda_repair.calls
    (s_b, i_b), = list(bn.search_stream([q0]))
    (s_r, i_r), = list(ref.search_stream([q0]))
    assert calls and 0 in calls[0][0], "the storm must flag query 0"
    assert calls[0][1] is not None and calls[0][1].shape[1] == 8 * bins
    assert bin_repair.strided_lambda_repair.calls == before + 1
    _same(s_b, i_b, s_r, i_r)
    assert list(i_r[0][:len(dup_rows)]) == dup_rows


def test_distributed_session_overflow_takes_the_exact_pass(meshes):
    """A row whose fired (shard, bin) columns overflow MAX_FIRED (copies
    of the query in three bins of two shards) takes the distributed exact
    pass, and comes back equal to the JAX "xla" mesh session."""
    from arrowspace_torch.ops.bin_repair import MAX_FIRED
    jm, tm = meshes
    rng = np.random.default_rng(19)
    shard_n, f, b, k = 8192, 16, 4, 10
    n = 8 * shard_n
    bins, depth = bins_target(k), binned_topk_depth_for(k)
    items = rng.uniform(0.1, 1.0, (n, f))
    q0 = rng.uniform(0.1, 1.0, (b, f))
    dups = []
    for s, bn_ in [(1, 9), (1, 40), (6, 9)][:MAX_FIRED + 1]:
        dups += [s * shard_n + bn_ + j * bins for j in range(depth + 1)]
    items[dups] = q0[0]
    lam = np.full(n, 0.25)
    _, lap = _setup(64, f, seed=3)
    lap = np.asarray(lap)[:f, :f]
    ref = jpar.DistributedSearchSession(
        jnp.asarray(items), jnp.asarray(lam), jnp.asarray(lap), jm, b, k=k,
        alpha=0.9, kernel="xla")
    bn = tpar.DistributedSearchSession(items, lam, lap, tm, b, k=k, alpha=0.9,
                                       kernel="binned")
    (s_b, i_b), = list(bn.search_stream([q0]))
    (s_r, i_r), = list(ref.search_stream([q0]))
    _same(s_b, i_b, s_r, i_r)
    assert list(i_b[0]) == sorted(dups)[:k]


def test_distributed_session_prepared_corpus_matches_raw(meshes):
    """The per-shard prepared corpus (normalised and padded once) gives
    bitwise the raw per-dispatch path's results, binned and merge."""
    _jm, tm = meshes
    items, lam, lap, batches = _uniform_case(13, n_batches=2, lap_seed=5)
    for kernel in ("binned", "merge"):
        prep = tpar.DistributedSearchSession(items, lam, lap, tm, 4, k=5,
                                             kernel=kernel)
        raw = tpar.DistributedSearchSession(items, lam, lap, tm, 4, k=5,
                                            kernel=kernel,
                                            prepare_corpus=False)
        for (s_p, i_p), (s_r, i_r) in zip(prep.search_stream(batches),
                                          raw.search_stream(batches)):
            np.testing.assert_array_equal(i_p, i_r)
            np.testing.assert_array_equal(s_p, s_r)


def test_sharded_from_jax_state_splits_the_index(meshes):
    """convert.sharded_from_jax_state: the JAX index's arrays as a port
    index and its corpus and λ split over the mesh (views of the index's
    tensors on a shared device)."""
    from arrowspace_tpu.index import ArrowIndex as JIndex
    _jm, tm = meshes
    rng = np.random.default_rng(3)
    rows = _clustered_rows(rng, 1024, 16, 5)
    jidx = JIndex.build(rows, eps=1.0, seed=3)
    ja = jidx.aspace
    tidx, x, lam = sharded_from_jax_state(
        np.asarray(ja.data), np.asarray(ja.lambdas),
        np.asarray(jidx.gl.matrix), ja.taumode, tm, dtype=torch.float64)
    np.testing.assert_array_equal(x.numpy(), np.asarray(ja.data))
    np.testing.assert_array_equal(lam.numpy(), np.asarray(ja.lambdas))
    assert x.shards[2].data_ptr() == tidx.aspace.data[256:].data_ptr()
    q = rows[:3] * 1.01
    sess = tpar.DistributedSearchSession(x, lam, tidx.gl.matrix, tm, 3, k=5)
    (s, i), = list(sess.search_stream([q]))
    rs, ri = jidx.search(q, k=5, alpha=0.9)
    _same(s, i, rs, ri)


def test_distributed_index_step_matches_jax(meshes):
    jm, tm = meshes
    rows, _ = _setup(n=128, f=16)
    params = dict(eps=1.0, k=5, topk=3, p=2.0, sigma=None, normalise=False,
                  sparsity_check=False)
    jl, js, ji = jpar.distributed_index_step(
        jnp.asarray(rows), jnp.asarray(rows[:10]),
        jnp.asarray(rows[:2] * 1.02),
        JTau.median(), JParams(**params), 5, jm)
    tl, ts, ti = tpar.distributed_index_step(
        rows, rows[:10], rows[:2] * 1.02, TauMode.median(),
        GraphParams(**params), 5, tm)
    assert tl.shape == (128,) and _np(ts).shape == (2, 5)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _same(ts, ti, js, ji)
    assert np.all(np.isfinite(_np(ts)))


def _check_clustering(cents, assigns, sizes, n, max_c):
    assert 1 <= cents.shape[0] <= max_c
    assert len(assigns) == n
    a = assigns.array
    assert sum(sizes) == int((a >= 0).sum())
    assert np.all((a == -1) | ((a >= 0) & (a < cents.shape[0])))


def test_sharded_clustering_invariants(meshes):
    """Sampled sharded clustering: the scan's invariants hold, the count
    of clusters lies near the single-device chunked mode's, and the
    result equals the JAX mesh scan's (the same sampler draws)."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
    from arrowspace_tpu.sampling import SamplerType as JSampler
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.clustering import _incremental_clustering_chunked
    from arrowspace_torch.sampling import SamplerType
    jm, tm = meshes
    rng = np.random.default_rng(29)
    centers = rng.uniform(0, 1, (6, 16))
    rows = centers[rng.integers(0, 6, 8192)] + rng.normal(0, 0.04,
                                                          (8192, 16))
    b = ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
    b.sampling = SamplerType.simple(0.6)
    cents, assigns, sizes = tpar.sharded_incremental_clustering(
        rows, b, 16, 0.3, SamplerType.simple(0.6).make(seed=5), tm,
        rounds_chunk=512)
    _check_clustering(cents, assigns, sizes, 8192, 16)
    b2 = ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
    b2.sampling = SamplerType.simple(0.6)
    c_chunk, _, _ = _incremental_clustering_chunked(
        b2, rows, 16, 16, 0.3, SamplerType.simple(0.6).make(seed=5),
        chunk=512)
    assert abs(cents.shape[0] - c_chunk.shape[0]) <= 6

    jb = JBuilder()
    jb.sampling = JSampler.simple(0.6)
    items = jax.device_put(jnp.asarray(rows), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("items", None)))
    jc, ja, js = jpar.sharded_incremental_clustering(
        items, jb, 16, 0.3, JSampler.simple(0.6).make(seed=5), jm,
        rounds_chunk=512)
    np.testing.assert_array_equal(assigns.array, ja.array)
    assert sizes == js
    np.testing.assert_allclose(cents, jc, rtol=0, atol=TOL)


def test_sharded_clustering_tail_round(meshes):
    """shard_n not a multiple of the round chunk (rounds of 300/300/300/
    124): the clamped window's results line up with the host rows, every
    row is decided, each lies within the relaxed radius of its centroid,
    and the result equals the JAX mesh scan's."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
    from arrowspace_tpu.sampling import SamplerType as JSampler
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.sampling import SamplerType
    jm, tm = meshes
    rng = np.random.default_rng(61)
    centers = rng.uniform(0, 1, (6, 16))
    rows = centers[rng.integers(0, 6, 8192)] + rng.normal(0, 0.03,
                                                          (8192, 16))
    b = ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
    b.sampling = None
    cents, assigns, sizes = tpar.sharded_incremental_clustering(
        rows, b, 16, 0.3, SamplerType.simple(1.0).make(seed=1), tm,
        rounds_chunk=300)
    _check_clustering(cents, assigns, sizes, 8192, 16)
    a = assigns.array
    assert np.all(a >= 0) and sum(sizes) == 8192
    d = ((rows[:, None, :] - cents[None, :, :]) ** 2).sum(axis=2)
    assert np.all(d[np.arange(8192), a] <= 0.3 * 1.5 + 1e-9)
    jb = JBuilder()
    jb.sampling = None
    items = jax.device_put(jnp.asarray(rows), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("items", None)))
    jc, ja, js = jpar.sharded_incremental_clustering(
        items, jb, 16, 0.3, JSampler.simple(1.0).make(seed=1), jm,
        rounds_chunk=300)
    np.testing.assert_array_equal(a, ja.array)
    np.testing.assert_allclose(cents, jc, rtol=0, atol=TOL)


def test_distributed_build_step_end_to_end(meshes):
    """Sharded build -> query, against the JAX mesh build step: the same
    centroids, λ and top-k; each query's source row first."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
    from arrowspace_torch.builder import ArrowSpaceBuilder
    jm, tm = meshes
    rng = np.random.default_rng(31)
    centers = rng.uniform(0.2, 0.8, (5, 16))
    rows = centers[rng.integers(0, 5, 4096)] + rng.normal(0, 0.04,
                                                          (4096, 16))
    params = dict(eps=1.0, k=5, topk=3, p=2.0, sigma=None, normalise=False,
                  sparsity_check=False)
    jb = JBuilder()
    jb.sampling = None
    jc, jl, js, ji = jpar.distributed_build_step(
        jnp.asarray(rows), jb, jnp.asarray(rows[:4] * 1.01), JTau.median(),
        JParams(**params), 5, jm, max_clusters=12, radius=0.3)
    b = ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
    b.sampling = None
    info = {}
    tc, tl, ts, ti = tpar.distributed_build_step(
        rows, b, rows[:4] * 1.01, TauMode.median(), GraphParams(**params), 5,
        tm, max_clusters=12, radius=0.3, clustering=info)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=TOL)
    _same(ts, ti, js, ji)
    assert tl.shape == (4096,) and _np(ts).shape == (4, 5)
    assert [int(_np(ti)[q][0]) for q in range(4)] == [0, 1, 2, 3]
    assert sum(info["sizes"]) == 4096 and info["seconds"] > 0


def test_multiprocess_build_refuses_unseeded_sampling(monkeypatch, meshes):
    """Across processes an unseeded sampler is refused (each process
    would draw its own entropy); one process accepts it."""
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.sampling import SamplerType
    _jm, tm = meshes
    rows, _ = _setup(n=128, f=16)
    b = ArrowSpaceBuilder(device="cpu", dtype=torch.float64)
    b.sampling = SamplerType.simple(0.6)
    args = (rows, b, rows[:2], TauMode.median(),
            GraphParams(eps=1.0, k=5, topk=3, p=2.0, sigma=None,
                        normalise=False, sparsity_check=False), 5)
    out = tpar.distributed_build_step(*args, tm, max_clusters=8, radius=0.3)
    assert _np(out[3]).shape == (2, 5)
    monkeypatch.setattr(type(tm), "multiprocess", property(lambda s: True))
    with pytest.raises(ValueError, match="seeded"):
        tpar.distributed_build_step(*args, tm, max_clusters=8, radius=0.3)
