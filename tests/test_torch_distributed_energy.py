"""arrowspace_torch.parallel.DistributedEnergySearchSession against the
JAX package's mesh energy session, on the CPU.

The six energy cases of tests/test_distributed.py (:641-823) in both
packages: the JAX side on the 8 virtual CPU devices of tests/conftest.py,
the port on an 8-shard CPU mesh, the same seeded inputs.  JAX energy
indexes are carried across with convert.from_jax_state (projection,
energy graph, λ and the tall-graph flag), so both serve the same z-plane.
The port's binned shards run K6's plain version here, over a z-plane
centred on its global mean.

Tolerances: ids and tie order exact; float64 scores within 1e-10 (the
centring and the rsqrt form round in another order than the JAX
package's scorer)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arrowspace_tpu import parallel as jpar
from arrowspace_tpu.taumode import TauMode as JTau
from arrowspace_torch import parallel as tpar
from arrowspace_torch.convert import from_jax_state
from arrowspace_torch.ops import bin_repair
from arrowspace_torch.ops.bintopk import binned_topk_depth_for, bins_target
from arrowspace_torch.taumode import TauMode
from data import make_moons_hd
from helpers import oracle_adjacency, oracle_laplacian

TOL = 1e-10


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jpar.make_mesh(8), tpar.make_mesh(devices=["cpu"] * 8)


def _carry(jidx):
    a = jidx.aspace
    proj = None if a.projection_matrix is None else \
        np.asarray(a.projection_matrix.matrix())
    sig = None if a.signals is None else np.asarray(a.signals)
    return from_jax_state(np.asarray(a.data), np.asarray(a.lambdas),
                          np.asarray(jidx.gl.matrix), a.taumode,
                          projection=proj, signals=sig,
                          pad_tall_graphs=a.pad_tall_graphs, device="cpu",
                          dtype=torch.float64)


def _same(s, i, js, ji):
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(s), np.asarray(js), rtol=0,
                               atol=TOL)


@pytest.fixture(scope="module")
def energy_index_800():
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams, build_energy
    from arrowspace_tpu.index import ArrowIndex
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02,
                                                          (800, 16))
    b = (ArrowSpaceBuilder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    jidx = ArrowIndex(aspace, gl, b)
    return jidx, _carry(jidx), rows


def _lap(f, seed):
    rows = make_moons_hd(64, noise=0.08, hd_noise=0.05, dims=f, seed=seed)
    adj = oracle_adjacency(rows.T[:, :32], eps=1.0, topk=4, p=2.0,
                           sigma=None)
    return np.asarray(oracle_laplacian(adj))[:f, :f]


def _uniform(seed, n=8 * 1024, f=16, b=4, n_batches=2):
    rng = np.random.default_rng(seed)
    items = rng.uniform(0.1, 1.0, (n, f))
    lam = rng.uniform(0, 1, n)
    batches = [rng.uniform(0.1, 1.0, (b, f)) for _ in range(n_batches)]
    return items, lam, _lap(f, 5), batches


def test_distributed_energy_session_matches_single(meshes,
                                                   energy_index_800):
    """from_index over a built energy index: the mesh session (per-shard
    z-plane, gathered merge) equals the JAX mesh session, the port's
    search_energy and the port's single-device session, a partial tail
    batch included."""
    jm, tm = meshes
    jidx, tidx, rows = energy_index_800
    assert tidx.nitems % 8 == 0
    sess = tpar.DistributedEnergySearchSession.from_index(
        tidx, tm, batch_size=8, k=5, w_lambda=1.0, w_dirichlet=0.5)
    assert sess.kernel == "chunked"
    sess.warmup()
    jsess = jpar.DistributedEnergySearchSession.from_index(
        jidx, jm, batch_size=8, k=5, w_lambda=1.0, w_dirichlet=0.5)
    single = tidx.make_energy_session(batch_size=8, k=5)
    batches = [rows[:8] * 1.01, rows[8:11] * 1.01]
    got = list(sess.search_stream(batches))
    assert got[0][1].shape == (8, 5) and got[1][1].shape == (3, 5)
    for qb, (s, i), (js, ji), (ss, si) in zip(
            batches, got, jsess.search_stream(batches),
            single.search_stream(batches)):
        _same(s, i, js, ji)
        _same(s, i, ss, si)
        rs, ri = tidx.search_energy(qb, k=5, w_lambda=1.0, w_dirichlet=0.5)
        _same(s, i, rs, ri)


def test_distributed_energy_weight_sweep(meshes, energy_index_800):
    """Each (w_λ, w_D) session equals the JAX one and search_energy."""
    jm, tm = meshes
    jidx, tidx, rows = energy_index_800
    queries = rows[5:9] * 1.02
    for wl, wd in ((0.3, 1.7), (0.0, 1.0)):
        sess = tpar.DistributedEnergySearchSession.from_index(
            tidx, tm, batch_size=4, k=5, w_lambda=wl, w_dirichlet=wd)
        jsess = jpar.DistributedEnergySearchSession.from_index(
            jidx, jm, batch_size=4, k=5, w_lambda=wl, w_dirichlet=wd)
        (s, i), = list(sess.search_stream([queries]))
        (js, ji), = list(jsess.search_stream([queries]))
        _same(s, i, js, ji)
        rs, ri = tidx.search_energy(queries, k=5, w_lambda=wl,
                                    w_dirichlet=wd)
        _same(s, i, rs, ri)


def test_distributed_energy_binned_matches_chunked(meshes):
    """The per-shard binned energy session (K6) equals the chunked one,
    and both equal the JAX chunked mesh session, on storm-free data."""
    jm, tm = meshes
    items, lam, lap, batches = _uniform(23)
    ref = tpar.DistributedEnergySearchSession(items, lam, lap, tm, 4, k=5,
                                              kernel="chunked",
                                              taumode=TauMode.median())
    bn = tpar.DistributedEnergySearchSession(items, lam, lap, tm, 4, k=5,
                                             kernel="binned",
                                             taumode=TauMode.median())
    jref = jpar.DistributedEnergySearchSession(
        jnp.asarray(items), jnp.asarray(lam), jnp.asarray(lap), jm, 4, k=5,
        kernel="chunked", taumode=JTau.median())
    assert bn._repair is not None and ref._repair is None
    for (s_b, i_b), (s_r, i_r), (js, ji) in zip(
            bn.search_stream(batches), ref.search_stream(batches),
            jref.search_stream(batches)):
        _same(s_b, i_b, s_r, i_r)
        _same(s_r, i_r, js, ji)


def test_distributed_energy_prepared_corpus_matches_raw(meshes):
    """The per-shard prepared z corpus (centred, padded, norms once)
    gives bitwise the per-dispatch path's results."""
    _jm, tm = meshes
    items, lam, lap, batches = _uniform(29)
    prep = tpar.DistributedEnergySearchSession(items, lam, lap, tm, 4, k=5,
                                               kernel="binned",
                                               taumode=TauMode.median())
    raw = tpar.DistributedEnergySearchSession(items, lam, lap, tm, 4, k=5,
                                              kernel="binned",
                                              prepare_corpus=False,
                                              taumode=TauMode.median())
    for (s_p, i_p), (s_r, i_r) in zip(prep.search_stream(batches),
                                      raw.search_stream(batches)):
        np.testing.assert_array_equal(i_p, i_r)
        np.testing.assert_array_equal(s_p, s_r)


def test_distributed_energy_strided_repair_restores_exactness(meshes):
    """More than depth copies of query 0 (z = items: no projection or
    signals, so d² = 0 ties them at the top) in ONE local bin of shard 3
    flag it, and the strided energy repair over the gathered det plane
    restores the exact result: equal to the port's and the JAX chunked
    mesh sessions, the copies lowest id first."""
    jm, tm = meshes
    rng = np.random.default_rng(31)
    shard_n, f, b, k = 8192, 16, 4, 6
    n = 8 * shard_n
    bins, depth = bins_target(k), binned_topk_depth_for(k)
    items = rng.uniform(0.1, 1.0, (n, f))
    q0 = rng.uniform(0.1, 1.0, (b, f))
    base = 3 * shard_n
    dup_rows = [base + 5 + j * bins for j in range(depth + 2)]
    items[dup_rows] = q0[0]
    lam = np.full(n, 0.5)
    lap = _lap(f, 3)
    ref = tpar.DistributedEnergySearchSession(items, lam, lap, tm, b, k=k,
                                              kernel="chunked",
                                              taumode=TauMode.median())
    jref = jpar.DistributedEnergySearchSession(
        jnp.asarray(items), jnp.asarray(lam), jnp.asarray(lap), jm, b, k=k,
        kernel="chunked", taumode=JTau.median())
    bn = tpar.DistributedEnergySearchSession(items, lam, lap, tm, b, k=k,
                                             kernel="binned",
                                             taumode=TauMode.median())
    calls = []
    inner = bn._repair

    def spy(q, qlam, det, scores, ids, flags):
        calls.append((np.nonzero(flags)[0], det))
        return inner(q, qlam, det, scores, ids, flags)

    bn._repair = spy
    before = bin_repair.strided_energy_repair.calls
    (s_b, i_b), = list(bn.search_stream([q0]))
    (s_r, i_r), = list(ref.search_stream([q0]))
    (js, ji), = list(jref.search_stream([q0]))
    assert calls and 0 in calls[0][0], "the storm must flag query 0"
    assert calls[0][1].shape == (b, 8 * bins)
    assert bin_repair.strided_energy_repair.calls == before + 1
    _same(s_b, i_b, s_r, i_r)
    _same(s_r, i_r, js, ji)
    assert list(i_b[0][:len(dup_rows)]) == dup_rows


def test_distributed_energy_session_projected_index(meshes):
    """from_index over a dims-reduced energy index, carried across: the
    queries project inside the step (λ preparation and z-plane in the
    reduced space); equal to the JAX mesh session and search_energy."""
    from arrowspace_tpu.builder import ArrowSpaceBuilder
    from arrowspace_tpu.energymaps import EnergyParams, build_energy
    from arrowspace_tpu.index import ArrowIndex
    jm, tm = meshes
    rng = np.random.default_rng(17)
    centers = rng.uniform(0.2, 0.8, (6, 96))
    rows = centers[rng.integers(0, 6, 512)] + rng.normal(0, 0.05, (512, 96))
    b = (ArrowSpaceBuilder().with_seed(9).with_dims_reduction(True, 0.9)
         .with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    assert aspace.projection_matrix is not None
    jidx = ArrowIndex(aspace, gl, b)
    tidx = _carry(jidx)
    sess = tpar.DistributedEnergySearchSession.from_index(tidx, tm,
                                                          batch_size=8, k=7)
    sess.warmup()
    jsess = jpar.DistributedEnergySearchSession.from_index(jidx, jm,
                                                           batch_size=8, k=7)
    q = rows[:8] * 1.01
    (s, i), = tuple(sess.search_stream([q]))
    (js, ji), = tuple(jsess.search_stream([q]))
    _same(s, i, js, ji)
    rs, ri = tidx.search_energy(q, k=7)
    _same(s, i, rs, ri)
