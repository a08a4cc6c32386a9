"""The plain versions of K4 (τ selection), K6 (binned energy top-k) and K7
(chord-surrogate energy fold) of arrowspace_torch, and the strided energy
repair, against the JAX package's Pallas kernels run in interpret mode
and its chunked energy scorer, on the CPU.

The port's wrappers take their plain versions here because the tensors
lie on the CPU; tests/test_torch_cuda.py holds the kernels themselves
against these plain versions on a card.

Tolerances: τ bitwise (an order statistic is an element of the row, or
the float32 mean of two); ids exact (ties to the lowest id); float32
energy scores within 1e-6 of the JAX kernel's and the chunked oracle's,
as the JAX package's own kernel tests hold them (both sides compute
d² = (|q|² + |x|²) - 2·q·x, with the dot product summed in another
order); certified K7 rows within 5e-5 of the oracle, the bound the JAX
package's approx tests state for the CPU (d² cancels for near duplicates
and the rsqrt form magnifies it); float64 paths within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrowspace_tpu.energymaps import _energy_score_topk_chunked as j_chunked
from arrowspace_tpu.ops import bin_repair as j_repair
from arrowspace_tpu.ops import energy_approx as j_approx
from arrowspace_tpu.ops.pallas_bintopk import _padded_rows
from arrowspace_tpu.ops.pallas_bintopk import binned_energy_topk as j_binned
from arrowspace_tpu.ops.pallas_tau import fused_select_tau as j_tau
from arrowspace_torch import taumode
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.ops import energy_approx as ea
from arrowspace_torch.ops import energy_bintopk as eb
from arrowspace_torch.ops import select_tau as st
from arrowspace_torch.ops.search import INT_MAX
from arrowspace_torch.taumode import TauMode


def _energy_data(n, g, b, seed=0, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:
        cents = rng.normal(size=(16, g)) * 2
        z = cents[rng.integers(0, 16, n)] + rng.normal(0, 0.5, (n, g))
        zq = z[rng.integers(0, n, b)] * 1.02
    else:
        z, zq = rng.normal(size=(n, g)), rng.normal(size=(b, g))
    return (zq.astype(np.float32), rng.uniform(0, 1, b).astype(np.float32),
            z.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _oracle(zq, qlam, z, xlam, wl, wd, k):
    s, i = j_chunked(jnp.asarray(zq), jnp.asarray(qlam), jnp.asarray(z),
                     jnp.asarray(xlam), jnp.float32(wl), jnp.float32(wd),
                     k=k, chunk=128)
    return np.asarray(s), np.asarray(i)


def _binned(zq, qlam, z, xlam, wl, wd, k):
    """The port's K6 path on the CPU: prepare, plain pool, flush."""
    zx, xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    q, ql = _t(zq, qlam)
    return eb.binned_energy_topk(q, ql, zx, xl, xn, eb.dtype_scalar(wl,
                                 zx.dtype), eb.dtype_scalar(wd, zx.dtype),
                                 k=k, n=z.shape[0])


def _jax_binned(zq, qlam, z, xlam, wl, wd, k):
    return j_binned(jnp.asarray(zq), jnp.asarray(qlam), jnp.asarray(z),
                    jnp.asarray(xlam), wl, wd, k=k, tile=bt.bins_target(k),
                    lane_split=1, interpret=True, block_b=4,
                    return_det=True)


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("f", [77, 128, 7])
@pytest.mark.parametrize("mode", [TauMode.median(), TauMode.percentile(0.3),
                                  TauMode.percentile(0.75)])
def test_k4_plain_matches_pallas_tau(f, mode):
    rng = np.random.default_rng(f)
    x = rng.normal(0.5, 1.0, (300, f)).astype(np.float32)
    x[3, min(5, f - 1)] = np.nan
    x[7, 0] = np.inf
    x[8, ::2] = -np.inf
    x[9] = np.nan                      # no finite value: TAU_FLOOR
    x[10] = 0.0                        # floored at TAU_FLOOR
    pct = mode.value if mode.kind == "percentile" else 0.5
    ref = np.asarray(j_tau(jnp.asarray(x), kind=mode.kind, pct=pct,
                           tile=256, interpret=True))
    before = st.fused_select_tau.launches
    got = st.fused_select_tau(torch.from_numpy(x), mode).numpy()
    assert st.fused_select_tau.launches == before      # plain on the CPU
    np.testing.assert_array_equal(got, ref)
    assert got[9] == got[10] == np.float32(taumode.TAU_FLOOR)


def test_select_tau_batch_routes_float32_batches_to_k4(monkeypatch):
    """The gate is keyed on size and dtype: float32 median or percentile
    batches of at least 2²² values take K4's wrapper (its plain version
    here), rows of up to 1536 values included, float64 and smaller
    batches the sort."""
    calls = []
    real = st.fused_select_tau

    def spy(x, mode):
        calls.append(tuple(x.shape))
        return real(x, mode)
    monkeypatch.setattr(st, "fused_select_tau", spy)
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.normal(size=(32768, 128)).astype(np.float32))
    for mode in (TauMode.median(), TauMode.percentile(0.4)):
        tau = taumode.select_tau_batch(big, mode)
        assert torch.equal(tau, taumode.select_tau_sorted(big, mode))
    assert calls == [(32768, 128)] * 2
    taumode.select_tau_batch(big[:1000], TauMode.median())
    taumode.select_tau_batch(big.double(), TauMode.median())
    taumode.select_tau_batch(big, TauMode.mean())
    assert len(calls) == 2
    wide = torch.from_numpy(rng.normal(size=(4096, 1536)).astype(np.float32))
    tau = taumode.select_tau_batch(wide, TauMode.median())
    assert torch.equal(tau, taumode.select_tau_sorted(wide, TauMode.median()))
    assert calls[2:] == [(4096, 1536)]


# ------------------------------------------------------------------ K6


@pytest.mark.parametrize("n,g,k,wl,wd", [(1000, 48, 8, 1.0, 0.5),
                                         (2048, 64, 10, 1.0, 0.5),
                                         (777, 17, 5, 0.7, 1.3),
                                         (3001, 32, 29, 2.0, 0.25),
                                         (900, 8, 64, 0.3, 1.0)])
def test_k6_plain_matches_pallas_and_oracle(n, g, k, wl, wd):
    zq, qlam, z, xlam = _energy_data(n, g, 6, seed=n + k)
    s, i, fl, det = _binned(zq, qlam, z, xlam, wl, wd, k)
    js, ji, jfl, jdet = _jax_binned(zq, qlam, z, xlam, wl, wd, k)
    os_, oi = _oracle(zq, qlam, z, xlam, wl, wd, k)
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl) != 0)
    assert det.shape == (6, bt.bins_target(k))
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    ok = ~fl.numpy()
    np.testing.assert_array_equal(i.numpy()[ok], oi[ok])
    np.testing.assert_allclose(s.numpy()[ok], os_[ok], atol=1e-6)


def test_k6_duplicate_ties_go_to_the_lowest_id():
    """Exact copies in one bin (stride 128) and in another bin: the
    results keep increasing ids, as lax.top_k over the full plane."""
    rng = np.random.default_rng(11)
    n, g, k = 900, 16, 6
    z = rng.normal(size=(n, g)).astype(np.float32)
    for j in (5, 5 + 256, 5 + 512, 300):
        z[j] = z[5]
    xlam = np.full(n, 0.4, np.float32)
    zq, qlam = z[5][None, :].copy(), np.array([0.4], np.float32)
    s, i, fl, _ = _binned(zq, qlam, z, xlam, 1.0, 0.5, k)
    _, oi = _oracle(zq, qlam, z, xlam, 1.0, 0.5, k)
    assert not bool(fl[0])
    assert i[0, :4].tolist() == [5, 261, 300, 517]
    np.testing.assert_array_equal(i.numpy(), oi)
    assert torch.equal(s[0, :4], torch.full((4,), float(s[0, 0])))


def test_k6_flags_a_deep_collision_like_pallas():
    """depth+1 copies of the best row in ONE bin: both flag the query;
    the oracle returns the copies in id order."""
    rng = np.random.default_rng(13)
    n, g, k = 1100, 16, 8
    depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
    z = (rng.normal(size=(n, g)) * 5.0).astype(np.float32)
    dup = [9 + d * bins for d in range(depth + 1)]
    z[dup] = z[9]
    xlam = np.full(n, 0.5, np.float32)
    zq, qlam = z[9][None, :].copy(), np.array([0.5], np.float32)
    _, _, fl, _ = _binned(zq, qlam, z, xlam, 1.0, 0.5, k)
    _, _, jfl, _ = _jax_binned(zq, qlam, z, xlam, 1.0, 0.5, k)
    assert bool(fl[0]) and int(np.asarray(jfl)[0]) == 1
    _, oi = _oracle(zq, qlam, z, xlam, 1.0, 0.5, k)
    assert oi[0, :depth + 1].tolist() == dup


@pytest.mark.parametrize("chunk", [128, 1000, 65536])
def test_chunked_scorer_matches_jax(chunk):
    """The plain chunked scorer (the repair fallback and the sessions'
    reference): float32 against the JAX scorer within 1e-6 and ids
    exact, float64 within 1e-12."""
    zq, qlam, z, xlam = _energy_data(2500, 24, 5, seed=chunk)
    s, i = eb.energy_topk_chunked(*_t(zq, qlam, z, xlam), 1.0, 0.5, k=12,
                                  chunk=chunk)
    js, ji = _oracle(zq, qlam, z, xlam, 1.0, 0.5, 12)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-6)
    d = [a.astype(np.float64) for a in (zq, qlam, z, xlam)]
    s64, i64 = eb.energy_topk_chunked(*_t(*d), 1.0, 0.5, k=12, chunk=chunk)
    js64, ji64 = j_chunked(*[jnp.asarray(a) for a in d], 1.0, 0.5, k=12,
                           chunk=128)
    np.testing.assert_array_equal(i64.numpy(), np.asarray(ji64))
    np.testing.assert_allclose(s64.numpy(), np.asarray(js64), rtol=0,
                               atol=1e-12)


def test_k6_pool_matches_a_per_bin_reference():
    """The plain pool, chunk by chunk and bin by bin, against a numpy
    fold: per (query, chunk, bin) the top-depth rows by (-score, id) and
    the (depth+1)-th score as det."""
    zq, qlam, z, xlam = _energy_data(1500, 12, 3, seed=4)
    zx, xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    q, ql = _t(zq, qlam)
    qn = (q * q).sum(dim=1)
    depth, bins, chunks, n = 3, 128, 4, 1500
    ps, pi, det = eb.binned_energy_pool(q, qn, ql, zx, xn, xl, 1.0, 0.5, n,
                                        depth=depth, bins=bins,
                                        chunks=chunks)
    plane, _ = eb.energy_plane(q, qn, ql, zx[:n], xn[:n], xl[:n], 1.0, 0.5)
    plane = plane.numpy()
    tiles = -(-n // bins)
    per = -(-tiles // chunks) * bins
    for c in range(ps.shape[1]):
        for b in (0, 5, 127):
            g = np.arange(c * per + b, min(n, (c + 1) * per), bins)
            for r in range(3):
                order = np.lexsort((g, -plane[r, g]))
                m = min(depth, g.size)
                assert pi[r, c, :m, b].tolist() == g[order[:m]].tolist()
                np.testing.assert_array_equal(ps[r, c, :m, b].numpy(),
                                              plane[r, g[order[:m]]])
                if g.size > depth:
                    assert det[r, c, b] == plane[r, g[order[depth]]]


# ------------------------------------------------------------------ K7


def _approx(zq, qlam, z, xlam, wl, wd, k, seed=0):
    zx, xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, z.shape[0], seed=seed)
    q, ql = _t(zq, qlam)
    return ea.binned_energy_topk_approx(q, ql, zx, xl, xn, z_s, xn_s,
                                        eb.dtype_scalar(wl, zx.dtype),
                                        eb.dtype_scalar(wd, zx.dtype), k=k,
                                        n=z.shape[0])


def _jax_approx(zq, qlam, z, xlam, wl, wd, k, seed=0):
    pad = _padded_rows(z.shape[0], bt.bins_target(k)) - z.shape[0]
    zx = jnp.asarray(np.pad(z, ((0, pad), (0, 0))))
    xl = jnp.asarray(np.pad(xlam, (0, pad)))
    xn = jnp.sum(zx * zx, axis=1)
    z_s, xn_s = j_approx.prepare_energy_chord_sample(zx, xn, z.shape[0],
                                                     seed=seed)
    return j_approx.binned_energy_topk_approx(
        jnp.asarray(zq), jnp.asarray(qlam), zx, xl, wl, wd, z_s, xn_s, k=k,
        n_items=z.shape[0], z_norms=xn, tile=bt.bins_target(k), lane_split=1,
        block_b=2, interpret=True)


def test_chord_sample_takes_the_jax_rows():
    _, _, z, xlam = _energy_data(3000, 8, 1, seed=2)
    zx, _xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, 3000, seed=5)
    jz, jxn = j_approx.prepare_energy_chord_sample(
        jnp.asarray(zx.numpy()), jnp.asarray(xn.numpy()), 3000, seed=5)
    assert z_s.shape == (ea.SAMPLE_ROWS, 8)
    np.testing.assert_array_equal(z_s.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(xn_s.numpy(), np.asarray(jxn))


@pytest.mark.parametrize("seed,clustered", [(0, False), (1, True)])
def test_chord_surrogate_bounds_the_exact_score(seed, clustered):
    """The port's fitted chords, evaluated as K7 evaluates them, lie on or
    above the float64 energy u for every (query, item) pair."""
    zq, qlam, z, xlam = _energy_data(3000, 24, 8, seed=seed,
                                     clustered=clustered)
    zx, xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, 3000, seed=seed)
    q, ql = _t(zq, qlam)
    qn = (q * q).sum(dim=1)
    ca, cb = ea._fit_chords(q, qn, z_s, xn_s, 0.5)
    sur, _d2 = ea.chord_plane(q, qn, torch.zeros_like(ql), ca, cb,
                              zx[:3000], xn[:3000], torch.zeros(3000), 0.0)
    d = q.double()[:, None, :] - zx[:3000].double()[None, :, :]
    exact = 0.5 / (1.0 + (d * d).sum(-1).sqrt())
    assert bool((sur.double() >= exact).all())


@pytest.mark.parametrize("n,k,clustered", [(3000, 8, False),
                                           (2048, 10, True),
                                           (777, 5, False)])
def test_k7_plain_certified_rows_match_the_oracle(n, k, clustered):
    zq, qlam, z, xlam = _energy_data(n, 24, 6, seed=n, clustered=clustered)
    s, i, fl = _approx(zq, qlam, z, xlam, 1.0, 0.5, k)
    js, ji, jfl = _jax_approx(zq, qlam, z, xlam, 1.0, 0.5, k)
    os_, oi = _oracle(zq, qlam, z, xlam, 1.0, 0.5, k)
    ok = ~fl.numpy()
    assert ok.any(), "no query certified on benign data"
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl) != 0)
    np.testing.assert_array_equal(i.numpy()[ok], oi[ok])
    np.testing.assert_allclose(s.numpy()[ok], os_[ok], atol=5e-5)
    np.testing.assert_array_equal(i.numpy()[ok], np.asarray(ji)[ok])


def test_k7_duplicate_ties_go_to_the_lowest_id():
    rng = np.random.default_rng(11)
    n, g, k = 900, 16, 6
    z = rng.normal(size=(n, g)).astype(np.float32)
    for j in (5, 5 + 256, 5 + 512, 300):
        z[j] = z[5]
    xlam = np.full(n, 0.4, np.float32)
    zq = np.repeat(z[5][None, :], 2, axis=0)
    s, i, fl = _approx(zq, np.array([0.4, 0.4], np.float32), z, xlam, 1.0,
                       0.5, k)
    for b in range(2):
        if not bool(fl[b]):
            assert i[b, :4].tolist() == [5, 261, 300, 517]


def test_k7_flags_when_the_margin_vanishes():
    """Near-identical rows tie every score at the k-th place: the row
    must be flagged, never returned uncertified."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(16,)).astype(np.float32)
    z = (np.tile(base, (600, 1))
         + rng.normal(0, 1e-7, (600, 16))).astype(np.float32)
    _, _, fl = _approx(base[None, :] * 1.01, np.array([0.5], np.float32), z,
                       np.full(600, 0.5, np.float32), 1.0, 0.5, 8)
    assert bool(fl[0])


def test_k7_pool_carries_each_entry_d2():
    """The d² payload of every live pool entry is the d² of its row, as
    the score plane computes it, and empty slots carry 0."""
    zq, qlam, z, xlam = _energy_data(1300, 16, 3, seed=8)
    zx, xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    z_s, xn_s = ea.prepare_energy_chord_sample(zx, xn, 1300)
    q, ql = _t(zq, qlam)
    qn = (q * q).sum(dim=1)
    ca, cb = ea._fit_chords(q, qn, z_s, xn_s, 0.5)
    ps, pi, pd, det = ea.binned_energy_approx_pool(
        q, qn, ql, ca, cb, zx, xn, xl, 1.0, 1300, depth=3, bins=128,
        chunks=2)
    _, d2 = ea.chord_plane(q, qn, ql, ca, cb, zx[:1300], xn[:1300],
                           xl[:1300], 1.0)
    live = pi != INT_MAX
    ids = torch.where(live, pi.long(), torch.zeros_like(pi.long()))
    want = d2.gather(1, ids.reshape(3, -1)).reshape(ids.shape)
    assert torch.equal(pd[live], want[live])
    assert not pd[~live].any()


# ------------------------------------------------------ strided repair


@pytest.mark.parametrize("extra", [1, 2])
def test_strided_energy_repair_restores_exactness(extra):
    """depth+extra same-bin copies of the best row: K6 flags the row, the
    strided repair over its fired bin returns the oracle's top-k (ids
    exact, the copies in id order), as the JAX repair does."""
    rng = np.random.default_rng(13)
    n, g, k = 1100, 16, 8
    depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
    z = (rng.normal(size=(n, g)) * 5.0).astype(np.float32)
    dup = [9 + d * bins for d in range(depth + extra)]
    z[dup] = z[9]
    xlam = np.full(n, 0.5, np.float32)
    zq, qlam = z[9][None, :].copy(), np.array([0.5], np.float32)
    s, i, fl, det = _binned(zq, qlam, z, xlam, 1.0, 0.5, k)
    assert bool(fl[0])
    zx, xl, xn = eb.prepare_binned_energy_corpus(*_t(z, xlam))
    before = br.strided_energy_repair.calls
    rs, ri = br.strided_energy_repair(
        zq, qlam, det.numpy(), s.numpy()[:, k - 1], i.numpy(), zx, xl, xn,
        1.0, 0.5, k=k, n=n)
    assert br.strided_energy_repair.calls == before + 1
    os_, oi = _oracle(zq, qlam, z, xlam, 1.0, 0.5, k)
    np.testing.assert_array_equal(ri, oi)
    np.testing.assert_allclose(rs, os_, atol=1e-6)
    assert ri[0, :len(dup)].tolist() == dup
    js, jsi, _, jdet = _jax_binned(zq, qlam, z, xlam, 1.0, 0.5, k)
    jrs, jri = j_repair.strided_energy_repair(
        zq, qlam, np.asarray(jdet), np.asarray(js)[:, k - 1],
        np.asarray(jsi), jnp.asarray(z), jnp.asarray(xlam), None, 1.0, 0.5,
        k=k, n=n, prepared=False)
    np.testing.assert_array_equal(ri, np.asarray(jri))


def test_engine_repairs_overflowing_rows_through_the_chunked_scan():
    """Copies of a row in more than MAX_FIRED bins overflow the strided
    repair; BinnedEnergyTopK serves that row through the plain chunked
    scan, and every row equals the oracle."""
    rng = np.random.default_rng(21)
    n, g, k = 70_000, 8, 10
    depth, bins = bt.binned_topk_depth_for(k), bt.bins_target(k)
    z = rng.normal(size=(n, g)).astype(np.float32)
    xlam = rng.uniform(0, 1, n).astype(np.float32)
    zq = z[[0, 1, 2]].copy()
    qlam = xlam[[0, 1, 2]].copy()
    for b in range(br.MAX_FIRED + 1):
        for d in range(depth + 1):
            z[b + 11 + bins * (d + 1)] = z[0]
            xlam[b + 11 + bins * (d + 1)] = xlam[0]
    engine = br.BinnedEnergyTopK(*_t(z, xlam), 1.0, 0.5, k)
    s, i = engine(*_t(zq, qlam))
    os_, oi = _oracle(zq, qlam, z, xlam, 1.0, 0.5, k)
    assert engine.flagged_rows >= 1
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(s, os_, atol=1e-6)
