"""tests/test_energy_approx.py run in both packages: each case once as
the JAX package runs it (K7 in interpret mode, by calling the JAX test
itself) and once on ``arrowspace_torch`` on the CPU, where K7 and K6
take their plain versions, on the same numpy inputs made from the case's
own seeds.  The port side is held to its own chunked scan and to the
JAX package's chunked oracle (_energy_score_topk_chunked).

The JAX case pins a test-sized Pallas tile and query block; the port's
engine picks its bins from k.  Its chord sample is the same rows (one
numpy draw in both packages).  The JAX rejection of an unprepared
corpus has its counterpart in the port's engine, which refuses approx
without a resident prepared plane.

Tolerances: certified rows' ids exact; scores within the JAX case's atol
(5e-5 where d² cancels for near duplicates, 1e-6 elsewhere) against the
port's chunked scan and within 5e-5 against the JAX oracle; the chord
sample rows bitwise the JAX package's (the coefficients are not compared:
a slope over the smallest sampled d², about 1e-3, carries float32
rounding up to 5e-4 relative, and each package's surrogate is held to
dominate the exact score instead); the approx session's ids equal the
exact session's, scores within 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_energy_approx as J
from arrowspace_tpu.energymaps import _energy_score_topk_chunked
from arrowspace_tpu.ops.energy_approx import \
    prepare_energy_chord_sample as j_sample
from arrowspace_torch import energymaps
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.energymaps import EnergyParams, build_energy
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops import energy_approx as ea
from arrowspace_torch.ops import energy_bintopk as eb
from suite_draws import APPROX_CASES, approx_data as _data


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _prepared(z, lam):
    return eb.prepare_binned_energy_corpus(*_t(z, lam))


def _run_approx(zq, qlam, z, lam, wl, wd, k, seed=0):
    zx, xlam, xn = _prepared(z, lam)
    n = z.shape[0]
    z_samp, xn_samp = ea.prepare_energy_chord_sample(zx, xn, n, seed=seed)
    dt = zx.dtype
    s, i, fl = ea.binned_energy_topk_approx(
        *_t(zq, qlam), zx, xlam, xn, z_samp, xn_samp,
        eb.dtype_scalar(wl, dt), eb.dtype_scalar(wd, dt), k=k, n=n)
    return s.numpy(), i.numpy(), fl.numpy()


def _scans(zq, qlam, z, lam, wl, wd, k):
    dt = torch.float32
    ps, pi = eb.energy_topk_chunked(*_t(zq, qlam, z, lam),
                                    eb.dtype_scalar(wl, dt),
                                    eb.dtype_scalar(wd, dt), k=k, chunk=512)
    js, ji = _energy_score_topk_chunked(
        jnp.asarray(zq), jnp.asarray(qlam), jnp.asarray(z), jnp.asarray(lam),
        jnp.float32(wl), jnp.float32(wd), k=k, chunk=512)
    return ps.numpy(), pi.numpy(), np.asarray(js), np.asarray(ji)


def _certified_exact(s, i, fl, args, wl, wd, k, atol):
    ps, pi, js, ji = _scans(*args, wl, wd, k)
    for b in np.nonzero(~fl)[0]:
        np.testing.assert_array_equal(i[b], pi[b])
        np.testing.assert_array_equal(i[b], ji[b])
        np.testing.assert_allclose(s[b], ps[b], atol=atol)
        np.testing.assert_allclose(s[b], js[b], atol=max(atol, 5e-5))
    return pi


def test_chord_surrogate_dominates_exact_everywhere():
    J.test_chord_surrogate_dominates_exact_everywhere()
    for seed, clustered in ((0, False), (1, True)):
        zq, qlam, z, lam = _data(3000, 24, 8, seed=seed, clustered=clustered)
        zx, _xlam, xn = _prepared(z, lam)
        z_samp, xn_samp = ea.prepare_energy_chord_sample(zx, xn, 3000,
                                                         seed=seed)
        zqt = torch.from_numpy(zq)
        qn = (zqt * zqt).sum(dim=1)
        wd = eb.dtype_scalar(0.5, torch.float32)
        ca, cb = [t.numpy() for t in ea._fit_chords(zqt, qn, z_samp,
                                                    xn_samp, wd)]
        # the same sample rows as the JAX package's
        jzx = jnp.asarray(zx.numpy())
        jsamp, _jxn = j_sample(jzx, jnp.sum(jzx * jzx, axis=1), 3000,
                               seed=seed)
        np.testing.assert_array_equal(np.asarray(jsamp), z_samp.numpy())
        xnh = (z * z).sum(axis=1, dtype=np.float32)
        qnh = qn.numpy()
        for b in range(8):
            d2f = ((np.float32(qnh[b]) + xnh)
                   - np.float32(2.0) * (z @ zq[b])).astype(np.float32)
            sur = np.maximum(ca[b, 0] * d2f + cb[b, 0],
                             ca[b, 1] * np.minimum(d2f, cb[b, 2]) + cb[b, 1])
            d2 = np.float64(qnh[b]) + xnh.astype(np.float64) \
                - 2.0 * (z.astype(np.float64) @ zq[b].astype(np.float64))
            exact = 0.5 / (1.0 + np.sqrt(np.maximum(d2, 0.0)))
            assert (sur >= exact).all(), (seed, b,
                                          float((exact - sur).max()))


@pytest.mark.parametrize("n,k,clustered", APPROX_CASES)
def test_approx_certified_rows_match_chunked_oracle(n, k, clustered):
    J.test_approx_certified_rows_match_chunked_oracle(n, k, clustered)
    args = _data(n, 24, 6, seed=n, clustered=clustered)
    s, i, fl = _run_approx(*args, 1.0, 0.5, k)
    assert fl.shape == (6,)
    assert (~fl).sum() >= 1, "no query certified on benign data"
    _certified_exact(s, i, fl, args, 1.0, 0.5, k, 5e-5)


def test_approx_block_padding_and_chunking():
    J.test_approx_block_padding_and_chunking()
    args = _data(900, 16, 5, seed=7)
    s, i, fl = _run_approx(*args, 0.7, 1.3, 6)
    assert fl.shape == (5,)
    _certified_exact(s, i, fl, args, 0.7, 1.3, 6, 1e-6)


def test_approx_duplicate_tie_order():
    J.test_approx_duplicate_tie_order()
    rng = np.random.default_rng(11)
    n, g, k = 900, 16, 6
    z = rng.normal(size=(n, g))
    for j in (5, 5 + 256, 5 + 512, 300):
        z[j] = z[5]
    z = z.astype(np.float32)
    zq = z[5][None, :].repeat(2, axis=0)
    args = (zq, np.asarray([0.4, 0.4], np.float32), z,
            np.full(n, 0.4, np.float32))
    s, i, fl = _run_approx(*args, 1.0, 0.5, k)
    _certified_exact(s, i, fl, args, 1.0, 0.5, k, 1e-6)
    for b in np.nonzero(~fl)[0]:
        assert list(i[b][:4]) == [5, 261, 517, 300]


def test_approx_flags_when_margin_vanishes():
    J.test_approx_flags_when_margin_vanishes()
    rng = np.random.default_rng(3)
    base = rng.normal(size=(16,)).astype(np.float32)
    z = np.tile(base, (600, 1)) + rng.normal(0, 1e-7, (600, 16)) \
        .astype(np.float32)
    z = z.astype(np.float32)
    _s, _i, fl = _run_approx(base[None, :] * np.float32(1.01),
                             np.asarray([0.5], np.float32), z,
                             np.full(600, 0.5, np.float32), 1.0, 0.5, 8)
    assert fl[0]


def test_approx_rejects_unprepared():
    J.test_approx_rejects_unprepared()
    _zq, _ql, z, lam = _data(500, 16, 2, seed=9)
    with pytest.raises(ValueError, match="prepared"):
        br.BinnedEnergyTopK(*_t(z, lam), 1.0, 0.5, 5, approx=True,
                            prepare_corpus=False)


def _energy_index(seed, rows):
    b = (ArrowSpaceBuilder(device="cpu", dtype=torch.float32).with_seed(seed)
         .with_dims_reduction(True, 0.3).with_inline_sampling(None))
    aspace, gl = build_energy(
        b, rows.tolist(),
        EnergyParams(split_quantile=0.2, allow_tall_graphs=True))
    return ArrowIndex(aspace, gl, b)


def test_energy_session_approx_matches_exact_session(monkeypatch):
    """The port's float32 index on the binned engine (its gate lowered
    below 800 rows): the approx session, with one row forced uncertified
    so its K6 fallback runs, returns what the exact session returns."""
    J.test_energy_session_approx_matches_exact_session(monkeypatch)
    monkeypatch.undo()
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] \
        + rng.normal(0, 0.02, (800, 16))
    idx = _energy_index(7, rows)
    monkeypatch.setattr(energymaps, "ENERGY_CHUNK", 512)
    orig = br.binned_energy_topk_approx
    seen = {"flags": []}

    def one_uncertified(*a, **kw):
        s, i, fl = orig(*a, **kw)
        fl = fl.clone()
        fl[0] = True
        seen["flags"].append(fl)
        return s, i, fl

    monkeypatch.setattr(br, "binned_energy_topk_approx", one_uncertified)
    queries = (rows[rng.integers(0, 800, 8)] * 1.01).astype(np.float32)
    exact = idx.make_energy_session(batch_size=8, k=5)
    assert exact.kernel == "binned"
    (se, ie), = list(exact.search_stream([queries]))
    approx = idx.make_energy_session(batch_size=8, k=5, approx=True)
    assert approx.kernel == "binned_approx"
    (sa, ia), = list(approx.search_stream([queries]))
    np.testing.assert_array_equal(ia, ie)
    np.testing.assert_allclose(sa, se, atol=1e-6)
    assert seen["flags"], "approx kernel was not dispatched"
    assert approx.engine.flagged_rows >= 1


def test_energy_session_approx_requires_binned_path():
    J.test_energy_session_approx_requires_binned_path()
    rng = np.random.default_rng(6)
    idx = _energy_index(3, rng.uniform(0, 1, (300, 16)))
    with pytest.raises(ValueError, match="approx"):
        idx.make_energy_session(batch_size=4, k=5, approx=True)
