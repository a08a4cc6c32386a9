"""The cases of tests/test_energy.py (mirroring the reference's
tests/test_energy_builder.rs and test_energy_search.rs) that no port
test pinned, in both packages: each case once as the JAX package runs it
(by calling the JAX test itself) and once on ``arrowspace_torch.energymaps``
on the CPU in float64, on the same rows and seeds.  The energy builds
project (JL), and the two packages draw different Gaussians, so a build's
results are held to the case's properties in each package; the scorer
cases, which take no build, are held to the JAX package's results too.

The file's other cases map in tests/test_torch_parity_map.py to
tests/test_torch_energy.py and tests/test_torch_leftovers.py, which hold
the same functions to the JAX package on the same inputs.

Tolerances: the JAX case's own; the chunked scorer against the in-memory
one within 1e-9 relative (1e-12 absolute), and against the JAX chunked
scorer within 1e-12; batch against single-query scores within 1e-9
relative (the binned engine's plain version: 1e-7)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_energy as J
from arrowspace_tpu.energymaps import _energy_score_topk_chunked as j_chunked
from arrowspace_torch import energymaps as en
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.energymaps import EnergyParams
from arrowspace_torch.ops import bin_repair as br
from arrowspace_torch.ops.energy_bintopk import energy_topk_chunked
from arrowspace_torch.taumode import (TauMode, select_tau_batch,
                                      synthetic_lambda_batch)
from data import make_gaussian_hd, make_moons_hd
from helpers import cosine_topk


def _plain_builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def _builder(seed=42):
    return (_plain_builder().with_lambda_graph(1.0, 5, 3, 2.0, None)
            .with_dims_reduction(True, 1.0).with_seed(seed))


def test_energy_vs_standard_overlap():
    J.test_energy_vs_standard_overlap()
    rows = make_gaussian_hd(90, spread=0.4, dims=96, seed=6)
    q = rows[11] * 1.02
    aspace_s, gl_s = _builder(seed=33).build(rows.tolist())
    qlam = aspace_s.prepare_query_item(q, gl_s)
    std = {i for i, _ in
           aspace_s.search_lambda_aware(ArrowItem(q, qlam), 10, 1.0)}
    aspace_e, gl_e = en.build_energy(_builder(seed=33), rows.tolist(),
                                     EnergyParams())
    eres = {i for i, _ in en.search_energy(aspace_e, q, gl_e, 10, 1.0, 0.5)}
    cos_ids, _ = cosine_topk(q, rows, 10)
    assert 0.0 <= len(eres & set(cos_ids)) / 10.0
    assert len(eres) == 10 and len(std) == 10


def _batch_vs_single(aspace, gl, queries, rel):
    scores, ids = en.search_energy_batch(aspace, queries, gl, 8, 1.0, 0.5)
    assert scores.shape == (len(queries), 8)
    for i, q in enumerate(queries):
        single = en.search_energy(aspace, q, gl, 8, 1.0, 0.5)
        assert [j for j, _ in single] == list(ids[i])
        for (_j, s), s2 in zip(single, scores[i]):
            assert s == pytest.approx(float(s2), rel=rel)


def test_search_energy_batch_matches_single():
    J.test_search_energy_batch_matches_single()
    rows = make_gaussian_hd(80, spread=0.5, dims=96, seed=8)
    aspace, gl = en.build_energy(_builder(seed=13), rows.tolist(),
                                 EnergyParams())
    _batch_vs_single(aspace, gl, rows[:3] * 1.01, 1e-9)


def test_search_energy_batch_streams_large_corpus(monkeypatch):
    """With ENERGY_CHUNK lowered below the corpus and the binned gate
    shut, the batch takes the chunked scan."""
    J.test_search_energy_batch_streams_large_corpus(monkeypatch)
    monkeypatch.undo()
    rows = make_gaussian_hd(90, spread=0.5, dims=96, seed=8)
    aspace, gl = en.build_energy(_builder(seed=13), rows.tolist(),
                                 EnergyParams())
    monkeypatch.setattr(en, "ENERGY_CHUNK", 32)
    monkeypatch.setattr(en, "energy_binned_fits", lambda *a: False)
    calls = []
    inner = en.energy_topk_chunked
    monkeypatch.setattr(en, "energy_topk_chunked",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    _batch_vs_single(aspace, gl, rows[:3] * 1.01, 1e-7)
    assert calls == [1]


def test_search_energy_batch_binned_dispatch(monkeypatch):
    """With ENERGY_CHUNK lowered below the corpus the port's size gate
    routes the batch to the binned engine (K6's plain version here, with
    its repair), which agrees with the single-query ranking."""
    J.test_search_energy_batch_binned_dispatch(monkeypatch)
    monkeypatch.undo()
    rows = make_gaussian_hd(120, spread=0.5, dims=96, seed=21)
    aspace, gl = en.build_energy(_builder(seed=5), rows.tolist(),
                                 EnergyParams())
    monkeypatch.setattr(en, "ENERGY_CHUNK", 32)
    calls = []
    inner = br.binned_energy_topk
    monkeypatch.setattr(br, "binned_energy_topk",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    _batch_vs_single(aspace, gl, rows[:3] * 1.01, 1e-7)
    assert calls, "the gate must dispatch the binned engine"


def test_tall_graph_lift_behind_flag():
    J.test_tall_graph_lift_behind_flag()
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (40, 16))
    rows = centers[rng.integers(0, 40, 800)] + rng.normal(0, 0.02, (800, 16))
    b = (_plain_builder().with_seed(7).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    aspace, gl = en.build_energy(
        b, rows.tolist(), EnergyParams(split_quantile=0.2,
                                       allow_tall_graphs=True))
    n_nodes = gl.shape()[0]
    assert n_nodes > aspace.nfeatures
    lam = np.asarray(aspace.lambdas)
    assert np.all(np.isfinite(lam)) and np.all(lam >= 0.0) and lam.std() > 0
    qlam = aspace.prepare_query_item(rows[3], gl)
    assert np.isfinite(qlam) and qlam != 0.0
    assert en.search_energy(aspace, rows[3], gl, 5, 1.0, 0.5)[0][0] == 3
    x = torch.from_numpy(rows[:32])
    lapd = torch.as_tensor(np.asarray(gl.matrix), dtype=torch.float64)
    taus = select_tau_batch(x, TauMode.median())
    lam_pad = synthetic_lambda_batch(x, lapd, taus, pad_items=True)
    x_ext = torch.nn.functional.pad(x, (0, n_nodes - 16))
    lam_ext = synthetic_lambda_batch(x_ext, lapd, taus)
    np.testing.assert_allclose(lam_pad.numpy(), lam_ext.numpy(), rtol=1e-12)


def test_energy_build_taumode_consistency():
    J.test_energy_build_taumode_consistency()
    rows = make_moons_hd(50, 0.2, 0.08, 99, 42)
    b = (_plain_builder().with_synthesis(TauMode.mean()).with_seed(111)
         .with_dims_reduction(True, 0.3).with_inline_sampling(None))
    aspace, _ = en.build_energy(b, rows.tolist(), EnergyParams())
    assert aspace.taumode == TauMode.mean()
    lam = np.asarray(aspace.lambdas)
    assert lam.shape[0] == aspace.nitems
    assert np.all(np.isfinite(lam)) and np.all(lam >= 0.0)


def test_energy_build_custom_params():
    J.test_energy_build_custom_params()
    rows = make_gaussian_hd(40, spread=0.1, dims=96, seed=6)
    p = EnergyParams(optical_tokens=None, trim_quantile=0.05, eta=0.15,
                     steps=2, split_quantile=0.95, neighbor_k=10,
                     split_tau=0.1, w_lambda=1.5, w_disp=0.3,
                     w_dirichlet=0.15, candidate_m=20)
    b = (_plain_builder().with_seed(333).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    lambda_k = b.lambda_k
    aspace, gl = en.build_energy(b, rows.tolist(), p)
    assert gl.graph_params.k == lambda_k
    assert not gl.graph_params.normalise
    assert np.any(np.asarray(aspace.lambdas) > 0.0)


def test_energy_build_lambda_statistics():
    J.test_energy_build_lambda_statistics()
    rows = make_moons_hd(100, 0.2, 0.1, 99, 42)
    b = (_plain_builder().with_seed(444).with_dims_reduction(True, 0.3)
         .with_inline_sampling(None))
    lam = np.asarray(en.build_energy(b, rows.tolist(),
                                     EnergyParams())[0].lambdas)
    assert lam.min() >= 0.0 and lam.max() > lam.min()
    assert np.isfinite(lam.mean()) and lam.mean() > 0.0


def test_energy_chunked_matches_in_memory():
    J.test_energy_chunked_matches_in_memory()
    rng = np.random.default_rng(23)
    n, f, b, k, g = 700, 24, 5, 9, 24
    items = torch.from_numpy(rng.normal(size=(n, f)))
    lam = torch.from_numpy(rng.uniform(0, 1, n))
    q = torch.from_numpy(rng.normal(size=(b, f)))
    qlam = torch.from_numpy(rng.uniform(0, 1, b))
    sig = torch.from_numpy(rng.normal(size=(g, f)) * 0.3)
    for use_signals in (True, False):
        s_mem, i_mem = en._energy_score_topk(
            q, qlam, items, lam, 1.0, 0.5, k=k,
            signals=sig if use_signals else None)
        z_items = items @ sig.T if use_signals else items
        z_q = q @ sig.T if use_signals else q
        s_ch, i_ch = energy_topk_chunked(z_q, qlam, z_items, lam, 1.0, 0.5,
                                         k=k, chunk=256)
        assert torch.equal(i_ch, i_mem)
        np.testing.assert_allclose(s_ch.numpy(), s_mem.numpy(), rtol=1e-9,
                                   atol=1e-12)
        js, ji = j_chunked(jnp.asarray(z_q.numpy()), jnp.asarray(qlam.numpy()),
                           jnp.asarray(z_items.numpy()),
                           jnp.asarray(lam.numpy()), jnp.asarray(1.0),
                           jnp.asarray(0.5), k=k, chunk=256)
        np.testing.assert_array_equal(i_ch.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s_ch.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-12)


def test_energy_chunked_tie_order_lowest_index():
    J.test_energy_chunked_tie_order_lowest_index()
    rng = np.random.default_rng(3)
    n, f, k = 600, 8, 6
    items = np.asarray(rng.normal(size=(n, f)))
    for j in (5, 150, 300, 450, 599):
        items[j] = items[5]
    _s, i = energy_topk_chunked(
        torch.from_numpy(items[5][None, :]), torch.tensor([0.4]),
        torch.from_numpy(items), torch.full((n,), 0.4, dtype=torch.float64),
        1.0, 0.5, k=k, chunk=128)
    assert i[0, :5].tolist() == [5, 150, 300, 450, 599]
