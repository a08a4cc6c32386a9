"""tests/test_energy_comparisons.py (energy search against the standard
pipeline, the reference's test_energy_search.rs:15-600) run in both
packages: each case once as the JAX package runs it (by calling the JAX
test itself, its module fixture built here the same way) and once on
``arrowspace_torch`` on the CPU in float64, on the same rows and seeds.

Every build here projects (JL), and the two packages draw different
Gaussians, so the port's results are held to the case's properties in
the port, not to the JAX package's ranks.  The build-time case keeps
its own bound, max(10× the standard build, 30 s), in each package.

Tolerances: those of the JAX case (ordering, set membership, the 1.5×
λ-proximity slack, the precision and recall bounds)."""

import time

import numpy as np
import pytest
import torch

import test_energy_comparisons as J
from arrowspace_tpu import energymaps as jen
from arrowspace_tpu.energymaps import EnergyParams as JParams
from arrowspace_torch import energymaps as en
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.energymaps import EnergyParams
from data import make_gaussian_hd, make_moons_hd


def _builder():
    return ArrowSpaceBuilder(device="cpu", dtype=torch.float64)


def _energy_builder(seed, rp_eps=0.3):
    return (_builder().with_seed(seed).with_dims_reduction(True, rp_eps)
            .with_inline_sampling(None))


def _std_builder(seed, rp_eps=0.3, eps=1.0, k=3, topk=3):
    return (_builder().with_lambda_graph(eps, k, topk, 2.0, None)
            .with_seed(seed).with_dims_reduction(True, rp_eps)
            .with_inline_sampling(None))


@pytest.fixture(scope="module")
def jax_energy_index():
    rows = make_gaussian_hd(100, spread=0.6, dims=96, seed=3)
    aspace, gl = jen.build_energy(J._energy_builder(12345), rows.tolist(),
                                  JParams())
    return rows, aspace, gl


@pytest.fixture(scope="module")
def energy_index():
    rows = make_gaussian_hd(100, spread=0.6, dims=96, seed=3)
    aspace, gl = en.build_energy(_energy_builder(12345), rows.tolist(),
                                 EnergyParams())
    return rows, aspace, gl


def _ids(res):
    return [i for i, _ in res]


def test_energy_search_basic(jax_energy_index, energy_index):
    J.test_energy_search_basic(jax_energy_index)
    rows, aspace, gl = energy_index
    res = en.search_energy(aspace, rows[0], gl, 5, 1.0, 0.5)
    assert len(res) == 5
    assert res[0][1] > res[4][1]


def test_energy_search_self_retrieval():
    J.test_energy_search_self_retrieval()
    rows = make_moons_hd(80, 0.2, 0.08, 99, 42)
    aspace, gl = en.build_energy(_energy_builder(9999), rows.tolist(),
                                 EnergyParams())
    res = en.search_energy(aspace, rows[10], gl, 1, 1.0, 0.5)
    assert len(res) == 1 and res[0][0] == 10


def test_energy_search_weight_tuning(jax_energy_index, energy_index):
    J.test_energy_search_weight_tuning(jax_energy_index)
    rows, aspace, gl = energy_index
    runs = [en.search_energy(aspace, rows[7], gl, 10, wl, wd)
            for wl, wd in ((1.0, 0.5), (2.0, 0.1), (0.1, 2.0))]
    assert all(len(r) == 10 for r in runs)
    sets = [set(_ids(r)) for r in runs]
    assert sets[0] != sets[1] or sets[0] != sets[2]


def test_energy_search_k_scaling(jax_energy_index, energy_index):
    J.test_energy_search_k_scaling(jax_energy_index)
    rows, aspace, gl = energy_index
    r5, r10, r20 = (en.search_energy(aspace, rows[3], gl, k, 1.0, 0.5)
                    for k in (5, 10, 20))
    assert (len(r5), len(r10), len(r20)) == (5, 10, 20)
    assert _ids(r5) == _ids(r10)[:5] and _ids(r10) == _ids(r20)[:10]


def test_energy_search_optical_compression():
    J.test_energy_search_optical_compression()
    rows = make_gaussian_hd(100, spread=0.6, dims=96, seed=5)
    aspace, gl = en.build_energy(_energy_builder(777), rows.tolist(),
                                 EnergyParams(optical_tokens=32))
    res = en.search_energy(aspace, rows[4], gl, 5, 1.0, 0.5)
    assert len(res) == 5 and all(np.isfinite(s) for _, s in res)


def test_energy_search_lambda_proximity():
    J.test_energy_search_lambda_proximity()
    rows = make_gaussian_hd(80, spread=0.5, dims=96, seed=7)
    aspace, gl = en.build_energy(_energy_builder(333), rows.tolist(),
                                 EnergyParams())
    res = en.search_energy(aspace, rows[0], gl, 10, 1.0, 0.0)
    assert len(res) == 10
    q_lambda = aspace.prepare_query_item(rows[0], gl)
    lam = np.asarray(aspace.lambdas)
    assert abs(q_lambda - lam[res[0][0]]) <= \
        abs(q_lambda - lam[res[9][0]]) * 1.5 + 1e-12


def test_energy_search_score_monotonicity():
    J.test_energy_search_score_monotonicity()
    rows = make_moons_hd(50, 0.2, 0.1, 99, 42)
    aspace, gl = en.build_energy(_energy_builder(444), rows.tolist(),
                                 EnergyParams())
    scores = [s for _, s in en.search_energy(aspace, rows[5], gl, 20, 1.0,
                                             0.5)]
    assert scores == sorted(scores, reverse=True)


def test_energy_search_empty_k(jax_energy_index, energy_index):
    J.test_energy_search_empty_k(jax_energy_index)
    rows, aspace, gl = energy_index
    assert en.search_energy(aspace, rows[0], gl, 0, 1.0, 0.5) == []


def test_energy_search_high_dimensional():
    J.test_energy_search_high_dimensional()
    rows = make_gaussian_hd(40, spread=0.5, dims=96, seed=9)
    aspace, gl = en.build_energy(_energy_builder(666, rp_eps=0.4),
                                 rows.tolist(), EnergyParams())
    res = en.search_energy(aspace, rows[2], gl, 8, 1.0, 0.5)
    assert len(res) == 8 and all(np.isfinite(s) for _, s in res)


def _std_search(rows, builder, query, k):
    aspace, gl = builder.build(rows.tolist())
    qlam = aspace.prepare_query_item(query, gl)
    return aspace.search_lambda_aware(ArrowItem(query, qlam), k, 0.7)


def test_energy_vs_standard_search_overlap():
    J.test_energy_vs_standard_search_overlap()
    rows = make_gaussian_hd(100, spread=0.6, dims=96, seed=11)
    res_std = _std_search(rows, _std_builder(12345), rows[5], 10)
    aspace_en, gl_en = en.build_energy(_energy_builder(12345),
                                       rows.tolist(), EnergyParams())
    res_en = en.search_energy(aspace_en, rows[5], gl_en, 10, 1.0, 0.5)
    assert len(set(_ids(res_std)) & set(_ids(res_en))) < 10


def test_energy_vs_standard_lambda_distribution():
    J.test_energy_vs_standard_lambda_distribution()
    rows = make_moons_hd(80, 0.2, 0.08, 99, 42)
    ls = np.asarray(_std_builder(9999).build(rows.tolist())[0].lambdas)
    le = np.asarray(en.build_energy(_energy_builder(9999), rows.tolist(),
                                    EnergyParams())[0].lambdas)
    for lam in (ls, le):
        assert np.all(np.isfinite(lam)) and np.all(lam >= 0.0)
    assert le.std() > 0.0
    assert abs(ls.mean() - le.mean()) > 1e-9


def test_energy_vs_standard_graph_structure():
    J.test_energy_vs_standard_graph_structure()
    rows = make_moons_hd(80, 0.2, 0.08, 99, 42)
    _, gl_std = _std_builder(31).build(rows.tolist())
    _, gl_en = en.build_energy(_energy_builder(31), rows.tolist(),
                               EnergyParams())
    n_std, n_en = gl_std.shape()[0], gl_en.shape()[0]
    assert n_std < 99
    assert gl_en.shape() == (n_en, n_en)
    assert gl_en.nnodes == n_en
    assert n_en != n_std


def test_energy_vs_standard_precision_at_k():
    J.test_energy_vs_standard_precision_at_k()
    rows = make_moons_hd(100, 0.3, 0.08, 99, 42)
    k, query = 10, rows[10]
    gt = set(np.argsort(np.linalg.norm(rows - query[None, :],
                                       axis=1))[:k].tolist())
    res_std = _std_search(rows, _std_builder(111, eps=0.2, k=2, topk=1),
                          query, k)
    aspace_en, gl_en = en.build_energy(_energy_builder(111), rows.tolist(),
                                       EnergyParams())
    res_en = en.search_energy(aspace_en, query, gl_en, k, 1.0, 0.5)
    prec_std = len(gt & set(_ids(res_std))) / k
    prec_en = len(gt & set(_ids(res_en))) / k
    assert prec_std > k / len(rows)
    assert prec_en >= 0.0
    assert prec_std >= prec_en * 0.5


def test_energy_vs_standard_recall_at_k():
    J.test_energy_vs_standard_recall_at_k()
    rows = make_gaussian_hd(80, spread=0.5, dims=96, seed=13)
    k, query = 20, rows[0]
    std_ids = set(_ids(_std_search(rows, _std_builder(333), query, k)))
    aspace_en, gl_en = en.build_energy(
        _energy_builder(333).with_lambda_graph(1.0, 3, 3, 2.0, None),
        rows.tolist(), EnergyParams())
    recall = [sum(i in std_ids for i in _ids(
        en.search_energy(aspace_en, query, gl_en, k, wl, wd))) / k
        for wl, wd in ((1.0, 0.5), (2.0, 0.1))]
    assert all(0.0 <= r <= 1.0 for r in recall)
    assert min(recall) < 1.0


def test_energy_vs_standard_build_time():
    J.test_energy_vs_standard_build_time()
    rows = make_moons_hd(100, 0.3, 0.08, 99, 42)
    t0 = time.perf_counter()
    _std_builder(444).build(rows.tolist())
    t_std = time.perf_counter() - t0
    t0 = time.perf_counter()
    en.build_energy(_energy_builder(444), rows.tolist(), EnergyParams())
    t_energy = time.perf_counter() - t0
    assert t_energy < max(t_std * 10.0, 30.0)


def test_energy_no_cosine_dependence():
    J.test_energy_no_cosine_dependence()
    rows = make_gaussian_hd(50, spread=0.6, dims=96, seed=15)
    query = rows[5]
    aspace, gl = en.build_energy(_energy_builder(555), rows.tolist(),
                                 EnergyParams())
    res = en.search_energy(aspace, query, gl, 10, 1.0, 0.0)
    qn = max(np.linalg.norm(query), 1e-9)
    cosines = [float(query @ rows[i] / (qn * max(np.linalg.norm(rows[i]),
                                                  1e-9))) for i in _ids(res)]
    assert cosines != sorted(cosines, reverse=True)
