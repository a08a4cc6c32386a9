"""The rest of arrowspace_torch's builder (typed configuration, display,
with_spectral, with_sparsity_check) and the signals graph, against the
JAX package in float64 on the CPU.

The signals graph is the Laplacian of the feature graph's Laplacian
(GraphFactory.build_spectral_laplacian); where it is attached, item λ
(the build, the one-row refresh, recompute_lambdas) and the energy
scores read it in both packages, and query λ reads the feature graph.

Tolerances: the graphs and λ within rtol 1e-12 (float64; products summed
in another order), energy ids exact and scores within 1e-12.  Inputs are
made with numpy from fixed seeds and fed to both packages."""

import json
import logging

import numpy as np
import pytest
import torch

from arrowspace_tpu import eigenmaps as jem
from arrowspace_tpu import energymaps as jen
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_tpu.builder import ConfigValue as JConfigValue
from arrowspace_tpu.builder import PairingStrategy as JPairingStrategy
from arrowspace_tpu.core import ArrowItem as JItem
from arrowspace_tpu.energymaps import EnergyParams as JEnergyParams
from arrowspace_tpu.graph import GraphFactory as JGraphFactory
from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.sampling import SamplerType as JSampler
from arrowspace_tpu.taumode import TauMode as JTauMode
from arrowspace_torch import eigenmaps as tem
from arrowspace_torch import energymaps as ten
from arrowspace_torch.builder import (ArrowSpaceBuilder, ConfigValue,
                                      PairingStrategy)
from arrowspace_torch.convert import from_jax_state
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.energymaps import EnergyParams
from arrowspace_torch.index import ArrowIndex
from arrowspace_torch.sampling import SamplerType
from arrowspace_torch.taumode import TauMode
from data import make_moons_hd

CPU64 = dict(device="cpu", dtype=torch.float64)


def _tb():
    return ArrowSpaceBuilder(**CPU64)


def _configure(b, sampler, mode):
    """The same non-default settings on a builder of either package."""
    return (b.with_lambda_graph(0.5, 8, 4, 3.0, 0.25)
            .with_synthesis(mode)
            .with_normalisation(True)
            .with_sparsity_check(True)
            .with_inline_sampling(sampler)
            .with_dims_reduction(True, 0.4)
            .with_seed(11))


CONFIGS = {
    "default": lambda jb, tb: (jb, tb),
    "configured": lambda jb, tb: (
        _configure(jb, JSampler.simple(0.8), JTauMode.percentile(0.75)),
        _configure(tb, SamplerType.simple(0.8), TauMode.percentile(0.75))),
    "fixed_unsampled": lambda jb, tb: (
        _configure(jb, None, JTauMode.fixed(0.3)).with_spectral(True),
        _configure(tb, None, TauMode.fixed(0.3)).with_spectral(True)),
    "mean_persisted": lambda jb, tb: (
        jb.with_synthesis(JTauMode.mean()).with_persistence("/x/y", "n"),
        tb.with_synthesis(TauMode.mean()).with_persistence("/x/y", "n")),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_typed_config_and_display_match_jax(name):
    jb, tb = CONFIGS[name](JBuilder(), _tb())
    jcfg, tcfg = jb.builder_config_typed(), tb.builder_config_typed()
    assert list(tcfg) == list(jcfg)
    for key in jcfg:
        assert tcfg[key].kind == jcfg[key].kind, key
        assert tcfg[key].to_json() == jcfg[key].to_json(), key
        assert str(tcfg[key]) == str(jcfg[key]), key
    assert str(tb) == str(jb)
    # the metadata JSON of both packages is the same text
    assert json.dumps({k: v.to_json() for k, v in tcfg.items()}) == \
        json.dumps({k: v.to_json() for k, v in jcfg.items()})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_value_json_roundtrip_across_packages(name):
    """Every typed value survives to_json/from_json in the port, and a
    value written by either package reads back equal in the other."""
    jb, tb = CONFIGS[name](JBuilder(), _tb())
    jcfg, tcfg = jb.builder_config_typed(), tb.builder_config_typed()
    for key, val in tcfg.items():
        assert ConfigValue.from_json(val.to_json()) == val, key
        back_j = JConfigValue.from_json(val.to_json())
        assert back_j.to_json() == jcfg[key].to_json(), key
        back_t = ConfigValue.from_json(jcfg[key].to_json())
        assert back_t == val, key


def test_config_value_accessors_and_display():
    for kind, value in [("Bool", True), ("Usize", 7), ("F64", 0.5),
                        ("F64", 2.0), ("OptionF64", None),
                        ("OptionU64", 11), ("String", "x")]:
        t, j = ConfigValue(kind, value), JConfigValue(kind, value)
        assert str(t) == str(j) and repr(t) == repr(j)
        for acc in ("as_bool", "as_usize", "as_f64", "as_tau_mode",
                    "as_sampler_type"):
            assert getattr(t, acc)() == getattr(j, acc)()
    assert str(ConfigValue("TauMode", TauMode.percentile(0.9))) == \
        str(JConfigValue("TauMode", JTauMode.percentile(0.9)))
    assert ConfigValue("Bool", True) != ConfigValue("Usize", True)


def test_new_pairing_strategy_and_defaults():
    b = ArrowSpaceBuilder.new(**CPU64)
    assert isinstance(b, ArrowSpaceBuilder)
    assert b.device == torch.device("cpu") and b.dtype == torch.float64
    jb = JBuilder.new()
    for name in ("prebuilt_spectral", "lambda_eps", "lambda_k",
                 "lambda_topk", "lambda_p", "lambda_sigma", "normalise",
                 "sparsity_check", "cluster_max_clusters", "cluster_radius",
                 "clustering_seed", "deterministic_clustering",
                 "use_dims_reduction", "rp_eps", "persistence"):
        assert getattr(b, name) == getattr(jb, name), name
    assert (PairingStrategy.FAST_PAIR, PairingStrategy.DEFAULT,
            PairingStrategy.cover_tree_knn(5)) == \
        (JPairingStrategy.FAST_PAIR, JPairingStrategy.DEFAULT,
         JPairingStrategy.cover_tree_knn(5))
    # the port's own state stays out of the typed configuration
    assert not {"device", "dtype", "stage_seconds", "clustering_seconds"} \
        & set(b.builder_config_typed())


def test_with_spectral_warns_and_sets_the_flag():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("arrowspace.builder")
    log.addHandler(handler)
    try:
        b = _tb().with_spectral(True)
    finally:
        log.removeHandler(handler)
    assert b.prebuilt_spectral is True
    assert any("experimental" in r.getMessage() for r in records)
    assert _tb().with_spectral(True).with_spectral(False) \
        .prebuilt_spectral is False


def test_with_sparsity_check_raises_like_jax():
    """A graph without an edge (ε far below every distance) over 24
    features stores its diagonal alone, 1/24 of the matrix: too sparse
    for the check in both packages, and it passes without the check."""
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=24, seed=5)
    with pytest.raises(ValueError, match="too sparse"):
        JBuilder().with_lambda_graph(1e-9, 5, 3, 2.0, None) \
            .with_sparsity_check(True).with_seed(9).build(rows.tolist())
    with pytest.raises(ValueError, match="too sparse"):
        _tb().with_lambda_graph(1e-9, 5, 3, 2.0, None) \
            .with_sparsity_check(True).with_seed(9).build(rows)
    aspace, _ = _tb().with_lambda_graph(1e-9, 5, 3, 2.0, None) \
        .with_sparsity_check(False).with_seed(9).build(rows)
    assert aspace.nitems == 60


def _spectral_pair(dims=12, seed=5, build_seed=9, n=60):
    rows = make_moons_hd(n, noise=0.1, hd_noise=0.05, dims=dims, seed=seed)
    ja, jg = JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_spectral(True).with_seed(build_seed).build(rows.tolist())
    ta, tg = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_spectral(True).with_seed(build_seed).build(rows)
    return rows, (ja, jg), (ta, tg)


def test_spectral_build_matches_jax():
    """tests/test_builder.py:103-110 on both packages: the signals graph
    is F×F and equals the JAX package's, and λ against it too."""
    _rows, (ja, jg), (ta, tg) = _spectral_pair()
    assert tuple(ta.signals.shape) == (12, 12)
    assert ta.signals.device.type == "cpu"
    assert ta.signals.dtype == torch.float64
    np.testing.assert_allclose(tg.matrix.numpy(), np.asarray(jg.matrix),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ta.signals.numpy(), np.asarray(ja.signals),
                               rtol=1e-12, atol=1e-14)
    assert ta._signals_nnz == ja._signals_nnz
    np.testing.assert_allclose(ta.lambdas.numpy(), np.asarray(ja.lambdas),
                               rtol=1e-12, atol=1e-14)


def test_build_spectral_laplacian_matches_jax_factory():
    """GraphFactory.build_spectral_laplacian of the port on the JAX
    package's feature graph, against the JAX factory on the same graph."""
    from arrowspace_torch.graph import GraphFactory, GraphLaplacian
    rows = make_moons_hd(70, noise=0.1, hd_noise=0.05, dims=10, seed=6)
    ja, jg = JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_seed(31).build(rows.tolist())
    JGraphFactory.build_spectral_laplacian(ja, jg)
    t = from_jax_state(rows, np.asarray(ja.lambdas), np.asarray(jg.matrix),
                       ja.taumode, **CPU64)
    gl = GraphLaplacian(init_data=t.gl.init_data, matrix=t.gl.matrix,
                        nnodes=t.gl.nnodes, graph_params=_tparams(jg),
                        structural_nnz=t.gl.structural_nnz)
    GraphFactory.build_spectral_laplacian(t.aspace, gl)
    np.testing.assert_allclose(t.aspace.signals.numpy(),
                               np.asarray(ja.signals), rtol=1e-12,
                               atol=1e-14)
    assert t.aspace._signals_nnz == ja._signals_nnz


def _tparams(jg):
    from arrowspace_torch.graph import GraphParams
    p = jg.graph_params
    return GraphParams(eps=p.eps, k=p.k, topk=p.topk, p=p.p, sigma=p.sigma,
                       normalise=p.normalise, sparsity_check=p.sparsity_check)


def test_compute_taumode_uses_signals_when_present():
    """tests/test_eigenmaps.py:82-93: the signals graph takes precedence
    over the feature graph, so λ differs from a build without it."""
    rows = make_moons_hd(60, noise=0.1, hd_noise=0.05, dims=12, seed=9)
    a1, _ = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(77) \
        .with_spectral(True).build(rows)
    a2, _ = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None).with_seed(77) \
        .build(rows)
    assert a1.signals is not None and a1.signals.shape[0] > 0
    assert a2.signals is None
    assert not np.allclose(a1.lambdas.numpy(), a2.lambdas.numpy())


def test_staged_equals_monolithic_with_spectral():
    """tests/test_eigenmaps.py:96-110: the staged pipeline with the
    signals graph equals the monolithic build, and the JAX package's."""
    rows = make_moons_hd(70, noise=0.1, hd_noise=0.05, dims=10, seed=6)
    b1 = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None).with_spectral(True) \
        .with_seed(31)
    aspace_m, _ = b1.build(rows)
    b2 = _tb().with_lambda_graph(1.0, 5, 3, 2.0, None).with_spectral(True) \
        .with_seed(31)
    b2.define_result_k()
    clustered = tem.start_clustering(b2, rows)
    aspace_s = clustered.aspace
    gl_s = tem.eigenmaps(aspace_s, b2, clustered.centroids, len(rows))
    tem.compute_taumode(aspace_s, gl_s)
    assert torch.equal(aspace_s.signals, aspace_m.signals)
    assert torch.equal(aspace_s.lambdas, aspace_m.lambdas)

    jb = JBuilder().with_lambda_graph(1.0, 5, 3, 2.0, None) \
        .with_spectral(True).with_seed(31)
    jb.define_result_k()
    jc = jem.start_clustering(jb, rows.tolist())
    jg = jem.eigenmaps(jc.aspace, jb, jc.centroids, jc.n_items)
    jem.compute_taumode(jc.aspace, jg)
    np.testing.assert_allclose(aspace_s.signals.numpy(),
                               np.asarray(jc.aspace.signals), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(aspace_s.lambdas.numpy(),
                               np.asarray(jc.aspace.lambdas), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("op", ["scale", "add", "mul"])
def test_one_row_refresh_reads_signals(op):
    """The one-row λ refresh after a mutation computes λ against the
    signals graph in both packages, and equals recompute_lambdas."""
    _rows, (ja, jg), (ta, tg) = _spectral_pair(seed=8, build_seed=4)
    for a, g in ((ja, jg), (ta, tg)):
        if op == "scale":
            a.scale_item(7, 1.7, g)
        elif op == "add":
            a.add_items(7, 3, g)
        else:
            a.mul_items(7, 3, g)
    assert float(ta.lambdas[7]) == pytest.approx(float(ja.lambdas[7]),
                                                 rel=1e-12, abs=1e-14)
    one_row = ta.lambdas.clone()
    ta.recompute_lambdas(tg)
    ja.recompute_lambdas(jg)
    np.testing.assert_allclose(ta.lambdas.numpy(), np.asarray(ja.lambdas),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(one_row.numpy(), ta.lambdas.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_query_lambda_reads_the_feature_graph():
    """The quirk both packages keep: a query's λ is prepared against
    gl.matrix even when the items' λ came from the signals graph."""
    rows, (ja, jg), (ta, tg) = _spectral_pair(seed=10, build_seed=2)
    q = rows[4] * 1.02
    lam_t, lam_j = ta.prepare_query_item(q, tg), ja.prepare_query_item(q, jg)
    assert lam_t == pytest.approx(float(lam_j), rel=1e-12)
    from arrowspace_torch.taumode import select_tau, synthetic_lambda_single
    tau = select_tau(q, ta.taumode)
    assert lam_t == pytest.approx(
        synthetic_lambda_single(q, tg.matrix, tau), rel=1e-12)
    res_t = ta.search_lambda_aware(ArrowItem(q, lam_t), 6, 0.8)
    res_j = ja.search_lambda_aware(JItem(q, lam_j), 6, 0.8)
    assert [i for i, _ in res_t] == [int(i) for i, _ in res_j]


# ---------------------------------------------------------------------------
# Energy search with a signals graph attached (tests/test_energy.py:295-320)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def energy_pair():
    """A JAX-built energy index carried into the port, both with the same
    random (G, r) signals matrix attached (G != r: the scores measure
    differences through a non-square map, as the JAX tests do)."""
    rng = np.random.default_rng(5)
    centres = rng.uniform(0, 1, (40, 96))
    rows = centres[rng.integers(0, 40, 600)] + rng.normal(0, 0.02,
                                                          (600, 96))
    b = JBuilder().with_seed(7).with_dims_reduction(True, 0.3) \
        .with_inline_sampling(None)
    ja, jg = jen.build_energy(b, rows.tolist(),
                              JEnergyParams(split_quantile=0.2,
                                            allow_tall_graphs=True))
    r = ja.reduced_dim
    sig = rng.normal(size=(r + 5, r)) * 0.3
    import jax.numpy as jnp
    ja.signals = jnp.asarray(sig)
    t = from_jax_state(rows, np.asarray(ja.lambdas), np.asarray(jg.matrix),
                       ja.taumode, pad_tall_graphs=ja.pad_tall_graphs,
                       projection=np.asarray(ja.projection_matrix.matrix()),
                       signals=sig, **CPU64)
    return rows, JIndex(ja, jg, b), t


def test_carried_signals(energy_pair):
    _rows, j, t = energy_pair
    np.testing.assert_array_equal(t.aspace.signals.numpy(),
                                  np.asarray(j.aspace.signals))
    assert t.aspace.projection_matrix.generator == "threefry"


@pytest.mark.parametrize("chunk", [None, 64])
def test_search_energy_batch_with_signals(energy_pair, monkeypatch, chunk):
    """In-memory (a (B, N, G) difference plane through the signals map)
    and, with the ceiling lowered, the streaming z-plane path, against
    the JAX package's same paths."""
    rows, j, t = energy_pair
    if chunk is not None:
        monkeypatch.setattr(jen, "ENERGY_CHUNK", chunk)
        monkeypatch.setattr(ten, "ENERGY_CHUNK", chunk)
    q = rows[[3, 77, 301, 599]] * 1.01
    js, ji = jen.search_energy_batch(j.aspace, q, j.gl, 9, 1.0, 0.5)
    ts, ti = ten.search_energy_batch(t.aspace, q, t.gl, 9, 1.0, 0.5)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-12)
    if chunk is not None:
        z = t.aspace._energy_z_cache
        assert z is not None and z[0] == tuple(t.aspace.signals.shape)


def test_search_energy_single_with_signals(energy_pair):
    rows, j, t = energy_pair
    for r in (0, 123, 456):
        q = rows[r] * 0.98
        jr = jen.search_energy(j.aspace, q, j.gl, 7, 1.0, 0.5)
        tr = ten.search_energy(t.aspace, q, t.gl, 7, 1.0, 0.5)
        assert [i for i, _ in tr] == [int(i) for i, _ in jr]
        np.testing.assert_allclose([s for _, s in tr],
                                   [float(s) for _, s in jr], rtol=0,
                                   atol=1e-12)


def test_energy_session_with_signals(energy_pair):
    """The EnergySearchSession's z-plane is z_items = x·signalsᵀ and
    z_q = q_prep·signalsᵀ in both packages."""
    rows, j, t = energy_pair
    rng = np.random.default_rng(3)
    batches = [rows[rng.integers(0, 600, 8)] * 1.02 for _ in range(3)]
    jsess = j.make_energy_session(batch_size=8, k=6)
    tsess = t.make_energy_session(batch_size=8, k=6)
    for (js, ji), (ts, ti) in zip(jsess.search_stream(batches),
                                  tsess.search_stream(batches)):
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-12)
    z_q, _ = tsess.prepare(torch.as_tensor(batches[0]))
    proj = t.aspace.projection_matrix.matrix()
    np.testing.assert_allclose(
        z_q.numpy(), batches[0] @ proj.numpy() @ t.aspace.signals.numpy().T,
        rtol=1e-12)


# ---------------------------------------------------------------------------
# A fault both packages share, pinned rather than fixed
# ---------------------------------------------------------------------------

def test_energy_index_mutation_fails_alike_in_both_packages():
    """An energy index cannot be mutated through ArrowSpace's API in
    either package: its graph has X nodes, not N, so the node check of
    scale_item asserts, and recompute_lambdas does not zero-pad the rows
    to the tall graph, so it raises (the live energy session does not
    use this API)."""
    rng = np.random.default_rng(17)
    centres = rng.uniform(0, 1, (60, 72))
    rows = centres[rng.integers(0, 60, 6000)] + rng.normal(0, 0.02,
                                                           (6000, 72))
    params = dict(split_quantile=0.2, allow_tall_graphs=True)
    j = JIndex.build_energy(rows, JEnergyParams(**params), seed=5)
    t = ArrowIndex.build_energy(rows, EnergyParams(**params), seed=5,
                                **CPU64)
    for idx in (j, t):
        assert idx.gl.matrix.shape[0] > 72, "the energy graph is not tall"
        assert idx.gl.nnodes != idx.aspace.nitems
    for a, g in ((j.aspace, j.gl), (t.aspace, t.gl)):
        with pytest.raises(AssertionError, match="Laplacian nodes"):
            a.scale_item(3, 1.5, g)
        with pytest.raises(ValueError, match="coordinates"):
            a.recompute_lambdas(g)
