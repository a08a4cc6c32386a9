"""The whole arrowspace_torch slice (seeded build -> search -> serving
session) against the JAX package, in float64 on the CPU.

Tolerances: λ within 1e-10 (float64; the λ products sum in another
order), ids exact, parity goldens at the JAX suite's own 1e-5 relative
budget."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.builder import ArrowSpaceBuilder as JBuilder
from arrowspace_torch import convert
from arrowspace_torch.builder import ArrowSpaceBuilder
from arrowspace_torch.core import ArrowItem
from arrowspace_torch.index import ArrowIndex, session_kernel_kind
from arrowspace_torch.taumode import TauMode

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CPU64 = dict(device="cpu", dtype=torch.float64)


def _clustered(seed, n, f, centres=12, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (centres, f))
    return c[rng.integers(0, centres, n)] + rng.normal(0, noise, (n, f))


def _queries(rows, seed, b):
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, rows.shape[0], b)
    return rows[pick] * 1.02 + rng.normal(0, 0.01, (b, rows.shape[1]))


@pytest.fixture(scope="module")
def small():
    rows = _clustered(7, 2000, 32)
    j = JIndex.build(rows, eps=1.0, k=6, topk=3, seed=11)
    t = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11, **CPU64)
    return rows, j, t


@pytest.fixture(scope="module")
def large():
    rows = _clustered(3, 65536, 16, centres=24)
    j = JIndex.build(rows, eps=1.0, k=6, topk=3, seed=5)
    t = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=5, **CPU64)
    return rows, j, t


def test_seeded_build_matches(small):
    _rows, j, t = small
    assert t.aspace.n_clusters == j.aspace.n_clusters
    np.testing.assert_array_equal(t.aspace.cluster_assignments,
                                  j.aspace.cluster_assignments)
    np.testing.assert_allclose(t.gl.matrix.numpy(), np.asarray(j.gl.matrix),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(t.lambdas, j.lambdas, rtol=1e-10, atol=1e-12)
    assert set(t.builder.stage_seconds) == {"clustering", "laplacian",
                                            "taumode"}


@pytest.mark.parametrize("alpha", [1.0, 0.9, 0.5])
def test_search_ids_match(small, alpha):
    rows, j, t = small
    q = _queries(rows, 1, 6)
    js, ji = j.search(q, k=10, alpha=alpha)
    ts, ti = t.search(q, k=10, alpha=alpha)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-10)


def test_search_one_and_f64_rescore(small):
    rows, j, t = small
    q = rows[123] * 1.02
    one = t.search_one(q, k=5, alpha=0.9)
    s, i = t.search(q, k=5, alpha=0.9)
    assert [x for x, _ in one] == i[0].tolist()
    assert one[0][0] == 123
    assert [x for x, _ in one] == [x for x, _ in j.search_one(q, k=5,
                                                              alpha=0.9)]
    rs, ri = t.search(q, k=5, alpha=0.9, precision="f64_rescore")
    js, ji = j.search(q, k=5, alpha=0.9, precision="f64_rescore")
    np.testing.assert_array_equal(ri, ji)


def test_large_build_serves_binned_session_like_jax(large):
    rows, j, t = large
    assert t.aspace.n_clusters == j.aspace.n_clusters
    np.testing.assert_allclose(t.lambdas, j.lambdas, rtol=1e-10, atol=1e-12)
    assert session_kernel_kind(t.nitems, 10, 16) == "binned"
    batches = [_queries(rows, s, 8) for s in (2, 3)] + \
        [_queries(rows, 4, 5)]                       # short tail batch
    ts = t.make_search_session(batch_size=8, k=10, alpha=0.9)
    assert ts.kernel == "binned"
    ts.warmup()
    js = j.make_search_session(batch_size=8, k=10, alpha=0.9)
    got = list(ts.search_stream(batches))
    want = list(js.search_stream(batches))
    assert len(got) == len(want) == 3
    for (gs, gi), (ws, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-10)


def test_large_search_takes_binned_engine_like_jax(large, monkeypatch):
    """search() shares the session's size gate: on the CPU a 65536-row
    index runs K1's plain version with exact repair, and its ids equal
    the JAX search."""
    from arrowspace_torch.ops import bintopk as bt
    rows, j, t = large
    seen, plain = [], bt.binned_topk_pool_plain
    monkeypatch.setattr(bt, "binned_topk_pool_plain",
                        lambda *a, **kw: seen.append(1) or plain(*a, **kw))
    q = _queries(rows, 6, 4)
    ts, ti = t.search(q, k=10, alpha=0.9)
    assert seen
    js, ji = j.search(q, k=10, alpha=0.9)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-10)


def test_from_jax_state_serves_same_ids(small):
    rows, j, _t = small
    a = j.aspace
    t = convert.from_jax_state(
        np.asarray(a.data), np.asarray(a.lambdas), np.asarray(j.gl.matrix),
        a.taumode, n_clusters=a.n_clusters,
        cluster_assignments=a.cluster_assignments,
        cluster_sizes=a.cluster_sizes, cluster_radius=a.cluster_radius,
        **CPU64)
    q = _queries(rows, 9, 7)
    js, ji = j.search(q, k=8, alpha=0.8)
    ts, ti = t.search(q, k=8, alpha=0.8)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    sess = t.make_search_session(batch_size=7, k=8, alpha=0.8)
    (ss, si), = list(sess.search_stream([q]))
    np.testing.assert_array_equal(si, np.asarray(ji))


def _parity_build(rows, mode):
    b = (ArrowSpaceBuilder(**CPU64)
         .with_lambda_graph(1.0, 6, 3, 2.0, None)
         .with_synthesis(mode)
         .with_inline_sampling(None)
         .with_seed(42))
    return b.build(rows)


@pytest.mark.parametrize("tag", ["quora", "proteins"])
def test_reference_parity_golden(tag):
    data = np.load(FIXTURES / "reference_embeddings.npz")
    gold = np.load(FIXTURES / "reference_parity_golden.npz")
    rows = data[tag]
    aspace, gl = _parity_build(rows, TauMode.median())
    np.testing.assert_allclose(aspace.lambdas.numpy(),
                               gold[f"{tag}_median_lambdas"], rtol=1e-5)
    lap = gl.matrix.numpy()
    assert tuple(gold[f"{tag}_lap_shape"]) == lap.shape
    r, c = np.nonzero(lap)
    np.testing.assert_array_equal(r, gold[f"{tag}_lap_rows"])
    np.testing.assert_array_equal(c, gold[f"{tag}_lap_cols"])
    np.testing.assert_allclose(lap[r, c], gold[f"{tag}_lap_vals"], rtol=1e-5)
    qlams = [aspace.prepare_query_item(rows[qi] * 1.02, gl)
             for qi in range(4)]
    np.testing.assert_allclose(qlams, gold[f"{tag}_query_lambdas"],
                               rtol=1e-5)
    for alpha in (1.0, 0.9, 0.7):
        a_tag = str(alpha).replace(".", "_")
        for qi in range(4):
            res = aspace.search_lambda_aware(
                ArrowItem(rows[qi] * 1.02, qlams[qi]), 5, alpha)
            assert [i for i, _ in res] == \
                list(gold[f"{tag}_top5_a{a_tag}_ids"][qi])
            np.testing.assert_allclose(
                [s for _, s in res], gold[f"{tag}_top5_a{a_tag}_scores"][qi],
                rtol=1e-5)
    for mode_tag, mode in (("mean", TauMode.mean()),
                           ("p75", TauMode.percentile(0.75))):
        aspace, _ = _parity_build(rows, mode)
        np.testing.assert_allclose(aspace.lambdas.numpy(),
                                   gold[f"{tag}_{mode_tag}_lambdas"],
                                   rtol=1e-5)


def test_builder_options_not_ported_raise():
    b = ArrowSpaceBuilder(**CPU64)
    # dims reduction is ported: same flag and default eps as the JAX builder
    jb = JBuilder().with_dims_reduction(True)
    b.with_dims_reduction(True)
    assert (b.use_dims_reduction, b.rp_eps) == (jb.use_dims_reduction,
                                               jb.rp_eps)
    # persistence is ported: the builder records (name, path) as the JAX
    # builder does; bf16 serving is ported too: below the streaming
    # kernels' size it serves the plain scan in the index dtype, as the
    # JAX package does off a TPU, and an unknown precision raises
    b.with_persistence("/nonexistent", "x")
    assert b.persistence == JBuilder().with_persistence("/nonexistent",
                                                        "x").persistence
    assert JBuilder().lambda_k == b.lambda_k
    rows = _clustered(2, 60, 8)
    idx = ArrowIndex.build(rows, eps=1.0, seed=3, **CPU64)
    s16, i16 = idx.search(rows[:2], k=3, precision="bf16")
    s32, i32 = idx.search(rows[:2], k=3)
    np.testing.assert_array_equal(i16, i32)
    np.testing.assert_array_equal(s16, s32)
    with pytest.raises(ValueError):
        idx.search(rows[:2], k=3, precision="fp8")


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['arrowspace_tpu'] = None; "
            "import arrowspace_torch, arrowspace_torch.convert, "
            "arrowspace_torch.eigenmaps, arrowspace_torch.ops.bin_repair, "
            "arrowspace_torch.ops.topk, arrowspace_torch.ops.taulambda, "
            "arrowspace_torch.energymaps, arrowspace_torch.reduction, "
            "arrowspace_torch.ops.select_tau, "
            "arrowspace_torch.ops.energy_bintopk, "
            "arrowspace_torch.ops.energy_approx, arrowspace_torch.live, "
            "arrowspace_torch.storage.parquet, "
            "arrowspace_torch.sparsification, "
            "arrowspace_torch.utils.quality, "
            "arrowspace_torch.utils.profiling, "
            "arrowspace_torch.precompile, arrowspace_torch.__main__; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules if sys.modules[m] is not None)")
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
