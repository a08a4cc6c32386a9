"""The small modules of arrowspace_torch (sparsification, utils/quality,
utils/profiling, ``python -m arrowspace_torch`` and precompile) against
the JAX package where it computes something, on the CPU.

Tolerances: the sparsifier and the λ statistics are the same numpy code
on the same inputs, so their outputs are equal; the quality scores run
on float64 indexes of both packages (one feature graph, λ within 1e-12
of each other), so they agree within 1e-12."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from arrowspace_tpu.index import ArrowIndex as JIndex
from arrowspace_tpu.sparsification import SfGrassSparsifier as JSparsifier
from arrowspace_tpu.utils import quality as jq
from arrowspace_tpu.utils.profiling import \
    log_lambda_statistics as j_lambda_stats
from arrowspace_torch import precompile
from arrowspace_torch.index import ArrowIndex, session_kernel_kind
from arrowspace_torch.sparsification import SfGrassSparsifier
from arrowspace_torch.utils import profiling
from arrowspace_torch.utils import quality as tq

CPU64 = dict(device="cpu", dtype=torch.float64)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _sparse_rows(seed=7, n=30):
    """The adjacency lists of tests/test_energy.py::test_sparsifier."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append([(int(j), float(rng.uniform(0.1, 1.0)))
                     for j in rng.choice(n, size=14, replace=False)
                     if j != i])
    return rows


@pytest.mark.parametrize("ratio", [0.5, 0.3, 1.0, 0.0, 5.0])
def test_sparsifier_matches_jax(ratio):
    rows = _sparse_rows()
    n = len(rows)
    sp = SfGrassSparsifier().with_target_ratio(ratio)
    jsp = JSparsifier().with_target_ratio(ratio)
    assert sp.target_ratio == jsp.target_ratio
    assert sp.sparsify_graph(rows, n) == jsp.sparsify_graph(rows, n)
    sparse = [r[:2] for r in rows]                 # avg degree < 10: kept
    assert sp.sparsify_graph(sparse, n) == sparse == \
        jsp.sparsify_graph(sparse, n)


def test_sparsifier_dense_graph_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (40, 40)) * (rng.uniform(0, 1, (40, 40)) < 0.6)
    np.fill_diagonal(a, 0.0)
    out = SfGrassSparsifier().with_target_ratio(0.4).sparsify_dense(a)
    np.testing.assert_array_equal(
        out, JSparsifier().with_target_ratio(0.4).sparsify_dense(a))
    assert 0 < np.count_nonzero(out) < np.count_nonzero(a)


@pytest.fixture(scope="module")
def pair():
    """One 1500 x 24 clustered corpus built by both packages, float64."""
    rng = np.random.default_rng(5)
    c = rng.uniform(0.2, 0.8, (10, 24))
    rows = c[rng.integers(0, 10, 1500)] + rng.normal(0, 0.05, (1500, 24))
    j = JIndex.build(rows, eps=1.0, k=6, topk=3, seed=11)
    t = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11, **CPU64)
    np.testing.assert_allclose(t.lambdas, np.asarray(j.lambdas), atol=1e-12,
                               rtol=0)
    return rows, j, t


def test_graph_and_lambda_quality_match_jax(pair):
    _, j, t = pair
    for name in ("graph_connectivity_ratio", "edge_count_efficiency"):
        assert abs(getattr(tq, name)(t.gl.matrix)
                   - getattr(jq, name)(np.asarray(j.gl.matrix))) <= 1e-12
    assert abs(tq.lambda_distribution_quality(t.aspace.lambdas)
               - jq.lambda_distribution_quality(np.asarray(j.lambdas))) \
        <= 1e-12
    assert abs(tq.evaluate_graph_quality(t.aspace, t.gl)
               - jq.evaluate_graph_quality(j.aspace, j.gl)) <= 1e-12
    assert tq.jaccard_similarity([1, 2, 3], [2, 3, 4]) == \
        jq.jaccard_similarity([1, 2, 3], [2, 3, 4]) == 0.5


@pytest.mark.parametrize("alpha", [0.7, 1.0])
def test_search_effectiveness_matches_jax(pair, alpha):
    rows, j, t = pair
    queries = [rows[3] * 1.01, rows[700], np.ones(24), np.ones(5)]
    want = jq.search_effectiveness_score(j.aspace, queries, alpha, 0.5, 10)
    got = tq.search_effectiveness_score(t.aspace, queries, alpha, 0.5, 10)
    assert abs(got - want) <= 1e-12
    assert tq.search_effectiveness_score(t.aspace, [], alpha, 0.5, 10) \
        == 0.5
    assert abs(tq.evaluate_parameter_quality(t.aspace, t.gl, queries, alpha,
                                             0.5, 10)
               - jq.evaluate_parameter_quality(j.aspace, j.gl, queries,
                                               alpha, 0.5, 10)) <= 1e-12


def test_lambda_statistics_match_jax(pair):
    _, j, t = pair
    got = profiling.log_lambda_statistics(t.aspace.lambdas)
    want = j_lambda_stats(np.asarray(t.lambdas))
    assert got == want
    assert profiling.log_lambda_statistics(t.lambdas) == want


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace records the CPU's operators, the annotated
    span among them, and is written as Chrome trace JSON."""
    x = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("arrowspace::probe"):
            (x @ x).sum()
    path = tmp_path / profiling.TRACE_FILE
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "arrowspace::probe" in names
    assert any(e.key == "arrowspace::probe" for e in prof.key_averages())


def test_module_entry_point_runs_without_jax():
    """python -m arrowspace_torch with jax and arrowspace_tpu blocked:
    it prints the version line and exits 0."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['arrowspace_tpu'] = None; "
            "runpy.run_module('arrowspace_torch', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("arrowspace-torch 0.1.0 — torch ")
    assert f"devices: {torch.cuda.device_count()}" in proc.stdout


@pytest.mark.parametrize("n,f,k,kind", [(70_000, 12, 10, "binned"),
                                        (3000, 12, 10, "plain")])
def test_precompile_warms_the_engines_the_gate_picks(n, f, k, kind):
    timings = precompile.warm(n, f, batch_sizes=(8, 32), k=k,
                              precisions=("f32", "bf16"), device="cpu")
    assert all(v >= 0 for v in timings.values()), timings
    assert session_kernel_kind(n, k, f) == kind
    want = {"native_scan"} | {f"{kind}_b{b}_f32" for b in (8, 32)}
    if kind != "plain":
        want |= {f"{kind}_b{b}_bf16" for b in (8, 32)}
        want |= {"repair_f32", "repair_bf16"}
    assert set(timings) == want


def test_precompile_energy_and_cli(capsys):
    timings = precompile.warm_energy(70_000, 8, batch_sizes=(16,),
                                     device="cpu")
    assert set(timings) == {"native_scan", "energy_binned_b16",
                            "energy_chunked_b16"}
    assert all(v >= 0 for v in timings.values())
    assert precompile.main(["--n", "3000", "--f", "8", "--batch", "4",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plain_b4_f32: " in out and "FAILED" not in out
    assert out.rstrip().splitlines()[-1].startswith("total: ")


def test_precompile_names_failures(monkeypatch, capsys):
    """A launch that raises is recorded as -1 and the rest still warm,
    as the JAX package's precompile does; the CLI then exits 1, so a
    warm-up step sees that a kernel did not build or launch."""
    from arrowspace_torch.ops import search

    def boom(*a, **kw):
        raise RuntimeError("refused")
    monkeypatch.setattr(search, "batched_lambda_aware_topk", boom)
    timings = precompile.warm(3000, 8, batch_sizes=(4, 8), device="cpu")
    assert timings["plain_b4_f32"] == timings["plain_b8_f32"] == -1.0
    assert timings["native_scan"] >= 0
    assert precompile.main(["--n", "3000", "--f", "8", "--batch", "4",
                            "--device", "cpu"]) == 1
    assert "plain_b4_f32: FAILED" in capsys.readouterr().out


def test_package_exports_the_projection():
    import arrowspace_torch
    from arrowspace_torch.reduction import (ImplicitProjection,
                                            compute_jl_dimension)
    assert arrowspace_torch.ImplicitProjection is ImplicitProjection
    assert arrowspace_torch.compute_jl_dimension is compute_jl_dimension
