"""The span and counter recorder of arrowspace_torch (utils/profiling.py)
and the spans and counters of the serving path, on the CPU.

A span always adds its wall time to the innermost active record (calls,
total, self time) and opens its ``arrowspace::`` range only while a
torch profiler records.  The serving sessions keep a session record and
each stream a stream record, with the stream's batches, queries and
flagged rows, and the repairs' triage of those rows.  The benchmark's
readers of these records (``portbench/metrics/``) report every new
per-layer metric of a tiny traced run, and nothing where the program has
no recorder.

Small corpora reach the binned engines with their gates lowered
(core.BINNED_MIN_ITEMS, energymaps.ENERGY_CHUNK), as
tests/test_torch_prepare_corpus.py lowers them; rows deeper than K1's
bin depth in one bin (two sources) and in three bins (one source) make
the first batch flag rows for the strided repair and for its fallback.
"""

import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from arrowspace_torch import ArrowIndex, core, energymaps
from arrowspace_torch.energymaps import EnergyParams
from arrowspace_torch.index import stream_search
from arrowspace_torch.ops import bintopk as bt
from arrowspace_torch.utils import profiling
from arrowspace_torch.utils.log import get_logger, stage_timer

ROOT = Path(__file__).resolve().parent.parent
N, F, K, B = 6000, 16, 10, 16
STREAM_SPANS = ("stream.input", "stream.launch", "stream.prepare",
                "stream.wait", "stream.repair", "repair.sync")
NEW_METRICS = {
    "glove100-batch2048": ["launch_ms.glove100", "repair_ms.glove100",
                           "repair_sync_ms.glove100",
                           "flagged_per_1k.glove100"],
    "cohere768-batch2048": ["launch_ms.cohere768", "repair_ms.cohere768",
                            "repair_sync_ms.cohere768",
                            "flagged_per_1k.cohere768"]}
SHARED_METRICS = ["session.prepare_s", "session.warmup_s",
                  "build.ch_sweep_s"]


def _rows():
    """Clustered rows; rows 0 and 1 each get depth+2 exact copies in one
    bin of K1 (and of K6, the same bins), row 2 in three bins."""
    rng = np.random.default_rng(3)
    c = rng.uniform(0.2, 0.8, (24, F))
    rows = c[rng.integers(0, 24, N)] + rng.normal(0, 0.05, (N, F))
    depth, bins = bt.binned_topk_depth_for(K), bt.bins_target(K)
    deep = 2 + np.arange(depth + 2)
    for src in (0, 1):
        rows[src + 7 + bins * deep] = rows[src]
    for b in (11, 29, 53):
        rows[b + bins * deep] = rows[2]
    return rows


@pytest.fixture(scope="module")
def rows():
    return _rows()


@pytest.fixture(scope="module")
def cosine(rows):
    return ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11,
                            device="cpu")


@pytest.fixture(scope="module")
def energy(rows):
    return ArrowIndex.build_energy(rows, EnergyParams(allow_tall_graphs=True),
                                   seed=5, device="cpu")


def _batches(rows):
    rng = np.random.default_rng(1)
    q = rows[rng.integers(0, rows.shape[0], 3 * B)] * 1.02
    q[:3] = rows[:3] * 1.02                  # the planted collisions
    return [q[:B], q[B:2 * B], q[2 * B:2 * B + 5]]      # a short tail


def _session(kind, cosine, energy, monkeypatch):
    monkeypatch.setattr(core, "BINNED_MIN_ITEMS", 1000)
    monkeypatch.setattr(energymaps, "ENERGY_CHUNK", 1000)
    if kind == "lambda":
        s = cosine.make_search_session(B, k=K)
        return s, s._repair.__self__
    s = energy.make_energy_session(B, k=K)
    return s, s.engine


def _last(kind="stream"):
    return [r for r in profiling.records() if r["kind"] == kind][-1]


def test_spans_nest_with_self_time_and_counters():
    rec = profiling.Record("stream", session=7)
    profiling.count("outside")                  # no active record: no-op
    with profiling.span("outside") as sp:
        pass
    assert sp.seconds >= 0.0
    with rec:
        for _ in range(2):
            with profiling.span("outer") as outer:
                time.sleep(0.002)
                with profiling.span("inner") as inner:
                    time.sleep(0.004)
                profiling.count("rows", 3)
        profiling.count("batches")
    got = profiling.records()[-1]
    assert got["id"] == rec.id and got["session"] == 7
    assert got["counters"] == {"rows": 6, "batches": 1}
    o, i = got["spans"]["outer"], got["spans"]["inner"]
    assert o["count"] == i["count"] == 2
    assert i["self_s"] == i["total_s"] >= 0.008
    assert o["total_s"] >= i["total_s"] + 0.004
    assert o["self_s"] == pytest.approx(o["total_s"] - i["total_s"],
                                        abs=1e-9)
    assert outer.seconds >= inner.seconds > 0.0
    assert "outside" not in got["spans"]


def test_registry_keeps_the_last_records():
    made = [profiling.Record("stream") for _ in range(profiling.KEEP + 5)]
    got = profiling.records()
    assert len(got) == profiling.KEEP
    assert [r["id"] for r in got] == [r.id for r in made[-profiling.KEEP:]]


def test_no_range_is_entered_without_a_profiler(cosine, energy, rows,
                                                 monkeypatch):
    entered = []

    def fake(name):
        entered.append(name)
        raise AssertionError(f"range {name} entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", fake)
    for kind in ("lambda", "energy"):
        s, _ = _session(kind, cosine, energy, monkeypatch)
        s.warmup()
        list(s.search_stream(_batches(rows)))
    with stage_timer(get_logger("test"), "stage"), \
            profiling.annotate("arrowspace::probe"):
        pass
    assert entered == []
    assert _last()["counters"]["rows_flagged"] >= 3


def test_annotate_keeps_its_nvtx_range_without_a_profiler(monkeypatch):
    """On CUDA ``annotate`` pushes an NVTX range of its name whether or
    not a torch profiler records (an Nsight Systems run starts none); a
    span pushes no NVTX range of its own."""
    import contextlib
    pushed = []

    @contextlib.contextmanager
    def fake_range(name):
        pushed.append(name)
        yield

    def no_push(name):
        raise AssertionError(f"span pushed NVTX range {name}")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range", fake_range)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_push)
    with profiling.annotate("arrowspace::mesh_merge"):
        pass
    with profiling.span("stream.wait"):
        pass
    assert pushed == ["arrowspace::mesh_merge"]


def test_spans_are_ranges_under_a_profiler(cosine, rows, monkeypatch):
    """Every span of the serving path and the CH sweep's is an
    ``arrowspace::`` range in a CPU profile, with the kernels' ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s, _ = _session("lambda", cosine, None, monkeypatch)
        s.warmup()
        list(s.search_stream(_batches(rows)))
        ArrowIndex.build(rows[:400], eps=1.0, seed=11, device="cpu")
    keys = {e.key for e in prof.key_averages()}
    want = {profiling.PREFIX + n for n in STREAM_SPANS + (
        "session.prepare", "session.warmup", "clustering.ch_sweep",
        "clustering.twonn", "build.clustering", "build.taumode")}
    assert want <= keys, sorted(want - keys)


@pytest.mark.parametrize("kind", ["lambda", "energy"])
def test_stream_counts_flagged_rows_and_their_triage(kind, cosine, energy,
                                                     rows, monkeypatch):
    """The binned λ and energy engines count alike: the stream's batches,
    unpadded queries and flagged rows, the engine's ``flagged_rows``, and
    a triage (passed, rescored, over MAX_FIRED) that sums to the flagged
    rows; the warm-up's synthetic repair counts into the session."""
    s, engine = _session(kind, cosine, energy, monkeypatch)
    s.warmup()
    session = _last("session")
    assert session["id"] == s.record.id
    assert {"session.prepare", "session.warmup",
            "repair.sync"} <= set(session["spans"])
    assert session["counters"]["rows_rescored"] == 1
    before = engine.flagged_rows
    list(s.search_stream(_batches(rows)))
    rec = _last()
    c = rec["counters"]
    assert rec["session"] == s.record.id
    assert c["batches"] == 3 and c["queries"] == 2 * B + 5
    assert c["rows_flagged"] == engine.flagged_rows - before >= 3
    assert c["rows_passed"] + c["rows_rescored"] + c["rows_fallback"] \
        == c["rows_flagged"]
    assert c["rows_fallback"] >= 1 and c["rows_rescored"] >= 2
    assert c["repair_chunks"] >= 1
    sp = rec["spans"]
    assert sp["stream.launch"]["count"] == sp["stream.wait"]["count"] == 3
    assert sp["stream.input"]["count"] == 4          # and the end
    assert sp["stream.caller"]["count"] == 3
    assert sp["stream.launch"]["self_s"] < sp["stream.launch"]["total_s"]
    assert sp["repair.sync"]["count"] >= 3


def test_stream_counts_a_planted_flag_with_a_stub_step():
    """As the JAX package's test_stream_driver_repairs_flagged_rows
    plants them: rows 1 and 3 flagged in a full batch, row 1 in the
    two-row tail."""
    bsz = 4

    def step(q):
        s = torch.arange(3, 0, -1, dtype=torch.float32).repeat(bsz, 1)
        i = torch.arange(3).repeat(bsz, 1)
        fl = torch.tensor([False, True, False, True])
        return s, i, fl, torch.zeros(bsz), torch.zeros(bsz, 4)

    def repair(q, qlam, det, scores, ids, flags):
        return scores, ids

    out = list(stream_search(step, [np.ones((bsz, 8)), np.ones((2, 8))],
                             bsz, 1, "cpu", torch.float32, repair=repair,
                             session=41))
    assert len(out) == 2
    rec = _last()
    assert rec["session"] == 41
    assert rec["counters"] == {"batches": 2, "queries": 6,
                               "rows_flagged": 3}
    assert rec["spans"]["stream.repair"]["count"] == 2


def test_empty_stream_yields_nothing_and_keeps_its_record():
    """An empty input yields nothing, as ``for qb in batches`` does, and
    the stream's record still joins the registry."""
    def step(q):
        raise AssertionError("no batch to launch")

    assert list(stream_search(step, [], 4, 2, "cpu", torch.float32,
                              session=43)) == []
    rec = _last()
    assert rec["session"] == 43 and rec["counters"] == {}
    assert rec["spans"]["stream.input"]["count"] == 1
    assert list(stream_search(step, iter(()), 4, 1, "cpu",
                              torch.float32)) == []


def test_stream_trace_times_the_real_loop():
    """tools/stream_trace.py's ``cost`` times index.stream_search itself,
    with the recorder and with it made no-ops, and leaves the recorder
    in place."""
    spec = importlib.util.spec_from_file_location(
        "stream_trace", ROOT / "tools" / "stream_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.cost(50, rounds=1)
    for key in ("plain", "flagged"):
        assert out[f"{key}_us"] > 0.0 and out[f"{key}_off_us"] > 0.0
        assert f"recorder_{key}_us" in out
    assert out["span_us"] > 0.0
    from arrowspace_torch import index
    assert index.span is profiling.span
    assert profiling.Record.__name__ == "Record"


def test_build_stage_seconds_keep_their_keys(cosine):
    b = cosine.builder
    assert set(b.stage_seconds) == {"clustering", "laplacian", "taumode"}
    assert {"twonn", "ch_sweep", "optimal_k", "scan"} <= set(
        b.clustering_seconds)
    assert b.clustering_seconds["ch_sweep"] <= \
        b.clustering_seconds["optimal_k"] <= b.stage_seconds["clustering"]
    assert all(v > 0.0 for v in b.stage_seconds.values())


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(
    SHARED_METRICS + [m for ms in NEW_METRICS.values() for m in ms]))
def test_readers_read_nothing_without_the_recorder(name, monkeypatch):
    """Against a program that has no recorder (the parent of these
    metrics), or with no stream matching the window, a reader returns
    None and does not raise."""
    monkeypatch.syspath_prepend(str(ROOT))
    read = _reader(name)
    rec = {"window": {"requests": 10 ** 9, "queries": 7}, "stages": {}}
    assert read(rec) is None
    monkeypatch.delattr(profiling, "records")
    rec["window"]["requests"] = 0
    assert read(rec) is None


def _digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).digest()
            for p in tree.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_traced_harness_reports_the_new_metrics(cell, tmp_path):
    """A tiny traced run of each cell from a copy of the benchmark: every
    new metric of the cell is a number, each read by a file of its own
    under portbench/metrics/, and the run changes no benchmark file.  The
    window runs for seconds, so that it serves more batches than the
    warm-up's one-batch stream, which its readers must tell apart."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    code = (
        "import sys, json, time; from pathlib import Path\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench.tests.tiny import tiny_run\n"
        f"out = tiny_run({cell!r}, seconds=2.0, traced=True, "
        f"root=Path({str(tmp_path)!r}))\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"ARROWSPACE_TEST_MODE": "1",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    for name in NEW_METRICS[cell] + SHARED_METRICS:
        assert name in out["metrics"], (out["attempted"], res.stderr[-3000:])
        v = out["metrics"][name]["value"]
        assert isinstance(v, float) and np.isfinite(v) and v >= 0.0, name
    assert out["metrics"]["launch_ms." + cell.split("-")[0]]["value"] > 0
    assert out["metrics"]["session.warmup_s"]["value"] > 0
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in spec["per_layer"]}
    assert set(NEW_METRICS[cell] + SHARED_METRICS) <= names
    readers = {p.name for p in (ROOT / "portbench/metrics").glob("*.py")}
    for name in NEW_METRICS[cell] + SHARED_METRICS:
        assert f"{name}.py" in readers or \
            f"{name.split('.')[0]}.py" in readers
    assert _digest(tmp_path / "portbench") == before
