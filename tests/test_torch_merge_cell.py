"""The benchmark's dbpedia-openai-1M-1536 cell (``dbpedia1536-batch2048``)
at a tiny size on the CPU, and the reader of its K3 counter.

The cell's configuration runs through ``portbench.harness.run_cell`` with
F = 1536 kept and the rows cut to 4096; ``core.BINNED_MIN_ITEMS`` is
lowered so that the session resolves "merge", as it does at 1M rows, and
K3's plain version serves every batch.  A sound run proves correct, and a
served id altered or a served score moved by 1e-4 (the benchmark's
planted faults, ``Broken``) comes out not correct.
The runs share one subprocess: the benchmark's process must load no JAX,
which this test process holds.  The sound run's window lasts seconds, so
that it serves more batches than the warm-up's one-batch stream, which
the stream readers must tell apart from it.
"""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from arrowspace_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CELL = "dbpedia1536-batch2048"
ROWS, BATCH = 4096, 16
FAULTS = ("id", "score")

RUNS = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from arrowspace_torch import core
from arrowspace_torch.utils import profiling
from portbench.tests.test_portbench_reference import Broken
from portbench.tests.tiny import tiny_run

core.BINNED_MIN_ITEMS = 1000
kinds = []


def watch(session):
    kinds.append(session.kernel)
    return session


def run(breaker, traced, seconds):
    return tiny_run({CELL!r}, seconds=seconds, traced=traced, breaker=breaker,
                    cfg={{"rows": {ROWS}, "features": 1536}},
                    mix={{"batch": {BATCH}, "keep_batches": 2,
                          "pool_bytes": 4 * {BATCH} * 1536 * 4}})


out = {{"sound": run(watch, True, 3.0)}}
out["streams"] = [r["counters"] for r in profiling.records()
                  if r["kind"] == "stream"]
for fault in {FAULTS!r}:
    out[fault] = run(lambda s, f=fault: Broken(watch(s), f), False, 0.5)
out["kinds"] = kinds
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    res = subprocess.run([sys.executable, "-c", RUNS], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"ARROWSPACE_TEST_MODE": "1",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_tiny_merge_cell_is_correct(runs):
    out = runs["sound"]
    assert runs["kinds"] == ["merge"] * (1 + len(FAULTS))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())
    assert out["checks"]["lambda_gap"]["value"] > 0       # λ was compared
    # no kernel launches on the CPU, so the counter reads 0
    assert out["counters"]["topk.merge_topk_partial.launches"] == 0
    assert out["metrics"]["merge_launches.dbpedia1536"]["value"] == 0.0
    assert out["metrics"]["launch_ms.dbpedia1536"]["value"] > 0
    assert out["attempted"] > 1
    window = [c for c in runs["streams"]
              if c["batches"] == out["attempted"]]
    assert len(window) == 1
    assert window[0]["queries"] == out["attempted"] * BATCH
    assert "k3.f32" not in window[0]


@pytest.mark.parametrize("fault", FAULTS)
def test_tiny_merge_cell_fault_comes_out_not_correct(runs, fault):
    out = runs[fault]
    assert out["correct"] is False
    bad = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert bad & {"score_gap", "rank_gap", "order_faults"}


def _reader():
    path = ROOT / "portbench" / "metrics" / "merge_launches.py"
    spec = importlib.util.spec_from_file_location("reader_merge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stream,launches,want", [
    (None, 0, None),                           # no stream record
    ({"batches": 4, "queries": 8}, 5, None),   # K3 ran, no counter
    ({"batches": 4, "queries": 8}, 0, 0.0),    # no K3 launch
    ({"batches": 4, "queries": 8, "k3.f32": 4}, 4, 1.0),
    ({"batches": 4, "queries": 8, "k3.f32": 1}, 1, 0.25),
])
def test_merge_launches_reader(stream, launches, want, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    read = _reader()
    recs = [] if stream is None else [
        {"kind": "stream", "id": 1, "session": None, "spans": {},
         "counters": stream}]
    monkeypatch.setattr(profiling, "records", lambda: recs)
    rec = {"window": {"requests": 4, "queries": 8},
           "counters": {"topk.merge_topk_partial.launches": launches}}
    assert read(rec) == want
    monkeypatch.delattr(profiling, "records")
    assert read(rec) is None
