"""BENCHMARK.json against the benchmark's contract, and everything in it
found by name; a new traffic mix and a new metric are picked up from
their files and entries alone."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.tiny import ROOT, TINY_CFG, TINY_MIX

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]


def test_top_level_and_paths():
    assert list(SPEC) == TOP
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in SPEC[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    from portbench import harness
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(SPEC, w["name"], False)}
        layers = harness.metrics_of(SPEC, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e
        assert w["chips"] == 1


def test_everything_is_found_by_name():
    from portbench import harness
    for c in SPEC["configs"]:
        cfg = harness.config_of(SPEC, ROOT, c["name"])
        assert c["file"].startswith("portbench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "portbench/systems" / f"{cfg['system']}.py").exists()
        assert (ROOT / "portbench/generators"
                / f"{cfg['generator']['kind']}.py").exists()
        assert (ROOT / "portbench/references"
                / f"{cfg['reference']}.py").exists()
    for w in SPEC["workloads"]:
        kind = harness.traffic_of(w["traffic"])["kind"]
        assert (ROOT / "portbench/loops" / f"{kind}.py").exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in SPEC["workloads"]}


def digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).digest()
            for p in tree.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_traffic_and_metric_need_only_new_files(tmp_path):
    """A dummy traffic file, a dummy metric file and their entries in
    BENCHMARK.json: the harness runs the new cell and reports the new
    metric, with no file that was there edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "portbench")
    (tmp_path / "portbench/traffic/dummy32.json").write_text(json.dumps(
        {"kind": "closed", "batch": 32, "depth": 1, "trace_after": 0,
         "trace_batches": 2, "keep_batches": 1, "pool_bytes": 128 * 64}))
    (tmp_path / "portbench/metrics/dummy_batches.py").write_text(
        "def read(rec):\n    return rec['window']['queries'] / "
        "rec['traffic']['batch']\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "glove100-dummy32",
                              "config": "glove-100-angular",
                              "traffic": "dummy32", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "qps.glove100":
            m["workloads"].append("glove100-dummy32")
    spec["per_layer"].append({"name": "dummy_batches", "unit": "batches",
                              "better": "higher", "source": "host_clock",
                              "layer": "index", "moves": "qps.glove100",
                              "workloads": ["glove100-dummy32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, json, time; from pathlib import Path\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import harness\n"
        f"root = Path({str(tmp_path)!r})\n"
        "out = harness.run_cell(harness.load_spec(root), root, "
        "'glove100-dummy32', 11, 0.3, True, time.perf_counter(), "
        f"device='cpu', cfg_override={TINY_CFG!r}, "
        "traffic_override={'keep_batches': 1})\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"ARROWSPACE_TEST_MODE": "1",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["dummy_batches"]["value"] == out["attempted"] > 0
    assert digest(tmp_path / "portbench").items() >= before.items()
    assert set(digest(tmp_path / "portbench")) - set(before) == {
        "traffic/dummy32.json", "metrics/dummy_batches.py"}


@pytest.mark.parametrize("traffic", sorted(
    {w["traffic"] for w in SPEC["workloads"]}))
def test_traffic_files_hold_parameters_only(traffic):
    from portbench import harness
    mix = harness.traffic_of(traffic)
    assert all(isinstance(v, (int, float, str, list, dict))
               for v in mix.values())
    assert {**TINY_MIX, **mix}   # the tests' overrides are keys it knows
