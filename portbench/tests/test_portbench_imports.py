"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the system under test; top-level module
names are compared whole (arrowspace_torch begins with arrowspace_tpu's
"arrowspace_")."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT, TINY_CFG, TINY_MIX

FORBIDDEN = {"jax", "jaxlib", "flax", "arrowspace_tpu"}
BENCH = ROOT / "portbench"
MODULES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_module_imports_nothing_forbidden(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if "references" in path.relative_to(BENCH).parts:
        assert "arrowspace_torch" not in names
        assert not names - {"__future__", "math", "numpy", "torch"}


def test_the_check_compares_whole_names():
    assert "arrowspace_torch" not in FORBIDDEN
    from portbench import harness
    assert set(harness.FORBIDDEN) == FORBIDDEN


def test_a_run_loads_none_of_them():
    """A tiny CPU run of the harness in a fresh process, then the process's
    sys.modules."""
    code = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        f"root = harness.Path({str(ROOT)!r})\n"
        "out = harness.run_cell(harness.load_spec(root), root, "
        "'glove100-batch2048', 3, 0.3, True, time.perf_counter(), "
        f"device='cpu', cfg_override={TINY_CFG!r}, "
        f"traffic_override={TINY_MIX!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"ARROWSPACE_TEST_MODE": "1",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "arrowspace_torch" in loaded
    assert not loaded & FORBIDDEN
