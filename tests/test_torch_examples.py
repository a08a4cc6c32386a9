"""The port's examples on the CPU against the JAX package's.

examples/torch_01-torch_04 run as a user runs them, with ``--device
cpu`` (float64 on the CPU), in a process of their own; the JAX examples
01-04 run here, in this process's float64 CPU configuration.  The ids
each prints must be equal: the cosine baseline, the λ-aware rankings and
the α sweep (01), the λ-band hits (02), the cosine baseline (03: both
builds there project 96 features by JL, and the packages' generators
differ, so its λ-aware and energy rankings are each package's own), and
the λ-aware, overlay and ensemble rankings (04)."""

import pathlib
import re
import runpy
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {
    "01_compare_cosine": [r"idx=(\d+)", r"alpha=([\d.]+): (.*)"],
    "02_proteins_lookup": [r"\(idx=(\d+)\)", r"=> (\d+) hits"],
    "03_compare_energy_cosine": [r"cosine top-10: (\[.*\])"],
    "04_hypergraph_ensembles": [r"top-10: (\[.*\])"],
}


def _ids(text, patterns):
    """What the patterns capture, line by line; 01's sweep keeps the ids
    of each α's entries (its 4-decimal scores are rounded text)."""
    out = []
    for line in text.splitlines():
        for pat in patterns:
            m = re.search(pat, line)
            if m is None:
                continue
            if pat.startswith("alpha"):
                out.append((m.group(1),
                            re.findall(r"(\d+)\(", m.group(2))))
            else:
                out.append(m.groups())
    return out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_prints_the_jax_examples_ids(name, capsys):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    finally:
        sys.path.remove(str(ROOT / "examples"))
    want = _ids(capsys.readouterr().out, EXAMPLES[name])
    got = _ids(proc.stdout, EXAMPLES[name])
    assert want and got == want
    if name == "03_compare_energy_cosine":
        assert "λ-aware (α=0.9) top-10: [42," in proc.stdout
        assert "energy-only top-10: [42," in proc.stdout
