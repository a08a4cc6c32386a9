"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds arrowspace_torch, on a machine
with as many CUDA cards as the cell asks for.  The last line of standard
output is the result object; the compared numbers and their limits are
the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="also read the controls' numbers (not a timed run)")
    a = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    harness.point_caches(ROOT)
    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, a.workload)
    if not harness.card_ready(int(cell["chips"])):
        harness.log(f"{a.workload} needs {cell['chips']} CUDA card(s); "
                    "this machine has fewer")
        return 2
    out = harness.run_cell(spec, ROOT, a.workload, a.seed, a.seconds,
                           bool(a.trace), T_START, control=a.control)
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
