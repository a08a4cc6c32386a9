"""Tiny cells on the CPU, for the benchmark's tests."""

import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY_CFG = {"rows": 3000, "features": 16}
TINY_MIX = {"batch": 64, "keep_batches": 2, "trace_after": 1,
            "trace_batches": 2, "pool_bytes": 1 << 17}


def tiny_run(workload, seed=2**31 + 7, seconds=0.5, traced=False,
             root=ROOT, cfg=None, mix=None, **kw):
    """One CPU run of a cell cut to a tiny corpus and batch."""
    from portbench import harness
    return harness.run_cell(harness.load_spec(root), root, workload, seed,
                            seconds, traced, time.perf_counter(), device="cpu",
                            cfg_override={**TINY_CFG, **(cfg or {})},
                            traffic_override={**TINY_MIX, **(mix or {})},
                            **kw)
