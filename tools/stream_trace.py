#!/usr/bin/env python3
"""What the program's own spans say about a benchmark cell, and what the
span recorder costs, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/stream_trace.py cost [--batches 20000] [--root DIR]
    python3 tools/stream_trace.py cell --workload cohere768-batch2048 \\
        --seed 5400000004 --seconds 51 [--out chiprun_out/trace]

``cost`` times ``index.stream_search``'s own loop on the host with no
profiler running (no card needed; see ``cost``), in µs a batch, with the
recorder and with it made no-ops; ``--root`` times another checkout's
loop (one with no recorder as it stands only).  The spans and counters
of a repair itself (``repair.sync``, the triage) are not in it: a few
spans a repaired batch, at ``span_us`` each.

``cell`` makes one traced run of the cell through the benchmark's
harness (``portbench.harness.run_cell``, as ``portbench/run.py --trace
1`` does), writes the traced stretch's Chrome trace (gzipped) and the
result to ``--out``, and prints:

* the window's stream record (``arrowspace_torch.utils.profiling``): ms
  a batch by span, and the sum of the stream's top-level spans
  (``stream.input``, ``.launch``, ``.wait``, ``.repair``, ``.caller``)
  against the window's wall time a batch;
* the rows flagged and their triage;
* the stretch's largest idle gaps of the card, read from the Chrome
  trace, each labelled by the innermost ``arrowspace::`` range the host
  was in when the gap began (else the innermost benchmark span).
"""

from __future__ import annotations

import argparse
import gzip
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOP_SPANS = ("stream.input", "stream.launch", "stream.wait",
             "stream.repair", "stream.caller")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _Off:
    """A recorder that records nothing: ``profiling.Record`` and the
    index's ``span`` made no-ops."""

    id = None

    def __init__(self, *args, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, *args):
        pass

    def add(self, *args):
        pass


def cost(n: int, rounds: int = 7) -> dict:
    """µs a batch of ``index.stream_search`` itself, on a stub step that
    returns ready CPU tensors (2048 × 100 float32 queries, k = 10, depth
    2; the step opens ``stream.prepare`` as the sessions' does), median
    of ``rounds`` runs of ``n`` batches: as it stands, and with the
    recorder made no-ops (their difference is the recorder's cost a
    batch), with no row flagged and with one flagged row a batch (a stub
    repair that returns its input).  A checkout with no recorder (the
    parent of the recorder) is timed as it stands only."""
    import statistics
    from unittest import mock

    import numpy as np
    import torch

    from arrowspace_torch import index
    from arrowspace_torch.utils import profiling
    bsz, dim, k = 2048, 100, 10
    qb = np.ones((bsz, dim), np.float32)
    scores, ids = torch.zeros(bsz, k), torch.zeros(bsz, k, dtype=torch.long)
    qlam, det = torch.zeros(bsz), torch.zeros(bsz, 8)

    def loop(flagged):
        flags = torch.zeros(bsz, dtype=torch.bool)
        flags[0] = flagged
        sp = getattr(index, "span", None)

        def step(q):
            if sp is not None:
                with sp("stream.prepare"):
                    pass
            return scores, ids, flags, qlam, det

        def repair(q, ql, d, s, i, f):
            return s, i

        t = time.perf_counter_ns()
        for _ in index.stream_search(step, itertools.repeat(qb, n), bsz, 2,
                                     "cpu", torch.float32, dim=dim,
                                     repair=repair):
            pass
        return (time.perf_counter_ns() - t) / n * 1e-3

    has = hasattr(profiling, "Record")
    runs: dict = {}
    for _ in range(rounds):
        for flagged in (False, True):
            key = "flagged" if flagged else "plain"
            runs.setdefault(f"{key}_us", []).append(loop(flagged))
            if has:
                with mock.patch.object(profiling, "Record", _Off), \
                        mock.patch.object(index, "span", _Off):
                    runs.setdefault(f"{key}_off_us", []).append(
                        loop(flagged))
    out = {k: statistics.median(v) for k, v in runs.items()}
    if has:
        for key in ("plain", "flagged"):
            out[f"recorder_{key}_us"] = out[f"{key}_us"] - \
                out[f"{key}_off_us"]

        def one_span(reps):
            t = time.perf_counter_ns()
            for _ in range(reps):
                with profiling.span("x"):
                    pass
            return (time.perf_counter_ns() - t) / reps * 1e-3
        out["span_us"] = one_span(n)
    t = time.perf_counter_ns()
    for _ in range(n // 10):
        with torch.profiler.record_function("arrowspace::x"):
            pass
    out["record_function_us"] = (time.perf_counter_ns() - t) / (n // 10) \
        * 1e-3
    return out


def gaps_from_chrome(path: Path, top: int = 10) -> dict:
    """The stretch's idle gaps from a Chrome trace, each labelled by the
    innermost ``arrowspace::`` host range at its start (else the
    innermost ``portbench.`` span, else "none"), with the benchmark's own
    interval arithmetic (portbench/trace.py)."""
    from portbench.trace import clip, gaps, innermost, union
    with gzip.open(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    lo, hi = [(e["ts"], e["ts"] + e["dur"]) for e in xs
              if e.get("cat") == "user_annotation"
              and e["name"] == "portbench.stretch"][0]
    merged = union(clip([(e["ts"], e["ts"] + e["dur"]) for e in xs
                         if e.get("cat") in DEVICE_CATS], lo, hi))
    holes = gaps(merged, lo, hi)
    ranges = [[(e["name"], e["ts"], e["ts"] + e["dur"]) for e in xs
               if e.get("cat") == "user_annotation"
               and e["name"].startswith(p)
               and e["name"] != "portbench.stretch"]
              for p in ("arrowspace::", "portbench.")]

    def label(t):
        for spans in ranges:
            name = innermost(spans, t)
            if name != "none":
                return name
        return "none"

    def covered(s, e, step=10.0):
        """ms of the gap [s, e) under each label, sampled every ``step``
        µs."""
        out: dict = {}
        t = s
        while t < e:
            n = label(t)
            out[n] = out.get(n, 0.0) + min(step, e - t) * 1e-3
            t += step
        return {n: round(v, 3) for n, v in sorted(out.items(),
                                                  key=lambda x: -x[1])}

    holes.sort(key=lambda h: h[0] - h[1])
    busy = sum(e - s for s, e in merged)
    return {"window_ms": (hi - lo) * 1e-3, "busy_ms": busy * 1e-3,
            "idle_share": 1.0 - busy / (hi - lo),
            "gaps": [[label(s), (e - s) * 1e-3, (s - lo) * 1e-3,
                      covered(s, e)] for s, e in holes[:top]]}


def cell(a, **run_options) -> dict:
    """One traced run of the cell (``run_options`` go to run_cell: the
    tests' tiny CPU cells)."""
    from portbench import harness, trace
    from portbench.loops import closed

    from arrowspace_torch.utils.profiling import records
    out_dir = Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    chrome = out_dir / f"{a.workload}-{a.seed}.json.gz"
    finish = trace.Tracer.finish

    def export_then_finish(self):
        done = getattr(self, "_done", None)
        if done is not None:
            raw = out_dir / "_trace.json"
            done.export_chrome_trace(str(raw))
            with open(raw, "rb") as src, gzip.open(chrome, "wb") as dst:
                dst.write(src.read())
            raw.unlink()
        finish(self)

    trace.Tracer.finish = export_then_finish
    window = {}
    run = closed.run

    def keep_window(*args, **kw):
        window.update(run(*args, **kw))
        return window

    closed.run = keep_window
    harness.point_caches(ROOT)
    spec = harness.load_spec(ROOT)
    res = harness.run_cell(spec, ROOT, a.workload, a.seed, a.seconds, True,
                           a.t_start, **run_options)
    # the window's stream: the record whose batches and queries are the
    # window's
    streams = [r for r in records() if r["kind"] == "stream"
               and r["counters"].get("batches") == window["requests"]
               and r["counters"].get("queries") == window["queries"]]
    rec = streams[-1] if streams else None
    report = {"workload": a.workload, "seed": a.seed,
              "correct": res["correct"], "metrics": res["metrics"],
              "device": res["device"], "breakdown": res.get("breakdown"),
              "window_s": window["seconds"], "stream": rec}
    if rec is not None:
        n = rec["counters"]["batches"]
        per = {k: v["total_s"] * 1e3 / n for k, v in rec["spans"].items()}
        report["ms_a_batch"] = per
        report["top_spans_ms_a_batch"] = sum(per.get(k, 0.0)
                                             for k in TOP_SPANS)
        report["window_ms_a_batch"] = window["seconds"] * 1e3 / n
    report["chrome_gaps"] = gaps_from_chrome(chrome)
    (out_dir / f"{a.workload}-{a.seed}.result.json").write_text(
        json.dumps(res, default=str))
    return report


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cost")
    c.add_argument("--batches", type=int, default=20_000)
    c.add_argument("--root", default=str(ROOT),
                   help="the checkout whose arrowspace_torch is timed")
    w = sub.add_parser("cell")
    w.add_argument("--workload", required=True)
    w.add_argument("--seed", type=int, required=True)
    w.add_argument("--seconds", type=float, default=51.0)
    w.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace"))
    a = p.parse_args()
    a.t_start = t_start
    if a.what == "cost":
        sys.path.insert(0, a.root)
    out = cost(a.batches) if a.what == "cost" else cell(a)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
