#!/usr/bin/env python3
"""Serving time of one session kind for two checkouts, in turns, on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/session_ab.py --kind energy --dirs PARENT,. \\
        [--order ABBAABBA] [--streams 3]

Each turn is a fresh process that imports ``arrowspace_torch`` and
``chip_smoke`` from its checkout (A is the first of ``--dirs``, B the
second), makes chip_smoke.py's corpus (1,000,000 x 128 seeded clustered
rows with its planted duplicates), builds the index of the kind
(``cosine``: ArrowIndex.build with ε = 1.0; ``energy``:
ArrowIndex.build_energy with allow_tall_graphs=True), makes the session
(B = 2048, k = 10; the energy kind also its approx session), warms it up
and times ``search_stream`` over chip_smoke.py's 16 batches on the host
clock, from a synchronise to a synchronise, ``--streams`` times.  It
prints each stream's ms per batch, then every session's median by
checkout.  Comparing two commits inside one call, in turns, keeps the
card, its power limit and the host's neighbours the same for both.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def worker(root: str, kind: str, streams: int) -> None:
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from arrowspace_torch.index import ArrowIndex

    dev = torch.device("cuda", 0)
    rows = cs.clustered_rows(cs.N_ROWS, cs.N_FEAT, cs.SEED)
    cs.plant_duplicates(rows)
    if kind == "energy":
        from arrowspace_torch.energymaps import EnergyParams
        index = ArrowIndex.build_energy(
            rows, EnergyParams(allow_tall_graphs=True), seed=cs.SEED,
            device=dev)
        sessions = {name: index.make_energy_session(
            batch_size=cs.BATCH, k=cs.K, w_lambda=cs.E_WL,
            w_dirichlet=cs.E_WD, approx=approx)
            for name, approx in (("exact", False), ("approx", True))}
    else:
        index = ArrowIndex.build(rows, eps=cs.EPS, seed=cs.SEED, device=dev)
        sessions = {"cosine": index.make_search_session(
            batch_size=cs.BATCH, k=cs.K, alpha=cs.ALPHA)}
    rng = np.random.default_rng(cs.SEED + 2)
    batches = [rows[rng.integers(0, rows.shape[0], cs.BATCH)] * 1.02
               for _ in range(cs.N_BATCHES)]
    out = {}
    for name, session in sessions.items():
        session.warmup()
        out[name] = []
        for _ in range(streams):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            list(session.search_stream(batches))
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) / len(batches)
                             * 1e3)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("cosine", "energy"), required=True)
    ap.add_argument("--dirs", required=True,
                    help="two checkouts, A,B, separated by a comma")
    ap.add_argument("--order", default="ABBAABBA")
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.kind, args.streams)
        return 0
    dirs = dict(zip("AB", args.dirs.split(",")))
    by_side = {"A": {}, "B": {}}
    for side in args.order:
        run = subprocess.run(
            [sys.executable, __file__, "--kind", args.kind, "--dirs",
             args.dirs, "--streams", str(args.streams), "--worker",
             dirs[side]], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        for name, ms in res.items():
            by_side[side].setdefault(name, []).extend(ms)
        print(f"{side} ({dirs[side]}): " + "; ".join(
            f"{name} " + ", ".join(f"{m:.3f}" for m in ms)
            for name, ms in res.items()) + " ms a batch", flush=True)
    for name in by_side["A"]:
        a, b = by_side["A"][name], by_side["B"][name]
        print(f"{name}: median A {statistics.median(a):.3f}, B "
              f"{statistics.median(b):.3f} ms a batch (A {min(a):.3f}-"
              f"{max(a):.3f}, B {min(b):.3f}-{max(b):.3f}; "
              f"{len(a)} and {len(b)} streams)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
