#!/usr/bin/env python3
"""How far the sharded unseeded clustering scan moves with the float
type, on the CPU.

Run from the root of a checkout (no card needed; about 25 s and 2 GiB
at the default size):

    python3 tools/scan_precision.py [--rows 1000000] [--shards 4]

It makes chip_smoke.py's corpus (seeded clustered rows, 128 features,
with its planted duplicates), takes K and the radius from
``clustering.compute_optimal_k`` over every row, and runs
``parallel.sharded_incremental_clustering`` on a CPU mesh of
``--shards`` shards twice without sampling: on the float32 rows and on
the same values in float64.  Both runs take the same serialisation, so
their centroids come in the same order; it prints n_c and the assigned
rows of each, the rows assigned otherwise, and the largest difference
of a cluster's size.  chip_smoke.py's [5c] holds the card's float32
scan to the float64 CPU scan within bounds read from this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()

    import chip_smoke as cs
    from arrowspace_torch import clustering, parallel
    from arrowspace_torch.builder import ArrowSpaceBuilder
    from arrowspace_torch.sampling import SamplerType

    rows = cs.clustered_rows(args.rows, cs.N_FEAT, cs.SEED)
    cs.plant_duplicates(rows)
    k, radius, _ = clustering.compute_optimal_k(rows, rows.shape[0],
                                                cs.N_FEAT, None)
    mesh = parallel.make_mesh(devices=["cpu"] * args.shards)
    runs = {}
    for dt in (torch.float32, torch.float64):
        builder = ArrowSpaceBuilder(device="cpu")
        builder.sampling = None
        t0 = time.perf_counter()
        cent, assign, sizes = parallel.sharded_incremental_clustering(
            torch.as_tensor(rows).to(dt), builder, k, radius,
            SamplerType.simple(1.0).make(seed=1), mesh)
        runs[str(dt)] = (cent, assign.array, np.asarray(sizes),
                         time.perf_counter() - t0)
    (c32, a32, s32, t32), (c64, a64, s64, t64) = runs.values()
    same = c32.shape == c64.shape
    print(json.dumps({
        "rows": args.rows, "shards": args.shards, "k": k,
        "radius": radius,
        "n_c": [int(c32.shape[0]), int(c64.shape[0])],
        "assigned": [int((a32 >= 0).sum()), int((a64 >= 0).sum())],
        "rows_assigned_otherwise": int((a32 != a64).sum()),
        "largest_size_difference":
            int(np.abs(s32 - s64).max()) if same else None,
        "seconds": [round(t32, 3), round(t64, 3)]}))


if __name__ == "__main__":
    main()
