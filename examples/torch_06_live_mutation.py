"""Live index mutation while serving on arrowspace_torch (the flow of
06_live_mutation.py): add, update and delete rows of a LiveSearchSession
whose corpus lives in a capacity buffer on the device; the live row
count reaches the kernels as their row count, and every search scores
exactly the current live rows.

    python examples/torch_06_live_mutation.py               # on the card
    python examples/torch_06_live_mutation.py --device cpu  # float64, CPU
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from arrowspace_torch import ArrowIndex, init


def device_and_dtype():
    """--device (cuda by default); the CPU runs float64, the card
    float32."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args().device)
    return dev, torch.float64 if dev.type == "cpu" else torch.float32


def main():
    init()
    device, dtype = device_and_dtype()
    rng = np.random.default_rng(11)
    n, f = 20_000, 64
    centers = rng.uniform(0.2, 0.8, (32, f))
    rows = centers[rng.integers(0, 32, n)] + rng.normal(0, 0.1, (n, f))

    t0 = time.time()
    idx = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=3,
                           device=device, dtype=dtype)
    print(f"build: {idx.nitems} items in {time.time() - t0:.2f}s")

    live = idx.make_live_session(batch_size=64, k=10, alpha=0.9,
                                 capacity=32_000)
    live.warmup()
    print(f"live session: capacity {live.capacity} "
          f"(kernel={live.kernel}), n={live.nitems}")

    fresh = centers[rng.integers(0, 32, 500)] + rng.normal(
        0, 0.1, (500, f))
    t0 = time.time()
    ids = live.add(fresh)
    print(f"add 500 rows: {time.time() - t0:.3f}s "
          f"(ids {ids[0]}..{ids[-1]}, n={live.nitems})")

    _s, got = live.search(fresh[:4] * 1.01)
    assert all(got[i][0] == ids[i] for i in range(4))
    print("new rows rank first for their own perturbations")

    target = fresh[100] * -1.0 + 1.0
    live.update([int(ids[100])], target[None])
    _, got = live.search(target * 1.005)
    assert got[0][0] == ids[100]
    print("updated row found at its new location")

    doomed = [int(ids[0]), 17, 4242]
    live.delete(doomed)
    _, got = live.search(np.concatenate([fresh[:2], rows[:2]]) * 1.01)
    assert not set(doomed) & set(got.ravel().tolist())
    print(f"deleted {doomed}; n={live.nitems}, ids stable for survivors")

    snap, ext_ids = live.to_index()
    print(f"snapshot: {snap.nitems} rows; row j carries external id "
          f"ext_ids[j] (e.g. ext_ids[0]={ext_ids[0]})")


if __name__ == "__main__":
    main()
