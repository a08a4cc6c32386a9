"""Low-latency exact serving with the cell-screened (pruned) session on
arrowspace_torch (the flow of 08_pruned_lowlat.py).

The corpus is grouped into cells of at most ``cap`` rows with
spherical-cap bounds on their scores; a query scores only the cells
whose bound can reach its top-k, and a query the bounds cannot certify
re-runs through the full scan, so every returned row equals the full
scan's.  auto_budget=True widens the screen while the flag rate of a
full window of queries stays high.

    python examples/torch_08_pruned_lowlat.py               # on the card
    python examples/torch_08_pruned_lowlat.py --device cpu  # float64, CPU
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


def main() -> None:
    init()
    device, dtype = device_and_dtype()
    rng = np.random.default_rng(3)
    n, f, centers = 60_000, 64, 48
    cents = rng.uniform(0.2, 0.8, (centers, f))
    rows = cents[rng.integers(0, centers, n)] \
        + rng.normal(0, 0.03, (n, f))

    t0 = time.time()
    idx = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11,
                           device=device, dtype=dtype)
    print(f"index build {n}x{f}: {time.time() - t0:.1f}s")

    sess = idx.make_pruned_session(batch_size=16, k=10, alpha=0.9,
                                   cap=128, auto_budget=True)
    sess.warmup()

    for step in range(4):
        queries = rows[rng.integers(0, n, 16)] * 1.01
        t0 = time.time()
        sess.search(queries)
        dt = time.time() - t0
        print(f"batch {step}: {dt * 1e3:6.1f} ms  "
              f"(certified so far: "
              f"{1.0 - sess.flag_rate:.2%} of {sess.queries_total})")

    queries = rows[rng.integers(0, n, 16)] * 1.01
    _sp, ip = sess.search(queries)
    _so, io = idx.search(queries, k=10, alpha=0.9)
    agree = sum(1 for b in range(16) if list(ip[b]) == list(io[b]))
    print(f"session vs full search: {agree}/16 identical id lists")
    assert agree == 16

    adv = rng.normal(size=(16, f))
    sess.search(adv)
    print(f"after an adversarial batch: flag rate {sess.flag_rate:.2%}, "
          f"budget growths {sess.budget_growths} (auto_budget widens the "
          f"screen only if the drift persists)")


if __name__ == "__main__":
    main()
