"""A serving loop on arrowspace_torch (the flow of 05_serving.py):
warm the machine, build once, stream batches through a pipelined
SearchSession, and re-rank exactly in float64 where tie order matters.

0. precompile.warm builds the CUDA kernel library (nvcc, once per
   checkout) and the native clustering scan, and launches each engine a
   session of the corpus shape takes, on zero tensors;
1. build an index once;
2. open a SearchSession: query-λ preparation and scoring + top-k per
   batch on the index's device, two batches in flight so the copy of
   batch i's results overlaps batch i+1's kernels;
3. serve a stream of batches;
4. precision="f64_rescore" recovers the float64 tie order;
5. an energy index serves through the same loop (EnergySearchSession).

    python examples/torch_05_serving.py               # on the card
    python examples/torch_05_serving.py --device cpu  # float64, CPU
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
    rng = np.random.default_rng(7)
    n, f = 50_000, 128
    centers = rng.uniform(0.2, 0.8, (64, f))
    rows = centers[rng.integers(0, 64, n)] + rng.normal(0, 0.2, (n, f))

    from arrowspace_torch.precompile import warm
    t0 = time.perf_counter()
    timings = warm(n, f, batch_sizes=(256,), k=10, device=device,
                   dtype=dtype)
    assert all(v >= 0 for v in timings.values()), timings
    print(f"warm for {n}x{f} ({', '.join(timings)}): "
          f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    idx = ArrowIndex.build(rows, eps=1.0, k=6, topk=3, seed=11,
                           device=device, dtype=dtype)
    print(f"build {n}x{f}: {time.perf_counter() - t0:.2f}s, "
          f"{idx.aspace.n_clusters} clusters")

    batch, n_batches = 256, 20
    sess = idx.make_search_session(batch_size=batch, k=10, alpha=0.9,
                                   depth=2)
    sess.warmup()

    batches = [rows[rng.integers(0, n, batch)] * 1.01
               for _ in range(n_batches)]
    t0 = time.perf_counter()
    served = 0
    for _scores, ids in sess.search_stream(batches):
        served += ids.shape[0]
    dt = time.perf_counter() - t0
    print(f"served {served} queries in {dt:.2f}s ({served / dt:.0f} QPS, "
          f"{dt / n_batches * 1e3:.1f} ms/batch pipelined; "
          f"engine {sess.kernel!r})")

    # the session and the one-shot search share query-λ preparation on
    # the device and one engine: the same ids
    _s_ref, i_ref = idx.search(batches[0], k=10, alpha=0.9)
    _s_got, i_got = next(iter(sess.search_stream(batches[:1])))
    assert (i_got == i_ref).all()
    print("pipelined results match one-shot search: OK")

    q = rows[rng.integers(0, n, 8)] * 1.01
    _s64, i64 = idx.search(q, k=10, alpha=1.0, precision="f64_rescore")
    cos = (q @ rows.T) / (np.linalg.norm(q, axis=1)[:, None]
                          * np.linalg.norm(rows, axis=1)[None, :])
    brute = np.argsort(-cos, axis=1, kind="stable")[:, :10]
    assert (i64 == brute).all()
    print("f64_rescore matches the float64 brute-force ranking: OK")

    from arrowspace_torch.energymaps import EnergyParams
    t0 = time.perf_counter()
    # allow_tall_graphs: the diffusion split can mint more sub-centroids
    # than F; the reference panics there, this pads query-λ preparation
    eidx = ArrowIndex.build_energy(rows[:20_000],
                                   EnergyParams(allow_tall_graphs=True),
                                   seed=11, device=device, dtype=dtype)
    print(f"energy build 20000x{f}: {time.perf_counter() - t0:.2f}s")
    esess = eidx.make_energy_session(batch_size=256, k=10,
                                     w_lambda=1.0, w_dirichlet=0.5)
    esess.warmup()
    ebatches = batches[:8]
    t0 = time.perf_counter()
    eserved = sum(ids.shape[0] for _, ids in esess.search_stream(ebatches))
    dt = time.perf_counter() - t0
    _s_e, i_e = next(iter(esess.search_stream(ebatches[:1])))
    _s_ref, i_ref = eidx.search_energy(ebatches[0], k=10)
    assert (i_e[:, 0] == i_ref[:, 0]).all()
    print(f"energy session: {eserved} queries in {dt:.2f}s "
          f"({eserved / dt:.0f} QPS); top-1 matches the one-shot energy "
          f"API: OK")


if __name__ == "__main__":
    main()
