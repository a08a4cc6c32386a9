"""λ-aware search vs plain cosine on arrowspace_torch (the flow of
01_compare_cosine.py).  Top-3+1 cosine results must match the α=1.0
λ-aware search exactly; α<1 mixes spectral evidence in.

    python examples/torch_01_compare_cosine.py               # on the card
    python examples/torch_01_compare_cosine.py --device cpu  # float64, CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from arrowspace_torch import ArrowItem, ArrowSpaceBuilder, init
from common import cosine_sim, protein_like_block


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
    db = protein_like_block()
    ids = [f"P{i:04d}" for i in range(len(db))]
    k = 3
    query = db[3] * 1.02

    base = sorted(((i, cosine_sim(query, v)) for i, v in enumerate(db)),
                  key=lambda t: -t[1])[: k + 1]
    print(f"Baseline cosine top-{k}+1:")
    for rank, (i, s) in enumerate(base):
        print(f"  {rank + 1}. idx={i} ({ids[i]}) score={s:.6f}")

    aspace, gl = (ArrowSpaceBuilder(device=device, dtype=dtype)
                  .with_lambda_graph(1e-3, 20, k, 2.0, 1e-3 * 0.75)
                  .with_normalisation(False)
                  .with_dims_reduction(True, None)
                  .with_seed(42)
                  .build(db.tolist()))
    print(f"\nArrowSpace shape: ({aspace.nitems}, {aspace.nfeatures}) "
          f"on {aspace.device}")

    q = ArrowItem(query, aspace.prepare_query_item(query, gl))

    print("\n--- Test 1: Pure Cosine Similarity (alpha=1.0) ---")
    res_cos = aspace.search_lambda_aware(q, k + 1, 1.0)
    for rank, (i, s) in enumerate(res_cos):
        print(f"  {rank + 1}. idx={i} ({ids[i]}) score={s:.6f}")
    ids_base = [i for i, _ in base]
    ids_arrow = [i for i, _ in res_cos]
    print("Match (baseline vs Arrow cosine):",
          "OK" if ids_base == ids_arrow else "DIFF")
    assert ids_base == ids_arrow

    print("\n--- Test 2: Lambda-Aware Search (alpha=0.9) ---")
    res_lam = aspace.search_lambda_aware(q, k + 5, 0.9)
    for rank, (i, s) in enumerate(res_lam):
        print(f"  {rank + 1}. idx={i} ({ids[i]}) score={s:.6f}")
    s1 = set(ids_base)
    s2 = {i for i, _ in res_lam[: k + 1]}
    print(f"Jaccard(baseline vs λ-aware): {len(s1 & s2) / len(s1 | s2):.3f}")

    print("\n--- Test 3: Alpha Sweep ---")
    for alpha in (0.8, 0.7, 0.6, 0.55, 0.4):
        res = aspace.search_lambda_aware(q, k, alpha)
        print(f"alpha={alpha}: " + ", ".join(
            f"{i}({s:.4f})" for i, s in res))


if __name__ == "__main__":
    main()
