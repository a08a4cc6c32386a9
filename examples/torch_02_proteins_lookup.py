"""λ-band range lookup with a ZSET-style sorted index on arrowspace_torch
(the flow of 02_proteins_lookup.py): O(log N + M) range-by-score on λ,
beside the index's own sorted λ band and the signed range_search.

    python examples/torch_02_proteins_lookup.py               # on the card
    python examples/torch_02_proteins_lookup.py --device cpu  # float64, CPU
"""

import argparse
import bisect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from arrowspace_torch import ArrowItem, ArrowSpaceBuilder, init
from common import load_vectors_3000


def device_and_dtype():
    """--device (cuda by default); the CPU runs float64, the card
    float32."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args().device)
    return dev, torch.float64 if dev.type == "cpu" else torch.float32


class ZSetIndex:
    """Sorted-score index: zadd + range_byscore (the example's BTreeMap
    ZSET, examples/02_proteins_lookup.rs:180-240)."""

    def __init__(self):
        self._entries = []  # sorted list of (score, idx, id)

    def zadd(self, score, idx, id_):
        bisect.insort(self._entries, (score, idx, id_))

    def range_byscore(self, lo, hi, offset=0, limit=None):
        scores = [e[0] for e in self._entries]
        i0 = bisect.bisect_left(scores, lo)
        i1 = bisect.bisect_right(scores, hi)
        out = [(e[1], e[0], e[2]) for e in self._entries[i0:i1]][offset:]
        return out[:limit] if limit is not None else out


def main():
    init()
    device, dtype = device_and_dtype()
    ids, items = load_vectors_3000()
    ids, items = ids[:800], items[:800]

    aspace, gl = (ArrowSpaceBuilder(device=device, dtype=dtype)
                  .with_lambda_graph(0.05, 12, 4, 2.0, 0.025)
                  .with_seed(7)
                  .build(items.tolist()))

    lambdas = aspace.lambdas_list()
    q_index = 3
    print(f"Querying near {ids[q_index]}")

    zset = ZSetIndex()
    for i, id_ in enumerate(ids):
        zset.zadd(float(lambdas[i]), i, id_)

    lambda_q = float(lambdas[q_index])
    band = float(lambdas.std()) / 2.0 ** 2.0
    lo, hi = lambda_q - band, lambda_q + band

    hits = zset.range_byscore(lo, hi, 0, 5)
    print(f"Query λ={lambda_q:.6f}, range [{lo:.6f}, {hi:.6f}] => "
          f"{len(hits)} hits")
    for rank, (idx, score, id_) in enumerate(hits):
        print(f"{rank + 1:2d}. λ={score:.6f} {id_} (idx={idx})")

    # the index's own sorted λ band: the same rows, in the same order
    # wherever λ values are distinct
    band_hits = aspace.range_search_sorted(lo, hi, 5)
    assert [i for i, _ in band_hits] == [idx for idx, _, _ in hits]
    print("range_search_sorted agrees with the ZSET: OK")

    res = aspace.range_search(ArrowItem(items[q_index], lambda_q), gl, band)
    print(f"range_search (signed band) found {len(res)} items")


if __name__ == "__main__":
    main()
