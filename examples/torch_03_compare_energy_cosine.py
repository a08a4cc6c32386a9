"""Energy-only pipeline vs cosine and λ-aware search on arrowspace_torch
(the flow of 03_compare_energy_cosine.py).

Both builds project the 96 features (JL, with_dims_reduction): the
port's projection comes from torch's generator, the JAX package's from
threefry, so λ and the λ-aware and energy rankings are this package's
own; the cosine baseline is the same numpy computation in both.

    python examples/torch_03_compare_energy_cosine.py               # card
    python examples/torch_03_compare_energy_cosine.py --device cpu  # CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import torch

from arrowspace_torch import ArrowItem, ArrowSpaceBuilder, init
from arrowspace_torch.energymaps import (EnergyParams, build_energy,
                                         search_energy)
from common import cosine_sim
from data import make_gaussian_hd  # noqa: E402


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
    rows = make_gaussian_hd(300, spread=0.5, dims=96, seed=11)
    q = rows[42] * 1.02
    k = 10

    base = sorted(((i, cosine_sim(q, v)) for i, v in enumerate(rows)),
                  key=lambda t: -t[1])[:k]
    base_ids = [i for i, _ in base]
    print("cosine top-10:", base_ids)

    def builder():
        return (ArrowSpaceBuilder(device=device, dtype=dtype)
                .with_lambda_graph(1.0, 5, 3, 2.0, None)
                .with_dims_reduction(True, 1.0)
                .with_seed(5))

    aspace_s, gl_s = builder().build(rows.tolist())
    qlam = aspace_s.prepare_query_item(q, gl_s)
    std = aspace_s.search_lambda_aware(ArrowItem(q, qlam), k, 0.9)
    std_ids = [i for i, _ in std]
    print("λ-aware (α=0.9) top-10:", std_ids)

    aspace_e, gl_e = build_energy(builder(), rows.tolist(), EnergyParams())
    en = search_energy(aspace_e, q, gl_e, k, 1.0, 0.5)
    en_ids = [i for i, _ in en]
    print("energy-only top-10:", en_ids)

    def recall(got):
        return len(set(got) & set(base_ids)) / k

    print(f"recall@{k} vs cosine: λ-aware={recall(std_ids):.2f}, "
          f"energy={recall(en_ids):.2f}")


if __name__ == "__main__":
    main()
