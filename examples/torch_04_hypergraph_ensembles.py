"""Hypergraph clique-expansion overlay and λτ-graph ensembles on
arrowspace_torch (the flow of 04_hypergraph_ensembles.py), through the
staged pipeline: start_clustering, eigenmaps, compute_taumode.

    python examples/torch_04_hypergraph_ensembles.py               # card
    python examples/torch_04_hypergraph_ensembles.py --device cpu  # CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import torch

from arrowspace_torch import ArrowItem, ArrowSpaceBuilder, init
from arrowspace_torch import eigenmaps as em
from arrowspace_torch.hypergraph import (clique_expansion_adjacency,
                                         ensemble_params, ensemble_search,
                                         overlay_laplacian)
from data import make_moons_hd  # noqa: E402


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
    rows = make_moons_hd(120, noise=0.08, hd_noise=0.04, dims=16, seed=3)
    q = rows[33] * 1.02

    b = (ArrowSpaceBuilder(device=device, dtype=dtype)
         .with_lambda_graph(1.0, 5, 3, 2.0, None)
         .with_seed(13))
    b.define_result_k()
    clustered = em.start_clustering(b, rows.tolist())
    aspace = clustered.aspace
    gl = em.eigenmaps(aspace, b, clustered.centroids, clustered.n_items)
    em.compute_taumode(aspace, gl)

    qlam = aspace.prepare_query_item(q, gl)
    base = aspace.search_lambda_aware(ArrowItem(q, qlam), 10, 0.9)
    print("base λ-aware top-10:", [i for i, _ in base])

    n = gl.shape()[0]
    hyper = clique_expansion_adjacency([[0, 1, 2, 3], [4, 5, 6]], n,
                                       weights=[1.0, 0.5])
    gl_overlaid = overlay_laplacian(gl, hyper, mix=0.3)
    em.compute_taumode(aspace, gl_overlaid)
    qlam2 = aspace.prepare_query_item(q, gl_overlaid)
    overlaid = aspace.search_lambda_aware(ArrowItem(q, qlam2), 10, 0.9)
    print("overlay  top-10:", [i for i, _ in overlaid])

    grid = ensemble_params(gl.graph_params, k_adjust=(-1, 0, 1),
                           eps_expand=(1.0, 1.5))
    fused = ensemble_search(aspace, clustered.centroids, q, grid, 10, 0.9)
    print(f"ensemble ({len(grid)} graphs) top-10:", [i for i, _ in fused])
    assert fused[0][0] == 33


if __name__ == "__main__":
    main()
