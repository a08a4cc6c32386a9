"""SF-GRASS-lite spectral sparsifier.

The PyTorch port's own copy of ``arrowspace_tpu.sparsification`` (numpy
only; importing the JAX package would import JAX).  Port of the
reference's sparsification module (reference:
sparsification.rs:14-120).  Note: the reference never calls this from
library code (only its test exercises it — see SURVEY.md §2 "dead code");
it is provided here for capability parity and as an optional edge-pruning
pass over dense adjacency matrices.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .utils.log import get_logger

logger = get_logger("arrowspace.sparsification")

__all__ = ["SfGrassSparsifier"]


class SfGrassSparsifier:
    """Degree-based spectral edge pruning (sparsification.rs:14-113)."""

    def __init__(self):
        self.target_ratio = 0.5

    def with_target_ratio(self, ratio: float) -> "SfGrassSparsifier":
        self.target_ratio = min(max(ratio, 0.1), 1.0)
        return self

    def sparsify_graph(self, adj_rows: List[List[Tuple[int, float]]],
                       n_nodes: int) -> List[List[Tuple[int, float]]]:
        """Keep the top target_ratio edges per node by w·√(deg_i·deg_j);
        skip entirely if avg degree < 10."""
        orig_edges = sum(len(r) for r in adj_rows)
        avg_degree = orig_edges / n_nodes if n_nodes else 0.0
        if avg_degree < 10.0:
            logger.info("SF-GRASS: Graph already sparse (avg degree %.1f), "
                        "skipping", avg_degree)
            return [list(r) for r in adj_rows]

        degrees = [len(r) for r in adj_rows]
        out: List[List[Tuple[int, float]]] = []
        for i, neighbors in enumerate(adj_rows):
            if not neighbors:
                out.append([])
                continue
            scored = [(j, w, w * np.sqrt(degrees[i] * degrees[j]))
                      for j, w in neighbors]
            scored.sort(key=lambda t: -t[2])
            keep = min(max(int(np.ceil(len(neighbors) * self.target_ratio)),
                           1), len(neighbors))
            out.append([(j, w) for j, w, _ in scored[:keep]])

        sparse_edges = sum(len(r) for r in out)
        logger.info("SF-GRASS: %d -> %d edges (%.1f%% reduction)",
                    orig_edges, sparse_edges,
                    100.0 * (1.0 - sparse_edges / orig_edges))
        return out

    def sparsify_dense(self, adj: np.ndarray) -> np.ndarray:
        """Convenience wrapper over a dense adjacency matrix."""
        n = adj.shape[0]
        rows = [[(int(j), float(adj[i, j])) for j in np.nonzero(adj[i])[0]]
                for i in range(n)]
        pruned = self.sparsify_graph(rows, n)
        out = np.zeros_like(adj)
        for i, row in enumerate(pruned):
            for j, w in row:
                out[i, j] = w
        return out
