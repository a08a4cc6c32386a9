"""Graph / λ / search quality metrics.

Port of the example-side quality metrics (reference:
examples/common/lib.rs:190-447) — connectivity ratio, λ-distribution
quality, edge-count efficiency, search effectiveness, and the weighted
quality combinations used by the examples for parameter exploration.
The port's own copy of ``arrowspace_tpu.utils.quality``: the numpy
metrics are the same code, and the search score runs on the port's
plain λ-aware plane.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "graph_connectivity_ratio", "lambda_distribution_quality",
    "edge_count_efficiency", "search_effectiveness_score",
    "evaluate_graph_quality", "evaluate_parameter_quality",
    "jaccard_similarity",
]


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array as a host array."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _count_edges(matrix) -> int:
    """Negative off-diagonal entries / 2 (symmetric Laplacian edges)."""
    m = _host(matrix)
    off = m.copy()
    np.fill_diagonal(off, 0.0)
    return int((off < 0.0).sum()) // 2


def graph_connectivity_ratio(matrix) -> float:
    """Edges relative to the spanning-tree minimum, scaled by 0.95 and
    capped at 1 (lib.rs:193-228)."""
    m = _host(matrix)
    nrows, ncols = m.shape
    if nrows != ncols or nrows <= 1:
        return 1.0 if nrows <= 1 else 0.0
    total_edges = _count_edges(m)
    max_possible = nrows * (nrows - 1) // 2
    if max_possible == 0:
        return 1.0
    min_connectivity_edges = nrows - 1
    ratio = total_edges / min_connectivity_edges
    return min(ratio * 0.95, 1.0)


def lambda_distribution_quality(lambdas) -> float:
    """0.4·spread + 0.6·in-[0,1]-range quality (lib.rs:231-269)."""
    lam = np.asarray(_host(lambdas), dtype=np.float64)
    if lam.size == 0:
        return 0.0
    valid = lam[np.isfinite(lam) & (lam >= 0.0)]
    if valid.size == 0:
        return 0.0
    mean = float(valid.mean())
    std = float(valid.std())
    spread_quality = min(std / (mean + 1e-6), 1.0) if std > 1e-6 else 0.1
    in_range = float(((valid >= 0.0) & (valid <= 1.0)).mean())
    return 0.4 * spread_quality + 0.6 * in_range


def edge_count_efficiency(adjacency_matrix) -> float:
    """Sparse-but-connected score (lib.rs:272-311)."""
    m = _host(adjacency_matrix)
    nrows, ncols = m.shape
    if nrows != ncols or nrows <= 1:
        return 1.0 if nrows <= 1 else 0.0
    total_edges = _count_edges(m)
    min_edges = nrows - 1
    max_reasonable = min(nrows * 6, nrows * (nrows - 1) // 2)
    if total_edges < min_edges:
        return total_edges / min_edges * 0.3
    if total_edges <= max_reasonable:
        sparsity_score = 1.0 - (total_edges - min_edges) / max(
            max_reasonable - min_edges, 1)
    else:
        sparsity_score = 0.1
    return 0.7 + 0.3 * sparsity_score


def search_effectiveness_score(aspace, queries: Sequence[Sequence[float]],
                               alpha: float, beta: float, k: int) -> float:
    """Result-quality heuristic over test queries (lib.rs:324-393).
    Note: like the reference, the query λ is left at 0 here — this probes
    scoring shape, not λ correctness — so the query is scored directly."""
    import torch

    from ..ops.search import shifted_lambda_plane, two_key_topk

    if not len(queries):
        return 0.5
    total = 0.0
    valid = 0
    data, lam = aspace.data, aspace.lambdas
    ids = torch.arange(aspace.nitems, device=data.device)[None, :]
    for query in queries:
        q = np.asarray(query, dtype=np.float64)
        if q.shape[0] != aspace.nfeatures:
            continue
        qt = torch.as_tensor(q).to(device=data.device, dtype=data.dtype)
        plane, c1 = shifted_lambda_plane(
            qt[None], torch.zeros(1, device=data.device, dtype=data.dtype),
            data, lam, alpha)
        top, _ = two_key_topk(plane + c1, ids, min(k, aspace.nitems))
        sims = top[0].double().cpu().numpy()
        if sims.size == 0:
            continue
        quality = 0.0
        avg = float(sims.mean())
        if 0.1 < avg <= 1.0:
            quality += 0.5
        if sims.size > 1 and float(((sims - avg) ** 2).mean()) > 1e-6:
            quality += 0.3
        if (1.0 - alpha) > 0.0:
            quality += 0.2
        total += quality
        valid += 1
    return total / valid if valid else 0.5


def evaluate_graph_quality(aspace, gl) -> float:
    """0.4·connectivity + 0.3·λ-quality + 0.3·edge-efficiency
    (lib.rs:396-403)."""
    return (0.4 * graph_connectivity_ratio(gl.matrix)
            + 0.3 * lambda_distribution_quality(_host(aspace.lambdas))
            + 0.3 * edge_count_efficiency(gl.matrix))


def evaluate_parameter_quality(aspace, gl, queries, alpha: float,
                               beta: float, k: int) -> float:
    """0.4·connectivity + 0.4·λ-quality + 0.2·search quality
    (lib.rs:405-427)."""
    return (0.4 * graph_connectivity_ratio(gl.matrix)
            + 0.4 * lambda_distribution_quality(_host(aspace.lambdas))
            + 0.2 * search_effectiveness_score(aspace, queries, alpha,
                                               beta, k))


def jaccard_similarity(a: Sequence[int], b: Sequence[int]) -> float:
    """|A∩B| / |A∪B| (lib.rs:543-...)."""
    sa, sb = set(a), set(b)
    union = sa | sb
    return len(sa & sb) / len(union) if union else 1.0
