"""Hypergraph clique-expansion overlays and λτ-graph ensembles.

PyTorch counterpart of ``arrowspace_tpu.hypergraph``.  The reference
documents these capabilities (README.md:112-113, graph.rs:142 "Ensembles
vary λτ-graph parameters (k, eps) and/or overlay hypergraph operations")
but ships no implementation; the JAX package supplies one and this
module carries it across:

- clique expansion: each hyperedge S with weight w contributes
  w/(|S|-1) to every unordered pair in S, accumulated into a dense
  adjacency overlay (numpy, as in the JAX package);
- Laplacian overlay: L' = L + mix·(D_h - A_h), still a Laplacian (row
  sums 0, PSD as a sum of PSD matrices);
- ensembles: several λτ graphs with perturbed (k, eps), one λ vector
  each, a query scored against every variant and the rankings fused by
  mean score.

τ is selected once per build (select_tau_batch: K4 on its gate) and
shared by the variants; each variant's λ is plain PyTorch, as the JAX
package's is plain XLA.  ``ensemble_topk_batch`` is a plain chunked
scan: one product and V λ planes a chunk, merged into the running top-k
with the stable two-key sort, so ties go to the lowest global id.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import GraphLaplacian, GraphParams
from .utils.log import get_logger
from .utils.profiling import annotate

logger = get_logger("arrowspace.hypergraph")

__all__ = ["clique_expansion_adjacency", "overlay_laplacian",
           "ensemble_params", "ensemble_search",
           "build_ensemble", "ensemble_search_prebuilt",
           "ensemble_query_lambdas", "ensemble_topk_batch"]


def clique_expansion_adjacency(
    hyperedges: Sequence[Sequence[int]],
    n_nodes: int,
    weights: Optional[Sequence[float]] = None,
    normalized: bool = False,
) -> np.ndarray:
    """Dense clique-expansion adjacency.

    Standard variant: hyperedge S adds w/(|S|-1) to every pair in S.
    Normalized variant (README.md:112 "normalized variant"): the full
    expanded adjacency is degree-normalized D^{-1/2} A D^{-1/2}, so large
    hyperedges cannot dominate the overlay.
    Hyperedges with fewer than 2 nodes are ignored."""
    adj = np.zeros((n_nodes, n_nodes))
    if weights is None:
        weights = [1.0] * len(hyperedges)
    for edge, w in zip(hyperedges, weights):
        edge = sorted(set(int(v) for v in edge))
        if len(edge) < 2:
            continue
        share = w / (len(edge) - 1)
        idx = np.asarray(edge)
        adj[np.ix_(idx, idx)] += share
    np.fill_diagonal(adj, 0.0)
    if normalized:
        deg = adj.sum(axis=1)
        inv_sqrt = np.where(deg > 0.0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)),
                            0.0)
        adj = adj * inv_sqrt[:, None] * inv_sqrt[None, :]
    return adj


def overlay_laplacian(gl: GraphLaplacian, hyper_adj,
                      mix: float = 1.0) -> GraphLaplacian:
    """L' = L + mix·(D_h - A_h): overlay the clique-expanded hypergraph on
    an existing λτ-graph Laplacian, on its device in its dtype."""
    a = torch.as_tensor(np.asarray(hyper_adj, dtype=np.float64)).to(
        device=gl.matrix.device, dtype=gl.matrix.dtype)
    assert a.shape == gl.matrix.shape, (
        f"overlay shape {tuple(a.shape)} != laplacian shape "
        f"{tuple(gl.matrix.shape)}")
    l_h = torch.diag(a.sum(dim=1)) - a
    new_matrix = gl.matrix + mix * l_h
    offdiag = new_matrix - torch.diag(torch.diagonal(new_matrix))
    nnz = int(new_matrix.shape[0]) + int((offdiag != 0).sum())
    out = dataclasses.replace(gl, matrix=new_matrix, structural_nnz=nnz)
    logger.info("Hypergraph overlay applied: mix=%.3f, nnz %d -> %d",
                mix, gl.nnz(), nnz)
    return out


def ensemble_params(base: GraphParams,
                    k_adjust: Sequence[int] = (-1, 0, 1),
                    eps_expand: Sequence[float] = (1.0, 1.5),
                    ) -> List[GraphParams]:
    """Parameter grid for λτ-graph ensembles (k-adjust, ε-expand).

    k_adjust shifts BOTH `k` and `topk`: the adjacency is built from
    top-(topk+1) cosine neighbours (laplacian.py, mirroring the
    reference's CosinePair at laplacian.rs:211) while `k` never touches
    it, so adjusting `k` alone gives bitwise-identical variant graphs
    whenever eps_expand is 1.0 (an ensemble λ spread of exactly 0, and
    every fused ranking equal to the single graph's)."""
    out = []
    for dk in k_adjust:
        for fe in eps_expand:
            k = max(base.k + dk, 1)
            out.append(dataclasses.replace(
                base, k=k, eps=base.eps * fe,
                topk=max(base.topk + dk, 1)))
    return out


def build_ensemble(aspace, centroids,
                   params_list: Sequence[GraphParams]
                   ) -> List[Tuple[GraphLaplacian, torch.Tensor]]:
    """Build the per-variant index state once: one λτ graph and one λ
    vector per parameter set, on the index's device in its dtype.  τ is
    data-only, so it is selected once (select_tau_batch, K4 on its gate)
    and shared by the variants.  Returns a list of (GraphLaplacian,
    lambdas)."""
    from .laplacian import build_laplacian_matrix
    from .taumode import select_tau_batch, synthetic_lambda_batch

    dev, dt = aspace.device, aspace.dtype
    cent = torch.as_tensor(np.asarray(centroids, dtype=np.float64)) \
        if not torch.is_tensor(centroids) else centroids
    taus = select_tau_batch(aspace.data, aspace.taumode)
    out = []
    for params in params_list:
        gl = build_laplacian_matrix(cent.T, params, n_items=aspace.nitems,
                                    device=dev, dtype=dt)
        lambdas = synthetic_lambda_batch(aspace.data, gl.matrix.to(dt), taus)
        out.append((gl, lambdas))
    return out


def ensemble_search_prebuilt(
    aspace,
    ensemble,               # list of (GraphLaplacian, lambdas)
    query,
    k: int,
    alpha: float,
) -> List[Tuple[int, float]]:
    """Score a query against prebuilt ensemble state and fuse by mean
    score.  Per-variant λ vectors are index state: build them once with
    build_ensemble and reuse them across queries.

    The projected query (a dims-reduced index) prepares τ and λ only; the
    cosine term scores the raw query against the raw (N, F) items, as
    ArrowIndex.search does."""
    from .ops.search import exact_topk, shifted_lambda_plane
    from .taumode import select_tau, synthetic_lambda_single

    query = np.asarray(query, dtype=np.float64)
    dev, dt = aspace.device, aspace.dtype
    q_prep = aspace.project_query(query) if aspace.projection_matrix \
        is not None else query
    tau = select_tau(q_prep, aspace.taumode)
    qdev = torch.as_tensor(query).to(device=dev, dtype=dt)[None, :]

    total = torch.zeros((aspace.nitems,), device=dev, dtype=dt)
    for gl, lambdas in ensemble:
        qlam = synthetic_lambda_single(q_prep, gl.matrix.to(dt), tau)
        ql = torch.tensor([qlam], device=dev, dtype=dt)
        plane, c1 = shifted_lambda_plane(qdev, ql, aspace.data, lambdas,
                                         alpha)
        total = total + (plane[0] + c1)

    total = total / len(ensemble)
    k_eff = min(k, aspace.nitems)
    top_s, top_i = exact_topk(total[None, :], k_eff)
    return [(int(i), float(s)) for i, s in
            zip(top_i[0].tolist(), top_s[0].tolist())]


def ensemble_query_lambdas(queries: torch.Tensor, ensemble,
                           taumode) -> torch.Tensor:
    """Per-variant query-λ preparation for ensemble_topk_batch: (B, F)
    queries -> (V, B) λ against each variant's Laplacian (the batched
    form of ensemble_search_prebuilt's per-variant preparation;
    graph.rs:142 + core.rs:533-549), τ selected once for the batch."""
    from .taumode import select_tau_batch, synthetic_lambda_batch
    dt = queries.dtype
    taus = select_tau_batch(queries, taumode)
    return torch.stack([
        synthetic_lambda_batch(queries, g.matrix.to(device=queries.device,
                                                    dtype=dt), taus)
        for g, _ in ensemble])


def ensemble_topk_batch(queries, qlams, items, item_lambdas_v, alpha, *,
                        k: int, chunk: int = 65536):
    """Batched MEAN-SCORE ensemble fusion at corpus scale.

    queries (B, F) raw; qlams (V, B) per-variant query λ
    (ensemble_query_lambdas); item_lambdas_v (V, N) the per-variant λ
    vectors of build_ensemble.  The fused score is
    ensemble_search_prebuilt's mean over variants of
    α·cos + (1−α)·(1 − min(|Δλ_v|, 1)), reassociated so the corpus is
    read once for the whole ensemble: the cosine term does not depend on
    the variant, so the score is α·cos + (1−α)·(1 − mean_v min(|Δλ_v|, 1))
    and each chunk of ``chunk`` rows costs one product and V λ planes.
    Each chunk's top-k is merged into the running top-k by the stable
    two-key sort on (−score, global id), so ties go to the lowest global
    id (the selection runs in a profiler range,
    "arrowspace::ensemble_select").  Returns (scores (B, k), ids (B, k)
    int64) on the queries' device."""
    from .ops.search import dot_plane, exact_topk, safe_unit, two_key_topk

    b = queries.shape[0]
    v = qlams.shape[0]
    n = items.shape[0]
    dt = queries.dtype
    a = torch.tensor(float(alpha), dtype=dt)
    c1 = 1.0 - a
    k_eff = min(k, n)
    qhat = safe_unit(queries) * a
    qlams = qlams.to(dt)
    run_s = run_i = None
    for c0 in range(0, n, chunk):
        xb = items[c0:c0 + chunk]
        lb = item_lambdas_v[:, c0:c0 + chunk].to(dt)
        cos = dot_plane(qhat, safe_unit(xb))                 # (B, C)
        dl = torch.zeros_like(cos)
        for j in range(v):                                   # V is tiny
            dl = dl + (qlams[j][:, None] - lb[j][None, :]).abs() \
                .clamp_max(1.0)
        sc = cos + c1 * (1.0 - dl / v)
        with annotate("arrowspace::ensemble_select"):
            s, i = exact_topk(sc, min(k_eff, sc.shape[1]))
            i = i + c0
            if run_s is not None:
                s, i = two_key_topk(torch.cat([run_s, s], dim=1),
                                    torch.cat([run_i, i], dim=1), k_eff)
        run_s, run_i = s, i
    if run_s is None:
        return (queries.new_zeros((b, 0)),
                torch.zeros((b, 0), dtype=torch.int64,
                            device=queries.device))
    return run_s, run_i


def ensemble_search(
    aspace,
    centroids,
    query,
    params_list: Sequence[GraphParams],
    k: int,
    alpha: float,
) -> List[Tuple[int, float]]:
    """Convenience one-shot: build_ensemble + ensemble_search_prebuilt."""
    ensemble = build_ensemble(aspace, centroids, params_list)
    return ensemble_search_prebuilt(aspace, ensemble, query, k, alpha)
