"""EigenMaps: the staged build pipeline as explicit, composable stages.

PyTorch counterpart of ``arrowspace_tpu.eigenmaps`` (reference:
eigenmaps.rs:93-456):

1. start_clustering — optimal-K heuristic + incremental clustering (the
   native scan when seeded, the chunked scan when not; a large corpus
   runs its Two-NN tiles and the chunked scan's distances on the index's
   tensor) + optional JL projection of the centroids;
2. eigenmaps        — feature-graph Laplacian from the centroids, and
   with ``with_spectral`` the signals graph (its Laplacian's Laplacian);
3. compute_taumode  — batched λτ on the index device;
4. search           — λ-aware search with query preparation.

Each stage is also attached to ArrowSpace, as the reference's trait
impl is (eigenmaps.py:193-197 of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

import torch

from . import clustering
from .core import ArrowItem, ArrowSpace
from .graph import GraphFactory, GraphLaplacian
from .reduction import ImplicitProjection, compute_jl_dimension
from .sampling import SamplerType
from .taumode import compute_taumode_lambdas
from .utils.log import get_logger
from .utils.profiling import span

logger = get_logger("arrowspace.eigenmaps")

__all__ = ["ClusteredOutput", "start_clustering", "eigenmaps",
           "compute_taumode", "search"]


@dataclass
class ClusteredOutput:
    """Output of the clustering stage (reference: eigenmaps.rs:75-87)."""
    aspace: ArrowSpace
    centroids: np.ndarray    # X × F′ (F′ = reduced_dim when projected)
    reduced_dim: int
    n_items: int
    n_features: int


def start_clustering(builder, rows) -> ClusteredOutput:
    """Stage 1 (reference: eigenmaps.rs:175-290)."""
    rows_arr = np.asarray(rows, dtype=np.float64)
    n_items, n_features = rows_arr.shape
    logger.info("EigenMaps::start_clustering: N=%d items, F=%d features",
                n_items, n_features)

    aspace = ArrowSpace.new(rows_arr, builder.synthesis,
                            device=builder.device, dtype=builder.dtype)
    # seeded builds thread the clustering seed through the sampler
    sampler_type = builder.sampling if builder.sampling is not None \
        else SamplerType.simple(1.0)
    sampler = sampler_type.make(seed=builder.clustering_seed)

    # host seconds of the clustering steps, for the build's breakdown
    cs = builder.clustering_seconds = {}
    with span("clustering.optimal_k") as optimal_k:
        k_opt, radius, intrinsic_dim = clustering.compute_optimal_k(
            rows_arr, n_items, n_features, builder.clustering_seed,
            device_data=aspace.data, seconds=cs)
    cs["optimal_k"] = optimal_k.seconds
    logger.debug("Optimal clustering: K=%d, radius=%.6f, intrinsic_dim=%d",
                 k_opt, radius, intrinsic_dim)
    builder.cluster_max_clusters = k_opt
    builder.cluster_radius = radius

    with span("clustering.scan") as scan:
        centroids, assignments, sizes = \
            clustering.run_incremental_clustering_with_sampling(
                builder, rows_arr, n_features, k_opt, radius, sampler,
                device_data=aspace.data)
    cs["scan"] = scan.seconds
    assign_arr = assignments.array
    logger.info("Clustering complete: %d centroids, %d items assigned",
                centroids.shape[0], int((assign_arr >= 0).sum()))

    aspace.n_clusters = centroids.shape[0]
    aspace.cluster_assignments = assign_arr
    aspace.cluster_sizes = np.asarray(sizes, dtype=np.int64)
    aspace.cluster_radius = radius

    # Optional JL projection (eigenmaps.rs:248-280): enabled and F > 64,
    # target = min(jl_dim, F/2).  The centroids are projected in the
    # index dtype on the index device, as the JAX package does.
    reduced_dim = n_features
    if builder.use_dims_reduction and n_features > 64:
        jl_dim = compute_jl_dimension(centroids.shape[0], builder.rp_eps)
        target_dim = min(jl_dim, n_features // 2)
        if target_dim < n_features:
            logger.info("Applying JL projection: %d features -> %d dims "
                        "(eps=%.2f)", n_features, target_dim,
                        builder.rp_eps)
            proj = ImplicitProjection(
                n_features, target_dim,
                **({"seed": builder.clustering_seed}
                   if builder.clustering_seed is not None else {}))
            cent = torch.as_tensor(np.asarray(centroids)).to(
                device=aspace.device, dtype=aspace.dtype)
            centroids = proj.project_device(cent).double().cpu().numpy()
            aspace.projection_matrix = proj
            aspace.reduced_dim = target_dim
            reduced_dim = target_dim
    return ClusteredOutput(aspace=aspace, centroids=centroids,
                           reduced_dim=reduced_dim, n_items=n_items,
                           n_features=n_features)


def eigenmaps(aspace: ArrowSpace, builder, centroids,
              n_items: int) -> GraphLaplacian:
    """Stage 2: feature-graph Laplacian from the clustered centroids
    (reference: eigenmaps.rs:292-356), then, when the builder asks for
    it, the signals graph in ``aspace.signals`` (eigenmaps.py:145-146 of
    the JAX package)."""
    n_centroids, n_features = np.shape(centroids)
    logger.info("EigenMaps::eigenmaps: %d centroids x %d features",
                n_centroids, n_features)
    gl = GraphFactory.build_laplacian_matrix_from_k_cluster(
        centroids, builder.lambda_eps, builder.lambda_k,
        builder.lambda_topk, builder.lambda_p, builder.lambda_sigma,
        builder.normalise, builder.sparsity_check, n_items,
        device=aspace.device, dtype=aspace.dtype)
    if builder.prebuilt_spectral:
        GraphFactory.build_spectral_laplacian(aspace, gl)
    return gl


def compute_taumode(aspace: ArrowSpace, gl: GraphLaplacian) -> None:
    """Stage 3: batched λτ (reference: eigenmaps.rs:358-383), against the
    signals graph where it is set (ArrowSpace.lambda_graph)."""
    aspace.lambdas = compute_taumode_lambdas(
        aspace.data, aspace.lambda_graph(gl), aspace.taumode,
        pad_items=aspace.pad_tall_graphs)
    aspace._lambda_order = None      # the sorted λ-band index


def search(aspace: ArrowSpace, item, gl: GraphLaplacian, k: int,
           alpha: float) -> List[Tuple[int, float]]:
    """Stage 5: λ-aware search with query preparation (reference:
    eigenmaps.rs:410-455).  Like the reference, the projected query is
    handed to search_lambda_aware, which needs the projected width to
    equal the stored item width."""
    q_lambda = aspace.prepare_query_item(item, gl)
    q = ArrowItem(aspace.project_query(item), q_lambda)
    return aspace.search_lambda_aware(q, k, alpha)


# The staged API on ArrowSpace, as the reference's trait impl.
ArrowSpace.start_clustering = staticmethod(start_clustering)
ArrowSpace.eigenmaps = eigenmaps
ArrowSpace.compute_taumode = compute_taumode
ArrowSpace.search = search
