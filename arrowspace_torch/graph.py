"""Graph Laplacian container and factory.

PyTorch counterpart of ``arrowspace_tpu.graph`` (reference:
graph.rs:94-743).  The canonical λτ-graph is built over the rows of a
transposed centroid matrix, i.e. the F′ feature signals, so it is a small
dense (F′×F′) tensor on the index's device.  ``structural_nnz`` tracks
the stored-entry count of the equivalent CSR (graph.rs:566-578).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .utils.log import get_logger

logger = get_logger("arrowspace.graph")

__all__ = ["GraphParams", "GraphLaplacian", "GraphFactory"]


@dataclass
class GraphParams:
    """λτ-graph construction parameters (reference: graph.rs:94-102)."""

    eps: float            # maximum rectified cosine distance
    k: int                # max number of neighbours per node
    topk: int             # number of closest-neighbour results considered
    p: float              # kernel exponent
    sigma: Optional[float]  # kernel scale (None -> 1.0 inside the builder)
    normalise: bool       # standard-scale columns before the build
    sparsity_check: bool  # fail if the Laplacian is >95% sparse

    def __eq__(self, other) -> bool:
        # Approximate float equality, exact ints/bools (graph.rs:105-119).
        if not isinstance(other, GraphParams):
            return NotImplemented

        def releq(a, b):
            return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)
        sig_eq = (self.sigma is None and other.sigma is None) or (
            self.sigma is not None and other.sigma is not None
            and releq(self.sigma, other.sigma))
        return (self.k == other.k and releq(self.eps, other.eps)
                and releq(self.p, other.p) and sig_eq
                and self.normalise == other.normalise)


@dataclass
class GraphLaplacian:
    """Dense graph Laplacian L = D - A (reference: graph.rs:126-135).

    matrix         : (n, n) tensor on the index's device.
    init_data      : the matrix the graph was built from (post-scaling).
    nnodes         : number of nodes of the original raw data (N), which
                     is generally NOT the matrix dimension (the F′×F′
                     quirk, graph.rs:172).
    structural_nnz : stored-entry count of the equivalent CSR.
    """

    init_data: torch.Tensor
    matrix: torch.Tensor
    nnodes: int
    graph_params: GraphParams
    structural_nnz: int = 0

    def shape(self):
        return tuple(self.matrix.shape)

    def nnz(self) -> int:
        return self.structural_nnz

    @staticmethod
    def sparsity(matrix, structural_nnz: int) -> float:
        """1 - nnz/total (reference: graph.rs:572-578)."""
        rows, cols = matrix.shape
        total = rows * cols
        return 1.0 - structural_nnz / total if total else 1.0

    def degrees(self) -> np.ndarray:
        """Diagonal entries; entries past the matrix dimension read as 0
        (graph.rs:324-345)."""
        n = self.matrix.shape[0]
        out = np.zeros(max(self.nnodes, n))
        out[:n] = torch.diagonal(self.matrix).double().cpu().numpy()
        return out


class GraphFactory:
    """Construction of the λτ-graph from data (reference:
    graph.rs:143-271)."""

    @staticmethod
    def build_laplacian_matrix_from_k_cluster(
        clustered,            # X×F centroid matrix (numpy or tensor)
        eps: float,
        k: int,
        topk: int,
        p: float,
        sigma_override: Optional[float],
        normalise: bool,
        sparsity_check: bool,
        n_items: int,
        *,
        device=None,
        dtype=None,
    ) -> GraphLaplacian:
        """Transpose the centroid matrix and build the λτ-graph over the F′
        feature rows (reference: graph.rs:149-204).  The result is an F′×F′
        matrix with nnodes == n_items (original N)."""
        from .laplacian import build_laplacian_matrix

        if not isinstance(clustered, torch.Tensor):
            clustered = torch.as_tensor(np.asarray(clustered,
                                                   dtype=np.float64))
        assert clustered.shape[0] <= n_items
        params = GraphParams(eps=eps, k=k, topk=topk, p=p,
                             sigma=sigma_override, normalise=normalise,
                             sparsity_check=sparsity_check)
        result = build_laplacian_matrix(clustered.T, params, n_items=n_items,
                                        device=device, dtype=dtype)
        if sparsity_check:
            sp = GraphLaplacian.sparsity(result.matrix, result.structural_nnz)
            if sp > 0.95:
                raise ValueError(
                    f"Resulting laplacian matrix is too sparse {sp}")
        logger.info(
            "Laplacian matrix built: %dx%d with %d nodes, %d non-zeros",
            result.matrix.shape[0], result.matrix.shape[1],
            result.nnodes, result.nnz())
        return result
