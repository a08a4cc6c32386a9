"""Graph Laplacian container and factory.

PyTorch counterpart of ``arrowspace_tpu.graph`` (reference:
graph.rs:94-743).  The canonical λτ-graph is built over the rows of a
transposed centroid matrix, i.e. the F′ feature signals, so it is a small
dense (F′×F′) tensor on the index's device.  ``structural_nnz`` tracks
the stored-entry count of the equivalent CSR (graph.rs:566-578), and the
reference's CSR operations (get, rows, products, checks, statistics) act
on the dense tensor.  ``nnodes`` is the item count N, which is generally
not the matrix dimension: indices in [dimension, nnodes) read as 0.0,
as the reference's sparse ``get`` returns None there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .utils.log import get_logger

logger = get_logger("arrowspace.graph")

__all__ = ["GraphParams", "GraphLaplacian", "GraphFactory",
           "LaplacianValidation", "LaplacianStats"]


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
class LaplacianValidation:
    """Validation results (reference: graph.rs:659-680)."""
    is_valid: bool = False
    is_symmetric: bool = False
    max_asymmetry: float = 0.0
    max_row_sum_error: float = 0.0
    row_sum_violations: list = field(default_factory=list)
    negative_diagonal: list = field(default_factory=list)


@dataclass
class LaplacianStats:
    """Summary statistics (reference: graph.rs:682-692)."""
    nnodes: int
    nnz: int
    sparsity: float
    min_degree: float
    max_degree: float
    mean_degree: float
    graph_params: GraphParams

    def __str__(self) -> str:
        return (
            "Laplacian Statistics:\n"
            f"  Nodes: {self.nnodes}\n"
            f"  Non-zero entries: {self.nnz} "
            f"({(1.0 - self.sparsity) * 100.0:.2f}% dense)\n"
            f"  Sparsity: {self.sparsity:.4f}\n"
            f"  Degree range: [{self.min_degree:.4f}, {self.max_degree:.4f}]\n"
            f"  Mean degree: {self.mean_degree:.4f}\n"
            f"  Graph parameters: {self.graph_params!r}\n"
        )


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

    def topk(self) -> int:
        return self.graph_params.topk

    def nnz(self) -> int:
        return self.structural_nnz

    def params(self) -> GraphParams:
        return self.graph_params

    def _host(self) -> np.ndarray:
        return self.matrix.cpu().numpy()

    def get(self, i: int, j: int) -> float:
        """Entry (i, j), bounds-checked against nnodes; positions past the
        stored matrix read as 0.0 (graph.rs:311-321)."""
        assert i < self.nnodes and j < self.nnodes, (
            f"Index out of bounds: ({i}, {j}) for "
            f"{self.nnodes}x{self.nnodes} matrix")
        n = self.matrix.shape[0]
        if i >= n or j >= n:
            return 0.0
        return float(self.matrix[i, j])

    def set(self, i: int, j: int, value: float) -> None:
        """Entry (i, j) := value, out of place.  A position in [dimension,
        nnodes) has no stored entry to set and raises IndexError, as the
        JAX package's host matrix does."""
        assert i < self.nnodes and j < self.nnodes
        n = self.matrix.shape[0]
        if i >= n or j >= n:
            raise IndexError(f"({i}, {j}) lies past the stored {n}x{n} "
                             "matrix")
        dev = self.matrix.device
        self.matrix = self.matrix.index_put(
            (torch.tensor([i], device=dev), torch.tensor([j], device=dev)),
            torch.tensor([value], dtype=self.matrix.dtype, device=dev))

    def get_row(self, i: int) -> np.ndarray:
        """Row i as an nnodes-long vector, zero past the stored matrix
        (graph.rs:362-375)."""
        assert i < self.nnodes, \
            f"Row index {i} out of bounds for {self.nnodes} nodes"
        n = self.matrix.shape[0]
        out = np.zeros(self.nnodes)
        if i < n:
            out[:n] = self.matrix[i].cpu().numpy()
        return out

    def get_column(self, j: int) -> np.ndarray:
        assert j < self.nnodes, \
            f"Column index {j} out of bounds for {self.nnodes} nodes"
        n = self.matrix.shape[0]
        out = np.zeros(self.nnodes)
        if j < n:
            out[:n] = self.matrix[:, j].cpu().numpy()
        return out

    @staticmethod
    def sparsity(matrix, structural_nnz: Optional[int] = None) -> float:
        """1 - nnz/total (reference: graph.rs:572-578); nnz counts the
        non-zero entries when not given."""
        rows, cols = matrix.shape
        total = rows * cols
        if structural_nnz is None:
            structural_nnz = int((torch.as_tensor(matrix).abs() > 0).sum())
        return 1.0 - structural_nnz / total if total else 1.0

    def degrees(self) -> np.ndarray:
        """Diagonal entries; entries past the matrix dimension read as 0
        (graph.rs:324-345)."""
        n = self.matrix.shape[0]
        out = np.zeros(max(self.nnodes, n))
        out[:n] = torch.diagonal(self.matrix).double().cpu().numpy()
        return out

    def multiply_vector(self, x) -> np.ndarray:
        """y = L·x (reference: graph.rs:436-473), on the matrix's device
        in its dtype."""
        x = torch.as_tensor(np.asarray(x)).to(device=self.matrix.device,
                                              dtype=self.matrix.dtype)
        assert x.shape[0] == self.matrix.shape[0], (
            f"Vector length {x.shape[0]} must match matrix dim "
            f"{self.matrix.shape[0]}")
        return (self.matrix @ x).cpu().numpy()

    def rayleigh_quotient(self, x) -> float:
        """R(L, x) = xᵀLx / xᵀx (reference: graph.rs:394-433); 0 with a
        warning for xᵀx <= 1e-12."""
        x = torch.as_tensor(np.asarray(x)).to(device=self.matrix.device,
                                              dtype=self.matrix.dtype)
        num = float(x @ (self.matrix @ x))
        den = float(x @ x)
        if den <= 1e-12:
            logger.warning("Zero vector encountered in Rayleigh quotient "
                           "computation")
            return 0.0
        return num / den

    def is_symmetric(self, tolerance: float) -> bool:
        return bool((self.matrix - self.matrix.T).abs().max() <= tolerance)

    def verify_properties(self, tolerance: float) -> LaplacianValidation:
        """Row sums ≈ 0, non-negative diagonal, symmetry (reference:
        graph.rs:500-564)."""
        v = LaplacianValidation()
        m = self._host()
        n = m.shape[0]
        row_sums = m.sum(axis=1)
        v.max_row_sum_error = float(np.max(np.abs(row_sums))) if n else 0.0
        for i in np.nonzero(np.abs(row_sums) > tolerance)[0]:
            v.row_sum_violations.append((int(i), float(row_sums[i])))
        diag = np.diagonal(m)
        for i in np.nonzero(diag < 0.0)[0]:
            v.negative_diagonal.append((int(i), float(diag[i])))
        v.is_symmetric = self.is_symmetric(tolerance)
        if not v.is_symmetric:
            v.max_asymmetry = float(np.max(np.abs(m - m.T)))
        v.is_valid = (not v.row_sum_violations and not v.negative_diagonal
                      and v.is_symmetric)
        return v

    def extract_adjacency(self) -> np.ndarray:
        """A_ij = -L_ij off the diagonal, 0 on it (reference:
        graph.rs:580-600)."""
        m = self._host().copy()
        np.fill_diagonal(m, 0.0)
        return -m

    def statistics(self) -> LaplacianStats:
        degrees = self.degrees()
        n = self.matrix.shape[0]
        return LaplacianStats(
            nnodes=self.nnodes,
            nnz=self.nnz(),
            sparsity=GraphLaplacian.sparsity(self.matrix,
                                             self.structural_nnz),
            min_degree=float(degrees.min()) if n else float("inf"),
            max_degree=float(degrees.max()) if n else float("-inf"),
            mean_degree=float(degrees.sum() / self.nnodes)
            if self.nnodes else 0.0,
            graph_params=self.graph_params,
        )

    @staticmethod
    def prepare_from_items(matrix, graph_params: GraphParams, *,
                           device=None, dtype=None) -> "GraphLaplacian":
        """The graph over the features of an N×F item matrix: transposed
        here, so the graph is F×F with nnodes N (reference:
        graph.rs:290-299)."""
        from .laplacian import build_laplacian_matrix
        if not isinstance(matrix, torch.Tensor):
            matrix = torch.as_tensor(np.asarray(matrix, dtype=np.float64))
        return build_laplacian_matrix(matrix.T, graph_params,
                                      n_items=matrix.shape[0],
                                      device=device, dtype=dtype)

    def __str__(self) -> str:
        out = [f"GraphLaplacian ({self.nnodes}×{self.nnodes}):",
               f"Parameters: {self.graph_params!r}"]
        if self.nnodes <= 10:
            out += ["Small matrix - showing structure only",
                    f"Non-zero entries: {self.nnz()}"]
        else:
            stats = self.statistics()
            out += [f"Matrix too large to display ({self.nnodes} nodes)",
                    f"Non-zero entries: {stats.nnz} "
                    f"({(1.0 - stats.sparsity) * 100.0:.2f}% dense)",
                    f"Degree range: [{stats.min_degree:.4f}, "
                    f"{stats.max_degree:.4f}], mean: {stats.mean_degree:.4f}"]
        return "\n".join(out) + "\n"


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

    @staticmethod
    def build_spectral_laplacian(aspace, graph_laplacian: GraphLaplacian
                                 ) -> None:
        """The F′×F′ Laplacian of the feature graph's Laplacian, into
        ``aspace.signals`` and ``aspace._signals_nnz`` (reference:
        graph.rs:212-270): the dense L is transposed and a second
        Laplacian is built over its rows with the graph's parameters, on
        the index device in the index dtype."""
        from .laplacian import build_laplacian_matrix

        params = graph_laplacian.graph_params
        gl2 = build_laplacian_matrix(graph_laplacian.matrix.T, params,
                                     n_items=aspace.nitems,
                                     device=aspace.device, dtype=aspace.dtype)
        aspace.signals = gl2.matrix
        aspace._signals_nnz = gl2.structural_nnz

        sp = GraphLaplacian.sparsity(aspace.signals, gl2.structural_nnz)
        if sp > 0.95 and params.sparsity_check:
            raise ValueError(f"Resulting spectral matrix is too sparse {sp}")
        if aspace.reduced_dim is not None:
            assert (aspace.signals.shape[0] == aspace.reduced_dim
                    and aspace.signals.shape[1] == aspace.reduced_dim), \
                "result should be a FxF matrix with reduced dimensions F"
        else:
            assert aspace.signals.shape[0] == aspace.signals.shape[1], \
                "result should be a FxF matrix"
        logger.info("Built FxF feature matrix: %dx%d",
                    aspace.signals.shape[0], aspace.signals.shape[1])
