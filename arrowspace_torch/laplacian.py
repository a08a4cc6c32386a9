"""λτ-graph Laplacian build from high-dimensional vectors.

PyTorch counterpart of ``arrowspace_tpu.laplacian`` (reference:
laplacian.rs:122-417).  Per node row:

1. optional "normalisation", which is a StandardScaler (column
   z-scoring, laplacian.rs:146-155);
2. top-(topk+1) neighbours by rectified cosine distance
   d = 1 - max(0, cos) (laplacian.rs:211, 72-75);
3. filter j != i, d <= eps, kernel weight w = 1/(1+(d/σ)^p) with σ
   defaulting to 1.0 when None (laplacian.rs:253-254), w > 1e-12;
4. inline sparsification when the average degree exceeds 10: keep the
   top 50% of a row's edges by w·√(deg_i·deg_j), at least 1, only for
   rows with more than 2 edges (laplacian.rs:229-280);
5. symmetrise as a max/union merge (laplacian.rs:314-320);
6. L = D - A (laplacian.rs:349-417).

The node count is small (F′ feature signals), so the whole build is one
dense pairwise-cosine product plus stable sorts and a scatter-max.  It
runs in float64 on the index's device and the Laplacian is returned in
the index dtype.  Neighbour and sparsification ranks use stable sorts,
so ties resolve to the lowest index as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import resolve
from .graph import GraphLaplacian, GraphParams
from .utils.log import get_logger

logger = get_logger("arrowspace.laplacian")

__all__ = ["build_laplacian_matrix", "standard_scale_columns",
           "rectified_cosine_distances", "adjacency_from_knn"]


def _column_mean(m: torch.Tensor) -> torch.Tensor:
    """(1, C) column means, each column summed row by row in order (the
    order of numpy's reduction over axis 0, which the JAX package's
    Laplacian build takes for host rows).  torch.mean sums
    in another order; on a Laplacian's columns, which sum to zero, the
    two orders leave different ~1e-17 residues, and a scaled all-zero
    row then becomes a zero vector in one package and a tiny nonzero one
    in the other, which gains or loses a graph edge."""
    return m.cumsum(dim=0)[-1:] / m.shape[0]


def standard_scale_columns(m: torch.Tensor) -> torch.Tensor:
    """Column z-scoring (laplacian.rs:146-155, smartcore StandardScaler).
    Constant columns are left centred (std guarded to 1)."""
    mean = _column_mean(m)
    centred = m - mean
    std = _column_mean(centred * centred).sqrt()
    std = torch.where(std > 0.0, std, torch.ones_like(std))
    return centred / std


def rectified_cosine_distances(rows: torch.Tensor) -> torch.Tensor:
    """Pairwise d = 1 - max(0, cos) over matrix rows (laplacian.rs:72-75).
    Zero-norm rows get cos = 0 -> d = 1."""
    norms = torch.sqrt((rows * rows).sum(dim=1))
    safe = torch.where(norms > 0.0, norms, torch.ones_like(norms))
    unit = rows / safe[:, None]
    cos = unit @ unit.T
    both = (norms[:, None] > 0.0) & (norms[None, :] > 0.0)
    cos = torch.where(both, cos, torch.zeros_like(cos))
    return 1.0 - cos.clamp_min(0.0)


def _build_dense(rows: torch.Tensor, params: GraphParams):
    """(adjacency, Laplacian, off-diagonal nnz) of the λτ-graph over the
    rows of ``rows`` (laplacian.rs:203-417)."""
    n = rows.shape[0]
    kq = min(params.topk + 1, n)
    sigma = params.sigma if params.sigma is not None else 1.0

    dist = rectified_cosine_distances(rows)
    # self is always the closest entry, then filtered out (CosinePair's
    # self hit)
    dist.fill_diagonal_(-1.0)
    nbr = torch.argsort(dist, dim=1, stable=True)[:, :kq]
    d = dist.gather(1, nbr)
    row_ids = torch.arange(n, device=rows.device)[:, None].expand(n, kq)
    deg_mask = (nbr != row_ids) & (d <= params.eps)
    degrees = deg_mask.sum(dim=1)

    sparsify = float(degrees.double().mean()) > 10.0
    w = 1.0 / (1.0 + (d.clamp_min(0.0) / sigma) ** params.p)
    valid = deg_mask & (w > 1e-12)

    if sparsify:
        logger.info("Inline sparsification enabled (avg degree %.1f)",
                    float(degrees.double().mean()))
        deg_f = degrees.to(rows.dtype)
        score = w * torch.sqrt(deg_f[:, None] * deg_f[nbr])
        score = torch.where(valid, score,
                            torch.full_like(score, float("-inf")))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        count = valid.sum(dim=1)
        keep = rank < (count // 2).clamp_min(1)[:, None]
        valid = torch.where((count > 2)[:, None], valid & keep, valid)

    w_masked = torch.where(valid, w, torch.zeros_like(w))
    adj = torch.zeros(n * n, dtype=rows.dtype, device=rows.device)
    flat = (row_ids * n + nbr).reshape(-1)
    adj.scatter_reduce_(0, flat, w_masked.reshape(-1), reduce="amax")
    adj = adj.reshape(n, n)
    adj = torch.maximum(adj, adj.T)
    adj.fill_diagonal_(0.0)
    lap = torch.diag(adj.sum(dim=1)) - adj
    return adj, lap, int((adj > 0).sum())


def adjacency_from_knn(rows, params: GraphParams, *, device=None,
                       dtype=None) -> torch.Tensor:
    """The dense symmetric adjacency over the rows of ``rows``
    (laplacian.rs:203-346) that build_laplacian_matrix builds on the way
    to L = D - A, without normalisation: computed in float64 on
    ``device``, returned in ``dtype`` (config.resolve; a tensor's own
    device and dtype by default)."""
    if torch.is_tensor(rows):
        device = rows.device if device is None else device
        dtype = rows.dtype if dtype is None else dtype
    dev, dt = resolve(device, dtype)
    x = torch.as_tensor(rows).to(device=dev, dtype=torch.float64)
    adj, _, _ = _build_dense(x, params)
    return adj.to(dt)


def build_laplacian_matrix(transposed, params: GraphParams,
                           n_items: Optional[int] = None, *, device=None,
                           dtype=None) -> GraphLaplacian:
    """Build the graph Laplacian over the **rows** of ``transposed``
    (reference: laplacian.rs:122-178).

    The canonical caller passes a transposed X×F centroid matrix, so the
    graph is over the F′ feature signals and the matrix is F′×F′ while
    ``nnodes`` records the original N."""
    dev, dt = resolve(device, dtype)
    rows = torch.as_tensor(transposed).to(device=dev, dtype=torch.float64)
    d, n_cols = rows.shape
    assert n_cols >= 2 and d >= 2, (
        f"items should be at least of shape (2,2): ({d},{n_cols})")
    logger.info("Building Laplacian matrix for %d items with %d features",
                n_cols, d)

    items = standard_scale_columns(rows) if params.normalise else rows
    _, lap, offdiag_nnz = _build_dense(items, params)
    structural_nnz = d + offdiag_nnz  # diagonal always stored
    logger.info("Successfully built Laplacian matrix (%dx%d) with %d "
                "non-zeros", d, d, structural_nnz)
    return GraphLaplacian(
        init_data=items.to(dt),
        matrix=lap.to(dt),
        nnodes=n_items if n_items is not None else n_cols,
        graph_params=params,
        structural_nnz=structural_nnz,
    )
