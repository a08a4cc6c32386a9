"""ArrowSpace and ArrowItem: core containers and λ-aware search.

PyTorch counterpart of ``arrowspace_tpu.core`` (reference:
core.rs:84-1006).  ArrowSpace keeps the N×F item matrix and the per-item
λ vector on one device in one dtype; searches are batched products plus
an exact top-k (ops/search.py), or on large corpora the binned kernel
with exact repair (binned_fits) or, where K1 does not admit F, the exact
merge kernel (merge_fits): the engine gates, which the serving session
shares.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import resolve
from .ops.bintopk import bintopk_fits
from .ops.search import batched_lambda_aware_topk, binned_topk_with_repair
from .ops.topk import fused_lambda_topk
from .reduction import ImplicitProjection
from .taumode import (TAUDEFAULT, TauMode, select_tau, select_tau_batch,
                      synthetic_lambda_batch, synthetic_lambda_single)
from .utils.log import get_logger

logger = get_logger("arrowspace.core")

__all__ = ["ArrowItem", "ArrowSpace", "BINNED_MIN_ITEMS", "BINNED_MAX_K",
           "binned_fits", "merge_fits"]

# Corpus size and k from which the streaming kernels serve (core.py:422-442
# of the JAX package).
BINNED_MIN_ITEMS = 65536
BINNED_MAX_K = 128


def binned_fits(nitems: int, k: int, f: int) -> bool:
    """Whether the binned kernel (K1) with exact repair serves this size:
    at least BINNED_MIN_ITEMS rows, k up to BINNED_MAX_K and F within
    K1's shared-memory gate.  An engine gate of both search and the
    serving session, keyed on size alone: a CPU index runs the same engine
    as a CUDA one, through the kernels' plain versions."""
    return merge_fits(nitems, k) and bintopk_fits(f)


def merge_fits(nitems: int, k: int) -> bool:
    """Whether the streaming kernels serve this size: at least
    BINNED_MIN_ITEMS rows and k up to BINNED_MAX_K.  Where it holds and
    binned_fits does not (F above K1's gate), the exact merge kernel (K3)
    serves, at any F (core.py:429-439 of the JAX package).  Keyed on size
    alone, as binned_fits is."""
    return nitems >= BINNED_MIN_ITEMS and k <= BINNED_MAX_K


class ArrowItem:
    """A single owned row with an associated spectral score λ
    (reference: core.rs:84-317)."""

    __slots__ = ("item", "lambda_")

    def __init__(self, item, lambda_: float):
        self.item = np.array(item, dtype=np.float64)
        self.lambda_ = float(lambda_)

    def __len__(self) -> int:
        return self.item.shape[0]

    def lambda_component_similarity(self, other: "ArrowItem") -> float:
        """1 - min(|Δλ|, 1) (reference: core.rs:135-138)."""
        return 1.0 - min(abs(self.lambda_ - other.lambda_), 1.0)

    def cosine_similarity(self, other) -> float:
        other = np.asarray(other, dtype=np.float64)
        denom = float(np.linalg.norm(self.item) * np.linalg.norm(other))
        if denom > 0.0:
            return float(np.dot(self.item, other)) / denom
        return 0.0

    def lambda_similarity(self, other: "ArrowItem", alpha: float) -> float:
        """α·cos + (1-α)·λ-proximity (reference: core.rs:156-175)."""
        assert len(self) == len(other), "items should be of the same length"
        return alpha * self.cosine_similarity(other.item) \
            + (1.0 - alpha) * self.lambda_component_similarity(other)


@dataclass
class ArrowSpace:
    """Dense N×F item matrix with per-item spectral scores
    (reference: core.rs:366-385)."""

    nfeatures: int = 0
    nitems: int = 0
    data: Optional[torch.Tensor] = None          # (N, F)
    lambdas: Optional[torch.Tensor] = None       # (N,)
    taumode: TauMode = TAUDEFAULT

    n_clusters: int = 0
    # -1 encodes the reference's None (outlier / unassigned)
    cluster_assignments: Optional[np.ndarray] = None
    cluster_sizes: Optional[np.ndarray] = None
    cluster_radius: float = 0.0

    # JL projection of a dims-reduced build (eigenmaps.start_clustering)
    projection_matrix: Optional[ImplicitProjection] = None
    reduced_dim: Optional[int] = None
    # Host float64 rows the index was built from (f64_rescore search).
    host_rows: Optional[np.ndarray] = None
    # True for energy builds with EnergyParams.allow_tall_graphs: λ
    # zero-pads items to graphs with more nodes than item coordinates
    # instead of raising the reference's error (taumode.rs:574).
    pad_tall_graphs: bool = False
    _projected_cache: Optional[torch.Tensor] = None

    @staticmethod
    def new(items: Sequence[Sequence[float]], taumode: TauMode = TAUDEFAULT,
            *, device=None, dtype=None) -> "ArrowSpace":
        """Construct from equal-length rows (reference: core.rs:415-439),
        on ``device`` in ``dtype`` (defaults: config.resolve)."""
        items = np.asarray(items, dtype=np.float64)
        assert items.size > 0, "items cannot be empty"
        assert items.shape[0] > 1, "cannot create a arrowspace of one arrow only"
        dev, dt = resolve(device, dtype)
        n_items, n_features = items.shape
        return ArrowSpace(
            nfeatures=n_features,
            nitems=n_items,
            data=torch.as_tensor(items).to(device=dev, dtype=dt),
            lambdas=torch.zeros((n_items,), device=dev, dtype=dt),
            taumode=taumode,
            cluster_assignments=np.full((0,), -1, dtype=np.int64),
            cluster_sizes=np.zeros((0,), dtype=np.int64),
            host_rows=items,
        )

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def _check_query(self, items: np.ndarray) -> None:
        assert items.shape[-1] == self.nfeatures, (
            f"Query dimension {items.shape[-1]} doesn't match index "
            f"original dimension {self.nfeatures}")
        assert np.all(np.isfinite(items)), (
            "Query item contains invalid values (NaN or infinity). "
            "All values must be finite.")

    def project_query(self, query) -> np.ndarray:
        """The query in the index space: projected when the build used a
        projection (reference: core.rs:509-529), float64 on the host."""
        query = np.asarray(query, dtype=np.float64)
        assert query.shape[0] == self.nfeatures, (
            f"Query dimension {query.shape[0]} doesn't match index original "
            f"dimension {self.nfeatures}")
        if self.projection_matrix is not None:
            return self.projection_matrix.project(query)
        return query

    def projected_items(self) -> torch.Tensor:
        """The (N, r) projected item matrix on the index device, cached;
        the items themselves when no projection is active."""
        if self.projection_matrix is None:
            return self.data
        if self._projected_cache is None or \
                self._projected_cache.shape[0] != self.nitems:
            self._projected_cache = \
                self.projection_matrix.project_device(self.data)
        return self._projected_cache

    def prepare_query_items_batch(self, items, gl) -> torch.Tensor:
        """Batched query-λ preparation: (B, F) -> (B,) on the index
        device (the batched form of core.rs:533-549).  A projected build
        prepares λ from the projected query (core.rs:193-194 of the JAX
        package), while corpus λ came from the raw rows."""
        items = np.asarray(items, dtype=np.float64)
        self._check_query(items)
        if self.projection_matrix is not None:
            items = self.projection_matrix.project_batch_host(items)
        lap = gl.matrix.to(device=self.device, dtype=self.dtype)
        q = torch.as_tensor(items).to(device=self.device, dtype=self.dtype)
        taus = select_tau_batch(q, self.taumode)
        return synthetic_lambda_batch(q, lap, taus,
                                      pad_items=self.pad_tall_graphs)

    def prepare_query_item(self, item, gl) -> float:
        """The query's synthetic λ (reference: core.rs:533-549): τ from the
        query's coordinates on the host, then λ against the graph."""
        item = np.asarray(item, dtype=np.float64)
        self._check_query(item)
        if self.projection_matrix is not None:
            item = self.project_query(item)
        tau = select_tau(item, self.taumode)
        return synthetic_lambda_single(item, gl.matrix, tau,
                                       pad_items=self.pad_tall_graphs)

    def search_lambda_aware(self, query: ArrowItem, k: int,
                            alpha: float) -> List[Tuple[int, float]]:
        """λ-aware top-k (reference: core.rs:760-798), through the batched
        path with B=1 so both single-query APIs share one engine."""
        assert query.lambda_ != 0.0, (
            "Lambda of the item is 0.0, prepare the item before searching")
        k_eff = min(k, self.nitems)
        scores, idx = self.search_lambda_aware_batch(
            np.atleast_2d(query.item), np.asarray([query.lambda_]), k_eff,
            alpha)
        return [(int(i), float(s)) for i, s in
                zip(idx[0].tolist(), scores[0].tolist())]

    def search_lambda_aware_batch(self, queries, query_lambdas, k: int,
                                  alpha: float):
        """Batched λ-aware top-k: (B, F) queries -> (scores (B,k),
        ids (B,k)) tensors on the index device."""
        k_eff = min(k, self.nitems)
        q = torch.as_tensor(np.asarray(queries, dtype=np.float64)) \
            if not torch.is_tensor(queries) else queries
        ql = torch.as_tensor(np.asarray(query_lambdas, dtype=np.float64)) \
            if not torch.is_tensor(query_lambdas) else query_lambdas
        q = q.to(device=self.device, dtype=self.dtype)
        ql = ql.to(device=self.device, dtype=self.dtype)
        if binned_fits(self.nitems, k_eff, self.nfeatures):
            return binned_topk_with_repair(q, ql, self.data, self.lambdas,
                                           alpha, k=k_eff)
        if merge_fits(self.nitems, k_eff):
            return fused_lambda_topk(q, ql, self.data, self.lambdas, alpha,
                                     k=k_eff)
        return batched_lambda_aware_topk(q, ql, self.data, self.lambdas,
                                         alpha, k=k_eff)
