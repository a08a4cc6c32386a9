"""ArrowSpace and ArrowItem: core containers and λ-aware search.

PyTorch counterpart of ``arrowspace_tpu.core`` (reference:
core.rs:84-1006).  ArrowSpace keeps the N×F item matrix and the per-item
λ vector on one device in one dtype; searches are batched products plus
an exact top-k (ops/search.py), or on large corpora the binned kernel
with exact repair (binned_fits) or, where K1 does not admit F, the exact
merge kernel (merge_fits): the engine gates, which the serving session
shares.  Items and λ are mutated out of place (a new tensor per
set), so a session made before a mutation keeps serving the snapshot it
was made from, as the JAX package's immutable arrays do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import resolve
from .ops.bintopk import bintopk_fits
from .ops.search import (batched_lambda_aware_topk, binned_topk_with_repair,
                         hybrid_search_device_fused)
from .ops.topk import fused_lambda_topk
from .reduction import ImplicitProjection
from .taumode import (TAUDEFAULT, TauMode, compute_taumode_lambdas,
                      select_tau, select_tau_batch, synthetic_lambda_batch,
                      synthetic_lambda_single)
from .utils.log import get_logger

logger = get_logger("arrowspace.core")

__all__ = ["ArrowItem", "ArrowFeature", "ArrowSpace", "BINNED_MIN_ITEMS",
           "BINNED_MAX_K", "binned_fits", "merge_fits", "lambda_aware_topk",
           "densematrix_to_vecvec"]

# Corpus size and k from which the streaming kernels serve (core.py:422-442
# of the JAX package).
BINNED_MIN_ITEMS = 65536
BINNED_MAX_K = 128


def binned_fits(nitems: int, k: int, f: int, use_bf16: bool = False) -> bool:
    """Whether the binned kernel (K1) with exact repair serves this size:
    at least BINNED_MIN_ITEMS rows, k up to BINNED_MAX_K and F within
    K1's gate (its shared memory; in bf16 also F <= 1536, the JAX
    session's binned limit).  An engine gate of both search and the
    serving session, keyed on size and dtype alone: a CPU index runs the
    same engine as a CUDA one, through the kernels' plain versions."""
    return merge_fits(nitems, k) and bintopk_fits(f, use_bf16)


def merge_fits(nitems: int, k: int) -> bool:
    """Whether the streaming kernels serve this size: at least
    BINNED_MIN_ITEMS rows and k up to BINNED_MAX_K.  Where it holds and
    binned_fits does not (F above K1's gate), the exact merge kernel (K3)
    serves, at any F (core.py:429-439 of the JAX package).  Keyed on size
    alone, as binned_fits is."""
    return nitems >= BINNED_MIN_ITEMS and k <= BINNED_MAX_K


def lambda_aware_topk(queries, query_lambdas, items, item_lambdas, alpha,
                      *, k: int, use_bf16: bool = False,
                      use_pallas: Optional[bool] = None):
    """Exact λ-aware top-k of a corpus on one device, by the engine its
    size takes: the binned kernel (K1) with exact repair where
    binned_fits holds, the exact merge kernel (K3) where only merge_fits
    does, else the plain scan.  ``use_pallas`` (the JAX package's name,
    core.py:386-441 there) overrides the size gate: False forces the
    plain scan, True forces the kernels at any row count (K1 with repair
    where K1 admits F, else K3; both serve k <= BINNED_MAX_K).  With
    ``use_bf16`` K1 and K3 take bf16 operands (their bf16 modes); the
    plain scan stays in the index dtype, as the JAX package's "xla"
    route does.  (scores (B, k), ids (B, k)) tensors."""
    n, f = items.shape
    if use_pallas is None:
        kind = "binned" if binned_fits(n, k, f, use_bf16) else \
            "merge" if merge_fits(n, k) else "plain"
    elif use_pallas:
        if k > BINNED_MAX_K:
            raise ValueError(f"use_pallas=True: the kernels serve k <= "
                             f"{BINNED_MAX_K}, not {k}")
        kind = "binned" if bintopk_fits(f, use_bf16) else "merge"
    else:
        kind = "plain"
    if kind == "binned":
        return binned_topk_with_repair(queries, query_lambdas, items,
                                       item_lambdas, alpha, k=k,
                                       use_bf16=use_bf16)
    if kind == "merge":
        return fused_lambda_topk(queries, query_lambdas, items, item_lambdas,
                                 alpha, k=k, use_bf16=use_bf16)
    return batched_lambda_aware_topk(queries, query_lambdas, items,
                                     item_lambdas, alpha, k=k)


class ArrowItem:
    """A single owned row with an associated spectral score λ
    (reference: core.rs:84-317)."""

    __slots__ = ("item", "lambda_")

    def __init__(self, item, lambda_: float):
        self.item = np.array(item, dtype=np.float64)
        self.lambda_ = float(lambda_)

    def __len__(self) -> int:
        return self.item.shape[0]

    def is_empty(self) -> bool:
        return self.item.size == 0

    def lambda_component_similarity(self, other: "ArrowItem") -> float:
        """1 - min(|Δλ|, 1) (reference: core.rs:135-138)."""
        return 1.0 - min(abs(self.lambda_ - other.lambda_), 1.0)

    def lambda_similarity(self, other: "ArrowItem", alpha: float) -> float:
        """α·cos + (1-α)·λ-proximity (reference: core.rs:156-175)."""
        assert len(self) == len(other), "items should be of the same length"
        return alpha * self.cosine_similarity(other.item) \
            + (1.0 - alpha) * self.lambda_component_similarity(other)

    def dot(self, other: "ArrowItem") -> float:
        assert len(self) == len(other), "Dimension mismatch"
        return float(np.dot(self.item, other.item))

    @staticmethod
    def norm(a) -> float:
        a = np.asarray(a, dtype=np.float64)
        return float(np.sqrt(np.sum(a * a)))

    def cosine_similarity(self, other) -> float:
        other = np.asarray(other, dtype=np.float64)
        denom = ArrowItem.norm(self.item) * ArrowItem.norm(other)
        if denom > 0.0:
            return float(np.dot(self.item, other)) / denom
        logger.warning("Zero vector encountered in cosine similarity "
                       "computation")
        return 0.0

    def euclidean_distance(self, other: "ArrowItem") -> float:
        assert len(self) == len(other), "Dimension mismatch"
        d = self.item - other.item
        return float(np.sqrt(np.sum(d * d)))

    def add_inplace(self, other: "ArrowItem") -> None:
        assert len(self) == len(other), "Dimension mismatch"
        self.item += other.item

    def mul_inplace(self, other: "ArrowItem") -> None:
        assert len(self) == len(other), "Dimension mismatch"
        self.item *= other.item

    def scale(self, scalar: float) -> None:
        self.item *= scalar

    def __iter__(self):
        return iter(self.item)


class ArrowFeature:
    """A feature column (reference: core.rs:91-94)."""

    __slots__ = ("feature",)

    def __init__(self, feature):
        self.feature = np.asarray(feature, dtype=np.float64)


@dataclass
class ArrowSpace:
    """Dense N×F item matrix with per-item spectral scores
    (reference: core.rs:366-385)."""

    nfeatures: int = 0
    nitems: int = 0
    data: Optional[torch.Tensor] = None          # (N, F)
    # F′×F′ Laplacian of the feature graph's Laplacian (with_spectral,
    # graph.GraphFactory.build_spectral_laplacian), on the index device;
    # where set and non-empty, item λ is computed against it
    signals: Optional[torch.Tensor] = None
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
    _signals_nnz: int = 0
    _projected_cache: Optional[torch.Tensor] = None
    # (signals shape, z = projected items · signalsᵀ): the energy
    # search's z-plane (energymaps._energy_z_items)
    _energy_z_cache: Optional[tuple] = None
    # (λ ascending as float64, their item ids): lambda_sorted_index's cache,
    # dropped by every change of data or λ
    _lambda_order: Optional[Tuple[np.ndarray, np.ndarray]] = None

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

    from_items = new  # the test-path alias (core.rs:444-453)

    @staticmethod
    def from_items_default(items, *, device=None,
                           dtype=None) -> "ArrowSpace":
        """ArrowSpace.new with the default τ policy (TAUDEFAULT)."""
        return ArrowSpace.new(items, TAUDEFAULT, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def lambda_graph(self, gl) -> torch.Tensor:
        """The graph item λ is computed against: ``signals`` where it is
        set and non-empty, else the feature graph (eigenmaps.rs:358-383,
        taumode.rs:195-200).  Query λ always reads ``gl.matrix``, items
        built with signals too: the JAX package's quirk, kept
        (core.py:195, 233 and index.py:414 of the JAX package)."""
        if self.signals is not None and self.signals.shape[0] > 0:
            return self.signals
        return gl.matrix

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
                                  alpha: float,
                                  use_pallas: Optional[bool] = None,
                                  use_bf16: bool = False):
        """Batched λ-aware top-k: (B, F) queries -> (scores (B,k),
        ids (B,k)) tensors on the index device.  ``use_pallas`` None
        takes the engine the size gates pick, False the plain scan, True
        the kernels at any row count; ``use_bf16`` gives the kernels bf16
        operands (lambda_aware_topk)."""
        k_eff = min(k, self.nitems)
        q = torch.as_tensor(np.asarray(queries, dtype=np.float64)) \
            if not torch.is_tensor(queries) else queries
        ql = torch.as_tensor(np.asarray(query_lambdas, dtype=np.float64)) \
            if not torch.is_tensor(query_lambdas) else query_lambdas
        q = q.to(device=self.device, dtype=self.dtype)
        ql = ql.to(device=self.device, dtype=self.dtype)
        return lambda_aware_topk(q, ql, self.data, self.lambdas, alpha,
                                 k=k_eff, use_bf16=use_bf16,
                                 use_pallas=use_pallas)

    # ------------------------------------------------------------------
    # Access and mutation (core.py:241-360 of the JAX package)
    # ------------------------------------------------------------------
    def lambdas_list(self) -> np.ndarray:
        return self.lambdas.cpu().numpy()

    def cluster_of(self, i: int) -> Optional[int]:
        if self.cluster_assignments is None or \
                i >= len(self.cluster_assignments):
            return None
        v = int(self.cluster_assignments[i])
        return None if v < 0 else v

    def get_feature(self, i: int) -> ArrowFeature:
        assert i < self.nfeatures, "feature index out of bounds"
        return ArrowFeature(self.data[:, i].cpu().numpy())

    def _data_changed(self) -> None:
        self._projected_cache = None
        self._energy_z_cache = None
        self._lambda_order = None
        self.host_rows = None   # the data diverged from the float64 original

    def set_feature(self, f: int, values: ArrowFeature) -> None:
        assert f < self.nfeatures, "feature index out of bounds"
        col = torch.as_tensor(values.feature).to(device=self.device,
                                                 dtype=self.dtype)
        self.data = self.data.index_copy(
            1, torch.tensor([f], device=self.device), col[:, None])
        self._data_changed()

    def get_item(self, i: int) -> ArrowItem:
        assert i < self.nitems, "item index out of bounds"
        return ArrowItem(self.data[i].cpu().numpy(), float(self.lambdas[i]))

    def set_item(self, i: int, values: ArrowItem) -> None:
        assert i < self.nitems, "item index out of bounds"
        row = torch.as_tensor(values.item).to(device=self.device,
                                              dtype=self.dtype)
        self.data = self.data.index_copy(
            0, torch.tensor([i], device=self.device), row[None, :])
        self._data_changed()

    def _check_gl(self, gl) -> None:
        assert gl.nnodes == self.nitems, \
            "Laplacian nodes must match number of items"

    def _refresh_lambda_row(self, a: int, gl) -> None:
        """λ of row ``a`` after it changed.  The reference re-runs the
        whole batch (core.rs:644); λ_j depends only on row j and the
        unchanged graph, so recomputing the edited row gives the same
        value: τ from the row on the host, then synthetic_lambda_single
        against the graph (lambda_graph), on its device in its dtype."""
        row = self.data[a].double().cpu().numpy()
        tau = select_tau(row, self.taumode)
        lam = synthetic_lambda_single(row, self.lambda_graph(gl), tau)
        self.lambdas = self.lambdas.index_copy(
            0, torch.tensor([a], device=self.device),
            torch.tensor([lam], dtype=self.dtype, device=self.device))
        self._lambda_order = None

    def add_items(self, a: int, b: int, gl) -> None:
        """Row a += row b, then λ of row a (reference: core.rs:614-642)."""
        assert a < self.nitems and b < self.nitems, (
            f"Item indices out of bounds: a={a}, b={b}, ncols={self.nitems}")
        self._check_gl(gl)
        item_a, item_b = self.get_item(a), self.get_item(b)
        item_a.add_inplace(item_b)
        self.set_item(a, item_a)
        self._refresh_lambda_row(a, gl)

    def mul_items(self, a: int, b: int, gl) -> None:
        """Row a *= row b elementwise, then λ of row a."""
        assert a < self.nitems and b < self.nitems, (
            f"Item indices out of bounds: a={a}, b={b}, ncols={self.nitems}")
        self._check_gl(gl)
        item_a, item_b = self.get_item(a), self.get_item(b)
        item_a.mul_inplace(item_b)
        self.set_item(a, item_a)
        self._refresh_lambda_row(a, gl)

    def scale_item(self, a: int, scalar: float, gl) -> None:
        """Row a *= scalar, then λ of row a."""
        assert a < self.nitems, (
            f"Item index out of bounds: a={a}, ncols={self.nitems}")
        self._check_gl(gl)
        item_a = self.get_item(a)
        item_a.scale(scalar)
        self.set_item(a, item_a)
        self._refresh_lambda_row(a, gl)

    def recompute_lambdas(self, gl) -> None:
        """Every λ again (reference: core.rs:711-727) against
        lambda_graph, through compute_taumode_lambdas: K2, K4 and K5 by
        their gates."""
        self.lambdas = compute_taumode_lambdas(self.data,
                                               self.lambda_graph(gl),
                                               self.taumode)
        self._lambda_order = None

    def update_lambdas(self, new_lambdas) -> None:
        new = torch.as_tensor(np.array(new_lambdas)) \
            if not torch.is_tensor(new_lambdas) else new_lambdas
        new = new.to(device=self.device, dtype=self.dtype)
        assert new.shape == self.lambdas.shape, \
            "New lambdas length must match existing lambdas length"
        self.lambdas = new
        self._lambda_order = None

    # ------------------------------------------------------------------
    # Hybrid and range search (core.py:444-496 of the JAX package)
    # ------------------------------------------------------------------
    def search_lambda_aware_hybrid(self, query: ArrowItem, k: int,
                                   alpha: float) -> List[Tuple[int, float]]:
        """Hybrid search mixing cosine-only evidence (reference:
        core.rs:802-928): the union of the λ-aware top-k, the high-cosine
        set (> 0.9999, scored by cosine) and the semantic top-1, best
        first, k of them (ops.search.hybrid_search_device_fused)."""
        if k == 0:
            return []
        scores, ids = hybrid_search_device_fused(
            torch.as_tensor(query.item), query.lambda_, self.data,
            self.lambdas, alpha, k=min(k, self.nitems))
        return [(int(i), float(s)) for i, s in
                zip(ids.tolist(), scores.tolist())]

    def lambda_sorted_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """(λ ascending as float64, the item ids in that order): a stable
        argsort, cached until data or λ change, for O(log N + M) bands."""
        if self._lambda_order is None or \
                len(self._lambda_order[0]) != self.nitems:
            lam = self.lambdas.double().cpu().numpy()
            order = np.argsort(lam, kind="stable")
            self._lambda_order = (lam[order], order)
        return self._lambda_order

    def range_search_sorted(self, lo: float, hi: float,
                            limit: Optional[int] = None
                            ) -> List[Tuple[int, float]]:
        """Two-sided λ band [lo, hi] by binary search on the sorted λ
        index: (item id, λ) ascending by λ, at most ``limit``."""
        lam_sorted, order = self.lambda_sorted_index()
        i0 = int(np.searchsorted(lam_sorted, lo, side="left"))
        i1 = int(np.searchsorted(lam_sorted, hi, side="right"))
        hits = [(int(order[i]), float(lam_sorted[i])) for i in range(i0, i1)]
        return hits[:limit] if limit is not None else hits

    def range_search(self, query: ArrowItem, gl,
                     eps: float) -> List[Tuple[int, float]]:
        """λ-band range search with the reference's signed one-sided test
        query.λ - item.λ <= eps (reference: core.rs:944-976, kept as it
        is); a query whose λ is 0 is prepared first.  Returns (item id,
        query.λ - item.λ) in id order."""
        if math.isclose(query.lambda_, 0.0, rel_tol=1e-9, abs_tol=1e-9):
            qlam = self.prepare_query_item(query.item, gl)
        else:
            qlam = query.lambda_
        diff = qlam - self.lambdas.double().cpu().numpy()
        hits = np.nonzero(diff <= eps)[0]
        return [(int(i), float(diff[i])) for i in hits]


def densematrix_to_vecvec(matrix) -> List[List[float]]:
    """Rows as lists of floats (core.rs:1042-1047)."""
    if torch.is_tensor(matrix):
        matrix = matrix.double().cpu().numpy()
    return np.asarray(matrix, dtype=np.float64).tolist()
