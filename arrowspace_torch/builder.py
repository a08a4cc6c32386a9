"""ArrowSpaceBuilder: fluent configuration + 4-stage build orchestration.

PyTorch counterpart of ``arrowspace_tpu.builder`` (reference:
builder.rs:20-455): the same method names, defaults (builder.rs:59-91),
define_result_k heuristic (builder.rs:225-233) and stage order.  The
builder also carries the device and dtype the index is built on.
Persistence is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from .config import resolve
from .core import ArrowSpace
from .graph import GraphLaplacian
from .sampling import SamplerType
from .taumode import TAUDEFAULT, TauMode
from .utils.log import get_logger, stage_timer

logger = get_logger("arrowspace.builder")

__all__ = ["ArrowSpaceBuilder"]


class ArrowSpaceBuilder:
    """Fluent builder (reference: builder.rs:20-233)."""

    def __init__(self, *, device=None, dtype=None):
        self.device, self.dtype = resolve(device, dtype)
        self.synthesis: TauMode = TAUDEFAULT
        self.lambda_eps = 1e-3
        self.lambda_k = 6
        self.lambda_topk = 3
        self.lambda_p = 2.0
        self.lambda_sigma: Optional[float] = None  # σ := 1.0 in the kernel
        self.normalise = False
        self.sparsity_check = False
        self.sampling: Optional[SamplerType] = SamplerType.simple(0.6)
        self.cluster_max_clusters: Optional[int] = None
        self.cluster_radius = 1.0
        self.clustering_seed: Optional[int] = None
        self.deterministic_clustering = False
        self.use_dims_reduction = False
        self.rp_eps = 0.3
        # wall seconds of the last build, per stage, and of its clustering
        # stage's two host steps (optimal K, the scan)
        self.stage_seconds: Dict[str, float] = {}
        self.clustering_seconds: Dict[str, float] = {}

    def with_lambda_graph(self, eps: float, k: int, topk: int, p: float,
                          sigma_override: Optional[float]
                          ) -> "ArrowSpaceBuilder":
        self.lambda_eps = eps
        self.lambda_k = k
        self.lambda_topk = topk
        self.lambda_p = p
        self.lambda_sigma = sigma_override
        return self

    def with_synthesis(self, tau_mode: TauMode) -> "ArrowSpaceBuilder":
        self.synthesis = tau_mode
        return self

    def with_normalisation(self, normalise: bool) -> "ArrowSpaceBuilder":
        self.normalise = normalise
        return self

    def with_inline_sampling(self, sampling: Optional[SamplerType]
                             ) -> "ArrowSpaceBuilder":
        self.sampling = sampling
        return self

    def with_dims_reduction(self, enable: bool,
                            eps: Optional[float] = None
                            ) -> "ArrowSpaceBuilder":
        """JL projection of the centroids before the graph build
        (eigenmaps.start_clustering); eps defaults to 0.5
        (builder.rs:183)."""
        self.use_dims_reduction = enable
        self.rp_eps = eps if eps is not None else 0.5
        return self

    def with_persistence(self, path, name: str) -> "ArrowSpaceBuilder":
        raise NotImplementedError(
            "persistence is not ported yet (ROADMAP.md queue 1, "
            "storage/parquet)")

    def with_seed(self, seed: int) -> "ArrowSpaceBuilder":
        """Seeded => deterministic sequential clustering
        (builder.rs:190-195)."""
        self.clustering_seed = seed
        self.deterministic_clustering = True
        return self

    def define_result_k(self) -> None:
        """topk heuristic for small k (builder.rs:225-233)."""
        if self.lambda_k <= 5:
            self.lambda_topk = 3
        elif self.lambda_k < 10:
            self.lambda_topk = 4

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, rows) -> Tuple[ArrowSpace, GraphLaplacian]:
        """4-stage build (reference: builder.rs:249-455): clustering, the
        feature-graph Laplacian, then λτ.  Per-stage wall seconds land in
        ``stage_seconds``."""
        from . import eigenmaps as em

        n_items = len(rows)
        self.define_result_k()
        logger.info("Building ArrowSpace from %d items", n_items)
        self.stage_seconds = {}
        with stage_timer(logger, "ArrowSpaceBuilder::build"):
            t0 = time.perf_counter()
            clustered = em.start_clustering(self, rows)
            self._sync()
            t1 = time.perf_counter()
            gl = em.eigenmaps(clustered.aspace, self, clustered.centroids,
                              n_items)
            self._sync()
            t2 = time.perf_counter()
            em.compute_taumode(clustered.aspace, gl)
            self._sync()
            t3 = time.perf_counter()
        self.stage_seconds = {"clustering": t1 - t0, "laplacian": t2 - t1,
                              "taumode": t3 - t2}
        return clustered.aspace, gl
