"""ArrowSpaceBuilder: fluent configuration + 4-stage build orchestration.

PyTorch counterpart of ``arrowspace_tpu.builder`` (reference:
builder.rs:20-455): the same method names, defaults (builder.rs:59-91),
define_result_k heuristic (builder.rs:225-233), stage order, persistence
hooks (builder.rs:271-432) and typed configuration (builder.rs:459-634).
The builder also carries the device and dtype the index is built on, and
the wall seconds of its last build; neither enters the typed
configuration, so the persisted metadata has the same keys in both
packages.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from .config import resolve
from .core import ArrowSpace
from .graph import GraphLaplacian
from .sampling import SamplerType
from .taumode import TAUDEFAULT, TauMode
from .utils.log import get_logger, stage_timer
from .utils.profiling import span

logger = get_logger("arrowspace.builder")

__all__ = ["ArrowSpaceBuilder", "ConfigValue", "PairingStrategy"]


class PairingStrategy:
    """Defined-but-unused enum kept for API parity (builder.rs:13-18)."""
    FAST_PAIR = "FastPair"
    DEFAULT = "Default"

    @staticmethod
    def cover_tree_knn(k: int):
        return ("CoverTreeKNN", k)


def _fmt(v) -> str:
    """A configuration value as Rust's Display prints it."""
    if v is None:
        return "None"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        r = repr(v)
        return r[:-2] if r.endswith(".0") else r
    return str(v)


class ConfigValue:
    """Typed configuration value (reference: builder.rs:526-634): a tagged
    union whose kind is one of Bool, Usize, F64, String, OptionF64,
    OptionUsize, OptionU64, TauMode, OptionSamplerType."""

    def __init__(self, kind: str, value):
        self.kind = kind
        self.value = value

    def as_bool(self):
        return self.value if self.kind == "Bool" else None

    def as_usize(self):
        return self.value if self.kind == "Usize" else None

    def as_f64(self):
        return self.value if self.kind == "F64" else None

    def as_tau_mode(self):
        return self.value if self.kind == "TauMode" else None

    def as_sampler_type(self):
        return self.value if self.kind == "OptionSamplerType" else None

    def __eq__(self, other):
        return (isinstance(other, ConfigValue) and self.kind == other.kind
                and self.value == other.value)

    def __repr__(self):
        return f"ConfigValue({self.kind}, {self.value!r})"

    def __str__(self):  # Display parity (builder.rs:637-668)
        if self.kind in ("TauMode", "OptionSamplerType") \
                and self.value is not None:
            return str(self.value)
        return _fmt(self.value)

    def to_json(self):
        """The value's form in the metadata JSON: {kind: value}."""
        if self.kind == "TauMode":
            return {self.kind: self.value.to_config()}
        if self.kind == "OptionSamplerType":
            return {self.kind: None if self.value is None
                    else self.value.to_config()}
        return {self.kind: self.value}

    @staticmethod
    def from_json(obj) -> "ConfigValue":
        (kind, value), = obj.items()
        if kind == "TauMode":
            return ConfigValue(kind, TauMode.from_config(value))
        if kind == "OptionSamplerType":
            return ConfigValue(kind, None if value is None
                               else SamplerType.from_config(value))
        return ConfigValue(kind, value)


class ArrowSpaceBuilder:
    """Fluent builder (reference: builder.rs:20-233)."""

    def __init__(self, *, device=None, dtype=None):
        self.device, self.dtype = resolve(device, dtype)
        self.prebuilt_spectral = False
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
        self.persistence: Optional[Tuple[str, pathlib.Path]] = None
        # wall seconds of the last build, per stage, and of its clustering
        # stage's two host steps (optimal K, the scan)
        self.stage_seconds: Dict[str, float] = {}
        self.clustering_seconds: Dict[str, float] = {}

    @staticmethod
    def new(*, device=None, dtype=None) -> "ArrowSpaceBuilder":
        return ArrowSpaceBuilder(device=device, dtype=dtype)

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

    def with_spectral(self, compute_spectral: bool) -> "ArrowSpaceBuilder":
        """Also build the F′×F′ signals graph (graph.GraphFactory.
        build_spectral_laplacian), against which λ is then computed."""
        logger.warning("with_spectral is an experimental feature, results "
                       "may be unprecise. Keep the default to false")
        self.prebuilt_spectral = compute_spectral
        return self

    def with_sparsity_check(self, sparsity_check: bool
                            ) -> "ArrowSpaceBuilder":
        self.sparsity_check = sparsity_check
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
        """Write the build's Parquet artifacts under ``path`` as
        ``{name}-*`` (storage/parquet, builder.rs:271-432)."""
        self.persistence = (name, pathlib.Path(path))
        return self

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
        feature-graph Laplacian (and with ``with_spectral`` the signals
        graph), then λτ.  With ``with_persistence`` each stage's artifacts
        are written as the JAX package writes them (builder.py:198-248),
        every device tensor copied to host float64 once.  Per-stage wall
        seconds land in ``stage_seconds``, the artifacts' under
        "persistence"."""
        from . import eigenmaps as em

        n_items = len(rows)
        self.define_result_k()
        logger.info("Building ArrowSpace from %d items", n_items)
        self.stage_seconds = {}
        store, t_persist = None, 0.0
        if self.persistence is not None:
            from .storage import parquet as store
            name, path = self.persistence
            path.mkdir(parents=True, exist_ok=True)

        def persist(save: str, matrix, suffix: str, **kwargs) -> None:
            nonlocal t_persist
            if store is not None:
                with span("build.persistence") as sp:
                    getattr(store, save)(matrix, path, f"{name}-{suffix}",
                                         self, **kwargs)
                t_persist += sp.seconds

        def host64(t):
            return t.double().cpu().numpy()

        persist("save_dense_matrix_with_builder",
                np.asarray(rows, dtype=np.float64), "raw_input")
        with stage_timer(logger, "ArrowSpaceBuilder::build"):
            with span("build.clustering") as clustering:
                clustered = em.start_clustering(self, rows)
                aspace = clustered.aspace
                self._sync()
            for suffix in ("clustered-dm", "laplacian-input"):
                persist("save_dense_matrix_with_builder",
                        np.asarray(clustered.centroids, dtype=np.float64),
                        suffix)
            with span("build.laplacian") as laplacian:
                gl = em.eigenmaps(aspace, self, clustered.centroids, n_items)
                self._sync()
            persist("save_sparse_matrix_with_builder", host64(gl.matrix),
                    "gl-matrix", structural_nnz=gl.structural_nnz)
            if self.prebuilt_spectral and aspace.signals is not None:
                persist("save_sparse_matrix_with_builder",
                        host64(aspace.signals), "aspace-signals",
                        structural_nnz=aspace._signals_nnz)
            with span("build.taumode") as taumode:
                em.compute_taumode(aspace, gl)
                self._sync()
            persist("save_lambda_with_builder", host64(aspace.lambdas),
                    "lambdas", projection=aspace.projection_matrix)
        self.stage_seconds = {"clustering": clustering.seconds,
                              "laplacian": laplacian.seconds,
                              "taumode": taumode.seconds}
        if store is not None:
            self.stage_seconds["persistence"] = t_persist
        logger.debug("ArrowSpaceBuilder configuration: %s", self)
        return aspace, gl

    def builder_config_typed(self) -> Dict[str, ConfigValue]:
        """Typed config map (reference: builder.rs:580-634), the keys of
        the JAX package's: the device, dtype and timings stay out."""
        return {
            "prebuilt_spectral": ConfigValue("Bool", self.prebuilt_spectral),
            "lambda_eps": ConfigValue("F64", self.lambda_eps),
            "lambda_k": ConfigValue("Usize", self.lambda_k),
            "lambda_topk": ConfigValue("Usize", self.lambda_topk),
            "lambda_p": ConfigValue("F64", self.lambda_p),
            "lambda_sigma": ConfigValue("OptionF64", self.lambda_sigma),
            "normalise": ConfigValue("Bool", self.normalise),
            "sparsity_check": ConfigValue("Bool", self.sparsity_check),
            "synthesis": ConfigValue("TauMode", self.synthesis),
            "sampling": ConfigValue("OptionSamplerType", self.sampling),
            "cluster_max_clusters": ConfigValue("OptionUsize",
                                                self.cluster_max_clusters),
            "cluster_radius": ConfigValue("F64", self.cluster_radius),
            "clustering_seed": ConfigValue("OptionU64", self.clustering_seed),
            "deterministic_clustering": ConfigValue(
                "Bool", self.deterministic_clustering),
            "use_dims_reduction": ConfigValue("Bool", self.use_dims_reduction),
            "rp_eps": ConfigValue("F64", self.rp_eps),
        }

    def __str__(self) -> str:
        """Cookie-style key=value dump (reference: builder.rs:459-524)."""
        fields = [("prebuilt_spectral", self.prebuilt_spectral),
                  ("lambda_eps", self.lambda_eps),
                  ("lambda_k", self.lambda_k),
                  ("lambda_topk", self.lambda_topk),
                  ("lambda_p", self.lambda_p),
                  ("lambda_sigma", self.lambda_sigma),
                  ("normalise", self.normalise),
                  ("sparsity_check", self.sparsity_check),
                  ("sampling", self.sampling)]
        out = [f"{k}={_fmt(v)}" for k, v in fields]
        out.append(f"synthesis={self.synthesis}")
        out += [f"{k}={_fmt(v)}" for k, v in (
            ("cluster_max_clusters", self.cluster_max_clusters),
            ("cluster_radius", self.cluster_radius),
            ("clustering_seed", self.clustering_seed),
            ("deterministic_clustering", self.deterministic_clustering),
            ("use_dims_reduction", self.use_dims_reduction),
            ("rp_eps", self.rp_eps))]
        out.append("persistence="
                   f"{self.persistence[1] if self.persistence else 'None'}")
        return ", ".join(out)
