"""ArrowIndex: the build/query facade and the serving session.

PyTorch counterpart of ``arrowspace_tpu.index``:

    index = ArrowIndex.build(rows, seed=11, device="cuda")
    scores, ids = index.search(queries, k=10, alpha=0.9)
    session = index.make_search_session(batch_size=2048, k=10, alpha=0.9)
    session.warmup()
    for scores, ids in session.search_stream(batches): ...
    # bf16 operands in K1 and K3 (float32 accumulation, λ and scores):
    index.make_search_session(2048, precision="bf16")
    index.search(queries, precision="bf16")

    energy = ArrowIndex.build_energy(rows, EnergyParams(
        allow_tall_graphs=True), seed=11, device="cuda")
    session = energy.make_energy_session(batch_size=2048, k=10)

    index.search_hybrid(query, k=10); index.range(lo, hi)
    index.aspace.add_items(a, b, index.gl); index.stats()

    index.save(path, "name"); ArrowIndex.load(path, "name", device="cuda")
    live = index.make_live_session(batch_size=2048, k=10, capacity=2**21)
    ids = live.add(rows); live.delete(ids[:5]); live.search(queries)

Without ``seed`` the build's clustering is the unseeded chunked scan.

A serving step is query-λ preparation (τ selection + synthetic λ on the
device) followed by the scoring + top-k kernel chosen by
session_kernel_kind: the binned kernel (K1) with exact strided repair of
flagged rows, the exact merge kernel (K3) above the width K1 serves
(float32 F > 352), or the plain product + stable sort.  The stream loop
keeps ``depth`` batches in flight: batch i+1 is enqueued on the current
stream before batch i's results are waited for.
"""

from __future__ import annotations

from collections import deque
from time import perf_counter_ns
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .builder import ArrowSpaceBuilder
from .config import numpy_dtype
from .core import ArrowItem, ArrowSpace, binned_fits, merge_fits
from .graph import GraphLaplacian
from .ops.bin_repair import BinnedEnergyTopK, BinnedTopK
from .ops.bintopk import bins_target, prepare_binned_corpus
from .ops.search import batched_lambda_aware_topk, rescore_topk_f64
from .ops.topk import fused_lambda_topk
from .sampling import SamplerType
from .taumode import TauMode, select_tau_batch, synthetic_lambda_batch
from .utils import profiling
from .utils.log import get_logger
from .utils.profiling import span

logger = get_logger("arrowspace.index")

__all__ = ["ArrowIndex", "SearchSession", "EnergySearchSession",
           "session_kernel_kind", "energy_session_config", "stream_search",
           "PRECISIONS", "check_precision"]


PRECISIONS = ("f32", "bf16")


def session_kernel_kind(nitems: int, k: int, f: int,
                        use_bf16: bool = False) -> str:
    """The serving step's top-k engine, keyed on size and operand dtype,
    never on the device: "binned" (K1 plus exact repair) where
    core.binned_fits admits the size (float32 up to F = 352, K1's wgmma
    route; bf16 up to 1536), "merge" (K3, exact, no repair) where only
    core.merge_fits does (wider F), else "plain".  core.lambda_aware_topk
    (search) takes the same engine."""
    if binned_fits(nitems, k, f, use_bf16):
        return "binned"
    return "merge" if merge_fits(nitems, k) else "plain"


def stream_search(step, batches, batch_size: int, depth: int, device,
                  dtype, dim: Optional[int] = None, repair=None,
                  session: Optional[int] = None):
    """Yield (scores, ids) host arrays per input batch with ``depth``
    batches in flight.

    ``step(q)`` enqueues one batch and returns (scores, ids, flags, qlam,
    det) device tensors, flags/det None for the plain kernel.  On CUDA
    the small results are copied into pinned host memory right behind
    the step and an event marks their arrival, so waiting for batch i
    lets batch i+1, already enqueued, keep the card busy.  When a batch
    that flagged rows is yielded, ``repair(q_block, qlam, det, scores,
    ids, flags)`` (BinnedTopK.repair) returns its host results with the
    flagged rows repaired.  A short batch (a stream tail) is padded to
    batch_size and sliced back.

    The stream keeps a utils.profiling stream record (its ``session`` the
    owning session record's id): spans ``stream.input`` (taking the next
    batch from ``batches``, its cast and padding), ``stream.launch`` (the
    pinned copy, the step, the result copies and the event),
    ``stream.wait`` (the event's wait), ``stream.repair`` (``repair``)
    and ``stream.caller`` (the caller's time between a yield and the next
    resumption); counters ``batches``, ``queries`` (unpadded) and
    ``rows_flagged``."""
    np_dtype = numpy_dtype(dtype)
    cuda = torch.device(device).type == "cuda"
    rec = profiling.Record("stream", session)
    # made once: a generator runs in one thread at a time, and none of
    # these spans is open across a yield
    s_input, s_launch, s_wait, s_repair = (span(f"stream.{name}") for name in
                                           ("input", "launch", "wait",
                                            "repair"))

    def launch(qb):
        if not cuda:
            out = step(torch.from_numpy(qb).to(device))
            return out, [t for t in out[:3] if t is not None], None
        # A copy from pageable memory synchronises the stream, which would
        # wait for the batches in flight; a pinned copy is only enqueued.
        q = torch.from_numpy(qb).pin_memory().to(device, non_blocking=True)
        out = step(q)
        small = [t for t in out[:3] if t is not None]
        host = [t.to("cpu", non_blocking=True) for t in small]
        ev = torch.cuda.Event()
        ev.record()
        return out, host, ev

    def finish(launched, m, qb):
        out, host, ev = launched
        with s_wait:
            if ev is not None:
                ev.synchronize()
        rec.count("batches")
        rec.count("queries", m)
        s, i = host[0].numpy()[:m], host[1].numpy()[:m]
        if len(host) < 3:
            return s, i
        flags = host[2].numpy()[:m]
        flagged = int(np.count_nonzero(flags))
        rec.count("rows_flagged", flagged)
        if repair is None or not flagged:
            return s, i
        with s_repair:
            return repair(qb, out[3], out[4], s, i, flags)

    def take(it):
        """The next batch from ``it``, cast and padded, with its number of
        queries; None at the end."""
        qb = next(it, end)
        if qb is end:
            return None
        qb = np.ascontiguousarray(qb, dtype=np_dtype)
        nq = qb.shape[0]
        if dim is not None and qb.shape[1] != dim:
            raise ValueError(f"query batch has {qb.shape[1]} features but "
                             f"the session index has {dim}")
        if nq > batch_size:
            raise ValueError(f"batch of {nq} exceeds the session "
                             f"batch_size {batch_size}")
        if nq < batch_size:
            qb = np.pad(qb, ((0, batch_size - nq), (0, 0)),
                        constant_values=1.0)
        return qb, nq

    end = object()
    it, pending = iter(batches), deque()
    while True:
        with rec:
            with s_input:
                got = take(it)
            if got is None:
                break
            with s_launch:
                pending.append((launch(got[0]), got[1], got[0]))
            if len(pending) <= depth:
                continue
            out = finish(*pending.popleft())
        t = perf_counter_ns()
        yield out
        rec.add("stream.caller", perf_counter_ns() - t)
    while pending:
        with rec:
            out = finish(*pending.popleft())
        t = perf_counter_ns()
        yield out
        rec.add("stream.caller", perf_counter_ns() - t)


def _query_prep(aspace: ArrowSpace, gl: GraphLaplacian):
    """The sessions' query preparation on the index device, as two
    functions: ``project`` maps q (B, F) to the index space (q @ P when
    the build projected, else q), and ``prepare`` returns (project(q),
    λ (B,)) with λ from the projected query (the session step of the JAX
    package, index.py:79-84), timed as the span ``stream.prepare``."""
    lap = gl.matrix.to(device=aspace.device, dtype=aspace.dtype)
    taumode, pad_tall = aspace.taumode, aspace.pad_tall_graphs
    proj = None if aspace.projection_matrix is None else \
        aspace.projection_matrix.matrix(dtype=aspace.dtype,
                                        device=aspace.device)

    def project(q):
        return q if proj is None else q @ proj

    def prepare(q):
        with span("stream.prepare"):
            q_prep = project(q)
            taus = select_tau_batch(q_prep, taumode)
            return q_prep, synthetic_lambda_batch(q_prep, lap, taus,
                                                  pad_items=pad_tall)
    return project, prepare


def check_precision(precision: str) -> bool:
    """Whether a session's ``precision`` asks for bf16; ValueError unless
    it is one of PRECISIONS (index.py:404-405 of the JAX package)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unsupported precision {precision!r}; one of "
                         f"{PRECISIONS}")
    return precision == "bf16"


class SearchSession:
    """Pipelined streaming search for serving.

    One step per batch fuses query-λ preparation with scoring + top-k; on
    the binned and merge kernels the corpus is normalised and padded
    once, here.  On the binned kernel flagged rows are repaired through
    the strided repair, with the exact merge kernel (K3) for rows whose
    fired bins overflow; the merge kernel is exact and flags nothing
    (index.py:94-98 of the JAX package).

    ``precision="bf16"`` gives K1 and K3 bf16 operands wherever one of
    them serves (its repair and K3 fallback included): the session holds
    one bf16 prepared corpus, λ, c1 and the scores stay float32.  The
    plain engine serves the index dtype (index.py:429-445 of the JAX
    package); ``self.precision`` says what the session serves.

    ``prepare_corpus=False`` (index.py:393-402 of the JAX package) keeps
    no prepared copy resident: each step prepares one for K1 or K3 and
    drops it once the kernel is enqueued, and the strided repair prepares
    the rows it gathers from the raw corpus.  That trades the
    preparation's passes over the corpus, every batch, for the copy's
    memory (N·F·4 bytes in float32, half that in bf16), for example to
    serve two large indexes from one card; results equal the prepared
    session's bitwise.

    ``record`` is the session's utils.profiling record: construction
    (ended by a synchronise) is its span ``session.prepare``, ``warmup``
    its span ``session.warmup``, and the record of each of its streams
    carries its id."""

    def __init__(self, index: "ArrowIndex", batch_size: int, k: int = 10,
                 alpha: float = 0.9, depth: int = 2,
                 precision: str = "f32", prepare_corpus: bool = True):
        want_bf16 = check_precision(precision)
        self.record = profiling.Record("session")
        with self.record, span("session.prepare"):
            aspace, gl = index.aspace, index.gl
            self.batch_size = int(batch_size)
            self.k = min(int(k), index.nitems)
            self.alpha = float(alpha)
            self.depth = max(1, int(depth))
            self.device, self.dtype = aspace.device, aspace.dtype
            self._dim = aspace.nfeatures
            self.kernel = session_kernel_kind(index.nitems, self.k,
                                              aspace.nfeatures, want_bf16)
            use_bf16 = want_bf16 and self.kernel != "plain"
            self.precision = "bf16" if use_bf16 else "f32"
            k_eff, alpha_f = self.k, self.alpha
            _, prepare = _query_prep(aspace, gl)
            data, lambdas = aspace.data, aspace.lambdas
            self.prepare_corpus = bool(prepare_corpus)
            engine = BinnedTopK(data, lambdas, alpha_f, k_eff,
                                use_bf16=use_bf16,
                                prepare_corpus=self.prepare_corpus) \
                if self.kernel == "binned" else None
            if self.kernel == "merge" and self.prepare_corpus:
                xhat, xlam = prepare_binned_corpus(data, lambdas,
                                                   use_bf16=use_bf16)
                n_items = index.nitems

                def exact(q, qlam):
                    return fused_lambda_topk(q, qlam, xhat, xlam, alpha_f,
                                             k=k_eff, prepared=True,
                                             n_items=n_items)
            elif self.kernel == "merge":
                def exact(q, qlam):
                    return fused_lambda_topk(q, qlam, data, lambdas, alpha_f,
                                             k=k_eff, use_bf16=use_bf16)
            else:
                def exact(q, qlam):
                    return batched_lambda_aware_topk(q, qlam, data, lambdas,
                                                     alpha_f, k=k_eff)

            def step(q):
                _, qlam = prepare(q)
                if engine is not None:
                    s, i, flags, det = engine.step(q, qlam)
                    return s, i, flags, qlam, det
                s, i = exact(q, qlam)
                return s, i, None, qlam, None

            self._step = step
            self._repair = engine.repair if engine is not None else None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run one full batch through the stream loop and, on the binned
        kernel, one synthetic strided repair, so that kernel builds and
        first-call costs land here and not on the first real batch (the
        session record's span ``session.warmup``)."""
        with self.record, span("session.warmup"):
            ones = np.ones((self.batch_size, self._dim))
            list(self.search_stream([ones]))
            if self._repair is not None:
                k = self.k
                det = torch.full((1, bins_target(k)), -1.0, device=self.device,
                                 dtype=self.dtype)
                det[0, 0] = 1.0                  # one fired bin
                self._repair(ones[:1], torch.zeros(1, device=self.device,
                                                   dtype=self.dtype), det,
                             np.zeros((1, k)), np.arange(k)[None, :],
                             np.ones(1, dtype=bool))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def search_stream(self, batches: Iterable
                      ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Yield (scores, ids) per input batch, ``depth`` batches in
        flight (see stream_search)."""
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self.device, self.dtype,
                             dim=self._dim, repair=self._repair,
                             session=self.record.id)


def energy_session_config(nitems: int, k: int, z_width: int) -> str:
    """The energy serving step's engine, keyed on size, never on the
    device: "binned" (K6 plus exact repair, or K7 with approx) where
    energymaps.energy_binned_fits admits the size (N > 65536, k <= 128,
    a z-width within the kernels' shared memory), else "chunked" (the
    plain chunked scan)."""
    from .energymaps import energy_binned_fits
    return "binned" if energy_binned_fits(nitems, k, z_width) \
        else "chunked"


def _energy_query_prep(aspace: ArrowSpace, gl: GraphLaplacian):
    """The energy sessions' query preparation on the index device, as two
    functions: ``to_z`` maps raw queries (B, F) to the z-plane (projected,
    then through the signals graph where energymaps.energy_signals finds
    one), and ``prepare`` returns (to_z(q), λ (B,)), λ against gl.matrix
    as for every query (see ArrowSpace.lambda_graph)."""
    from .energymaps import energy_signals
    project, prepare_q = _query_prep(aspace, gl)
    sig = energy_signals(aspace, aspace.projected_items().shape[1])

    def through(q_prep):
        return q_prep if sig is None else q_prep @ sig.T

    def to_z(q):
        return through(project(q))

    def prepare(q):
        q_prep, qlam = prepare_q(q)
        return through(q_prep), qlam
    return to_z, prepare


def energy_z_plane(aspace: ArrowSpace) -> torch.Tensor:
    """The corpus z-plane the energy sessions serve: the projected items,
    through the signals graph where one is attached (cached on the
    ArrowSpace, energymaps._energy_z_items)."""
    from .energymaps import _energy_z_items, energy_signals
    items_proj = aspace.projected_items()
    return _energy_z_items(aspace, items_proj,
                           energy_signals(aspace, items_proj.shape[1]))


class EnergySearchSession:
    """Pipelined streaming ENERGY search for serving (indices built with
    build_energy).

    One step per batch: query-λ preparation, the z-projection of the
    queries, then the binned energy engine (K6; K7 with ``approx``) or,
    below its gate, the plain chunked scan.  Flagged rows are repaired
    exactly when their batch is yielded: K6's deep-collision rows through
    the strided repair (the chunked scan for rows whose fired bins
    overflow), K7's uncertified rows through K6 on a padded block.
    ``approx=True`` needs the binned engine and a resident prepared
    z-plane, and raises otherwise (index.py:592-597 of the JAX package).
    ``prepare_corpus=False`` keeps no centred z-plane resident: each step
    (and each repair) prepares one and drops it once its kernels are
    enqueued, with results bitwise the prepared session's.  Results are
    exact either way.  ``record``: as SearchSession's."""

    def __init__(self, index: "ArrowIndex", batch_size: int, k: int = 10,
                 w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                 depth: int = 2, prepare_corpus: bool = True,
                 approx: bool = False):
        from .ops.energy_bintopk import energy_topk_chunked

        self.record = profiling.Record("session")
        with self.record, span("session.prepare"):
            aspace, gl = index.aspace, index.gl
            self.batch_size = int(batch_size)
            self.k = min(int(k), index.nitems)
            self.depth = max(1, int(depth))
            self.device, self.dtype = aspace.device, aspace.dtype
            self._dim = aspace.nfeatures
            # the z-plane: the projected items, through the signals graph
            # where one is attached (index.py:547-620 of the JAX package)
            to_z, self.prepare = _energy_query_prep(aspace, gl)
            z_items = energy_z_plane(aspace)
            lambdas = aspace.lambdas
            kernel = energy_session_config(index.nitems, self.k,
                                           z_items.shape[1])
            if approx and (kernel != "binned" or not prepare_corpus):
                raise ValueError(
                    "approx=True needs the binned energy engine (more than "
                    "65536 rows, k <= 128, a z-width the kernels admit) on "
                    "a prepared z-plane; this session resolved "
                    f"kernel={kernel!r}, "
                    f"prepare_corpus={bool(prepare_corpus)}")
            self.kernel = "binned_approx" if approx else kernel
            self.prepare_corpus = bool(prepare_corpus)
            engine = BinnedEnergyTopK(z_items, lambdas, w_lambda,
                                      w_dirichlet, self.k, approx=approx,
                                      project=to_z,
                                      prepare_corpus=self.prepare_corpus) \
                if kernel == "binned" else None
            k_eff = self.k

            def step(q):
                z_q, qlam = self.prepare(q)
                if engine is not None:
                    s, i, flags, det = engine.step(z_q, qlam)
                    return s, i, flags, qlam, det
                s, i = energy_topk_chunked(z_q, qlam, z_items, lambdas,
                                           w_lambda, w_dirichlet, k=k_eff)
                return s, i, None, qlam, None

            self._step = step
            self.engine = engine
            self._repair = engine.repair if engine is not None else None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run one full batch through the stream loop and one synthetic
        repair of a flagged row (the strided repair, or with approx the
        exact K6 block), so that kernel builds and first-call costs land
        here and not on the first real batch (the session record's span
        ``session.warmup``)."""
        with self.record, span("session.warmup"):
            ones = np.ones((self.batch_size, self._dim))
            list(self.search_stream([ones]))
            if self.engine is not None:
                k = self.k
                det = None
                if not self.engine.approx:
                    det = torch.full((1, bins_target(k)), -1.0,
                                     device=self.device, dtype=self.dtype)
                    det[0, 0] = 1.0              # one fired bin
                self._repair(ones[:1], torch.zeros(1, device=self.device,
                                                   dtype=self.dtype), det,
                             np.zeros((1, k)), np.arange(k)[None, :],
                             np.ones(1, dtype=bool))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def search_stream(self, batches: Iterable
                      ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Yield (scores, ids) per input batch, ``depth`` batches in
        flight (see stream_search)."""
        return stream_search(self._step, batches, self.batch_size,
                             self.depth, self.device, self.dtype,
                             dim=self._dim, repair=self._repair,
                             session=self.record.id)


class ArrowIndex:
    """Built index = ArrowSpace + GraphLaplacian + builder config."""

    def __init__(self, aspace: ArrowSpace, gl: GraphLaplacian,
                 builder: Optional[ArrowSpaceBuilder] = None):
        self.aspace = aspace
        self.gl = gl
        self.builder = builder

    @classmethod
    def build(cls, rows, *, eps: float = 1e-3, k: int = 6, topk: int = 3,
              p: float = 2.0, sigma: Optional[float] = None,
              taumode: TauMode = TauMode.median(),
              normalise: bool = False,
              sampling: Optional[SamplerType] = SamplerType.simple(0.6),
              dims_reduction: bool = False, rp_eps: Optional[float] = None,
              seed: Optional[int] = None, spectral: bool = False,
              device=None, dtype=None) -> "ArrowIndex":
        """Build an index over the rows (ArrowSpaceBuilder's options by
        their names there); ``spectral=True`` also builds the
        signals graph and computes item λ against it (with_spectral)."""
        b = (ArrowSpaceBuilder(device=device, dtype=dtype)
             .with_lambda_graph(eps, k, topk, p, sigma)
             .with_synthesis(taumode)
             .with_normalisation(normalise)
             .with_inline_sampling(sampling)
             .with_dims_reduction(dims_reduction, rp_eps))
        if spectral:
            b = b.with_spectral(True)
        if seed is not None:
            b = b.with_seed(seed)
        aspace, gl = b.build(rows)
        return cls(aspace, gl, b)

    @classmethod
    def build_energy(cls, rows, energy_params=None, *,
                     seed: Optional[int] = None, device=None, dtype=None,
                     **kwargs) -> "ArrowIndex":
        """Energy build (energymaps.build_energy) with dims reduction on
        (rp_eps from kwargs, default 0.5) and, when ``eps`` is given, the
        λ-graph parameters eps/k/topk/p/sigma from kwargs (index.py:744-760
        of the JAX package).  A corpus whose sub-centroid graph outgrows
        its feature count needs EnergyParams(allow_tall_graphs=True)."""
        from .energymaps import EnergyParams, build_energy
        b = ArrowSpaceBuilder(device=device, dtype=dtype) \
            .with_dims_reduction(True, kwargs.get("rp_eps", 0.5))
        if "eps" in kwargs:
            b = b.with_lambda_graph(kwargs["eps"], kwargs.get("k", 6),
                                    kwargs.get("topk", 3),
                                    kwargs.get("p", 2.0),
                                    kwargs.get("sigma"))
        if seed is not None:
            b = b.with_seed(seed)
        aspace, gl = build_energy(b, rows, energy_params or EnergyParams())
        return cls(aspace, gl, b)

    def _synthesize_builder(self) -> ArrowSpaceBuilder:
        """Builder config reconstructed from the index's state, for an
        index with no builder attached (a loaded one): persisting the
        defaults instead would change query-λ preparation on a
        load -> save -> load round trip (index.py:763-781 of the JAX
        package)."""
        a = self.aspace
        b = ArrowSpaceBuilder(device=a.device, dtype=a.dtype)
        b.synthesis = a.taumode
        gp = getattr(self.gl, "graph_params", None)
        if gp is not None:
            b.with_lambda_graph(gp.eps, gp.k, gp.topk, gp.p, gp.sigma)
            b.normalise = gp.normalise
            b.sparsity_check = gp.sparsity_check
        b.use_dims_reduction = a.projection_matrix is not None
        b.prebuilt_spectral = a.signals is not None and a.signals.shape[0] > 0
        b.cluster_max_clusters = a.n_clusters or None
        b.cluster_radius = a.cluster_radius or 1.0
        return b

    def save(self, path, name: str) -> None:
        """Persist as the builder's Parquet artifacts (storage/parquet),
        which the reference's tooling and the JAX package read too
        (projected indexes excepted: see storage/parquet).  The raw input
        is the item matrix as float64, so a reload gives the same
        tensors.  Each device tensor is copied to the host once."""
        import pathlib

        from .storage import parquet as pq
        base = pathlib.Path(path)
        base.mkdir(parents=True, exist_ok=True)
        a = self.aspace
        b = self.builder or self._synthesize_builder()

        def host64(t):
            return t.double().cpu().numpy()
        pq.save_dense_matrix_with_builder(host64(a.data), base,
                                          f"{name}-raw_input", b)
        pq.save_dense_matrix_with_builder(host64(self.gl.init_data).T, base,
                                          f"{name}-laplacian-input", b)
        pq.save_sparse_matrix_with_builder(
            host64(self.gl.matrix), base, f"{name}-gl-matrix", b,
            structural_nnz=self.gl.structural_nnz)
        pq.save_lambda_with_builder(host64(a.lambdas), base,
                                    f"{name}-lambdas", b,
                                    projection=a.projection_matrix)
        if a.signals is not None and a.signals.shape[0] > 0:
            pq.save_sparse_matrix_with_builder(
                host64(a.signals), base, f"{name}-aspace-signals", b)
        logger.info("index saved to %s as '%s'", base, name)

    @classmethod
    def load(cls, path, name: str, *, device=None,
             dtype=None) -> "ArrowIndex":
        """An index saved by ``save`` (or a build with persistence), on
        ``device`` in ``dtype``; no λ is computed."""
        from .storage import parquet as pq
        aspace, gl = pq.load_arrowspace_index(path, name, device=device,
                                              dtype=dtype)
        return cls(aspace, gl)

    def search(self, queries, k: int = 10, alpha: float = 0.9,
               use_pallas: Optional[bool] = None, precision: str = "f32",
               rescore_pool: Optional[int] = None):
        """Batched λ-aware search: (B, F) -> host (scores (B, k),
        ids (B, k)).  precision="f64_rescore" re-ranks a candidate pool
        of max(4k, k+32) (or rescore_pool) against the original float64
        rows on the host.  precision="bf16" gives K1 (with its repair)
        or, above K1's bf16 gate, K3 bf16 operands with float32
        accumulation; scores then differ from float32's in the third
        decimal.  Below the streaming kernels' size it serves the plain
        scan in the index dtype, as the JAX package does off a TPU.
        ``use_pallas`` (every precision, the rescore's candidate pool
        included): None takes the engine the size gates pick, False the
        plain scan, True the kernels at any row count
        (ArrowSpace.search_lambda_aware_batch)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        qlam = self.aspace.prepare_query_items_batch(queries, self.gl)
        if precision == "f64_rescore":
            if self.aspace.host_rows is None:
                raise ValueError(
                    "f64_rescore needs the original f64 rows; a mutation "
                    "of the index's items dropped them")
            m = min(rescore_pool or max(4 * k, k + 32), self.aspace.nitems)
            _s, cand = self.aspace.search_lambda_aware_batch(
                queries, qlam, m, alpha, use_pallas=use_pallas)
            return rescore_topk_f64(
                queries, qlam.cpu().numpy(), self.aspace.host_rows,
                self.aspace.lambdas.cpu().numpy(), alpha, cand.cpu().numpy(),
                min(k, self.aspace.nitems))
        use_bf16 = check_precision(precision)
        scores, ids = self.aspace.search_lambda_aware_batch(
            queries, qlam, k, alpha, use_pallas=use_pallas,
            use_bf16=use_bf16)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def search_one(self, query, k: int = 10, alpha: float = 0.9
                   ) -> List[Tuple[int, float]]:
        qlam = self.aspace.prepare_query_item(query, self.gl)
        return self.aspace.search_lambda_aware(ArrowItem(query, qlam), k,
                                               alpha)

    def search_hybrid(self, query, k: int = 10, alpha: float = 0.9
                      ) -> List[Tuple[int, float]]:
        """Hybrid search (ArrowSpace.search_lambda_aware_hybrid) with the
        query's λ prepared first."""
        qlam = self.aspace.prepare_query_item(query, self.gl)
        return self.aspace.search_lambda_aware_hybrid(
            ArrowItem(query, qlam), k, alpha)

    def range(self, lo: float, hi: float,
              limit: Optional[int] = None) -> List[Tuple[int, float]]:
        """Two-sided λ band via the sorted index (O(log N + M))."""
        return self.aspace.range_search_sorted(lo, hi, limit)

    def make_search_session(self, batch_size: int, k: int = 10,
                            alpha: float = 0.9, depth: int = 2,
                            precision: str = "f32",
                            prepare_corpus: bool = True) -> SearchSession:
        """Streaming search for serving, ``depth`` batches in flight;
        precision "f32" or "bf16"; prepare_corpus=False keeps no
        prepared corpus copy resident (SearchSession)."""
        return SearchSession(self, batch_size, k=k, alpha=alpha, depth=depth,
                             precision=precision,
                             prepare_corpus=prepare_corpus)

    def make_pruned_session(self, batch_size: int = 16, k: int = 10,
                            alpha: float = 0.9, cap: int = 256,
                            m_cells: Optional[int] = None,
                            margin: float = 1e-3, seed: int = 0,
                            m_vote: int = 8,
                            union_cells: Optional[int] = None,
                            auto_budget: bool = False,
                            engine: str = "host",
                            n_clusters: Optional[int] = None,
                            lloyd_sample: Optional[int] = None):
        """Exact cell-screened search (pruned.PrunedSearchSession): a
        query scores only the corpus units whose bound can reach its
        top-k, and one the bounds cannot certify re-runs through the full
        scan.  B <= 16 gathers units per query, B in (16, 512] scores one
        union of voted units per batch.  auto_budget=True grows the
        budget while more than 5 % of a full window of queries flag.
        engine="device" builds the layout on the device
        (pruned.build_cells_device, for large corpora); n_clusters (2-4x
        the corpus's expected cluster count) and lloyd_sample tune the
        Lloyd pass."""
        from .pruned import PrunedSearchSession
        return PrunedSearchSession(self, batch_size, k=k, alpha=alpha,
                                   cap=cap, m_cells=m_cells, margin=margin,
                                   seed=seed, m_vote=m_vote,
                                   union_cells=union_cells,
                                   auto_budget=auto_budget, engine=engine,
                                   n_clusters=n_clusters,
                                   lloyd_sample=lloyd_sample)

    def make_live_session(self, batch_size: int, k: int = 10,
                          alpha: float = 0.9, depth: int = 2,
                          capacity: Optional[int] = None,
                          precision: str = "f32"):
        """Serving session with add/update/delete: the corpus lives in a
        capacity buffer on the device and the live row count reaches the
        kernels as their ``n`` (live.LiveSearchSession).  Results carry
        stable external ids.  precision="bf16" serves bf16 operands on
        the binned engine."""
        from .live import LiveSearchSession
        return LiveSearchSession(self, batch_size, k=k, alpha=alpha,
                                 depth=depth, capacity=capacity,
                                 precision=precision)

    def make_live_energy_session(self, batch_size: int, k: int = 10,
                                 w_lambda: float = 1.0,
                                 w_dirichlet: float = 0.5, depth: int = 2,
                                 capacity: Optional[int] = None):
        """Energy-index live session: add/update/delete over a capacity
        buffer of the z-plane (live.LiveEnergySearchSession)."""
        from .live import LiveEnergySearchSession
        return LiveEnergySearchSession(self, batch_size, k=k,
                                       w_lambda=w_lambda,
                                       w_dirichlet=w_dirichlet, depth=depth,
                                       capacity=capacity)

    def search_energy(self, queries, k: int = 10, w_lambda: float = 1.0,
                      w_dirichlet: float = 0.5):
        """Batched energy-only ranking (indices built with build_energy):
        (B, F) -> host (scores (B, k), ids (B, k))."""
        from .energymaps import search_energy_batch
        return search_energy_batch(self.aspace, queries, self.gl, k,
                                   w_lambda, w_dirichlet)

    def make_energy_session(self, batch_size: int, k: int = 10,
                            w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                            depth: int = 2, prepare_corpus: bool = True,
                            approx: bool = False) -> EnergySearchSession:
        """Streaming energy search for serving, ``depth`` batches in
        flight; approx=True serves through the certified chord-surrogate
        kernel (K7), whose uncertified rows re-run exactly;
        prepare_corpus=False keeps no centred z-plane resident."""
        return EnergySearchSession(self, batch_size, k=k, w_lambda=w_lambda,
                                   w_dirichlet=w_dirichlet, depth=depth,
                                   prepare_corpus=prepare_corpus,
                                   approx=approx)

    def warmup(self, batch_sizes=(1, 16, 256), k: int = 10,
               alpha: float = 0.9) -> None:
        """One search at each batch size, so that kernel builds and
        first-call costs land here and not on the first query."""
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            q = rng.uniform(0.1, 1.0, (b, self.aspace.nfeatures))
            self.search(q, k=min(k, self.nitems), alpha=alpha)
        logger.info("warmup complete for batch sizes %s", batch_sizes)

    @property
    def lambdas(self) -> np.ndarray:
        return self.aspace.lambdas.cpu().numpy()

    @property
    def nitems(self) -> int:
        return self.aspace.nitems

    def stats(self) -> dict:
        lam = self.lambdas
        gstats = self.gl.statistics()
        return {
            "n_items": self.aspace.nitems,
            "n_features": self.aspace.nfeatures,
            "n_clusters": self.aspace.n_clusters,
            "graph_nodes": self.gl.shape()[0],
            "graph_nnz": self.gl.nnz(),
            "graph_sparsity": gstats.sparsity,
            "lambda_min": float(lam.min()),
            "lambda_max": float(lam.max()),
            "lambda_mean": float(lam.mean()),
            "lambda_std": float(lam.std()),
        }
