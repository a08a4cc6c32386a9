"""Live serving sessions: add, update and delete between batches of search.

PyTorch counterpart of ``arrowspace_tpu.live``.  The corpus lives on the
device in a capacity buffer with more rows than it serves; the live row
count ``n`` reaches the kernels (K1, K3, K6) and the strided repairs as
their row count, so a mutation is a few row writes and a host counter,
and serving stays on the same kernels as a static session:

* ``add`` ingests raw rows by the index's query preparation: projection
  (when the build projected), τ (select_tau_batch, K4 by its gate) and
  λ (synthetic_lambda_batch against the frozen build graph, zero-padded
  to a tall graph where the build allowed one), then the rows are
  written in place, with the arithmetic of the prepared corpus.  λ of an
  edited row is what ArrowSpace._refresh_lambda_row would assign, the
  trade the reference makes: edits never rebuild the graph
  (core.rs:644); ``to_index()`` and a rebuild refresh it.
* ``delete`` swaps the tail survivors into the holes (one
  ``index_copy_`` per row array) and shrinks the live count; the rows
  past it keep stale data, which no kernel scores.  Positions change, so
  results carry stable EXTERNAL ids through a host-side table.
* Rows are ingested in blocks of at most MAX_MUTATION_BLOCK.  The JAX
  package pads mutation index vectors to power-of-two buckets to bound
  XLA recompiles (live.py:256-268); a CUDA launch needs no such padding.

Searches interleaved with mutations see a consistent snapshot: each
batch reads the live count when it is enqueued.  Mutating while a
``search_stream`` has batches in flight applies to later batches;
deleting during an in-flight stream is not supported (a flagged batch's
repair reads the count when the batch is yielded).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .index import (ArrowIndex, _energy_query_prep, _query_prep,
                    check_precision, energy_session_config, energy_z_plane,
                    session_kernel_kind, stream_search)
from .ops.bin_repair import BinnedEnergyTopK, BinnedTopK
from .ops.bintopk import (CORPUS_ALIGN, bins_target, prepare_binned_corpus,
                          prepared_rows)
from .ops.energy_bintopk import energy_topk_chunked
from .ops.search import batched_lambda_aware_topk
from .ops.topk import fused_lambda_topk
from .utils.log import get_logger

logger = get_logger("arrowspace.live")

__all__ = ["LiveSearchSession", "LiveEnergySearchSession"]


def _capacity_rows(cap: int) -> int:
    """A capacity rounded up to whole CORPUS_ALIGN rows: whole bin tiles
    of every bin count the binned kernels take."""
    return -(-int(cap) // CORPUS_ALIGN) * CORPUS_ALIGN


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """t zero-padded along its first axis to ``rows`` rows, contiguous."""
    pad = [0, 0] * (t.dim() - 1) + [0, rows - t.shape[0]]
    return torch.nn.functional.pad(t, pad).contiguous()


class _LiveBase:
    """The live sessions' shared machinery: the external-id table, the
    mutations and the search drivers (live.py:270-466 of the JAX
    package).  A subclass holds the device state and provides
    _ingest_rows(rows, positions), _row_arrays() (the tensors a delete
    compacts), _grow_arrays(rows), _set_n(), _step and _repair."""

    MAX_MUTATION_BLOCK = 4096

    def _init_ids(self, n0: int, cap_rows: int) -> None:
        self.capacity = cap_rows       # the rounding's headroom is usable
        self._n = n0
        self._ids = np.full(cap_rows, -1, dtype=np.int64)
        self._ids[:n0] = np.arange(n0)
        self._pos = {i: i for i in range(n0)}
        self._next_id = n0

    @property
    def nitems(self) -> int:
        return self._n

    def _check_k_vs_live(self) -> None:
        # a user-reachable state (deletes shrink n below k): the missing
        # slots would map to stale or -1 external ids, so raise
        if self.k > self._n:
            raise ValueError(
                f"k={self.k} exceeds the live corpus size {self._n}; "
                f"add rows (or rebuild the session with a smaller k)")

    def _position_of(self, ext_id) -> int:
        try:
            return self._pos[int(ext_id)]
        except KeyError:
            raise KeyError(
                f"unknown or deleted external id {int(ext_id)}") from None

    def _positions(self, pos) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pos, dtype=np.int64),
                               device=self.device)

    # -- mutation -------------------------------------------------------
    def add(self, rows) -> np.ndarray:
        """Ingest new vectors; returns their external ids (int64).  λ is
        assigned by the index's preparation pipeline against the frozen
        build graph (see the module docstring)."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        m = rows.shape[0]
        if m == 0:
            return np.empty((0,), dtype=np.int64)
        if rows.shape[1] != self._dim:
            raise ValueError(
                f"rows have {rows.shape[1]} features, index has {self._dim}")
        if self._n + m > self.capacity:
            raise ValueError(
                f"live corpus full: {self._n} + {m} > capacity "
                f"{self.capacity}; construct the session with a larger "
                f"capacity= (or grow(), which reallocates)")
        positions = np.arange(self._n, self._n + m)
        self._ingest_blocks(rows, positions)
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._ids[positions] = ids
        for i, p in zip(ids.tolist(), positions.tolist()):
            self._pos[i] = p
        self._next_id += m
        self._n += m
        self._set_n()
        return ids

    def update(self, ids, rows) -> None:
        """Overwrite existing vectors in place; λ is refreshed as
        ArrowSpace.set_item + _refresh_lambda_row would refresh it."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        if len(ids) != rows.shape[0]:
            raise ValueError(
                f"update(): {len(ids)} ids but {rows.shape[0]} rows")
        if len(np.unique(ids)) != len(ids):
            # two different rows for one position: which one survives
            # would be the caller's guess, so refuse
            uniq, counts = np.unique(ids, return_counts=True)
            dupes = uniq[counts > 1]
            raise ValueError(
                f"update(): duplicate external ids {dupes[:8]}"
                f" — deduplicate on the caller side (keep the intended "
                f"occurrence) before dispatch")
        positions = np.array([self._position_of(i) for i in ids])
        self._ingest_blocks(rows, positions)

    def delete(self, ids) -> None:
        """Remove vectors by external id: the tail survivors move into
        the holes (swap with the last rows), wherever the holes are."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        doomed = sorted({self._position_of(i) for i in ids})
        m = len(doomed)
        if m == 0:
            return
        n_new = self._n - m
        doomed_set = set(doomed)
        holes = [p for p in doomed if p < n_new]
        survivors = [p for p in range(n_new, self._n)
                     if p not in doomed_set]
        assert len(holes) == len(survivors), (holes, survivors)
        if holes:
            src, dst = self._positions(survivors), self._positions(holes)
            for a in self._row_arrays():
                a.index_copy_(0, dst, a.index_select(0, src))
            for s, d in zip(survivors, holes):
                moved = int(self._ids[s])
                self._ids[d] = moved
                self._pos[moved] = d
        for i in ids.tolist():
            self._pos.pop(i, None)
        self._ids[n_new:self._n] = -1
        self._n = n_new
        self._set_n()

    def _ingest_blocks(self, rows: np.ndarray, positions: np.ndarray) -> None:
        for lo in range(0, len(positions), self.MAX_MUTATION_BLOCK):
            hi = min(lo + self.MAX_MUTATION_BLOCK, len(positions))
            self._ingest_rows(rows[lo:hi], positions[lo:hi])

    def grow(self, new_capacity: int) -> None:
        """Reallocate the buffers to a larger capacity (a copy of the
        corpus on the device); prefer sizing capacity up front."""
        cap_rows = _capacity_rows(new_capacity)
        if cap_rows <= self.capacity:
            return
        self._grow_arrays(cap_rows)
        self._ids = np.concatenate(
            [self._ids, np.full(cap_rows - self.capacity, -1,
                                dtype=np.int64)])
        logger.info("live session grown %d -> %d rows", self.capacity,
                    cap_rows)
        self.capacity = cap_rows

    # -- search ---------------------------------------------------------
    def _stream(self, batches, depth: int):
        return stream_search(self._step, batches, self.batch_size, depth,
                             self.device, self.dtype, dim=self._dim,
                             repair=self._repair)

    def warmup(self, mutation_buckets=(1, 2)) -> None:
        """Run one full batch and, on a binned engine, one synthetic
        repair of a flagged row, then add and delete blocks of zero rows
        of each size in ``mutation_buckets`` (a multi-row block loses its
        first row first, which moves a survivor): first-call costs land
        here and not on the first real batch or mutation.  The corpus is
        left as it was; a block that does not fit the free capacity is
        skipped."""
        ones = np.ones((self.batch_size, self._dim))
        list(self._stream([ones], 1))
        if self._repair is not None:
            k = self.k
            det = torch.full((1, bins_target(k)), -1.0, device=self.device,
                             dtype=self.dtype)
            det[0, 0] = 1.0                  # one fired bin
            self._repair(ones[:1], torch.zeros(1, device=self.device,
                                               dtype=self.dtype), det,
                         np.zeros((1, k)), np.arange(k)[None, :],
                         np.ones(1, dtype=bool))
        for b in sorted({int(x) for x in mutation_buckets}):
            if b < 1 or self._n + b > self.capacity:
                continue
            pid = self.add(np.zeros((b, self._dim)))
            self.delete(pid[:1])
            if b > 1:
                self.delete(pid[1:])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def search(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous batched search over the CURRENT live rows:
        (B, F) -> (scores (B, k), external ids (B, k) int64)."""
        self._check_k_vs_live()
        queries = np.atleast_2d(np.asarray(queries))
        out = [next(iter(self._stream([queries[lo:lo + self.batch_size]],
                                      1)))
               for lo in range(0, queries.shape[0], self.batch_size)]
        s = np.concatenate([o[0] for o in out], axis=0)
        i = np.concatenate([o[1] for o in out], axis=0)
        return s, self._ids[i]

    def search_stream(self, batches: Iterable
                      ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined streaming search (index.stream_search), ``depth``
        batches in flight; yields (scores, external ids) per batch.
        Mutations between batches apply to later batches; the id table
        is read when a batch is yielded, so do not DELETE during an
        in-flight stream."""
        self._check_k_vs_live()
        for s, i in self._stream(batches, self.depth):
            yield s, self._ids[i]


class LiveSearchSession(_LiveBase):
    """Serving session over a live corpus in a capacity buffer (λ-aware
    cosine scoring), with add / update / delete between batches.

    The engine is chosen once, at capacity (index.session_kernel_kind):
    "binned" is K1 with the strided repair (K3 for rows whose fired bins
    overflow), "merge" is K3 where F is above K1's gate (the JAX package
    serves that size with a masked XLA step), "plain" a plain scan of the
    first ``nitems`` rows.  On the first two the prepared corpus
    (prepare_binned_corpus) is kept at capacity and written in place.
    Results carry stable EXTERNAL ids (int64): the index's rows get ids
    0..n-1, ``add`` returns fresh ones.  ``capacity`` (default: the index
    size) bounds the live row count and is rounded up to CORPUS_ALIGN
    rows; ``grow()`` reallocates.  A query's λ is prepared against the
    build graph as in SearchSession.

    ``precision="bf16"`` serves bf16 operands on the binned engine only
    (live.py:530 of the JAX package): the capacity buffer is then bf16,
    and ``add`` / ``update`` write rows by prepared_rows, so an added row
    scores bitwise as a prepared one; the other engines serve the index
    dtype (``self.precision`` says which)."""

    def __init__(self, index: ArrowIndex, batch_size: int, k: int = 10,
                 alpha: float = 0.9, depth: int = 2,
                 capacity: Optional[int] = None, precision: str = "f32"):
        want_bf16 = check_precision(precision)
        aspace, gl = index.aspace, index.gl
        n0 = index.nitems
        cap = max(int(capacity or n0), n0)
        self.batch_size = int(batch_size)
        # k is clamped against the CAPACITY: the corpus may grow, and the
        # search-time check covers a live count below k
        self.k = min(int(k), cap)
        self.depth = max(1, int(depth))
        self.alpha = float(alpha)
        self.device, self.dtype = aspace.device, aspace.dtype
        self._dim = aspace.nfeatures
        self._aspace, self._gl = aspace, gl
        self._project, self._prepare = _query_prep(aspace, gl)
        self.kernel = session_kernel_kind(cap, self.k, self._dim, want_bf16)
        use_bf16 = want_bf16 and self.kernel == "binned"
        self.precision = "bf16" if use_bf16 else "f32"
        cap_rows = _capacity_rows(cap)
        self._init_ids(n0, cap_rows)

        self._raw = _pad_rows(aspace.data, cap_rows)
        self._lam = _pad_rows(aspace.lambdas, cap_rows)
        self._xhat = self._xlam = None
        self._engine = None
        if self.kernel in ("binned", "merge"):
            self._xhat, self._xlam = prepare_binned_corpus(
                aspace.data, aspace.lambdas, rows=cap_rows,
                use_bf16=use_bf16)
        if self.kernel == "binned":
            self._engine = BinnedTopK(self._xhat, self._xlam, self.alpha,
                                      self.k, prepared=True, n=n0)
        self._repair = self._engine.repair if self._engine else None

    def _step(self, q):
        _, qlam = self._prepare(q)
        if self._engine is not None:
            s, i, flags, det = self._engine.step(q, qlam)
            return s, i, flags, qlam, det
        if self.kernel == "merge":
            s, i = fused_lambda_topk(q, qlam, self._xhat, self._xlam,
                                     self.alpha, k=self.k, prepared=True,
                                     n_items=self._n)
        else:
            s, i = batched_lambda_aware_topk(q, qlam, self._raw[:self._n],
                                             self._lam[:self._n], self.alpha,
                                             k=self.k)
        return s, i, None, qlam, None

    def _set_n(self) -> None:
        if self._engine is not None:
            self._engine.n = self._n

    def _ingest_rows(self, rows: np.ndarray, pos: np.ndarray) -> None:
        """λ as a query's (project, τ, λ against the build graph), then
        the rows written in place; xhat by prepare_binned_corpus's
        arithmetic (prepared_rows), so an added copy of a row scores
        bitwise as it."""
        r = torch.as_tensor(rows).to(device=self.device, dtype=self.dtype)
        _, lam = self._prepare(r)
        p = self._positions(pos)
        self._raw.index_copy_(0, p, r)
        self._lam.index_copy_(0, p, lam)
        if self._xhat is not None:
            self._xhat.index_copy_(0, p, prepared_rows(r, self._xhat))
            self._xlam.index_copy_(0, p, lam.to(self._xlam.dtype))

    def _row_arrays(self):
        arrays = [self._raw, self._lam]
        if self._xhat is not None:
            arrays += [self._xhat, self._xlam]
        return arrays

    def _grow_arrays(self, rows: int) -> None:
        self._raw = _pad_rows(self._raw, rows)
        self._lam = _pad_rows(self._lam, rows)
        if self._xhat is not None:
            self._xhat = _pad_rows(self._xhat, rows)
            self._xlam = _pad_rows(self._xlam, rows)
        if self._engine is not None:
            self._engine.xhat, self._engine.xlam = self._xhat, self._xlam

    def to_index(self) -> Tuple[ArrowIndex, np.ndarray]:
        """The live corpus as a regular ArrowIndex (to save it, or to
        rebuild its graph), with (n,) int64 external ids: row j of the
        index is the live vector whose id is external_ids[j].  Its
        host_rows are the live rows as float64; the graph is the build's,
        with nnodes = n (the reference's nnodes == nitems)."""
        n = self._n
        data = self._raw[:n].clone()
        aspace = dataclasses.replace(
            self._aspace, nitems=n, data=data,
            lambdas=self._lam[:n].clone(),
            host_rows=data.double().cpu().numpy(),
            _projected_cache=None, _energy_z_cache=None,
            _lambda_order=None)
        gl = copy.copy(self._gl)
        gl.nnodes = n
        return ArrowIndex(aspace, gl), self._ids[:n].copy()


class LiveEnergySearchSession(_LiveBase):
    """Energy-index counterpart of LiveSearchSession: the z-plane (the
    projected items, through the signals graph where one is attached)
    lives in a capacity buffer with its λ, and for the binned engine its
    squared norms.  The engine is K6 with the strided repair where
    energymaps.energy_binned_fits admits the capacity, else the plain
    chunked scan of the first ``nitems`` rows; there is no approx variant
    (live.py:669-822 of the JAX package).

    The binned engine serves a plane centred on its mean
    (BinnedEnergyTopK): the centre is fixed at construction and every
    ingested row is written as z - centre with its norm, so a mutation
    moves no other row's distance.  New rows take λ as queries do
    (against the energy graph, zero-padded to a tall one where the build
    allowed it), not through ArrowSpace's mutation API, which an energy
    index does not support.  There is no ``to_index``: an energy index
    is rebuilt from its source rows."""

    def __init__(self, index: ArrowIndex, batch_size: int, k: int = 10,
                 w_lambda: float = 1.0, w_dirichlet: float = 0.5,
                 depth: int = 2, capacity: Optional[int] = None):
        aspace, gl = index.aspace, index.gl
        n0 = index.nitems
        cap = max(int(capacity or n0), n0)
        self.batch_size = int(batch_size)
        self.k = min(int(k), cap)
        self.depth = max(1, int(depth))
        self.w_lambda, self.w_dirichlet = float(w_lambda), float(w_dirichlet)
        self.device, self.dtype = aspace.device, aspace.dtype
        self._dim = aspace.nfeatures
        to_z, self._prepare = _energy_query_prep(aspace, gl)
        z_items = energy_z_plane(aspace)
        self.kernel = energy_session_config(cap, self.k, z_items.shape[1])
        cap_rows = _capacity_rows(cap)
        self._init_ids(n0, cap_rows)
        self.engine = self._z = self._lam = None
        if self.kernel == "binned":
            self.engine = BinnedEnergyTopK(
                z_items, aspace.lambdas, w_lambda, w_dirichlet, self.k,
                project=to_z, rows=cap_rows)
        else:
            self._z = _pad_rows(z_items, cap_rows)
            self._lam = _pad_rows(aspace.lambdas, cap_rows)
        self._repair = self.engine.repair if self.engine else None

    def _step(self, q):
        z_q, qlam = self._prepare(q)
        if self.engine is not None:
            s, i, flags, det = self.engine.step(z_q, qlam)
            return s, i, flags, qlam, det
        s, i = energy_topk_chunked(z_q, qlam, self._z[:self._n],
                                   self._lam[:self._n], self.w_lambda,
                                   self.w_dirichlet, k=self.k)
        return s, i, None, qlam, None

    def _set_n(self) -> None:
        if self.engine is not None:
            self.engine.n = self._n

    def _ingest_rows(self, rows: np.ndarray, pos: np.ndarray) -> None:
        """z and λ as a query's (project, τ, λ against the energy graph,
        z through the signals graph), then the rows written in place."""
        r = torch.as_tensor(rows).to(device=self.device, dtype=self.dtype)
        z_new, lam = self._prepare(r)
        p = self._positions(pos)
        if self.engine is not None:
            self.engine.write_rows(p, z_new, lam)
        else:
            self._z.index_copy_(0, p, z_new)
            self._lam.index_copy_(0, p, lam)

    def _row_arrays(self):
        if self.engine is not None:
            e = self.engine
            return [e.zx, e.xn, e.xlam]
        return [self._z, self._lam]

    def _grow_arrays(self, rows: int) -> None:
        if self.engine is not None:
            e = self.engine
            e.zx, e.xn, e.xlam = (_pad_rows(t, rows)
                                  for t in (e.zx, e.xn, e.xlam))
        else:
            self._z = _pad_rows(self._z, rows)
            self._lam = _pad_rows(self._lam, rows)
