"""ArrowIndex: the build/query facade and the serving session.

PyTorch counterpart of ``arrowspace_tpu.index``:

    index = ArrowIndex.build(rows, seed=11, device="cuda")
    scores, ids = index.search(queries, k=10, alpha=0.9)
    session = index.make_search_session(batch_size=2048, k=10, alpha=0.9)
    session.warmup()
    for scores, ids in session.search_stream(batches): ...

A serving step is query-λ preparation (τ selection + synthetic λ on the
device) followed by the scoring + top-k kernel chosen by
session_kernel_kind: the binned kernel (K1) with exact strided repair of
flagged rows, or the plain product + stable sort.  The stream loop keeps
``depth`` batches in flight: batch i+1 is enqueued on the current stream
before batch i's results are waited for.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .builder import ArrowSpaceBuilder
from .core import ArrowItem, ArrowSpace, binned_fits
from .graph import GraphLaplacian
from .ops.bin_repair import BinnedTopK
from .ops.bintopk import bins_target
from .ops.search import batched_lambda_aware_topk, rescore_topk_f64
from .sampling import SamplerType
from .taumode import TauMode, select_tau_batch, synthetic_lambda_batch
from .utils.log import get_logger

logger = get_logger("arrowspace.index")

__all__ = ["ArrowIndex", "SearchSession", "session_kernel_kind",
           "stream_search"]


def session_kernel_kind(nitems: int, k: int, f: int) -> str:
    """The serving step's top-k engine, keyed on size, never on the
    device: "binned" (K1 plus exact repair) where core.binned_fits admits
    the size, else "plain"."""
    return "binned" if binned_fits(nitems, k, f) else "plain"


def stream_search(step, batches, batch_size: int, depth: int, device,
                  dtype, dim: Optional[int] = None, repair=None):
    """Yield (scores, ids) host arrays per input batch with ``depth``
    batches in flight.

    ``step(q)`` enqueues one batch and returns (scores, ids, flags, qlam,
    det) device tensors, flags/det None for the plain kernel.  On CUDA
    the small results are copied into pinned host memory right behind
    the step and an event marks their arrival, so waiting for batch i
    lets batch i+1, already enqueued, keep the card busy.  When a batch
    is yielded, ``repair(q_block, qlam, det, scores, ids, flags)``
    (BinnedTopK.repair) returns its host results with the flagged rows
    repaired.  A short batch (a stream tail) is padded to batch_size and
    sliced back."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    cuda = torch.device(device).type == "cuda"

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
        if ev is not None:
            ev.synchronize()
        s, i = host[0].numpy()[:m], host[1].numpy()[:m]
        if len(host) < 3 or repair is None:
            return s, i
        return repair(qb, out[3], out[4], s, i, host[2].numpy()[:m])

    pending = deque()
    for qb in batches:
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
        pending.append((launch(qb), nq, qb))
        if len(pending) > depth:
            yield finish(*pending.popleft())
    while pending:
        yield finish(*pending.popleft())


class SearchSession:
    """Pipelined streaming search for serving.

    One step per batch fuses query-λ preparation with scoring + top-k; on
    the binned kernel the corpus is normalised and padded once, here.
    Flagged rows are repaired through the strided repair, with the exact
    merge kernel (K3) for rows whose fired bins overflow."""

    def __init__(self, index: "ArrowIndex", batch_size: int, k: int = 10,
                 alpha: float = 0.9, depth: int = 2):
        aspace, gl = index.aspace, index.gl
        self.batch_size = int(batch_size)
        self.k = min(int(k), index.nitems)
        self.alpha = float(alpha)
        self.depth = max(1, int(depth))
        self.device, self.dtype = aspace.device, aspace.dtype
        self._dim = aspace.nfeatures
        self.kernel = session_kernel_kind(index.nitems, self.k,
                                          aspace.nfeatures)
        k_eff, alpha_f = self.k, self.alpha
        lap = gl.matrix.to(device=self.device, dtype=self.dtype)
        taumode, pad_tall = aspace.taumode, aspace.pad_tall_graphs
        data, lambdas = aspace.data, aspace.lambdas
        engine = BinnedTopK(data, lambdas, alpha_f, k_eff) \
            if self.kernel == "binned" else None

        def step(q):
            taus = select_tau_batch(q, taumode)
            qlam = synthetic_lambda_batch(q, lap, taus, pad_items=pad_tall)
            if engine is not None:
                s, i, flags, det = engine.step(q, qlam)
                return s, i, flags, qlam, det
            s, i = batched_lambda_aware_topk(q, qlam, data, lambdas,
                                             alpha_f, k=k_eff)
            return s, i, None, qlam, None

        self._step = step
        self._repair = engine.repair if engine is not None else None

    def warmup(self) -> None:
        """Run one full batch through the stream loop and, on the binned
        kernel, one synthetic strided repair, so that kernel builds and
        first-call costs land here and not on the first real batch."""
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
                             dim=self._dim, repair=self._repair)


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
              seed: Optional[int] = None, device=None,
              dtype=None) -> "ArrowIndex":
        b = (ArrowSpaceBuilder(device=device, dtype=dtype)
             .with_lambda_graph(eps, k, topk, p, sigma)
             .with_synthesis(taumode)
             .with_normalisation(normalise)
             .with_inline_sampling(sampling))
        if seed is not None:
            b = b.with_seed(seed)
        aspace, gl = b.build(rows)
        return cls(aspace, gl, b)

    def search(self, queries, k: int = 10, alpha: float = 0.9,
               precision: str = "f32", rescore_pool: Optional[int] = None):
        """Batched λ-aware search: (B, F) -> host (scores (B, k),
        ids (B, k)).  precision="f64_rescore" re-ranks a candidate pool
        of max(4k, k+32) (or rescore_pool) against the original float64
        rows on the host."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        qlam = self.aspace.prepare_query_items_batch(queries, self.gl)
        if precision == "f64_rescore":
            m = min(rescore_pool or max(4 * k, k + 32), self.aspace.nitems)
            _s, cand = self.aspace.search_lambda_aware_batch(
                queries, qlam, m, alpha)
            return rescore_topk_f64(
                queries, qlam.cpu().numpy(), self.aspace.host_rows,
                self.aspace.lambdas.cpu().numpy(), alpha, cand.cpu().numpy(),
                min(k, self.aspace.nitems))
        if precision != "f32":
            raise NotImplementedError(f"precision {precision!r} is not "
                                      "ported yet")
        scores, ids = self.aspace.search_lambda_aware_batch(
            queries, qlam, k, alpha)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def search_one(self, query, k: int = 10, alpha: float = 0.9
                   ) -> List[Tuple[int, float]]:
        qlam = self.aspace.prepare_query_item(query, self.gl)
        return self.aspace.search_lambda_aware(ArrowItem(query, qlam), k,
                                               alpha)

    def make_search_session(self, batch_size: int, k: int = 10,
                            alpha: float = 0.9,
                            depth: int = 2) -> SearchSession:
        """Streaming search for serving, ``depth`` batches in flight."""
        return SearchSession(self, batch_size, k=k, alpha=alpha, depth=depth)

    @property
    def lambdas(self) -> np.ndarray:
        return self.aspace.lambdas.cpu().numpy()

    @property
    def nitems(self) -> int:
        return self.aspace.nitems
