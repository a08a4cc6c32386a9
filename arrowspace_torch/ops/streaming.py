"""Out-of-core streaming: corpora kept in host memory, in row chunks.

PyTorch counterpart of ``arrowspace_tpu.ops.streaming``.  λτ and the
λ-aware scan are single passes over the item matrix, so a corpus larger
than the card's memory streams through it in row chunks:

- streamed λτ: each chunk's λ through taumode.compute_taumode_lambdas
  (K2 at F <= 256; K4 then K5 for a narrow graph over wide rows);
- streamed top-k: each chunk's exact top-k by the engine its size takes
  (core.lambda_aware_topk: K1 with its repair, K3 or the plain scan),
  its ids offset to global ids and merged into the running (B, k) on
  the device by the two-key (-score, id) sort, so a tie goes to the
  lowest global id.

On CUDA the chunks are staged in two pinned host buffers: chunk i+1 is
copied to the card on a side stream while chunk i computes, with events
between the two streams (``double_buffer=False`` copies on the compute
stream instead).  The host fills a pinned buffer (and casts to ``dtype``)
between launches.  ``profile``, a dict, receives the wall seconds and,
for a double-buffered run on CUDA, the copy and compute intervals of
every chunk from CUDA events: bytes, the copies' rate and the share of
copy time that overlapped compute.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import numpy_dtype, resolve
from ..utils.log import get_logger

logger = get_logger("arrowspace.streaming")

__all__ = ["streamed_taumode_lambdas", "streamed_lambda_topk"]


def _chunks(arrays, chunk: int, device: torch.device, dtype,
            double_buffer: bool, profile: Optional[dict]):
    """Yield (row offset, [device tensors of the chunk's rows]) for the
    host ``arrays`` (same row count), cast to ``dtype``.  The consumer's
    work for a chunk must be enqueued on the current stream before it
    asks for the next one."""
    n = arrays[0].shape[0]
    np_dt = numpy_dtype(dtype)
    chunk = max(1, min(int(chunk), n))
    starts = list(range(0, n, chunk))
    if device.type != "cuda" or not double_buffer:
        for c0 in starts:
            yield c0, [torch.from_numpy(np.ascontiguousarray(
                a[c0:c0 + chunk], dtype=np_dt)).to(device) for a in arrays]
        return

    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    timing = profile is not None
    pinned = [[torch.empty((chunk,) + a.shape[1:], dtype=dtype,
                           pin_memory=True) for a in arrays]
              for _ in range(2)]
    dev = [[torch.empty(p.shape, dtype=dtype, device=device) for p in slot]
           for slot in pinned]
    copied: list = [None, None]   # H2D copy into the slot done (side)
    freed: list = [None, None]    # compute on the slot done (main)
    events = []                   # copy start and end, compute start and end
    base = torch.cuda.Event(enable_timing=True) if timing else None
    if timing:
        base.record(main)

    def fill(i):
        """Host rows of chunk i into pinned slot i % 2, once that slot's
        last copy has left it."""
        slot, c0 = i % 2, starts[i]
        m = min(chunk, n - c0)
        if copied[slot] is not None:
            copied[slot].synchronize()
        for p, a in zip(pinned[slot], arrays):
            np.copyto(p.numpy()[:m], a[c0:c0 + m], casting="same_kind")

    def copy(i):
        """Enqueue chunk i's upload on the side stream, after the compute
        that last read its device slot."""
        slot, m = i % 2, min(chunk, n - starts[i])
        with torch.cuda.stream(side):
            if freed[slot] is not None:
                side.wait_event(freed[slot])
            start = torch.cuda.Event(enable_timing=timing)
            start.record(side)
            for d, p in zip(dev[slot], pinned[slot]):
                d[:m].copy_(p[:m], non_blocking=True)
            done = torch.cuda.Event(enable_timing=timing)
            done.record(side)
        copied[slot] = done
        return start, done

    fill(0)
    pending = copy(0)
    if len(starts) > 1:
        fill(1)
    for i, c0 in enumerate(starts):
        slot, m = i % 2, min(chunk, n - c0)
        current = pending
        if i + 1 < len(starts):
            pending = copy(i + 1)
        main.wait_event(copied[slot])
        begin = torch.cuda.Event(enable_timing=timing)
        begin.record(main)
        yield c0, [d[:m] for d in dev[slot]]
        end = torch.cuda.Event(enable_timing=timing)
        end.record(main)
        freed[slot] = end
        events.append((current[0], current[1], begin, end))
        if i + 2 < len(starts):
            fill(i + 2)
    if timing:
        main.synchronize()
        _summarise(profile, base, events, n * np_dt.itemsize * sum(
            int(np.prod(a.shape[1:])) for a in arrays))


def _summarise(profile: dict, base, events, n_bytes: int) -> None:
    """Copy and compute intervals (ms from ``base``) of every chunk, the
    copies' rate, and the share of copy time during which the compute
    stream was busy with a chunk."""
    spans = [tuple(base.elapsed_time(e) for e in ev) for ev in events]
    compute = [(b, e) for _, _, b, e in spans]
    copy_ms = hidden = 0.0
    for cs, ce, _, _ in spans:
        copy_ms += ce - cs
        hidden += sum(max(0.0, min(ce, e) - max(cs, b)) for b, e in compute)
    profile.update(
        chunks=len(spans), bytes=int(n_bytes), copy_ms=copy_ms,
        compute_ms=sum(e - b for b, e in compute),
        upload_gb_s=n_bytes / (copy_ms * 1e6) if copy_ms > 0 else None,
        hidden_share=hidden / copy_ms if copy_ms > 0 else None,
        spans_ms=spans)


def streamed_taumode_lambdas(host_items, laplacian, taumode,
                             chunk: int = 1 << 22, *, device=None,
                             dtype=torch.float32, double_buffer: bool = True,
                             profile: Optional[dict] = None) -> np.ndarray:
    """λτ (N,) of a corpus in host memory (numpy or memmap, (N, F)),
    ``chunk`` rows at a time, against ``laplacian`` (n, n)."""
    from ..taumode import compute_taumode_lambdas

    dev, dt = resolve(device, dtype)
    lap = torch.as_tensor(laplacian).to(device=dev, dtype=dt)
    n = host_items.shape[0]
    t0 = time.perf_counter()
    parts = []
    for c0, (x,) in _chunks([host_items], chunk, dev, dt, double_buffer,
                            profile):
        parts.append(compute_taumode_lambdas(x, lap, taumode))
        logger.info("streamed λτ: %d / %d rows", c0 + x.shape[0], n)
    out = torch.cat(parts).cpu().numpy()
    if profile is not None:
        profile["wall_s"] = time.perf_counter() - t0
    return out


def streamed_lambda_topk(queries, query_lambdas, host_items, host_lambdas,
                         alpha: float, k: int, chunk: int = 1 << 22, *,
                         device=None, dtype=torch.float32,
                         double_buffer: bool = True,
                         profile: Optional[dict] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """λ-aware top-k (scores (B, k), global ids (B, k) int64) of queries
    (B, F) with their λ (B,) over a corpus in host memory, ``chunk`` rows
    at a time.  Where the corpus holds fewer than k rows, the last slots
    hold -inf and id 0, as the JAX package's host merge leaves them."""
    from ..core import lambda_aware_topk
    from .search import two_key_topk

    dev, dt = resolve(device, dtype)
    q = torch.as_tensor(queries).to(device=dev, dtype=dt)
    qlam = torch.as_tensor(query_lambdas).to(device=dev, dtype=dt)
    b, n = q.shape[0], host_items.shape[0]
    best_s = torch.full((b, k), float("-inf"), dtype=dt, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for c0, (x, lam) in _chunks([host_items, host_lambdas], chunk, dev, dt,
                                double_buffer, profile):
        s, i = lambda_aware_topk(q, qlam, x, lam, alpha,
                                 k=min(k, x.shape[0]))
        best_s, best_i = two_key_topk(torch.cat([best_s, s], dim=1),
                                      torch.cat([best_i, i.long() + c0],
                                                dim=1), k)
        logger.info("streamed top-k: %d / %d rows", c0 + x.shape[0], n)
    out = best_s.cpu().numpy(), best_i.cpu().numpy()
    if profile is not None:
        profile["wall_s"] = time.perf_counter() - t0
    return out
