"""Profiling hooks: the package's spans and counters, and device traces.

The reference instruments stage boundaries with std::time::Instant spans
and ASCII-box statistics (taumode.rs:184-311, builder.rs:252).  Here one
recorder times every span of the package (``span``; ``annotate`` and
utils.log.stage_timer are spans too):

* a span always adds its wall time (``perf_counter_ns``) to the totals of
  the innermost active ``Record``: calls, total and self time (total less
  the time its child spans cover);
* only while a torch profiler is recording does it also open the range
  ``arrowspace::<name>`` (record_function), so that the package's spans
  land on the trace's clock beside the kernels they launch; with no
  profiler running no range is entered.  Under
  ``torch.autograd.profiler.emit_nvtx`` (an Nsight Systems run) that
  range is an NVTX range; ``annotate``'s ranges are NVTX ranges on CUDA
  whether or not a profiler records;
* ``count(name, n)`` adds to the innermost active record's counters.

A record keeps totals only, so a stream of any length holds constant
memory.  The serving sessions (index.SearchSession,
index.EnergySearchSession) each hold a session record (``session.prepare``,
``session.warmup``), and every ``index.stream_search`` a stream record
that carries its session's id; ``records()`` returns the last KEEP of
them, oldest first: what a session's last streams did.

Device-side profiles come from torch.profiler (``device_trace``): a
Chrome trace (chrome://tracing or Perfetto) with the card's kernels when
CUDA is recorded.  Counterpart of ``arrowspace_tpu.utils.profiling``
(jax.profiler traces).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
from collections import deque
from time import perf_counter_ns
from typing import Optional

import numpy as np
import torch

from .log import get_logger

logger = get_logger("arrowspace.profiling")

__all__ = ["device_trace", "annotate", "log_lambda_statistics", "span",
           "count", "Record", "records"]

TRACE_FILE = "trace.json"
# the prefix of the package's ranges in a device trace
PREFIX = "arrowspace::"
# session and stream records kept by the registry
KEEP = 16

_profiling = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)
_registry: deque = deque(maxlen=KEEP)


class _Stacks:
    """A thread's stacks: the active records, and per open span the
    nanoseconds its children have covered so far."""

    __slots__ = ("records", "frames")

    def __init__(self):
        self.records: list = []
        self.frames: list = []


class _Local(threading.local):
    def __init__(self):
        self.stacks = _Stacks()


_local = _Local()


class Record:
    """Totals of the spans and counters recorded while it is active
    (``with record:``): per span name [calls, total ns, self ns], per
    counter its sum.  ``kind`` is "session" or "stream"; a stream
    record's ``session`` is its session record's id (None for a stream
    no session owns).  Every record joins the registry that
    ``records()`` reads."""

    __slots__ = ("id", "kind", "session", "spans", "counters")

    def __init__(self, kind: str, session: Optional[int] = None):
        self.id = next(_ids)
        self.kind, self.session = kind, session
        self.spans: dict = {}
        self.counters: dict = {}
        _registry.append(self)

    def add(self, name: str, total_ns: int, self_ns: Optional[int] = None
            ) -> None:
        """Add one call of ``name`` lasting ``total_ns`` (``self_ns`` of
        it outside child spans; all of it by default)."""
        t = self.spans.get(name)
        if t is None:
            t = self.spans[name] = [0, 0, 0]
        t[0] += 1
        t[1] += total_ns
        t[2] += total_ns if self_ns is None else self_ns

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def __enter__(self):
        """``with record:`` spans and counts go to this record."""
        _local.stacks.records.append(self)
        return self

    def __exit__(self, *exc):
        _local.stacks.records.pop()
        return False

    def as_dict(self) -> dict:
        return {"id": self.id, "kind": self.kind, "session": self.session,
                "spans": {k: {"count": c, "total_s": t * 1e-9,
                              "self_s": s * 1e-9}
                          for k, (c, t, s) in self.spans.items()},
                "counters": dict(self.counters)}


def records() -> list:
    """The registry's session and stream records as dicts (``id``,
    ``kind``, ``session``, ``spans``: name -> ``count``, ``total_s``,
    ``self_s``; ``counters``), oldest first."""
    return [r.as_dict() for r in list(_registry)]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost active record (none:
    nothing)."""
    recs = _local.stacks.records
    if recs:
        recs[-1].count(name, n)


class span:
    """``with span(name) as sp:`` times the block into the innermost
    active record (calls, total and self time) and leaves its wall
    seconds in ``sp.seconds``.  While a torch profiler records, the block
    is also the range ``arrowspace::<name>`` (``range_name`` when
    given)."""

    __slots__ = ("name", "range_name", "_dt", "_t0", "_rec", "_frames",
                 "_rf")

    def __init__(self, name: str, range_name: Optional[str] = None):
        self.name, self.range_name = name, range_name
        self._dt = 0

    @property
    def seconds(self) -> float:
        """Wall seconds of the span's last exit."""
        return self._dt * 1e-9

    def __enter__(self):
        stacks = _local.stacks
        recs = stacks.records
        self._rec = recs[-1] if recs else None
        self._rf = None
        if _profiling():
            rname = self.range_name or PREFIX + self.name
            self._rf = torch.profiler.record_function(rname)
            self._rf.__enter__()
        self._frames = stacks.frames
        self._frames.append(0)
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = perf_counter_ns() - self._t0
        frames = self._frames
        child = frames.pop()
        if frames:
            frames[-1] += dt
        rec = self._rec
        if rec is not None:
            # Record.add, inline: this runs several times a served batch
            t = rec.spans.get(self.name)
            if t is None:
                t = rec.spans[self.name] = [0, 0, 0]
            t[0] += 1
            t[1] += dt
            t[2] += dt - child
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._dt = dt
        return False


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """Record a torch.profiler trace around a block and write it to
    ``logdir``/trace.json (default: arrowspace_trace in the temporary
    directory).  The card's activity is recorded too whenever CUDA is
    available.  Yields the profiler, whose ``key_averages()`` sums the
    time by kernel."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "arrowspace_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """A span named ``name`` whose range in a device trace carries
    ``name`` as given (see span), and on CUDA an NVTX range of that name
    whether or not a profiler records."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(span(name, range_name=name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def log_lambda_statistics(lambdas) -> dict:
    """λ distribution summary at stage boundaries, mirroring the
    reference's post-computation statistics block (taumode.rs:286-308)."""
    lam = lambdas.cpu().numpy() if torch.is_tensor(lambdas) \
        else np.asarray(lambdas)
    stats = {
        "min": float(lam.min()),
        "max": float(lam.max()),
        "mean": float(lam.mean()),
        "std": float(lam.std()),
        "range": float(lam.max() - lam.min()),
    }
    logger.info(
        "Lambda Statistics: min=%.6f max=%.6f mean=%.6f std=%.6f range=%.6f",
        stats["min"], stats["max"], stats["mean"], stats["std"],
        stats["range"])
    return stats
