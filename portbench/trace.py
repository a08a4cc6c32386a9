"""The device trace of a traced run, reduced to what the metrics read.

A traced run records a bounded stretch of its window with
``torch.profiler`` (CPU and CUDA activities).  The stretch is enclosed in
the benchmark's own span ``STRETCH``; its length is the traced window.
Busy time is the union of the device's intervals (kernels, copies and
sets) inside it, so operations that overlap on several streams count
once.  Idle gaps are the holes in that union, each labelled by the
innermost benchmark span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Iterable, List, Tuple

from torch.profiler import record_function

PREFIX = "portbench."
STRETCH = "stretch"
TOP = 10

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(merged: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The holes of a sorted disjoint union inside [lo, hi]."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def innermost(spans: List[Tuple[str, float, float]], t: float) -> str:
    """The name of the shortest span that holds time t, else "none"."""
    best, best_len = "none", float("inf")
    for name, s, e in spans:
        if s <= t < e and e - s < best_len:
            best, best_len = name, e - s
    return best


def reduce(device: List[Tuple[str, float, float]],
           spans: List[Tuple[str, float, float]]) -> dict:
    """Busy and window seconds, and the breakdown, of one traced stretch.

    ``device``: (name, start, end) of every device operation, seconds on
    the trace's clock; ``spans``: (name, start, end) of the benchmark's
    spans on the same clock, ``STRETCH`` among them."""
    stretch = [(s, e) for n, s, e in spans if n == STRETCH]
    if not stretch:
        raise ValueError("the trace holds no stretch span")
    lo, hi = stretch[0]
    inside = clip([(s, e) for _, s, e in device], lo, hi)
    merged = union(inside)
    busy = sum(e - s for s, e in merged)
    per_op = defaultdict(float)
    for name, s, e in device:
        c = clip([(s, e)], lo, hi)
        if c:
            per_op[name] += c[0][1] - c[0][0]
    others = [x for x in spans if x[0] != STRETCH]
    labelled = [(innermost(others, s), e - s) for s, e in gaps(merged, lo, hi)]
    labelled.sort(key=lambda x: -x[1])
    ops = sorted(per_op.items(), key=lambda x: -x[1])
    return {"busy_s": busy, "window_s": hi - lo,
            "device_ops": [[n, v] for n, v in ops[:TOP]],
            "idle_gaps": [[n, v] for n, v in labelled[:TOP]],
            "n_device_ops": len(device)}


def events(prof) -> tuple:
    """(device, spans) tuples in seconds from a stopped torch.profiler
    profile: every CUDA-side kernel, copy and set, and every benchmark
    span.  The profiler mirrors each host annotation onto the device's
    timeline too, under the annotation's name; those mirrors are no
    device work and are left out.  Times count from the trace's first
    event."""
    from torch.autograd import DeviceType
    raw = list(prof.profiler.kineto_results.events())
    base = min((ev.start_ns() for ev in raw), default=0)
    host = [ev for ev in raw if ev.device_type() != DeviceType.CUDA]
    marks = {ev.name() for ev in host if ev.is_user_annotation()}
    device, spans = [], []
    for ev in raw:
        s = (ev.start_ns() - base) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            if ev.name() not in marks:
                device.append((ev.name(), s, e))
        elif ev.is_user_annotation() and ev.name().startswith(PREFIX):
            spans.append((ev.name()[len(PREFIX):], s, e))
    return device, spans


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a torch.profiler annotation, free when no
    profiler runs."""
    with record_function(PREFIX + name):
        yield


class Tracer:
    """Profiles the stretch between ``start()`` and ``stop()``; ``off``
    does nothing.  ``result`` holds the reduction after ``finish()``."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.result = None
        self._prof = self._span = None

    def start(self, sync=None) -> None:
        if not self.on or self._prof is not None or \
                getattr(self, "_done", None) is not None:
            return
        if sync is not None:
            sync()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(PREFIX + STRETCH)
        self._span.__enter__()

    def warm(self, sync) -> None:
        """Profile one tiny stretch, so that the profiler's own start-up
        (CUPTI's first initialisation takes seconds) lands in set-up and
        not in the measured window."""
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device="cuda" if self.cuda else "cpu").sum()
            sync()

    def stop(self, sync=None) -> None:
        if self._prof is None:
            return
        if sync is not None:
            sync()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._prof, self._span = self._prof, None, None

    def finish(self) -> None:
        """Reduce the stopped stretch's trace (after the window)."""
        done = getattr(self, "_done", None)
        if done is not None:
            self.result = reduce(*events(done))
            self._done = None


def idle_share(result) -> float:
    """1 - busy / window of a reduced trace; None without one, or where
    nothing ran on a device."""
    if not result or result["window_s"] <= 0 or not result["n_device_ops"]:
        return None
    return 1.0 - result["busy_s"] / result["window_s"]
