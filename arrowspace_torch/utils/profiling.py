"""Profiling hooks.

The reference instruments stage boundaries with std::time::Instant spans
and ASCII-box statistics (taumode.rs:184-311, builder.rs:252).  Here the
same wall-clock spans come from utils.log.stage_timer, and device-side
profiles from torch.profiler: a Chrome trace (chrome://tracing or
Perfetto) with the card's kernels when CUDA is recorded, and named
ranges that show in it and, on CUDA, as NVTX ranges.  Counterpart of
``arrowspace_tpu.utils.profiling`` (jax.profiler traces).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .log import get_logger

logger = get_logger("arrowspace.profiling")

__all__ = ["device_trace", "annotate", "log_lambda_statistics"]

TRACE_FILE = "trace.json"


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
    """A named sub-span inside a device trace (record_function), and on
    CUDA an NVTX range of the same name."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
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
