"""Logging bootstrap mirroring arrowspace::init() (reference: lib.rs:32-46).

Log level comes from ``ARROWSPACE_LOG`` (analogue of RUST_LOG), defaulting
to ``info``.  Stage-boundary messages keep the same shape as the reference
so build logs stay comparable.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager

_INITIALIZED = False


def init() -> None:
    """Idempotent logger initialisation (reference: lib.rs:36-46)."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    level_name = os.environ.get("ARROWSPACE_LOG", "info").upper()
    level = getattr(logging, level_name, logging.INFO)
    logging.basicConfig(
        level=level,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    _INITIALIZED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


@contextmanager
def stage_timer(logger: logging.Logger, stage: str):
    """Wall-clock span logged at stage boundaries, mirroring the
    std::time::Instant spans in builder.rs:252 / laplacian.rs:188-196: a
    utils.profiling span named ``stage``."""
    from .profiling import span
    sp = span(stage)
    logger.info("%s: started", stage)
    try:
        with sp:
            yield
    finally:
        logger.info("%s: completed in %.3fs", stage, sp.seconds)
