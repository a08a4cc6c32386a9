"""K4: per-row τ selection, median or percentile (csrc/select_tau.cu).

Replaces ``arrowspace_tpu.ops.pallas_tau.fused_select_tau`` (pallas_call
at pallas_tau.py:475; body ``_kernel`` :422, ``_tau_rows`` :305 with the
``bisect`` layout).  ``taumode.select_tau_batch`` routes float32 median
and percentile batches of at least 2²² values here: the energy build's
corpus λ pass (a tall graph, where K2 does not apply) and each row
window of the projected builds at F = 768 and 1536.

The kernel selects the order statistic by a radix select over each
row's finite range (common.cuh, shared with K2), so τ equals
``taumode.select_tau_sorted``, its plain version, bitwise.  It takes
rows of up to 1536 values, where the JAX package's Pallas kernel stops
below 1536 (``fused_select_tau_fits``) and sorts: both are bitwise
equal to the sort.
"""

from __future__ import annotations

import torch

from ._build import check, lib, stream_of

__all__ = ["MAX_F", "select_tau_fits", "fused_select_tau_fits",
           "fused_select_tau", "select_tau_plain"]

MAX_F = 1536               # 48 values a lane of one warp
_KINDS = {"median": 0, "percentile": 1}


def select_tau_fits(f: int) -> bool:
    """Whether one warp holds a row of F values in its registers."""
    return 1 <= f <= MAX_F


# the JAX package's name of the gate (pallas_tau.py:143)
fused_select_tau_fits = select_tau_fits


def fused_select_tau(items: torch.Tensor, mode=None, *, kind: str = "median",
                     pct: float = 0.5) -> torch.Tensor:
    """τ (N,) of every row of items (N, F) for a median or percentile
    TauMode ``mode``, or, without one, for the JAX package's ``kind`` and
    ``pct`` (pallas_tau.py:442).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    x = items
    if mode is None:
        from ..taumode import TauMode
        mode = TauMode(kind, float(pct) if kind == "percentile" else 0.0)
    if x.device.type == "cpu":
        return select_tau_plain(x, mode)
    n, f = x.shape
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError("fused_select_tau: CUDA float32 contiguous rows "
                         "required")
    if mode.kind not in _KINDS:
        raise ValueError(f"fused_select_tau: mode {mode.kind!r} is not an "
                         "order statistic")
    if not select_tau_fits(f):
        raise ValueError(f"fused_select_tau: F={f} exceeds {MAX_F}")
    pct = min(max(mode.value, 0.0), 1.0) if mode.kind == "percentile" \
        else 0.5
    tau = torch.empty((n,), device=x.device, dtype=torch.float32)
    if n:
        rc = lib().asp_select_tau(x.data_ptr(), n, f, _KINDS[mode.kind],
                                  pct, tau.data_ptr(), stream_of(x))
        check(rc, "asp_select_tau")
        fused_select_tau.launches += 1
    return tau


fused_select_tau.launches = 0


def select_tau_plain(x: torch.Tensor, mode) -> torch.Tensor:
    """Plain PyTorch version of K4: the row sort of select_tau_sorted."""
    from ..taumode import select_tau_sorted
    return select_tau_sorted(x, mode)
