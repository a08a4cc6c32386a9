"""K2: fused τ + λ in one pass over the items (csrc/taulambda.cu).

Replaces ``arrowspace_tpu.ops.pallas_taulambda.fused_taulambda_batch``
(pallas_call at pallas_taulambda.py:151; body ``_kernel`` :33, τ from
``pallas_tau._tau_rows`` :305 with the ``bisect`` layout,
``_bisect_order_stat`` :190).

Per item row x (F values) against a graph L (n×n, n <= F):
- τ, the exact order statistic of the row's finite values (median,
  percentile, mean or fixed; TAU_FLOOR applied), equal bitwise to
  taumode.select_tau_batch for median and percentile;
- E = xₙᵀLxₙ / xᵀx, S = x²·d_r + x²·d_c - 2xₙᵀWxₙ,
  G = clamp((x⁴·d2_r + x⁴·d2_c + 6x²ᵀW²x² - 4x³ᵀW²x - 4xᵀW²x³) / S², 0, 1),
  λ = τ·E/(E+τ) + (1-τ)·G, with W = max(-L, 0) off the diagonal.

``taulambda_fits`` is the kernel's shared-memory gate; above it the
caller runs select_tau_batch + synthetic_lambda_batch.
``taulambda_plain`` is the same computation in plain PyTorch.  The λ
body is K5's (ops/lambda_batch.py, csrc/lambda_tile.cuh: the five
quadratic forms on the tensor cores as 3×TF32).
"""

from __future__ import annotations

import torch

from ..taumode import TauMode, select_tau_sorted
from ._build import check, lib, stream_of
from .lambda_batch import (graph_operands, lambda_batch_plain,
                           lambda_tile_floats)

__all__ = ["taulambda_fits", "fused_taulambda", "taulambda_plain",
           "fused_taulambda_fits", "fused_taulambda_batch"]

_SMEM_LIMIT = 227 * 1024
_KINDS = {"median": 0, "percentile": 1, "mean": 2, "fixed": 3}


def taulambda_fits(f: int, n: int) -> bool:
    """Shared memory of one CTA: the λ body's item tile of whole rows,
    the graph slices and four per-row sums (it fits at every F <= 256);
    F is capped by the per-lane row registers of the τ selection (8
    values a lane)."""
    smem = lambda_tile_floats(f, 4) * 4
    return 1 <= n <= f <= 256 and smem <= _SMEM_LIMIT


def fused_taulambda(items: torch.Tensor, laplacian: torch.Tensor, mode):
    """(λ (N,), τ (N,)) for every item row.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if items.device.type == "cpu":
        return taulambda_plain(items, laplacian, mode)
    n_items, f = items.shape
    n = laplacian.shape[0]
    if not (items.is_cuda and items.dtype == torch.float32
            and items.is_contiguous()):
        raise ValueError("fused_taulambda: CUDA float32 contiguous items "
                         "required")
    if not taulambda_fits(f, n):
        raise ValueError(f"fused_taulambda: F={f}, n={n} outside the "
                         "kernel's gate")
    ops = [t.to(items.device).contiguous()
           for t in graph_operands(laplacian, torch.float32)]
    pct = min(max(mode.value, 0.0), 1.0) if mode.kind == "percentile" \
        else 0.5
    fixed = mode.fixed_tau() if mode.kind == "fixed" else 0.0
    lam = torch.empty((n_items,), device=items.device, dtype=torch.float32)
    tau = torch.empty_like(lam)
    if n_items:
        rc = lib().asp_taulambda(
            items.data_ptr(), *[t.data_ptr() for t in ops], n_items, f, n,
            _KINDS[mode.kind], pct, fixed, lam.data_ptr(), tau.data_ptr(),
            stream_of(items))
        check(rc, "asp_taulambda")
        fused_taulambda.launches += 1
    return lam, tau


fused_taulambda.launches = 0


def taulambda_plain(items: torch.Tensor, laplacian: torch.Tensor, mode):
    """Plain PyTorch version of the K2 kernel: (λ, τ) in items' dtype.
    τ comes from the sort, never from K4; λ from K5's plain version."""
    tau = select_tau_sorted(items, mode)
    return lambda_batch_plain(items, laplacian, tau), tau


def fused_taulambda_fits(n_items: int, f: int, n: int) -> bool:
    """The JAX package's name and arguments of taulambda_fits
    (pallas_taulambda.py:81); the gate does not depend on n_items."""
    return taulambda_fits(f, n)


def fused_taulambda_batch(items: torch.Tensor, laplacian: torch.Tensor, *,
                          kind: str = "median", pct: float = 0.5,
                          fixed: float = 0.0) -> torch.Tensor:
    """λ (N,) of every item row by fused_taulambda, with the τ policy
    given as the JAX package's ``kind`` / ``pct`` / ``fixed``
    (pallas_taulambda.py:93)."""
    value = {"percentile": pct, "fixed": fixed}.get(kind, 0.0)
    return fused_taulambda(items, laplacian, TauMode(kind, float(value)))[0]
