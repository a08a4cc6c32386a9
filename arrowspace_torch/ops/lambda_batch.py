"""K5: synthetic λ given τ, in one pass over the items (csrc/lambda_batch.cu).

Replaces ``arrowspace_tpu.ops.pallas_lambda.fused_lambda_batch``
(pallas_call at pallas_lambda.py:166; body ``_kernel`` :39-87).

Per item row x (F values) with its τ, against a graph L (n×n, n <= F):
E = xₙᵀLxₙ / xᵀx (the denominator over the FULL row), S = x²·d_r +
x²·d_c - 2xₙᵀWxₙ, G = clamp((x⁴·d2_r + x⁴·d2_c + 6x²ᵀW²x² - 4x³ᵀW²xₙ -
4xₙᵀW²x³) / S², 0, 1), λ = τ·E/(E+τ) + (1-τ)·G, with xₙ = x[:n] and
W = max(-L, 0) off the diagonal: the reference's partial-coordinate λ
(taumode.rs:552-660).  ``taumode.compute_taumode_lambdas`` routes a
float32 batch here after K2's gate fails, when the graph is at most half
as wide as the rows (2n <= F, a JL-projected canonical build) and
``lambda_batch_fits`` admits it, with τ from ``select_tau_batch``.

``lambda_batch_plain`` is the same computation in plain PyTorch; K2's
plain version is τ followed by it.
"""

from __future__ import annotations

import torch

from ..config import DENOM_EPS
from ..taumode import graph_weights
from ._build import check, lib, stream_of

__all__ = ["lambda_batch_fits", "lambda_tile_floats", "graph_operands",
           "fused_lambda_batch", "lambda_batch_plain"]

_ROWS = 64                 # item rows per CTA (csrc/lambda_tile.cuh)
_NI = 32                   # graph rows per staged slice
_XS = 68                   # row stride of a staged slice (floats)
_SMEM_LIMIT = 227 * 1024


def lambda_tile_floats(cols: int, row_scalars: int) -> int:
    """Shared floats of a CTA of K2 or K5 (csrc/lambda_tile.cuh): the item
    tile of rows of ``cols`` values (row stride whole k-steps + 4), two
    buffers of the L, W and W2 slices, the two warp groups' five forms a
    row and the kernel's ``row_scalars`` sums a row.  It mirrors the
    tile's ``smem_bytes``; a card test holds the two equal."""
    stride = -(-cols // 8) * 8 + 4
    return (_ROWS * stride + 2 * 3 * _NI * _XS
            + (2 * 5 + row_scalars) * _ROWS)


def lambda_batch_fits(f: int, n: int) -> bool:
    """Shared memory of one CTA: the λ body's item tile of the rows'
    graph coordinates, the graph slices, and three per-row sums; n <=
    680."""
    smem = lambda_tile_floats(n, 3) * 4
    return 1 <= n <= f and smem <= _SMEM_LIMIT


def graph_operands(laplacian: torch.Tensor, dtype):
    """(L, W, W², d_r, d_c, d2_r, d2_c) in ``dtype``: the edge weights
    W = max(-L, 0) off the diagonal, their squares, and the row and
    column sums of both."""
    lap = laplacian.to(dtype)
    w = graph_weights(lap)
    w2 = w * w
    return (lap.contiguous(), w.contiguous(), w2.contiguous(),
            w.sum(dim=1), w.sum(dim=0), w2.sum(dim=1), w2.sum(dim=0))


def fused_lambda_batch(items: torch.Tensor, laplacian: torch.Tensor,
                       taus: torch.Tensor) -> torch.Tensor:
    """λ (N,) of every item row given its τ (N,).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises; either raises ValueError for a graph of more nodes
    than the rows have coordinates (pallas_lambda.py:101-103)."""
    n_items, f = items.shape
    n = laplacian.shape[0]
    if n > f:
        raise ValueError(
            f"graph has {n} nodes but items have only {f} coordinates")
    if items.device.type == "cpu":
        return lambda_batch_plain(items, laplacian, taus)
    if not (items.is_cuda and items.dtype == torch.float32
            and items.is_contiguous()):
        raise ValueError("fused_lambda_batch: CUDA float32 contiguous items "
                         "required")
    if taus.shape != (n_items,) or taus.device != items.device:
        raise ValueError("fused_lambda_batch: one τ per item row, on the "
                         "items' device, required")
    if not lambda_batch_fits(f, n):
        raise ValueError(f"fused_lambda_batch: F={f}, n={n} outside the "
                         "kernel's gate")
    ops = [t.to(items.device).contiguous()
           for t in graph_operands(laplacian, torch.float32)]
    tau = taus.to(torch.float32).contiguous()
    lam = torch.empty((n_items,), device=items.device, dtype=torch.float32)
    if n_items:
        rc = lib().asp_lambda_batch(
            items.data_ptr(), *[t.data_ptr() for t in ops], tau.data_ptr(),
            n_items, f, n, lam.data_ptr(), stream_of(items))
        check(rc, "asp_lambda_batch")
        fused_lambda_batch.launches += 1
    return lam


fused_lambda_batch.launches = 0


def lambda_batch_plain(items: torch.Tensor, laplacian: torch.Tensor,
                       taus: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K5 kernel, in items' dtype: the terms
    of pallas_lambda._kernel, in its order."""
    n = laplacian.shape[0]
    lap, w, w2, d_r, d_c, d2_r, d2_c = [
        t.to(items.device) for t in graph_operands(laplacian, items.dtype)]
    xn = items[:, :n]

    def rs(a, m, b):                  # rowsum((a @ mᵀ) * b)
        return ((a @ m.T) * b).sum(dim=1)

    numerator = rs(xn, lap, xn)
    denom = (items * items).sum(dim=1)
    zero = torch.zeros((), dtype=items.dtype, device=items.device)
    e_raw = torch.where(denom > DENOM_EPS,
                        numerator / denom.clamp_min(DENOM_EPS), zero)
    x2 = xn * xn
    x3, x4 = x2 * xn, x2 * x2
    s = (x2 * d_r).sum(dim=1) + (x2 * d_c).sum(dim=1) - 2.0 * rs(xn, w, xn)
    t_a = (x4 * d2_r).sum(dim=1) + (x4 * d2_c).sum(dim=1)
    g_num = (t_a + 6.0 * rs(x2, w2, x2) - 4.0 * rs(x3, w2, xn)
             - 4.0 * rs(xn, w2, x3))
    g = torch.where(s > 0.0, g_num / (s * s).clamp_min(DENOM_EPS), zero)
    g = g.clamp(0.0, 1.0)
    taus = taus.to(items.dtype)
    return taus * (e_raw / (e_raw + taus)) + (1.0 - taus) * g
