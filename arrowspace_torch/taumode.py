"""TauMode: tau-selection policies and the synthetic λτ index transform.

PyTorch counterpart of ``arrowspace_tpu.taumode`` (reference:
taumode.rs:75-660).  Per item x against a dense graph matrix L (n×n):

    tau       = select_tau(x, mode)
    E_raw     = x[:n]ᵀ L x[:n] / xᵀx   (0 if xᵀx <= 1e-12)
    S         = Σ_{i≠j} w_ij (x_i - x_j)²,  w_ij = max(-L_ij, 0)
    G         = clamp(Σ_{i≠j} (w_ij (x_i - x_j)² / S)², 0, 1)
    λ         = tau · E_raw/(E_raw + tau) + (1 - tau) · G

The graph is tiny (F′ ≤ a few hundred nodes), so the batch is a handful
of (N×n)·(n×n) products.  At float32 the fused τ+λ kernel
(ops/taulambda.py, K2) or, for a narrow graph over wide rows, the λ
kernel (ops/lambda_batch.py, K5) does the batch in one pass over the
items.

All products here run at IEEE float32 or float64: TF32 is off
(config.py), so query-λ preparation needs no precision override.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .config import (DENOM_EPS, SELECT_TAU_KERNEL_MIN_ELEMS, TAU_FLOOR,
                     TAUMODE_WINDOW_BYTES)
from .utils.log import get_logger

logger = get_logger("arrowspace.taumode")

__all__ = ["TauMode", "TAU_FLOOR", "TAUDEFAULT", "select_tau",
           "select_tau_batch", "select_tau_sorted", "synthetic_lambda_batch",
           "synthetic_lambda_single", "compute_taumode_lambdas"]


@dataclass(frozen=True)
class TauMode:
    """Tau-selection policy (reference: taumode.rs:75-82).

    kind: one of "fixed" | "median" | "mean" | "percentile".
    value: the fixed tau or the percentile in [0, 1].
    """

    kind: str = "median"
    value: float = 0.0

    @staticmethod
    def fixed(v: float) -> "TauMode":
        return TauMode("fixed", float(v))

    @staticmethod
    def median() -> "TauMode":
        return TauMode("median")

    @staticmethod
    def mean() -> "TauMode":
        return TauMode("mean")

    @staticmethod
    def percentile(p: float) -> "TauMode":
        return TauMode("percentile", float(p))

    def fixed_tau(self) -> float:
        """The tau a "fixed" policy yields: its value, or TAU_FLOOR when
        that is not a finite positive number."""
        t = self.value
        return t if np.isfinite(t) and t > 0.0 else TAU_FLOOR

    def __str__(self) -> str:  # Display parity (taumode.rs:663-672)
        if self.kind in ("fixed", "percentile"):
            return f"{self.kind.capitalize()}({_fmt_float(self.value)})"
        return self.kind.capitalize()

    def to_config(self):
        """The policy's form in the persisted metadata."""
        if self.kind in ("fixed", "percentile"):
            return {self.kind.capitalize(): self.value}
        return self.kind.capitalize()

    @staticmethod
    def from_config(cfg) -> "TauMode":
        if isinstance(cfg, str):
            return TauMode(cfg.lower())
        if isinstance(cfg, dict):
            (k, v), = cfg.items()
            return TauMode(k.lower(), float(v))
        raise ValueError(f"bad TauMode config: {cfg!r}")


def _fmt_float(v: float) -> str:
    """A float as Rust's Display prints it: "0.5", and "2" for 2.0."""
    out = repr(float(v))
    return out[:-2] if out.endswith(".0") else out


TAUDEFAULT = TauMode.median()


def select_tau(energies: Sequence[float], mode: TauMode) -> float:
    """Strictly-positive tau from a value set; filters non-finite values and
    floors at TAU_FLOOR (reference: taumode.rs:87-127).  Host float64."""
    if mode.kind == "fixed":
        return mode.fixed_tau()

    arr = np.asarray(energies, dtype=np.float64)
    finite = arr[np.isfinite(arr)]

    if mode.kind == "mean":
        m = float(finite.mean()) if finite.size else 0.0
        return max(m, TAU_FLOOR)

    if finite.size == 0:
        return TAU_FLOOR
    v = np.sort(finite)
    if mode.kind == "percentile":
        pp = min(max(mode.value, 0.0), 1.0)
        # round-half-away-from-zero like Rust f64::round
        idx = int(np.floor((v.size - 1) * pp + 0.5))
        return max(float(v[idx]), TAU_FLOOR)
    if v.size % 2 == 1:
        return max(float(v[v.size // 2]), TAU_FLOOR)
    mid = 0.5 * (float(v[v.size // 2 - 1]) + float(v[v.size // 2]))
    return max(mid, TAU_FLOOR)


def select_tau_batch(x: torch.Tensor, mode: TauMode) -> torch.Tensor:
    """Per-row tau for a batch of item vectors (N, F) -> (N,), in x's
    dtype on x's device.

    A float32 median or percentile batch of at least
    SELECT_TAU_KERNEL_MIN_ELEMS values, with F within K4's gate (F <=
    1536), takes the K4 kernel (ops/select_tau.py; its plain version on
    the CPU); the gate is keyed on size and dtype, never on the device.
    Everything else, wider rows included, takes select_tau_sorted."""
    n_rows, f = x.shape
    if (mode.kind in ("median", "percentile") and x.dtype == torch.float32
            and n_rows * f >= SELECT_TAU_KERNEL_MIN_ELEMS):
        from .ops.select_tau import fused_select_tau, select_tau_fits
        if select_tau_fits(f):
            return fused_select_tau(x.contiguous(), mode)
    return select_tau_sorted(x, mode)


def select_tau_sorted(x: torch.Tensor, mode: TauMode) -> torch.Tensor:
    """select_tau_batch by sorting each row, the plain version of K4.

    Each row is sorted with non-finite values pushed to the end and the
    order statistic is taken over the finite prefix only, exactly as the
    JAX package's select_tau_batch does (including its float32 rank
    arithmetic for percentiles), so the two agree bitwise."""
    n_rows, f = x.shape
    if mode.kind == "fixed":
        return torch.full((n_rows,), mode.fixed_tau(), dtype=x.dtype,
                          device=x.device)

    finite = torch.isfinite(x)
    m = finite.sum(dim=1)                      # finite count per row
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    if mode.kind == "mean":
        s = torch.where(finite, x, zero).sum(dim=1)
        mean = torch.where(m > 0, s / m.clamp_min(1), zero)
        return mean.clamp_min(TAU_FLOOR)

    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    xs = torch.sort(torch.where(finite, x, inf), dim=1).values

    if mode.kind == "percentile":
        pp = min(max(mode.value, 0.0), 1.0)
        idx = torch.floor((m - 1).to(torch.float32) * pp + 0.5).long()
        idx = idx.clamp(0, f - 1)
        val = xs.gather(1, idx[:, None])[:, 0]
        out = torch.where(m > 0, val, torch.full_like(val, TAU_FLOOR))
        return out.clamp_min(TAU_FLOOR)

    m1 = m.clamp_min(1)
    lo = ((m1 - 1) // 2).clamp(0, f - 1)
    hi = (m1 // 2).clamp(0, f - 1)
    vlo = xs.gather(1, lo[:, None])[:, 0]
    vhi = xs.gather(1, hi[:, None])[:, 0]
    med = 0.5 * (vlo + vhi)
    out = torch.where(m > 0, med, torch.full_like(med, TAU_FLOOR))
    return out.clamp_min(TAU_FLOOR)


def graph_weights(laplacian: torch.Tensor) -> torch.Tensor:
    """Edge weights w_ij = max(-L_ij, 0) off-diagonal, 0 on the diagonal
    (reference: taumode.rs:574-584 treats only i≠j entries)."""
    w = (-laplacian).clamp_min(0.0)
    return w.fill_diagonal_(0.0)


# direct method: items per chunk so the (chunk, n, n) broadcast stays small
_DIRECT_CHUNK_ELEMS = 1 << 24


def synthetic_lambda_batch(items: torch.Tensor, laplacian: torch.Tensor,
                           taus: torch.Tensor, *, method: str = "matmul",
                           pad_items: bool = False) -> torch.Tensor:
    """Batched synthetic λ (reference: taumode.rs:552-660, vectorised).

    λ_i = τ_i · E_i/(E_i + τ_i) + (1 - τ_i) · clamp(G_i, 0, 1)

    method="matmul" expands S and the G numerator into moments of the
    item row against W and W² (a few (N×n)(n×n) products); "direct"
    evaluates the edgewise sums literally and is the oracle.
    pad_items=True zero-extends items to a graph with n > F nodes instead
    of raising the reference's hard error (taumode.rs:574 index OOB)."""
    n = laplacian.shape[0]
    big_f = items.shape[1]
    if n > big_f and not pad_items:
        raise ValueError(
            f"graph has {n} nodes but items have only {big_f} coordinates; "
            "the reference panics on this (taumode.rs:574 index OOB)")
    if n > big_f:
        xn = torch.nn.functional.pad(items, (0, n - big_f))
    else:
        xn = items[:, :n]
    lap = laplacian.to(device=items.device, dtype=items.dtype)

    numerator = ((xn @ lap.T) * xn).sum(dim=1)
    denom = (items * items).sum(dim=1)
    zero = torch.zeros((), dtype=items.dtype, device=items.device)
    e_raw = torch.where(denom > DENOM_EPS,
                        numerator / denom.clamp_min(DENOM_EPS), zero)

    w = graph_weights(lap)
    if method == "matmul":
        d_r, d_c = w.sum(dim=1), w.sum(dim=0)
        x2 = xn * xn
        xwx = ((xn @ w.T) * xn).sum(dim=1)
        s = x2 @ d_r + x2 @ d_c - 2.0 * xwx
        # Σ_ij W²_ij (x_i - x_j)⁴ with
        # (x_i - x_j)⁴ = x_i⁴ + x_j⁴ + 6 x_i²x_j² - 4 x_i³x_j - 4 x_i x_j³
        w2 = w * w
        x3, x4 = x2 * xn, x2 * x2
        t_a = x4 @ w2.sum(dim=1) + x4 @ w2.sum(dim=0)
        t_b = 6.0 * ((x2 @ w2.T) * x2).sum(dim=1)
        t_c = -4.0 * ((x3 @ w2.T) * xn).sum(dim=1)
        t_d = -4.0 * ((xn @ w2.T) * x3).sum(dim=1)
        g_num = t_a + t_b + t_c + t_d
    elif method == "direct":
        chunk = max(1, _DIRECT_CHUNK_ELEMS // max(1, n * n))
        s_parts, g_parts = [], []
        for c0 in range(0, xn.shape[0], chunk):
            x = xn[c0:c0 + chunk]
            diff = x[:, :, None] - x[:, None, :]
            e = w * diff * diff
            s_parts.append(e.sum(dim=(1, 2)))
            g_parts.append((e * e).sum(dim=(1, 2)))
        s = torch.cat(s_parts) if s_parts else denom.new_zeros((0,))
        g_num = torch.cat(g_parts) if g_parts else denom.new_zeros((0,))
    else:
        raise ValueError(f"unknown method {method!r}")

    g_raw = torch.where(s > 0.0, g_num / (s * s).clamp_min(DENOM_EPS), zero)
    g = g_raw.clamp(0.0, 1.0)
    return taus * (e_raw / (e_raw + taus)) + (1.0 - taus) * g


def synthetic_lambda_single(item, laplacian: torch.Tensor, tau: float, *,
                            method: str = "direct",
                            pad_items: bool = False) -> float:
    """Single-item synthetic λ (reference: compute_synthetic_lambda_csr),
    on the graph's device in the graph's dtype."""
    x = torch.as_tensor(np.asarray(item, dtype=np.float64)).to(
        device=laplacian.device, dtype=laplacian.dtype)[None, :]
    t = torch.full((1,), float(tau), dtype=x.dtype, device=x.device)
    return float(synthetic_lambda_batch(x, laplacian, t, method=method,
                                        pad_items=pad_items)[0])


def compute_taumode_lambdas(items: torch.Tensor, laplacian: torch.Tensor,
                            taumode: TauMode, *, method: str = "matmul",
                            pad_items: bool = False) -> torch.Tensor:
    """Batched λ over all items (reference: compute_taumode_lambdas_parallel,
    taumode.rs:174-312): tau per item from its own coordinates, then λ.

    Corpora above TAUMODE_WINDOW_BYTES run in fixed row windows.  A
    float32 batch with a graph no taller than the items takes the fused
    τ+λ kernel K2 when its feasibility gate admits the shape; failing
    that, τ comes from select_tau_batch and a graph at most half as wide
    as the items (2n <= F) takes the λ kernel K5 when its gate admits
    it, the order of the JAX package (taumode.py:446-464).  On the CPU
    both take their plain versions: the gates are keyed on size and
    dtype, never on the device.  Every other case runs select_tau_batch
    + synthetic_lambda_batch."""
    n_items, n_features = items.shape
    logger.info(
        "Parallel TauMode lambda computation: items=%d features=%d "
        "graph=%dx%d mode=%s", n_items, n_features, laplacian.shape[0],
        laplacian.shape[1], taumode)
    n_bytes = n_items * n_features * items.element_size()
    if n_bytes > TAUMODE_WINDOW_BYTES:
        win = TAUMODE_WINDOW_BYTES // (n_features * items.element_size())
        win = max(1 << 14, (win >> 14) << 14)  # 16k-row granularity
        if win < n_items:
            return torch.cat([
                compute_taumode_lambdas(items[c0:c0 + win], laplacian,
                                        taumode, method=method,
                                        pad_items=pad_items)
                for c0 in range(0, n_items, win)])

    n = laplacian.shape[0]
    fused = items.dtype == torch.float32 and method == "matmul"
    if fused and n <= n_features:
        from .ops.taulambda import fused_taulambda, taulambda_fits
        if taulambda_fits(n_features, n):
            lam, _tau = fused_taulambda(items, laplacian, taumode)
            return lam

    taus = select_tau_batch(items, taumode)
    # a narrow graph (JL-projected: 2n <= F) over wide rows: K5 reads
    # each row once, the product chain once per product
    if fused and 2 * n <= n_features:
        from .ops.lambda_batch import fused_lambda_batch, lambda_batch_fits
        if lambda_batch_fits(n_features, n):
            return fused_lambda_batch(items.contiguous(), laplacian, taus)
    return synthetic_lambda_batch(items, laplacian, taus, method=method,
                                  pad_items=pad_items)
