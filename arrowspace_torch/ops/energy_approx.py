"""K7: chord-surrogate energy fold + pooled-d² exact rescore + per-query
certification (csrc/energy_chord.cu).

Replaces ``arrowspace_tpu.ops.energy_approx.binned_energy_topk_approx``
(pallas_call at energy_approx.py:404; body ``_chord_kernel`` :201).

u(d²) = w_D/(1+√d²) is convex and decreasing in d², so every secant chord
lies on or above it inside its interval.  Per query, ``_fit_chords``
places knots [0, a, c] from a sampled d² distribution and the kernel
folds the surrogate ŝ = max(d²·a₁ + b₁, min(d², c)·a₂ + b₂) - w_λ·|Δλ|
(intercepts lifted by 1e-6·w_D against rounding, so ŝ bounds the exact
shifted score from above) into K1's binned pool, carrying each entry's
d².  ``_flush_rescore_certify`` (plain torch, as the JAX package runs it
outside the kernel) rescores every pool entry exactly from its d²,
takes the two-key top-k and certifies a query when its k-th exact score
strictly beats every det: an item outside the pool lost a surrogate
comparison, so its exact score ≤ its surrogate ≤ det.  Uncertified rows
are flagged; the caller re-runs them exactly.
``binned_energy_approx_pool_plain`` is the kernel's computation in plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check, lib, stream_of
from .bintopk import (KERNEL_BINS, KERNEL_DEPTHS, _default_chunks,
                      binned_topk_depth_for, bins_target, fold_pool_plain)
from .energy_bintopk import energy_grid_ctas, energy_u
from .search import INT_MAX, NEG_INF, dot_plane, two_key_topk

__all__ = ["SAMPLE_ROWS", "K7_PAIRS", "prepare_energy_chord_sample",
           "chord_plane", "binned_energy_approx_pool",
           "binned_energy_approx_pool_plain", "binned_energy_topk_approx"]

SAMPLE_ROWS = 1024
# (query, bin) pairs a CTA of K7's energy tile holds: 8 warps of 16
# queries × 16 bins (csrc/energy_chord.cu, NT = 2; its d² payload leaves
# no registers for K6's 16 pairs a thread)
K7_PAIRS = 2048


def prepare_energy_chord_sample(zx, xn, n: int, seed: int = 0):
    """min(SAMPLE_ROWS, n) distinct real rows of the prepared corpus for
    the per-query chord fit, picked with numpy's default_rng(seed), so
    the JAX package picks the same rows.  Returns (z_samp (S, G),
    xn_samp (S,))."""
    s = min(SAMPLE_ROWS, int(n))
    ids = np.random.default_rng(seed).choice(int(n), size=s, replace=False)
    ids = torch.as_tensor(ids, device=zx.device)
    return zx[ids], xn[ids]


def _fit_chords(z_q, qn, z_samp, xn_samp, wd: float):
    """Per-query knots and chord coefficients (energy_approx.py:108-143):
    knots a ≈ 0.9·min and c ≈ mean - 1.28σ of the sampled d², two chords
    of u over [0, a] and [a, c] and the floor u(c), every intercept
    lifted by 1e-6·w_D.  Returns (ca (B, 2) [a₁, a₂], cb (B, 3)
    [b₁, b₂, c]) in z_q's dtype."""
    d2s = (qn[:, None] + xn_samp[None, :]) - 2.0 * (z_q @ z_samp.T)
    mn = d2s.min(dim=1).values
    mu = d2s.mean(dim=1)
    sd = ((d2s * d2s).mean(dim=1) - mu * mu).clamp_min(0.0).sqrt()
    a_k = (0.9 * mn).clamp_min(1e-6)
    c_k = torch.maximum(a_k * 1.69 + 1e-3, mu - 1.28 * sd)
    g1 = wd / (1.0 + a_k.sqrt())
    g2 = wd / (1.0 + c_k.sqrt())
    a1 = (g1 - wd) / a_k
    a2 = (g2 - g1) / (c_k - a_k)
    lift = wd * 1e-6
    b1 = torch.full_like(a_k, wd + lift)
    b2 = g1 - a2 * a_k + lift
    return (torch.stack([a1, a2], dim=1).contiguous(),
            torch.stack([b1, b2, c_k], dim=1).contiguous())


def chord_plane(zq, qn, qlam, ca, cb, zx, xn, xlam, wl: float):
    """(surrogate scores, d²) of queries zq against rows zx: each step
    rounds once, in the order K7 rounds it."""
    d2 = (qn[:, None] + xn[None, :]) - 2.0 * dot_plane(zq, zx)
    a1, a2 = ca[:, 0:1], ca[:, 1:2]
    b1, b2, ck = cb[:, 0:1], cb[:, 1:2], cb[:, 2:3]
    u = torch.maximum(d2 * a1 + b1, torch.minimum(d2, ck) * a2 + b2)
    return u - wl * (qlam[:, None] - xlam[None, :]).abs(), d2


def binned_energy_approx_pool(zq, qn, qlam, ca, cb, zx, xn, xlam, wl: float,
                              n: int, *, depth: int, bins: int, chunks: int):
    """Per-(query, chunk, bin) top-``depth`` surrogate pool, the d² of
    each pool entry, and det.  Returns pool_s, pool_i, pool_d
    (B, chunks, depth, bins) and det (B, chunks, bins).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if zq.device.type == "cpu":
        return binned_energy_approx_pool_plain(
            zq, qn, qlam, ca, cb, zx, xn, xlam, wl, n, depth=depth,
            bins=bins, chunks=chunks)
    bsz, g = zq.shape
    n_tiles = -(-n // bins)
    for t in (zq, qn, qlam, ca, cb, zx, xn, xlam):
        if not (t.is_cuda and t.dtype == torch.float32
                and t.is_contiguous()):
            raise ValueError("binned_energy_approx_pool: CUDA float32 "
                             "contiguous tensors required")
    if ca.shape != (bsz, 2) or cb.shape != (bsz, 3):
        raise ValueError("binned_energy_approx_pool: chord coefficients "
                         "must be (B, 2) and (B, 3)")
    if bins not in KERNEL_BINS or depth not in KERNEL_DEPTHS:
        raise ValueError(f"binned_energy_approx_pool: unsupported "
                         f"bins={bins} depth={depth}")
    if g < 1:
        raise ValueError("binned_energy_approx_pool: empty z-plane rows")
    if zx.shape[0] < n_tiles * bins or zx.shape[1] != g \
            or xn.shape[0] < n_tiles * bins:
        raise ValueError("binned_energy_approx_pool: corpus not padded to "
                         "whole bin tiles")
    tiles_per_chunk = -(-n_tiles // chunks)
    chunks = -(-n_tiles // tiles_per_chunk)
    shape = (bsz, chunks, depth, bins)
    pool_s = torch.empty(shape, device=zq.device, dtype=torch.float32)
    pool_i = torch.empty(shape, device=zq.device, dtype=torch.int32)
    pool_d = torch.empty(shape, device=zq.device, dtype=torch.float32)
    det = torch.empty((bsz, chunks, bins), device=zq.device,
                      dtype=torch.float32)
    if bsz == 0 or n <= 0:
        return pool_s, pool_i, pool_d, det
    rc = lib().asp_energy_chord(
        zq.data_ptr(), qn.data_ptr(), qlam.data_ptr(), ca.data_ptr(),
        cb.data_ptr(), zx.data_ptr(), xn.data_ptr(), xlam.data_ptr(), wl, n,
        bsz, g, bins, depth, chunks, tiles_per_chunk, pool_s.data_ptr(),
        pool_i.data_ptr(), pool_d.data_ptr(), det.data_ptr(), stream_of(zq))
    check(rc, "asp_energy_chord")
    binned_energy_approx_pool.launches += 1
    return pool_s, pool_i, pool_d, det


binned_energy_approx_pool.launches = 0


def binned_energy_approx_pool_plain(zq, qn, qlam, ca, cb, zx, xn, xlam,
                                    wl: float, n: int, *, depth: int,
                                    bins: int, chunks: int):
    """Plain PyTorch version of the K7 kernel, same outputs and layout."""
    z_n, n_n, l_n = zx[:n], xn[:n], xlam[:n]

    def scores(b0, b1):
        return chord_plane(zq[b0:b1], qn[b0:b1], qlam[b0:b1], ca[b0:b1],
                           cb[b0:b1], z_n, n_n, l_n, wl)
    pool_s, pool_i, det, pool_d = fold_pool_plain(
        scores, zq.shape[0], n, depth=depth, bins=bins, chunks=chunks,
        device=zq.device, payload=True)
    return pool_s, pool_i, pool_d, det


def _flush_rescore_certify(pool_s, pool_i, pool_d, det, qlam, xlam,
                           wl: float, wd: float, k: int):
    """Exact top-k from the surrogate pool (energy_approx.py:427-464):
    every pool entry rescored from its d² with the exact shifted score,
    the two-key (-score, id) top-k, and certified = kth > every det.
    Returns (scores (B,k) on the true scale, ids (B,k), flags (B,) True
    for uncertified rows)."""
    bsz = pool_s.shape[0]
    ps = pool_s.reshape(bsz, -1)
    pi = pool_i.reshape(bsz, -1).long()
    valid = ps > NEG_INF
    lam_g = xlam[torch.where(valid, pi, torch.zeros_like(pi))]
    sc = energy_u(pool_d.reshape(bsz, -1), wd) \
        - wl * (qlam[:, None] - lam_g).abs()
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    ids = torch.where(valid, pi, torch.full_like(pi, INT_MAX))
    s, i = two_key_topk(sc, ids, k)
    kth = s[:, k - 1]
    certified = (kth > det.reshape(bsz, -1).amax(dim=1)) & (kth > NEG_INF)
    return s - wd, i, ~certified


def binned_energy_topk_approx(z_q, query_lambdas, zx, xlam, xn, z_samp,
                              xn_samp, wl: float, wd: float, *, k: int,
                              n: int):
    """Certified-exact energy top-k over a prepared corpus: (scores (B,k),
    ids (B,k), flags (B,) bool).  An unflagged row equals the exact
    energy top-k; a flagged row failed certification and must be re-run
    exactly by the caller.  wl and wd must be values of the corpus
    dtype."""
    dt = zx.dtype
    zq = z_q.to(dt).contiguous()
    qlam = query_lambdas.to(dt).contiguous()
    qn = (zq * zq).sum(dim=1)
    ca, cb = _fit_chords(zq, qn, z_samp, xn_samp, wd)
    depth, bins = binned_topk_depth_for(k), bins_target(k)
    chunks = _default_chunks(
        energy_grid_ctas(zq.shape[0], bins, zq.shape[1], K7_PAIRS),
        -(-n // bins), zq.device)
    pool_s, pool_i, pool_d, det = binned_energy_approx_pool(
        zq, qn, qlam, ca, cb, zx, xn, xlam, wl, n, depth=depth, bins=bins,
        chunks=chunks)
    return _flush_rescore_certify(pool_s, pool_i, pool_d, det, qlam, xlam,
                                  wl, wd, k)
