"""K6: bin-accumulator streaming energy top-k (csrc/energy_bintopk.cu).

Replaces ``arrowspace_tpu.ops.pallas_bintopk.binned_energy_topk``
(pallas_call at pallas_bintopk.py:934; body ``_energy_kernel`` :689).

The score is the energy score of ``energymaps.search_energy`` in z-space
(the JL-projected items), in the JAX kernel's rsqrt2 form and SHIFTED by
+w_D (``energy_plane``): the pool, det and flags are computed on the
shifted scale and -w_D is restored after the sort and the flag compare
(pallas_bintopk.py:953-996).  The pool layout, bins, depth, det and the
flush are K1's (ops/bintopk.py), so the strided repair covers both.
``binned_energy_pool_plain`` is the same computation in plain PyTorch.

K6 and K7 are one kernel, the energy tile (csrc/energy_tile.cuh), on
the tensor cores; ``energy_query_block`` and ``energy_grid_ctas`` mirror
its CTA rule for the chunk count.  Its shared memory does not grow with
the z-width, so it takes any G.
"""

from __future__ import annotations

import torch

from ._build import check, lib, stream_of
from .bintopk import (CORPUS_ALIGN, KERNEL_BINS, KERNEL_DEPTHS,
                      _default_chunks, binned_topk_depth_for, bins_target,
                      flush_pool, fold_pool_plain)
from .search import dot_plane, exact_topk, two_key_topk

__all__ = ["ENERGY_CHUNK", "K6_PAIRS", "energy_query_block",
           "energy_grid_ctas", "dtype_scalar", "energy_u", "energy_plane",
           "energy_topk_chunked", "prepare_binned_energy_corpus",
           "binned_energy_pool", "binned_energy_pool_plain",
           "binned_energy_topk", "rsqrt_probe"]

# Corpus rows per step of the plain chunked scorer, and the corpus size
# above which the energy search takes the binned engine
# (energymaps.py:420 of the JAX package).
ENERGY_CHUNK = 65536
# (query, bin) pairs a CTA of the energy tile holds: 8 warps of 16
# queries × 32 bins for K6 (csrc/energy_tile.cuh, NT = 4)
K6_PAIRS = 4096
_SLICE = 64      # features of a staged slice


def energy_query_block(g: int, bsz: int) -> int:
    """Queries per CTA of the energy tile (csrc query_block, the same
    rule): 128 where the z-plane is one slice wide (G ≤ 64, the query
    block is then staged once) and the batch, rounded up to a multiple of
    32, fills it; else 64 where the batch fills it, else 32."""
    cap = -(-bsz // 32) * 32
    if cap >= 128 and g <= _SLICE:
        return 128
    return 64 if cap >= 64 else 32


def energy_grid_ctas(bsz: int, bins: int, g: int, pairs: int) -> int:
    """CTAs per corpus chunk of the energy tile holding ``pairs`` (query,
    bin) pairs a CTA (K6_PAIRS, or energy_approx.K7_PAIRS): one per query
    block and group of pairs / query_block bins."""
    qb = energy_query_block(g, bsz)
    return -(-bsz // qb) * (bins * qb // pairs)


def dtype_scalar(v: float, dtype) -> float:
    """v rounded to ``dtype``, as a Python float: a weight that both a
    kernel (float32 argument) and a PyTorch expression see alike."""
    return float(torch.tensor(v, dtype=dtype))


def energy_u(d2: torch.Tensor, wd: float) -> torch.Tensor:
    """w_D/(1+√d²) in the rsqrt2 form of the JAX kernel and chunked
    scorer (energymaps.py:480-488): d² clamped to [tiny, max/2] so a
    duplicate (d² = 0) gives exactly w_D and an overflowed d² stays
    finite, s = d²·rsqrt(d²), u = w_D·rsqrt(1 + 2s + d²)."""
    fi = torch.finfo(d2.dtype)
    d2c = d2.clamp(fi.tiny, fi.max * 0.5)
    s = d2c * torch.rsqrt(d2c)
    return wd * torch.rsqrt(1.0 + 2.0 * s + d2c)


def energy_plane(zq, qn, qlam, zx, xn, xlam, wl: float, wd: float):
    """(shifted scores, d²) of queries zq (B, G) against rows zx (N, G):
    d² = (|z_q|² + |z_x|²) - 2·z_q·z_x and
    score = w_D/(1+√d²) - w_λ·|λ_q - λ_x| (the true score minus w_D).
    Each step rounds once, in the order K6 and K7 round it."""
    d2 = (qn[:, None] + xn[None, :]) - 2.0 * dot_plane(zq, zx)
    return energy_u(d2, wd) - wl * (qlam[:, None] - xlam[None, :]).abs(), d2


def energy_topk_chunked(z_q, query_lambdas, z_items, item_lambdas,
                        wl: float, wd: float, *, k: int,
                        chunk: int = ENERGY_CHUNK):
    """Exact energy top-k by a plain scan of the z-plane in row chunks
    (energymaps._energy_score_topk_chunked of the JAX package): each
    chunk's shifted score plane (energy_plane), its stable top-k, and a
    two-key merge with the running top-k, so ties go to the lowest id as
    over the full plane.  The scorer of small corpora, the repair
    fallback and the reference the kernels are held against.  Returns
    (scores (B, k) on the true scale, ids (B, k) int64)."""
    dt = z_items.dtype
    wl, wd = dtype_scalar(wl, dt), dtype_scalar(wd, dt)
    zq = z_q.to(dt)
    qlam = query_lambdas.to(dt)
    qn = (zq * zq).sum(dim=1)
    run_s = run_i = None
    for c0 in range(0, z_items.shape[0], chunk):
        zc = z_items[c0:c0 + chunk]
        sc, _ = energy_plane(zq, qn, qlam, zc, (zc * zc).sum(dim=1),
                             item_lambdas[c0:c0 + chunk].to(dt), wl, wd)
        s, i = exact_topk(sc, min(k, sc.shape[1]))
        i = i + c0
        if run_s is not None:
            s, i = two_key_topk(torch.cat([run_s, s], dim=1),
                                torch.cat([run_i, i], dim=1), k)
        run_s, run_i = s, i
    return run_s - wd, run_i


def prepare_binned_energy_corpus(z_items: torch.Tensor,
                                 item_lambdas: torch.Tensor, rows: int = 0):
    """The z-plane, its λ and its squared row norms, zero-padded to a
    multiple of CORPUS_ALIGN rows, and to at least ``rows`` (a live
    session's capacity): float32 on CUDA (what K6 and K7 read), the
    corpus dtype on the CPU.  Sessions do this once.  Returns
    (zx (n_pad, G), xlam (n_pad,), xn (n_pad,))."""
    dt = torch.float32 if z_items.is_cuda else z_items.dtype
    n = z_items.shape[0]
    pad = (-max(n, rows)) % CORPUS_ALIGN + max(0, rows - n)
    zx = torch.nn.functional.pad(z_items.to(dt), (0, 0, 0, pad))
    xlam = torch.nn.functional.pad(item_lambdas.to(dt), (0, pad))
    return zx.contiguous(), xlam.contiguous(), (zx * zx).sum(dim=1)


def binned_energy_pool(zq, qn, qlam, zx, xn, xlam, wl: float, wd: float,
                       n: int, *, depth: int, bins: int, chunks: int):
    """Per-(query, chunk, bin) top-``depth`` pool and det of the shifted
    energy score.

    zq (B, G) queries in z-space, qn (B,) their squared norms, qlam (B,);
    zx / xn / xlam the prepared corpus (at least ceil(n/bins)·bins rows).
    Returns pool_s (B, chunks, depth, bins), pool_i (same, int32 global
    row ids, INT_MAX in empty slots) and det (B, chunks, bins).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if zq.device.type == "cpu":
        return binned_energy_pool_plain(zq, qn, qlam, zx, xn, xlam, wl, wd,
                                        n, depth=depth, bins=bins,
                                        chunks=chunks)
    bsz, g = zq.shape
    n_tiles = -(-n // bins)
    for t in (zq, qn, qlam, zx, xn, xlam):
        if not (t.is_cuda and t.dtype == torch.float32
                and t.is_contiguous()):
            raise ValueError("binned_energy_pool: CUDA float32 contiguous "
                             "tensors required")
    if bins not in KERNEL_BINS or depth not in KERNEL_DEPTHS:
        raise ValueError(f"binned_energy_pool: unsupported bins={bins} "
                         f"depth={depth}")
    if g < 1:
        raise ValueError("binned_energy_pool: empty z-plane rows")
    if zx.shape[0] < n_tiles * bins or zx.shape[1] != g \
            or xn.shape[0] < n_tiles * bins:
        raise ValueError("binned_energy_pool: corpus not padded to whole "
                         "bin tiles")
    tiles_per_chunk = -(-n_tiles // chunks)
    chunks = -(-n_tiles // tiles_per_chunk)
    pool_s = torch.empty((bsz, chunks, depth, bins), device=zq.device,
                         dtype=torch.float32)
    pool_i = torch.empty((bsz, chunks, depth, bins), device=zq.device,
                         dtype=torch.int32)
    det = torch.empty((bsz, chunks, bins), device=zq.device,
                      dtype=torch.float32)
    if bsz == 0 or n <= 0:
        return pool_s, pool_i, det
    rc = lib().asp_energy_bintopk(
        zq.data_ptr(), qn.data_ptr(), qlam.data_ptr(), zx.data_ptr(),
        xn.data_ptr(), xlam.data_ptr(), wl, wd, n, bsz, g, bins, depth,
        chunks, tiles_per_chunk, pool_s.data_ptr(), pool_i.data_ptr(),
        det.data_ptr(), stream_of(zq))
    check(rc, "asp_energy_bintopk")
    binned_energy_pool.launches += 1
    return pool_s, pool_i, det


binned_energy_pool.launches = 0


def binned_energy_pool_plain(zq, qn, qlam, zx, xn, xlam, wl: float,
                             wd: float, n: int, *, depth: int, bins: int,
                             chunks: int):
    """Plain PyTorch version of the K6 kernel, same outputs and layout."""
    z_n, n_n, l_n = zx[:n], xn[:n], xlam[:n]

    def scores(b0, b1):
        return energy_plane(zq[b0:b1], qn[b0:b1], qlam[b0:b1], z_n, n_n,
                            l_n, wl, wd)[0], None
    return fold_pool_plain(scores, zq.shape[0], n, depth=depth, bins=bins,
                           chunks=chunks, device=zq.device)


def binned_energy_topk(z_q, query_lambdas, zx, xlam, xn, wl: float,
                       wd: float, *, k: int, n: int, depth: int = 0):
    """Binned energy top-k over a prepared corpus
    (prepare_binned_energy_corpus) of n true rows: (scores (B,k), ids
    (B,k), flags (B,), det (B, bins)), scores and det on the true scale.
    Flagged rows may miss a top-k element to a deep bin collision and
    must be repaired by the caller (ops/bin_repair); unflagged rows are
    exact.  wl and wd must be values of the corpus dtype; ``depth`` 0
    takes binned_topk_depth_for(k)."""
    dt = zx.dtype
    zq = z_q.to(dt).contiguous()
    qlam = query_lambdas.to(dt).contiguous()
    qn = (zq * zq).sum(dim=1)
    depth, bins = depth or binned_topk_depth_for(k), bins_target(k)
    chunks = _default_chunks(
        energy_grid_ctas(zq.shape[0], bins, zq.shape[1], K6_PAIRS),
        -(-n // bins), zq.device)
    pool_s, pool_i, det = binned_energy_pool(zq, qn, qlam, zx, xn, xlam, wl,
                                             wd, n, depth=depth, bins=bins,
                                             chunks=chunks)
    return flush_pool(pool_s, pool_i, det, k, -wd)


def rsqrt_probe(x: torch.Tensor) -> torch.Tensor:
    """rsqrtf of every element of a CUDA float32 tensor, computed by the
    function K6 and K7 call, for holding it against torch.rsqrt."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError("rsqrt_probe: CUDA float32 contiguous tensor "
                         "required")
    out = torch.empty_like(x)
    rc = lib().asp_rsqrt_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                               stream_of(x))
    check(rc, "asp_rsqrt_probe")
    return out
