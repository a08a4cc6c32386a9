"""K1: bin-accumulator streaming λ-aware top-k (csrc/bintopk.cu).

Replaces ``arrowspace_tpu.ops.pallas_bintopk.binned_lambda_topk``
(pallas_call at pallas_bintopk.py:667; body ``_kernel`` :387,
``_fold_subtiles`` :464, ``_fold_tile`` :359).

Contract kept from the TPU kernel (bin_repair.py:12-33): corpus row g
belongs to bin ``g mod bins``; the pool holds, per (query, bin), at
least the top-``depth`` scores by (-score, lowest id); and ``det[q, b]``
bounds every score of bin b that is not in the pool (NEG_INF when none
is missing).  The flush then takes the exact two-key top-k of the pool
and flags a query when some bin's det reaches its kth score, so
unflagged rows are exact and flagged rows are repaired exactly by
rescoring only their fired bins (ops/bin_repair).

The CUDA kernel splits the corpus into chunks, one CTA per (query block,
chunk, group of bins), and writes a top-``depth`` pool and a det per
(query, chunk, bin); the flush merges the chunks.  A row dropped by its
chunk is below that chunk's det, and the strided repair rescans the
whole bin, so the per-chunk pools keep the contract.  It computes the
dot products on the tensor cores as 3×TF32 (csrc/bintopk.cu), within
1e-5 of float32, not bitwise; identical rows still score bitwise alike.
``binned_topk_pool_plain`` is the same computation in plain PyTorch.
Its fold (``fold_pool_plain``) is also the plain fold of the energy
kernels K6 and K7 (csrc/energy_tile.cuh, ops/energy_bintopk.py), which
keep the same pool layout.

Scores are SHIFTED by -c1 = -(1-α): queries arrive α-prescaled so the
dot product is α·cos, and c1 is added back after the flush.

bf16 mode (``use_bf16``, the JAX kernel's ``use_bf16=True``): the
prepared corpus and the query operand are bf16, zero-padded to a
multiple of 8 features (a TMA row stride is a multiple of 16 bytes), and
a kernel of its own (csrc/bintopk_bf16.cu, ``asp_bintopk_bf16``, counted
by ``binned_topk_pool.launches_bf16``) multiplies them with ``wgmma``
from shared memory, float32 accumulation, the corpus slices arriving by
TMA into a ring of ``bf16_stages`` stages; λ, c1, the scores and det
stay float32.  Its plain version upcasts the bf16 operands to float32.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, lib, stream_of
from .search import (INT_MAX, NEG_INF, as_operand, dot_plane, lambda_term,
                     operand_query, safe_unit, two_key_topk)

__all__ = ["binned_topk_depth_for", "bins_target", "prepare_binned_corpus",
           "scoring_dtype", "prepared_rows", "bintopk_fits", "query_block",
           "grid_ctas",
           "bf16_stages", "bf16_config", "wave_chunks", "check_operands",
           "binned_topk_pool",
           "binned_topk_pool_plain", "fold_pool_plain", "flush_pool",
           "binned_lambda_topk"]

# Prepared corpora are zero-padded to a multiple of the widest bin count,
# so one prepared copy serves every k.
CORPUS_ALIGN = 512
KERNEL_BINS = (128, 256, 512)
KERNEL_DEPTHS = (2, 3, 4)
_SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block can use
# K1's CTA holds _PAIRS (query, bin) pairs, 16 a thread, as a block of
# query_block() queries × _PAIRS / query_block() bins (csrc/bintopk.cu)
_PAIRS = 4096
# The bf16 kernel's widest F: the JAX session's binned limit
# (arrowspace_tpu/index.py:214); its shared memory would admit more.
BF16_MAX_F = 1536
# Features of a bf16 operand row are padded to a multiple of this: a
# tensor map's row stride is a multiple of 16 bytes (both bf16 kernels,
# K1's and K3's, read their rows by tensor map).
BF16_ALIGN = 8
# The bf16 kernel's shared memory (csrc/bintopk_bf16.cu): 1024 bytes to
# align the 128-byte-swizzled tiles, the query block as ceil(F/64) tiles
# of qb rows × 128 bytes, and a ring of 3 to 16 stages of _PAIRS / qb
# corpus rows × 128 bytes, each with two 8-byte barriers (one more for
# the query block).
_BF16_ROW, _BF16_ALIGN_SMEM = 128, 1024
_BF16_MIN_STAGES, _BF16_MAX_STAGES = 3, 16


def binned_topk_depth_for(k: int) -> int:
    """Bin depth D for a requested k (pallas_bintopk.py:61-73): deep
    enough that a >D collision is rare, shallow enough to keep the
    insertion network cheap."""
    if k <= 4:
        return 2
    if k <= 48:
        return 3
    return 4


def bins_target(k: int) -> int:
    """Bins per query (pallas_bintopk.py:114-148): 128 up to k=12, then
    wider pools as the collision rate ~C(k, D+1)/bins^D grows."""
    if k <= 12:
        return 128
    if k <= 32:
        return 256
    return 512


def bf16_stages(f: int, qb: int) -> int:
    """Stages of the bf16 kernel's ring at query block qb (csrc stages):
    as many as fit beside the query block, at most 16; 0 when none
    does."""
    room = _SMEM_LIMIT - _bf16_smem(f, qb, 0)
    return max(0, min(_BF16_MAX_STAGES,
                      room // ((_PAIRS // qb) * _BF16_ROW + 16)))


def _bf16_smem(f: int, qb: int, stages: int) -> int:
    return (_BF16_ALIGN_SMEM + -(-f // 64) * qb * _BF16_ROW
            + stages * ((_PAIRS // qb) * _BF16_ROW + 16) + 8)


def _bintopk_smem(f: int, qb: int, use_bf16: bool = False) -> int:
    """K1's shared memory (csrc smem_bytes).  float32: the query block's
    rows, unsplit, padded to whole 8-feature k-steps at row stride FP + 4,
    and two corpus slices of _PAIRS / qb rows × 64 features at stride 68.
    bf16: the query block unpadded and its ring of bf16_stages stages, at
    least 3 (so the block fits exactly when this is within the limit)."""
    if use_bf16:
        return _bf16_smem(f, qb, max(_BF16_MIN_STAGES, bf16_stages(f, qb)))
    return (qb * (-(-f // 8) * 8 + 4) + 2 * (_PAIRS // qb) * 68) * 4


def query_block(f: int, bsz: int, use_bf16: bool = False) -> int:
    """Queries per CTA of K1 (csrc query_block, the same rule): the
    largest of 128, 64 and 32 (bf16: 128 and 64) whose shared memory fits
    at this F and that the batch, rounded up to a multiple of 32, fills.
    A larger block reads each corpus slice once for more queries."""
    cap = -(-bsz // 32) * 32
    for qb in (128, 64):
        if qb <= cap and _bintopk_smem(f, qb, use_bf16) <= _SMEM_LIMIT:
            return qb
    return 64 if use_bf16 else 32


def grid_ctas(bsz: int, bins: int, f: int, use_bf16: bool = False) -> int:
    """CTAs per corpus chunk of K1: one per query block and group of
    _PAIRS / query_block bins."""
    qb = query_block(f, bsz, use_bf16)
    return -(-bsz // qb) * (bins * qb // _PAIRS)


def bintopk_fits(f: int, use_bf16: bool = False) -> bool:
    """Whether K1's shared memory fits a block at its smallest query
    block (float32 32, bf16 64): the same at every bin count.  The bf16
    kernel is capped at BF16_MAX_F, the JAX session's binned limit."""
    if use_bf16:
        f = -(-f // BF16_ALIGN) * BF16_ALIGN
        if f > BF16_MAX_F:
            return False
    return f >= 1 and _bintopk_smem(f, 64 if use_bf16 else 32,
                                     use_bf16) <= _SMEM_LIMIT


def bf16_config(f: int, bsz: int, depth: int) -> dict:
    """What the bf16 kernel runs at (F, B, depth), from the library
    (CUDA only): query block, ring stages, dynamic shared bytes, and the
    instantiation's registers, spilled bytes a thread and largest
    block."""
    out = (ctypes.c_int * 6)()
    check(lib().asp_bintopk_bf16_config(f, bsz, depth, out),
          "asp_bintopk_bf16_config")
    keys = ("query_block", "stages", "smem_bytes", "registers",
            "spill_bytes", "max_threads")
    return dict(zip(keys, out))


def scoring_dtype(items: torch.Tensor) -> torch.dtype:
    """The dtype the kernels score a corpus in: float32 on CUDA (what
    they read), the corpus dtype on the CPU."""
    return torch.float32 if items.is_cuda else items.dtype


def prepared_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Corpus rows as a prepared corpus ``like`` holds them: safe_unit in
    the rows' dtype, then as_operand (the cast to like's dtype, zero
    padding to its width)."""
    return as_operand(safe_unit(rows), like)


def prepare_binned_corpus(items: torch.Tensor, item_lambdas: torch.Tensor,
                          rows: int = 0, use_bf16: bool = False):
    """Unit-normalised corpus and its λ, zero-padded to a multiple of
    CORPUS_ALIGN rows, and to at least ``rows`` (a live session's
    capacity).  λ is in the scoring dtype: float32 on CUDA (what the
    kernels read), the corpus dtype on the CPU; so is the corpus, or
    with ``use_bf16`` bf16, its features zero-padded to a multiple of
    BF16_ALIGN (the JAX package's ``_unit_padded(..., jnp.bfloat16)``).
    Sessions do this once; a row written later by prepared_rows (safe_unit
    in the corpus dtype, then the cast) scores bitwise as a prepared row
    would."""
    dt = scoring_dtype(items)
    n, f = items.shape
    pad = (-max(n, rows)) % CORPUS_ALIGN + max(0, rows - n)
    width = -(-f // BF16_ALIGN) * BF16_ALIGN if use_bf16 else f
    like = items.new_empty((0, width),
                           dtype=torch.bfloat16 if use_bf16 else dt)
    xhat = torch.nn.functional.pad(prepared_rows(items, like),
                                   (0, 0, 0, pad))
    xlam = torch.nn.functional.pad(item_lambdas.to(dt), (0, pad))
    return xhat.contiguous(), xlam.contiguous()


def _default_chunks(ctas: int, n_tiles: int, device) -> int:
    """Corpus chunks for a grid of ``ctas`` CTAs per chunk (grid_ctas for
    K1, energy_bintopk.energy_grid_ctas for K6 and K7).  Each kernel's
    registers leave room for one resident CTA per SM, so the grid should
    fill the SMs in whole waves."""
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = 1
    return wave_chunks(ctas, n_tiles, sms)


def wave_chunks(ctas: int, n_tiles: int, sms: int, cap: int = 64) -> int:
    """The fewest chunks (at most ``cap``, at most one per tile) whose
    last wave over ``sms`` SMs is at least 90 % full, else the fullest.
    Fewer chunks also keep the pool the flush sorts small."""
    best, best_fill = 1, 0.0
    for c in range(1, max(1, min(n_tiles, cap)) + 1):
        total = ctas * c
        fill = total / (-(-total // sms) * sms)
        if fill >= 0.9:
            return c
        if fill > best_fill:
            best, best_fill = c, fill
    return best


def binned_topk_pool(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                     depth: int, bins: int, chunks: int):
    """Per-(query, chunk, bin) top-``depth`` pool and det.

    qhat (B, F) α-prescaled unit queries, qlam (B,), xhat/xlam the
    prepared corpus (at least ceil(n/bins)·bins rows), c1 = 1-α.
    Returns pool_s (B, chunks, depth, bins), pool_i (same, int32 global
    row ids, INT_MAX in empty slots) and det (B, chunks, bins).  bf16
    qhat and xhat (F a multiple of BF16_ALIGN, 16-byte aligned) take the
    bf16 kernel; qlam, xlam and the outputs are float32 either way.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if qhat.device.type == "cpu":
        return binned_topk_pool_plain(qhat, qlam, xhat, xlam, c1, n,
                                      depth=depth, bins=bins, chunks=chunks)
    bsz, f = qhat.shape
    n_tiles = -(-n // bins)
    bf16 = check_operands("binned_topk_pool", qhat, qlam, xhat, xlam)
    if bins not in KERNEL_BINS or depth not in KERNEL_DEPTHS:
        raise ValueError(f"binned_topk_pool: unsupported bins={bins} "
                         f"depth={depth}")
    if not bintopk_fits(f, bf16):
        raise ValueError(f"binned_topk_pool: F={f} exceeds the kernel's "
                         "gate")
    if xhat.shape[0] < n_tiles * bins or xhat.shape[1] != f:
        raise ValueError("binned_topk_pool: corpus not padded to whole "
                         "bin tiles")
    tiles_per_chunk = -(-n_tiles // chunks)
    chunks = -(-n_tiles // tiles_per_chunk)
    pool_s = torch.empty((bsz, chunks, depth, bins), device=qhat.device,
                         dtype=torch.float32)
    pool_i = torch.empty((bsz, chunks, depth, bins), device=qhat.device,
                         dtype=torch.int32)
    det = torch.empty((bsz, chunks, bins), device=qhat.device,
                      dtype=torch.float32)
    if bsz == 0 or n <= 0:
        return pool_s, pool_i, det
    entry = "asp_bintopk_bf16" if bf16 else "asp_bintopk"
    rc = getattr(lib(), entry)(
        qhat.data_ptr(), qlam.data_ptr(), xhat.data_ptr(), xlam.data_ptr(),
        c1, n, bsz, f, bins, depth, chunks, tiles_per_chunk,
        pool_s.data_ptr(), pool_i.data_ptr(), det.data_ptr(),
        stream_of(qhat))
    check(rc, entry)
    if bf16:
        binned_topk_pool.launches_bf16 += 1
    else:
        binned_topk_pool.launches += 1
    return pool_s, pool_i, det


binned_topk_pool.launches = 0
binned_topk_pool.launches_bf16 = 0


def check_operands(name: str, qhat, qlam, xhat, xlam) -> bool:
    """Raise unless the tensors are what K1's and K3's kernels read:
    CUDA, contiguous, qlam and xlam float32, and qhat and xhat both
    float32 or both bf16 (then F a multiple of BF16_ALIGN and both
    16-byte aligned, for the tensor maps).  Returns whether the
    operands are bf16."""
    for t in (qhat, qlam, xhat, xlam):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name}: CUDA contiguous tensors required")
    bf16 = qhat.dtype == torch.bfloat16
    want = torch.bfloat16 if bf16 else torch.float32
    if (qhat.dtype != want or xhat.dtype != want
            or qlam.dtype != torch.float32 or xlam.dtype != torch.float32):
        raise ValueError(f"{name}: qhat and xhat both float32 or both "
                         "bf16, qlam and xlam float32 required")
    if bf16 and (qhat.shape[1] % BF16_ALIGN or qhat.data_ptr() % 16
                 or xhat.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 operands need F a multiple of "
                         f"{BF16_ALIGN} and 16-byte aligned rows")
    return bf16


def binned_topk_pool_plain(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                           depth: int, bins: int, chunks: int):
    """Plain PyTorch version of the K1 kernel, same outputs and layout;
    bf16 operands are multiplied in float32 (dot_plane)."""
    x_n, l_n = xhat[:n], xlam[:n]

    def scores(b0, b1):
        return dot_plane(qhat[b0:b1], x_n) - lambda_term(qlam[b0:b1], l_n,
                                                         c1), None
    return fold_pool_plain(scores, qhat.shape[0], n, depth=depth,
                           bins=bins, chunks=chunks, device=qhat.device)


def fold_pool_plain(block_scores, bsz: int, n: int, *, depth: int,
                    bins: int, chunks: int, device, payload: bool = False):
    """Plain PyTorch version of the binned fold (csrc/binned_fold.cuh).

    ``block_scores(b0, b1)`` returns the (b1-b0, n) score plane of
    queries b0..b1-1 and, with ``payload``, the plane of the value each
    pool entry carries (else None).  Rows are viewed as (chunk, tile,
    bin); a stable descending sort over each chunk's tiles keeps the
    earliest (lowest-id) row first among equal scores, which is what the
    kernel's strict-> insertion keeps.  The (depth+1)-th entry is the
    chunk's det.  Returns pool_s, pool_i (B, chunks, depth, bins), det
    (B, chunks, bins) and, with ``payload``, pool_d like pool_s (0 in
    empty slots)."""
    n_tiles = -(-n // bins)
    tiles_per_chunk = -(-n_tiles // chunks)
    chunks = -(-n_tiles // tiles_per_chunk)
    span = chunks * tiles_per_chunk * bins
    ids = torch.arange(span, device=device)
    ids = ids.reshape(chunks, tiles_per_chunk, bins)
    take = min(depth + 1, tiles_per_chunk)
    rows = max(1, (1 << 26) // max(1, span))
    out_s, out_i, out_det, out_d = [], [], [], []
    for b0 in range(0, bsz, rows):
        b1 = min(bsz, b0 + rows)
        plane, pay = block_scores(b0, b1)
        full = plane.new_full((b1 - b0, span), NEG_INF)
        full[:, :n] = plane
        full = full.reshape(-1, chunks, tiles_per_chunk, bins)
        s, order = torch.sort(full, dim=2, descending=True, stable=True)
        s, order = s[:, :, :take], order[:, :, :take]
        live = s > NEG_INF
        g = ids[None].expand(b1 - b0, -1, -1, -1).gather(2, order)
        g = torch.where(live, g, torch.full_like(g, INT_MAX))
        if payload:
            pfull = pay.new_zeros((b1 - b0, span))
            pfull[:, :n] = pay
            d = pfull.reshape(-1, chunks, tiles_per_chunk, bins).gather(
                2, order)
            d = torch.where(live, d, torch.zeros_like(d))
        if take < depth + 1:           # fewer tiles than depth + 1
            pad = (0, 0, 0, depth + 1 - take)
            s = torch.nn.functional.pad(s, pad, value=NEG_INF)
            g = torch.nn.functional.pad(g, pad, value=INT_MAX)
            if payload:
                d = torch.nn.functional.pad(d, pad, value=0.0)
        out_s.append(s[:, :, :depth])
        out_i.append(g[:, :, :depth].to(torch.int32))
        out_det.append(s[:, :, depth])
        if payload:
            out_d.append(d[:, :, :depth])
    pool = (torch.cat(out_s), torch.cat(out_i), torch.cat(out_det))
    return pool + (torch.cat(out_d),) if payload else pool


def flush_pool(pool_s, pool_i, det, k: int, shift: float):
    """Exact top-k over the pool plus the miss flags
    (pallas_bintopk.py:959-997): a two-key (-score, id) sort, the kth
    score, and flag = any bin whose det (max over chunks) reaches it.
    The shift c1 is added back to scores and det after the compare.
    Returns (scores (B,k), ids (B,k) int64, flags (B,) bool,
    det (B, bins))."""
    bsz = pool_s.shape[0]
    s, i = two_key_topk(pool_s.reshape(bsz, -1),
                        pool_i.reshape(bsz, -1).long(), k)
    det_b = det.amax(dim=1)
    kth = s[:, k - 1]
    flags = ((det_b >= kth[:, None]) & (det_b > NEG_INF)).any(dim=1)
    return s + shift, i, flags, det_b + shift


def binned_lambda_topk(queries, query_lambdas, items, item_lambdas, alpha,
                       *, k: int, depth: int = 0, prepared: bool = False,
                       n_items: int = 0, use_bf16: bool = False):
    """Binned λ-aware top-k: (scores (B,k), ids (B,k), flags (B,),
    det (B, bins)).  Flagged rows may miss a top-k element to a deep bin
    collision and must be repaired by the caller (ops/bin_repair);
    unflagged rows are exact.  ``depth`` 0 takes binned_topk_depth_for(k)
    (the kernel holds 2, 3 or 4 a bin).

    ``prepared=True`` takes items/item_lambdas from prepare_binned_corpus
    (bf16 when that corpus is) and the true row count from n_items (a
    live session's count, read at each call); otherwise the corpus is
    prepared here, in bf16 with ``use_bf16``, and dropped when the
    kernel has been enqueued.  The query is prescaled in the scoring
    dtype (item_lambdas') and only then cast to the corpus's dtype; λ
    and c1 stay in the scoring dtype."""
    if not prepared:
        n_items = items.shape[0]
        items, item_lambdas = prepare_binned_corpus(items, item_lambdas,
                                                    use_bf16=use_bf16)
    n = n_items
    depth, bins = depth or binned_topk_depth_for(k), bins_target(k)
    dt = item_lambdas.dtype
    qhat, c1 = operand_query(queries, alpha, dt, items)
    qlam = query_lambdas.to(dt).contiguous()
    chunks = _default_chunks(
        grid_ctas(qhat.shape[0], bins, qhat.shape[1],
                  qhat.dtype == torch.bfloat16),
        -(-n // bins), qhat.device)
    pool_s, pool_i, det = binned_topk_pool(qhat, qlam, items, item_lambdas,
                                           c1, n, depth=depth, bins=bins,
                                           chunks=chunks)
    return flush_pool(pool_s, pool_i, det, k, c1)
