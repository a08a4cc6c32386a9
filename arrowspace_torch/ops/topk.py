"""K3: exact streaming merge top-k (csrc/merge_topk.cu).

Replaces ``arrowspace_tpu.ops.pallas_topk.fused_lambda_topk``
(pallas_call at pallas_topk.py:263; body ``_kernel`` :90, ``_merge_topk``
:74).  It scores every corpus row with the shifted λ-aware expression and
keeps an exact per-query top-k, ties going to the lowest global id.  It
serves the λ-aware search and the "merge" SearchSession where K1's gate
does not admit F (core.merge_fits), and the rows of the binned path's
repair whose fired bins overflow MAX_FIRED (ops/bin_repair).

The CUDA kernel splits the corpus into chunks, one CTA per (query block,
chunk); it computes the dot products on the tensor cores as K1 does
(3×TF32, within 1e-5 of float32; identical rows, and a (query, row) pair
scored by K1, score bitwise alike), keeps each query's top-k in shared
memory, and writes a partial top-k per (query, chunk); the plain two-key
sort merges the partials.  ``merge_topk_partial_plain`` is the same
computation in plain PyTorch.
"""

from __future__ import annotations

import torch

from ._build import check, lib, stream_of
from .bintopk import prepare_binned_corpus, wave_chunks
from .search import (INT_MAX, NEG_INF, dot_plane, exact_topk, lambda_term,
                     prepare_query, two_key_topk)

__all__ = ["merge_topk_partial", "merge_topk_partial_plain",
           "fused_lambda_topk", "merge_query_block", "merge_smem_bytes",
           "merge_ctas_per_sm", "merge_rows_per_chunk"]

MAX_K = 128
_PAIRS = 4096              # (query, row) pairs a CTA holds (csrc kPairs)
_SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block can use
_SMEM_SM = 228 * 1024      # shared memory of an SM, 1 KB of it per block
_SORT_ELEMS = 1 << 27      # plain version: plane elements per sort


def merge_query_block(bsz: int) -> int:
    """Queries per CTA of K3 (csrc query_block, the same rule): 64 where
    the batch, rounded up to a multiple of 32, fills it, else 32."""
    return 64 if -(-bsz // 32) * 32 >= 64 else 32


def merge_smem_bytes(bsz: int, k: int) -> int:
    """K3's shared memory (csrc smem_bytes): two query and two corpus
    slices of 64 features at stride 68, and per query a top-k list and a
    one-tile candidate buffer of (score, id), its k-th entry and its
    candidate count: within a block's budget at every k <= MAX_K."""
    qb = merge_query_block(bsz)
    tr = _PAIRS // qb
    return 4 * (2 * (qb + tr) * 68 + 2 * qb * k + 2 * qb * tr + 3 * qb)


def merge_ctas_per_sm(bsz: int, k: int) -> int:
    """K3 CTAs resident on one SM: two where their shared memory fits
    (k <= 24 at 64-query blocks; the kernel's launch bounds keep its
    registers within two CTAs), else one."""
    return 2 if 2 * (merge_smem_bytes(bsz, k) + 1024) <= _SMEM_SM else 1


def merge_rows_per_chunk(bsz: int, n: int, sms: int, k: int) -> int:
    """Corpus rows per chunk of K3: whole tiles, the chunk count from
    ops.bintopk.wave_chunks over the grid's ceil(B / query block) CTAs a
    chunk, so that the grid fills the resident CTA slots of ``sms`` SMs
    (merge_ctas_per_sm each) in whole waves.  A tile is _PAIRS / query
    block rows."""
    tr = _PAIRS // merge_query_block(bsz)
    n_tiles = max(1, -(-n // tr))
    ctas = -(-bsz // merge_query_block(bsz))
    chunks = wave_chunks(ctas, n_tiles, sms * merge_ctas_per_sm(bsz, k))
    return -(-n_tiles // chunks) * tr


def _chunk_rows(bsz: int, n: int, device, k: int) -> int:
    """merge_rows_per_chunk on the SMs of ``device`` (one on the CPU)."""
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = 1
    return merge_rows_per_chunk(bsz, n, sms, k)


def merge_topk_partial(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                       k: int, rows_per_chunk: int):
    """Exact top-k of the shifted scores over each chunk of
    ``rows_per_chunk`` corpus rows: (scores (B, chunks, k),
    ids (B, chunks, k) int32), best first, NEG_INF/INT_MAX in slots a
    short chunk cannot fill.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if qhat.device.type == "cpu":
        return merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1, n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz, f = qhat.shape
    for t in (qhat, qlam, xhat, xlam):
        if not (t.is_cuda and t.dtype == torch.float32
                and t.is_contiguous()):
            raise ValueError("merge_topk_partial: CUDA float32 contiguous "
                             "tensors required")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"merge_topk_partial: k={k} outside [1, {MAX_K}]")
    if merge_smem_bytes(bsz, k) > _SMEM_LIMIT:
        raise ValueError(f"merge_topk_partial: B={bsz}, F={f}, k={k} "
                         "exceeds the kernel's shared-memory budget")
    if xhat.shape[0] < n or xhat.shape[1] != f or rows_per_chunk < 1:
        raise ValueError("merge_topk_partial: bad corpus shape")
    chunks = -(-n // rows_per_chunk)
    out_s = torch.empty((bsz, chunks, k), device=qhat.device,
                        dtype=torch.float32)
    out_i = torch.empty((bsz, chunks, k), device=qhat.device,
                        dtype=torch.int32)
    if bsz == 0 or n <= 0:
        return out_s, out_i
    rc = lib().asp_merge_topk(
        qhat.data_ptr(), qlam.data_ptr(), xhat.data_ptr(), xlam.data_ptr(),
        c1, n, bsz, f, k, chunks, rows_per_chunk, out_s.data_ptr(),
        out_i.data_ptr(), stream_of(qhat))
    check(rc, "asp_merge_topk")
    merge_topk_partial.launches += 1
    return out_s, out_i


merge_topk_partial.launches = 0


def merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                             k: int, rows_per_chunk: int):
    """Plain PyTorch version of the K3 kernel, same outputs and layout."""
    parts_s, parts_i = [], []
    block = max(1, _SORT_ELEMS // rows_per_chunk)    # queries per sort
    for r0 in range(0, n, rows_per_chunk):
        r1 = min(n, r0 + rows_per_chunk)
        s_parts, i_parts = [], []
        for b0 in range(0, qhat.shape[0], block):
            plane = dot_plane(qhat[b0:b0 + block], xhat[r0:r1]) \
                - lambda_term(qlam[b0:b0 + block], xlam[r0:r1], c1)
            s, i = exact_topk(plane, min(k, r1 - r0))
            s_parts.append(s)
            i_parts.append(i)
        s = torch.cat(s_parts)
        i = (torch.cat(i_parts) + r0).to(torch.int32)
        if s.shape[1] < k:
            pad = k - s.shape[1]
            s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
            i = torch.nn.functional.pad(i, (0, pad), value=INT_MAX)
        parts_s.append(s)
        parts_i.append(i)
    return torch.stack(parts_s, dim=1), torch.stack(parts_i, dim=1)


def fused_lambda_topk(queries, query_lambdas, items, item_lambdas, alpha,
                      *, k: int, prepared: bool = False, n_items: int = 0,
                      rows_per_chunk: int = 0):
    """Exact λ-aware top-k through K3: (scores (B,k), ids (B,k) int64).

    ``prepared=True`` takes items/item_lambdas from
    ops.bintopk.prepare_binned_corpus and the true row count from
    n_items; otherwise the corpus is normalised here."""
    if not prepared:
        n_items = items.shape[0]
        items, item_lambdas = prepare_binned_corpus(items, item_lambdas)
    n = n_items
    qhat, c1 = prepare_query(queries, alpha, dtype=items.dtype)
    qlam = query_lambdas.to(items.dtype).contiguous()
    rows_per_chunk = rows_per_chunk or _chunk_rows(qhat.shape[0], n,
                                                   qhat.device, k)
    part_s, part_i = merge_topk_partial(qhat, qlam, items, item_lambdas, c1,
                                        n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz = part_s.shape[0]
    s, i = two_key_topk(part_s.reshape(bsz, -1),
                        part_i.reshape(bsz, -1).long(), k)
    return s + c1, i
