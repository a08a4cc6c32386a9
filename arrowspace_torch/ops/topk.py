"""K3: exact streaming merge top-k (csrc/merge_topk.cu).

Replaces ``arrowspace_tpu.ops.pallas_topk.fused_lambda_topk``
(pallas_call at pallas_topk.py:263; body ``_kernel`` :90, ``_merge_topk``
:74).  It scores every corpus row with the shifted λ-aware expression and
keeps an exact per-query top-k, ties going to the lowest global id.  It
is the exact fallback of the binned path's repair for rows whose fired
bins overflow MAX_FIRED (ops/bin_repair).

The CUDA kernel splits the corpus over CTAs; each warp keeps one query's
top-k in shared memory by insertion, so a CTA writes a partial top-k per
(query, chunk) and the plain two-key sort merges the partials.
``merge_topk_partial_plain`` is the same computation in plain PyTorch.
"""

from __future__ import annotations

import torch

from ._build import check, lib, stream_of
from .search import (INT_MAX, NEG_INF, dot_plane, exact_topk, lambda_term,
                     prepare_query, two_key_topk)

__all__ = ["merge_topk_partial", "merge_topk_partial_plain",
           "fused_lambda_topk"]

MAX_K = 128
_QUERIES_PER_CTA = 8       # one warp per query
_TILE = 128                # corpus rows staged per step
_SORT_ELEMS = 1 << 27      # plain version: plane elements per sort


def _chunk_rows(bsz: int, n: int, device) -> int:
    """Corpus rows per CTA: enough CTAs for two per SM, whole tiles."""
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = 1
    q_blocks = -(-bsz // _QUERIES_PER_CTA)
    chunks = max(1, -(-2 * sms // q_blocks))
    rows = -(-n // chunks)
    return max(_TILE, -(-rows // _TILE) * _TILE)


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
    from .bintopk import prepare_binned_corpus
    if not prepared:
        n_items = items.shape[0]
        items, item_lambdas = prepare_binned_corpus(items, item_lambdas)
    n = n_items
    qhat, c1 = prepare_query(queries, alpha, dtype=items.dtype)
    qlam = query_lambdas.to(items.dtype).contiguous()
    rows_per_chunk = rows_per_chunk or _chunk_rows(qhat.shape[0], n,
                                                   qhat.device)
    part_s, part_i = merge_topk_partial(qhat, qlam, items, item_lambdas, c1,
                                        n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz = part_s.shape[0]
    s, i = two_key_topk(part_s.reshape(bsz, -1),
                        part_i.reshape(bsz, -1).long(), k)
    return s + c1, i
