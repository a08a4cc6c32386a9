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

bf16 mode (``use_bf16``, the JAX kernel's ``use_bf16=True``): bf16 query
and corpus operands, multiplied as bf16 ``mma.sync`` with float32
accumulation (``asp_merge_topk_bf16``, counted by
``merge_topk_partial.launches_bf16``), scores float32, as K1's bf16 mode.
"""

from __future__ import annotations

import torch

from ._build import check, lib, stream_of
from .bintopk import check_operands, prepare_binned_corpus, wave_chunks
from .search import (INT_MAX, NEG_INF, dot_plane, exact_topk, lambda_term,
                     operand_query, two_key_topk)

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


def merge_smem_bytes(bsz: int, k: int, use_bf16: bool = False) -> int:
    """K3's shared memory (csrc smem_bytes): two query and two corpus
    slices of 64 features at stride 68 floats (bf16: 72 bf16), and per
    query a top-k list and a one-tile candidate buffer of (score, id),
    its k-th entry and its candidate count: within a block's budget at
    every k <= MAX_K."""
    qb = merge_query_block(bsz)
    tr = _PAIRS // qb
    slices = 2 * (qb + tr) * (144 if use_bf16 else 272)
    return slices + 4 * (2 * qb * k + 2 * qb * tr + 3 * qb)


def merge_ctas_per_sm(bsz: int, k: int, use_bf16: bool = False) -> int:
    """K3 CTAs resident on one SM: two where their shared memory fits
    (float32: k <= 24 at 64-query blocks; the kernel's launch bounds keep
    its registers within two CTAs), else one."""
    return 2 if 2 * (merge_smem_bytes(bsz, k, use_bf16) + 1024) \
        <= _SMEM_SM else 1


def merge_rows_per_chunk(bsz: int, n: int, sms: int, k: int,
                         use_bf16: bool = False) -> int:
    """Corpus rows per chunk of K3: whole tiles, the chunk count from
    ops.bintopk.wave_chunks over the grid's ceil(B / query block) CTAs a
    chunk, so that the grid fills the resident CTA slots of ``sms`` SMs
    (merge_ctas_per_sm each) in whole waves.  A tile is _PAIRS / query
    block rows."""
    tr = _PAIRS // merge_query_block(bsz)
    n_tiles = max(1, -(-n // tr))
    ctas = -(-bsz // merge_query_block(bsz))
    chunks = wave_chunks(ctas, n_tiles,
                         sms * merge_ctas_per_sm(bsz, k, use_bf16))
    return -(-n_tiles // chunks) * tr


def _chunk_rows(bsz: int, n: int, device, k: int,
                use_bf16: bool = False) -> int:
    """merge_rows_per_chunk on the SMs of ``device`` (one on the CPU)."""
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = 1
    return merge_rows_per_chunk(bsz, n, sms, k, use_bf16)


def merge_topk_partial(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                       k: int, rows_per_chunk: int):
    """Exact top-k of the shifted scores over each chunk of
    ``rows_per_chunk`` corpus rows: (scores (B, chunks, k),
    ids (B, chunks, k) int32), best first, NEG_INF/INT_MAX in slots a
    short chunk cannot fill.  bf16 qhat and xhat take the bf16 kernel
    (ops.bintopk.check_operands says what the kernels read).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if qhat.device.type == "cpu":
        return merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1, n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz, f = qhat.shape
    bf16 = check_operands("merge_topk_partial", qhat, qlam, xhat, xlam)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"merge_topk_partial: k={k} outside [1, {MAX_K}]")
    if merge_smem_bytes(bsz, k, bf16) > _SMEM_LIMIT:
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
    entry = "asp_merge_topk_bf16" if bf16 else "asp_merge_topk"
    rc = getattr(lib(), entry)(
        qhat.data_ptr(), qlam.data_ptr(), xhat.data_ptr(), xlam.data_ptr(),
        c1, n, bsz, f, k, chunks, rows_per_chunk, out_s.data_ptr(),
        out_i.data_ptr(), stream_of(qhat))
    check(rc, entry)
    if bf16:
        merge_topk_partial.launches_bf16 += 1
    else:
        merge_topk_partial.launches += 1
    return out_s, out_i


merge_topk_partial.launches = 0
merge_topk_partial.launches_bf16 = 0


def merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                             k: int, rows_per_chunk: int):
    """Plain PyTorch version of the K3 kernel, same outputs and layout;
    bf16 operands are multiplied in float32 (dot_plane)."""
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
                      rows_per_chunk: int = 0, use_bf16: bool = False):
    """Exact λ-aware top-k through K3: (scores (B,k), ids (B,k) int64).

    ``prepared=True`` takes items/item_lambdas from
    ops.bintopk.prepare_binned_corpus (bf16 when that corpus is) and the
    true row count from n_items; otherwise the corpus is normalised here,
    in bf16 with ``use_bf16``.  The query is prescaled in the scoring
    dtype (item_lambdas') before its cast, as in K1's wrapper."""
    if not prepared:
        n_items = items.shape[0]
        items, item_lambdas = prepare_binned_corpus(items, item_lambdas,
                                                    use_bf16=use_bf16)
    n = n_items
    dt = item_lambdas.dtype
    qhat, c1 = operand_query(queries, alpha, dt, items)
    qlam = query_lambdas.to(dt).contiguous()
    rows_per_chunk = rows_per_chunk or _chunk_rows(
        qhat.shape[0], n, qhat.device, k, qhat.dtype == torch.bfloat16)
    part_s, part_i = merge_topk_partial(qhat, qlam, items, item_lambdas, c1,
                                        n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz = part_s.shape[0]
    s, i = two_key_topk(part_s.reshape(bsz, -1),
                        part_i.reshape(bsz, -1).long(), k)
    return s + c1, i
