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

float32 routes: ``merge_topk_partial`` launches the wgmma kernel
(csrc/merge_topk_tf32.cu, ``asp_merge_topk_tf32``) where
``merge_tf32_route`` admits the launch (F a multiple of 4 from 128 to
3072, at least 64 queries), else the mma.sync kernel
(csrc/merge_topk.cu, ``asp_merge_topk``); both run the same 3×TF32
sequence a pair, so their outputs are bitwise equal.
``merge_topk_partial.launches`` counts both, ``launches_wgmma`` and
``launches_mma`` each route, and the recorder's counters ``k3.f32`` (both
routes) and ``k3.tf32_wgmma`` (the wgmma route; utils.profiling.count)
those inside a session's or stream's record: in a "merge" session's
stream one a batch, in a "binned" session's only the repair's fallbacks.

bf16 mode (``use_bf16``, the JAX kernel's ``use_bf16=True``): bf16 query
and corpus operands, a kernel of its own (csrc/merge_topk_bf16.cu,
``asp_merge_topk_bf16``, counted by ``merge_topk_partial.launches_bf16``)
that multiplies them with ``wgmma`` from shared memory, float32
accumulation, the slices arriving by TMA into a ring whose depth, tile
rows and query residency ``merge_bf16_plan`` gives at each (F, k); λ, c1
and the scores stay float32, and a (query, row) pair scores bitwise as in
K1's bf16 mode.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from ._build import check, lib, stream_of
from .bintopk import check_operands, prepare_binned_corpus, wave_chunks
from .search import (INT_MAX, NEG_INF, dot_plane, exact_topk, lambda_term,
                     operand_query, two_key_topk)

__all__ = ["merge_topk_partial", "merge_topk_partial_plain",
           "fused_lambda_topk", "merge_query_block", "merge_bf16_plan",
           "merge_tf32_stages", "merge_tf32_route", "merge_tile_rows",
           "merge_smem_bytes", "merge_ctas_per_sm", "merge_rows_per_chunk",
           "merge_bf16_config", "merge_tf32_config"]

MAX_K = 128
_PAIRS = 4096              # (query, row) pairs a CTA holds (csrc kPairs)
_SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block can use
_SMEM_SM = 228 * 1024      # shared memory of an SM, 1 KB of it per block
_SORT_ELEMS = 1 << 27      # plain version: plane elements per sort
# The bf16 kernel (csrc/merge_topk_bf16.cu): 64 queries × 128 corpus rows
# a CTA, rows in 128-byte-swizzled slices of 64 features (a query slice
# 64 × 128 bytes), a ring of 3 to 8 stages.
_BF16_QB, _BF16_TR, _BF16_ROW, _BF16_ALIGN_SMEM = 64, 128, 128, 1024
_BF16_QSLICE = _BF16_QB * _BF16_ROW
_BF16_MIN_STAGES, _BF16_MAX_STAGES = 3, 8
# K3's float32 wgmma route (csrc/merge_topk_tf32.cu): 64 queries × 128
# corpus rows a CTA; a ring of 3 to 8 stages of one 32-feature box each
# (128 corpus rows and the 64 queries' hi and lo tf32 planes, 128 bytes a
# row), each with two 8-byte barriers, beside the selection state.  Its
# widths: those where the ablation measured it (tools/kernel_ablation.py
# --kernels k3tf32, H100, B = 2048, k = 10 and 100), and it beat the
# mma.sync kernel at each: 1.2-1.5× at F = 128, 1.8-2.3× at 768 to 3072.
_TF32_QB, _TF32_TR = 64, 128
_TF32_STAGE = (_TF32_TR + 2 * _TF32_QB) * _BF16_ROW
_TF32_MIN_STAGES, _TF32_MAX_STAGES = 3, 8
_TF32_MIN_F, _TF32_MAX_F = 128, 3072


def merge_query_block(bsz: int, use_bf16: bool = False) -> int:
    """Queries per CTA of K3 (csrc query_block, the same rule): 64 where
    the batch, rounded up to a multiple of 32, fills it, else 32; the
    bf16 kernel always 64 (wgmma's M)."""
    if use_bf16:
        return _BF16_QB
    return 64 if -(-bsz // 32) * 32 >= 64 else 32


def _select_smem(qb: int, tr: int, k: int) -> int:
    """Per query of a wgmma kernel's block: its k-th (score, id), top-k
    list and candidate buffer of one tile's rows, and its count."""
    return qb * 8 + qb * k * 8 + qb * tr * 8 + qb * 4


def _bf16_stage(resident: bool) -> int:
    return _BF16_TR * _BF16_ROW + (0 if resident else _BF16_QSLICE)


def _bf16_smem(f: int, k: int, resident: bool, stages: int) -> int:
    """The bf16 kernel's shared memory (csrc smem_bytes): 1024 bytes to
    align the swizzled tiles, the resident query block (ceil(F/64)
    slices), the stages and their two 8-byte barriers (one more for the
    query block), and per query its k-th (score, id), top-k list,
    candidate buffer of one tile's rows and count."""
    return (_BF16_ALIGN_SMEM
            + (-(-f // 64) * _BF16_QSLICE if resident else 0)
            + stages * _bf16_stage(resident) + (2 * stages + 1) * 8
            + _select_smem(_BF16_QB, _BF16_TR, k))


def merge_bf16_plan(f: int, k: int) -> tuple:
    """What the bf16 kernel runs at (F, k) (csrc plan, the same rule):
    (query block resident, ring stages).  The query block is resident
    where a ring of 3 stages fits beside it and the selection state,
    which grows with k; the ring is as deep as the shared memory allows,
    at most 8.  Streamed, a ring of 3 stages fits at every F and every
    k <= MAX_K."""
    for resident in (True, False):
        room = _SMEM_LIMIT - _bf16_smem(f, k, resident, 0)
        stages = max(0, min(_BF16_MAX_STAGES,
                            room // (_bf16_stage(resident) + 16)))
        if stages >= _BF16_MIN_STAGES:
            return resident, stages
    return False, 0


def _tf32_smem(k: int, stages: int) -> int:
    """The float32 wgmma kernel's shared memory (csrc smem_bytes): 1024
    bytes to align the swizzled boxes, the stages with their barriers,
    and the selection state."""
    return (_BF16_ALIGN_SMEM + stages * (_TF32_STAGE + 16)
            + _select_smem(_TF32_QB, _TF32_TR, k))


def merge_tf32_stages(k: int) -> int:
    """Stages of the float32 wgmma kernel's ring at k (csrc stages): as
    many as fit beside the selection state, at most 8 (3 at k = 128)."""
    room = _SMEM_LIMIT - _tf32_smem(k, 0)
    return max(0, min(_TF32_MAX_STAGES, room // (_TF32_STAGE + 16)))


def merge_tf32_route(bsz: int, f: int, k: int) -> bool:
    """Whether float32 K3 launches the wgmma kernel
    (csrc/merge_topk_tf32.cu) at (B, F, k): F a multiple of 4 (a tensor
    map's row stride is a multiple of 16 bytes) from 128 to 3072, the
    widths where it was measured to beat the mma.sync kernel; a batch
    that fills the 64-query block; 1 <= k <= MAX_K, where a ring of 3
    stages or more fits beside the selection state.  Elsewhere (the
    repair's fallbacks under 64 queries among them) the mma.sync kernel
    (csrc/merge_topk.cu) runs.  bf16 operands never take it."""
    return (f % 4 == 0 and _TF32_MIN_F <= f <= _TF32_MAX_F
            and bsz >= _TF32_QB and 1 <= k <= MAX_K
            and merge_tf32_stages(k) >= _TF32_MIN_STAGES)


def _wgmma(bsz: int, k: int, use_bf16: bool, f: int) -> bool:
    """Whether a launch runs one of the wgmma kernels, bf16 or float32,
    whose rules (128-row tiles, one CTA an SM) differ from the mma.sync
    kernel's."""
    return use_bf16 or merge_tf32_route(bsz, f, k)


def _need_f(f, use_bf16: bool) -> None:
    if use_bf16 and not f:
        raise ValueError("the bf16 merge rule needs F")


def merge_tile_rows(bsz: int, k: int, use_bf16: bool = False,
                    f: int = 0) -> int:
    """Corpus rows of a K3 tile: _PAIRS / query block (float32 on the
    mma.sync kernel); the wgmma kernels' two warpgroups' 64 rows each."""
    _need_f(f, use_bf16)
    if _wgmma(bsz, k, use_bf16, f):
        return _BF16_TR
    return _PAIRS // merge_query_block(bsz)


def merge_smem_bytes(bsz: int, k: int, use_bf16: bool = False,
                     f: int = 0) -> int:
    """K3's shared memory (csrc smem_bytes).  float32: two query and two
    corpus slices of 64 features at stride 68 floats, and per query a
    top-k list and a one-tile candidate buffer of (score, id), its k-th
    entry and its candidate count: within a block's budget at every
    k <= MAX_K.  bf16: _bf16_smem at merge_bf16_plan's choice; float32
    where merge_tf32_route admits: _tf32_smem at merge_tf32_stages."""
    _need_f(f, use_bf16)
    if use_bf16:
        return _bf16_smem(f, k, *merge_bf16_plan(f, k))
    if merge_tf32_route(bsz, f, k):
        return _tf32_smem(k, merge_tf32_stages(k))
    qb = merge_query_block(bsz)
    tr = _PAIRS // qb
    return 2 * (qb + tr) * 272 + 4 * (2 * qb * k + 2 * qb * tr + 3 * qb)


def merge_ctas_per_sm(bsz: int, k: int, use_bf16: bool = False,
                      f: int = 0) -> int:
    """K3 CTAs resident on one SM: two where their shared memory fits
    (float32: k <= 24 at 64-query blocks; the kernel's launch bounds keep
    its registers within two CTAs), else one (the wgmma kernels: always,
    their rings fill the SM)."""
    return 2 if 2 * (merge_smem_bytes(bsz, k, use_bf16, f) + 1024) \
        <= _SMEM_SM else 1


def merge_rows_per_chunk(bsz: int, n: int, sms: int, k: int,
                         use_bf16: bool = False, f: int = 0) -> int:
    """Corpus rows per chunk of K3: whole tiles (merge_tile_rows), the
    chunk count from ops.bintopk.wave_chunks over the grid's
    ceil(B / query block) CTAs a chunk, so that the grid fills the
    resident CTA slots of ``sms`` SMs (merge_ctas_per_sm each) in whole
    waves: at most 64 chunks, or for the wgmma kernels as many as the
    slots (a batch of one query block, a repair's rows, then fills every
    SM)."""
    tr = merge_tile_rows(bsz, k, use_bf16, f)
    n_tiles = max(1, -(-n // tr))
    ctas = -(-bsz // merge_query_block(bsz, use_bf16))
    slots = sms * merge_ctas_per_sm(bsz, k, use_bf16, f)
    chunks = wave_chunks(ctas, n_tiles, slots,
                         max(64, slots) if _wgmma(bsz, k, use_bf16, f)
                         else 64)
    return -(-n_tiles // chunks) * tr


def _chunk_rows(bsz: int, n: int, device, k: int,
                use_bf16: bool = False, f: int = 0) -> int:
    """merge_rows_per_chunk on the SMs of ``device`` (one on the CPU)."""
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = 1
    return merge_rows_per_chunk(bsz, n, sms, k, use_bf16, f)


def merge_bf16_config(f: int, k: int) -> dict:
    """What the bf16 kernel runs at (F, k), from the library (CUDA
    only): query block, tile rows, ring stages, dynamic shared bytes,
    the instantiation's registers and spilled bytes a thread, whether
    the query block is resident, and the CTAs an SM holds."""
    out = (ctypes.c_int * 8)()
    check(lib().asp_merge_topk_bf16_config(f, k, out),
          "asp_merge_topk_bf16_config")
    keys = ("query_block", "tile_rows", "stages", "smem_bytes", "registers",
            "spill_bytes", "resident", "ctas_per_sm")
    return dict(zip(keys, out))


def merge_tf32_config(f: int, k: int) -> dict:
    """What the float32 wgmma kernel runs at (F, k), from the library
    (CUDA only), in merge_bf16_config's keys (its query block is never
    resident)."""
    out = (ctypes.c_int * 7)()
    check(lib().asp_merge_topk_tf32_config(f, k, out),
          "asp_merge_topk_tf32_config")
    keys = ("query_block", "tile_rows", "stages", "smem_bytes", "registers",
            "spill_bytes", "ctas_per_sm")
    return dict(zip(keys, out))


def merge_topk_partial(qhat, qlam, xhat, xlam, c1: float, n: int, *,
                       k: int, rows_per_chunk: int):
    """Exact top-k of the shifted scores over each chunk of
    ``rows_per_chunk`` corpus rows: (scores (B, chunks, k),
    ids (B, chunks, k) int32), best first, NEG_INF/INT_MAX in slots a
    short chunk cannot fill.  bf16 qhat and xhat take the bf16 kernel
    (ops.bintopk.check_operands says what the kernels read); float32
    operands the wgmma kernel where merge_tf32_route admits (B, F, k),
    else the mma.sync kernel.  The wgmma kernel's C entry refuses an
    xhat that is not 16-byte aligned (a tensor map's base), which
    raises here.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if qhat.device.type == "cpu":
        return merge_topk_partial_plain(qhat, qlam, xhat, xlam, c1, n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz, f = qhat.shape
    bf16 = check_operands("merge_topk_partial", qhat, qlam, xhat, xlam)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"merge_topk_partial: k={k} outside [1, {MAX_K}]")
    if merge_smem_bytes(bsz, k, bf16, f) > _SMEM_LIMIT:
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
    args = (qhat.data_ptr(), qlam.data_ptr(), xhat.data_ptr(),
            xlam.data_ptr(), c1, n, bsz, f, k, chunks, rows_per_chunk,
            out_s.data_ptr(), out_i.data_ptr())
    wgmma = not bf16 and merge_tf32_route(bsz, f, k)
    if wgmma:   # the query rows split into a hi and a lo plane
        planes = torch.empty((2, bsz, f), device=qhat.device,
                             dtype=torch.float32)
        args += (planes.data_ptr(),)
    entry = ("asp_merge_topk_bf16" if bf16 else
             "asp_merge_topk_tf32" if wgmma else "asp_merge_topk")
    check(getattr(lib(), entry)(*args, stream_of(qhat)), entry)
    if bf16:
        merge_topk_partial.launches_bf16 += 1
        return out_s, out_i
    merge_topk_partial.launches += 1
    count("k3.f32")
    if wgmma:
        merge_topk_partial.launches_wgmma += 1
        count("k3.tf32_wgmma")
    else:
        merge_topk_partial.launches_mma += 1
    return out_s, out_i


merge_topk_partial.launches = 0       # float32, both routes
merge_topk_partial.launches_wgmma = 0
merge_topk_partial.launches_mma = 0
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
        qhat.shape[0], n, qhat.device, k, qhat.dtype == torch.bfloat16,
        qhat.shape[1])
    part_s, part_i = merge_topk_partial(qhat, qlam, items, item_lambdas, c1,
                                        n, k=k,
                                        rows_per_chunk=rows_per_chunk)
    bsz = part_s.shape[0]
    s, i = two_key_topk(part_s.reshape(bsz, -1),
                        part_i.reshape(bsz, -1).long(), k)
    return s + c1, i
